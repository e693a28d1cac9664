"""Autoregressive forecaster with boundary forcing.

Counterpart of ``neural_lam_tpu/models/forecaster.py`` (reference:
neural_lam/models/forecasters/autoregressive.py:14-146): a Python loop
over prediction steps that overwrites the boundary nodes with the given
boundary states after every step. Under grad a step can be
rematerialised (``torch.utils.checkpoint``): its activations are dropped
after the forward and recomputed in the backward, as the JAX forecaster
does with ``jax.checkpoint``.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..datastore.base import BaseDatastore
from .base import StepPredictor


class ARForecaster(nn.Module):
    """Unrolls a :class:`StepPredictor`, overwriting boundary nodes with
    the boundary states at every step.

    ``remat_steps``: rematerialise each step in the backward. ``None``
    (the default) turns it on only for rollouts of more than one step,
    where the stored activations grow with the number of steps; a
    single-step rollout has nothing to gain from the recompute.
    """

    def __init__(
        self,
        predictor: StepPredictor,
        datastore: BaseDatastore,
        remat_steps: Optional[bool] = None,
    ) -> None:
        super().__init__()
        self.predictor = predictor
        self.remat_steps = remat_steps
        # (N, 1, 1) masks in the node-major layout
        # (reference: forecasters/autoregressive.py:36-45)
        mask = np.asarray(datastore.boundary_mask.data, np.float32)
        device = next(predictor.parameters()).device
        self.register_buffer(
            "boundary_mask",
            torch.from_numpy(mask.reshape(-1, 1, 1).copy()).to(device),
            persistent=False,
        )

    @property
    def predicts_std(self) -> bool:
        return self.predictor.predicts_std

    def forward(
        self,
        init_states: torch.Tensor,  # (B, 2, N, d_state)
        forcing_features: torch.Tensor,  # (B, T, N, d_forcing)
        boundary_states: torch.Tensor,  # (B, T, N, d_state)
        params: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Batched rollout; returns ``(prediction (B, T, N, d), std|None)``.

        Runs in the node-major layout ``(N, B, d)``: per step, predict,
        then blend ``boundary_mask * boundary + interior_mask * pred``
        (reference: autoregressive.py:116-136). The states are float32.

        ``params`` (the predictor's parameters by name) runs every step on
        those tensors instead of the predictor's own: the bf16 copies of
        mixed-precision training, made under autograd so that the
        gradients land on the float32 parameters. They are swapped in
        inside each step, so that a rematerialised step recomputes with
        them too.
        """
        bmask = self.boundary_mask
        imask = 1.0 - bmask
        # (B, T, N, d) -> (T, N, B, d)
        init_nm = init_states.permute(1, 2, 0, 3)
        forcing_nm = forcing_features.permute(1, 2, 0, 3)
        boundary_nm = boundary_states.permute(1, 2, 0, 3)
        prev_prev_state, prev_state = init_nm[0], init_nm[1]

        def step(prev_state, prev_prev_state, forcing, boundary):
            inputs = (prev_state, prev_prev_state, forcing)
            if params is None:
                pred_state, pred_std = self.predictor.step(*inputs)
            else:
                pred_state, pred_std = functional_call(
                    self.predictor, params, inputs, strict=False
                )
            return bmask * boundary + imask * pred_state, pred_std

        pred_steps = forcing_nm.shape[0]
        use_remat = (
            self.remat_steps if self.remat_steps is not None else pred_steps > 1
        ) and torch.is_grad_enabled()
        predictions, stds = [], []
        for t in range(pred_steps):
            args = (prev_state, prev_prev_state, forcing_nm[t], boundary_nm[t])
            if use_remat:
                # the model draws no random numbers, so no RNG state is
                # saved for the recompute: saving it reads the generator,
                # which a CUDA graph capture does not allow
                new_state, pred_std = checkpoint(
                    step, *args, use_reentrant=False, preserve_rng_state=False
                )
            else:
                new_state, pred_std = step(*args)
            predictions.append(new_state)
            if pred_std is not None:
                stds.append(pred_std)
            prev_prev_state, prev_state = prev_state, new_state
        # (T, N, B, d) -> (B, T, N, d)
        prediction = torch.stack(predictions).permute(2, 0, 1, 3)
        if self.predicts_std:
            return prediction, torch.stack(stds).permute(2, 0, 1, 3)
        return prediction, None
