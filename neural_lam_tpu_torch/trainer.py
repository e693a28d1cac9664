"""Training step: counterpart of ``neural_lam_tpu/trainer.py``.

- batch standardization on the device (reference: module.py:307-337),
- loss = ``mean(loss_fn(pred, target, pred_std, mask=interior))``
  (reference: module.py:361-386),
- ``per_var_std = diff_std / sqrt(feature_weights)`` when the model has
  no std head (reference: module.py:142-163),
- AdamW with betas (0.9, 0.95) (reference: module.py:275-287).

:class:`Trainer` holds the statics, the loss and one optimizer step
(``train_step``). The JAX trainer's epoch loops, evaluation, checkpoints,
preemption handling, bf16 compute, sharded optimizer state and spatial
sharding are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import NeuralLAMConfig
from .datastore.base import BaseDatastore
from .loss_weighting import get_state_feature_weighting
from .metrics import get_metric
from .models.forecaster import ARForecaster
from .utils.device import resolve_device


@dataclasses.dataclass
class TrainingArgs:
    """Training hyperparameters: the fields of the JAX package's
    ``TrainingArgs`` that the training step reads (reference:
    neural_lam/train_model.py:208-262)."""

    lr: float = 1e-3
    # AdamW decoupled weight decay: the reference's
    # ``torch.optim.AdamW(params, lr=..., betas=(0.9, 0.95))``
    # (reference: models/module.py:284-287) inherits torch's default 0.01
    weight_decay: float = 0.01
    batch_size: int = 4
    ar_steps_train: int = 1
    loss: str = "wmse"
    # "32" (reference default); "bf16" is not ported yet
    precision: str = "32"


def make_optimizer(
    params, lr: float, weight_decay: float = 0.01
) -> torch.optim.Optimizer:
    """The training optimizer: AdamW matching the reference recipe,
    ``torch.optim.AdamW(params, lr=..., betas=(0.9, 0.95))`` (reference:
    models/module.py:284-287), the same update as the JAX package's
    ``optax.adamw(lr, b1=0.9, b2=0.95, weight_decay=...)``."""
    return torch.optim.AdamW(
        params, lr=lr, betas=(0.9, 0.95), eps=1e-8, weight_decay=weight_decay
    )


def standardization_stats(datastore: BaseDatastore) -> dict[str, np.ndarray]:
    """State and forcing mean/std, stds clamped away from zero
    (reference: module.py:289-305)."""
    eps = np.finfo(np.float32).eps
    stats = datastore.get_standardization_dataarray(category="state")
    if datastore.get_num_data_vars("forcing") > 0:
        f_stats = datastore.get_standardization_dataarray(category="forcing")
    else:
        f_stats = {}
    return {
        "state_mean": np.asarray(stats["state_mean"], np.float32),
        "state_std": np.maximum(np.asarray(stats["state_std"], np.float32), eps),
        "forcing_mean": np.asarray(f_stats.get("forcing_mean", np.zeros(0)), np.float32),
        "forcing_std": np.maximum(
            np.asarray(f_stats.get("forcing_std", np.ones(0)), np.float32), eps
        ),
    }


def device_stats(
    stats: dict[str, np.ndarray], forcing_width: int, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(state_mean, state_std, forcing_mean, forcing_std)`` on
    ``device``, the forcing stats repeated per window position,
    feature-major, to ``forcing_width`` (reference: module.py:307-337);
    without forcing the last two are a no-op mean 0 and std 1."""
    n_f = stats["forcing_mean"].shape[-1]
    if forcing_width > 0 and n_f > 0:
        window = forcing_width // n_f
        f_mean = np.repeat(stats["forcing_mean"], window)
        f_std = np.repeat(stats["forcing_std"], window)
    else:
        f_mean = np.zeros(forcing_width, np.float32)
        f_std = np.ones(forcing_width, np.float32)
    return tuple(
        torch.as_tensor(a, device=device)
        for a in (stats["state_mean"], stats["state_std"], f_mean, f_std)
    )


def standardize_batch(
    init_states: torch.Tensor,
    target_states: torch.Tensor,
    forcing: torch.Tensor,
    stats: dict[str, np.ndarray] | tuple[torch.Tensor, ...],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Standardize state and windowed forcing on their device. ``stats``
    is the dictionary of :func:`standardization_stats`, or the tensors
    :func:`device_stats` made of it once, which saves a loop four small
    copies to the device per batch."""
    if isinstance(stats, dict):
        stats = device_stats(stats, forcing.shape[-1], init_states.device)
    mean, std, f_mean, f_std = stats
    init_states = (init_states - mean) / std
    target_states = (target_states - mean) / std
    if forcing.shape[-1] > 0:
        forcing = (forcing - f_mean) / f_std
    return init_states, target_states, forcing


class Trainer:
    """One optimizer step at a time around an :class:`ARForecaster`.

    The trainer runs on ``device``: ``"cuda"`` unless the caller asks
    for ``"cpu"``, and the forecaster's parameters must live there.
    """

    def __init__(
        self,
        forecaster: ARForecaster,
        config: NeuralLAMConfig,
        datastore: BaseDatastore,
        args: TrainingArgs,
        device: str | torch.device = "cuda",
    ) -> None:
        if args.precision != "32":
            raise NotImplementedError(
                f"precision {args.precision!r}: only float32 training is "
                "ported; bf16 compute is not yet"
            )
        self.device = resolve_device(device)
        param_device = next(forecaster.parameters()).device
        if param_device.type != self.device.type or (
            self.device.index is not None
            and param_device.index != self.device.index
        ):
            raise ValueError(
                f"forecaster on {param_device}, trainer on {self.device}"
            )
        self.forecaster = forecaster
        self.args = args
        self.datastore = datastore

        # Interior mask (reference: module.py:129-140): the host bool array,
        # and a copy on the device so that a step moves nothing across.
        boundary = np.asarray(datastore.boundary_mask.data) > 0.5
        self.interior_mask_bool = ~boundary
        self._interior_mask = torch.from_numpy(self.interior_mask_bool).to(self.device)

        # per_var_std substitute when the model has no std head
        # (reference: module.py:142-163).
        if not forecaster.predicts_std:
            stats = datastore.get_standardization_dataarray(category="state")
            weights = get_state_feature_weighting(config, datastore)
            diff_std = np.asarray(stats["state_diff_std_standardized"], np.float32)
            self.per_var_std = torch.from_numpy(diff_std / np.sqrt(weights)).to(
                self.device
            )
        else:
            self.per_var_std = None

        self.stats = standardization_stats(datastore)
        self._device_stats: dict[int, tuple[torch.Tensor, ...]] = {}
        self.loss_fn = get_metric(args.loss)
        self.optimizer = self.init_state()

    def init_state(self) -> torch.optim.Optimizer:
        """A fresh AdamW (zero moments, step 0) over the forecaster's
        parameters; ``train_step`` uses the one in ``self.optimizer``."""
        return make_optimizer(
            self.forecaster.parameters(), self.args.lr, self.args.weight_decay
        )

    def _to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32).to(self.device)

    def _loss(self, init_states, target_states, forcing) -> torch.Tensor:
        """Scalar training loss of one batch ``(B, 2, N, d)``,
        ``(B, T, N, d)``, ``(B, T, N, f)`` in physical units."""
        forcing = self._to_device(forcing)
        width = forcing.shape[-1]
        if width not in self._device_stats:
            self._device_stats[width] = device_stats(self.stats, width, self.device)
        init_states, target_states, forcing = standardize_batch(
            self._to_device(init_states),
            self._to_device(target_states),
            forcing,
            self._device_stats[width],
        )
        prediction, pred_std = self.forecaster(init_states, forcing, target_states)
        if pred_std is None:
            pred_std = self.per_var_std
        return torch.mean(
            self.loss_fn(
                prediction, target_states, pred_std, mask=self._interior_mask
            )
        )

    def train_step(self, init_states, target_states, forcing) -> torch.Tensor:
        """Forward, backward and one AdamW update on one batch; returns
        the loss before the update as a 0-d tensor on the device (read
        it with ``.item()``, which waits for the device)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._loss(init_states, target_states, forcing)
        loss.backward()
        self.optimizer.step()
        return loss.detach()
