"""Step-predictor base: shared statics, statistics and output clamping.

Counterpart of ``neural_lam_tpu/models/base.py`` (reference:
neural_lam/models/step_predictors/base.py:15-383). Data-derived
quantities (static grid features, standardisation stats, clamping
limits) are loaded once at construction as non-persistent buffers, so
the state dict holds only learned parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..datastore.base import BaseDatastore
from ..utils.numerics import inverse_sigmoid, inverse_softplus


@dataclasses.dataclass(frozen=True)
class ClampParams:
    """Per-feature clamping spec in standardized space.

    Features with both bounds use a rescaled-sigmoid clamp, features with
    one bound a (shifted/negated) softplus clamp
    (reference: models/step_predictors/base.py:222-320).
    """

    sigmoid_idx: tuple[int, ...]
    sigmoid_lower: torch.Tensor  # (len(sigmoid_idx),)
    sigmoid_upper: torch.Tensor
    softplus_lower_idx: tuple[int, ...]
    softplus_lower: torch.Tensor
    softplus_upper_idx: tuple[int, ...]
    softplus_upper: torch.Tensor
    # the three index tuples as int64 tensors on the model's device: a
    # Python list as an index would be copied to the device at every
    # step, which a CUDA graph capture does not allow
    sigmoid_index: torch.Tensor
    softplus_lower_index: torch.Tensor
    softplus_upper_index: torch.Tensor

    @property
    def any_clamping(self) -> bool:
        return bool(
            self.sigmoid_idx or self.softplus_lower_idx or self.softplus_upper_idx
        )

    def to(self, device: torch.device) -> "ClampParams":
        return dataclasses.replace(
            self,
            sigmoid_lower=self.sigmoid_lower.to(device),
            sigmoid_upper=self.sigmoid_upper.to(device),
            softplus_lower=self.softplus_lower.to(device),
            softplus_upper=self.softplus_upper.to(device),
            sigmoid_index=self.sigmoid_index.to(device),
            softplus_lower_index=self.softplus_lower_index.to(device),
            softplus_upper_index=self.softplus_upper_index.to(device),
        )


def prepare_clamping_params(
    datastore: BaseDatastore,
    state_mean: np.ndarray,
    state_std: np.ndarray,
    lower_lims: Optional[dict[str, float]],
    upper_lims: Optional[dict[str, float]],
) -> ClampParams:
    """Build :class:`ClampParams` from per-variable physical-space limits,
    normalized into standardized space with the state mean/std
    (reference: models/step_predictors/base.py:207-221)."""
    lower_lims = dict(lower_lims or {})
    upper_lims = dict(upper_lims or {})
    names = datastore.get_vars_names(category="state")
    unknown = (set(lower_lims) | set(upper_lims)) - set(names)
    if unknown:
        raise ValueError(
            "State feature limits were provided for unknown features: "
            f"{unknown}"
        )

    def normalize(x: float, i: int) -> float:
        return (x - float(state_mean[i])) / float(state_std[i])

    sig_idx, sig_lo, sig_hi = [], [], []
    sp_lo_idx, sp_lo = [], []
    sp_hi_idx, sp_hi = [], []
    for i, name in enumerate(names):
        has_lo, has_hi = name in lower_lims, name in upper_lims
        if has_lo and has_hi:
            if not lower_lims[name] < upper_lims[name]:
                raise ValueError(
                    f"Invalid clamping limits for feature {name!r}: lower "
                    f"{lower_lims[name]} not below upper {upper_lims[name]}"
                )
            sig_idx.append(i)
            sig_lo.append(normalize(lower_lims[name], i))
            sig_hi.append(normalize(upper_lims[name], i))
        elif has_lo:
            sp_lo_idx.append(i)
            sp_lo.append(normalize(lower_lims[name], i))
        elif has_hi:
            sp_hi_idx.append(i)
            sp_hi.append(normalize(upper_lims[name], i))

    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    return ClampParams(
        sigmoid_idx=tuple(sig_idx),
        sigmoid_lower=f32(sig_lo),
        sigmoid_upper=f32(sig_hi),
        softplus_lower_idx=tuple(sp_lo_idx),
        softplus_lower=f32(sp_lo),
        softplus_upper_idx=tuple(sp_hi_idx),
        softplus_upper=f32(sp_hi),
        sigmoid_index=torch.tensor(sig_idx, dtype=torch.int64),
        softplus_lower_index=torch.tensor(sp_lo_idx, dtype=torch.int64),
        softplus_upper_index=torch.tensor(sp_hi_idx, dtype=torch.int64),
    )


def get_clamped_new_state(
    clamp: ClampParams, state_delta: torch.Tensor, prev_state: torch.Tensor
) -> torch.Tensor:
    """Residual update with per-feature range clamping.

    ``X_{t+1} = f(f^{-1}(X_t) + delta)`` per clamped feature, plain
    ``X_t + delta`` otherwise (reference:
    models/step_predictors/base.py:322-383).
    """
    new_state = prev_state + state_delta

    if clamp.sigmoid_idx:
        idx = clamp.sigmoid_index
        lo, hi = clamp.sigmoid_lower, clamp.sigmoid_upper
        span = hi - lo
        inv = inverse_sigmoid((prev_state[..., idx] - lo) / span)
        new_state[..., idx] = lo + span * torch.sigmoid(inv + state_delta[..., idx])

    if clamp.softplus_lower_idx:
        idx = clamp.softplus_lower_index
        lo = clamp.softplus_lower
        inv = inverse_softplus(prev_state[..., idx] - lo)
        new_state[..., idx] = lo + F.softplus(inv + state_delta[..., idx])

    if clamp.softplus_upper_idx:
        idx = clamp.softplus_upper_index
        hi = clamp.softplus_upper
        inv = -inverse_softplus(hi - prev_state[..., idx])
        new_state[..., idx] = hi - F.softplus(-(inv + state_delta[..., idx]))

    return new_state


class StepPredictor(nn.Module):
    """One-step predictor ``(X_{t-1}, X_t, forcing_t) -> X_{t+1}``."""

    def __init__(
        self,
        datastore: BaseDatastore,
        output_std: bool = False,
        output_clamping_lower: Optional[dict[str, float]] = None,
        output_clamping_upper: Optional[dict[str, float]] = None,
    ) -> None:
        super().__init__()
        self.num_state_vars = datastore.get_num_data_vars(category="state")

        # Standardized static grid features, or an (N, 0) placeholder
        # (reference: models/step_predictors/base.py:50-71).
        da_static = datastore.get_dataarray(
            category="static", split=None, standardize=True
        )
        if da_static is None:
            static_np = np.empty((datastore.num_grid_points, 0), np.float32)
        else:
            static_np = np.asarray(da_static.data, dtype=np.float32)
        self.register_buffer(
            "grid_static_features", torch.from_numpy(static_np.copy()),
            persistent=False,
        )
        self.num_grid_nodes = int(static_np.shape[0])

        stats = datastore.get_standardization_dataarray(category="state")
        state_mean = np.asarray(stats["state_mean"], dtype=np.float32)
        state_std = np.asarray(stats["state_std"], dtype=np.float32)

        self.output_std = bool(output_std)
        self.grid_output_dim = (
            2 * self.num_state_vars if self.output_std else self.num_state_vars
        )
        self.clamp = prepare_clamping_params(
            datastore, state_mean, state_std,
            output_clamping_lower, output_clamping_upper,
        )

    @property
    def predicts_std(self) -> bool:
        return self.output_std

    def forward(self, prev_state, prev_prev_state, forcing):
        """The one-step prediction, :meth:`step` (which the subclasses
        define), so that ``torch.func.functional_call`` can run it on
        other parameter tensors."""
        return self.step(prev_state, prev_prev_state, forcing)

    def get_clamped_new_state(
        self, state_delta: torch.Tensor, prev_state: torch.Tensor
    ) -> torch.Tensor:
        return get_clamped_new_state(self.clamp, state_delta, prev_state)
