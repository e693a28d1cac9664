"""Evaluation metrics on ``(..., N, num_vars)`` gridded tensors.

Counterpart of ``neural_lam_tpu/metrics.py`` (reference:
neural_lam/metrics.py:11-397). All metrics share the signature
``metric(pred, target, pred_std, mask, average_grid, sum_vars)`` and the
``mask_and_reduce_metric`` reduction. The grid mask is a boolean array
over the ``N`` nodes: a host (numpy) array as in the JAX package, or a
``torch`` tensor already on the values' device, which a training loop
passes so that no step copies the mask across.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import numpy as np
import torch


def get_metric(metric_name: str) -> Callable[..., torch.Tensor]:
    """Look up a metric function by (case-insensitive) name."""
    metric_name_lower = metric_name.lower()
    if metric_name_lower not in DEFINED_METRICS:
        # ValueError, not assert: survives python -O and matches
        # get_metric_entry's error contract
        raise ValueError(
            f"Unknown metric: {metric_name!r} "
            f"(available: {sorted(DEFINED_METRICS)})"
        )
    return DEFINED_METRICS[metric_name_lower]


Mask = Union[np.ndarray, torch.Tensor]


def _node_mask(mask: Mask, like: torch.Tensor) -> torch.Tensor:
    """``(N,)`` bool tensor on ``like``'s device."""
    if not isinstance(mask, torch.Tensor):
        mask = torch.from_numpy(np.ascontiguousarray(np.asarray(mask, dtype=bool)))
    return mask.to(device=like.device, dtype=torch.bool)


def mask_and_reduce_metric(
    metric_entry_vals: torch.Tensor,
    mask: Optional[Mask],
    average_grid: bool,
    sum_vars: bool,
) -> torch.Tensor:
    """Select masked grid nodes, then mean over grid / sum over vars
    (reference: metrics.py:38-85).

    With ``average_grid`` the masked mean is computed by select-sum
    (``where`` keeps excluded NaNs out) instead of materialising a
    gathered copy of the interior nodes. Without ``average_grid`` the
    caller gets per-node values, so the gather is required to match the
    reference's masked shape.
    """
    if mask is not None:
        mask = _node_mask(mask, metric_entry_vals)
        if average_grid:
            # counted on the device: no wait for it
            n_sel = mask.sum().clamp(min=1)
            sel = torch.where(
                mask[:, None], metric_entry_vals, torch.zeros_like(metric_entry_vals)
            )
            metric_entry_vals = sel.sum(dim=-2) / n_sel
            if sum_vars:
                metric_entry_vals = metric_entry_vals.sum(dim=-1)
            return metric_entry_vals
        metric_entry_vals = metric_entry_vals.index_select(
            -2, mask.nonzero().squeeze(-1)
        )
    if average_grid:
        metric_entry_vals = metric_entry_vals.mean(dim=-2)
    if sum_vars:
        metric_entry_vals = metric_entry_vals.sum(dim=-1)
    return metric_entry_vals


def _wmse_entry(pred, target, pred_std):
    return (pred - target) ** 2 / (pred_std**2)


def _mse_entry(pred, target, pred_std):
    return (pred - target) ** 2


def _wmae_entry(pred, target, pred_std):
    return torch.abs(pred - target) / pred_std


def _mae_entry(pred, target, pred_std):
    return torch.abs(pred - target)


def _nll_entry(pred, target, pred_std):
    var = pred_std**2
    return 0.5 * (torch.log(2 * math.pi * var) + (target - pred) ** 2 / var)


def _crps_entry(pred, target, pred_std):
    target_standard = (target - pred) / pred_std
    return -pred_std * (
        math.pi ** (-0.5)
        - 2 * _std_normal_pdf(target_standard)
        - target_standard * (2 * _std_normal_cdf(target_standard) - 1)
    )


# Per-element error terms before any mask/reduction.
ENTRY_FNS = {
    "wmse": _wmse_entry,
    "mse": _mse_entry,
    "wmae": _wmae_entry,
    "mae": _mae_entry,
    "nll": _nll_entry,
    "crps_gauss": _crps_entry,
}


def get_metric_entry(metric_name: str):
    """Per-element (unreduced) form of a registered metric."""
    name = metric_name.lower()
    if name not in ENTRY_FNS:
        raise ValueError(
            f"Unknown metric {metric_name!r} (available: "
            f"{sorted(ENTRY_FNS)})"
        )
    return ENTRY_FNS[name]


def _sanitize_masked_inputs(pred, target, pred_std, mask):
    """Double-where: neutralise inputs at masked-OUT nodes BEFORE the
    entry computation. The select-sum in ``mask_and_reduce_metric``
    keeps excluded NaNs out of the VALUE, but a single ``where`` does
    not protect gradients: if target/pred_std is NaN at an excluded
    node (NaN-filled exterior is common in LAM datastores), the
    cotangent is 0 * d(entry)/d(pred) = NaN and poisons every parameter
    gradient. Zeroing the inputs at excluded nodes (std -> 1) makes the
    entry finite there; the outer mask still drops it from the value.
    """
    if mask is None:
        return pred, target, pred_std
    m = _node_mask(mask, pred)[:, None]
    pred = torch.where(m, pred, torch.zeros_like(pred))
    target = torch.where(m, target, torch.zeros_like(target))
    if pred_std.dim() == pred.dim():
        # node-dependent std head; per-variable (d,) std is finite by
        # construction (trainer eps-clamps it) and must not broadcast
        pred_std = torch.where(m, pred_std, torch.ones_like(pred_std))
    return pred, target, pred_std


def wmse(pred, target, pred_std, mask=None, average_grid=True, sum_vars=True):
    """Squared error weighted by ``1 / pred_std**2``
    (reference: metrics.py:88-138)."""
    pred, target, pred_std = _sanitize_masked_inputs(
        pred, target, pred_std, mask
    )
    entry = _wmse_entry(pred, target, pred_std)
    return mask_and_reduce_metric(entry, mask, average_grid, sum_vars)


def mse(pred, target, pred_std, mask=None, average_grid=True, sum_vars=True):
    """Unweighted squared error (pred_std replaced by ones)."""
    return wmse(
        pred, target, torch.ones_like(pred_std), mask, average_grid, sum_vars
    )


def wmae(pred, target, pred_std, mask=None, average_grid=True, sum_vars=True):
    """Absolute error weighted by ``1 / pred_std``
    (reference: metrics.py:186-236)."""
    pred, target, pred_std = _sanitize_masked_inputs(
        pred, target, pred_std, mask
    )
    entry = _wmae_entry(pred, target, pred_std)
    return mask_and_reduce_metric(entry, mask, average_grid, sum_vars)


def mae(pred, target, pred_std, mask=None, average_grid=True, sum_vars=True):
    """Unweighted absolute error (pred_std replaced by ones)."""
    return wmae(
        pred, target, torch.ones_like(pred_std), mask, average_grid, sum_vars
    )


def nll(pred, target, pred_std, mask=None, average_grid=True, sum_vars=True):
    """Gaussian negative log likelihood (reference: metrics.py:284-330)."""
    pred, target, pred_std = _sanitize_masked_inputs(
        pred, target, pred_std, mask
    )
    entry = _nll_entry(pred, target, pred_std)
    return mask_and_reduce_metric(entry, mask, average_grid, sum_vars)


def _std_normal_pdf(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(-0.5 * x * x) / math.sqrt(2 * math.pi)


def _std_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def crps_gauss(
    pred, target, pred_std, mask=None, average_grid=True, sum_vars=True
):
    """Closed-form Gaussian CRPS, negated for minimisation
    (reference: metrics.py:333-387)."""
    pred, target, pred_std = _sanitize_masked_inputs(
        pred, target, pred_std, mask
    )
    entry = _crps_entry(pred, target, pred_std)
    return mask_and_reduce_metric(entry, mask, average_grid, sum_vars)


DEFINED_METRICS = {
    "mse": mse,
    "mae": mae,
    "wmse": wmse,
    "wmae": wmae,
    "nll": nll,
    "crps_gauss": crps_gauss,
}
