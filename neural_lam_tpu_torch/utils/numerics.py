"""Numerical helpers (clamping inverses).

Counterpart of ``neural_lam_tpu/utils/numerics.py``; semantics match the
reference implementations (reference: neural_lam/utils.py:800-874).
"""

from __future__ import annotations

import math

import torch


def inverse_softplus(
    x: torch.Tensor, beta: float = 1.0, threshold: float = 20.0
) -> torch.Tensor:
    """Inverse of softplus(x) = log(1 + exp(beta*x)) / beta.

    Inputs above ``threshold / beta`` are treated as linear (softplus is
    identity there); inputs are clamped slightly above zero so the log
    stays finite.
    """
    lo = math.log(float(torch.tensor(1e-6 + 1.0, dtype=x.dtype))) / beta
    x_clamped = x.clamp(lo, threshold / beta)
    non_linear_part = torch.log(torch.expm1(x_clamped * beta)) / beta
    return torch.where(x * beta <= threshold, non_linear_part, x)


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Inverse of the logistic sigmoid with clamping away from {0, 1}."""
    x_clamped = x.clamp(1e-6, 1 - 1e-6)
    return torch.log(x_clamped / (1 - x_clamped))
