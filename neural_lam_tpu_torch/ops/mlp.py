"""MLPs used throughout the model.

Counterpart of ``neural_lam_tpu/ops/mlp.py``. Semantics mirror the
reference ``utils.make_mlp`` (reference: neural_lam/utils.py:538-570): a
stack of ``Linear -> SiLU`` pairs with a final ``Linear`` and an optional
``LayerNorm`` on the output. The module is an ``nn.Sequential`` so its
state-dict keys are the reference's (``0.weight``, ``2.bias``,
``3.weight`` for the LayerNorm scale, ...).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

LN_EPS = 1e-5  # torch.nn.LayerNorm default, as in the JAX package


def make_mlp(
    blueprint: Sequence[int],
    layer_norm: bool = True,
    generator: Optional[torch.Generator] = None,
    device: Optional[torch.device] = None,
) -> nn.Sequential:
    """Build an MLP for the layer-width ``blueprint``.

    ``blueprint[0]`` is the input width, ``blueprint[-1]`` the output
    width. Weights and biases are drawn uniformly in ``+-1/sqrt(fan_in)``
    (the ``nn.Linear`` default distribution) from ``generator``.
    """
    if len(blueprint) < 2:
        raise ValueError(f"Invalid MLP blueprint {list(blueprint)}")
    layers: list[nn.Module] = []
    n_linear = len(blueprint) - 1
    for i, (din, dout) in enumerate(zip(blueprint[:-1], blueprint[1:])):
        lin = nn.Linear(din, dout, device=device)
        bound = 1.0 / din**0.5
        with torch.no_grad():
            lin.weight.uniform_(-bound, bound, generator=generator)
            lin.bias.uniform_(-bound, bound, generator=generator)
        layers.append(lin)
        if i != n_linear - 1:
            layers.append(nn.SiLU())
    if layer_norm:
        layers.append(nn.LayerNorm(blueprint[-1], eps=LN_EPS, device=device))
    return nn.Sequential(*layers)


def linear_layers(mlp: nn.Sequential) -> list[nn.Linear]:
    return [m for m in mlp if isinstance(m, nn.Linear)]


def output_layer_norm(mlp: nn.Sequential) -> Optional[nn.LayerNorm]:
    last = mlp[-1]
    return last if isinstance(last, nn.LayerNorm) else None


def apply_mlp_split_first(
    mlp: nn.Sequential, parts: Sequence[torch.Tensor]
) -> torch.Tensor:
    """Apply ``mlp`` to the (virtual) concatenation of ``parts``.

    ``concat(parts) @ W`` is computed as ``sum_i parts[i] @ W_i`` with
    the first-layer weight sliced by part widths, so the concatenated
    activation is never materialised. Equal to ``mlp(torch.cat(parts,
    -1))`` up to f32 summation order.
    """
    first = mlp[0]
    x = first.bias
    start = 0
    for part in parts:
        width = part.shape[-1]
        x = x + part @ first.weight[:, start : start + width].T
        start += width
    if start != first.in_features:
        raise ValueError(
            f"parts widths {start} != first-layer input {first.in_features}"
        )
    for layer in mlp[1:]:
        x = layer(x)
    return x
