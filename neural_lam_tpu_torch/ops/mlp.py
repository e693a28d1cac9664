"""MLPs used throughout the model.

Counterpart of ``neural_lam_tpu/ops/mlp.py``. Semantics mirror the
reference ``utils.make_mlp`` (reference: neural_lam/utils.py:538-570): a
stack of ``Linear -> SiLU`` pairs with a final ``Linear`` and an optional
``LayerNorm`` on the output. The module is an ``nn.Sequential`` so its
state-dict keys are the reference's (``0.weight``, ``2.bias``,
``3.weight`` for the LayerNorm scale, ...). :class:`SplitMLPs` holds one
such MLP per chunk of the leading axis (reference:
neural_lam/gnn_layers.py:275-325), the per-section edge MLPs and
per-level node MLPs of HiLAMParallel.

Dtypes follow ``jnp.dot`` and JAX's promotion (``neural_lam_tpu/ops/
mlp.py:60-80``): an MLP runs in its input's dtype when its parameters
have that dtype (bf16 products return bf16 under mixed precision), and
in the promoted dtype when they differ (bf16 activations against the
float32 parameters of the eval step give float32, as ``bf16 @ f32`` does
in JAX; ``torch.matmul`` and ``F.linear`` would raise).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-5  # torch.nn.LayerNorm default, as in the JAX package


def promote(x: torch.Tensor, *params: Optional[torch.Tensor]):
    """``x`` and ``params`` in their promoted dtype (JAX's rule for
    ``x @ w + b``); tensors already of that dtype are returned as they
    are."""
    dtype = x.dtype
    for p in params:
        if p is not None:
            dtype = torch.promote_types(dtype, p.dtype)
    return [None if t is None else t.to(dtype) for t in (x, *params)]


class MLP(nn.Sequential):
    """An ``nn.Sequential`` of ``Linear``, ``SiLU`` and ``LayerNorm``
    whose forward promotes an activation and a layer's parameters of
    different dtypes, as JAX does (see the module's docstring); with one
    dtype throughout it is ``nn.Sequential``'s forward."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self:
            if isinstance(layer, nn.Linear) and layer.weight.dtype != x.dtype:
                x, w, b = promote(x, layer.weight, layer.bias)
                x = F.linear(x, w, b)
            elif isinstance(layer, nn.LayerNorm) and layer.weight.dtype != x.dtype:
                x, g, b = promote(x, layer.weight, layer.bias)
                x = F.layer_norm(x, layer.normalized_shape, g, b, layer.eps)
            else:
                x = layer(x)
        return x


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
    return MLP(*layers)


class SplitMLPs(nn.Module):
    """MLPs of one blueprint under ``mlps.<k>``, MLP ``k`` applied to
    chunk ``k`` of the input's leading (edge or node) axis. Chunking by
    the leading axis covers both the unbatched ``(E, D)`` and the
    node-major batched ``(E, B, D)`` layout."""

    def __init__(self, mlps: Sequence[nn.Sequential]) -> None:
        super().__init__()
        self.mlps = nn.ModuleList(mlps)

    def forward(self, x: torch.Tensor, chunk_sizes: Sequence[int]) -> torch.Tensor:
        sizes = [int(n) for n in chunk_sizes]
        if len(sizes) != len(self.mlps) or sum(sizes) != x.shape[0]:
            raise ValueError(
                f"chunk sizes {sizes} do not split {x.shape[0]} rows among "
                f"{len(self.mlps)} MLPs"
            )
        return torch.cat(
            [mlp(chunk) for mlp, chunk in zip(self.mlps, x.split(sizes, dim=0))],
            dim=0,
        )


def make_mlps(
    blueprint: Sequence[int],
    num_chunks: int = 1,
    generator: Optional[torch.Generator] = None,
    device: Optional[torch.device] = None,
) -> "nn.Sequential | SplitMLPs":
    """One MLP, or with ``num_chunks > 1`` a :class:`SplitMLPs` of as
    many MLPs of the same blueprint."""
    if num_chunks == 1:
        return make_mlp(blueprint, generator=generator, device=device)
    return SplitMLPs(
        [
            make_mlp(blueprint, generator=generator, device=device)
            for _ in range(num_chunks)
        ]
    )


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
        part, w = promote(part, first.weight[:, start : start + width])
        x = x + part @ w.T
        start += width
    if start != first.in_features:
        raise ValueError(
            f"parts widths {start} != first-layer input {first.in_features}"
        )
    return MLP.forward(mlp[1:], x)
