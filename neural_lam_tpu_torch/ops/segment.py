"""Per-edge gathers and per-receiver aggregation.

Counterpart of ``neural_lam_tpu/ops/segment.py``. Node arrays are
``(N, ...)``, edge arrays ``(E, ...)`` in the edge set's receiver-sorted
order.

- ``gather_senders`` is ``segment_kernels.SenderGather``: K1 forward and
  K2, the sender scatter, backward; on CPU tensors both run their plain
  versions (``index_select`` and ``index_add_``).
- ``gather_receivers``, ``aggregate_sum`` and ``aggregate_mean`` are the
  unfused route's operations. Their TPU kernels (K6, the receiver
  expand, and K5, the segment sum) are not ported yet, so on CUDA
  tensors they raise instead of running a library operation in their
  place; on CPU tensors they run their plain versions (``index_select``
  and ``index_add_``).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from .segment_kernels import SenderGather

if TYPE_CHECKING:  # pragma: no cover
    from .interaction import EdgeSet


def _require_cpu(name: str, kernel: str, x: torch.Tensor) -> None:
    if x.device.type != "cpu":
        raise NotImplementedError(
            f"{name} on {x.device}: its kernel ({kernel}) is not ported "
            "yet; the unfused route runs on the CPU only"
        )


def gather_senders(edge_set: "EdgeSet", send_rep: torch.Tensor) -> torch.Tensor:
    """Per-edge sender features ``send_rep[senders]`` (K1; its gradient
    is K2)."""
    return SenderGather.apply(send_rep, edge_set)


def gather_receivers(edge_set: "EdgeSet", rec_rep: torch.Tensor) -> torch.Tensor:
    """Per-edge receiver features ``rec_rep[receivers]``."""
    _require_cpu("gather_receivers", "K6, the receiver expand", rec_rep)
    return rec_rep.index_select(0, edge_set.receivers)


def aggregate_sum(edge_set: "EdgeSet", messages: torch.Tensor) -> torch.Tensor:
    """Per-receiver sums of ``(E, ...)`` messages; receivers without
    edges get 0."""
    _require_cpu("aggregate_sum", "K5, the segment sum", messages)
    out = messages.new_zeros((edge_set.num_rec,) + tuple(messages.shape[1:]))
    return out.index_add_(0, edge_set.receivers, messages)


def mean_divisor(edge_set: "EdgeSet", like: torch.Tensor) -> torch.Tensor:
    """Per-receiver edge counts clamped to at least 1, shaped to divide
    an ``(N_rec, ...)`` array like ``like``."""
    counts = edge_set.recv_counts.clamp(min=1).to(like.dtype)
    return counts.reshape((-1,) + (1,) * (like.dim() - 1))


def aggregate_mean(edge_set: "EdgeSet", messages: torch.Tensor) -> torch.Tensor:
    """Mean over each receiver's edges; receivers without edges get 0."""
    summed = aggregate_sum(edge_set, messages)
    return summed / mean_divisor(edge_set, summed)
