"""Per-edge gathers and per-receiver aggregation.

Counterpart of ``neural_lam_tpu/ops/segment.py``. Node arrays are
``(N, ...)``, edge arrays ``(E, ...)`` in the edge set's receiver-sorted
order.

- ``gather_senders`` is ``segment_kernels.SenderGather``: K1 forward and
  K2, the sender scatter, backward.
- ``gather_receivers`` is ``segment_kernels.ReceiverGather``: K6, the
  receiver expand, forward and K5, the segment sum, backward.
- ``aggregate_sum`` is ``segment_kernels.SegmentSum``: K5 forward and K6
  backward; ``aggregate_mean`` divides its result by the receivers' edge
  counts.

These are the operations of the unfused route of
``ops/interaction.py::apply_interaction_net``. On CUDA tensors they
launch the kernels; on CPU tensors the kernels' plain versions
(``index_select`` and ``index_add_``) run.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from .segment_kernels import ReceiverGather, SegmentSum, SenderGather

if TYPE_CHECKING:  # pragma: no cover
    from .interaction import EdgeSet


def gather_senders(edge_set: "EdgeSet", send_rep: torch.Tensor) -> torch.Tensor:
    """Per-edge sender features ``send_rep[senders]`` (K1; its gradient
    is K2)."""
    return SenderGather.apply(send_rep, edge_set)


def gather_receivers(edge_set: "EdgeSet", rec_rep: torch.Tensor) -> torch.Tensor:
    """Per-edge receiver features ``rec_rep[receivers]`` (K6; its
    gradient is K5)."""
    return ReceiverGather.apply(rec_rep.contiguous(), edge_set)


def aggregate_sum(edge_set: "EdgeSet", messages: torch.Tensor) -> torch.Tensor:
    """Per-receiver sums of ``(E, ...)`` messages; receivers without
    edges get 0 (K5; its gradient is K6)."""
    return SegmentSum.apply(messages.contiguous(), edge_set)


def mean_divisor(edge_set: "EdgeSet", like: torch.Tensor) -> torch.Tensor:
    """Per-receiver edge counts clamped to at least 1, shaped to divide
    an ``(N_rec, ...)`` array like ``like``."""
    counts = edge_set.recv_counts.clamp(min=1).to(like.dtype)
    return counts.reshape((-1,) + (1,) * (like.dim() - 1))


def aggregate_mean(edge_set: "EdgeSet", messages: torch.Tensor) -> torch.Tensor:
    """Mean over each receiver's edges; receivers without edges get 0."""
    summed = aggregate_sum(edge_set, messages)
    return summed / mean_divisor(edge_set, summed)
