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

The reduced precisions are read here, from the JAX package's environment
variables, at every call (``neural_lam_tpu/ops/segment.py:80-131``,
``:205-216``):

- ``NEURAL_LAM_TPU_MATMUL_PRECISION``: ``default`` and ``highest`` are the
  port's float32 path (3xTF32 in the kernels, TF32 off in cuBLAS);
  ``high`` rounds the fused kernels' matmul operands and their and the
  sender gather's streams to bf16 (:func:`matmul_high`); ``high-kernels``
  only the kernels' operands, the streams stay float32
  (:func:`kernel_matmul_high`). cuBLAS stays float32 under every value,
  as XLA's matmuls stay float32 in the JAX package on the CPU.
- ``NEURAL_LAM_TPU_BF16_KERNELS``: with bf16 inputs (mixed precision),
  ``auto`` lets the bf16 rows reach the kernels, ``off`` keeps the
  kernels float32 with casts at their boundary.

``gather_senders`` runs K1 and K2 in :func:`gather_io_dtype`; K5 and K6
run in float32 with casts around them, as ``_fold_rows`` does there.
"""

from __future__ import annotations

import os
from typing import TYPE_CHECKING

import torch

from .segment_kernels import ReceiverGather, SegmentSum, SenderGather

if TYPE_CHECKING:  # pragma: no cover
    from .interaction import EdgeSet


MATMUL_PRECISION_ENV = "NEURAL_LAM_TPU_MATMUL_PRECISION"
BF16_KERNELS_ENV = "NEURAL_LAM_TPU_BF16_KERNELS"
MATMUL_PRECISIONS = ("default", "highest", "high", "high-kernels")


def matmul_precision() -> str:
    """``NEURAL_LAM_TPU_MATMUL_PRECISION`` as it stands (``default``
    when unset); raises ``ValueError`` for a value the JAX CLI does not
    offer."""
    value = os.environ.get(MATMUL_PRECISION_ENV, "default")
    if value not in MATMUL_PRECISIONS:
        raise ValueError(
            f"{MATMUL_PRECISION_ENV}={value!r}: expected one of "
            f"{', '.join(MATMUL_PRECISIONS)}"
        )
    return value


def apply_matmul_precision() -> None:
    """The entry points' counterpart of the JAX package's
    ``apply_matmul_precision``: checks the variable, and under
    ``highest`` turns TF32 off in cuBLAS (the JAX package sets
    ``jax_default_matmul_precision`` there). ``default`` is the same
    float32 path already, TF32 being off in PyTorch unless a caller
    turned it on; ``high`` and ``high-kernels`` act in the kernels and
    the gather streams (:func:`matmul_high`, :func:`kernel_matmul_high`),
    read at every call."""
    if matmul_precision() == "highest":
        torch.backends.cuda.matmul.allow_tf32 = False


def matmul_high() -> bool:
    """``high``: the fused kernels' matmul operands and the streams of
    the kernels and of the sender gather in bf16."""
    return matmul_precision() == "high"


def kernel_matmul_high() -> bool:
    """``high`` or ``high-kernels``: the fused kernels' matmul operands
    in bf16 (float32 accumulation)."""
    return matmul_precision() in ("high", "high-kernels")


def bf16_kernels() -> bool:
    """May bf16 inputs reach the kernels as bf16
    (``NEURAL_LAM_TPU_BF16_KERNELS`` other than ``off``)?"""
    return os.environ.get(BF16_KERNELS_ENV, "auto") != "off"


def gather_io_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the sender gather (K1, and K2 backward) runs in for
    rows of ``dtype``: bf16 for float32 rows under ``high`` and for bf16
    rows unless ``NEURAL_LAM_TPU_BF16_KERNELS=off``, else float32 (the
    JAX package's ``_gather_io_dtype``)."""
    if dtype == torch.float32 and matmul_high():
        return torch.bfloat16
    if dtype == torch.bfloat16 and bf16_kernels():
        return torch.bfloat16
    return torch.float32


def gather_senders(edge_set: "EdgeSet", send_rep: torch.Tensor) -> torch.Tensor:
    """Per-edge sender features ``send_rep[senders]`` (K1; its gradient
    is K2), in :func:`gather_io_dtype` with casts from and back to the
    input's dtype."""
    io = gather_io_dtype(send_rep.dtype)
    return SenderGather.apply(send_rep.to(io), edge_set).to(send_rep.dtype)


def gather_receivers(edge_set: "EdgeSet", rec_rep: torch.Tensor) -> torch.Tensor:
    """Per-edge receiver features ``rec_rep[receivers]`` (K6; its
    gradient is K5), in float32."""
    out = ReceiverGather.apply(rec_rep.float().contiguous(), edge_set)
    return out.to(rec_rep.dtype)


def aggregate_sum(edge_set: "EdgeSet", messages: torch.Tensor) -> torch.Tensor:
    """Per-receiver sums of ``(E, ...)`` messages; receivers without
    edges get 0 (K5; its gradient is K6), in float32."""
    out = SegmentSum.apply(messages.float().contiguous(), edge_set)
    return out.to(messages.dtype)


def mean_divisor(edge_set: "EdgeSet", like: torch.Tensor) -> torch.Tensor:
    """Per-receiver edge counts clamped to at least 1, shaped to divide
    an ``(N_rec, ...)`` array like ``like``."""
    counts = edge_set.recv_counts.clamp(min=1).to(like.dtype)
    return counts.reshape((-1,) + (1,) * (like.dim() - 1))


def aggregate_mean(edge_set: "EdgeSet", messages: torch.Tensor) -> torch.Tensor:
    """Mean over each receiver's edges; receivers without edges get 0."""
    summed = aggregate_sum(edge_set, messages)
    return summed / mean_divisor(edge_set, summed)
