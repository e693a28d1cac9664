"""K1, K2, K5 and K6, the row gathers and sums over an edge set:
counterparts of ``neural_lam_tpu/ops/pallas_segment.py``.

``sender_gather(x, senders)`` returns ``x[senders]`` for node rows ``x``
of shape ``(N, ...)``: the per-edge sender features in the edge set's
receiver-sorted order. ``sender_scatter(g, edge_set, n)`` is its
transpose, ``dx[s] = sum of g[slot]`` over the slots with sender ``s``,
``(E, ...) -> (n, ...)``. :class:`SenderGather` ties the two into one
differentiable operation, which ``ops/segment.py::gather_senders`` calls.

``receiver_expand(x, edge_set)`` returns ``x[receivers]``, ``(num_rec,
...) -> (E, ...)``, and ``segment_sum(msg, edge_set)`` is its transpose,
``out[r] = sum of msg[slot]`` over the slots with receiver ``r``.
:class:`ReceiverGather` (K6 forward, K5 backward) and
:class:`SegmentSum` (K5 forward, K6 backward) are the differentiable
operations of the unfused route, ``ops/segment.py::gather_receivers``
and ``aggregate_sum``.

- K1 replaces ``banded_expand_nondiff`` (pallas_segment.py:821, its
  ``_banded_kernel(transpose=True)`` pallas_call at :872) and K2
  ``banded_scatter_nondiff`` (:766, the ``transpose=False`` call at
  :810). The TPU kernels gather and scatter by one-hot MXU matmuls
  against banded sender windows, with dead slots reading zero; the
  port's edge sets have no dead slots, and Hopper has indexed loads, so
  K1 (``csrc/sender_gather.cu``) is a row copy and K2
  (``csrc/sender_scatter.cu``) a gather-reduce over the edge set's
  sender-sorted tables: each output row is summed in a fixed slot order
  by the threads that own it, without float atomics, so the sum is
  deterministic as the JAX one is.
- K5 replaces ``_blocked_segment_sum_fwd_impl`` (pallas_segment.py:331,
  its pallas_call at :380, reached through
  ``blocked_segment_sum_nondiff`` :456 and ``make_blocked_segment_sum``
  :485) and K6 ``_blocked_segment_sum_bwd_impl`` (:407, its pallas_call
  at :446, reached through ``blocked_expand_nondiff`` :470). The TPU
  kernels walk a blocked-CSR layout with one-hot matmuls; the port's
  edge sets are receiver-sorted CSR, so each receiver's slots are a
  contiguous run of rows: K5 (``csrc/segment_sum.cu``) is a segmented
  reduction over contiguous rows in slot order, without atomics, and K6
  (``csrc/receiver_expand.cu``) a row copy driven by ``rowptr``.
- Bound on the H100: bytes, all four. Every edge row is moved once and
  every node row once; the kernels move 16-byte words with consecutive
  threads on consecutive words (see the source notes).
- K1 and K2 also take bf16 rows, as the JAX package's gather does under
  mixed precision and ``NEURAL_LAM_TPU_MATMUL_PRECISION=high``
  (ops/segment.py:205-320): K1 copies them (``nl_sender_gather_bf16``),
  K2 widens each to float32 and returns float32 sums
  (``nl_sender_scatter_bf16``, the JAX kernel's ``out_dtype=float32``).
  Each bf16 variant counts its launches apart from the float32 kernel's,
  in :data:`SENDER_GATHER_BF16` and :data:`SENDER_SCATTER_BF16`. K5 and
  K6 take float32 only (the JAX package casts around them).
- On a CPU tensor the wrappers run the plain versions (``index_select``
  and ``index_add_``); on a CUDA tensor they launch the kernels or
  raise.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import TYPE_CHECKING

import torch

from . import kernel_build

if TYPE_CHECKING:  # pragma: no cover
    from .interaction import EdgeSet

KERNEL = "sender_gather"
SCATTER_KERNEL = "sender_scatter"
SEGMENT_SUM_KERNEL = "segment_sum"
EXPAND_KERNEL = "receiver_expand"


class LaunchCount:
    """The launch count of a kernel variant that has no wrapper of its
    own: the wrapper that launches it adds one to ``launches``."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.launches = 0


SENDER_GATHER_BF16 = LaunchCount("K1 sender_gather bf16")
SENDER_SCATTER_BF16 = LaunchCount("K2 sender_scatter bf16")


def sender_gather_plain(x: torch.Tensor, senders: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: ``x[senders]`` along the row axis."""
    return x.index_select(0, senders)


def sender_scatter_plain(
    g: torch.Tensor, senders: torch.Tensor, num_rows: int
) -> torch.Tensor:
    """Plain PyTorch version of K2: ``index_add_`` of the edge rows
    ``g`` into ``num_rows`` zero rows at ``senders``, float32 sums (bf16
    rows are widened first, as K2 widens them)."""
    g = g.float()
    out = g.new_zeros((num_rows,) + tuple(g.shape[1:]))
    return out.index_add_(0, senders.long(), g)


def segment_sum_plain(
    messages: torch.Tensor, receivers: torch.Tensor, num_rec: int
) -> torch.Tensor:
    """Plain PyTorch version of K5: ``index_add_`` of the edge rows
    ``messages`` into ``num_rec`` zero rows at ``receivers``."""
    out = messages.new_zeros((num_rec,) + tuple(messages.shape[1:]))
    return out.index_add_(0, receivers.long(), messages)


def receiver_expand_plain(x: torch.Tensor, receivers: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K6: ``x[receivers]`` along the row axis."""
    return x.index_select(0, receivers)


@functools.cache
def _gather_lib(symbol: str = "nl_sender_gather"):
    fn = getattr(kernel_build.load(KERNEL), symbol)
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _scatter_lib(symbol: str = "nl_sender_scatter"):
    fn = getattr(kernel_build.load(SCATTER_KERNEL), symbol)
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _rowptr_lib(kernel: str, symbol: str):
    """K5's and K6's launchers share one signature: ``(in, rowptr, out,
    n_rec, row_width, vec4, stream)``."""
    fn = getattr(kernel_build.load(kernel), symbol)
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def refuse_autograd(name: str, use: str, *tensors) -> None:
    """A kernel launcher records no autograd graph: refuse an input that
    autograd would differentiate through, and name the differentiable
    entry point. Inside a ``Function``'s forward grad mode is off, so
    the launchers pass there."""
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    ):
        raise RuntimeError(
            f"{name} launches a kernel outside autograd; differentiate "
            f"through {use} instead"
        )


def _check_rows(name: str, x: torch.Tensor, index: torch.Tensor,
                bf16: bool = False) -> None:
    """Refuse rows the kernel does not take: float32 rows, or with
    ``bf16`` also bf16 rows."""
    if index.device != x.device:
        raise ValueError(f"{name}: rows and indices on different devices")
    allowed = (torch.float32, torch.bfloat16) if bf16 else (torch.float32,)
    if x.dtype not in allowed:
        names = " or ".join(str(d).replace("torch.", "") for d in allowed)
        raise TypeError(f"{name}: rows must be {names}, got {x.dtype}")
    if index.dtype != torch.int32 or index.dim() != 1:
        raise TypeError(f"{name}: indices must be a 1-d int32 tensor")
    if not (x.is_contiguous() and index.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")


def sender_gather(x: torch.Tensor, senders: torch.Tensor) -> torch.Tensor:
    """K1: ``x[senders]`` for ``x`` of shape ``(N, *row)`` float32 or
    bf16 (the bf16 variant; the result has the rows' dtype).

    ``senders`` is an int32 index vector on the same device with entries
    in ``[0, N)`` (validated when the edge set is built). Returns
    ``(len(senders), *row)``. The launcher itself is not differentiable:
    :class:`SenderGather` is.
    """
    if x.device.type == "cpu":
        return sender_gather_plain(x, senders)
    if x.device.type != "cuda":
        raise RuntimeError(f"sender_gather: unsupported device {x.device}")
    refuse_autograd("sender_gather", "ops.segment.gather_senders", x)
    _check_rows("sender_gather", x, senders, bf16=True)
    bf16 = x.dtype == torch.bfloat16
    row = math.prod(x.shape[1:])
    out = torch.empty(
        (senders.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device
    )
    if senders.shape[0] == 0 or row == 0:
        return out
    per_word = 8 if bf16 else 4  # elements of a 16-byte word
    vec4 = row % per_word == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    err = _gather_lib("nl_sender_gather_bf16" if bf16 else "nl_sender_gather")(
        x.data_ptr(), senders.data_ptr(), out.data_ptr(),
        senders.shape[0], row, int(vec4),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"sender_gather kernel launch failed: CUDA error {err}")
    (SENDER_GATHER_BF16 if bf16 else sender_gather).launches += 1
    return out


sender_gather.launches = 0


def sender_scatter(
    g: torch.Tensor, edge_set: "EdgeSet", num_rows: int
) -> torch.Tensor:
    """K2: ``dx[s] = sum of g[slot]`` over the slots of ``edge_set`` with
    sender ``s``, for ``g`` of shape ``(E, *row)`` float32 or bf16 (the
    bf16 variant). Returns float32 sums ``(num_rows, *row)``; rows without
    a slot are 0. ``num_rows`` is the row count of the gather's input,
    which the edge set need not know."""
    n_tab = edge_set.send_rowptr.shape[0] - 1
    if g.shape[0] != edge_set.num_edges:
        raise ValueError("sender_scatter: g rows != edges of the edge set")
    if num_rows < n_tab:
        raise ValueError(
            f"sender_scatter: {num_rows} rows for an edge set with senders "
            f"up to {n_tab - 1}"
        )
    if g.device.type == "cpu":
        return sender_scatter_plain(g, edge_set.senders, num_rows)
    if g.device.type != "cuda":
        raise RuntimeError(f"sender_scatter: unsupported device {g.device}")
    refuse_autograd("sender_scatter", "ops.segment.gather_senders", g)
    perm, rowptr = edge_set.send_perm, edge_set.send_rowptr
    _check_rows("sender_scatter", g, perm, bf16=True)
    if rowptr.device != g.device or rowptr.dtype != torch.int32:
        raise ValueError("sender_scatter: edge set not on the kernel's device")
    bf16 = g.dtype == torch.bfloat16
    row = math.prod(g.shape[1:])
    out = torch.empty(
        (num_rows,) + tuple(g.shape[1:]), dtype=torch.float32, device=g.device
    )
    if num_rows == 0 or row == 0:
        return out
    vec4 = (
        row % 4 == 0 and g.data_ptr() % (8 if bf16 else 16) == 0
        and out.data_ptr() % 16 == 0
    )
    err = _scatter_lib("nl_sender_scatter_bf16" if bf16 else "nl_sender_scatter")(
        g.data_ptr(), perm.data_ptr(), rowptr.data_ptr(), out.data_ptr(),
        num_rows, n_tab, row, int(vec4),
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"sender_scatter kernel launch failed: CUDA error {err}")
    (SENDER_SCATTER_BF16 if bf16 else sender_scatter).launches += 1
    return out


sender_scatter.launches = 0


class SenderGather(torch.autograd.Function):
    """``x[edge_set.senders]`` with K1 as its forward and K2 as its
    backward (their plain versions on CPU tensors). K2's float32 sums are
    cast to the gradient's dtype, as the JAX package's VJP casts them
    (ops/segment.py:265, :314)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, edge_set: "EdgeSet") -> torch.Tensor:
        ctx.edge_set = edge_set
        ctx.num_rows = x.shape[0]
        return sender_gather(x, edge_set.senders)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        d_x = sender_scatter(grad.contiguous(), ctx.edge_set, ctx.num_rows)
        return d_x.to(grad.dtype), None


def _launch_rowptr(name, lib, src, edge_set, out, num_rec) -> bool:
    """Check and launch K5 or K6 (``src`` rows in, ``out`` rows out, both
    walked by ``edge_set.rowptr``); False if there was nothing to do."""
    rowptr = edge_set.rowptr
    _check_rows(name, src, rowptr)
    if rowptr.shape[0] != num_rec + 1:
        raise ValueError(f"{name}: rowptr does not cover {num_rec} receivers")
    row = math.prod(src.shape[1:])
    if num_rec == 0 or row == 0 or out.numel() == 0:
        return False
    vec4 = row % 4 == 0 and src.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    err = lib(
        src.data_ptr(), rowptr.data_ptr(), out.data_ptr(), num_rec, row,
        int(vec4), torch.cuda.current_stream(src.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return True


def segment_sum(messages: torch.Tensor, edge_set: "EdgeSet") -> torch.Tensor:
    """K5: ``out[r] = sum of messages[slot]`` over the slots of
    ``edge_set`` with receiver ``r``, for ``messages`` of shape
    ``(E, *row)`` float32 in the edge set's order. Returns
    ``(num_rec, *row)``; receivers without a slot get 0. The launcher is
    not differentiable: :class:`SegmentSum` is."""
    num_rec = edge_set.num_rec
    if messages.shape[0] != edge_set.num_edges:
        raise ValueError("segment_sum: message rows != edges of the edge set")
    if messages.device.type == "cpu":
        return segment_sum_plain(messages, edge_set.receivers, num_rec)
    if messages.device.type != "cuda":
        raise RuntimeError(f"segment_sum: unsupported device {messages.device}")
    refuse_autograd("segment_sum", "ops.segment.aggregate_sum", messages)
    out = torch.empty(
        (num_rec,) + tuple(messages.shape[1:]),
        dtype=messages.dtype, device=messages.device,
    )
    if messages.shape[0] == 0:
        return out.zero_()  # no slot: every sum is empty
    lib = _rowptr_lib(SEGMENT_SUM_KERNEL, "nl_segment_sum")
    if _launch_rowptr("segment_sum", lib, messages, edge_set, out, num_rec):
        segment_sum.launches += 1
    return out


segment_sum.launches = 0


def receiver_expand(x: torch.Tensor, edge_set: "EdgeSet") -> torch.Tensor:
    """K6: ``x[receivers]`` for ``x`` of shape ``(num_rec, *row)``
    float32: each receiver's row copied to its slots, ``(E, *row)`` in
    the edge set's order. The launcher is not differentiable:
    :class:`ReceiverGather` is."""
    num_rec = edge_set.num_rec
    if x.shape[0] != num_rec:
        raise ValueError(
            f"receiver_expand: {x.shape[0]} rows for an edge set with "
            f"{num_rec} receivers"
        )
    if x.device.type == "cpu":
        return receiver_expand_plain(x, edge_set.receivers)
    if x.device.type != "cuda":
        raise RuntimeError(f"receiver_expand: unsupported device {x.device}")
    refuse_autograd("receiver_expand", "ops.segment.gather_receivers", x)
    out = torch.empty(
        (edge_set.num_edges,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device
    )
    lib = _rowptr_lib(EXPAND_KERNEL, "nl_receiver_expand")
    if _launch_rowptr("receiver_expand", lib, x, edge_set, out, num_rec):
        receiver_expand.launches += 1
    return out


receiver_expand.launches = 0


class ReceiverGather(torch.autograd.Function):
    """``x[edge_set.receivers]`` with K6 as its forward and K5 as its
    backward (their plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, edge_set: "EdgeSet") -> torch.Tensor:
        ctx.edge_set = edge_set
        return receiver_expand(x, edge_set)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return segment_sum(grad.contiguous(), ctx.edge_set), None


class SegmentSum(torch.autograd.Function):
    """Per-receiver sums of the edge rows with K5 as its forward and K6
    as its backward (their plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, messages: torch.Tensor, edge_set: "EdgeSet") -> torch.Tensor:
        ctx.edge_set = edge_set
        return segment_sum(messages, edge_set)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return receiver_expand(grad.contiguous(), ctx.edge_set), None
