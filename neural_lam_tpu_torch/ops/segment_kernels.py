"""K1 and K2, the sender gather and its backward, the sender scatter:
counterparts of ``neural_lam_tpu/ops/pallas_segment.py``.

``sender_gather(x, senders)`` returns ``x[senders]`` for node rows ``x``
of shape ``(N, ...)``: the per-edge sender features in the edge set's
receiver-sorted order. ``sender_scatter(g, edge_set, n)`` is its
transpose, ``dx[s] = sum of g[slot]`` over the slots with sender ``s``,
``(E, ...) -> (n, ...)``. :class:`SenderGather` ties the two into one
differentiable operation, which ``ops/segment.py::gather_senders`` calls.

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
- Bound on the H100: bytes, both. Every edge row is moved once and
  every node row once; the kernels move 16-byte words with consecutive
  threads on consecutive words (see the source notes).
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


def sender_gather_plain(x: torch.Tensor, senders: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: ``x[senders]`` along the row axis."""
    return x.index_select(0, senders)


def sender_scatter_plain(
    g: torch.Tensor, senders: torch.Tensor, num_rows: int
) -> torch.Tensor:
    """Plain PyTorch version of K2: ``index_add_`` of the edge rows
    ``g`` into ``num_rows`` zero rows at ``senders``."""
    out = g.new_zeros((num_rows,) + tuple(g.shape[1:]))
    return out.index_add_(0, senders.long(), g)


@functools.cache
def _gather_lib():
    fn = kernel_build.load(KERNEL).nl_sender_gather
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _scatter_lib():
    fn = kernel_build.load(SCATTER_KERNEL).nl_sender_scatter
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
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


def _check_rows(name: str, x: torch.Tensor, index: torch.Tensor) -> None:
    if index.device != x.device:
        raise ValueError(f"{name}: rows and indices on different devices")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: rows must be float32, got {x.dtype}")
    if index.dtype != torch.int32 or index.dim() != 1:
        raise TypeError(f"{name}: indices must be a 1-d int32 tensor")
    if not (x.is_contiguous() and index.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")


def sender_gather(x: torch.Tensor, senders: torch.Tensor) -> torch.Tensor:
    """K1: ``x[senders]`` for ``x`` of shape ``(N, *row)`` float32.

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
    _check_rows("sender_gather", x, senders)
    row = math.prod(x.shape[1:])
    out = torch.empty(
        (senders.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device
    )
    if senders.shape[0] == 0 or row == 0:
        return out
    vec4 = row % 4 == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    err = _gather_lib()(
        x.data_ptr(), senders.data_ptr(), out.data_ptr(),
        senders.shape[0], row, int(vec4),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"sender_gather kernel launch failed: CUDA error {err}")
    sender_gather.launches += 1
    return out


sender_gather.launches = 0


def sender_scatter(
    g: torch.Tensor, edge_set: "EdgeSet", num_rows: int
) -> torch.Tensor:
    """K2: ``dx[s] = sum of g[slot]`` over the slots of ``edge_set`` with
    sender ``s``, for ``g`` of shape ``(E, *row)`` float32. Returns
    ``(num_rows, *row)``; rows without a slot are 0. ``num_rows`` is the
    row count of the gather's input, which the edge set need not know."""
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
    _check_rows("sender_scatter", g, perm)
    if rowptr.device != g.device or rowptr.dtype != torch.int32:
        raise ValueError("sender_scatter: edge set not on the kernel's device")
    row = math.prod(g.shape[1:])
    out = torch.empty(
        (num_rows,) + tuple(g.shape[1:]), dtype=g.dtype, device=g.device
    )
    if num_rows == 0 or row == 0:
        return out
    vec4 = row % 4 == 0 and g.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    err = _scatter_lib()(
        g.data_ptr(), perm.data_ptr(), rowptr.data_ptr(), out.data_ptr(),
        num_rows, n_tab, row, int(vec4),
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"sender_scatter kernel launch failed: CUDA error {err}")
    sender_scatter.launches += 1
    return out


sender_scatter.launches = 0


class SenderGather(torch.autograd.Function):
    """``x[edge_set.senders]`` with K1 as its forward and K2 as its
    backward (their plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, edge_set: "EdgeSet") -> torch.Tensor:
        ctx.edge_set = edge_set
        ctx.num_rows = x.shape[0]
        return sender_gather(x, edge_set.senders)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return sender_scatter(grad.contiguous(), ctx.edge_set, ctx.num_rows), None
