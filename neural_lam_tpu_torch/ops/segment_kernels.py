"""K1, the sender gather: counterpart of ``neural_lam_tpu/ops/pallas_segment.py``.

``sender_gather(x, senders)`` returns ``x[senders]`` for node rows ``x``
of shape ``(N, ...)``: the per-edge sender features in the edge set's
receiver-sorted order.

- Replaces ``banded_expand_nondiff`` (pallas_segment.py:821, its
  ``_banded_kernel(transpose=True)`` pallas_call at :872), reached
  through ``ops/segment.py::gather_senders``. The TPU kernel gathers by
  one-hot MXU matmuls against banded sender windows, with dead slots
  reading zero; the port's edge sets have no dead slots, and Hopper has
  indexed loads, so the CUDA kernel (``csrc/sender_gather.cu``) is a
  row copy.
- Bound on the H100: bytes. Every output row is written once and its
  sender row read once; the kernel moves 16-byte words with consecutive
  threads on consecutive words (see the source note).
- On a CPU tensor the wrapper runs :func:`sender_gather_plain`
  (``index_select``); on a CUDA tensor it launches the kernel or raises.
  The kernel is forward-only: its VJP, K2 (``banded_scatter_nondiff``),
  comes with the training slice.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import kernel_build

KERNEL = "sender_gather"


def sender_gather_plain(x: torch.Tensor, senders: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1: ``x[senders]`` along the row axis."""
    return x.index_select(0, senders)


@functools.cache
def _lib():
    lib = kernel_build.load(KERNEL)
    fn = lib.nl_sender_gather
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def check_forward_only(name: str, *tensors) -> None:
    """The port's kernels have no backward yet: refuse inputs that
    autograd would need to differentiate through."""
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    ):
        raise RuntimeError(
            f"{name} is forward-only: its backward kernels (K2 and K4) "
            "come with the training slice; run the forecast under "
            "torch.no_grad() or torch.inference_mode()"
        )


def sender_gather(x: torch.Tensor, senders: torch.Tensor) -> torch.Tensor:
    """K1: ``x[senders]`` for ``x`` of shape ``(N, *row)`` float32.

    ``senders`` is an int32 index vector on the same device with entries
    in ``[0, N)`` (validated when the edge set is built). Returns
    ``(len(senders), *row)``.
    """
    if x.device.type == "cpu":
        return sender_gather_plain(x, senders)
    if x.device.type != "cuda":
        raise RuntimeError(f"sender_gather: unsupported device {x.device}")
    check_forward_only("sender_gather", x)
    if senders.device != x.device:
        raise ValueError("sender_gather: x and senders on different devices")
    if x.dtype != torch.float32:
        raise TypeError(f"sender_gather: x must be float32, got {x.dtype}")
    if senders.dtype != torch.int32 or senders.dim() != 1:
        raise TypeError("sender_gather: senders must be a 1-d int32 tensor")
    if not (x.is_contiguous() and senders.is_contiguous()):
        raise ValueError("sender_gather: inputs must be contiguous")
    row = math.prod(x.shape[1:])
    out = torch.empty(
        (senders.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device
    )
    if senders.shape[0] == 0 or row == 0:
        return out
    vec4 = row % 4 == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    err = _lib()(
        x.data_ptr(), senders.data_ptr(), out.data_ptr(),
        senders.shape[0], row, int(vec4),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"sender_gather kernel launch failed: CUDA error {err}")
    sender_gather.launches += 1
    return out


sender_gather.launches = 0
