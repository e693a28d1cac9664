"""K3, the fused edge-phase forward: counterpart of ``neural_lam_tpu/ops/pallas_fused.py``.

One call computes a whole GNN edge phase on receiver-sorted edges: the
optional edge embedder on the raw static edge features, the two-layer
edge MLP over ``[edge, sender, receiver]`` with its LayerNorm, the
optional edge-residual update and the sum of the messages into their
receivers (see ``csrc/fused_edge.cu`` for the formula).

- Replaces ``_fused_fwd_impl`` (pallas_fused.py:879, its pallas_call at
  :1033 over ``_fused_fwd_kernel`` :180 and ``_embed_forward`` :104),
  which ``make_fused_interaction`` builds. The TPU's one-hot gathers,
  ``kron(I, W)`` weights, lane stripes and blocked-CSR tiles are Mosaic
  workarounds and are not carried over.
- Bound on the H100: operations, in exact float32 on the SIMT units; the
  design keeps all weights in shared memory, computes the receiver
  projection once per receiver and the embedder once per edge, and sums
  each receiver's messages in one block without atomics.
- Supported on CUDA: hidden width 64, batch 1 to 32, raw edge features
  up to 8 wide, ``propagation`` and ``layer_norm=False`` in the kernel
  itself. Other shapes raise on CUDA. On a CPU tensor the wrapper runs
  :func:`fused_edge_phase_plain`.
- Forward-only: the backward kernel, K4 (``_fused_bwd_impl``), comes
  with the training slice.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import kernel_build
from .mlp import linear_layers, output_layer_norm
from .segment_kernels import check_forward_only

KERNEL = "fused_edge"
KERNEL_HIDDEN = 64
KERNEL_MAX_BATCH = 32
MAX_RAW_FEATURES = 8
_EDGE_RAW, _EDGE_SHARED, _EDGE_BATCHED = 0, 1, 2


def fusable(edge_mlp: nn.Sequential) -> bool:
    """True if the edge MLP has the two-linear-layer shape the fused
    phase implements (the ``hidden_layers=1`` default): a ``(3h -> h)``
    first layer over ``[edge, sender, receiver]`` and an ``(h -> h)``
    second layer."""
    layers = linear_layers(edge_mlp)
    if len(layers) != 2:
        return False
    h = layers[0].out_features
    return layers[0].in_features == 3 * h and (
        layers[1].in_features,
        layers[1].out_features,
    ) == (h, h)


def embedder_fusable(embedder: nn.Sequential, hidden: int) -> bool:
    """True if the edge embedder is the Linear-SiLU-Linear-LayerNorm the
    fused phase runs on the raw edge features."""
    layers = linear_layers(embedder)
    return (
        len(layers) == 2
        and output_layer_norm(embedder) is not None
        and layers[0].out_features == hidden
        and layers[0].in_features <= MAX_RAW_FEATURES
        and (layers[1].in_features, layers[1].out_features)
        == (hidden, hidden)
    )


def fused_edge_phase_plain(
    edge_mlp: nn.Sequential,
    edge_rep: Optional[torch.Tensor],
    x_send: torch.Tensor,
    rec_rep: torch.Tensor,
    receivers: torch.Tensor,
    embedder: Optional[nn.Sequential] = None,
    edge_feats: Optional[torch.Tensor] = None,
    update_edges: bool = False,
    propagation: bool = False,
):
    """Plain PyTorch version of K3 (same arguments as
    :func:`fused_edge_phase` plus the per-edge ``receivers``)."""
    lin1, lin2 = linear_layers(edge_mlp)
    ln = output_layer_norm(edge_mlp)
    d = lin2.out_features
    if embedder is not None:
        edge_rep = embedder(edge_feats)
    w1 = lin1.weight
    rec_proj = rec_rep @ w1[:, 2 * d :].T  # once per receiver
    edge_proj = edge_rep @ w1[:, :d].T
    if edge_rep.dim() == 2:
        edge_proj = edge_proj.unsqueeze(1)
    pre = (
        edge_proj
        + x_send @ w1[:, d : 2 * d].T
        + rec_proj.index_select(0, receivers)
        + lin1.bias
    )
    msg = lin2(F.silu(pre))
    if ln is not None:
        msg = ln(msg)
    if propagation:
        msg = msg + x_send
    new_edge = None
    if update_edges:
        base = edge_rep.unsqueeze(1) if edge_rep.dim() == 2 else edge_rep
        new_edge = base + msg
    aggr = torch.zeros_like(rec_rep).index_add_(0, receivers, msg)
    return aggr, new_edge


@functools.cache
def _lib():
    fn = kernel_build.load(KERNEL).nl_fused_edge_fwd
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 19
    fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _check(name: str, t: torch.Tensor, device: torch.device, shape) -> None:
    if t.device != device:
        raise ValueError(f"fused_edge_phase: {name} on {t.device}, not {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"fused_edge_phase: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"fused_edge_phase: {name} has shape {tuple(t.shape)}, "
            f"expected {tuple(shape)}"
        )
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"fused_edge_phase: {name} must be contiguous and aligned")


def fused_edge_phase(
    edge_mlp: nn.Sequential,
    edge_rep: Optional[torch.Tensor],
    x_send: torch.Tensor,
    rec_rep: torch.Tensor,
    edge_set,
    embedder: Optional[nn.Sequential] = None,
    edge_feats: Optional[torch.Tensor] = None,
    update_edges: bool = False,
    propagation: bool = False,
):
    """K3: the fused edge phase over ``edge_set`` (receiver-sorted CSR).

    ``x_send`` is ``(E, B, D)`` (sender rows from K1), ``rec_rep`` is
    ``(N_rec, B, D)``; the edge input is either ``edge_rep`` of shape
    ``(E, B, D)`` or ``(E, D)`` (shared across the batch), or, with
    ``embedder``, the raw ``edge_feats`` of shape ``(E, F)``. Returns
    ``(aggregated_sum (N_rec, B, D), new_edge (E, B, D) | None)``.
    """
    if x_send.device.type == "cpu":
        return fused_edge_phase_plain(
            edge_mlp, edge_rep, x_send, rec_rep, edge_set.receivers,
            embedder, edge_feats, update_edges, propagation,
        )
    if x_send.device.type != "cuda":
        raise RuntimeError(f"fused_edge_phase: unsupported device {x_send.device}")
    dev = x_send.device
    lin1, lin2 = linear_layers(edge_mlp)
    ln = output_layer_norm(edge_mlp)
    emb_lins = linear_layers(embedder) if embedder is not None else []
    emb_ln = output_layer_norm(embedder) if embedder is not None else None
    weights = [lin1.weight, lin1.bias, lin2.weight, lin2.bias]
    if ln is not None:
        weights += [ln.weight, ln.bias]
    for lin in emb_lins:
        weights += [lin.weight, lin.bias]
    if emb_ln is not None:
        weights += [emb_ln.weight, emb_ln.bias]
    check_forward_only("fused_edge_phase", x_send, rec_rep, edge_rep, *weights)

    d = KERNEL_HIDDEN
    if not fusable(edge_mlp) or lin2.out_features != d:
        raise ValueError(
            f"fused_edge_phase: the CUDA kernel takes a (3*{d} -> {d} -> {d}) "
            "edge MLP"
        )
    if x_send.dim() != 3:
        raise ValueError("fused_edge_phase: x_send must be (E, B, D)")
    n_edges, batch = x_send.shape[0], x_send.shape[1]
    num_rec = edge_set.num_rec
    if not 1 <= batch <= KERNEL_MAX_BATCH:
        raise ValueError(
            f"fused_edge_phase: batch {batch} outside 1..{KERNEL_MAX_BATCH}"
        )
    if n_edges != edge_set.num_edges:
        raise ValueError("fused_edge_phase: x_send rows != edges of the edge set")
    _check("x_send", x_send, dev, (n_edges, batch, d))
    _check("rec_rep", rec_rep, dev, (num_rec, batch, d))
    if ln is not None and ln.eps != 1e-5:
        raise ValueError("fused_edge_phase: the kernel's LayerNorm eps is 1e-5")
    feat = 0
    if embedder is not None:
        if not embedder_fusable(embedder, d) or emb_ln.eps != 1e-5:
            raise ValueError(
                "fused_edge_phase: the CUDA kernel takes a Linear-SiLU-"
                f"Linear-LayerNorm embedder of width {d} on at most "
                f"{MAX_RAW_FEATURES} raw features"
            )
        feat = emb_lins[0].in_features
        _check("edge_feats", edge_feats, dev, (n_edges, feat))
        edge_in, mode = edge_feats, _EDGE_RAW
    elif edge_rep.dim() == 2:
        _check("edge_rep", edge_rep, dev, (n_edges, d))
        edge_in, mode = edge_rep, _EDGE_SHARED
    else:
        _check("edge_rep", edge_rep, dev, (n_edges, batch, d))
        edge_in, mode = edge_rep, _EDGE_BATCHED
    for w in weights:
        if (
            w.device != dev
            or w.dtype != torch.float32
            or not w.is_contiguous()
            or w.data_ptr() % 16
        ):
            raise ValueError(
                "fused_edge_phase: weights must be contiguous, 16-byte "
                f"aligned float32 on {dev}"
            )
    rowptr = edge_set.rowptr
    if rowptr.device != dev or rowptr.dtype != torch.int32:
        raise ValueError("fused_edge_phase: edge set not on the kernel's device")

    aggr = torch.empty((num_rec, batch, d), dtype=torch.float32, device=dev)
    new_edge = (
        torch.empty((n_edges, batch, d), dtype=torch.float32, device=dev)
        if update_edges
        else None
    )
    if num_rec == 0:
        return aggr, new_edge
    emb = (
        [emb_lins[0].weight, emb_lins[0].bias, emb_lins[1].weight,
         emb_lins[1].bias, emb_ln.weight, emb_ln.bias]
        if embedder is not None
        else [None] * 6
    )
    err = _lib()(
        mode, num_rec, batch, feat, int(update_edges), int(propagation),
        int(ln is not None),
        _ptr(edge_in), _ptr(x_send), _ptr(rec_rep), _ptr(rowptr),
        _ptr(lin1.weight), _ptr(lin1.bias), _ptr(lin2.weight), _ptr(lin2.bias),
        _ptr(ln.weight if ln is not None else None),
        _ptr(ln.bias if ln is not None else None),
        *(_ptr(t) for t in emb),
        _ptr(aggr), _ptr(new_edge),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_edge_phase kernel launch failed: CUDA error {err}")
    fused_edge_phase.launches += 1
    return aggr, new_edge


fused_edge_phase.launches = 0
