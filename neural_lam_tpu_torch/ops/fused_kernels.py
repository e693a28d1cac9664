"""K3 and K4, the fused edge phase and its backward: counterparts of
``neural_lam_tpu/ops/pallas_fused.py``.

One call computes a whole GNN edge phase on receiver-sorted edges: the
optional edge embedder on the raw static edge features, the two-layer
edge MLP over ``[edge, sender, receiver]`` with its LayerNorm, the
optional edge-residual update and the sum of the messages into their
receivers (see ``csrc/fused_edge.cu`` for the formula, and
``csrc/fused_edge_bwd.cu`` for its gradients).

- K3 replaces ``_fused_fwd_impl`` (pallas_fused.py:879, its pallas_call
  at :1033 over ``_fused_fwd_kernel`` :180 and ``_embed_forward`` :104)
  and K4 ``_fused_bwd_impl`` (:1052, its pallas_call at :1298 over
  ``_fused_bwd_kernel`` :397 and ``_embed_backward`` :124), which
  ``make_fused_interaction`` ties into one ``custom_vjp``;
  :class:`FusedEdgePhase` is that ``custom_vjp``'s counterpart. The
  TPU's one-hot gathers, ``kron(I, W)`` weights, lane stripes and
  blocked-CSR tiles are Mosaic workarounds and are not carried over.
- Bound on the H100: operations, in exact float32 on the SIMT units.
  K3 keeps all weights in shared memory, computes the receiver
  projection once per receiver and the embedder once per edge, and sums
  each receiver's messages in one block without atomics. When the call
  will be differentiated K3 also writes the first layer's
  pre-activation, and K4 starts from it: persistent blocks that own
  whole receivers keep their share of every weight gradient in
  registers, write it once to a workspace, and a last small kernel sums
  the workspace in block order, so the gradients are deterministic.
- The gradient of the receiver rows and of the receiver slice of the
  first layer are node-sized products of K4's ``d_recproj`` output,
  formed here with ``torch`` as the JAX package forms them outside its
  kernel (pallas_fused.py:1624-1631).
- Supported on CUDA: hidden width 64, batch 1 to 32, raw edge features
  up to 8 wide, ``propagation`` and ``layer_norm=False`` in the kernels
  themselves. Other shapes raise on CUDA. On a CPU tensor the forward
  runs :func:`fused_edge_phase_plain` and the backward differentiates
  it with autograd.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import kernel_build
from .mlp import LN_EPS, linear_layers, output_layer_norm
from .segment_kernels import refuse_autograd

KERNEL = "fused_edge"
BWD_KERNEL = "fused_edge_bwd"
KERNEL_HIDDEN = 64
KERNEL_MAX_BATCH = 32
MAX_RAW_FEATURES = 8
_EDGE_RAW, _EDGE_SHARED, _EDGE_BATCHED = 0, 1, 2
# floats per block of K4's two workspaces (csrc/fused_edge_bwd.cu:
# kMainStride, kEdgeStride)
_MAT = KERNEL_HIDDEN * KERNEL_HIDDEN
_WS_MAIN = 3 * _MAT + 4 * KERNEL_HIDDEN
_WS_EDGE = 2 * _MAT + MAX_RAW_FEATURES * KERNEL_HIDDEN + 4 * KERNEL_HIDDEN


def _ln_ok(mlp: nn.Sequential) -> bool:
    ln = output_layer_norm(mlp)
    return ln is None or ln.eps == LN_EPS


def fusable(edge_mlp: nn.Sequential) -> bool:
    """True if the edge MLP has the two-linear-layer shape the fused
    phase implements (the ``hidden_layers=1`` default): a ``(3h -> h)``
    first layer over ``[edge, sender, receiver]`` and an ``(h -> h)``
    second layer, with the default LayerNorm eps if it has one."""
    layers = linear_layers(edge_mlp)
    if len(layers) != 2:
        return False
    h = layers[0].out_features
    return (
        layers[0].in_features == 3 * h
        and (layers[1].in_features, layers[1].out_features) == (h, h)
        and _ln_ok(edge_mlp)
    )


def embedder_fusable(embedder: nn.Sequential, hidden: int) -> bool:
    """True if the edge embedder is the Linear-SiLU-Linear-LayerNorm the
    fused phase runs on the raw edge features."""
    layers = linear_layers(embedder)
    return (
        len(layers) == 2
        and output_layer_norm(embedder) is not None
        and _ln_ok(embedder)
        and layers[0].out_features == hidden
        and layers[0].in_features <= MAX_RAW_FEATURES
        and (layers[1].in_features, layers[1].out_features)
        == (hidden, hidden)
    )


def _weights(edge_mlp: nn.Sequential, embedder: Optional[nn.Sequential]):
    """The twelve weight tensors of the phase, None where a part is
    absent: ``w1 b1 w2 b2 gamma beta | ew1 eb1 ew2 eb2 eg ebt``."""
    lin1, lin2 = linear_layers(edge_mlp)
    ln = output_layer_norm(edge_mlp)
    out = [lin1.weight, lin1.bias, lin2.weight, lin2.bias]
    out += [ln.weight, ln.bias] if ln is not None else [None, None]
    if embedder is None:
        return out + [None] * 6
    e1, e2 = linear_layers(embedder)
    eln = output_layer_norm(embedder)
    return out + [e1.weight, e1.bias, e2.weight, e2.bias, eln.weight, eln.bias]


def _plain(edge_in, x_send, rec_rep, receivers, weights, raw, update_edges,
           propagation):
    """The phase in plain PyTorch on the weight tensors of :func:`_weights`."""
    w1, b1, w2, b2, gamma, beta, ew1, eb1, ew2, eb2, eg, ebt = weights
    d = w2.shape[0]
    if raw:
        edge_rep = F.layer_norm(
            F.linear(F.silu(F.linear(edge_in, ew1, eb1)), ew2, eb2),
            (d,), eg, ebt, LN_EPS,
        )
    else:
        edge_rep = edge_in
    rec_proj = rec_rep @ w1[:, 2 * d :].T  # once per receiver
    edge_proj = edge_rep @ w1[:, :d].T
    if edge_rep.dim() == 2:
        edge_proj = edge_proj.unsqueeze(1)
    pre = (
        edge_proj
        + x_send @ w1[:, d : 2 * d].T
        + rec_proj.index_select(0, receivers)
        + b1
    )
    msg = F.linear(F.silu(pre), w2, b2)
    if gamma is not None:
        msg = F.layer_norm(msg, (d,), gamma, beta, LN_EPS)
    if propagation:
        msg = msg + x_send
    new_edge = None
    if update_edges:
        base = edge_rep.unsqueeze(1) if edge_rep.dim() == 2 else edge_rep
        new_edge = base + msg
    aggr = torch.zeros_like(rec_rep).index_add_(0, receivers, msg)
    return aggr, new_edge


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
    :func:`fused_edge_phase` plus the per-edge ``receivers``). Autograd
    through it is the plain version of K4."""
    raw = embedder is not None
    return _plain(
        edge_feats if raw else edge_rep, x_send, rec_rep, receivers,
        _weights(edge_mlp, embedder), raw, update_edges, propagation,
    )


@functools.cache
def _fwd_lib():
    fn = kernel_build.load(KERNEL).nl_fused_edge_fwd
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 20
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_lib():
    fn = kernel_build.load(BWD_KERNEL).nl_fused_edge_bwd
    fn.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p] * 25
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


def _check_inputs(edge_in, x_send, rec_rep, edge_set, weights, raw) -> tuple[int, int]:
    """Refuse what the CUDA kernels do not take; returns the edge mode
    and the raw feature width."""
    dev, d = x_send.device, KERNEL_HIDDEN
    w1, _, w2 = weights[:3]
    if tuple(w1.shape) != (d, 3 * d) or tuple(w2.shape) != (d, d):
        raise ValueError(
            f"fused_edge_phase: the CUDA kernels take a (3*{d} -> {d} -> {d}) "
            "edge MLP"
        )
    if x_send.dim() != 3:
        raise ValueError("fused_edge_phase: x_send must be (E, B, D)")
    n_edges, batch = x_send.shape[0], x_send.shape[1]
    if not 1 <= batch <= KERNEL_MAX_BATCH:
        raise ValueError(
            f"fused_edge_phase: batch {batch} outside 1..{KERNEL_MAX_BATCH}"
        )
    if n_edges != edge_set.num_edges:
        raise ValueError("fused_edge_phase: x_send rows != edges of the edge set")
    _check("x_send", x_send, dev, (n_edges, batch, d))
    _check("rec_rep", rec_rep, dev, (edge_set.num_rec, batch, d))
    feat = 0
    if raw:
        ew1, ew2 = weights[6], weights[8]
        feat = ew1.shape[1]
        if (
            tuple(ew1.shape) != (d, feat)
            or feat > MAX_RAW_FEATURES
            or tuple(ew2.shape) != (d, d)
        ):
            raise ValueError(
                "fused_edge_phase: the CUDA kernels take a Linear-SiLU-"
                f"Linear-LayerNorm embedder of width {d} on at most "
                f"{MAX_RAW_FEATURES} raw features"
            )
        _check("edge_feats", edge_in, dev, (n_edges, feat))
        mode = _EDGE_RAW
    elif edge_in.dim() == 2:
        _check("edge_rep", edge_in, dev, (n_edges, d))
        mode = _EDGE_SHARED
    else:
        _check("edge_rep", edge_in, dev, (n_edges, batch, d))
        mode = _EDGE_BATCHED
    for w in weights:
        if w is not None and (
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
    return mode, feat


def fused_edge_fwd(edge_in, x_send, rec_rep, edge_set, weights, raw,
                   update_edges, propagation, save_pre=False):
    """Launch K3 on CUDA tensors: ``(aggr, new_edge | None, pre | None)``.
    The launcher records no autograd graph; :class:`FusedEdgePhase` does."""
    refuse_autograd(
        "fused_edge_fwd", "ops.fused_kernels.fused_edge_phase",
        edge_in, x_send, rec_rep, *weights,
    )
    mode, feat = _check_inputs(edge_in, x_send, rec_rep, edge_set, weights, raw)
    dev = x_send.device
    shape = tuple(x_send.shape)
    aggr = torch.empty(tuple(rec_rep.shape), dtype=torch.float32, device=dev)
    new_edge = (
        torch.empty(shape, dtype=torch.float32, device=dev) if update_edges else None
    )
    pre = torch.empty(shape, dtype=torch.float32, device=dev) if save_pre else None
    if edge_set.num_rec == 0:
        return aggr, new_edge, pre
    err = _fwd_lib()(
        mode, edge_set.num_rec, shape[1], feat, int(update_edges),
        int(propagation), int(weights[4] is not None),
        _ptr(edge_in), _ptr(x_send), _ptr(rec_rep), _ptr(edge_set.rowptr),
        *(_ptr(w) for w in weights),
        _ptr(aggr), _ptr(new_edge), _ptr(pre),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_edge_phase kernel launch failed: CUDA error {err}")
    fused_edge_phase.launches += 1
    return aggr, new_edge, pre


def fused_edge_bwd(d_aggr, d_new_edge, pre, edge_in, x_send, rec_rep, edge_set,
                   weights, raw, propagation):
    """Launch K4 on CUDA tensors. ``d_new_edge`` may be None (no gradient
    reaches the updated edges). Returns ``(d_edge | None, d_send, d_rec,
    weight grads)``: ``d_edge`` in the edge input's shape, None for raw
    features; the weight grads in the order of :func:`_weights`, None
    where the weight is."""
    mode, feat = _check_inputs(edge_in, x_send, rec_rep, edge_set, weights, raw)
    dev, d = x_send.device, KERNEL_HIDDEN
    n_edges, batch = x_send.shape[0], x_send.shape[1]
    num_rec = edge_set.num_rec
    _check("d_aggr", d_aggr, dev, (num_rec, batch, d))
    _check("pre", pre, dev, (n_edges, batch, d))
    if d_new_edge is not None:
        _check("d_new_edge", d_new_edge, dev, (n_edges, batch, d))
    w1, _, _, _, gamma = weights[:5]

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    batched = mode == _EDGE_BATCHED
    d_send = empty(n_edges, batch, d)
    d_recproj = empty(num_rec, batch, d)
    d_edge = None
    if batched:
        d_edge = empty(n_edges, batch, d)
    elif mode == _EDGE_SHARED:
        d_edge = empty(n_edges, d)
    if num_rec == 0 or n_edges == 0:
        # no edge reaches a weight or a node: every gradient is zero
        zeros = [None if w is None else torch.zeros_like(w) for w in weights]
        return (
            None if d_edge is None else d_edge.zero_(),
            d_send, torch.zeros_like(rec_rep), zeros,
        )
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    out_main = empty(_WS_MAIN)
    ws_main = empty(blocks, _WS_MAIN)
    presum = out_edge = ws_edge = None
    if not batched:
        presum, out_edge, ws_edge = (
            empty(n_edges, d), empty(_WS_EDGE), empty(blocks, _WS_EDGE)
        )
    err = _bwd_lib()(
        mode, num_rec, n_edges, batch, feat, int(propagation),
        int(gamma is not None), blocks,
        _ptr(edge_in), _ptr(x_send), _ptr(pre), _ptr(d_aggr), _ptr(d_new_edge),
        _ptr(edge_set.rowptr), _ptr(w1), _ptr(weights[2]), _ptr(weights[3]),
        _ptr(gamma), *(_ptr(w) for w in weights[6:]),
        _ptr(d_send), _ptr(d_edge), _ptr(d_recproj), _ptr(presum),
        _ptr(ws_main), _ptr(out_main), _ptr(ws_edge), _ptr(out_edge),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"fused_edge_phase backward kernel launch failed: CUDA error {err}"
        )
    fused_edge_bwd.launches += 1

    mats = out_main[: 3 * _MAT].view(3, d, d)  # dW2, dW1s, dW1e as (out, in)
    db2, dgamma, dbeta, db1 = out_main[3 * _MAT :].view(4, d)
    emb_grads = [None] * 6
    dw1e = mats[2]
    if not batched:
        dw1e = out_edge[:_MAT].view(d, d)
        if raw:
            dew1 = out_edge[2 * _MAT : 2 * _MAT + MAX_RAW_FEATURES * d]
            deb1, deb2, deg, debt = out_edge[2 * _MAT + MAX_RAW_FEATURES * d :].view(4, d)
            emb_grads = [
                dew1.view(d, MAX_RAW_FEATURES)[:, :feat].contiguous(), deb1,
                out_edge[_MAT : 2 * _MAT].view(d, d), deb2, deg, debt,
            ]
    # the receiver slice: node-sized products, as the JAX package forms them
    w1r = w1[:, 2 * d :]
    d_rec = d_recproj @ w1r
    dw1r = torch.einsum("nbc,nbk->ck", d_recproj, rec_rep)
    grads = [torch.cat([dw1e, mats[1], dw1r], dim=1), db1, mats[0], db2]
    grads += [dgamma, dbeta] if gamma is not None else [None, None]
    return d_edge, d_send, d_rec, grads + emb_grads


fused_edge_bwd.launches = 0


class FusedEdgePhase(torch.autograd.Function):
    """The fused edge phase with K3 as its forward and K4 as its
    backward. On CPU tensors the forward is the plain version and the
    backward is autograd through the plain version.

    ``apply(edge_in, x_send, rec_rep, *weights, edge_set, raw,
    update_edges, propagation)`` with the twelve tensors of
    :func:`_weights`; returns ``(aggr, new_edge | None)``.
    """

    @staticmethod
    def forward(ctx, edge_in, x_send, rec_rep, *args):
        weights, (edge_set, raw, update_edges, propagation) = args[:12], args[12:]
        ctx.meta = (edge_set, raw, update_edges, propagation)
        ctx.set_materialize_grads(False)
        need_grad = any(ctx.needs_input_grad)
        if x_send.device.type == "cpu":
            aggr, new_edge = _plain(
                edge_in, x_send, rec_rep, edge_set.receivers, weights, raw,
                update_edges, propagation,
            )
            pre = None
        else:
            aggr, new_edge, pre = fused_edge_fwd(
                edge_in, x_send, rec_rep, edge_set, weights, raw, update_edges,
                propagation, save_pre=need_grad,
            )
        if need_grad:
            ctx.save_for_backward(edge_in, x_send, rec_rep, *weights, pre)
        return aggr, new_edge

    @staticmethod
    def backward(ctx, d_aggr, d_new_edge):
        edge_set, raw, update_edges, propagation = ctx.meta
        # absent weights were saved as None and come back as None
        edge_in, x_send, rec_rep, *weights, pre = ctx.saved_tensors
        if d_aggr is None and d_new_edge is None:
            return (None,) * 19
        if d_aggr is None:
            d_aggr = torch.zeros_like(rec_rep)
        if x_send.device.type == "cpu":
            d_edge, d_send, d_rec, grads = _plain_bwd(
                d_aggr, d_new_edge, edge_in, x_send, rec_rep, edge_set, weights,
                raw, update_edges, propagation,
            )
        else:
            d_edge, d_send, d_rec, grads = fused_edge_bwd(
                d_aggr.contiguous(),
                None if d_new_edge is None else d_new_edge.contiguous(),
                pre, edge_in, x_send, rec_rep, edge_set, weights, raw,
                propagation,
            )
        return (d_edge, d_send, d_rec, *grads, None, None, None, None)


def _plain_bwd(d_aggr, d_new_edge, edge_in, x_send, rec_rep, edge_set, weights,
               raw, update_edges, propagation):
    """K4's plain version: autograd through :func:`_plain` on the same
    inputs. Same returns as :func:`fused_edge_bwd`."""
    with torch.enable_grad():
        leaves = [
            None if t is None else t.detach().requires_grad_(True)
            for t in (edge_in, x_send, rec_rep, *weights)
        ]
        if raw:
            leaves[0] = edge_in.detach()  # the raw features are constants
        aggr, new_edge = _plain(
            leaves[0], leaves[1], leaves[2], edge_set.receivers, leaves[3:],
            raw, update_edges, propagation,
        )
        outs, seeds = [aggr], [d_aggr]
        if d_new_edge is not None:
            outs.append(new_edge)
            seeds.append(d_new_edge)
        wanted = [i for i, t in enumerate(leaves) if t is not None and t.requires_grad]
        got = torch.autograd.grad(
            outs, [leaves[i] for i in wanted], seeds, allow_unused=True
        )
    grads = [None] * len(leaves)
    for i, g in zip(wanted, got):
        grads[i] = torch.zeros_like(leaves[i]) if g is None else g
    return grads[0], grads[1], grads[2], grads[3:]


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
    """K3, differentiable through K4: the fused edge phase over
    ``edge_set`` (receiver-sorted CSR).

    ``x_send`` is ``(E, B, D)`` (sender rows from K1), ``rec_rep`` is
    ``(N_rec, B, D)``; the edge input is either ``edge_rep`` of shape
    ``(E, B, D)`` or ``(E, D)`` (shared across the batch), or, with
    ``embedder``, the raw ``edge_feats`` of shape ``(E, F)``. Returns
    ``(aggregated_sum (N_rec, B, D), new_edge (E, B, D) | None)``.
    """
    if x_send.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"fused_edge_phase: unsupported device {x_send.device}")
    if not fusable(edge_mlp) or (
        embedder is not None
        and not embedder_fusable(embedder, linear_layers(edge_mlp)[1].out_features)
    ):
        raise ValueError(
            "fused_edge_phase takes a two-layer (3h -> h -> h) edge MLP and a "
            "Linear-SiLU-Linear-LayerNorm embedder"
        )
    raw = embedder is not None
    return FusedEdgePhase.apply(
        edge_feats if raw else edge_rep, x_send, rec_rep,
        *_weights(edge_mlp, embedder),
        edge_set, raw, update_edges, propagation,
    )


fused_edge_phase.launches = 0
