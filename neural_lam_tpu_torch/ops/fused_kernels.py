"""K3 and K4, the fused edge phase and its backward, and K7 and K8, its
v2 form with the sender gather merged in: counterparts of
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
- Bound on the H100: operations, or the bytes of the larger sets. All
  four run their products on the tensor cores at float32 accuracy
  (``wgmma`` and ``mma.sync`` TF32 with the 3xTF32 split,
  ``csrc/tc_tf32.cuh``); a warp owns 16 rows by 64 features, so a row's
  layers, SiLU and LayerNorm chain in registers. K3 and K7 keep the
  weights in shared memory once per block of three groups of warps,
  compute (K3) or read (K7) the receiver projection once per receiver
  and the embedder once per edge, and sum each receiver's messages in
  one group without atomics. When the call will be differentiated they
  also write the first layer's pre-activation, and K4 and K8 start from
  it: groups that own whole receivers keep their share of every weight
  gradient in registers, write it once to a workspace sized by the grid,
  and a last small kernel sums the workspace in group order, so the
  gradients are deterministic.
- The gradient of the receiver rows and of the receiver slice of the
  first layer are node-sized products of K4's ``d_recproj`` output,
  formed here with ``torch`` as the JAX package forms them outside its
  kernel (pallas_fused.py:1624-1631).
- K7 (``csrc/fused_edge_v2.cu``) replaces ``_fused_v2_fwd_impl``
  (pallas_fused.py:2143, its pallas_call at :2281 over
  ``_fused_v2_fwd_kernel`` :1800) and K8 (``csrc/fused_edge_v2_bwd.cu``)
  ``_fused_v2_bwd_impl`` (:2293, its pallas_call at :2448 over
  ``_fused_v2_bwd_kernel`` :1934), tied into one ``custom_vjp`` by
  ``make_fused_interaction_v2`` (:2456); :class:`FusedEdgePhaseV2` is
  its counterpart. The first layer's sender and receiver products are
  formed once per node outside the kernel (``sp = send . W1s``, ``rp =
  rec . W1r``); K7 loads ``sp`` by sender index, so no per-edge sender
  array exists and K1 does not run. K8 emits the per-edge ``d_pre``
  instead of ``d_send``; K2 scatters it into ``d_sp``, and autograd of
  the two projections gives ``dW1s``, ``dW1r`` and the node gradients
  (the Function's ``W1`` gradient carries zeros in those blocks, as the
  JAX one does at :2673). :func:`fused_v2_routed` picks the route per
  edge set, from the same environment variables as the JAX package.
- Supported on CUDA: hidden width 64, batch 1 to 32, raw edge features
  up to 8 wide, ``propagation`` (K3, K4) and ``layer_norm=False`` in the
  kernels themselves. Other shapes raise on CUDA here; the routing in
  ``ops/interaction.py`` sends them to the unfused route before any
  launch (:func:`kernels_take`). On a CPU tensor the
  forward runs :func:`fused_edge_phase_plain` (or
  :func:`fused_edge_phase_v2_plain`) and the backward differentiates it
  with autograd.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import kernel_build
from .mlp import LN_EPS, linear_layers, output_layer_norm
from .segment_kernels import refuse_autograd, sender_scatter

KERNEL = "fused_edge"
BWD_KERNEL = "fused_edge_bwd"
V2_KERNEL = "fused_edge_v2"
V2_BWD_KERNEL = "fused_edge_v2_bwd"
KERNEL_HIDDEN = 64
KERNEL_MAX_BATCH = 32
MAX_RAW_FEATURES = 8
_EDGE_RAW, _EDGE_SHARED, _EDGE_BATCHED = 0, 1, 2
# floats per group (the main kernels) or block (the edge pass) of the
# backward kernels' workspaces (csrc/fused_edge_bwd.cu and
# fused_edge_v2_bwd.cu: kMainStride, kGroups; fused_edge_bwd_common.cuh:
# kEdgeStride, kRowGroups)
_MAT = KERNEL_HIDDEN * KERNEL_HIDDEN
_WS_MAIN = 2 * _MAT + 4 * KERNEL_HIDDEN
_WS_EDGE = 2 * _MAT + MAX_RAW_FEATURES * KERNEL_HIDDEN + 4 * KERNEL_HIDDEN
_WS_MAIN_V2 = _MAT + 4 * KERNEL_HIDDEN
_GROUPS = 3  # groups of warps per block of K4's and K8's main kernels
_ROW_GROUPS = 4  # and of their batched edge pass
# rows of a tile, and (receiver, b) rows of a receiver chunk of K4's and
# K8's main kernels (kRecRows, kChunkRows)
_TILE_ROWS, _CHUNK_ROWS_K4, _CHUNK_ROWS_K8 = 64, 32, 16


def kernels_take(hidden: int, batch: int, device) -> bool:
    """Do the CUDA kernels of the fused edge phase (K3/K4 and K7/K8) take
    a call of this hidden width and batch on ``device``? They are built
    for hidden ``KERNEL_HIDDEN`` and batch 1 to ``KERNEL_MAX_BATCH``; on
    any other device the plain versions run, and they take every shape.
    The routing predicates ask this before any launch, as the JAX
    package's ``fused_edge_phase_supported`` asks ``stripe_fits``
    (neural_lam_tpu/ops/interaction.py:426), so a shape the kernels
    refuse takes the unfused route instead of raising."""
    if torch.device(device).type != "cuda":
        return True
    return hidden == KERNEL_HIDDEN and 1 <= batch <= KERNEL_MAX_BATCH


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


def _embed(edge_in, weights, raw):
    """The edge input as the first layer sees it: the embedder on the raw
    features, or the edge array itself."""
    if not raw:
        return edge_in
    ew1, eb1, ew2, eb2, eg, ebt = weights[6:]
    d = ew2.shape[0]
    return F.layer_norm(
        F.linear(F.silu(F.linear(edge_in, ew1, eb1)), ew2, eb2),
        (d,), eg, ebt, LN_EPS,
    )


def _edge_proj(edge_rep, w1):
    """``edge_rep . W1e``, once per edge for a shared ``(E, D)`` input."""
    proj = edge_rep @ w1[:, : w1.shape[0]].T
    return proj.unsqueeze(1) if edge_rep.dim() == 2 else proj


def _messages(pre, edge_rep, rec_like, receivers, weights, update_edges,
              residual=None):
    """Second layer, LayerNorm, the optional residuals and the receiver
    sums: ``(aggr, new_edge | None)``."""
    w2, b2, gamma, beta = weights[2:6]
    msg = F.linear(F.silu(pre), w2, b2)
    if gamma is not None:
        msg = F.layer_norm(msg, (w2.shape[0],), gamma, beta, LN_EPS)
    if residual is not None:
        msg = msg + residual
    new_edge = None
    if update_edges:
        base = edge_rep.unsqueeze(1) if edge_rep.dim() == 2 else edge_rep
        new_edge = base + msg
    aggr = torch.zeros_like(rec_like).index_add_(0, receivers, msg)
    return aggr, new_edge


def _plain(edge_in, x_send, rec_rep, receivers, weights, raw, update_edges,
           propagation):
    """The phase in plain PyTorch on the weight tensors of :func:`_weights`."""
    w1, b1 = weights[:2]
    d = w1.shape[0]
    edge_rep = _embed(edge_in, weights, raw)
    rec_proj = rec_rep @ w1[:, 2 * d :].T  # once per receiver
    pre = (
        _edge_proj(edge_rep, w1)
        + x_send @ w1[:, d : 2 * d].T
        + rec_proj.index_select(0, receivers)
        + b1
    )
    return _messages(
        pre, edge_rep, rec_rep, receivers, weights, update_edges,
        residual=x_send if propagation else None,
    )


def _plain_v2(edge_in, sp, rp, senders, receivers, weights, raw, update_edges):
    """The v2 phase (K7) in plain PyTorch on the node projections ``sp``
    and ``rp``: ``(aggr, new_edge | None, pre)``."""
    edge_rep = _embed(edge_in, weights, raw)
    pre = (
        _edge_proj(edge_rep, weights[0])
        + sp.index_select(0, senders)
        + rp.index_select(0, receivers)
        + weights[1]
    )
    aggr, new_edge = _messages(pre, edge_rep, rp, receivers, weights, update_edges)
    return aggr, new_edge, pre


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


def fused_edge_phase_v2_plain(
    edge_mlp: nn.Sequential,
    edge_rep: Optional[torch.Tensor],
    sp: torch.Tensor,
    rp: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    embedder: Optional[nn.Sequential] = None,
    edge_feats: Optional[torch.Tensor] = None,
    update_edges: bool = False,
):
    """Plain PyTorch version of K7: the v2 phase on the sender and
    receiver projections ``sp`` ``(N_send, B, D)`` and ``rp`` ``(N_rec,
    B, D)`` (``index_select`` by ``senders`` and ``receivers``,
    ``index_add_`` into the receivers). Returns ``(aggr, new_edge |
    None)``; autograd through it is the plain version of K8."""
    raw = embedder is not None
    aggr, new_edge, _ = _plain_v2(
        edge_feats if raw else edge_rep, sp, rp, senders, receivers,
        _weights(edge_mlp, embedder), raw, update_edges,
    )
    return aggr, new_edge


# The environment variables that choose the route, read only through
# these names, so that ``route_env`` covers all of them
FUSED_V2_ENV = "NEURAL_LAM_TPU_FUSED_V2"
FUSED_V2_RATIO_ENV = "NEURAL_LAM_TPU_FUSED_V2_RATIO"
CACHE_PRE_ENV = "NEURAL_LAM_TPU_CACHE_PRE"
_ROUTE_ENV = (FUSED_V2_ENV, FUSED_V2_RATIO_ENV, CACHE_PRE_ENV)


def route_env() -> tuple[Optional[str], ...]:
    """The environment variables that :func:`fused_v2_routed` reads, as
    they stand now. A captured CUDA graph fixes the route it was captured
    on, so a cache of graphs keys on these."""
    return tuple(os.environ.get(name) for name in _ROUTE_ENV)


def fused_v2_enabled() -> bool:
    """The coarse gate of the v2 route, read at call time:
    ``NEURAL_LAM_TPU_FUSED_V2=off`` turns it off everywhere, and so does
    ``NEURAL_LAM_TPU_CACHE_PRE=off`` (K8 starts from the saved ``pre``).
    The JAX package's ``fused_v2_enabled`` (pallas_fused.py:1755)."""
    if os.environ.get(FUSED_V2_ENV, "auto") == "off":
        return False
    return os.environ.get(CACHE_PRE_ENV, "on") != "off"


def fused_v2_routed(num_edge_slots: int, num_hoisted_rows: int) -> bool:
    """Does an interaction-wired fused phase take the v2 route (K7, K8)?
    The JAX package's ``fused_v2_routed`` (pallas_fused.py:1768), from
    the same environment variables, read at every call:
    ``NEURAL_LAM_TPU_FUSED_V2`` ``on`` takes v2 on every such phase,
    ``off`` on none, and ``auto`` (the default) when the edge slots reach
    ``NEURAL_LAM_TPU_FUSED_V2_RATIO`` (default 8) times the hoisted rows,
    the sender rows plus the receiver rows. No MEPS edge set reaches 8,
    so the default route at MEPS is v1 (K1 + K3).

    The port counts without the JAX padding: its callers pass the edge
    set's ``num_edges`` and ``send_rows + num_rec``, where the JAX package
    counts the blocked layout's padded slots and block-padded receiver
    rows. An edge set within a few percent of the ratio may therefore
    route differently in the two packages; away from it they agree.

    The ratio of 8 is the JAX package's, measured on a TPU. On an H100
    (NVIDIA H100 80GB HBM3, 700.00 W; ``chip_smoke.py``'s ``route``
    lines, with the tensor-core K7 and K8, batch 4) the routes
    cross far below it. v2 against v1 device time is 0.82 forward and
    0.79 forward and backward at m2g (3.6 edges per hoisted row), 0.87-1.00
    and 0.84-0.92 at m2m (4.4), and 0.87 forward but 1.07 forward and
    backward at g2m (1.4), where the projections' backward over 63,784
    grid sender rows costs 0.50 ms: the crossover lies below 1.4 for
    serving and between 1.4 and 3.6 for training. Per AR step v2 takes
    0.88 of v1's edge-phase device time, per training step 0.87. The
    default stays 8, so both packages route alike; a ratio for this card
    is for a benchmark cell to decide."""
    if not fused_v2_enabled():
        return False
    if os.environ.get(FUSED_V2_ENV, "auto") == "on":
        return True
    ratio = float(os.environ.get(FUSED_V2_RATIO_ENV, "8"))
    return num_edge_slots >= ratio * max(num_hoisted_rows, 1)


@functools.cache
def _fwd_lib():
    fn = kernel_build.load(KERNEL).nl_fused_edge_fwd
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 21
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_lib():
    fn = kernel_build.load(BWD_KERNEL).nl_fused_edge_bwd
    fn.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p] * 25
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _v2_fwd_lib():
    fn = kernel_build.load(V2_KERNEL).nl_fused_edge_v2_fwd
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 22
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _v2_bwd_lib():
    fn = kernel_build.load(V2_BWD_KERNEL).nl_fused_edge_v2_bwd
    fn.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p] * 24
    fn.restype = ctypes.c_int
    return fn


# kernel -> (source, its occupancy entry point)
_OCCUPANCY = {
    "K3": (KERNEL, "nl_fused_edge_fwd_occupancy"),
    "K4": (BWD_KERNEL, "nl_fused_edge_bwd_occupancy"),
    "K7": (V2_KERNEL, "nl_fused_edge_v2_fwd_occupancy"),
    "K8": (V2_BWD_KERNEL, "nl_fused_edge_v2_bwd_occupancy"),
}


def kernel_occupancy(kernel: str) -> dict[str, dict[str, int]]:
    """The launch resources of ``kernel`` (K3, K7, or K4's or K8's main
    kernel) in each edge mode, from the CUDA runtime on the current
    device: blocks and warps per SM, threads per block, registers per
    thread and dynamic shared memory per block in bytes."""
    source, entry = _OCCUPANCY[kernel]
    fn = getattr(kernel_build.load(source), entry)
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    out = {}
    for name, mode in (("raw", _EDGE_RAW), ("shared", _EDGE_SHARED),
                       ("batched", _EDGE_BATCHED)):
        vals = [ctypes.c_int() for _ in range(4)]
        err = fn(mode, *(ctypes.addressof(v) for v in vals))
        if err != 0:
            raise RuntimeError(f"occupancy query failed: CUDA error {err}")
        blocks, threads, regs, smem = (v.value for v in vals)
        out[name] = dict(blocks=blocks, warps=blocks * threads // 32,
                         threads=threads, regs=regs, smem=smem)
    return out


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _bwd_grid(dev, num_rec, n_edges, batch, batched, chunk_rows) -> tuple[int, int, int]:
    """The grids of K4's and K8's launches, sized to the work, and the
    floats of their edge pass's workspace: the main kernel runs 3 groups
    of warps a block, each over chunks of ``chunk_rows / B`` receivers (at
    least one); the edge pass 4 groups a block over tiles of 64 (edge, b)
    rows of d_pre (batched), or one block per tile of 64 rows of s (per
    edge)."""
    sms = _sm_count(dev.index if dev.index is not None else torch.cuda.current_device())
    chunks = -(-num_rec // max(1, chunk_rows // batch))
    main_blocks = min(sms, -(-chunks // _GROUPS))
    if batched:
        tiles = -(-n_edges * batch // _TILE_ROWS)
        edge_blocks = min(sms, -(-tiles // _ROW_GROUPS))
        return main_blocks, edge_blocks, edge_blocks * _ROW_GROUPS * _MAT
    edge_blocks = min(sms, -(-n_edges // _TILE_ROWS))
    return main_blocks, edge_blocks, edge_blocks * _WS_EDGE


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _check(name: str, t: torch.Tensor, device: torch.device, shape,
           who: str = "fused_edge_phase") -> None:
    if t.device != device:
        raise ValueError(f"{who}: {name} on {t.device}, not {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{who}: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{who}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}"
        )
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{who}: {name} must be contiguous and aligned")


def _check_edge_and_weights(who, edge_in, edge_set, batch, dev, weights, raw):
    """Refuse an edge input, weights or an edge set that the CUDA kernels
    do not take; returns the edge mode and the raw feature width."""
    d, n_edges = KERNEL_HIDDEN, edge_set.num_edges
    w1, _, w2 = weights[:3]
    if tuple(w1.shape) != (d, 3 * d) or tuple(w2.shape) != (d, d):
        raise ValueError(
            f"{who}: the CUDA kernels take a (3*{d} -> {d} -> {d}) edge MLP"
        )
    if not 1 <= batch <= KERNEL_MAX_BATCH:
        raise ValueError(f"{who}: batch {batch} outside 1..{KERNEL_MAX_BATCH}")
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
                f"{who}: the CUDA kernels take a Linear-SiLU-Linear-LayerNorm "
                f"embedder of width {d} on at most {MAX_RAW_FEATURES} raw "
                "features"
            )
        _check("edge_feats", edge_in, dev, (n_edges, feat), who)
        mode = _EDGE_RAW
    elif edge_in.dim() == 2:
        _check("edge_rep", edge_in, dev, (n_edges, d), who)
        mode = _EDGE_SHARED
    else:
        _check("edge_rep", edge_in, dev, (n_edges, batch, d), who)
        mode = _EDGE_BATCHED
    for w in weights:
        if w is not None and (
            w.device != dev
            or w.dtype != torch.float32
            or not w.is_contiguous()
            or w.data_ptr() % 16
        ):
            raise ValueError(
                f"{who}: weights must be contiguous, 16-byte aligned float32 "
                f"on {dev}"
            )
    for index in (edge_set.rowptr, edge_set.senders):
        if index.device != dev or index.dtype != torch.int32:
            raise ValueError(f"{who}: edge set not on the kernel's device")
    return mode, feat


def _check_inputs(edge_in, x_send, rec_rep, edge_set, weights, raw) -> tuple[int, int]:
    """Refuse what K3 and K4 do not take; returns the edge mode and the
    raw feature width."""
    dev, d = x_send.device, KERNEL_HIDDEN
    if x_send.dim() != 3:
        raise ValueError("fused_edge_phase: x_send must be (E, B, D)")
    n_edges, batch = x_send.shape[0], x_send.shape[1]
    if n_edges != edge_set.num_edges:
        raise ValueError("fused_edge_phase: x_send rows != edges of the edge set")
    mode, feat = _check_edge_and_weights(
        "fused_edge_phase", edge_in, edge_set, batch, dev, weights, raw
    )
    _check("x_send", x_send, dev, (n_edges, batch, d))
    _check("rec_rep", rec_rep, dev, (edge_set.num_rec, batch, d))
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
    # the kernel's work counter; inside a CUDA graph capture its zero-fill
    # is a node of the graph, so every replay starts it at 0 again
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    err = _fwd_lib()(
        mode, edge_set.num_rec, shape[1], feat, int(update_edges),
        int(propagation), int(weights[4] is not None),
        _ptr(edge_in), _ptr(x_send), _ptr(rec_rep), _ptr(edge_set.rowptr),
        *(_ptr(w) for w in weights),
        _ptr(aggr), _ptr(new_edge), _ptr(pre), _ptr(counter),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_edge_phase kernel launch failed: CUDA error {err}")
    fused_edge_phase.launches += 1
    return aggr, new_edge, pre


def _edge_grads(out_edge, raw, feat):
    """``dW1e`` and the embedder's six weight gradients (None without an
    embedder) from the summed workspace of the backward kernels' edge
    pass (csrc/fused_edge_bwd_common.cuh)."""
    d = KERNEL_HIDDEN
    dw1e = out_edge[:_MAT].view(d, d)
    if not raw:
        return dw1e, [None] * 6
    dew1 = out_edge[2 * _MAT : 2 * _MAT + MAX_RAW_FEATURES * d]
    deb1, deb2, deg, debt = out_edge[2 * _MAT + MAX_RAW_FEATURES * d :].view(4, d)
    return dw1e, [
        dew1.view(d, MAX_RAW_FEATURES)[:, :feat].contiguous(), deb1,
        out_edge[_MAT : 2 * _MAT].view(d, d), deb2, deg, debt,
    ]


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
    main_blocks, edge_blocks, ws_edge_size = _bwd_grid(
        dev, num_rec, n_edges, batch, batched, _CHUNK_ROWS_K4
    )
    # the summed weight gradients (the returned gradients are views of
    # them), and one allocation for the kernels' scratch, freed on return
    # (inside a CUDA graph capture both come from the graph's pool):
    # ws_main | ws_edge | d_pre or s (multiples of 4 floats: each pointer
    # stays 16-byte aligned)
    out_main, out_edge = empty(_WS_MAIN), empty(_WS_EDGE)
    sizes = (main_blocks * _GROUPS * _WS_MAIN, ws_edge_size,
             n_edges * (batch if batched else 1) * d)
    scratch = empty(sum(sizes))
    ws_main, ws_edge, d_pre = (
        scratch.data_ptr() + 4 * sum(sizes[:i]) for i in range(3)
    )
    err = _bwd_lib()(
        mode, num_rec, n_edges, batch, feat, int(propagation),
        int(gamma is not None), main_blocks, edge_blocks,
        _ptr(edge_in), _ptr(x_send), _ptr(pre), _ptr(d_aggr), _ptr(d_new_edge),
        _ptr(edge_set.rowptr), _ptr(w1), _ptr(weights[2]), _ptr(weights[3]),
        _ptr(gamma), *(_ptr(w) for w in weights[6:]),
        _ptr(d_send), _ptr(d_edge), _ptr(d_recproj), d_pre,
        ws_main, _ptr(out_main), ws_edge, _ptr(out_edge),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"fused_edge_phase backward kernel launch failed: CUDA error {err}"
        )
    fused_edge_bwd.launches += 1

    mats = out_main[: 2 * _MAT].view(2, d, d)  # dW2, dW1s as (out, in)
    db2, dgamma, dbeta, db1 = out_main[2 * _MAT :].view(4, d)
    dw1e, emb_grads = _edge_grads(out_edge, raw, feat)
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
    update_edges, propagation, grad_enabled)`` with the twelve tensors of
    :func:`_weights`, ``grad_enabled`` the caller's grad mode; returns
    ``(aggr, new_edge | None)``.
    """

    @staticmethod
    def forward(ctx, edge_in, x_send, rec_rep, *args):
        weights = args[:12]
        edge_set, raw, update_edges, propagation, grad_enabled = args[12:]
        ctx.meta = (edge_set, raw, update_edges, propagation)
        ctx.set_materialize_grads(False)
        need_grad = grad_enabled and any(ctx.needs_input_grad)
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
            return (None,) * 20
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
        return (d_edge, d_send, d_rec, *grads, None, None, None, None, None)


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
    # grad mode decides whether K3 writes pre for the backward: inside the
    # Function, needs_input_grad follows the parameters' requires_grad even
    # under no_grad and inference_mode, where no backward will run
    return FusedEdgePhase.apply(
        edge_feats if raw else edge_rep, x_send, rec_rep,
        *_weights(edge_mlp, embedder),
        edge_set, raw, update_edges, propagation, torch.is_grad_enabled(),
    )


fused_edge_phase.launches = 0


# -- the v2 route: K7 forward, K8 backward ----------------------------------

_V2 = "fused_edge_phase_v2"


def _check_v2_inputs(edge_in, sp, rp, edge_set, weights, raw) -> tuple[int, int]:
    """Refuse what K7 and K8 do not take; returns the edge mode and the
    raw feature width."""
    dev, d = rp.device, KERNEL_HIDDEN
    if sp.dim() != 3 or rp.dim() != 3:
        raise ValueError(f"{_V2}: sp and rp must be (N, B, D)")
    batch = rp.shape[1]
    mode, feat = _check_edge_and_weights(_V2, edge_in, edge_set, batch, dev, weights, raw)
    n_tab = edge_set.send_rowptr.shape[0] - 1
    if sp.shape[0] < n_tab:
        raise ValueError(
            f"{_V2}: sp has {sp.shape[0]} rows for an edge set with senders "
            f"up to {n_tab - 1}"
        )
    _check("sp", sp, dev, (sp.shape[0], batch, d), _V2)
    _check("rp", rp, dev, (edge_set.num_rec, batch, d), _V2)
    return mode, feat


def fused_edge_v2_fwd(edge_in, sp, rp, edge_set, weights, raw, update_edges,
                      save_pre=False):
    """Launch K7 on CUDA tensors: ``(aggr, new_edge | None, pre | None)``.
    The launcher records no autograd graph; :class:`FusedEdgePhaseV2`
    does."""
    refuse_autograd(
        "fused_edge_v2_fwd", "ops.fused_kernels.fused_edge_phase_v2",
        edge_in, sp, rp, *weights,
    )
    mode, feat = _check_v2_inputs(edge_in, sp, rp, edge_set, weights, raw)
    dev, batch = rp.device, rp.shape[1]
    shape = (edge_set.num_edges, batch, KERNEL_HIDDEN)
    aggr = torch.empty(tuple(rp.shape), dtype=torch.float32, device=dev)
    new_edge = (
        torch.empty(shape, dtype=torch.float32, device=dev) if update_edges else None
    )
    pre = torch.empty(shape, dtype=torch.float32, device=dev) if save_pre else None
    if edge_set.num_rec == 0:
        return aggr, new_edge, pre
    # the kernel's work counter; inside a CUDA graph capture its zero-fill
    # is a node of the graph, so every replay starts it at 0 again
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    err = _v2_fwd_lib()(
        mode, edge_set.num_rec, batch, feat, int(update_edges),
        int(weights[4] is not None),
        _ptr(edge_in), _ptr(sp), _ptr(rp), _ptr(edge_set.rowptr),
        _ptr(edge_set.senders), *(_ptr(w) for w in weights),
        _ptr(aggr), _ptr(new_edge), _ptr(pre), _ptr(counter),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{_V2} kernel launch failed: CUDA error {err}")
    fused_edge_phase_v2.launches += 1
    return aggr, new_edge, pre


def fused_edge_v2_bwd(d_aggr, d_new_edge, pre, edge_in, edge_set, weights, raw):
    """Launch K8 on CUDA tensors. ``d_new_edge`` may be None (no gradient
    reaches the updated edges). Returns ``(d_edge | None, d_pre,
    d_recproj, weight grads)``: ``d_edge`` in the edge input's shape, None
    for raw features; ``d_pre`` per (edge, b) row and ``d_recproj`` its
    sum per (receiver, b); the weight grads in the order of
    :func:`_weights`, None where the weight is, with zeros in the sender
    and receiver blocks of ``W1``: those come from autograd of the node
    projections."""
    dev, d = pre.device, KERNEL_HIDDEN
    n_edges, num_rec, batch = edge_set.num_edges, edge_set.num_rec, pre.shape[1]
    mode, feat = _check_edge_and_weights(_V2, edge_in, edge_set, batch, dev, weights, raw)
    _check("pre", pre, dev, (n_edges, batch, d), _V2)
    _check("d_aggr", d_aggr, dev, (num_rec, batch, d), _V2)
    if d_new_edge is not None:
        _check("d_new_edge", d_new_edge, dev, (n_edges, batch, d), _V2)
    gamma = weights[4]

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    batched = mode == _EDGE_BATCHED
    d_pre = empty(n_edges, batch, d)
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
            d_pre, d_recproj.zero_(), zeros,
        )
    main_blocks, edge_blocks, ws_edge_size = _bwd_grid(
        dev, num_rec, n_edges, batch, batched, _CHUNK_ROWS_K8
    )
    # the summed weight gradients (the returned gradients are views of
    # them), and one allocation for the kernels' scratch, freed on return
    # (inside a CUDA graph capture both come from the graph's pool):
    # ws_main | ws_edge | s (multiples of 4 floats: each pointer stays
    # 16-byte aligned)
    out_main, out_edge = empty(_WS_MAIN_V2), empty(_WS_EDGE)
    sizes = (main_blocks * _GROUPS * _WS_MAIN_V2, ws_edge_size,
             0 if batched else n_edges * d)
    scratch = empty(sum(sizes))
    ws_main, ws_edge, presum = (
        scratch.data_ptr() + 4 * sum(sizes[:i]) for i in range(3)
    )
    err = _v2_bwd_lib()(
        mode, num_rec, n_edges, batch, feat, int(gamma is not None), main_blocks,
        edge_blocks, _ptr(edge_in), _ptr(pre), _ptr(d_aggr), _ptr(d_new_edge),
        _ptr(edge_set.rowptr), _ptr(weights[0]), _ptr(weights[2]),
        _ptr(weights[3]), _ptr(gamma), *(_ptr(w) for w in weights[6:]),
        _ptr(d_pre), _ptr(d_edge), _ptr(d_recproj), presum,
        ws_main, _ptr(out_main), ws_edge, _ptr(out_edge),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{_V2} backward kernel launch failed: CUDA error {err}")
    fused_edge_v2_bwd.launches += 1

    dw2 = out_main[:_MAT].view(d, d)  # (out, in)
    db2, dgamma, dbeta, db1 = out_main[_MAT:].view(4, d)
    dw1e, emb_grads = _edge_grads(out_edge, raw, feat)
    zero = torch.zeros((d, d), dtype=torch.float32, device=dev)
    grads = [torch.cat([dw1e, zero, zero], dim=1), db1, dw2, db2]
    grads += [dgamma, dbeta] if gamma is not None else [None, None]
    return d_edge, d_pre, d_recproj, grads + emb_grads


fused_edge_v2_bwd.launches = 0


def _plain_v2_bwd(d_aggr, d_new_edge, edge_in, sp, rp, edge_set, weights, raw,
                  update_edges):
    """K8's plain version: autograd through :func:`_plain_v2` on the same
    inputs, with ``sp`` and ``rp`` held constant. Same returns as
    :func:`fused_edge_v2_bwd`."""
    with torch.enable_grad():
        leaves = [None if w is None else w.detach().requires_grad_(True) for w in weights]
        edge = edge_in.detach().requires_grad_(not raw)  # raw features: constants
        aggr, new_edge, pre = _plain_v2(
            edge, sp.detach(), rp.detach(), edge_set.senders, edge_set.receivers,
            leaves, raw, update_edges,
        )
        outs, seeds = [aggr], [d_aggr]
        if d_new_edge is not None:
            outs.append(new_edge)
            seeds.append(d_new_edge)
        wanted = [pre] + ([] if raw else [edge]) + [w for w in leaves if w is not None]
        got = list(torch.autograd.grad(outs, wanted, seeds, allow_unused=True))
    got = [torch.zeros_like(t) if g is None else g for t, g in zip(wanted, got)]
    d_pre = got.pop(0)
    d_edge = None if raw else got.pop(0)
    grads = [None if w is None else got.pop(0) for w in leaves]
    d_recproj = torch.zeros_like(rp).index_add_(0, edge_set.receivers, d_pre)
    return d_edge, d_pre, d_recproj, grads


class FusedEdgePhaseV2(torch.autograd.Function):
    """The v2 fused edge phase with K7 as its forward and K8, then K2 on
    ``d_pre``, as its backward. On CPU tensors the forward is the plain
    version and the backward autograd through it, then K2's plain version.

    ``apply(edge_in, sp, rp, *weights, edge_set, raw, update_edges,
    grad_enabled)`` with the twelve tensors of :func:`_weights`,
    ``grad_enabled`` the caller's grad mode; returns ``(aggr, new_edge |
    None)``. The gradient of ``W1`` carries zeros in its sender and
    receiver blocks: the node projections that formed ``sp`` and ``rp``
    add theirs."""

    @staticmethod
    def forward(ctx, edge_in, sp, rp, *args):
        weights, (edge_set, raw, update_edges, grad_enabled) = args[:12], args[12:]
        ctx.meta = (edge_set, raw, update_edges, sp.shape[0], tuple(rp.shape))
        ctx.set_materialize_grads(False)
        need_grad = grad_enabled and any(ctx.needs_input_grad)
        on_cpu = rp.device.type == "cpu"
        if on_cpu:
            aggr, new_edge, pre = _plain_v2(
                edge_in, sp, rp, edge_set.senders, edge_set.receivers, weights,
                raw, update_edges,
            )
        else:
            aggr, new_edge, pre = fused_edge_v2_fwd(
                edge_in, sp, rp, edge_set, weights, raw, update_edges,
                save_pre=need_grad,
            )
        if need_grad:
            # the plain backward recomputes from sp and rp; K8 needs only pre
            extra = (sp, rp) if on_cpu else (pre,)
            ctx.save_for_backward(edge_in, *weights, *extra)
        return aggr, new_edge

    @staticmethod
    def backward(ctx, d_aggr, d_new_edge):
        edge_set, raw, update_edges, num_send, rec_shape = ctx.meta
        # absent weights were saved as None and come back as None
        edge_in, *saved = ctx.saved_tensors
        weights, extra = saved[:12], saved[12:]
        if d_aggr is None and d_new_edge is None:
            return (None,) * 19
        if d_aggr is None:
            d_aggr = edge_in.new_zeros(rec_shape)
        if len(extra) == 2:
            d_edge, d_pre, d_recproj, grads = _plain_v2_bwd(
                d_aggr, d_new_edge, edge_in, *extra, edge_set, weights, raw,
                update_edges,
            )
        else:
            d_edge, d_pre, d_recproj, grads = fused_edge_v2_bwd(
                d_aggr.contiguous(),
                None if d_new_edge is None else d_new_edge.contiguous(),
                extra[0], edge_in, edge_set, weights, raw,
            )
        d_sp = sender_scatter(d_pre, edge_set, num_send)  # K2
        return (d_edge, d_sp, d_recproj, *grads, None, None, None, None)


def fused_edge_phase_v2(
    edge_mlp: nn.Sequential,
    edge_rep: Optional[torch.Tensor],
    send_rep: torch.Tensor,
    rec_rep: torch.Tensor,
    edge_set,
    embedder: Optional[nn.Sequential] = None,
    edge_feats: Optional[torch.Tensor] = None,
    update_edges: bool = False,
):
    """K7, differentiable through K8 and K2: the v2 fused edge phase over
    ``edge_set`` (receiver-sorted CSR), interaction wiring only.

    ``send_rep`` ``(N_send, B, D)`` and ``rec_rep`` ``(N_rec, B, D)`` are
    node arrays: their first-layer products ``sp`` and ``rp`` are formed
    here with ``torch`` matmuls, under autograd, and K7 gathers ``sp`` by
    sender. The edge input is as for :func:`fused_edge_phase`. Returns
    ``(aggregated_sum (N_rec, B, D), new_edge (E, B, D) | None)``.
    """
    if rec_rep.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{_V2}: unsupported device {rec_rep.device}")
    if not fusable(edge_mlp) or (
        embedder is not None
        and not embedder_fusable(embedder, linear_layers(edge_mlp)[1].out_features)
    ):
        raise ValueError(
            f"{_V2} takes a two-layer (3h -> h -> h) edge MLP and a "
            "Linear-SiLU-Linear-LayerNorm embedder"
        )
    raw = embedder is not None
    w1 = linear_layers(edge_mlp)[0].weight
    d = w1.shape[0]
    sp = send_rep @ w1[:, d : 2 * d].T  # once per sender row
    rp = rec_rep @ w1[:, 2 * d :].T  # once per receiver row
    return FusedEdgePhaseV2.apply(  # pre only under grad, as in fused_edge_phase
        edge_feats if raw else edge_rep, sp, rp,
        *_weights(edge_mlp, embedder),
        edge_set, raw, update_edges, torch.is_grad_enabled(),
    )


fused_edge_phase_v2.launches = 0
