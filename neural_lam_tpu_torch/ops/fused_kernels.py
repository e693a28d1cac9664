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
- Reduced precision: :func:`fused_precision` chooses, as
  ``make_fused_interaction`` and ``make_fused_interaction_v2`` do
  (pallas_fused.py:1414-1453, :2518-2525), whether the kernels' matmul
  operands are bf16 (bf16 inputs, ``high``, ``high-kernels``) and in which
  dtype the edge, sender and receiver streams move (bf16 for bf16 inputs
  and under ``high``). The bf16 instantiations of K3, K4, K7 and K8
  (``nl_fused_edge_fwd_bf16ops``, ``nl_fused_edge_bwd_bf16ops``,
  ``nl_fused_edge_v2_fwd_bf16ops``, ``nl_fused_edge_v2_bwd_bf16ops``)
  multiply bf16 operands with float32 accumulation and keep SiLU,
  LayerNorm, the residuals and the sums in float32; the outputs follow the
  receiver rows' dtype, the gradients the inputs'. On the v2 route the node
  projections ``sp`` and ``rp`` are formed as the JAX ``proj`` forms them
  (bf16 operands, float32 sums, the result in the streams' dtype), and
  K8's ``d_pre`` goes to K2 in the streams' dtype. Their plain versions,
  :func:`_plain` and :func:`_plain_v2` with ``bf16_ops``, round each
  product's operands to bf16 (:class:`_BF16Product`).
  ``NEURAL_LAM_TPU_BF16_KERNELS=off`` keeps the float32 kernels and casts
  at their boundary.
- The saved pre-activation: :func:`cache_pre` reads
  ``NEURAL_LAM_TPU_CACHE_PRE`` as the JAX package does
  (pallas_fused.py:1490-1492). ``on`` (the default) saves K3's ``pre`` in
  float32, ``bf16`` rounds it to bf16 (K3's and K4's ``PRE_BF16`` and
  ``kPreBf16`` instantiations: K4 recomputes SiLU, the second layer and
  the LayerNorm from the rounded value, the forward's outputs come from the
  unrounded one), and ``off`` saves none: K4's recomputing instantiation
  (``csrc/fused_edge_bwd_recompute.cu``) forms ``pre`` again in its tile
  loop. ``off`` also turns the v2 route off; v2 saves a float32 ``pre``
  whatever the variable says, as the JAX package does.
- The node-MLP epilogue: under ``NEURAL_LAM_TPU_FUSED_AGGR=on``
  (:func:`fused_aggr_enabled`, off by default) an interaction-wired phase
  with sum aggregation and a two-layer node MLP (:func:`aggr_fusable`) hands
  that MLP to K3 (``fused_edge_phase(..., aggr_mlp=...)``), which returns the
  receiver's node update ``rec + LN(MLP([rec, aggr]))`` instead of the
  aggregate, as the JAX kernel's ``node_epilogue`` does (pallas_fused.py
  :335-391, :1042-1049; K3's ``NODE`` instantiations,
  ``csrc/fused_edge_node.cu``). Its backward runs the node MLP's backward
  (``csrc/fused_node_bwd.cu``, the JAX kernel's :509-599) before K4, which
  then reads the aggregate's gradient as it reads ``d_aggr`` otherwise. The
  aggregate is kept in float32 for it only when the call will be
  differentiated; under a reduced precision the node MLP's products take
  bf16 operands on the float32 aggregate (:func:`_plain_node`).
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
from .segment import (
    BF16_KERNELS_ENV,
    MATMUL_PRECISION_ENV,
    bf16_kernels,
    kernel_matmul_high,
    matmul_high,
)
from .segment_kernels import LaunchCount, refuse_autograd, sender_scatter

KERNEL = "fused_edge"
NODE_KERNEL = "fused_edge_node"
BWD_KERNEL = "fused_edge_bwd"
BWD_RECOMPUTE_KERNEL = "fused_edge_bwd_recompute"
NODE_BWD_KERNEL = "fused_node_bwd"
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
# floats per group of K4's recompute workspace: a tile's pre and a chunk's
# receiver products (csrc/fused_edge_bwd_main.cuh: kPreStride)
_WS_PRE = (_TILE_ROWS + _CHUNK_ROWS_K4) * KERNEL_HIDDEN
# floats per block of the node backward's workspace, and its blocks per SM
# (csrc/fused_node_bwd.cu: kStride, kBlocksPerSm)
_WS_NODE = 3 * _MAT + 4 * KERNEL_HIDDEN
_NODE_BWD_BLOCKS_PER_SM = 2

# The launch counts of the bf16-operand instantiations of K3, K4, K7 and
# K8: bf16 streams (mixed precision, ``high``) and float32 streams
# (``high-kernels``)
FUSED_EDGE_BF16 = LaunchCount("K3 fused_edge_phase bf16")
FUSED_EDGE_BF16_OPS = LaunchCount("K3 fused_edge_phase bf16 operands")
FUSED_EDGE_BWD_BF16 = LaunchCount("K4 fused_edge_phase backward bf16")
FUSED_EDGE_BWD_BF16_OPS = LaunchCount("K4 fused_edge_phase backward bf16 operands")
FUSED_EDGE_V2_BF16 = LaunchCount("K7 fused_edge_phase_v2 bf16")
FUSED_EDGE_V2_BF16_OPS = LaunchCount("K7 fused_edge_phase_v2 bf16 operands")
FUSED_EDGE_V2_BWD_BF16 = LaunchCount("K8 fused_edge_phase_v2 backward bf16")
FUSED_EDGE_V2_BWD_BF16_OPS = LaunchCount("K8 fused_edge_phase_v2 backward bf16 operands")
# and of the instantiations of NEURAL_LAM_TPU_CACHE_PRE, in every
# precision: K3 writing a bf16 pre, K4 reading one, K4 recomputing pre
FUSED_EDGE_BF16_PRE = LaunchCount("K3 fused_edge_phase bf16 pre")
FUSED_EDGE_BWD_BF16_PRE = LaunchCount("K4 fused_edge_phase backward bf16 pre")
FUSED_EDGE_BWD_RECOMPUTE = LaunchCount("K4 fused_edge_phase backward recompute")
# and of the node-MLP epilogue (NEURAL_LAM_TPU_FUSED_AGGR=on): K3 with it
# and the node MLP's backward, in float32, with bf16 streams and with bf16
# operands on float32 streams (whatever pre K3 saves)
FUSED_EDGE_NODE = LaunchCount("K3 fused_edge_phase node epilogue")
FUSED_EDGE_NODE_BF16 = LaunchCount("K3 fused_edge_phase node epilogue bf16")
FUSED_EDGE_NODE_BF16_OPS = LaunchCount("K3 fused_edge_phase node epilogue bf16 operands")
FUSED_NODE_BWD = LaunchCount("K4 node backward")
FUSED_NODE_BWD_BF16 = LaunchCount("K4 node backward bf16")
FUSED_NODE_BWD_BF16_OPS = LaunchCount("K4 node backward bf16 operands")


def fused_precision(in_dtype: torch.dtype) -> tuple[bool, torch.dtype]:
    """``(bf16_ops, io_dtype)`` of a fused phase whose receiver rows are
    ``in_dtype``: are the kernels' matmul operands bf16, and in which dtype
    do the edge, sender and receiver streams move? The JAX package's
    ``cdt`` and ``io_dt`` (pallas_fused.py:1430-1453), from the same
    environment variables, read at every call: bf16 inputs take bf16
    streams and operands unless ``NEURAL_LAM_TPU_BF16_KERNELS=off``;
    ``high`` takes both for float32 inputs too, ``high-kernels`` the
    operands only."""
    bf16_streams = in_dtype == torch.bfloat16 and bf16_kernels()
    ops = bf16_streams or kernel_matmul_high()
    io = torch.bfloat16 if (bf16_streams or matmul_high()) else torch.float32
    return ops, io


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


def aggr_fusable(aggr_mlp: nn.Sequential) -> bool:
    """True if the node MLP has the two-linear-layer shape the node-MLP
    epilogue implements (``hidden_layers=1``): a ``(2h -> h)`` first layer
    over ``[rec, aggr]`` and an ``(h -> h)`` second layer, with the default
    LayerNorm eps if it has one. The JAX package's ``aggr_fusable``
    (pallas_fused.py:1333)."""
    layers = linear_layers(aggr_mlp)
    if len(layers) != 2:
        return False
    h = layers[0].out_features
    return (
        layers[0].in_features == 2 * h
        and (layers[1].in_features, layers[1].out_features) == (h, h)
        and _ln_ok(aggr_mlp)
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


def _node_weights(aggr_mlp: nn.Sequential) -> list:
    """The six weight tensors of the node-MLP epilogue, None where a part is
    absent: ``wa1 ba1 wa2 ba2 gn bn``, ``wa1 = [War | Wag]`` the ``(D, 2D)``
    first layer in nn.Linear's layout (the part order ``(rec, aggr)`` of
    ``_prep_node_weights``, pallas_fused.py:820-849)."""
    lin1, lin2 = linear_layers(aggr_mlp)
    ln = output_layer_norm(aggr_mlp)
    out = [lin1.weight, lin1.bias, lin2.weight, lin2.bias]
    return out + ([ln.weight, ln.bias] if ln is not None else [None, None])


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (to nearest even), as float32."""
    return x.to(torch.bfloat16).float()


class _BF16Product(torch.autograd.Function):
    """``x . w^T`` (``w`` in nn.Linear's (out, in) layout) as the bf16
    kernels form it: both operands rounded to bf16, the products exact and
    summed in float32. Its backward is the JAX backward kernel's,
    ``d_x = bf16(g) . bf16(w)`` and ``d_w = bf16(g)^T . bf16(x)``, or with
    ``round_grad`` False (the receiver slice, which the JAX package
    differentiates outside its kernel, in float32) ``g . w`` and
    ``g^T . x``."""

    @staticmethod
    def forward(ctx, x, w, round_grad):
        ctx.save_for_backward(x, w)
        ctx.round_grad = round_grad
        return _bf16(x) @ _bf16(w).T

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        if ctx.round_grad:
            g, x, w = _bf16(g), _bf16(x), _bf16(w)
        d_w = g.reshape(-1, g.shape[-1]).T @ x.reshape(-1, x.shape[-1])
        return g @ w, d_w, None


def _linear(x, w, b, bf16_ops: bool, round_grad: bool = True):
    """``x . w^T (+ b)`` in float32, or with ``bf16_ops`` as the bf16
    kernels form it (:class:`_BF16Product`; ``b`` added in float32)."""
    if not bf16_ops:
        return x @ w.T if b is None else F.linear(x, w, b)
    y = _BF16Product.apply(x, w, round_grad)
    return y if b is None else y + b


def _embed(edge_in, weights, raw, bf16_ops=False):
    """The edge input as the first layer sees it: the embedder on the raw
    features, or the edge array itself."""
    if not raw:
        return edge_in
    ew1, eb1, ew2, eb2, eg, ebt = weights[6:]
    d = ew2.shape[0]
    hidden = F.silu(_linear(edge_in, ew1, eb1, bf16_ops))
    return F.layer_norm(
        _linear(hidden, ew2, eb2, bf16_ops), (d,), eg, ebt, LN_EPS,
    )


def _edge_proj(edge_rep, w1, batch=None, bf16_ops=False):
    """``edge_rep . W1e``, once per edge for a shared ``(E, D)`` input;
    with ``bf16_ops`` per (edge, b) row of the shared input broadcast to
    ``batch``, so that its gradient rounds each row's share to bf16 before
    the batch is summed, as the JAX kernel's column-tiled weight does."""
    w1e = w1[:, : w1.shape[0]]
    if bf16_ops and edge_rep.dim() == 2:
        edge_rep = edge_rep.unsqueeze(1).expand(-1, batch, -1)
    proj = _linear(edge_rep, w1e, None, bf16_ops)
    return proj.unsqueeze(1) if proj.dim() == 2 else proj


def _messages(pre, edge_rep, rec_like, receivers, weights, update_edges,
              residual=None, bf16_ops=False):
    """Second layer, LayerNorm, the optional residuals and the receiver
    sums: ``(aggr, new_edge | None)``."""
    w2, b2, gamma, beta = weights[2:6]
    msg = _linear(F.silu(pre), w2, b2, bf16_ops)
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
           propagation, bf16_ops=False, pre_in=None, return_pre=False):
    """The phase in plain PyTorch on the weight tensors of :func:`_weights`,
    all float32. With ``bf16_ops`` each product takes bf16 operands, as
    K3's and K4's bf16 instantiations do (the JAX kernels' ``cdt``); SiLU,
    LayerNorm, the residuals and the sums stay float32. The TPU kernel's
    one-hot selection and broadcast matmuls also round the receiver
    projection, each message before its sum and a shared edge before its
    residual to bf16; the port selects, sums and broadcasts exactly.

    ``pre_in``: a saved pre-activation (float32 or bf16) for the second
    layer to start from, with the identity as its gradient: differentiated,
    the backward of K4 reading the ``pre`` that K3 saved (a bf16 one under
    ``NEURAL_LAM_TPU_CACHE_PRE=bf16``). ``return_pre`` appends the float32
    ``pre`` that the first layer formed to the outputs."""
    w1, b1 = weights[:2]
    d = w1.shape[0]
    edge_rep = _embed(edge_in, weights, raw, bf16_ops)
    # once per receiver
    rec_proj = _linear(rec_rep, w1[:, 2 * d :], None, bf16_ops, round_grad=False)
    pre = (
        _edge_proj(edge_rep, w1, x_send.shape[1], bf16_ops)
        + _linear(x_send, w1[:, d : 2 * d], None, bf16_ops)
        + rec_proj.index_select(0, receivers)
        + b1
    )
    # pre_in's value with pre's gradient (the difference is exact: a
    # rounding of pre lies within a factor 2 of it)
    used = pre if pre_in is None else pre + (pre_in.float() - pre).detach()
    aggr, new_edge = _messages(
        used, edge_rep, rec_rep, receivers, weights, update_edges,
        residual=x_send if propagation else None, bf16_ops=bf16_ops,
    )
    return (aggr, new_edge, pre) if return_pre else (aggr, new_edge)


def _plain_node(rec, aggr, node_weights, bf16_ops=False):
    """The node-MLP epilogue in plain PyTorch, in the JAX kernel's order
    (pallas_fused.py:335-391): ``rec + LN(SiLU(rec . War + aggr . Wag +
    ba1) . Wa2 + ba2)`` on float32 ``rec`` and the float32 aggregate. With
    ``bf16_ops`` each product takes bf16 operands (:class:`_BF16Product`,
    whose backward is the JAX backward kernel's, :509-599); the sums, SiLU,
    the LayerNorm and the residual stay float32."""
    wa1, ba1, wa2, ba2, gn, bn = node_weights
    d = wa2.shape[0]
    pre = (_linear(rec, wa1[:, :d], None, bf16_ops)
           + _linear(aggr, wa1[:, d:], None, bf16_ops) + ba1)
    z = _linear(F.silu(pre), wa2, ba2, bf16_ops)
    if gn is not None:
        z = F.layer_norm(z, (d,), gn, bn, LN_EPS)
    return rec + z


def _plain_node_bwd(d_node, rec, aggr, node_weights, bf16_ops=False):
    """The node backward's plain version: autograd through
    :func:`_plain_node` (all float32). Returns ``(d_aggr, d_rec, grads)``:
    ``d_rec`` the receiver's share through the node MLP and its residual,
    the grads in the order of :func:`_node_weights`, None where the weight
    is."""
    with torch.enable_grad():
        leaves = [None if w is None else w.detach().requires_grad_(True)
                  for w in (rec, aggr, *node_weights)]
        out = _plain_node(leaves[0], leaves[1], leaves[2:], bf16_ops)
        wanted = [t for t in leaves if t is not None]
        got = iter(torch.autograd.grad(out, wanted, d_node))
    grads = [None if t is None else next(got) for t in leaves]
    return grads[1], grads[0], grads[2:]


def _plain_v2(edge_in, sp, rp, senders, receivers, weights, raw, update_edges,
              bf16_ops=False):
    """The v2 phase (K7) in plain PyTorch on the node projections ``sp``
    and ``rp`` (float32): ``(aggr, new_edge | None, pre)``. With
    ``bf16_ops`` each product takes bf16 operands, as K7's and K8's bf16
    instantiations do; the gathers, sums and ``pre`` stay float32."""
    edge_rep = _embed(edge_in, weights, raw, bf16_ops)
    pre = (
        _edge_proj(edge_rep, weights[0], sp.shape[1], bf16_ops)
        + sp.index_select(0, senders)
        + rp.index_select(0, receivers)
        + weights[1]
    )
    aggr, new_edge = _messages(pre, edge_rep, rp, receivers, weights, update_edges,
                               bf16_ops=bf16_ops)
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
    aggr_mlp: Optional[nn.Sequential] = None,
):
    """Plain PyTorch version of K3 (same arguments as
    :func:`fused_edge_phase` plus the per-edge ``receivers``). Autograd
    through it is the plain version of K4 (and of the node backward, with
    ``aggr_mlp``). Under a reduced precision
    (:func:`fused_precision` of ``rec_rep``'s dtype) it is the plain
    version of K3's bf16 instantiation, with the casts of
    :func:`fused_edge_phase` around it: the same dtypes in and out. Under
    ``NEURAL_LAM_TPU_CACHE_PRE=bf16`` its values are those of the exact
    ``pre`` and its gradients those of the bf16 one (:func:`cache_pre`)."""
    raw = embedder is not None
    bf16_ops, io = fused_precision(rec_rep.dtype)
    edge_in, x_io, rec_io, weights = _kernel_inputs(
        edge_mlp, embedder, edge_rep, edge_feats, io, x_send, rec_rep
    )
    args = (edge_in.float(), x_io.float(), rec_io.float(), receivers, weights, raw,
            update_edges, propagation, bf16_ops)
    *outs, pre = _plain(*args, return_pre=True)
    if cache_pre() == "bf16":  # the values of outs, the gradients of the rounded pre's
        rounded = _plain(*args, pre_in=_bf16(pre.detach()))
        outs = [None if t is None else r + (t - r).detach() for t, r in zip(outs, rounded)]
    if aggr_mlp is not None:
        node_weights = [None if w is None else w.float() for w in _node_weights(aggr_mlp)]
        # K4 reads the aggregate's gradient in the streams' dtype
        outs[0] = _plain_node(rec_io.float(), _GradIn.apply(outs[0], io), node_weights,
                              bf16_ops)
    outs = [None if t is None else t.to(rec_rep.dtype) for t in outs]
    if io != rec_rep.dtype:  # K4 reads the incoming gradients in the streams' dtype
        outs = [None if t is None else _GradIn.apply(t, io) for t in outs]
    return tuple(outs)


class _GradIn(torch.autograd.Function):
    """The identity, whose backward rounds the gradient to ``io`` (and
    back): the cast of the incoming gradients that K4's launcher makes."""

    @staticmethod
    def forward(ctx, x, io):
        ctx.io = io
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.io).to(g.dtype), None


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
    out_dtype: Optional[torch.dtype] = None,
):
    """Plain PyTorch version of K7: the v2 phase on the sender and
    receiver projections ``sp`` ``(N_send, B, D)`` and ``rp`` ``(N_rec,
    B, D)`` (``index_select`` by ``senders`` and ``receivers``,
    ``index_add_`` into the receivers), in the streams' dtype of
    :func:`fused_precision` of ``rp``'s dtype. Returns ``(aggr, new_edge |
    None)`` in ``out_dtype`` (``rp``'s by default); autograd through it is
    the plain version of K8. Under a reduced precision it is the plain
    version of K7's bf16 instantiation: bf16 operands, float32 sums."""
    raw = embedder is not None
    bf16_ops, io = fused_precision(rp.dtype)
    edge_in, sp_io, rp_io, weights = _kernel_inputs(
        edge_mlp, embedder, edge_rep, edge_feats, io, sp, rp
    )
    aggr, new_edge, _ = _plain_v2(
        edge_in.float(), sp_io.float(), rp_io.float(), senders, receivers, weights, raw,
        update_edges, bf16_ops,
    )
    out = rp.dtype if out_dtype is None else out_dtype
    outs = [None if t is None else t.to(out) for t in (aggr, new_edge)]
    if io != out:  # K8 reads the incoming gradients in the streams' dtype
        outs = [None if t is None else _GradIn.apply(t, io) for t in outs]
    return tuple(outs)


# The environment variables that choose the route and the precision, read
# only through these names, so that ``route_env`` covers all of them
FUSED_V2_ENV = "NEURAL_LAM_TPU_FUSED_V2"
FUSED_V2_RATIO_ENV = "NEURAL_LAM_TPU_FUSED_V2_RATIO"
CACHE_PRE_ENV = "NEURAL_LAM_TPU_CACHE_PRE"
FUSED_AGGR_ENV = "NEURAL_LAM_TPU_FUSED_AGGR"
FUSED_ENV = "NEURAL_LAM_TPU_FUSED"
STENCIL_ENV = "NEURAL_LAM_TPU_STENCIL"
_ROUTE_ENV = (
    FUSED_V2_ENV, FUSED_V2_RATIO_ENV, CACHE_PRE_ENV, BF16_KERNELS_ENV,
    MATMUL_PRECISION_ENV, FUSED_AGGR_ENV, FUSED_ENV, STENCIL_ENV,
)


def route_env() -> tuple[Optional[str], ...]:
    """The environment variables that choose the route and the kernels'
    precision (:func:`fused_v2_routed`, :func:`fused_precision`,
    :func:`fused_aggr_enabled`, ``NEURAL_LAM_TPU_FUSED`` in
    ``ops.interaction.fused_edge_phase_supported``, ``NEURAL_LAM_TPU_STENCIL``
    in ``ops.stencil.stencil_enabled``), as they stand now. A
    captured CUDA graph fixes the route and the kernels' precision it was
    captured with, so a cache of graphs keys on these."""
    return tuple(os.environ.get(name) for name in _ROUTE_ENV)


def fused_disabled() -> bool:
    """``NEURAL_LAM_TPU_FUSED=off``, read at every call: every phase takes
    the unfused route, as in the JAX package's
    ``fused_edge_phase_supported`` (neural_lam_tpu/ops/interaction.py:413)."""
    return os.environ.get(FUSED_ENV, "auto") == "off"


def fused_aggr_enabled() -> bool:
    """``NEURAL_LAM_TPU_FUSED_AGGR`` as the JAX package reads it
    (pallas_fused.py:1346-1364), at every call: ``on`` runs the node MLP as
    K3's epilogue where the phase allows it (interaction wiring, sum
    aggregation, one two-layer node MLP, the v1 route); anything else, and
    the default, leaves the node MLP to the caller. The JAX package keeps it
    as an option for tight memory: the node MLP's per-node intermediates are
    never stored."""
    return os.environ.get(FUSED_AGGR_ENV, "off") == "on"


def cache_pre() -> str:
    """``NEURAL_LAM_TPU_CACHE_PRE`` as the JAX package reads it
    (pallas_fused.py:1490-1492), at every call: ``"off"`` saves no ``pre``
    (K4 recomputes it), ``"bf16"`` saves it rounded to bf16, and any other
    value saves it in float32 (``"on"``, the default)."""
    mode = os.environ.get(CACHE_PRE_ENV, "on")
    return mode if mode in ("off", "bf16") else "on"


def fused_v2_enabled() -> bool:
    """The coarse gate of the v2 route, read at call time:
    ``NEURAL_LAM_TPU_FUSED_V2=off`` turns it off everywhere, and so does
    ``NEURAL_LAM_TPU_CACHE_PRE=off`` (K8 starts from the saved ``pre``).
    The JAX package's ``fused_v2_enabled`` (pallas_fused.py:1755)."""
    if os.environ.get(FUSED_V2_ENV, "auto") == "off":
        return False
    return cache_pre() != "off"


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


def _c_fn(source: str, name: str, ints: int, pointers: int):
    """The C entry point ``name`` of ``csrc/<source>.cu``: ``ints`` int
    arguments, then ``pointers`` pointers (the stream last)."""
    fn = getattr(kernel_build.load(source), name)
    fn.argtypes = [ctypes.c_int] * ints + [ctypes.c_void_p] * pointers
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _fwd_lib():
    """K3 in float32: ``pre_bf16`` and the arguments below."""
    return _c_fn(KERNEL, "nl_fused_edge_fwd", 8, 21)


@functools.cache
def _fwd_bf16_lib():
    """K3's bf16-operand instantiations: ``(pre_bf16, io_bf16, out_bf16)``
    and then the arguments of ``nl_fused_edge_fwd``."""
    return _c_fn(KERNEL, "nl_fused_edge_fwd_bf16ops", 10, 21)


@functools.cache
def _fwd_node_lib():
    """K3 with the node-MLP epilogue, every precision: ``(bf16_ops,
    pre_bf16, io_bf16, out_bf16, node_layer_norm)``, the ints of
    ``nl_fused_edge_fwd``, its pointers up to ``pre``, the node weights and
    ``node_out``, then ``counter`` and the stream."""
    return _c_fn(NODE_KERNEL, "nl_fused_edge_fwd_node", 12, 28)


@functools.cache
def _node_bwd_lib():
    """The node MLP's backward, every precision: ``(bf16_ops, io_bf16,
    rows, layer_norm, blocks)`` and its pointers."""
    return _c_fn(NODE_BWD_KERNEL, "nl_fused_node_bwd", 5, 13)


@functools.cache
def _bwd_lib():
    """K4 from a saved pre in float32: ``pre_bf16`` and the arguments
    below."""
    return _c_fn(BWD_KERNEL, "nl_fused_edge_bwd", 10, 25)


@functools.cache
def _bwd_bf16_lib():
    """K4's bf16-operand instantiations: ``(pre_bf16, io_bf16)`` and then
    the arguments of ``nl_fused_edge_bwd``."""
    return _c_fn(BWD_KERNEL, "nl_fused_edge_bwd_bf16ops", 11, 25)


@functools.cache
def _bwd_recompute_lib():
    """K4 recomputing pre, every precision: ``(bf16_ops, io_bf16)`` and
    then the arguments of ``nl_fused_edge_bwd`` with ``rec``, ``b1`` and
    the recompute's workspace in place of ``pre``."""
    return _c_fn(BWD_RECOMPUTE_KERNEL, "nl_fused_edge_bwd_recompute", 11, 27)


@functools.cache
def _v2_fwd_lib():
    return _c_fn(V2_KERNEL, "nl_fused_edge_v2_fwd", 6, 22)


@functools.cache
def _v2_fwd_bf16_lib():
    """K7's bf16-operand instantiations: ``(io_bf16, out_bf16)`` and then
    the arguments of ``nl_fused_edge_v2_fwd``."""
    return _c_fn(V2_KERNEL, "nl_fused_edge_v2_fwd_bf16ops", 8, 22)


@functools.cache
def _v2_bwd_lib():
    return _c_fn(V2_BWD_KERNEL, "nl_fused_edge_v2_bwd", 8, 24)


@functools.cache
def _v2_bwd_bf16_lib():
    """K8's bf16-operand instantiations: ``io_bf16`` and then the
    arguments of ``nl_fused_edge_v2_bwd``."""
    return _c_fn(V2_BWD_KERNEL, "nl_fused_edge_v2_bwd_bf16ops", 9, 24)


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
           who: str = "fused_edge_phase", dtype: torch.dtype = torch.float32) -> None:
    if t.device != device:
        raise ValueError(f"{who}: {name} on {t.device}, not {device}")
    if t.dtype != dtype:
        raise TypeError(f"{who}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{who}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}"
        )
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{who}: {name} must be contiguous and aligned")


def _check_edge_and_weights(who, edge_in, edge_set, batch, dev, weights, raw,
                            io=torch.float32):
    """Refuse an edge input (of dtype ``io``), weights (float32) or an
    edge set that the CUDA kernels do not take; returns the edge mode and
    the raw feature width."""
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
        _check("edge_feats", edge_in, dev, (n_edges, feat), who, io)
        mode = _EDGE_RAW
    elif edge_in.dim() == 2:
        _check("edge_rep", edge_in, dev, (n_edges, d), who, io)
        mode = _EDGE_SHARED
    else:
        _check("edge_rep", edge_in, dev, (n_edges, batch, d), who, io)
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
    raw feature width. The streams are float32, or all bf16 (the bf16
    instantiations); the weights float32."""
    dev, d, io = x_send.device, KERNEL_HIDDEN, x_send.dtype
    if x_send.dim() != 3:
        raise ValueError("fused_edge_phase: x_send must be (E, B, D)")
    if io not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_edge_phase: x_send must be float32 or bf16, got {io}")
    n_edges, batch = x_send.shape[0], x_send.shape[1]
    if n_edges != edge_set.num_edges:
        raise ValueError("fused_edge_phase: x_send rows != edges of the edge set")
    mode, feat = _check_edge_and_weights(
        "fused_edge_phase", edge_in, edge_set, batch, dev, weights, raw, io
    )
    _check("x_send", x_send, dev, (n_edges, batch, d), dtype=io)
    _check("rec_rep", rec_rep, dev, (edge_set.num_rec, batch, d), dtype=io)
    return mode, feat


def fused_edge_fwd(edge_in, x_send, rec_rep, edge_set, weights, raw,
                   update_edges, propagation, save_pre=False, bf16_ops=False,
                   out_dtype=None, pre_dtype=torch.float32, node_weights=None,
                   save_aggr=False):
    """Launch K3 on CUDA tensors: ``(aggr, new_edge | None, pre | None)``.
    The launcher records no autograd graph; :class:`FusedEdgePhase` does.

    With ``node_weights`` (the six tensors of :func:`_node_weights`,
    float32) K3 runs the node-MLP epilogue and returns ``(node_out,
    new_edge | None, pre | None, aggr | None)``: ``node_out`` in
    ``out_dtype``, the aggregate in float32 and only with ``save_aggr``
    (``FUSED_EDGE_NODE``, ``FUSED_EDGE_NODE_BF16`` or
    ``FUSED_EDGE_NODE_BF16_OPS``).

    The streams ``edge_in``, ``x_send`` and ``rec_rep`` are all float32 or
    all bf16 and the weights float32. With ``bf16_ops`` the bf16-operand
    instantiation runs (bf16 streams: ``FUSED_EDGE_BF16``; float32:
    ``FUSED_EDGE_BF16_OPS``), and ``aggr`` and ``new_edge`` are written in
    ``out_dtype`` (float32 or bf16; the streams' dtype by default). Without
    it the streams must be float32 and so are the outputs. ``pre`` (with
    ``save_pre``) is written in ``pre_dtype``: float32, or bf16 by the
    instantiation that rounds it (``FUSED_EDGE_BF16_PRE``, in either
    precision)."""
    refuse_autograd(
        "fused_edge_fwd", "ops.fused_kernels.fused_edge_phase",
        edge_in, x_send, rec_rep, *weights,
    )
    mode, feat = _check_inputs(edge_in, x_send, rec_rep, edge_set, weights, raw)
    dev, io = x_send.device, x_send.dtype
    if not bf16_ops and io != torch.float32:
        raise TypeError("fused_edge_fwd: bf16 streams need bf16_ops")
    out = io if out_dtype is None else out_dtype
    if not bf16_ops and out != torch.float32:
        raise TypeError("fused_edge_fwd: the float32 kernel writes float32")
    if pre_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_edge_fwd: pre must be float32 or bf16, not {pre_dtype}")
    shape = tuple(x_send.shape)
    node = node_weights is not None
    aggr_dtype = torch.float32 if node else out
    aggr = (torch.empty(tuple(rec_rep.shape), dtype=aggr_dtype, device=dev)
            if save_aggr or not node else None)
    new_edge = torch.empty(shape, dtype=out, device=dev) if update_edges else None
    pre = torch.empty(shape, dtype=pre_dtype, device=dev) if save_pre else None
    pre_bf16 = pre is not None and pre_dtype == torch.bfloat16
    io_bf16 = io == torch.bfloat16
    if node:
        _check_node_weights("fused_edge_fwd", node_weights, dev)
        node_out = torch.empty(tuple(rec_rep.shape), dtype=out, device=dev)
        if edge_set.num_rec == 0:
            return node_out, new_edge, pre, aggr
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
        err = _fwd_node_lib()(
            int(bf16_ops), int(pre_bf16), int(io_bf16), int(out == torch.bfloat16),
            int(node_weights[4] is not None), mode, edge_set.num_rec, shape[1], feat,
            int(update_edges), int(propagation), int(weights[4] is not None),
            _ptr(edge_in), _ptr(x_send), _ptr(rec_rep), _ptr(edge_set.rowptr),
            *(_ptr(w) for w in weights), _ptr(aggr), _ptr(new_edge), _ptr(pre),
            *(_ptr(w) for w in node_weights), _ptr(node_out), _ptr(counter),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(
                f"fused_edge_phase node epilogue kernel launch failed: CUDA error {err}"
            )
        (FUSED_EDGE_NODE if not bf16_ops else
         FUSED_EDGE_NODE_BF16 if io_bf16 else FUSED_EDGE_NODE_BF16_OPS).launches += 1
        return node_out, new_edge, pre, aggr
    if edge_set.num_rec == 0:
        return aggr, new_edge, pre
    # the kernel's work counter; inside a CUDA graph capture its zero-fill
    # is a node of the graph, so every replay starts it at 0 again
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    args = (
        mode, edge_set.num_rec, shape[1], feat, int(update_edges),
        int(propagation), int(weights[4] is not None),
        _ptr(edge_in), _ptr(x_send), _ptr(rec_rep), _ptr(edge_set.rowptr),
        *(_ptr(w) for w in weights),
        _ptr(aggr), _ptr(new_edge), _ptr(pre), _ptr(counter),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if bf16_ops:
        err = _fwd_bf16_lib()(int(pre_bf16), int(io_bf16), int(out == torch.bfloat16), *args)
    else:
        err = _fwd_lib()(int(pre_bf16), *args)
    if err != 0:
        raise RuntimeError(f"fused_edge_phase kernel launch failed: CUDA error {err}")
    if pre_bf16:
        FUSED_EDGE_BF16_PRE.launches += 1
    elif not bf16_ops:
        fused_edge_phase.launches += 1
    else:
        (FUSED_EDGE_BF16 if io_bf16 else FUSED_EDGE_BF16_OPS).launches += 1
    return aggr, new_edge, pre


def _check_node_weights(who, node_weights, dev) -> None:
    """Refuse node weights that the node-MLP kernels do not take."""
    d = KERNEL_HIDDEN
    wa1, ba1, wa2, ba2, gn, bn = node_weights
    if tuple(wa1.shape) != (d, 2 * d) or tuple(wa2.shape) != (d, d) or (gn is None) != (bn is None):
        raise ValueError(f"{who}: the CUDA kernels take a (2*{d} -> {d} -> {d}) node MLP")
    for w in node_weights:
        if w is not None and (w.device != dev or w.dtype != torch.float32
                              or not w.is_contiguous() or w.data_ptr() % 16):
            raise ValueError(
                f"{who}: node weights must be contiguous, 16-byte aligned float32 on {dev}"
            )


def fused_node_bwd(d_node, rec_rep, aggr, node_weights, bf16_ops=False):
    """Launch the node MLP's backward on CUDA tensors (before K4): from
    ``d_node``, the gradient of K3's node update, recompute the node MLP
    from ``rec_rep`` and the saved float32 aggregate ``aggr`` and return
    ``(d_aggr, d_rec, grads)``: ``d_aggr`` for K4, in the streams' dtype;
    ``d_rec`` the receiver's share through the node MLP and its residual,
    float32; the weight gradients in the order of :func:`_node_weights`,
    None where the weight is, summed deterministically.

    ``d_node`` and ``rec_rep`` are ``(N_rec, B, D)`` in the streams' dtype,
    float32 or (with ``bf16_ops``) bf16. With ``bf16_ops`` the products take
    bf16 operands (``FUSED_NODE_BWD_BF16`` or ``FUSED_NODE_BWD_BF16_OPS``);
    without, 3xTF32 (``FUSED_NODE_BWD``)."""
    refuse_autograd("fused_node_bwd", "ops.fused_kernels.fused_edge_phase",
                    d_node, rec_rep, aggr, *node_weights)
    dev, d, io = rec_rep.device, KERNEL_HIDDEN, rec_rep.dtype
    who = "fused_node_bwd"
    if io not in (torch.float32, torch.bfloat16) or (not bf16_ops and io != torch.float32):
        raise TypeError(f"{who}: streams of {io} need bf16_ops, or are float32")
    if rec_rep.dim() != 3 or rec_rep.shape[2] != d:
        raise ValueError(f"{who}: rec_rep must be (N, B, {d})")
    shape = tuple(rec_rep.shape)
    _check("rec_rep", rec_rep, dev, shape, who, io)
    _check("d_node", d_node, dev, shape, who, io)
    _check("aggr", aggr, dev, shape, who)
    _check_node_weights(who, node_weights, dev)
    d_aggr = torch.empty(shape, dtype=io, device=dev)
    d_rec = torch.empty(shape, dtype=torch.float32, device=dev)
    rows = shape[0] * shape[1]
    if rows == 0:
        return d_aggr, d_rec, [None if w is None else torch.zeros_like(w) for w in node_weights]
    sms = _sm_count(dev.index if dev.index is not None else torch.cuda.current_device())
    blocks = min(_NODE_BWD_BLOCKS_PER_SM * sms, -(-rows // _TILE_ROWS))
    out = torch.empty(_WS_NODE, dtype=torch.float32, device=dev)
    ws = torch.empty(blocks * _WS_NODE, dtype=torch.float32, device=dev)
    wa1, ba1, wa2, ba2, gn, bn = node_weights
    io_bf16 = io == torch.bfloat16
    err = _node_bwd_lib()(
        int(bf16_ops), int(io_bf16), rows, int(gn is not None), blocks, _ptr(rec_rep),
        _ptr(aggr), _ptr(d_node), _ptr(wa1), _ptr(ba1), _ptr(wa2), _ptr(ba2), _ptr(gn),
        _ptr(d_aggr), _ptr(d_rec), _ptr(ws), _ptr(out),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_node_bwd kernel launch failed: CUDA error {err}")
    (FUSED_NODE_BWD if not bf16_ops else
     FUSED_NODE_BWD_BF16 if io_bf16 else FUSED_NODE_BWD_BF16_OPS).launches += 1
    dwar, dwag, dwa2 = out[: 3 * _MAT].view(3, d, d)
    dba1, dba2, dgn, dbn = out[3 * _MAT :].view(4, d)
    grads = [torch.cat([dwar, dwag], dim=1), dba1, dwa2, dba2]
    grads += [dgn, dbn] if gn is not None else [None, None]
    return d_aggr, d_rec, grads


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
                   weights, raw, propagation, bf16_ops=False):
    """Launch K4 on CUDA tensors. ``d_new_edge`` may be None (no gradient
    reaches the updated edges). Returns ``(d_edge | None, d_send, d_rec,
    weight grads)``: ``d_edge`` in the edge input's shape, None for raw
    features; the weight grads in the order of :func:`_weights`, None
    where the weight is.

    ``d_aggr``, ``d_new_edge``, the edge input, ``x_send`` and ``rec_rep``
    are in the streams' dtype, float32 or (with ``bf16_ops``) bf16, and so
    are ``d_edge`` and ``d_send``; ``d_rec`` and the weight gradients are
    float32. With ``bf16_ops`` the bf16-operand instantiation runs
    (``FUSED_EDGE_BWD_BF16`` or ``FUSED_EDGE_BWD_BF16_OPS``). ``pre`` is
    K3's saved pre-activation, float32 or bf16 (``FUSED_EDGE_BWD_BF16_PRE``),
    or None: the instantiation that recomputes it from the edge input,
    ``x_send`` and ``rec_rep`` runs (``FUSED_EDGE_BWD_RECOMPUTE``); both in
    either precision."""
    mode, feat = _check_inputs(edge_in, x_send, rec_rep, edge_set, weights, raw)
    dev, d, io = x_send.device, KERNEL_HIDDEN, x_send.dtype
    if not bf16_ops and io != torch.float32:
        raise TypeError("fused_edge_bwd: bf16 streams need bf16_ops")
    n_edges, batch = x_send.shape[0], x_send.shape[1]
    num_rec = edge_set.num_rec
    _check("d_aggr", d_aggr, dev, (num_rec, batch, d), dtype=io)
    if pre is not None:
        _check("pre", pre, dev, (n_edges, batch, d),
               dtype=torch.bfloat16 if pre.dtype == torch.bfloat16 else torch.float32)
    if d_new_edge is not None:
        _check("d_new_edge", d_new_edge, dev, (n_edges, batch, d), dtype=io)
    w1, _, _, _, gamma = weights[:5]

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    batched = mode == _EDGE_BATCHED
    d_send = empty(n_edges, batch, d, dtype=io)
    d_recproj = empty(num_rec, batch, d)
    d_edge = None
    if batched:
        d_edge = empty(n_edges, batch, d, dtype=io)
    elif mode == _EDGE_SHARED:
        d_edge = empty(n_edges, d, dtype=io)
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
    # ws_main | ws_edge | d_pre or s | the recompute's workspace (multiples
    # of 4 floats: each pointer stays 16-byte aligned)
    out_main, out_edge = empty(_WS_MAIN), empty(_WS_EDGE)
    sizes = (main_blocks * _GROUPS * _WS_MAIN, ws_edge_size,
             n_edges * (batch if batched else 1) * d,
             main_blocks * _GROUPS * _WS_PRE if pre is None else 0)
    scratch = empty(sum(sizes))
    ws_main, ws_edge, d_pre, pre_ws = (
        scratch.data_ptr() + 4 * sum(sizes[:i]) for i in range(4)
    )
    ints = (mode, num_rec, n_edges, batch, feat, int(propagation),
            int(gamma is not None), main_blocks, edge_blocks)
    outs = (_ptr(d_send), _ptr(d_edge), _ptr(d_recproj), d_pre,
            ws_main, _ptr(out_main), ws_edge, _ptr(out_edge))
    embedder = tuple(_ptr(w) for w in weights[6:])
    stream = torch.cuda.current_stream(dev).cuda_stream
    io_bf16 = io == torch.bfloat16
    if pre is None:
        err = _bwd_recompute_lib()(
            int(bf16_ops), int(io_bf16), *ints, _ptr(edge_in), _ptr(x_send), _ptr(rec_rep),
            _ptr(d_aggr), _ptr(d_new_edge), _ptr(edge_set.rowptr), _ptr(w1),
            _ptr(weights[1]), _ptr(weights[2]), _ptr(weights[3]), _ptr(gamma), *embedder,
            *outs, pre_ws, stream,
        )
    else:
        args = (
            *ints, _ptr(edge_in), _ptr(x_send), _ptr(pre), _ptr(d_aggr), _ptr(d_new_edge),
            _ptr(edge_set.rowptr), _ptr(w1), _ptr(weights[2]), _ptr(weights[3]),
            _ptr(gamma), *embedder, *outs, stream,
        )
        pre_bf16 = int(pre.dtype == torch.bfloat16)
        if bf16_ops:
            err = _bwd_bf16_lib()(pre_bf16, int(io_bf16), *args)
        else:
            err = _bwd_lib()(pre_bf16, *args)
    if err != 0:
        raise RuntimeError(
            f"fused_edge_phase backward kernel launch failed: CUDA error {err}"
        )
    if pre is None:
        FUSED_EDGE_BWD_RECOMPUTE.launches += 1
    elif pre.dtype == torch.bfloat16:
        FUSED_EDGE_BWD_BF16_PRE.launches += 1
    elif not bf16_ops:
        fused_edge_bwd.launches += 1
    else:
        (FUSED_EDGE_BWD_BF16 if io_bf16 else FUSED_EDGE_BWD_BF16_OPS).launches += 1

    mats = out_main[: 2 * _MAT].view(2, d, d)  # dW2, dW1s as (out, in)
    db2, dgamma, dbeta, db1 = out_main[2 * _MAT :].view(4, d)
    dw1e, emb_grads = _edge_grads(out_edge, raw, feat)
    # the receiver slice: node-sized products in float32, as the JAX
    # package forms them (its einsums promote bf16 rows to float32)
    w1r = w1[:, 2 * d :]
    d_rec = d_recproj @ w1r
    dw1r = torch.einsum("nbc,nbk->ck", d_recproj, rec_rep.float())
    grads = [torch.cat([dw1e, mats[1], dw1r], dim=1), db1, mats[0], db2]
    grads += [dgamma, dbeta] if gamma is not None else [None, None]
    return d_edge, d_send, d_rec, grads + emb_grads


fused_edge_bwd.launches = 0


class FusedEdgePhase(torch.autograd.Function):
    """The fused edge phase with K3 as its forward and K4 as its
    backward. On CPU tensors the forward is the plain version and the
    backward is autograd through the plain version.

    ``apply(edge_in, x_send, rec_rep, *weights, *node_weights, edge_set,
    raw, update_edges, propagation, grad_enabled, bf16_ops, out_dtype,
    pre_mode)`` with the streams in one dtype (float32, or bf16 with
    ``bf16_ops``), the twelve float32 tensors of :func:`_weights`, the six
    of :func:`_node_weights` (six Nones without the node-MLP epilogue),
    ``grad_enabled`` the caller's grad mode, ``bf16_ops`` the kernels'
    bf16 operands, ``out_dtype`` that of the outputs and ``pre_mode``
    :func:`cache_pre`'s: what K3 saves for K4 (a float32 ``pre``, a bf16
    one, or none); returns ``(aggr, new_edge | None)``, or with node
    weights ``(node_out, new_edge | None)``, when K3 also saves the float32
    aggregate for the node backward, which runs before K4. The backward
    takes the incoming gradients in the streams' dtype, as the JAX package
    casts them to ``io_dt``, and returns the streams' gradients in their
    dtype and the weights' in float32.
    """

    @staticmethod
    def forward(ctx, edge_in, x_send, rec_rep, *args):
        weights, node_weights = args[:12], args[12:18]
        (edge_set, raw, update_edges, propagation, grad_enabled, bf16_ops,
         out_dtype, pre_mode) = args[18:]
        node = node_weights[0] is not None
        ctx.meta = (edge_set, raw, update_edges, propagation, bf16_ops, pre_mode)
        ctx.set_materialize_grads(False)
        need_grad = grad_enabled and any(ctx.needs_input_grad)
        save_pre = need_grad and pre_mode != "off"
        pre_dtype = torch.bfloat16 if pre_mode == "bf16" else torch.float32
        aggr32 = None
        if x_send.device.type == "cpu":
            # the plain version saves what K3 would: pre in pre_dtype, or
            # none, and with the epilogue the float32 aggregate
            aggr, new_edge, pre = _plain(
                edge_in.float(), x_send.float(), rec_rep.float(),
                edge_set.receivers, weights, raw, update_edges, propagation,
                bf16_ops, return_pre=True,
            )
            pre = pre.to(pre_dtype) if save_pre else None
            if node:
                aggr32 = aggr if need_grad else None
                aggr = _plain_node(rec_rep.float(), aggr, node_weights, bf16_ops)
            aggr = aggr.to(out_dtype)
            new_edge = None if new_edge is None else new_edge.to(out_dtype)
        else:  # the float32 kernel writes float32, cast on the way out
            out = fused_edge_fwd(
                edge_in, x_send, rec_rep, edge_set, weights, raw, update_edges,
                propagation, save_pre=save_pre, bf16_ops=bf16_ops,
                out_dtype=out_dtype if bf16_ops else None, pre_dtype=pre_dtype,
                node_weights=node_weights if node else None, save_aggr=need_grad,
            )
            aggr, new_edge, pre = out[:3]
            aggr32 = out[3] if node else None
            aggr = aggr.to(out_dtype)
            new_edge = None if new_edge is None else new_edge.to(out_dtype)
        if need_grad:
            ctx.save_for_backward(edge_in, x_send, rec_rep, *weights, *node_weights, pre,
                                  aggr32)
        return aggr, new_edge

    @staticmethod
    def backward(ctx, d_aggr, d_new_edge):
        edge_set, raw, update_edges, propagation, bf16_ops, pre_mode = ctx.meta
        # absent weights (and pre, under pre_mode "off", and the aggregate
        # without the epilogue) were saved as None and come back as None
        edge_in, x_send, rec_rep, *saved = ctx.saved_tensors
        weights, node_weights, (pre, aggr32) = saved[:12], saved[12:18], saved[18:]
        if d_aggr is None and d_new_edge is None:
            return (None,) * 29
        io = x_send.dtype
        d_aggr = torch.zeros_like(rec_rep) if d_aggr is None else d_aggr.to(io)
        if d_new_edge is not None:
            d_new_edge = d_new_edge.to(io)
        node_grads, d_rec_node = [None] * 6, None
        if aggr32 is not None:
            # the node MLP's backward first: d_aggr is the node update's
            # gradient, and K4 reads the aggregate's, in the streams' dtype
            if x_send.device.type == "cpu":
                d_agg, d_rec_node, node_grads = _plain_node_bwd(
                    d_aggr.float(), rec_rep.float(), aggr32, node_weights, bf16_ops)
                d_aggr = d_agg.to(io)
            else:
                d_aggr, d_rec_node, node_grads = fused_node_bwd(
                    d_aggr.contiguous(), rec_rep, aggr32, node_weights, bf16_ops)
        if x_send.device.type == "cpu":
            d_edge, d_send, d_rec, grads = _plain_bwd(
                d_aggr.float(), None if d_new_edge is None else d_new_edge.float(),
                edge_in.float(), x_send.float(), rec_rep.float(), edge_set,
                weights, raw, update_edges, propagation, bf16_ops, pre,
            )
        else:
            d_edge, d_send, d_rec, grads = fused_edge_bwd(
                d_aggr.contiguous(),
                None if d_new_edge is None else d_new_edge.contiguous(),
                pre, edge_in, x_send, rec_rep, edge_set, weights, raw,
                propagation, bf16_ops,
            )
        if d_rec_node is not None:
            d_rec = d_rec + d_rec_node
        d_edge = None if d_edge is None else d_edge.to(io)
        return (d_edge, d_send.to(io), d_rec.to(io), *grads, *node_grads, *(None,) * 8)


def _plain_bwd(d_aggr, d_new_edge, edge_in, x_send, rec_rep, edge_set, weights,
               raw, update_edges, propagation, bf16_ops=False, pre=None):
    """K4's plain version: autograd through :func:`_plain` on the same
    inputs, from the saved ``pre`` (float32 or bf16) or, without one,
    recomputing it. Same returns as :func:`fused_edge_bwd`."""
    with torch.enable_grad():
        leaves = [
            None if t is None else t.detach().requires_grad_(True)
            for t in (edge_in, x_send, rec_rep, *weights)
        ]
        if raw:
            leaves[0] = edge_in.detach()  # the raw features are constants
        aggr, new_edge = _plain(
            leaves[0], leaves[1], leaves[2], edge_set.receivers, leaves[3:],
            raw, update_edges, propagation, bf16_ops, pre_in=pre,
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
    aggr_mlp: Optional[nn.Sequential] = None,
):
    """K3, differentiable through K4: the fused edge phase over
    ``edge_set`` (receiver-sorted CSR).

    ``x_send`` is ``(E, B, D)`` (sender rows from K1), ``rec_rep`` is
    ``(N_rec, B, D)``; the edge input is either ``edge_rep`` of shape
    ``(E, B, D)`` or ``(E, D)`` (shared across the batch), or, with
    ``embedder``, the raw ``edge_feats`` of shape ``(E, F)``. Returns
    ``(aggregated_sum (N_rec, B, D), new_edge (E, B, D) | None)``.

    With ``aggr_mlp`` (an :func:`aggr_fusable` node MLP over ``[rec,
    aggr]``) K3 also runs the node-MLP epilogue and the first output is
    the receiver's node update ``rec_rep + aggr_mlp([rec_rep, aggr])``
    instead of the aggregate, as the JAX kernel's with ``aggr_params``;
    differentiated, the node MLP's backward runs before K4.
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
    if aggr_mlp is not None and not (
        aggr_fusable(aggr_mlp)
        and linear_layers(aggr_mlp)[1].out_features == linear_layers(edge_mlp)[1].out_features
    ):
        raise ValueError("fused_edge_phase's node epilogue takes a two-layer "
                         "(2h -> h -> h) node MLP of the edge MLP's width")
    raw = embedder is not None
    bf16_ops, io = fused_precision(rec_rep.dtype)
    edge_in, x_io, rec_io, weights = _kernel_inputs(
        edge_mlp, embedder, edge_rep, edge_feats, io, x_send, rec_rep
    )
    node_weights = [None] * 6
    if aggr_mlp is not None:
        node_weights = [None if w is None else w.float() for w in _node_weights(aggr_mlp)]
    # grad mode decides whether K3 writes pre (and, with the epilogue, the
    # aggregate) for the backward: inside the Function, needs_input_grad
    # follows the parameters' requires_grad even under no_grad and
    # inference_mode, where no backward will run
    return FusedEdgePhase.apply(
        edge_in, x_io, rec_io, *weights, *node_weights,
        edge_set, raw, update_edges, propagation, torch.is_grad_enabled(),
        bf16_ops, rec_rep.dtype, cache_pre(),
    )


def _kernel_inputs(edge_mlp, embedder, edge_rep, edge_feats, io, *streams):
    """The edge input and ``streams`` in ``io`` and the twelve weights of
    :func:`_weights` in float32, by casts that autograd follows back to
    the callers' dtypes (none where the dtype is already right): the JAX
    package's casts around its kernels (pallas_fused.py:1463-1472,
    :1720-1735), the raw features through float32 as there."""
    if embedder is not None:
        edge_in = edge_feats.float().to(io)
    else:
        edge_in = edge_rep.to(io)
    weights = [None if w is None else w.float() for w in _weights(edge_mlp, embedder)]
    return (edge_in, *(t.to(io) for t in streams), weights)


fused_edge_phase.launches = 0


# -- the v2 route: K7 forward, K8 backward ----------------------------------

_V2 = "fused_edge_phase_v2"


def _check_v2_inputs(edge_in, sp, rp, edge_set, weights, raw) -> tuple[int, int]:
    """Refuse what K7 and K8 do not take; returns the edge mode and the
    raw feature width. The streams ``edge_in``, ``sp`` and ``rp`` are all
    float32 or all bf16 (the bf16 instantiations); the weights float32."""
    dev, d, io = rp.device, KERNEL_HIDDEN, rp.dtype
    if sp.dim() != 3 or rp.dim() != 3:
        raise ValueError(f"{_V2}: sp and rp must be (N, B, D)")
    if io not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{_V2}: rp must be float32 or bf16, got {io}")
    batch = rp.shape[1]
    mode, feat = _check_edge_and_weights(_V2, edge_in, edge_set, batch, dev, weights, raw, io)
    n_tab = edge_set.send_rowptr.shape[0] - 1
    if sp.shape[0] < n_tab:
        raise ValueError(
            f"{_V2}: sp has {sp.shape[0]} rows for an edge set with senders "
            f"up to {n_tab - 1}"
        )
    _check("sp", sp, dev, (sp.shape[0], batch, d), _V2, io)
    _check("rp", rp, dev, (edge_set.num_rec, batch, d), _V2, io)
    return mode, feat


def fused_edge_v2_fwd(edge_in, sp, rp, edge_set, weights, raw, update_edges,
                      save_pre=False, bf16_ops=False, out_dtype=None):
    """Launch K7 on CUDA tensors: ``(aggr, new_edge | None, pre | None)``.
    The launcher records no autograd graph; :class:`FusedEdgePhaseV2`
    does.

    The streams ``edge_in``, ``sp`` and ``rp`` are all float32 or all
    bf16 and the weights float32. With ``bf16_ops`` the bf16-operand
    instantiation runs (bf16 streams: ``FUSED_EDGE_V2_BF16``; float32:
    ``FUSED_EDGE_V2_BF16_OPS``), and ``aggr`` and ``new_edge`` are written
    in ``out_dtype`` (float32 or bf16; the streams' dtype by default).
    Without it the streams must be float32 and so are the outputs. ``pre``
    is float32 always, as in the JAX package (pallas_fused.py:2256-2259)."""
    refuse_autograd(
        "fused_edge_v2_fwd", "ops.fused_kernels.fused_edge_phase_v2",
        edge_in, sp, rp, *weights,
    )
    mode, feat = _check_v2_inputs(edge_in, sp, rp, edge_set, weights, raw)
    dev, batch, io = rp.device, rp.shape[1], rp.dtype
    if not bf16_ops and io != torch.float32:
        raise TypeError(f"{_V2}: bf16 streams need bf16_ops")
    out = io if out_dtype is None else out_dtype
    if not bf16_ops and out != torch.float32:
        raise TypeError(f"{_V2}: the float32 kernel writes float32")
    shape = (edge_set.num_edges, batch, KERNEL_HIDDEN)
    aggr = torch.empty(tuple(rp.shape), dtype=out, device=dev)
    new_edge = torch.empty(shape, dtype=out, device=dev) if update_edges else None
    pre = torch.empty(shape, dtype=torch.float32, device=dev) if save_pre else None
    if edge_set.num_rec == 0:
        return aggr, new_edge, pre
    # the kernel's work counter; inside a CUDA graph capture its zero-fill
    # is a node of the graph, so every replay starts it at 0 again
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    args = (
        mode, edge_set.num_rec, batch, feat, int(update_edges),
        int(weights[4] is not None),
        _ptr(edge_in), _ptr(sp), _ptr(rp), _ptr(edge_set.rowptr),
        _ptr(edge_set.senders), *(_ptr(w) for w in weights),
        _ptr(aggr), _ptr(new_edge), _ptr(pre), _ptr(counter),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    io_bf16 = io == torch.bfloat16
    if bf16_ops:
        err = _v2_fwd_bf16_lib()(int(io_bf16), int(out == torch.bfloat16), *args)
    else:
        err = _v2_fwd_lib()(*args)
    if err != 0:
        raise RuntimeError(f"{_V2} kernel launch failed: CUDA error {err}")
    if not bf16_ops:
        fused_edge_phase_v2.launches += 1
    else:
        (FUSED_EDGE_V2_BF16 if io_bf16 else FUSED_EDGE_V2_BF16_OPS).launches += 1
    return aggr, new_edge, pre


def fused_edge_v2_bwd(d_aggr, d_new_edge, pre, edge_in, edge_set, weights, raw,
                      bf16_ops=False):
    """Launch K8 on CUDA tensors. ``d_new_edge`` may be None (no gradient
    reaches the updated edges). Returns ``(d_edge | None, d_pre,
    d_recproj, weight grads)``: ``d_edge`` in the edge input's shape, None
    for raw features; ``d_pre`` per (edge, b) row and ``d_recproj`` its
    sum per (receiver, b); the weight grads in the order of
    :func:`_weights`, None where the weight is, with zeros in the sender
    and receiver blocks of ``W1``: those come from autograd of the node
    projections.

    ``d_aggr``, ``d_new_edge`` and the edge input are in the streams'
    dtype, float32 or (with ``bf16_ops``) bf16, and so is ``d_edge``;
    ``pre``, ``d_pre``, ``d_recproj`` and the weight gradients are
    float32. With ``bf16_ops`` the bf16-operand instantiation runs
    (``FUSED_EDGE_V2_BWD_BF16`` or ``FUSED_EDGE_V2_BWD_BF16_OPS``)."""
    dev, d, io = pre.device, KERNEL_HIDDEN, d_aggr.dtype
    n_edges, num_rec, batch = edge_set.num_edges, edge_set.num_rec, pre.shape[1]
    if io not in (torch.float32, torch.bfloat16) or (not bf16_ops and io != torch.float32):
        raise TypeError(f"{_V2}: streams of {io} need bf16_ops, or are float32")
    mode, feat = _check_edge_and_weights(_V2, edge_in, edge_set, batch, dev, weights, raw, io)
    _check("pre", pre, dev, (n_edges, batch, d), _V2)
    _check("d_aggr", d_aggr, dev, (num_rec, batch, d), _V2, io)
    if d_new_edge is not None:
        _check("d_new_edge", d_new_edge, dev, (n_edges, batch, d), _V2, io)
    gamma = weights[4]

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    batched = mode == _EDGE_BATCHED
    d_pre = empty(n_edges, batch, d)
    d_recproj = empty(num_rec, batch, d)
    d_edge = None
    if batched:
        d_edge = empty(n_edges, batch, d, dtype=io)
    elif mode == _EDGE_SHARED:
        d_edge = empty(n_edges, d, dtype=io)
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
    args = (
        mode, num_rec, n_edges, batch, feat, int(gamma is not None), main_blocks,
        edge_blocks, _ptr(edge_in), _ptr(pre), _ptr(d_aggr), _ptr(d_new_edge),
        _ptr(edge_set.rowptr), _ptr(weights[0]), _ptr(weights[2]),
        _ptr(weights[3]), _ptr(gamma), *(_ptr(w) for w in weights[6:]),
        _ptr(d_pre), _ptr(d_edge), _ptr(d_recproj), presum,
        ws_main, _ptr(out_main), ws_edge, _ptr(out_edge),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    io_bf16 = io == torch.bfloat16
    err = _v2_bwd_bf16_lib()(int(io_bf16), *args) if bf16_ops else _v2_bwd_lib()(*args)
    if err != 0:
        raise RuntimeError(f"{_V2} backward kernel launch failed: CUDA error {err}")
    if not bf16_ops:
        fused_edge_v2_bwd.launches += 1
    else:
        (FUSED_EDGE_V2_BWD_BF16 if io_bf16 else FUSED_EDGE_V2_BWD_BF16_OPS).launches += 1

    dw2 = out_main[:_MAT].view(d, d)  # (out, in)
    db2, dgamma, dbeta, db1 = out_main[_MAT:].view(4, d)
    dw1e, emb_grads = _edge_grads(out_edge, raw, feat)
    zero = torch.zeros((d, d), dtype=torch.float32, device=dev)
    grads = [torch.cat([dw1e, zero, zero], dim=1), db1, dw2, db2]
    grads += [dgamma, dbeta] if gamma is not None else [None, None]
    return d_edge, d_pre, d_recproj, grads + emb_grads


fused_edge_v2_bwd.launches = 0


def _plain_v2_bwd(d_aggr, d_new_edge, edge_in, sp, rp, edge_set, weights, raw,
                  update_edges, bf16_ops=False):
    """K8's plain version: autograd through :func:`_plain_v2` on the same
    inputs (float32), with ``sp`` and ``rp`` held constant. Same returns as
    :func:`fused_edge_v2_bwd`, all float32."""
    with torch.enable_grad():
        leaves = [None if w is None else w.detach().requires_grad_(True) for w in weights]
        edge = edge_in.detach().requires_grad_(not raw)  # raw features: constants
        aggr, new_edge, pre = _plain_v2(
            edge, sp.detach(), rp.detach(), edge_set.senders, edge_set.receivers,
            leaves, raw, update_edges, bf16_ops,
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
    grad_enabled, bf16_ops, out_dtype)`` with the streams in one dtype
    (float32, or bf16 with ``bf16_ops``), the twelve float32 tensors of
    :func:`_weights`, ``grad_enabled`` the caller's grad mode, ``bf16_ops``
    the kernels' bf16 operands and ``out_dtype`` that of the outputs;
    returns ``(aggr, new_edge | None)``. The backward takes the incoming
    gradients in the streams' dtype and hands K2 ``d_pre`` in it, as the
    JAX package casts them to ``io_dt`` (pallas_fused.py:2322, :2389,
    :2651-2657), and returns the streams' gradients in their dtype. The
    gradient of ``W1`` carries zeros in its sender and receiver blocks: the
    node projections that formed ``sp`` and ``rp`` add theirs."""

    @staticmethod
    def forward(ctx, edge_in, sp, rp, *args):
        weights = args[:12]
        edge_set, raw, update_edges, grad_enabled, bf16_ops, out_dtype = args[12:]
        ctx.meta = (edge_set, raw, update_edges, bf16_ops, sp.shape[0], tuple(rp.shape))
        ctx.io = rp.dtype  # the streams'
        ctx.set_materialize_grads(False)
        need_grad = grad_enabled and any(ctx.needs_input_grad)
        on_cpu = rp.device.type == "cpu"
        if on_cpu:
            aggr, new_edge, pre = _plain_v2(
                edge_in.float(), sp.float(), rp.float(), edge_set.senders,
                edge_set.receivers, weights, raw, update_edges, bf16_ops,
            )
            aggr = aggr.to(out_dtype)
            new_edge = None if new_edge is None else new_edge.to(out_dtype)
        elif bf16_ops:
            aggr, new_edge, pre = fused_edge_v2_fwd(
                edge_in, sp, rp, edge_set, weights, raw, update_edges,
                save_pre=need_grad, bf16_ops=True, out_dtype=out_dtype,
            )
        else:  # the float32 kernel, cast on the way out
            aggr, new_edge, pre = fused_edge_v2_fwd(
                edge_in, sp, rp, edge_set, weights, raw, update_edges,
                save_pre=need_grad,
            )
            aggr = aggr.to(out_dtype)
            new_edge = None if new_edge is None else new_edge.to(out_dtype)
        if need_grad:
            # the plain backward recomputes from sp and rp; K8 needs only pre
            extra = (sp, rp) if on_cpu else (pre,)
            ctx.save_for_backward(edge_in, *weights, *extra)
        return aggr, new_edge

    @staticmethod
    def backward(ctx, d_aggr, d_new_edge):
        edge_set, raw, update_edges, bf16_ops, num_send, rec_shape = ctx.meta
        # absent weights were saved as None and come back as None
        edge_in, *saved = ctx.saved_tensors
        weights, extra = saved[:12], saved[12:]
        if d_aggr is None and d_new_edge is None:
            return (None,) * 21
        io = ctx.io
        d_aggr = edge_in.new_zeros(rec_shape, dtype=io) if d_aggr is None else d_aggr.to(io)
        if d_new_edge is not None:
            d_new_edge = d_new_edge.to(io)
        if len(extra) == 2:
            d_edge, d_pre, d_recproj, grads = _plain_v2_bwd(
                d_aggr.float(), None if d_new_edge is None else d_new_edge.float(),
                edge_in.float(), extra[0].float(), extra[1].float(), edge_set, weights,
                raw, update_edges, bf16_ops,
            )
        else:
            d_edge, d_pre, d_recproj, grads = fused_edge_v2_bwd(
                d_aggr.contiguous(),
                None if d_new_edge is None else d_new_edge.contiguous(),
                extra[0], edge_in, edge_set, weights, raw, bf16_ops,
            )
        d_sp = sender_scatter(d_pre.to(io), edge_set, num_send)  # K2, float32 sums
        d_edge = None if d_edge is None else d_edge.to(io)
        return (d_edge, d_sp.to(io), d_recproj.to(io), *grads, *(None,) * 6)


def _projection(x, w, bf16_ops, io):
    """A node projection ``x . w^T`` outside the kernel, as the JAX
    package's ``proj`` forms it (pallas_fused.py:2541-2560): the operands
    in float32, or rounded to bf16 with ``bf16_ops``, float32 sums, the
    result in the streams' dtype ``io``. The casts are autograd's, so its
    backward rounds the gradients of the bf16 operands to bf16 as JAX's
    transpose of the product does."""
    if bf16_ops:
        x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    return (x.float() @ w.float().T).to(io)


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
    ``(aggregated_sum (N_rec, B, D), new_edge (E, B, D) | None)`` in
    ``rec_rep``'s dtype. Under a reduced precision (:func:`fused_precision`)
    the projections take bf16 operands and the streams move in its dtype,
    through K7's and K8's bf16 instantiations, as in the JAX package's
    ``make_fused_interaction_v2`` (pallas_fused.py:2518-2525).
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
    bf16_ops, io = fused_precision(rec_rep.dtype)
    edge_in, weights = _kernel_inputs(edge_mlp, embedder, edge_rep, edge_feats, io)
    w1 = weights[0]
    d = w1.shape[0]
    sp = _projection(send_rep, w1[:, d : 2 * d], bf16_ops, io)  # once per sender row
    rp = _projection(rec_rep, w1[:, 2 * d :], bf16_ops, io)  # once per receiver row
    return FusedEdgePhaseV2.apply(  # pre only under grad, as in fused_edge_phase
        edge_in, sp, rp, *weights,
        edge_set, raw, update_edges, torch.is_grad_enabled(), bf16_ops, rec_rep.dtype,
    )


fused_edge_phase_v2.launches = 0
