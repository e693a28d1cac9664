"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where no GPU is present (decided in a
fixture, at run time). Run them on a machine with an H100 with
``python -m pytest -m cuda tests/test_torch_cuda.py``.

Parity is in float32 (TF32 off for matmuls and convolutions, so the plain
versions' products are exact float32; K3 and K4 compute theirs on the
tensor cores with the 3xTF32 split, at float32 accuracy, which
``test_fused_edge_phase_float32_accuracy`` holds). The tolerances cover
rounding and summation order only: the kernels sum the 64-term dot products and each
receiver's messages in another order than PyTorch's CPU and CUDA
matmuls and ``index_add_``; every value is O(1) after LayerNorm and the
aggregates sum O(10) of them, so 1e-4 absolute is far above the
rounding and far below any real error. The backward kernels' tolerances
are stated in their tests.
"""

import contextlib
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from neural_lam_tpu_torch.config import DatastoreSelection, NeuralLAMConfig
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.graphs import create_graph_from_datastore
from neural_lam_tpu_torch.models import ARForecaster, GraphLAM, HiLAM
from neural_lam_tpu_torch.ops.fused_kernels import (
    _weights,
    fused_edge_bwd,
    fused_edge_fwd,
    fused_edge_phase,
    fused_edge_phase_plain,
    fused_edge_phase_v2,
    fused_edge_phase_v2_plain,
    fused_edge_v2_bwd,
    fused_edge_v2_fwd,
)
from neural_lam_tpu_torch.ops import fused_kernels as fk
from neural_lam_tpu_torch.ops import segment_kernels as sk
from neural_lam_tpu_torch.ops.interaction import make_edge_set
from neural_lam_tpu_torch.ops.mlp import make_mlp
from neural_lam_tpu_torch.ops.interaction import (
    InteractionNet,
    apply_interaction_net,
)
from neural_lam_tpu_torch.ops.segment import (
    aggregate_sum,
    gather_receivers,
    gather_senders,
)
from neural_lam_tpu_torch.ops import launch_counters
from neural_lam_tpu_torch.trainer import GRAPH_WARMUP_STEPS, Trainer, TrainingArgs
from neural_lam_tpu_torch.ops.segment_kernels import (
    receiver_expand,
    receiver_expand_plain,
    segment_sum,
    segment_sum_plain,
    sender_gather,
    sender_gather_plain,
    sender_scatter,
    sender_scatter_plain,
)

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _edge_set(rng, n_send, n_rec, n_edges, device, empty_rec=0):
    """Random edges; the last ``empty_rec`` receivers get none."""
    snd = rng.integers(0, n_send, n_edges)
    rcv = rng.integers(0, n_rec - empty_rec, n_edges)
    es, perm = make_edge_set(snd, rcv, num_rec=n_rec, num_send=n_send)
    return es.to(device), perm


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 64), (3, 5)])
def test_sender_gather_matches_plain(cuda, shape):
    rng = np.random.default_rng(0)
    es, _ = _edge_set(rng, 300, 200, 5000, cuda)
    x = torch.tensor(rng.normal(size=(300,) + shape), dtype=torch.float32, device=cuda)
    before = sender_gather.launches
    out = sender_gather(x, es.senders)
    torch.cuda.synchronize()
    assert sender_gather.launches == before + 1
    # a copy: bit-identical
    torch.testing.assert_close(out, sender_gather_plain(x, es.senders), rtol=0, atol=0)


FLAGS = [
    # (edge mode, update_edges, propagation, layer_norm)
    ("raw", False, False, True),  # g2m / m2g
    ("raw", True, False, True),  # m2m layer 0
    ("batched", True, False, True),  # m2m layers 1-3
    ("shared", True, False, True),
    ("raw", False, True, True),  # PropagationNet
    ("batched", False, False, False),  # no LayerNorm
]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,update,prop,ln", FLAGS)
@pytest.mark.parametrize("batch", [4, 3, 1, 32])  # 16, 21, 64, 2 edges a tile
def test_fused_edge_phase_matches_plain(cuda, mode, update, prop, ln, batch):
    rng = np.random.default_rng(1)
    d, n_send, n_rec = 64, 70, 50
    es, _ = _edge_set(rng, n_send, n_rec, 900, cuda, empty_rec=5)
    gen = torch.Generator().manual_seed(0)
    edge_mlp = make_mlp([3 * d, d, d], layer_norm=ln, generator=gen).to(cuda)
    embedder = make_mlp([3, d, d], generator=gen).to(cuda)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32, device=cuda)

    send, rec = t(n_send, batch, d), t(n_rec, batch, d)
    x_send = sender_gather_plain(send, es.senders)
    kw = dict(update_edges=update, propagation=prop)
    edge_rep, feats, emb = None, None, None
    if mode == "raw":
        feats, emb = t(es.num_edges, 3), embedder
    elif mode == "shared":
        edge_rep = t(es.num_edges, d)
    else:
        edge_rep = t(es.num_edges, batch, d)
    with torch.no_grad():
        before = fused_edge_phase.launches
        got = fused_edge_phase(
            edge_mlp, edge_rep, x_send, rec, es, embedder=emb, edge_feats=feats, **kw
        )
        torch.cuda.synchronize()
        assert fused_edge_phase.launches == before + 1
        want = fused_edge_phase_plain(
            edge_mlp, edge_rep, x_send, rec, es.receivers, emb, feats, **kw
        )
    torch.testing.assert_close(got[0], want[0], **TOL)
    assert torch.all(got[0][-5:] == 0)  # receivers without edges
    if update:
        torch.testing.assert_close(got[1], want[1], **TOL)
    else:
        assert got[1] is None


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 64), (3, 5)])
def test_sender_scatter_matches_plain(cuda, shape):
    """K2 against ``index_add_``. Sender 7 has 400 slots, the last ten
    senders none, and the gather's input has more rows than the table."""
    rng = np.random.default_rng(3)
    snd = np.concatenate([rng.integers(0, 290, 4600), np.full(400, 7)])
    rcv = rng.integers(0, 200, 5000)
    es, _ = make_edge_set(snd, rcv, num_rec=200, num_send=300)
    es = es.to(cuda)
    g = torch.tensor(rng.normal(size=(5000,) + shape), dtype=torch.float32, device=cuda)
    before = sender_scatter.launches
    out = sender_scatter(g, es, 310)
    torch.cuda.synchronize()
    assert sender_scatter.launches == before + 1
    want = sender_scatter_plain(g, es.senders, 310)
    # f32 sums of up to 400 O(1) terms in another order than index_add_'s
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-4)
    assert torch.all(out[290:] == 0)
    again = sender_scatter(g, es, 310)
    assert torch.equal(out, again)  # fixed summation order


@pytest.mark.cuda
def test_gather_senders_backward_is_the_scatter(cuda):
    rng = np.random.default_rng(4)
    es, _ = _edge_set(rng, 30, 20, 200, cuda)
    x = torch.tensor(rng.normal(size=(30, 2, 64)), dtype=torch.float32,
                     device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="outside autograd"):
        sender_gather(x, es.senders)
    k1, k2 = sender_gather.launches, sender_scatter.launches
    out = gather_senders(es, x)
    w = torch.tensor(rng.normal(size=tuple(out.shape)), dtype=torch.float32, device=cuda)
    (out * w).sum().backward()
    assert (sender_gather.launches, sender_scatter.launches) == (k1 + 1, k2 + 1)
    torch.testing.assert_close(
        x.grad, sender_scatter_plain(w, es.senders, 30), rtol=1e-5, atol=1e-5
    )


BWD_FLAGS = FLAGS + [
    ("shared", False, False, True),
    ("batched", True, True, True),
    ("raw", True, False, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,update,prop,ln", BWD_FLAGS)
@pytest.mark.parametrize("batch,use_new_edge",
                         [(4, True), (4, False), (3, True), (1, True), (32, True)])
def test_fused_edge_phase_backward_matches_plain(cuda, mode, update, prop, ln, batch, use_new_edge):
    """K4 (through ``FusedEdgePhase``) against autograd of the plain
    version: every input and weight gradient. ``use_new_edge=False``
    leaves the updated edges out of the loss, so K4 gets no
    ``d_new_edge``."""
    rng = np.random.default_rng(5)
    d, n_send, n_rec = 64, 70, 50
    es, _ = _edge_set(rng, n_send, n_rec, 900, cuda, empty_rec=5)
    gen = torch.Generator().manual_seed(1)
    edge_mlp = make_mlp([3 * d, d, d], layer_norm=ln, generator=gen).to(cuda)
    embedder = make_mlp([3, d, d], generator=gen).to(cuda)

    def t(*shape, grad=False):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=cuda, requires_grad=grad)

    x_send, rec = t(es.num_edges, batch, d, grad=True), t(n_rec, batch, d, grad=True)
    edge_rep, feats, emb = None, None, None
    if mode == "raw":
        feats, emb = t(es.num_edges, 3), embedder
    elif mode == "shared":
        edge_rep = t(es.num_edges, d, grad=True)
    else:
        edge_rep = t(es.num_edges, batch, d, grad=True)
    w_aggr = t(n_rec, batch, d)
    w_edge = t(es.num_edges, batch, d)
    params = list(edge_mlp.parameters()) + (list(emb.parameters()) if emb else [])
    leaves = [x_send, rec] + ([edge_rep] if edge_rep is not None else []) + params

    def loss(out):
        total = (out[0] * w_aggr).sum()
        if update and use_new_edge:
            total = total + (out[1] * w_edge).sum()
        return total

    kw = dict(update_edges=update, propagation=prop)
    before = fused_edge_bwd.launches, fk.FUSED_EDGE_BWD_RECEIVER.launches
    got = torch.autograd.grad(
        loss(fused_edge_phase(edge_mlp, edge_rep, x_send, rec, es,
                              embedder=emb, edge_feats=feats, **kw)),
        leaves,
    )
    torch.cuda.synchronize()
    # K4 and the receiver slice that its entry launches
    assert (fused_edge_bwd.launches, fk.FUSED_EDGE_BWD_RECEIVER.launches) == (
        before[0] + 1, before[1] + 1)
    want = torch.autograd.grad(
        loss(fused_edge_phase_plain(edge_mlp, edge_rep, x_send, rec,
                                    es.receivers, emb, feats, **kw)),
        leaves,
    )
    # weight gradients sum 900 x batch O(1) terms: tolerance relative to
    # the largest entry of each gradient
    for g, w in zip(got, want):
        scale = max(w.abs().max().item(), 1.0)
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * scale)
    again = torch.autograd.grad(
        loss(fused_edge_phase(edge_mlp, edge_rep, x_send, rec, es,
                              embedder=emb, edge_feats=feats, **kw)),
        leaves,
    )
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # deterministic


@pytest.mark.cuda
def test_fused_edge_phase_saves_pre_only_under_grad(cuda):
    """The forecast path's K3 writes no ``pre``; under grad it does, and
    the outputs are the same bits."""
    rng = np.random.default_rng(6)
    d = 64
    es, _ = _edge_set(rng, 40, 30, 300, cuda)
    edge_mlp = make_mlp([3 * d, d, d], generator=torch.Generator().manual_seed(2)).to(cuda)
    x_send = torch.tensor(rng.normal(size=(300, 2, d)), dtype=torch.float32, device=cuda)
    rec = torch.tensor(rng.normal(size=(30, 2, d)), dtype=torch.float32, device=cuda)
    edge = torch.tensor(rng.normal(size=(300, 2, d)), dtype=torch.float32, device=cuda)
    with torch.no_grad():
        weights = _weights(edge_mlp, None)
        a0, e0, pre0 = fused_edge_fwd(edge, x_send, rec, es, weights, False, True, False)
        a1, e1, pre1 = fused_edge_fwd(edge, x_send, rec, es, weights, False, True,
                                      False, save_pre=True)
    assert pre0 is None and pre1.shape == x_send.shape
    assert torch.equal(a0, a1) and torch.equal(e0, e1)
    w1 = edge_mlp[0].weight
    want = (edge @ w1[:, :d].T + x_send @ w1[:, d:2 * d].T
            + (rec @ w1[:, 2 * d:].T)[es.receivers] + edge_mlp[0].bias)
    torch.testing.assert_close(pre1, want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("v2", [False, True])
def test_fused_edge_phase_writes_pre_only_when_differentiated(cuda, monkeypatch, v2):
    """Under ``no_grad`` and ``inference_mode`` (the forecast) K3 and K7
    write no ``pre``, though the edge MLP's parameters require grad; with
    grad on they do, and the outputs are the same bits."""
    from neural_lam_tpu_torch.ops import fused_kernels as fk

    rng = np.random.default_rng(14)
    d = 64
    es, _ = _edge_set(rng, 40, 30, 300, cuda)
    edge_mlp = make_mlp([3 * d, d, d], generator=torch.Generator().manual_seed(8)).to(cuda)
    send = torch.tensor(rng.normal(size=(300 if not v2 else 40, 2, d)),
                        dtype=torch.float32, device=cuda)
    rec = torch.tensor(rng.normal(size=(30, 2, d)), dtype=torch.float32, device=cuda)
    edge = torch.tensor(rng.normal(size=(300, 2, d)), dtype=torch.float32, device=cuda)
    name = "fused_edge_v2_fwd" if v2 else "fused_edge_fwd"
    launcher, saved = getattr(fk, name), []

    def spy(*args, save_pre=False, **kw):
        saved.append(save_pre)
        return launcher(*args, save_pre=save_pre, **kw)

    monkeypatch.setattr(fk, name, spy)
    phase = fk.fused_edge_phase_v2 if v2 else fk.fused_edge_phase
    outs = []
    for mode in (torch.no_grad, torch.inference_mode, torch.enable_grad):
        with mode():
            outs.append([o.detach().clone() for o in phase(edge_mlp, edge, send, rec, es,
                                                           update_edges=True)])
    assert saved == [False, False, True]
    for out in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], out))


def _degree_edge_set(kind, device):
    """Edge sets shaped like the MEPS and the hierarchical ones, small:
    ``mesh`` random degrees with a receiver of 400 edges and ten without
    any; ``down`` exactly one edge per receiver; ``up`` exactly nine;
    ``top`` 40 edges into 9 receivers; ``empty`` no edge at all."""
    rng = np.random.default_rng(7)
    if kind == "mesh":
        n_send, n_rec = 300, 200
        rcv = np.concatenate([rng.integers(0, 190, 4600), np.full(400, 7)])
    elif kind == "down":
        n_send, n_rec = 9, 81
        rcv = rng.permutation(81)
    elif kind == "up":
        n_send, n_rec = 81, 9
        rcv = np.repeat(np.arange(9), 9)
    elif kind == "top":
        n_send, n_rec = 9, 9
        rcv = rng.integers(0, 9, 40)
    else:
        n_send, n_rec = 5, 4
        rcv = np.zeros(0, np.int64)
    snd = rng.integers(0, n_send, rcv.size)
    es, _ = make_edge_set(snd, rcv, num_rec=n_rec, num_send=n_send)
    return es.to(device), n_send, n_rec


KINDS = ["mesh", "down", "up", "top", "empty"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(4, 64), (3, 5), (64,)])
def test_segment_sum_matches_plain(cuda, kind, shape):
    """K5 against ``index_add_``: f32 sums of up to 400 O(1) rows in slot
    order, so 1e-5 of the largest sum; the same bits on a second run; a
    row width that is not a multiple of 4 floats takes the scalar path."""
    es, _, n_rec = _degree_edge_set(kind, cuda)
    rng = np.random.default_rng(8)
    msg = torch.tensor(rng.normal(size=(es.num_edges,) + shape),
                       dtype=torch.float32, device=cuda)
    before = segment_sum.launches
    out = segment_sum(msg, es)
    torch.cuda.synchronize()
    assert segment_sum.launches == before + (kind != "empty")
    want = segment_sum_plain(msg, es.receivers, n_rec)
    scale = max(want.abs().max().item(), 1.0)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-5 * scale)
    assert torch.equal(out, segment_sum(msg, es))
    if kind == "mesh":
        assert torch.all(out[190:] == 0)  # receivers without edges
    if kind == "down":  # degree 1: a copy
        assert torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", [(4, 64), (3, 5), (64,)])
def test_receiver_expand_matches_plain(cuda, kind, shape):
    """K6 against ``index_select``: a copy, bit-identical."""
    es, _, n_rec = _degree_edge_set(kind, cuda)
    rng = np.random.default_rng(9)
    x = torch.tensor(rng.normal(size=(n_rec,) + shape), dtype=torch.float32, device=cuda)
    before = receiver_expand.launches
    out = receiver_expand(x, es)
    torch.cuda.synchronize()
    assert receiver_expand.launches == before + (kind != "empty")
    assert out.shape == (es.num_edges,) + shape
    assert torch.equal(out, receiver_expand_plain(x, es.receivers))


@pytest.mark.cuda
def test_receiver_gather_and_segment_sum_are_each_others_backward(cuda):
    es, _, n_rec = _degree_edge_set("mesh", cuda)
    rng = np.random.default_rng(10)

    def t(*shape, grad=False):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=cuda, requires_grad=grad)

    x, msg = t(n_rec, 2, 64, grad=True), t(es.num_edges, 2, 64, grad=True)
    w_e, w_n = t(es.num_edges, 2, 64), t(n_rec, 2, 64)
    with pytest.raises(RuntimeError, match="outside autograd"):
        receiver_expand(x, es)
    with pytest.raises(RuntimeError, match="outside autograd"):
        segment_sum(msg, es)
    k5, k6 = segment_sum.launches, receiver_expand.launches
    (gather_receivers(es, x) * w_e).sum().backward()
    assert (segment_sum.launches, receiver_expand.launches) == (k5 + 1, k6 + 1)
    assert torch.equal(x.grad, segment_sum(w_e, es))
    (aggregate_sum(es, msg) * w_n).sum().backward()
    assert (segment_sum.launches, receiver_expand.launches) == (k5 + 3, k6 + 2)
    assert torch.equal(msg.grad, receiver_expand_plain(w_n, es.receivers))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["down", "up", "top"])
@pytest.mark.parametrize("mode,update,prop", [
    ("shared", True, False), ("shared", True, True),
    ("batched", True, True), ("batched", False, False),
])
def test_fused_edge_phase_on_tiny_sets(cuda, kind, mode, update, prop):
    """K3 and K4 on sets smaller than one block's share of receivers and
    than the number of SMs, in the hierarchical models' modes: outputs
    and every gradient against the plain version."""
    es, n_send, n_rec = _degree_edge_set(kind, cuda)
    rng = np.random.default_rng(11)
    d, batch = 64, 4
    edge_mlp = make_mlp([3 * d, d, d], generator=torch.Generator().manual_seed(3)).to(cuda)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=cuda, requires_grad=True)

    x_send, rec = t(es.num_edges, batch, d), t(n_rec, batch, d)
    edge = t(es.num_edges, d) if mode == "shared" else t(es.num_edges, batch, d)
    w_aggr, w_edge = t(n_rec, batch, d).detach(), t(es.num_edges, batch, d).detach()
    leaves = [x_send, rec, edge] + list(edge_mlp.parameters())
    kw = dict(update_edges=update, propagation=prop)

    def loss(out):
        total = (out[0] * w_aggr).sum()
        return total + (out[1] * w_edge).sum() if update else total

    got = fused_edge_phase(edge_mlp, edge, x_send, rec, es, **kw)
    want = fused_edge_phase_plain(edge_mlp, edge, x_send, rec, es.receivers, **kw)
    torch.testing.assert_close(got[0], want[0], **TOL)
    if update:
        torch.testing.assert_close(got[1], want[1], **TOL)
    for g, w in zip(torch.autograd.grad(loss(got), leaves),
                    torch.autograd.grad(loss(want), leaves)):
        scale = max(w.abs().max().item(), 1.0)
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mesh", "down"])
@pytest.mark.parametrize("mode", ["raw", "shared", "batched"])
@pytest.mark.parametrize("batch", [4, 32])
def test_fused_edge_phase_long_receivers_and_degree_one(cuda, kind, mode, batch):
    """K3 and K4 where a receiver's edges span many tiles (400 edges into
    one receiver, ten receivers without edges) and where every receiver
    has exactly one edge, in each edge mode: outputs and every gradient
    against the plain version, and the same bits on a second run."""
    es, n_send, n_rec = _degree_edge_set(kind, cuda)
    rng = np.random.default_rng(13)
    d = 64
    gen = torch.Generator().manual_seed(7)
    edge_mlp = make_mlp([3 * d, d, d], generator=gen).to(cuda)
    emb = make_mlp([3, d, d], generator=gen).to(cuda) if mode == "raw" else None

    def t(*shape, grad=True):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=cuda, requires_grad=grad)

    x_send, rec = t(es.num_edges, batch, d), t(n_rec, batch, d)
    edge_rep = feats = None
    if mode == "raw":
        feats = t(es.num_edges, 3, grad=False)
    else:
        edge_rep = t(es.num_edges, d) if mode == "shared" else t(es.num_edges, batch, d)
    leaves = [x_send, rec] + ([edge_rep] if edge_rep is not None else [])
    leaves += list(edge_mlp.parameters()) + (list(emb.parameters()) if emb else [])
    w_aggr, w_edge = t(n_rec, batch, d, grad=False), t(es.num_edges, batch, d, grad=False)
    kw = dict(embedder=emb, edge_feats=feats, update_edges=True)

    def run(fn, *index):
        out = fn(edge_mlp, edge_rep, x_send, rec, *index, **kw)
        loss = (out[0] * w_aggr).sum() + (out[1] * w_edge).sum()
        return [o.detach() for o in out], torch.autograd.grad(loss, leaves)

    got, got_g = run(fused_edge_phase, es)
    want, want_g = run(fused_edge_phase_plain, es.receivers)
    # a receiver's sum of 400 O(1) messages is off float64 by about 3e-4 in
    # any float32 order (the plain version's own, too): 1e-4 of the largest
    # aggregate; the updated edges as in the other tests
    scale = max(want[0].abs().max().item(), 1.0)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-4 * scale)
    torch.testing.assert_close(got[1], want[1], **TOL)
    if kind == "mesh":
        assert torch.all(got[0][190:] == 0)  # receivers without edges
    for g, w in zip(got_g, want_g):
        scale = max(w.abs().max().item(), 1.0)
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * scale)
    again, again_g = run(fused_edge_phase, es)
    assert all(torch.equal(a, b) for a, b in zip(got + list(got_g), again + list(again_g)))


def _near_one(rng, shape, scale=1.0):
    """``scale * (1 + k 2^-18)`` with integer ``k < 128``: exact in
    float32, but TF32's 10-bit mantissa rounds every value down to
    ``scale``, so a product on TF32 operands alone misses by about 2^-11
    relative, always in the same direction."""
    return scale * (1.0 + rng.integers(0, 128, size=shape) * 2.0**-18)


def _tf32(t):
    """Round float32 values to TF32 (10 mantissa bits, to nearest)."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.cuda
def test_fused_edge_phase_float32_accuracy(cuda):
    """K3 and K4, and K7 and K8, run their products on the tensor cores
    with the 3xTF32 split, at float32 accuracy: on operands that need 18
    mantissa bits (where plain TF32, checked here on the same inputs,
    misses the first layer by more than 1e-4 relative), ``pre``, the
    aggregate and every gradient agree with the plain version in float64
    to 1e-5 of their largest entry."""
    rng = np.random.default_rng(31)
    d, batch = 64, 4
    es, _ = _edge_set(rng, 40, 30, 600, cuda, empty_rec=3)
    n_e, n_rec = es.num_edges, es.num_rec
    mlp64 = make_mlp([3 * d, d, d], layer_norm=False).double()
    with torch.no_grad():
        mlp64[0].weight.copy_(torch.tensor(_near_one(rng, (d, 3 * d), 2.0**-6)))
        mlp64[2].weight.copy_(torch.tensor(_near_one(rng, (d, d), 2.0**-8)))
        mlp64[0].bias.zero_()
        mlp64[2].bias.zero_()
    edge_mlp = make_mlp([3 * d, d, d], layer_norm=False)
    edge_mlp.load_state_dict(mlp64.state_dict())
    edge_mlp = edge_mlp.float().to(cuda)  # exact: every value fits in float32
    arrays = [_near_one(rng, s) for s in ((n_e, batch, d), (n_e, batch, d), (n_rec, batch, d))]
    d_aggr64 = torch.tensor(_near_one(rng, (n_rec, batch, d)))

    def rel(got, want):
        got, want = got.detach().double().cpu(), want.detach()
        return ((got - want).abs().max() / want.abs().max()).item()

    # the float64 reference (edge, sender and receiver rows in that order)
    ref = [torch.tensor(a, requires_grad=True) for a in arrays]
    receivers = es.receivers.cpu()
    w1 = mlp64[0].weight
    pre64 = (ref[0] @ w1[:, :d].T + ref[1] @ w1[:, d:2 * d].T
             + (ref[2] @ w1[:, 2 * d:].T)[receivers])
    aggr64, _ = fused_edge_phase_plain(mlp64, ref[0], ref[1], ref[2], receivers)
    want = torch.autograd.grad((aggr64 * d_aggr64).sum(), ref + list(mlp64.parameters()))
    # what TF32 operands alone give for the first layer
    t32 = [_tf32(torch.tensor(a, dtype=torch.float32)).double() for a in arrays]
    w32 = _tf32(w1.detach().float()).double()
    pre_tf32 = (t32[0] @ w32[:, :d].T + t32[1] @ w32[:, d:2 * d].T
                + (t32[2] @ w32[:, 2 * d:].T)[receivers])
    assert rel(pre_tf32, pre64) > 1e-4

    leaves = [torch.tensor(a, dtype=torch.float32, device=cuda, requires_grad=True)
              for a in arrays]
    with torch.no_grad():
        aggr, _, pre = fused_edge_fwd(leaves[0], leaves[1], leaves[2], es,
                                      _weights(edge_mlp, None), False, False, False,
                                      save_pre=True)
    assert rel(pre, pre64) < 1e-5
    assert rel(aggr, aggr64) < 1e-5
    out = fused_edge_phase(edge_mlp, leaves[0], leaves[1], leaves[2], es)[0]
    got = torch.autograd.grad((out * d_aggr64.float().to(cuda)).sum(),
                              leaves + list(edge_mlp.parameters()))
    for g, w in zip(got, want):
        assert rel(g, w) < 1e-5

    # K7 and K8 (the v2 route) on the same kind of operands, with sender
    # node rows: K7's tensor-core product is the first layer's edge term,
    # which TF32 operands alone miss by more than 1e-4; the node
    # projections are float32 matmuls (TF32 off)
    assert rel(t32[0] @ w32[:, :d].T, ref[0] @ w1[:, :d].T) > 1e-4
    arrays2 = [arrays[0], _near_one(rng, (40, batch, d)), arrays[2]]
    ref2 = [torch.tensor(a, requires_grad=True) for a in arrays2]
    senders = es.senders.cpu().long()
    sp64, rp64 = ref2[1] @ w1[:, d:2 * d].T, ref2[2] @ w1[:, 2 * d:].T
    pre64 = ref2[0] @ w1[:, :d].T + sp64[senders] + rp64[receivers]
    aggr64, _ = fused_edge_phase_v2_plain(mlp64, ref2[0], sp64, rp64, senders, receivers)
    want = torch.autograd.grad((aggr64 * d_aggr64).sum(), ref2 + list(mlp64.parameters()))
    leaves = [torch.tensor(a, dtype=torch.float32, device=cuda, requires_grad=True)
              for a in arrays2]
    with torch.no_grad():
        w1f = edge_mlp[0].weight
        aggr, _, pre = fused_edge_v2_fwd(
            leaves[0], leaves[1] @ w1f[:, d:2 * d].T, leaves[2] @ w1f[:, 2 * d:].T, es,
            _weights(edge_mlp, None), False, False, save_pre=True,
        )
    assert rel(pre, pre64) < 1e-5
    assert rel(aggr, aggr64) < 1e-5
    out = fused_edge_phase_v2(edge_mlp, leaves[0], leaves[1], leaves[2], es)[0]
    got = torch.autograd.grad((out * d_aggr64.float().to(cuda)).sum(),
                              leaves + list(edge_mlp.parameters()))
    for g, w in zip(got, want):
        assert rel(g, w) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("hidden_layers,chunks", [(2, 1), (0, 1), (2, 3)])
def test_unfused_interaction_net_on_the_card_matches_the_cpu(cuda, hidden_layers, chunks):
    """``apply_interaction_net`` on the unfused route (K1, K6, the MLP,
    K5; K2, K5, K6 backward) on the card against the same call on the
    CPU, where the plain versions run: outputs and every gradient."""
    es, n_send, n_rec = _degree_edge_set("mesh", "cpu")
    rng = np.random.default_rng(12)
    d, batch = 64, 4
    net = InteractionNet(
        d, hidden_layers=hidden_layers, num_edge_chunks=chunks,
        generator=torch.Generator().manual_seed(4),
    )
    sizes = dict(edge_chunk_sizes=[1000, 3000, 1000]) if chunks > 1 else {}
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((n_send, batch, d), (n_rec, batch, d), (es.num_edges, d))]
    w = rng.normal(size=(n_rec, batch, d)).astype(np.float32)

    def run(device):
        net.to(device).zero_grad(set_to_none=True)
        leaves = [torch.tensor(a, device=device, requires_grad=True) for a in arrays]
        new_rec, new_edge = apply_interaction_net(
            net, es.to(device), *leaves, aggr="mean", **sizes
        )
        ((new_rec * torch.tensor(w, device=device)).sum() + new_edge.sum()).backward()
        grads = [leaf.grad for leaf in leaves] + [p.grad for p in net.parameters()]
        return [a.detach().cpu() for a in (new_rec, new_edge, *grads)]

    counters = (sender_gather, sender_scatter, segment_sum, receiver_expand)
    before = [fn.launches for fn in counters]
    got = run(cuda)
    assert [fn.launches - b for fn, b in zip(counters, before)] == [1, 1, 2, 2]
    want = run("cpu")
    for g, w_ in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w_, **TOL)
    for g, w_ in zip(got[2:], want[2:]):
        scale = max(w_.abs().max().item(), 1.0)
        torch.testing.assert_close(g, w_, rtol=0, atol=1e-4 * scale)


# -- K7 and K8, the v2 route -------------------------------------------------------

V2_FLAGS = [
    # (edge mode, update_edges, layer_norm)
    ("raw", False, True),  # g2m / m2g
    ("raw", True, True),  # m2m layer 0
    ("batched", True, True),  # m2m layers 1-3
    ("shared", True, True),  # HiLAMParallel's sections
    ("batched", False, False),  # no LayerNorm
    ("raw", False, False),
]


def _v2_case(rng, cuda, es, n_send, n_rec, mode, batch, ln=True, d=64, seed=0):
    """Node rows, edge input and MLPs of one v2 call, as leaves."""
    gen = torch.Generator().manual_seed(seed)
    edge_mlp = make_mlp([3 * d, d, d], layer_norm=ln, generator=gen).to(cuda)
    embedder = make_mlp([3, d, d], generator=gen).to(cuda)

    def t(*shape, grad=True):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=cuda, requires_grad=grad)

    send, rec = t(n_send, batch, d), t(n_rec, batch, d)
    edge_rep, feats, emb = None, None, None
    if mode == "raw":
        feats, emb = t(es.num_edges, 3, grad=False), embedder
    elif mode == "shared":
        edge_rep = t(es.num_edges, d)
    else:
        edge_rep = t(es.num_edges, batch, d)
    leaves = [send, rec] + ([edge_rep] if edge_rep is not None else [])
    leaves += list(edge_mlp.parameters()) + (list(emb.parameters()) if emb else [])
    w_aggr, w_edge = t(n_rec, batch, d, grad=False), t(es.num_edges, batch, d, grad=False)
    return edge_mlp, emb, send, rec, edge_rep, feats, leaves, w_aggr, w_edge


def _v2_plain(edge_mlp, edge_rep, send, rec, es, emb, feats, update):
    """The plain reference: the same node projections, then K7's plain
    version (autograd through both is K8's and K2's)."""
    w1 = edge_mlp[0].weight
    d = w1.shape[0]
    return fused_edge_phase_v2_plain(
        edge_mlp, edge_rep, send @ w1[:, d : 2 * d].T, rec @ w1[:, 2 * d :].T,
        es.senders, es.receivers, emb, feats, update,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("mode,update,ln", V2_FLAGS)
@pytest.mark.parametrize("batch", [4, 3, 1, 32])  # 16, 21, 64, 2 edges a tile
def test_fused_edge_phase_v2_matches_plain(cuda, mode, update, ln, batch):
    """K7 against its plain version: the aggregate (zero for receivers
    without edges), the updated edges and the saved ``pre``."""
    rng = np.random.default_rng(21)
    n_send, n_rec = 70, 50
    es, _ = _edge_set(rng, n_send, n_rec, 900, cuda, empty_rec=5)
    edge_mlp, emb, send, rec, edge_rep, feats, _, _, _ = _v2_case(
        rng, cuda, es, n_send, n_rec, mode, batch, ln
    )
    with torch.no_grad():
        before = fused_edge_phase_v2.launches
        got = fused_edge_phase_v2(edge_mlp, edge_rep, send, rec, es, embedder=emb,
                                  edge_feats=feats, update_edges=update)
        torch.cuda.synchronize()
        assert fused_edge_phase_v2.launches == before + 1
        want = _v2_plain(edge_mlp, edge_rep, send, rec, es, emb, feats, update)
        w1, d = edge_mlp[0].weight, 64
        sp, rp = send @ w1[:, d : 2 * d].T, rec @ w1[:, 2 * d :].T
        edge_in = feats if mode == "raw" else edge_rep
        wts = _weights(edge_mlp, emb)
        _, _, pre = fused_edge_v2_fwd(edge_in, sp, rp, es, wts, mode == "raw", update,
                                      save_pre=True)
    torch.testing.assert_close(got[0], want[0], **TOL)
    assert torch.all(got[0][-5:] == 0)  # receivers without edges
    if update:
        torch.testing.assert_close(got[1], want[1], **TOL)
    else:
        assert got[1] is None
    emb_rep = edge_rep if mode != "raw" else emb(feats)
    proj = emb_rep @ w1[:, :d].T
    proj = proj.unsqueeze(1) if proj.dim() == 2 else proj
    want_pre = proj + sp[es.senders.long()] + rp[es.receivers] + edge_mlp[0].bias
    torch.testing.assert_close(pre, want_pre.detach(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,update,ln", V2_FLAGS)
@pytest.mark.parametrize("batch,use_new_edge",
                         [(4, True), (4, False), (3, True), (1, True), (32, True)])
def test_fused_edge_phase_v2_backward_matches_plain(cuda, mode, update, ln, batch, use_new_edge):
    """K8 and K2 (through ``FusedEdgePhaseV2`` and the node projections)
    against autograd of the plain version: the node rows', the edge
    input's and every weight's gradient. ``use_new_edge=False`` is the
    last m2m layer: K8 gets no ``d_new_edge``. A sender without edges
    gets a zero gradient row; a second run gives the same bits."""
    rng = np.random.default_rng(22)
    n_send, n_rec = 70, 50
    snd = rng.integers(0, n_send - 1, 900)  # sender n_send - 1 sends nothing
    rcv = rng.integers(0, n_rec - 5, 900)
    es, _ = make_edge_set(snd, rcv, num_rec=n_rec, num_send=n_send)
    es = es.to(cuda)
    edge_mlp, emb, send, rec, edge_rep, feats, leaves, w_aggr, w_edge = _v2_case(
        rng, cuda, es, n_send, n_rec, mode, batch, ln, seed=1
    )

    def loss(out):
        total = (out[0] * w_aggr).sum()
        if update and use_new_edge:
            total = total + (out[1] * w_edge).sum()
        return total

    def run():
        out = fused_edge_phase_v2(edge_mlp, edge_rep, send, rec, es, embedder=emb,
                                  edge_feats=feats, update_edges=update)
        return torch.autograd.grad(loss(out), leaves)

    before = (fused_edge_v2_bwd.launches, sender_scatter.launches, sender_gather.launches)
    got = run()
    torch.cuda.synchronize()
    after = (fused_edge_v2_bwd.launches, sender_scatter.launches, sender_gather.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 0]
    want = torch.autograd.grad(
        loss(_v2_plain(edge_mlp, edge_rep, send, rec, es, emb, feats, update)), leaves
    )
    for g, w in zip(got, want):
        scale = max(w.abs().max().item(), 1.0)
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * scale)
    assert torch.all(got[0][n_send - 1] == 0)
    assert all(torch.equal(a, b) for a, b in zip(got, run()))  # deterministic


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["down", "up", "top", "empty"])
@pytest.mark.parametrize("mode,update", [("shared", True), ("batched", True), ("batched", False)])
def test_fused_edge_phase_v2_on_tiny_sets(cuda, kind, mode, update):
    """K7 and K8 on sets smaller than one block's share of receivers and
    than the number of SMs, of degree exactly 1 and 9, and without edges:
    outputs and every gradient against the plain version."""
    es, n_send, n_rec = _degree_edge_set(kind, cuda)
    rng = np.random.default_rng(23)
    edge_mlp, emb, send, rec, edge_rep, feats, leaves, w_aggr, w_edge = _v2_case(
        rng, cuda, es, n_send, n_rec, mode, 4, seed=3
    )

    def loss(out):
        total = (out[0] * w_aggr).sum()
        return total + (out[1] * w_edge).sum() if update else total

    got = fused_edge_phase_v2(edge_mlp, edge_rep, send, rec, es, update_edges=update)
    want = _v2_plain(edge_mlp, edge_rep, send, rec, es, None, None, update)
    torch.testing.assert_close(got[0], want[0], **TOL)
    if update:
        torch.testing.assert_close(got[1], want[1], **TOL)
    for g, w in zip(torch.autograd.grad(loss(got), leaves, allow_unused=True),
                    torch.autograd.grad(loss(want), leaves, allow_unused=True)):
        if w is None:  # no edge: the edge MLP's first layers get no gradient
            assert g is None or not torch.any(g)
            continue
        scale = max(w.abs().max().item(), 1.0) if w.numel() else 1.0
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("embed,update", [(True, False), (True, True), (False, True)])
def test_v2_route_matches_v1_route(cuda, monkeypatch, embed, update):
    """``apply_interaction_net`` on the card with ``NEURAL_LAM_TPU_FUSED_V2``
    on (K7; K8 and K2 backward) and off (K1 and K3; K4 and K2 backward):
    the same outputs and gradients to rounding, and each route's
    launches."""
    es, n_send, n_rec = _degree_edge_set("mesh", cuda)
    rng = np.random.default_rng(24)
    d, batch = 64, 4
    net = InteractionNet(d, generator=torch.Generator().manual_seed(5)).to(cuda)
    emb = make_mlp([3, d, d], generator=torch.Generator().manual_seed(6)).to(cuda)
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((n_send, batch, d), (n_rec, batch, d), (es.num_edges, batch, d))]
    feats = torch.tensor(rng.normal(size=(es.num_edges, 3)), dtype=torch.float32, device=cuda)
    counters = (fused_edge_phase_v2, fused_edge_v2_bwd, sender_gather, fused_edge_phase,
                fused_edge_bwd, sender_scatter)

    def run(route):
        monkeypatch.setenv("NEURAL_LAM_TPU_FUSED_V2", route)
        net.zero_grad(set_to_none=True)
        emb.zero_grad(set_to_none=True)
        leaves = [torch.tensor(a, device=cuda, requires_grad=True) for a in arrays]
        kw = dict(update_edges=update)
        if embed:
            kw.update(edge_embedder=emb, edge_features=feats)
            leaves[2] = None
        before = [fn.launches for fn in counters]
        out = apply_interaction_net(net, es, leaves[0], leaves[1], leaves[2], **kw)
        outs = out if update else (out,)
        sum((o * o).sum() for o in outs).backward()
        launches = [fn.launches - b for fn, b in zip(counters, before)]
        params = list(net.parameters()) + (list(emb.parameters()) if embed else [])
        grads = [x.grad for x in leaves if x is not None] + [p.grad for p in params]
        return [o.detach() for o in outs], grads, launches

    out2, grads2, launches2 = run("on")
    out1, grads1, launches1 = run("off")
    assert launches2 == [1, 1, 0, 0, 0, 1]
    assert launches1 == [0, 0, 1, 1, 1, 1]
    for a, b in zip(out2, out1):
        torch.testing.assert_close(a, b, **TOL)
    for g, w in zip(grads2, grads1):
        scale = max(w.abs().max().item(), 1.0)
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mesh", "down"])
@pytest.mark.parametrize("mode", ["raw", "shared", "batched"])
@pytest.mark.parametrize("batch", [4, 32])
def test_fused_edge_phase_v2_long_receivers_and_degree_one(cuda, kind, mode, batch):
    """K7 and K8 (with K2) where a receiver's edges span many tiles (400
    edges into one receiver, ten receivers without edges) and where every
    receiver has exactly one edge, in each edge mode: outputs and every
    gradient against the plain version, and the same bits on a second
    run. The aggregate is held to 1e-4 of the largest aggregate, as K3's
    is: a receiver's sum of 400 O(1) messages is off float64 by about
    3e-4 in any float32 order, the plain version's own too."""
    es, n_send, n_rec = _degree_edge_set(kind, cuda)
    rng = np.random.default_rng(14)
    edge_mlp, emb, send, rec, edge_rep, feats, leaves, w_aggr, w_edge = _v2_case(
        rng, cuda, es, n_send, n_rec, mode, batch, seed=8
    )

    def run(v2):
        if v2:
            out = fused_edge_phase_v2(edge_mlp, edge_rep, send, rec, es, embedder=emb,
                                      edge_feats=feats, update_edges=True)
        else:
            out = _v2_plain(edge_mlp, edge_rep, send, rec, es, emb, feats, True)
        loss = (out[0] * w_aggr).sum() + (out[1] * w_edge).sum()
        return [o.detach() for o in out], torch.autograd.grad(loss, leaves)

    got, got_g = run(True)
    want, want_g = run(False)
    scale = max(want[0].abs().max().item(), 1.0)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-4 * scale)
    torch.testing.assert_close(got[1], want[1], **TOL)
    if kind == "mesh":
        assert torch.all(got[0][190:] == 0)  # receivers without edges
    for g, w in zip(got_g, want_g):
        scale = max(w.abs().max().item(), 1.0)
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * scale)
    again, again_g = run(True)
    assert all(torch.equal(a, b) for a, b in zip(got + list(got_g), again + list(again_g)))


# -- shapes the fused kernels do not take: the unfused route on the card ----------

_UNFUSED = (sender_gather, receiver_expand, segment_sum)
_FUSED = (fused_edge_phase, fused_edge_phase_v2)


def _launches(counters, before):
    return [fn.launches - b for fn, b in zip(counters, before)]


@pytest.mark.cuda
def test_graph_lam_hidden_32_on_the_card_matches_the_cpu(cuda, tmp_path):
    """``GraphLAM(hidden_dim=32)``: the fused kernels are built for hidden
    64, so every GNN application of the step routes to the unfused
    operations before any launch (K1, K6, the MLP, K5; K2, K5, K6
    backward) and computes what the CPU computes: the new state and the
    gradient of the previous state and of every parameter, at the
    unfused card tests' tolerances."""
    ds = DummyDatastore(root_path=tmp_path, n_grid_x=9, n_grid_y=9, n_timesteps=12)
    create_graph_from_datastore(ds, tmp_path / "graph" / "multiscale")
    torch.manual_seed(0)
    models = {"cpu": GraphLAM(ds, hidden_dim=32, processor_layers=2, device="cpu")}
    models["cuda"] = GraphLAM(ds, hidden_dim=32, processor_layers=2, device=cuda)
    models["cuda"].load_state_dict(models["cpu"].state_dict())
    rng = np.random.default_rng(41)
    n, batch = ds.num_grid_points, 4
    d, f = ds.get_num_data_vars("state"), 3 * ds.get_num_data_vars("forcing")
    arrays = [rng.normal(size=(n, batch, w)).astype(np.float32) for w in (d, d, f, d)]

    def run(device):
        model = models[device]
        model.zero_grad(set_to_none=True)
        prev = torch.tensor(arrays[0], device=device, requires_grad=True)
        out, _ = model.step(prev, *(torch.tensor(a, device=device) for a in arrays[1:3]))
        (out * torch.tensor(arrays[3], device=device)).sum().backward()
        grads = [prev.grad] + [p.grad for p in model.parameters()]
        return out.detach().cpu(), [g.cpu() for g in grads]

    before = [fn.launches for fn in _UNFUSED + _FUSED]
    got = run("cuda")
    torch.cuda.synchronize()
    launches = _launches(_UNFUSED + _FUSED, before)
    assert all(x > 0 for x in launches[:3]) and launches[3:] == [0, 0]
    want = run("cpu")
    torch.testing.assert_close(got[0], want[0], **TOL)
    for g, w in zip(got[1], want[1]):
        scale = max(w.abs().max().item(), 1.0)
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("embed", [False, True])
def test_interaction_net_batch_33_on_the_card_matches_the_cpu(cuda, embed):
    """``apply_interaction_net`` at batch 33, beyond the fused kernels'
    32: on the card it takes the unfused route (with the edge embedder
    run up front) where the CPU takes the fused one (its plain version),
    and both compute the same outputs and gradients."""
    es, n_send, n_rec = _degree_edge_set("mesh", "cpu")
    rng = np.random.default_rng(42)
    d, batch = 64, 33
    net = InteractionNet(d, generator=torch.Generator().manual_seed(9))
    emb = make_mlp([3, d, d], generator=torch.Generator().manual_seed(10))
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((n_send, batch, d), (n_rec, batch, d), (es.num_edges, d),
                        (es.num_edges, 3), (n_rec, batch, d))]

    def run(device):
        net.to(device).zero_grad(set_to_none=True)
        emb.to(device).zero_grad(set_to_none=True)
        t = [torch.tensor(a, device=device) for a in arrays]
        leaves = [t[0].requires_grad_(True), t[1].requires_grad_(True)]
        if embed:
            kw = dict(edge_embedder=emb, edge_features=t[3])
            edge = None
        else:
            edge = t[2].requires_grad_(True)
            leaves.append(edge)
            kw = {}
        new_rec, new_edge = apply_interaction_net(net, es.to(device), leaves[0], leaves[1],
                                                  edge, **kw)
        ((new_rec * t[4]).sum() + new_edge.sum()).backward()
        params = list(net.parameters()) + (list(emb.parameters()) if embed else [])
        grads = [x.grad for x in leaves] + [p.grad for p in params]
        return [a.detach().cpu() for a in (new_rec, new_edge, *grads)]

    before = [fn.launches for fn in _UNFUSED + _FUSED]
    got = run(cuda)
    torch.cuda.synchronize()
    assert _launches(_UNFUSED + _FUSED, before) == [1, 2, 2, 0, 0]
    want = run("cpu")
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, **TOL)
    for g, w in zip(got[2:], want[2:]):
        scale = max(w.abs().max().item(), 1.0)
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * scale)


# -- the training step as one CUDA graph ------------------------------------------

TRAIN_MODELS = {
    # name -> (class, graph, model kwargs, NEURAL_LAM_TPU_FUSED_V2)
    "graph_lam": (GraphLAM, "multiscale", {}, "off"),
    "graph_lam_v2": (GraphLAM, "multiscale", {}, "on"),
    "graph_lam_h2": (GraphLAM, "multiscale", dict(hidden_layers=2), "off"),
    "hi_lam": (HiLAM, "hierarchical", {}, "off"),
}


def _train_setup(tmp_path, cuda, name, monkeypatch):
    """A factory of trainers on the card, each around a new model that
    holds the same seeded weights, and batches of 2 drawn from a numpy
    seed. HiLAM needs a 27x27 grid for two mesh levels."""
    cls, graph, kw, v2 = TRAIN_MODELS[name]
    monkeypatch.setenv("NEURAL_LAM_TPU_FUSED_V2", v2)
    side = 27 if graph == "hierarchical" else 9
    ds = DummyDatastore(root_path=tmp_path, n_grid_x=side, n_grid_y=side, n_timesteps=12)
    create_graph_from_datastore(
        ds, tmp_path / "graph" / graph, hierarchical=graph == "hierarchical"
    )
    torch.manual_seed(0)
    model_kw = dict(hidden_dim=64, processor_layers=2, graph_name=graph, **kw)
    weights = cls(ds, device="cpu", **model_kw).state_dict()
    config = NeuralLAMConfig(datastore=DatastoreSelection(kind="dummydata", config_path=""))

    def make_trainer():
        model = cls(ds, device=cuda, **model_kw)
        model.load_state_dict(weights)
        return Trainer(ARForecaster(model, ds), config, ds, TrainingArgs(batch_size=2),
                       device=cuda)

    def batches(count, batch=2, steps=1, seed=7):
        rng = np.random.default_rng(seed)
        n, d = ds.num_grid_points, ds.get_num_data_vars("state")
        f = 3 * ds.get_num_data_vars("forcing")
        return [
            tuple(rng.normal(size=s).astype(np.float32)
                  for s in ((batch, 2, n, d), (batch, steps, n, d), (batch, steps, n, f)))
            for _ in range(count)
        ]

    return make_trainer, batches


def _assert_same_training(got, want, losses_got, losses_want):
    """Losses within 1e-6 relative, each parameter within 1e-5 of its
    largest entry; returns whether every bit matched."""
    np.testing.assert_allclose(losses_got, losses_want, rtol=1e-6)
    same = list(losses_got) == list(losses_want)
    for (name, p), q in zip(got.forecaster.named_parameters(), want.forecaster.parameters()):
        scale = max(q.abs().max().item(), 1e-30)
        assert (p - q).abs().max().item() <= 1e-5 * scale, name
        same = same and torch.equal(p, q)
    return same


def _ticks(calls) -> dict[str, int]:
    """Each wrapper's launch count across ``calls()``."""
    counters = launch_counters()
    before = {name: fn.launches for name, fn in counters.items()}
    calls()
    return {name: fn.launches - before[name] for name, fn in counters.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TRAIN_MODELS))
def test_captured_step_matches_the_eager_step(cuda, tmp_path, monkeypatch, name):
    """Five steps through the captured graph against five eager
    ``train_step`` calls from the same weights on the same batches; the
    graph is captured once, by the first call, whose warm-up steps and
    capture launch the route's kernels, and replayed five times, which
    calls no wrapper."""
    make_trainer, batches = _train_setup(tmp_path, cuda, name, monkeypatch)
    data = batches(5)
    eager, captured = make_trainer(), make_trainer()
    want = [eager.train_step(*b).item() for b in data]
    step = captured.make_train_step()
    got = []
    first = _ticks(lambda: got.append(step(*data[0]).item()))
    later = _ticks(lambda: got.extend(step(*b).item() for b in data[1:]))
    bits = _assert_same_training(captured, eager, got, want)
    print(f"{name}: captured step against eager over 5 steps, bits "
          f"{'matched' if bits else 'differ'}")
    assert len(captured.graphs) == 1 and not any(later.values())
    assert all(v % (GRAPH_WARMUP_STEPS + 1) == 0 for v in first.values())
    fused = TRAIN_MODELS[name][2].get("hidden_layers", 1) == 1
    v2 = fused and TRAIN_MODELS[name][3] == "on"
    ran = {k.split()[0] for k, v in first.items() if v}
    want_ran = {"K7", "K8", "K2"} if v2 else {"K1", "K3", "K2", "K4"} if fused else {
        "K1", "K2", "K5", "K6"}
    assert ran == want_ran


@pytest.mark.cuda
def test_grad_follows_the_replayed_graph(cuda, tmp_path, monkeypatch):
    """With two graphs (two batch sizes), ``.grad`` after each call holds
    that call's gradients: the eager step's on the same batch from the
    same weights."""
    make_trainer, batches = _train_setup(tmp_path, cuda, "graph_lam", monkeypatch)
    data = [batches(1, batch=2)[0], batches(1, batch=3)[0], batches(1, batch=2, seed=8)[0]]
    eager, captured = make_trainer(), make_trainer()
    step = captured.make_train_step()
    for b in data:
        eager.train_step(*b)
        step(*b)
        for p, q in zip(captured.forecaster.parameters(), eager.forecaster.parameters()):
            scale = max(q.grad.abs().max().item(), 1e-30)
            assert (p.grad - q.grad).abs().max().item() <= 1e-5 * scale
    assert len(captured.graphs) == 2


@pytest.mark.cuda
def test_scan_steps_equals_three_captured_steps(cuda, tmp_path, monkeypatch):
    make_trainer, batches = _train_setup(tmp_path, cuda, "graph_lam", monkeypatch)
    data = batches(3)
    single, scanned = make_trainer(), make_trainer()
    step = single.make_train_step()
    want = [step(*b).item() for b in data]
    stacked = [np.stack([b[i] for b in data]) for i in range(3)]
    got = []
    ticks = _ticks(lambda: got.append(scanned.make_train_step(scan_steps=3)(*stacked)))
    assert tuple(got[0].shape) == (3,)
    _assert_same_training(scanned, single, got[0].tolist(), want)
    assert len(scanned.graphs) == 1
    # single warm-up steps, then the capture of 3 steps; g2m, 2 m2m, m2g each
    assert ticks["K3 fused_edge_phase"] == (GRAPH_WARMUP_STEPS + 3) * 4


@pytest.mark.cuda
def test_graph_cache_keys_on_shape_and_route(cuda, tmp_path, monkeypatch):
    """A second batch size captures a second graph, a change of route a
    third, on that route; going back replays the earlier ones. The
    launch counters count the warm-up steps and the capture of a new
    graph, and nothing for a replay."""
    make_trainer, batches = _train_setup(tmp_path, cuda, "graph_lam", monkeypatch)
    trainer = make_trainer()
    step = trainer.make_train_step()
    step(*batches(1, batch=2)[0])
    step(*batches(1, batch=3)[0])
    assert len(trainer.graphs) == 2
    monkeypatch.setenv("NEURAL_LAM_TPU_FUSED_V2", "on")
    ticks = _ticks(lambda: step(*batches(1, batch=2)[0]))
    assert len(trainer.graphs) == 3
    # g2m, 2 m2m, m2g in each warm-up step and the capture
    assert ticks["K7 fused_edge_phase_v2"] == (GRAPH_WARMUP_STEPS + 1) * 4
    assert ticks["K3 fused_edge_phase"] == 0
    monkeypatch.setenv("NEURAL_LAM_TPU_FUSED_V2", "off")
    ticks = _ticks(lambda: step(*batches(1, batch=2)[0]))
    assert len(trainer.graphs) == 3 and not any(ticks.values())


@pytest.mark.cuda
def test_a_new_optimizer_is_captured_again(cuda, tmp_path, monkeypatch):
    """Replacing ``trainer.optimizer`` (as a restored optimizer state
    will) drops the graph; the next step captures a new one over the new
    state and goes on as the eager step does from the same point."""
    make_trainer, batches = _train_setup(tmp_path, cuda, "graph_lam", monkeypatch)
    data = batches(4)
    eager, captured = make_trainer(), make_trainer()
    step = captured.make_train_step()
    want, got, ticks = [], [], []
    for i, b in enumerate(data):
        if i == 2:
            first = captured.graphs[next(iter(captured.graphs))].graph
            eager.optimizer = eager.init_state()
            captured.optimizer = captured.init_state()
        want.append(eager.train_step(*b).item())
        ticks.append(_ticks(lambda: got.append(step(*b).item()))["K3 fused_edge_phase"])
    (entry,) = captured.graphs.values()
    assert entry.graph is not first
    # captured by the first and the third call, replayed by the others
    assert ticks == [(GRAPH_WARMUP_STEPS + 1) * 4, 0, (GRAPH_WARMUP_STEPS + 1) * 4, 0]
    _assert_same_training(captured, eager, got, want)


@pytest.mark.cuda
def test_capture_with_remat_at_three_ar_steps(cuda, tmp_path, monkeypatch):
    """At ``ar_steps`` 3 each AR step is rematerialised in the backward
    (``torch.utils.checkpoint``), inside the capture too."""
    make_trainer, batches = _train_setup(tmp_path, cuda, "graph_lam", monkeypatch)
    data = batches(3, steps=3)
    eager, captured = make_trainer(), make_trainer()
    assert captured.forecaster.remat_steps is None  # on for more than one step
    want = [eager.train_step(*b).item() for b in data]
    step = captured.make_train_step()
    got = []
    ticks = _ticks(lambda: got.extend(step(*b).item() for b in data))
    _assert_same_training(captured, eager, got, want)
    assert len(captured.graphs) == 1
    # the warm-up steps and the capture: three AR steps each, each forward
    # twice (the recompute), of 4 applications
    assert ticks["K3 fused_edge_phase"] == (GRAPH_WARMUP_STEPS + 1) * 3 * 2 * 4


@contextlib.contextmanager
def _process_group(backend, monkeypatch):
    """A process group of one rank in this process (``torchrun``'s
    environment), left after."""
    import socket

    from neural_lam_tpu_torch.utils import distributed

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for key, value in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="1",
                           RANK="0", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1").items():
        monkeypatch.setenv(key, value)
    distributed.init_from_env(backend)
    try:
        yield
    finally:
        distributed.destroy()


def _with_args(trainer, **args):
    """``trainer`` with ``TrainingArgs`` fields replaced and a new
    optimizer made from them."""
    for key, value in args.items():
        setattr(trainer.args, key, value)
    trainer.optimizer = trainer.init_state()
    return trainer


@pytest.mark.cuda
@pytest.mark.parametrize("args", [dict(), dict(shard_opt_state=False), dict(flat_opt=True)],
                         ids=["zero1", "replicated", "flat_opt"])
def test_dp_captured_step_in_an_nccl_group(cuda, tmp_path, monkeypatch, args):
    """In an NCCL group of one, the captured step (its all-reduce, and
    under ZeRO-1 its all-gather, inside the graph) against the eager step
    over 5 steps, bit for bit, and both against the step without a group
    (``torch.optim.AdamW``), whose trajectory ``FlatAdamW`` keeps."""
    from neural_lam_tpu_torch.optim import FlatAdamW

    make_trainer, batches = _train_setup(tmp_path, cuda, "graph_lam", monkeypatch)
    data = batches(5)
    plain = make_trainer()
    want = [plain.train_step(*b).item() for b in data]
    with _process_group("nccl", monkeypatch):
        eager, captured = _with_args(make_trainer(), **args), _with_args(make_trainer(), **args)
        assert isinstance(captured.optimizer, FlatAdamW)
        got_eager = [eager.train_step(*b).item() for b in data]
        step = captured.make_train_step()
        got = [step(*b).item() for b in data]
        assert len(captured.graphs) == 1
        assert _assert_same_training(captured, eager, got, got_eager)
    _assert_same_training(eager, plain, got_eager, want)


@pytest.mark.cuda
def test_captured_step_refuses_a_gloo_group_on_cuda(cuda, tmp_path, monkeypatch):
    """gloo's collectives cannot be captured: the captured step raises,
    the eager step runs (the collectives through host copies) and keeps
    the step of no group."""
    make_trainer, batches = _train_setup(tmp_path, cuda, "graph_lam", monkeypatch)
    data = batches(3)
    plain = make_trainer()
    want = [plain.train_step(*b).item() for b in data]
    with _process_group("gloo", monkeypatch):
        trainer = make_trainer()
        with pytest.raises(RuntimeError, match="NCCL"):
            trainer.make_train_step()
        got = [trainer.train_step(*b).item() for b in data]
    _assert_same_training(trainer, plain, got, want)


@pytest.mark.cuda
def test_flat_opt_captured_step_keeps_the_per_tensor_trajectory(cuda, tmp_path, monkeypatch):
    """``flat_opt`` without a group: the captured step against the
    per-tensor optimizer's captured step over 5 steps."""
    make_trainer, batches = _train_setup(tmp_path, cuda, "graph_lam", monkeypatch)
    data = batches(5)
    plain, flat = make_trainer(), _with_args(make_trainer(), flat_opt=True)
    want = [plain.make_train_step()(*b).item() for b in data]
    step = flat.make_train_step()
    got = [step(*b).item() for b in data]
    _assert_same_training(flat, plain, got, want)


CAPTURE_FAILS = """
import sys
from pathlib import Path

import numpy as np
import torch

from neural_lam_tpu_torch.config import DatastoreSelection, NeuralLAMConfig
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.graphs import create_graph_from_datastore
from neural_lam_tpu_torch.models import ARForecaster, GraphLAM
from neural_lam_tpu_torch.trainer import Trainer, TrainingArgs

root = Path(sys.argv[1])
ds = DummyDatastore(root_path=root, n_grid_x=9, n_grid_y=9, n_timesteps=12)
create_graph_from_datastore(ds, root / "graph" / "multiscale")
model = GraphLAM(ds, hidden_dim=64, processor_layers=1, device="cuda")
config = NeuralLAMConfig(datastore=DatastoreSelection(kind="dummydata", config_path=""))
trainer = Trainer(ARForecaster(model, ds), config, ds, TrainingArgs(batch_size=2))
loss_fn = trainer._loss


def host_read(*batch):
    loss = loss_fn(*batch)
    loss.item()  # waits for the device: not allowed inside a capture
    return loss


trainer._loss = host_read
rng = np.random.default_rng(0)
n, d = ds.num_grid_points, ds.get_num_data_vars("state")
f = 3 * ds.get_num_data_vars("forcing")
batch = [rng.normal(size=s).astype(np.float32) for s in ((2, 2, n, d), (2, 1, n, d), (2, 1, n, f))]
try:
    trainer.make_train_step()(*batch)
except RuntimeError as err:
    assert not trainer.graphs, "a failed capture left a graph"
    print("capture raised:", str(err).splitlines()[0])
    sys.exit(0)
print("the step ran without its graph")
sys.exit(1)
"""


@pytest.mark.cuda
def test_a_failed_capture_raises(cuda, tmp_path):
    """A step that cannot be captured (a host read inside it) raises on
    CUDA: the trainer does not fall back to the eager step. In a process
    of its own, so that the failed capture leaves nothing behind."""
    repo = Path(__file__).resolve().parent.parent
    out = subprocess.run(
        [sys.executable, "-c", CAPTURE_FAILS, str(tmp_path)], cwd=repo,
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(repo)},
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "capture raised" in out.stdout


# -- a restored optimizer state under the captured step -------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("saved_by", ["card", "cpu"])
def test_restore_opt_recaptures_and_matches_the_eager_step(cuda, tmp_path, monkeypatch,
                                                           saved_by):
    """What ``--load <run> --restore_opt`` does on the card
    (``CheckpointManager.restore``): AdamW's step count is a float32 CUDA
    tensor afterwards, also from a checkpoint saved by a CPU optimizer
    (``capturable`` False); the captured step, whose graph was captured
    before the restore, captures again over the restored state; and its
    next 5 losses equal, bit for bit, those of the eager step from the same
    restored state."""
    from neural_lam_tpu_torch.checkpoint import CheckpointManager

    make_trainer, batches = _train_setup(tmp_path, cuda, "graph_lam", monkeypatch)
    data = batches(8)
    source = make_trainer()
    for b in data[:2]:
        source.train_step(*b)
    ckpt = CheckpointManager(tmp_path / "run")
    ckpt.save("latest", source.forecaster.predictor, source.optimizer, step=1)
    if saved_by == "cpu":
        path = tmp_path / "run" / "checkpoints" / "latest" / "state.pt"
        state = torch.load(path, map_location="cpu", weights_only=True)
        for group in state["optimizer"]["param_groups"]:
            group["capturable"] = False
        torch.save(state, path)

    eager, captured = make_trainer(), make_trainer()
    step = captured.make_train_step()
    step(*data[2])  # a graph over the state before the restore
    eager.train_step(*data[2])
    first = captured.graphs[next(iter(captured.graphs))].graph
    for trainer in (eager, captured):
        assert ckpt.restore("latest", trainer.forecaster.predictor, trainer.optimizer) == 1
        assert all(g["capturable"] for g in trainer.optimizer.param_groups)
        for st in trainer.optimizer.state.values():
            assert st["step"].is_cuda and st["step"].dtype == torch.float32
            assert float(st["step"]) == 2.0
    want = [eager.train_step(*b).item() for b in data[3:]]
    got = []
    ticks = _ticks(lambda: got.append(step(*data[3]).item()))
    later = _ticks(lambda: got.extend(step(*b).item() for b in data[4:]))
    (entry,) = captured.graphs.values()
    assert entry.graph is not first
    # captured again: the warm-up steps and the capture, g2m, 2 m2m, m2g each
    assert ticks["K3 fused_edge_phase"] == (GRAPH_WARMUP_STEPS + 1) * 4
    assert not any(later.values())
    assert got == want
    assert _assert_same_training(captured, eager, got, want)


# -- inference as CUDA graphs ------------------------------------------------------
#
# The forecast (``predict.make_forecast``), the eval step
# (``Trainer.make_eval_step``) and the test evaluation's batch
# (``evaluation.make_eval_batch``) are ``CapturedFunction``s: one CUDA
# graph per input shape and route. Each is held to the same code run
# eagerly on the card (``CapturedFunction.__call__`` patched to call the
# function), on the same weights and inputs: every output within 1e-6 of
# its largest entry; the same kernels run on the same values, so the same
# bits are expected, and their count is printed.

INFERENCE_RTOL = 1e-6


def _eager_inference(m) -> None:
    """``CapturedFunction`` calls its function eagerly under ``m`` (a
    ``monkeypatch`` context), as it does on the CPU."""
    from neural_lam_tpu_torch.utils.cuda_graph import CapturedFunction

    def call(self, *inputs):
        with torch.no_grad():
            return self.fn(*inputs)

    m.setattr(CapturedFunction, "__call__", call)


def _same(pairs, label) -> tuple[int, int]:
    """Each ``(got, want)`` array pair within ``INFERENCE_RTOL`` of the
    largest entry of ``want``; returns (equal entries, entries)."""
    same = total = 0
    for got, want in pairs:
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape, label
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(got - want).max() <= INFERENCE_RTOL * scale, label
        same += int((got == want).sum())
        total += want.size
    print(f"{label}: captured against eager, {same} of {total} entries the same bits")
    return same, total


def _recording(monkeypatch, module, name) -> list:
    """Patch ``module.name``, a maker of ``CapturedFunction``s, to keep
    what it makes in the returned list."""
    made = []
    maker = getattr(module, name)

    def record(*args, **kwargs):
        made.append(maker(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(module, name, record)
    return made


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TRAIN_MODELS))
def test_captured_forecast_matches_the_eager_forecast(cuda, tmp_path, monkeypatch, name):
    """``run_forecasts`` over the test split (7 samples at 3 AR steps in
    batches of 2: the tail batch of 1 is padded to 2 and replays the same
    graph), captured against eager: the same files. The first batch's
    call warms up and captures, the others only replay."""
    from neural_lam_tpu_torch import predict

    make_trainer, _ = _train_setup(tmp_path, cuda, name, monkeypatch)
    trainer = make_trainer()
    fc, ds = trainer.forecaster, trainer.datastore
    made = _recording(monkeypatch, predict, "make_forecast")
    kw = dict(split="test", ar_steps=3, batch_size=2, device=cuda)
    ticks = _ticks(lambda: predict.run_forecasts(fc, ds, out_dir=tmp_path / "captured", **kw))
    with monkeypatch.context() as m:
        _eager_inference(m)
        eager = _ticks(lambda: predict.run_forecasts(fc, ds, out_dir=tmp_path / "eager", **kw))
    files = sorted(p.name for p in (tmp_path / "eager").glob("forecast_test_*.npz"))
    assert len(files) == 7
    assert sorted(p.name for p in (tmp_path / "captured").glob("*.npz")) == files
    _same([(np.load(tmp_path / "captured" / f)["prediction"],
            np.load(tmp_path / "eager" / f)["prediction"]) for f in files], f"{name} forecast")
    (entry,) = made[0].graphs.values()
    assert entry.replays == 4 and entry.inputs[0].shape[0] == 2
    # the warm-up call and the capture launch what 2 of the 4 eager batches do
    assert all(2 * ticks[k] == v for k, v in eager.items()) and any(ticks.values())


@pytest.mark.cuda
def test_captured_evaluate_matches_the_eager_evaluate(cuda, tmp_path, monkeypatch):
    """``Trainer.evaluate`` over the validation split at 3 AR steps (7
    samples in batches of 2, the tail padded), with a watched metric,
    captured against eager: the same records, from one graph."""
    from neural_lam_tpu_torch.dataset import WeatherDataset
    from neural_lam_tpu_torch.loader import DataLoader

    make_trainer, _ = _train_setup(tmp_path, cuda, "graph_lam", monkeypatch)
    trainer = make_trainer()
    ds = trainer.datastore
    trainer.args.metrics_watch = ("val_rmse", "val_mae")
    trainer.args.var_leads_metrics_watch = {ds.get_vars_names("state")[0]: [1, 3]}
    loader = DataLoader(WeatherDataset(ds, "val", ar_steps=3), 2)
    got = trainer.evaluate(loader)
    with monkeypatch.context() as m:
        _eager_inference(m)
        want = trainer.evaluate(loader)
    assert sorted(got) == sorted(want) and len(got) > 4
    _same([(got[k], want[k]) for k in want], "evaluate")
    (entry,) = trainer.eval_steps[3].graphs.values()
    assert entry.replays == len(loader) == 4


@pytest.mark.cuda
def test_captured_test_evaluation_matches_the_eager_one(cuda, tmp_path, monkeypatch):
    """``run_test_evaluation`` at 3 AR steps, captured against eager: the
    same metrics and spatial loss map; and one batch's every output (loss,
    the three tables, the spatial loss, the prediction) from
    ``make_eval_batch``, whose clones a later replay leaves alone."""
    from neural_lam_tpu_torch import evaluation
    from neural_lam_tpu_torch.dataset import WeatherDataset
    from neural_lam_tpu_torch.loader import DataLoader

    make_trainer, batches = _train_setup(tmp_path, cuda, "graph_lam", monkeypatch)
    trainer = make_trainer()
    ds = trainer.datastore
    loader = DataLoader(WeatherDataset(ds, "test", ar_steps=3), 2)
    made = _recording(monkeypatch, evaluation, "make_eval_batch")
    kw = dict(n_example_pred=0, metrics_watch=["test_rmse"],
              var_leads_metrics_watch={ds.get_vars_names("state")[0]: [1, 3]})
    got = evaluation.run_test_evaluation(trainer, loader, ds, tmp_path / "captured", **kw)
    with monkeypatch.context() as m:
        _eager_inference(m)
        want = evaluation.run_test_evaluation(trainer, loader, ds, tmp_path / "eager", **kw)
    assert sorted(got) == sorted(want)
    _same([(got[k], want[k]) for k in want]
          + [tuple(np.load(tmp_path / d / "mean_spatial_loss.npy") for d in ("captured", "eager"))],
          "run_test_evaluation")
    (entry,) = made[0].graphs.values()
    assert entry.replays == len(loader)

    eval_batch = evaluation.make_eval_batch(trainer)
    data = [torch.from_numpy(a).to(cuda) for a in batches(2, steps=3)[0]]
    other = [torch.from_numpy(a).to(cuda) for a in batches(1, steps=3, seed=9)[0]]
    first = eval_batch(*data)
    kept = [t.clone() for t in (*first[0], first[1])]
    eval_batch(*other)  # a later replay
    with torch.no_grad():
        want = eval_batch.fn(*data)
    _same([(a.cpu(), b.cpu()) for a, b in zip((*first[0], first[1]), (*want[0], want[1]))],
          "eval_batch")
    assert all(torch.equal(a, b) for a, b in zip(kept, (*first[0], first[1])))


@pytest.mark.cuda
def test_inference_graphs_key_on_shape_and_route(cuda, tmp_path, monkeypatch):
    """The forecast captures a graph per batch size and a third on the v2
    route; going back replays the earlier ones and calls no wrapper."""
    from neural_lam_tpu_torch.predict import make_forecast

    make_trainer, batches = _train_setup(tmp_path, cuda, "graph_lam", monkeypatch)
    trainer = make_trainer()
    forecast = make_forecast(trainer.forecaster, trainer.datastore, cuda)
    b2, b3 = ([torch.from_numpy(a).to(cuda) for a in batches(1, batch=b, steps=2)[0]]
              for b in (2, 3))
    forecast(*b2)
    forecast(*b3)
    assert len(forecast.graphs) == 2
    monkeypatch.setenv("NEURAL_LAM_TPU_FUSED_V2", "on")
    ticks = _ticks(lambda: forecast(*b2))
    assert len(forecast.graphs) == 3
    # the warm-up call and the capture: 2 AR steps of g2m, 2 m2m, m2g
    assert ticks["K7 fused_edge_phase_v2"] == 2 * 2 * 4 and ticks["K3 fused_edge_phase"] == 0
    monkeypatch.setenv("NEURAL_LAM_TPU_FUSED_V2", "off")
    ticks = _ticks(lambda: (forecast(*b2), forecast(*b3)))
    assert len(forecast.graphs) == 3 and not any(ticks.values())
    assert sorted(e.replays for e in forecast.graphs.values()) == [1, 2, 2]


@pytest.mark.cuda
def test_inference_recaptures_after_a_replaced_parameter(cuda, tmp_path, monkeypatch):
    """What ``--load <run> --restore_opt`` does to a trainer whose eval
    step was captured: the restore copies the parameters in place, so the
    graph stays and replays the restored weights; a parameter replaced by
    a new tensor drops the graph, and the next call captures again. Each
    result equals the eager eval step's on the same weights."""
    from neural_lam_tpu_torch.checkpoint import CheckpointManager

    make_trainer, batches = _train_setup(tmp_path, cuda, "graph_lam", monkeypatch)
    source, trainer = make_trainer(), make_trainer()
    for b in batches(2):
        source.train_step(*b)
    ckpt = CheckpointManager(tmp_path / "run")
    ckpt.save("latest", source.forecaster.predictor, source.optimizer, step=1)
    data = [torch.from_numpy(a).to(cuda) for a in batches(1, steps=3, seed=11)[0]]
    step = trainer.make_eval_step(3)

    def check(label):
        """The captured call against the eager one; returns the
        captured call's outputs and its wrappers' ticks."""
        got = []
        ticks = _ticks(lambda: got.append(step(*data)))
        with torch.no_grad():
            want = step.fn(*data)
        _same([(got[0][k].cpu(), want[k].cpu()) for k in want], label)
        return got[0], ticks

    before, _ = check("eval step")
    first = next(iter(step.graphs.values())).graph
    ckpt.restore("latest", trainer.forecaster.predictor, trainer.optimizer)
    after, ticks = check("eval step after the restore")
    assert next(iter(step.graphs.values())).graph is first and not any(ticks.values())
    assert not torch.equal(after["loss"], before["loss"])
    param = next(trainer.forecaster.parameters())
    with torch.no_grad():
        param.data = param.data.clone()  # a new tensor: a new address
    _, ticks = check("eval step after a replaced parameter")
    (entry,) = step.graphs.values()
    assert entry.graph is not first and ticks["K3 fused_edge_phase"] == 2 * 3 * 4


INFERENCE_CAPTURE_FAILS = """
import sys
from pathlib import Path

import numpy as np
import torch

from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.graphs import create_graph_from_datastore
from neural_lam_tpu_torch.models import ARForecaster, GraphLAM
from neural_lam_tpu_torch.predict import make_forecast

root = Path(sys.argv[1])
ds = DummyDatastore(root_path=root, n_grid_x=9, n_grid_y=9, n_timesteps=12)
create_graph_from_datastore(ds, root / "graph" / "multiscale")
fc = ARForecaster(GraphLAM(ds, hidden_dim=64, processor_layers=1, device="cuda"), ds)
forward = fc.forward


def host_read(*args):
    out = forward(*args)
    out[0].sum().item()  # waits for the device: not allowed inside a capture
    return out


fc.forward = host_read
forecast = make_forecast(fc, ds, "cuda")
rng = np.random.default_rng(0)
n, d = ds.num_grid_points, ds.get_num_data_vars("state")
f = 3 * ds.get_num_data_vars("forcing")
batch = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).cuda()
         for s in ((2, 2, n, d), (2, 1, n, d), (2, 1, n, f))]
try:
    forecast(*batch)
except RuntimeError as err:
    assert not forecast.graphs, "a failed capture left a graph"
    print("capture raised:", str(err).splitlines()[0])
    sys.exit(0)
print("the forecast ran without its graph")
sys.exit(1)
"""


@pytest.mark.cuda
def test_a_failed_inference_capture_raises(cuda, tmp_path):
    """A forecast that cannot be captured (a host read inside it) raises
    on CUDA: there is no eager fallback. In a process of its own, so that
    the failed capture leaves nothing behind."""
    repo = Path(__file__).resolve().parent.parent
    out = subprocess.run(
        [sys.executable, "-c", INFERENCE_CAPTURE_FAILS, str(tmp_path)], cwd=repo,
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(repo)},
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "capture raised" in out.stdout


# -- the bf16 variants of K1-K4 ----------------------------------------------
#
# Each against its plain version at the same dtypes on the card. The
# kernels and the plain versions multiply the same bf16 operands exactly
# and sum in float32 in other orders; a bf16 output then rounds two nearly
# equal float32 values, which can land one bf16 ulp (2^-8 of the value)
# apart. So every output and gradient is held to 8e-3 of its largest
# entry, about two bf16 ulps, and its mean error to 1e-3 of it.

# mode -> (NEURAL_LAM_TPU_MATMUL_PRECISION, dtype of the inputs and weights)
BF16_MODES = {
    "bf16": (None, torch.bfloat16),  # mixed precision: bf16 streams, operands
    "high": ("high", torch.float32),  # bf16 streams, operands; float32 out
    "high-kernels": ("high-kernels", torch.float32),  # bf16 operands only
}
BF16_TOL, BF16_MEAN_TOL = 8e-3, 1e-3


def _bf16_mode(monkeypatch, mode):
    env, dtype = BF16_MODES[mode]
    monkeypatch.delenv("NEURAL_LAM_TPU_BF16_KERNELS", raising=False)
    if env is None:
        monkeypatch.delenv("NEURAL_LAM_TPU_MATMUL_PRECISION", raising=False)
    else:
        monkeypatch.setenv("NEURAL_LAM_TPU_MATMUL_PRECISION", env)
    return dtype


def _close_bf16(got, want, what=""):
    assert got.dtype == want.dtype, what
    scale = max(want.abs().max().item(), 1e-30)
    err = (got.float() - want.float()).abs()
    assert err.max().item() <= BF16_TOL * scale, (what, err.max().item() / scale)
    assert err.mean().item() <= BF16_MEAN_TOL * scale, (what, err.mean().item() / scale)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 64), (3, 5)])
def test_sender_gather_bf16_matches_plain(cuda, shape):
    rng = np.random.default_rng(20)
    es, _ = _edge_set(rng, 300, 200, 5000, cuda)
    x = torch.tensor(rng.normal(size=(300,) + shape), device=cuda).to(torch.bfloat16)
    before, f32 = sk.SENDER_GATHER_BF16.launches, sender_gather.launches
    out = sender_gather(x, es.senders)
    torch.cuda.synchronize()
    assert (sk.SENDER_GATHER_BF16.launches, sender_gather.launches) == (before + 1, f32)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, sender_gather_plain(x, es.senders))  # a copy


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 64), (3, 5)])
def test_sender_scatter_bf16_matches_plain(cuda, shape):
    """bf16 rows in, float32 sums out, as the JAX kernel's ``out_dtype``."""
    rng = np.random.default_rng(21)
    snd = np.concatenate([rng.integers(0, 290, 4600), np.full(400, 7)])
    es, _ = make_edge_set(snd, rng.integers(0, 200, 5000), num_rec=200, num_send=300)
    es = es.to(cuda)
    g = torch.tensor(rng.normal(size=(5000,) + shape), device=cuda).to(torch.bfloat16)
    before = sk.SENDER_SCATTER_BF16.launches
    out = sender_scatter(g, es, 310)
    torch.cuda.synchronize()
    assert sk.SENDER_SCATTER_BF16.launches == before + 1
    assert out.dtype == torch.float32
    # float32 sums of the same values in another order than index_add_'s
    torch.testing.assert_close(out, sender_scatter_plain(g, es.senders, 310),
                               rtol=1e-5, atol=1e-4)
    assert torch.equal(out, sender_scatter(g, es, 310))


def _sender_rows_case(cuda, n_send=300, n_edges=5000, seed=22):
    """Edges whose sender 7 has 400 slots and whose last 10 senders have
    none, over ``n_send`` sender rows."""
    rng = np.random.default_rng(seed)
    snd = np.concatenate([rng.integers(0, n_send - 10, n_edges - 400), np.full(400, 7)])
    es, _ = make_edge_set(snd, rng.integers(0, 200, n_edges), num_rec=200, num_send=n_send)
    return rng, es.to(cuda)


def _bf16_rows(rng, cuda, shape, offset=0):
    """bf16 rows of ``shape``, as a contiguous view ``offset`` bytes past a
    16-byte aligned allocation (an even number of bytes)."""
    n = int(np.prod(shape))
    flat = torch.empty(n + 8, dtype=torch.bfloat16, device=cuda)
    x = flat[offset // 2: offset // 2 + n].view(shape)
    x.copy_(torch.tensor(rng.normal(size=shape), dtype=torch.float32, device=cuda))
    assert x.is_contiguous() and x.data_ptr() % 16 == offset % 16
    return x


# K1's and K2's bf16 rows at hidden 64: batch 1, 4 and 32 (a 128-, 512-
# and 4,096-byte row, whole 16-byte words); width 5 at batch 32 and at
# batch 3 (rows of whole 8-byte words, and of neither)
SENDER_ROW_SHAPES = [(1, 64), (4, 64), (32, 64), (32, 5), (3, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SENDER_ROW_SHAPES)
def test_sender_gather_bf16_copies_the_rows(cuda, shape):
    """K1 bf16: the plain version's bits, edges not a multiple of 32, one
    launch counted apart from float32's."""
    rng, es = _sender_rows_case(cuda, n_edges=5003)
    x = _bf16_rows(rng, cuda, (300,) + shape)
    before, f32 = sk.SENDER_GATHER_BF16.launches, sender_gather.launches
    out = sender_gather(x, es.senders)
    torch.cuda.synchronize()
    assert (sk.SENDER_GATHER_BF16.launches, sender_gather.launches) == (before + 1, f32)
    assert torch.equal(out, sender_gather_plain(x, es.senders))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [2, 8, 16])
def test_sender_gather_bf16_misaligned_view(cuda, offset):
    """A view off 16-byte alignment takes the element form, one on it the
    16-byte words; the same bits either way."""
    rng, es = _sender_rows_case(cuda)
    x = _bf16_rows(rng, cuda, (300, 4, 64), offset)
    assert torch.equal(sender_gather(x, es.senders), sender_gather_plain(x, es.senders))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SENDER_ROW_SHAPES)
@pytest.mark.parametrize("num_rows", [300, 333])
def test_sender_scatter_bf16_sums_the_slots(cuda, shape, num_rows):
    """K2 bf16: a sender with 400 slots, ten with none and, at 333, rows
    past the edge set's senders, all within float32 summation order of the
    plain version, the same bits run after run."""
    rng, es = _sender_rows_case(cuda)
    g = _bf16_rows(rng, cuda, (5000,) + shape)
    before = sk.SENDER_SCATTER_BF16.launches
    out = sender_scatter(g, es, num_rows)
    torch.cuda.synchronize()
    assert sk.SENDER_SCATTER_BF16.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (num_rows,) + shape
    torch.testing.assert_close(out, sender_scatter_plain(g, es.senders, num_rows),
                               rtol=1e-5, atol=1e-4)
    assert torch.count_nonzero(out[290:]) == 0
    assert torch.equal(out, sender_scatter(g, es, num_rows))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 4])
def test_sender_scatter_bf16_many_senders_of_few_slots(cuda, batch):
    """50,000 senders over 60,000 edges, most with one or two slots."""
    rng, es = _sender_rows_case(cuda, n_send=50_000, n_edges=60_000, seed=23)
    g = _bf16_rows(rng, cuda, (60_000, batch, 64))
    out = sender_scatter(g, es, 50_000)
    torch.testing.assert_close(out, sender_scatter_plain(g, es.senders, 50_000),
                               rtol=1e-5, atol=1e-4)
    assert torch.equal(out, sender_scatter(g, es, 50_000))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [2, 8, 16])
def test_sender_scatter_bf16_misaligned_view(cuda, offset):
    """``g`` 2 bytes off 8-byte alignment takes the element form, on it
    the 8-byte words; each within the plain version's summation order."""
    rng, es = _sender_rows_case(cuda)
    g = _bf16_rows(rng, cuda, (5000, 4, 64), offset)
    out = sender_scatter(g, es, 300)
    torch.testing.assert_close(out, sender_scatter_plain(g, es.senders, 300),
                               rtol=1e-5, atol=1e-4)
    assert torch.equal(out, sender_scatter(g, es, 300))


def _bf16_phase_case(cuda, mode, flags, batch, seed, grad=False):
    """Inputs, modules and the keyword arguments of one fused phase in
    ``mode``'s dtype: ``(args, kw, leaves)``."""
    edge_mode, update, prop, ln = flags
    _, dtype = BF16_MODES[mode]
    rng = np.random.default_rng(seed)
    d, n_send, n_rec = 64, 70, 50
    es, _ = _edge_set(rng, n_send, n_rec, 900, cuda, empty_rec=5)
    gen = torch.Generator().manual_seed(seed)
    edge_mlp = make_mlp([3 * d, d, d], layer_norm=ln, generator=gen).to(cuda, dtype)
    embedder = make_mlp([3, d, d], generator=gen).to(cuda, dtype)

    def t(*shape, g=False):
        x = torch.tensor(rng.normal(size=shape), dtype=torch.float32, device=cuda)
        return x.to(dtype).requires_grad_(g)

    x_send, rec = t(es.num_edges, batch, d, g=grad), t(n_rec, batch, d, g=grad)
    edge_rep, feats, emb = None, None, None
    if edge_mode == "raw":
        feats, emb = t(es.num_edges, 3), embedder
    elif edge_mode == "shared":
        edge_rep = t(es.num_edges, d, g=grad)
    else:
        edge_rep = t(es.num_edges, batch, d, g=grad)
    leaves = [x_send, rec] + ([edge_rep] if edge_rep is not None else [])
    leaves += list(edge_mlp.parameters()) + (list(emb.parameters()) if emb else [])
    kw = dict(embedder=emb, edge_feats=feats, update_edges=update, propagation=prop)
    return (edge_mlp, edge_rep, x_send, rec, es), kw, leaves


def _bf16_counter(mode):
    return fk.FUSED_EDGE_BF16_OPS if mode == "high-kernels" else fk.FUSED_EDGE_BF16


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(BF16_MODES))
@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("batch", [4, 1, 32])
def test_fused_edge_phase_bf16_matches_plain(cuda, monkeypatch, mode, flags, batch):
    """K3's bf16-operand instantiations (bf16 streams; float32 streams
    under ``high-kernels``) against the plain version: the aggregate and
    the updated edges in the receiver rows' dtype, receivers without
    edges 0."""
    _bf16_mode(monkeypatch, mode)
    (edge_mlp, edge_rep, x_send, rec, es), kw, _ = _bf16_phase_case(
        cuda, mode, flags, batch, seed=22
    )
    counter = _bf16_counter(mode)
    with torch.no_grad():
        before, f32 = counter.launches, fused_edge_phase.launches
        got = fused_edge_phase(edge_mlp, edge_rep, x_send, rec, es, **kw)
        torch.cuda.synchronize()
        assert (counter.launches, fused_edge_phase.launches) == (before + 1, f32)
        want = fused_edge_phase_plain(edge_mlp, edge_rep, x_send, rec, es.receivers,
                                      kw["embedder"], kw["edge_feats"],
                                      kw["update_edges"], kw["propagation"])
    assert got[0].dtype == rec.dtype
    _close_bf16(got[0], want[0], "aggr")
    assert torch.all(got[0][-5:] == 0)
    if flags[1]:
        _close_bf16(got[1], want[1], "new_edge")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(BF16_MODES))
@pytest.mark.parametrize("flags", BWD_FLAGS)
@pytest.mark.parametrize("batch,use_new_edge", [(4, True), (4, False), (1, True), (32, True)])
def test_fused_edge_phase_bf16_backward_matches_plain(cuda, monkeypatch, mode, flags,
                                                     batch, use_new_edge):
    """K4's bf16-operand instantiations against autograd of the plain
    version: every input and weight gradient, in the input's or weight's
    dtype; the same bits on a second run."""
    _bf16_mode(monkeypatch, mode)
    (edge_mlp, edge_rep, x_send, rec, es), kw, leaves = _bf16_phase_case(
        cuda, mode, flags, batch, seed=23, grad=True
    )
    rng = np.random.default_rng(24)
    w_aggr = torch.tensor(rng.normal(size=tuple(rec.shape)), device=cuda).to(rec.dtype)
    w_edge = torch.tensor(rng.normal(size=tuple(x_send.shape)), device=cuda).to(rec.dtype)

    def loss(out):
        total = (out[0].float() * w_aggr.float()).sum()
        if flags[1] and use_new_edge:
            total = total + (out[1].float() * w_edge.float()).sum()
        return total

    counter = fk.FUSED_EDGE_BWD_BF16_OPS if mode == "high-kernels" else fk.FUSED_EDGE_BWD_BF16
    before, f32 = counter.launches, fused_edge_bwd.launches
    got = torch.autograd.grad(loss(fused_edge_phase(edge_mlp, edge_rep, x_send, rec, es, **kw)),
                              leaves)
    torch.cuda.synchronize()
    assert (counter.launches, fused_edge_bwd.launches) == (before + 1, f32)
    want = torch.autograd.grad(
        loss(fused_edge_phase_plain(edge_mlp, edge_rep, x_send, rec, es.receivers,
                                    kw["embedder"], kw["edge_feats"], kw["update_edges"],
                                    kw["propagation"])),
        leaves,
    )
    for i, (g, w) in enumerate(zip(got, want)):
        _close_bf16(g, w, f"gradient {i}")
    again = torch.autograd.grad(
        loss(fused_edge_phase(edge_mlp, edge_rep, x_send, rec, es, **kw)), leaves
    )
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_bf16_kernels_off_keeps_the_float32_kernels(cuda, monkeypatch):
    """``NEURAL_LAM_TPU_BF16_KERNELS=off``: bf16 inputs reach K1 and K3
    as float32 (casts at their boundary), and the outputs are bf16."""
    _bf16_mode(monkeypatch, "bf16")
    monkeypatch.setenv("NEURAL_LAM_TPU_BF16_KERNELS", "off")
    (edge_mlp, edge_rep, x_send, rec, es), kw, _ = _bf16_phase_case(
        cuda, "bf16", FLAGS[2], 4, seed=25
    )
    send = torch.randn(70, 4, 64, device=cuda).to(torch.bfloat16)
    with torch.no_grad():
        ticks = _ticks(lambda: (gather_senders(es, send),
                                fused_edge_phase(edge_mlp, edge_rep, x_send, rec, es, **kw)))
        got = fused_edge_phase(edge_mlp, edge_rep, x_send, rec, es, **kw)
        want = fused_edge_phase_plain(edge_mlp, edge_rep, x_send, rec, es.receivers,
                                      None, None, kw["update_edges"], kw["propagation"])
    assert {k for k, v in ticks.items() if v} == {"K1 sender_gather", "K3 fused_edge_phase"}
    assert got[0].dtype == torch.bfloat16
    _close_bf16(got[0], want[0])


def _bf16_trainers(tmp_path, cuda, monkeypatch):
    """``_train_setup``'s GraphLAM, built with ``compute_dtype`` bf16 and
    trained with ``precision="bf16"``."""
    monkeypatch.setenv("NEURAL_LAM_TPU_FUSED_V2", "off")
    ds = DummyDatastore(root_path=tmp_path, n_grid_x=9, n_grid_y=9, n_timesteps=12)
    create_graph_from_datastore(ds, tmp_path / "graph" / "multiscale")
    model_kw = dict(hidden_dim=64, processor_layers=2, compute_dtype=torch.bfloat16)
    weights = GraphLAM(ds, device="cpu", **model_kw).state_dict()
    config = NeuralLAMConfig(datastore=DatastoreSelection(kind="dummydata", config_path=""))

    def make_trainer():
        model = GraphLAM(ds, device=cuda, **model_kw)
        model.load_state_dict(weights)
        return Trainer(ARForecaster(model, ds), config, ds,
                       TrainingArgs(batch_size=2, precision="bf16"), device=cuda)

    rng = np.random.default_rng(7)
    n, d = ds.num_grid_points, ds.get_num_data_vars("state")
    f = 3 * ds.get_num_data_vars("forcing")
    data = [tuple(rng.normal(size=s).astype(np.float32)
                  for s in ((2, 2, n, d), (2, 1, n, d), (2, 1, n, f))) for _ in range(5)]
    return make_trainer, data


@pytest.mark.cuda
def test_captured_bf16_step_matches_the_eager_step(cuda, tmp_path, monkeypatch):
    """Mixed precision through the captured graph against five eager
    steps from the same weights, bit for bit; the parameters and AdamW's
    state stay float32, and the step launched the bf16 variants of K1-K4
    only."""
    _bf16_mode(monkeypatch, "bf16")
    make_trainer, data = _bf16_trainers(tmp_path, cuda, monkeypatch)
    eager, captured = make_trainer(), make_trainer()
    want = [eager.train_step(*b).item() for b in data]
    step = captured.make_train_step()
    got = []
    first = _ticks(lambda: got.append(step(*data[0]).item()))
    got += [step(*b).item() for b in data[1:]]
    assert got == want and np.isfinite(got).all()
    for p, q in zip(captured.forecaster.parameters(), eager.forecaster.parameters()):
        assert p.dtype == torch.float32 and torch.equal(p, q)
    for state in captured.optimizer.state.values():
        assert all(t.dtype == torch.float32 for t in state.values() if torch.is_tensor(t))
    assert {k for k, v in first.items() if v} == {
        "K1 sender_gather bf16", "K2 sender_scatter bf16", "K3 fused_edge_phase bf16",
        "K4 fused_edge_phase backward bf16", fk.FUSED_EDGE_BWD_RECEIVER.name,
    }


@pytest.mark.cuda
def test_captured_step_recaptures_when_the_matmul_precision_changes(cuda, tmp_path,
                                                                    monkeypatch):
    """A change of ``NEURAL_LAM_TPU_MATMUL_PRECISION`` between calls
    captures a graph of its own, which runs the bf16-operand K3 and K4,
    and replays the eager step's values under it; going back replays the
    first graph."""
    make_trainer, batches = _train_setup(tmp_path, cuda, "graph_lam", monkeypatch)
    data = batches(3)
    eager, captured = make_trainer(), make_trainer()
    step = captured.make_train_step()
    monkeypatch.delenv("NEURAL_LAM_TPU_MATMUL_PRECISION", raising=False)
    want = [eager.train_step(*data[0]).item()]
    got = [step(*data[0]).item()]
    monkeypatch.setenv("NEURAL_LAM_TPU_MATMUL_PRECISION", "high-kernels")
    want.append(eager.train_step(*data[1]).item())
    ticks = _ticks(lambda: got.append(step(*data[1]).item()))
    monkeypatch.delenv("NEURAL_LAM_TPU_MATMUL_PRECISION")
    want.append(eager.train_step(*data[2]).item())
    later = _ticks(lambda: got.append(step(*data[2]).item()))
    assert len(captured.graphs) == 2 and not any(later.values())
    assert ticks["K3 fused_edge_phase bf16 operands"] > 0 and ticks["K3 fused_edge_phase"] == 0
    np.testing.assert_allclose(got, want, rtol=1e-6)


# -- NEURAL_LAM_TPU_CACHE_PRE: K3 writing a bf16 pre, K4 reading it, K4
# recomputing it ------------------------------------------------------------
#
# In each precision: float32 (3xTF32) and the two bf16-operand ones. K4
# from a bf16 pre is held to the plain backward from the same bf16 values
# (``_plain_bwd`` with ``pre``), so that a rounding of pre that lands one
# bf16 ulp apart in kernel and plain version does not count against it.

PRE_MODES = {"float32": (None, torch.float32), **BF16_MODES}
PRE_FLAGS = [FLAGS[0], FLAGS[1], FLAGS[2], FLAGS[3], FLAGS[4]]


def _pre_case(cuda, monkeypatch, mode, flags, batch, seed):
    """The kernel arguments of one phase in ``mode``'s streams and
    operands: ``(edge_in, x_send, rec, es, wts, raw, update, prop,
    bf16_ops)``, the weights float32 (bf16 copies under mixed precision)."""
    env, _ = PRE_MODES[mode]
    if env is None:
        monkeypatch.delenv("NEURAL_LAM_TPU_MATMUL_PRECISION", raising=False)
    else:
        monkeypatch.setenv("NEURAL_LAM_TPU_MATMUL_PRECISION", env)
    case_mode = "bf16" if mode == "float32" else mode
    (edge_mlp, edge_rep, x_send, rec, es), kw, _ = _bf16_phase_case(
        cuda, case_mode, flags, batch, seed
    )
    if mode == "float32":
        edge_mlp = edge_mlp.float()
        kw["embedder"] = None if kw["embedder"] is None else kw["embedder"].float()
    bf16_ops, io = fk.fused_precision(rec.dtype if mode != "float32" else torch.float32)
    raw = flags[0] == "raw"
    edge_in = kw["edge_feats"] if raw else edge_rep
    wts = [None if w is None else w.detach().float() for w in
           _weights(edge_mlp, kw["embedder"])]
    args = [t.detach().float().to(io).contiguous() for t in (edge_in, x_send, rec)]
    return (*args, es, wts, raw, flags[1], flags[2], bf16_ops)


def _close_grads(got, want, mode, tol=1e-4):
    """float32: each gradient within ``tol`` of its largest entry; the bf16
    modes: ``_close_bf16`` in the gradient's dtype."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None:
            assert w is None or not w.any(), i
            continue
        if mode == "float32":
            scale = max(w.abs().max().item(), 1e-30)
            assert (g.float() - w.float()).abs().max().item() <= tol * scale, i
        else:
            _close_bf16(g, w.to(g.dtype), f"gradient {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(PRE_MODES))
@pytest.mark.parametrize("flags", PRE_FLAGS)
def test_bf16_pre_is_the_rounded_float32_pre(cuda, monkeypatch, mode, flags):
    """K3's ``PRE_BF16`` instantiations write the pre-activation that the
    float32-pre K3 writes, rounded to nearest even, in half the bytes, and
    the same outputs bit for bit; their launches count apart."""
    edge_in, x_send, rec, es, wts, raw, update, prop, bf16_ops = _pre_case(
        cuda, monkeypatch, mode, flags, 4, seed=40
    )
    args = (edge_in, x_send, rec, es, wts, raw, update, prop)
    with torch.no_grad():
        a32, e32, pre32 = fused_edge_fwd(*args, save_pre=True, bf16_ops=bf16_ops)
        ticks = _ticks(lambda: fused_edge_fwd(*args, save_pre=True, bf16_ops=bf16_ops,
                                              pre_dtype=torch.bfloat16))
        a16, e16, pre16 = fused_edge_fwd(*args, save_pre=True, bf16_ops=bf16_ops,
                                         pre_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert {k for k, v in ticks.items() if v} == {"K3 fused_edge_phase bf16 pre"}
    assert pre16.dtype == torch.bfloat16 and pre16.nbytes * 2 == pre32.nbytes
    assert torch.equal(pre16, pre32.to(torch.bfloat16))
    assert torch.equal(a16, a32) and (e16 is None or torch.equal(e16, e32))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(PRE_MODES))
@pytest.mark.parametrize("flags", PRE_FLAGS)
@pytest.mark.parametrize("batch,use_new_edge", [(4, True), (4, False), (1, True), (32, True)])
def test_backward_from_bf16_pre_matches_plain(cuda, monkeypatch, mode, flags, batch,
                                              use_new_edge):
    """K4's ``kPreBf16`` instantiations against the plain backward from
    the same bf16 pre: every gradient (float32 within 1e-4 of each one's
    largest entry, the bf16 modes within the bf16 bounds), the same bits on
    a second run, counted apart from the float32-pre K4."""
    edge_in, x_send, rec, es, wts, raw, update, prop, bf16_ops = _pre_case(
        cuda, monkeypatch, mode, flags, batch, seed=41
    )
    with torch.no_grad():
        _, _, pre = fused_edge_fwd(edge_in, x_send, rec, es, wts, raw, update, prop,
                                   save_pre=True, bf16_ops=bf16_ops, pre_dtype=torch.bfloat16)
    rng = np.random.default_rng(42)
    d_aggr = torch.tensor(rng.normal(size=tuple(rec.shape)), device=cuda).to(rec.dtype)
    d_new = None
    if update and use_new_edge:
        d_new = torch.tensor(rng.normal(size=tuple(x_send.shape)), device=cuda).to(rec.dtype)

    def run():
        return fused_edge_bwd(d_aggr, d_new, pre, edge_in, x_send, rec, es, wts, raw, prop,
                              bf16_ops)

    got = []
    ticks = _ticks(lambda: got.append(run()))
    torch.cuda.synchronize()
    assert {k for k, v in ticks.items() if v} == {"K4 fused_edge_phase backward bf16 pre",
                                                  fk.FUSED_EDGE_BWD_RECEIVER.name}
    want = fk._plain_bwd(d_aggr.float(), None if d_new is None else d_new.float(),
                         edge_in.float(), x_send.float(), rec.float(), es, wts, raw, update,
                         prop, bf16_ops, pre=pre)
    flat = lambda r: [r[0], r[1], r[2], *r[3]]  # noqa: E731
    _close_grads(flat(got[0]), flat(want), mode)
    again = run()
    assert all(a is None or torch.equal(a, b) for a, b in zip(flat(got[0]), flat(again)))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(PRE_MODES))
@pytest.mark.parametrize("flags", PRE_FLAGS)
@pytest.mark.parametrize("batch,use_new_edge", [(4, True), (4, False), (3, True), (1, True),
                                                (32, True)])
def test_recomputing_backward_matches_the_saved_pre_backward(cuda, monkeypatch, mode, flags,
                                                             batch, use_new_edge):
    """K4 without a saved pre (``fused_edge_bwd_recompute.cu``) against K4
    from K3's float32 pre on the same inputs: in float32 every gradient
    within 1e-6 of its largest entry (the recompute forms pre with
    mma.sync where K3 used wgmma: the same operands, another tensor-core
    instruction); with bf16 operands within the bf16 bounds (a last-bit
    difference of pre can move a bf16 rounding). Also against the plain
    backward that recomputes pre (1e-4 in float32, the bf16 bounds).
    Counted apart, and the same bits on a second run."""
    edge_in, x_send, rec, es, wts, raw, update, prop, bf16_ops = _pre_case(
        cuda, monkeypatch, mode, flags, batch, seed=43
    )
    with torch.no_grad():
        _, _, pre = fused_edge_fwd(edge_in, x_send, rec, es, wts, raw, update, prop,
                                   save_pre=True, bf16_ops=bf16_ops)
    rng = np.random.default_rng(44)
    d_aggr = torch.tensor(rng.normal(size=tuple(rec.shape)), device=cuda).to(rec.dtype)
    d_new = None
    if update and use_new_edge:
        d_new = torch.tensor(rng.normal(size=tuple(x_send.shape)), device=cuda).to(rec.dtype)

    def run(saved):
        return fused_edge_bwd(d_aggr, d_new, saved, edge_in, x_send, rec, es, wts, raw, prop,
                              bf16_ops)

    got = []
    ticks = _ticks(lambda: got.append(run(None)))
    torch.cuda.synchronize()
    assert {k for k, v in ticks.items() if v} == {"K4 fused_edge_phase backward recompute",
                                                  fk.FUSED_EDGE_BWD_RECEIVER.name}
    flat = lambda r: [r[0], r[1], r[2], *r[3]]  # noqa: E731
    _close_grads(flat(got[0]), flat(run(pre)), mode, tol=1e-6)
    assert all(a is None or torch.equal(a, b) for a, b in zip(flat(got[0]), flat(run(None))))
    want = fk._plain_bwd(d_aggr.float(), None if d_new is None else d_new.float(),
                         edge_in.float(), x_send.float(), rec.float(), es, wts, raw, update,
                         prop, bf16_ops)  # the plain backward recomputing pre
    _close_grads(flat(got[0]), flat(want), mode)


@pytest.mark.cuda
@pytest.mark.parametrize("pre_mode", ["on", "bf16", "off"])
def test_fused_edge_phase_follows_cache_pre(cuda, monkeypatch, pre_mode):
    """``fused_edge_phase`` under ``NEURAL_LAM_TPU_CACHE_PRE``: K3 saves a
    float32 pre (``on``), a bf16 one (``bf16``) or none (``off``), by a
    spy on its launcher, and the backward runs the matching K4; the
    gradients equal those of ``on`` within 1e-6 (``off``) or 1e-2
    (``bf16``, the rounding of pre) of each one's largest entry."""
    grads, saved = {}, []
    launcher = fk.fused_edge_fwd

    def spy(*args, **kw):
        out = launcher(*args, **kw)
        saved.append(None if out[2] is None else out[2].dtype)
        return out

    monkeypatch.setattr(fk, "fused_edge_fwd", spy)
    for mode in ("on", pre_mode):
        monkeypatch.setenv("NEURAL_LAM_TPU_CACHE_PRE", mode)
        (edge_mlp, edge_rep, x_send, rec, es), kw, leaves = _bf16_phase_case(
            cuda, "bf16", FLAGS[2], 4, seed=45, grad=True
        )
        edge_mlp.float()
        leaves = [t.detach().float().requires_grad_(True) for t in (x_send, rec, edge_rep)]
        leaves += list(edge_mlp.parameters())
        out = fused_edge_phase(edge_mlp, leaves[2], leaves[0], leaves[1], es, **kw)
        loss = (out[0] * out[0]).sum() + out[1].sin().sum()
        ticks = _ticks(lambda: grads.__setitem__(mode, torch.autograd.grad(loss, leaves)))
    want_k4 = {"on": "K4 fused_edge_phase backward",
               "bf16": "K4 fused_edge_phase backward bf16 pre",
               "off": "K4 fused_edge_phase backward recompute"}[pre_mode]
    assert {k for k, v in ticks.items() if v} == {want_k4, fk.FUSED_EDGE_BWD_RECEIVER.name}
    want_pre = {"on": torch.float32, "bf16": torch.bfloat16, "off": None}[pre_mode]
    assert saved == [torch.float32, want_pre]
    tol = {"on": 0.0, "bf16": 1e-2, "off": 1e-6}[pre_mode]
    for g, w in zip(grads[pre_mode], grads["on"]):
        assert (g - w).abs().max().item() <= tol * max(w.abs().max().item(), 1e-30)


# -- the bf16 variants of K7 and K8 -------------------------------------------


def _v2_bf16_case(cuda, monkeypatch, mode, flags, batch, seed):
    """``_v2_case`` in ``mode``'s dtype: node rows, edge input and MLPs of
    one v2 call, the leaves, and the loss weights."""
    dtype = _bf16_mode(monkeypatch, mode)
    edge_mode, update, ln = flags
    rng = np.random.default_rng(seed)
    n_send, n_rec = 70, 50
    snd = rng.integers(0, n_send - 1, 900)  # sender n_send - 1 sends nothing
    es, _ = make_edge_set(snd, rng.integers(0, n_rec - 5, 900), num_rec=n_rec,
                          num_send=n_send)
    es = es.to(cuda)
    edge_mlp, emb, send, rec, edge_rep, feats, _, w_aggr, w_edge = _v2_case(
        rng, cuda, es, n_send, n_rec, edge_mode, batch, ln, seed=seed
    )
    edge_mlp = edge_mlp.to(dtype)
    emb = None if emb is None else emb.to(dtype)
    cast = lambda t: None if t is None else t.detach().to(dtype).requires_grad_(  # noqa: E731
        t.requires_grad)
    send, rec, edge_rep, feats = cast(send), cast(rec), cast(edge_rep), cast(feats)
    leaves = [send, rec] + ([edge_rep] if edge_rep is not None else [])
    leaves += list(edge_mlp.parameters()) + (list(emb.parameters()) if emb else [])
    return edge_mlp, emb, send, rec, edge_rep, feats, leaves, w_aggr, w_edge, es


def _v2_bf16_plain(edge_mlp, edge_rep, send, rec, es, emb, feats, update):
    """The plain reference under the current precision: the node
    projections as ``fused_edge_phase_v2`` forms them, then K7's plain
    version (autograd through both is K8's and K2's)."""
    bf16_ops, io = fk.fused_precision(rec.dtype)
    w1 = edge_mlp[0].weight.float()
    d = w1.shape[0]
    return fused_edge_phase_v2_plain(
        edge_mlp, edge_rep, fk._projection(send, w1[:, d : 2 * d], bf16_ops, io),
        fk._projection(rec, w1[:, 2 * d :], bf16_ops, io), es.senders, es.receivers, emb,
        feats, update, out_dtype=rec.dtype,
    )


def _v2_counters(mode):
    if mode == "high-kernels":
        return "K7 fused_edge_phase_v2 bf16 operands", "K8 fused_edge_phase_v2 backward bf16 operands"
    return "K7 fused_edge_phase_v2 bf16", "K8 fused_edge_phase_v2 backward bf16"


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(BF16_MODES))
@pytest.mark.parametrize("flags", V2_FLAGS)
@pytest.mark.parametrize("batch", [4, 1, 32])
def test_fused_edge_phase_v2_bf16_matches_plain(cuda, monkeypatch, mode, flags, batch):
    """K7's bf16-operand instantiations (bf16 streams; float32 streams
    under ``high-kernels``) through ``fused_edge_phase_v2`` against the
    plain version: the aggregate and the updated edges in the receiver
    rows' dtype, receivers without edges 0; counted apart from K7."""
    edge_mlp, emb, send, rec, edge_rep, feats, _, _, _, es = _v2_bf16_case(
        cuda, monkeypatch, mode, flags, batch, seed=46
    )
    got = []
    with torch.no_grad():
        ticks = _ticks(lambda: got.append(fused_edge_phase_v2(
            edge_mlp, edge_rep, send, rec, es, embedder=emb, edge_feats=feats,
            update_edges=flags[1])))
        torch.cuda.synchronize()
        want = _v2_bf16_plain(edge_mlp, edge_rep, send, rec, es, emb, feats, flags[1])
    assert {k for k, v in ticks.items() if v} == {_v2_counters(mode)[0]}
    got = got[0]
    assert got[0].dtype == rec.dtype
    _close_bf16(got[0], want[0], "aggr")
    assert torch.all(got[0][-5:] == 0)
    if flags[1]:
        _close_bf16(got[1], want[1], "new_edge")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(BF16_MODES))
@pytest.mark.parametrize("flags", V2_FLAGS)
@pytest.mark.parametrize("batch,use_new_edge", [(4, True), (4, False), (1, True), (32, True)])
def test_fused_edge_phase_v2_bf16_backward_matches_plain(cuda, monkeypatch, mode, flags,
                                                        batch, use_new_edge):
    """K8's bf16-operand instantiations, with K2 on ``d_pre`` in the
    streams' dtype and the projections' backward, against autograd of the
    plain version: every node, edge and weight gradient in its dtype, a
    sender without edges zero, the same bits on a second run."""
    edge_mlp, emb, send, rec, edge_rep, feats, leaves, w_aggr, w_edge, es = _v2_bf16_case(
        cuda, monkeypatch, mode, flags, batch, seed=47
    )

    def loss(out):
        total = (out[0].float() * w_aggr).sum()
        if flags[1] and use_new_edge:
            total = total + (out[1].float() * w_edge).sum()
        return total

    def run():
        out = fused_edge_phase_v2(edge_mlp, edge_rep, send, rec, es, embedder=emb,
                                  edge_feats=feats, update_edges=flags[1])
        return torch.autograd.grad(loss(out), leaves)

    got = []
    ticks = _ticks(lambda: got.append(run()))
    torch.cuda.synchronize()
    k2 = "K2 sender_scatter bf16" if mode != "high-kernels" else "K2 sender_scatter"
    assert {k for k, v in ticks.items() if v} == {*_v2_counters(mode), k2}
    want = torch.autograd.grad(
        loss(_v2_bf16_plain(edge_mlp, edge_rep, send, rec, es, emb, feats, flags[1])), leaves
    )
    for i, (g, w) in enumerate(zip(got[0], want)):
        _close_bf16(g, w, f"gradient {i}")
    assert torch.all(got[0][0][-1] == 0)
    assert all(torch.equal(a, b) for a, b in zip(got[0], run()))


@pytest.mark.cuda
def test_v2_bf16_kernels_off_keeps_the_float32_kernels(cuda, monkeypatch):
    """``NEURAL_LAM_TPU_BF16_KERNELS=off`` on the v2 route: bf16 inputs
    reach K7 and K8 as float32 (casts at their boundary), the outputs and
    gradients are bf16, as in the JAX package."""
    edge_mlp, emb, send, rec, edge_rep, feats, leaves, w_aggr, _, es = _v2_bf16_case(
        cuda, monkeypatch, "bf16", V2_FLAGS[2], 4, seed=48
    )
    monkeypatch.setenv("NEURAL_LAM_TPU_BF16_KERNELS", "off")

    def run():
        out = fused_edge_phase_v2(edge_mlp, edge_rep, send, rec, es, update_edges=True)
        return out, torch.autograd.grad((out[0].float() * w_aggr).sum(), leaves)

    result = []
    ticks = _ticks(lambda: result.append(run()))
    assert {k for k, v in ticks.items() if v} == {
        "K7 fused_edge_phase_v2", "K8 fused_edge_phase_v2 backward", "K2 sender_scatter"}
    (out, grads), = result
    assert out[0].dtype == torch.bfloat16
    assert all(g.dtype == t.dtype for g, t in zip(grads, leaves))
    want = _v2_bf16_plain(edge_mlp, edge_rep, send, rec, es, None, None, True)
    _close_bf16(out[0], want[0], "aggr")


# -- the node-MLP route (NEURAL_LAM_TPU_FUSED_AGGR=on): the node update after
# K3 and the node MLP's backward before K4 --------------------------------------
#
# In each precision: float32 (3xTF32, held as K3 and K4 are) and the
# bf16-operand ones (held as the bf16 K3 and K4 are, _close_bf16).

NODE_MODES = {"float32": (None, torch.float32), **BF16_MODES}
NODE_FLAGS = [
    # (edge mode, update_edges, the node MLP's LayerNorm)
    ("raw", False, True),  # g2m / m2g
    ("raw", True, True),  # m2m layer 0
    ("batched", True, True),  # m2m layers 1-3
    ("shared", True, True),  # a shared edge rep
    ("batched", False, False),  # a node MLP without LayerNorm
]


def _node_counters(mode):
    """The names of K3's, the node update's and the node backward's launch
    counts in ``mode`` (``launch_counters``)."""
    sfx = {"float32": "", "high-kernels": " bf16 operands"}.get(mode, " bf16")
    return (f"K3 fused_edge_phase{sfx}", f"K3 node update{sfx}", f"K4 node backward{sfx}")


def _node_case(cuda, monkeypatch, mode, flags, batch, seed, grad=False, degree=0):
    """One phase with the epilogue in ``mode``'s dtype: ``(args, kw,
    leaves)``; 5 receivers without edges and, with ``degree``, one
    receiver with that many."""
    if mode == "float32":
        monkeypatch.delenv("NEURAL_LAM_TPU_MATMUL_PRECISION", raising=False)
        monkeypatch.delenv("NEURAL_LAM_TPU_BF16_KERNELS", raising=False)
        dtype = torch.float32
    else:
        dtype = _bf16_mode(monkeypatch, mode)
    edge_mode, update, node_ln = flags
    rng = np.random.default_rng(seed)
    d, n_send, n_rec, n_edges = 64, 70, 50, 900
    snd = rng.integers(0, n_send, n_edges + degree)
    rcv = np.concatenate([rng.integers(0, n_rec - 5, n_edges), np.full(degree, 3)])
    es, _ = make_edge_set(snd, rcv, num_rec=n_rec, num_send=n_send)
    es = es.to(cuda)
    gen = torch.Generator().manual_seed(seed)
    edge_mlp = make_mlp([3 * d, d, d], generator=gen).to(cuda, dtype)
    aggr_mlp = make_mlp([2 * d, d, d], layer_norm=node_ln, generator=gen).to(cuda, dtype)
    embedder = make_mlp([3, d, d], generator=gen).to(cuda, dtype)

    def t(*shape, g=False):
        x = torch.tensor(rng.normal(size=shape), dtype=torch.float32, device=cuda)
        return x.to(dtype).requires_grad_(g)

    x_send, rec = t(es.num_edges, batch, d, g=grad), t(n_rec, batch, d, g=grad)
    edge_rep, feats, emb = None, None, None
    if edge_mode == "raw":
        feats, emb = t(es.num_edges, 3), embedder
    elif edge_mode == "shared":
        edge_rep = t(es.num_edges, d, g=grad)
    else:
        edge_rep = t(es.num_edges, batch, d, g=grad)
    leaves = [x_send, rec] + ([edge_rep] if edge_rep is not None else [])
    leaves += list(edge_mlp.parameters()) + list(aggr_mlp.parameters())
    leaves += list(emb.parameters()) if emb else []
    kw = dict(embedder=emb, edge_feats=feats, update_edges=update, aggr_mlp=aggr_mlp)
    return (edge_mlp, edge_rep, x_send, rec, es), kw, leaves


def _node_plain(args, kw):
    edge_mlp, edge_rep, x_send, rec, es = args
    return fused_edge_phase_plain(edge_mlp, edge_rep, x_send, rec, es.receivers,
                                  kw["embedder"], kw["edge_feats"], kw["update_edges"],
                                  aggr_mlp=kw["aggr_mlp"])


def _node_close(mode, got, want, what=""):
    if mode != "float32":
        _close_bf16(got, want, what)
        return
    assert got.dtype == want.dtype, what
    scale = max(want.abs().max().item(), 1.0)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * scale, msg=what)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(NODE_MODES))
@pytest.mark.parametrize("flags", NODE_FLAGS)
@pytest.mark.parametrize("batch", [4, 1, 32])
def test_node_epilogue_matches_plain(cuda, monkeypatch, mode, flags, batch):
    """K3 and the node update after it against the plain version: the node
    update (receivers without edges too: ``rec + MLP([rec, 0])``) and the
    updated edges, in the receiver rows' dtype; the same bits on a second
    call; one launch of K3 and one of the node update, nothing else."""
    args, kw, _ = _node_case(cuda, monkeypatch, mode, flags, batch, seed=50)
    k3, counter, _ = _node_counters(mode)
    with torch.no_grad():
        result = []
        ticks = _ticks(lambda: result.append(fused_edge_phase(*args, **kw)))
        (got,) = result
        want = _node_plain(args, kw)
        again = fused_edge_phase(*args, **kw)
    torch.cuda.synchronize()
    assert {k: v for k, v in ticks.items() if v} == {k3: 1, counter: 1}
    assert got[0].dtype == args[3].dtype
    _node_close(mode, got[0], want[0], "node update")
    if flags[1]:
        _node_close(mode, got[1], want[1], "new_edge")
    assert all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(NODE_MODES))
@pytest.mark.parametrize("flags", NODE_FLAGS)
@pytest.mark.parametrize("batch,use_new_edge", [(4, True), (4, False), (1, True), (32, True)])
def test_node_backward_matches_plain(cuda, monkeypatch, mode, flags, batch, use_new_edge):
    """The node backward, then K4, against autograd of the plain version:
    every input and weight gradient (the node MLP's seven included), in the
    input's or weight's dtype; the same bits on a second run; each kernel
    launched once."""
    args, kw, leaves = _node_case(cuda, monkeypatch, mode, flags, batch, seed=51, grad=True)
    rec, x_send = args[3], args[2]
    rng = np.random.default_rng(52)
    w_node = torch.tensor(rng.normal(size=tuple(rec.shape)), device=cuda).float()
    w_edge = torch.tensor(rng.normal(size=tuple(x_send.shape)), device=cuda).float()

    def loss(out):
        total = (out[0].float() * w_node).sum()
        if flags[1] and use_new_edge:
            total = total + (out[1].float() * w_edge).sum()
        return total

    def run():
        return torch.autograd.grad(loss(fused_edge_phase(*args, **kw)), leaves)

    _, _, node_bwd = _node_counters(mode)
    result = []
    ticks = _ticks(lambda: result.append(run()))
    torch.cuda.synchronize()
    assert ticks[node_bwd] == 1
    assert sum(v for k, v in ticks.items() if k.startswith("K4 fused_edge_phase")) == 1
    (got,) = result
    want = torch.autograd.grad(loss(_node_plain(args, kw)), leaves)
    for i, (g, w) in enumerate(zip(got, want)):
        _node_close(mode, g, w, f"gradient {i}")
    assert all(torch.equal(a, b) for a, b in zip(got, run()))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(NODE_MODES))
def test_node_epilogue_degree_400(cuda, monkeypatch, mode):
    """A receiver with 400 edges more (a chunk that spans many tiles) beside
    receivers without edges: the node update and every gradient against the
    plain version."""
    args, kw, leaves = _node_case(cuda, monkeypatch, mode, NODE_FLAGS[2], 4, seed=53,
                                  grad=True, degree=400)
    got = fused_edge_phase(*args, **kw)
    want = _node_plain(args, kw)
    _node_close(mode, got[0], want[0], "node update")
    # a random seed: with ones, the LayerNorm's gradient sums to 0 and the
    # inputs' gradients are rounding noise
    seed = torch.randn(tuple(got[0].shape), device=cuda)
    g_got = torch.autograd.grad((got[0].float() * seed).sum(), leaves)
    g_want = torch.autograd.grad((want[0].float() * seed).sum(), leaves)
    for i, (g, w) in enumerate(zip(g_got, g_want)):
        _node_close(mode, g, w, f"gradient {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(NODE_MODES))
def test_node_launchers_match_their_plain_versions(cuda, monkeypatch, mode):
    """The launchers as ``chip_smoke.py`` calls them: K3 writes the
    aggregate in float32 beside updated edges in the outputs' dtype, the
    values of K3's own float32 aggregate and new edges; the node update on
    it against ``_plain_node``; the node backward against
    ``_plain_node_bwd`` from the same aggregate, its ``d_aggr`` in the
    streams' dtype."""
    args, kw, _ = _node_case(cuda, monkeypatch, mode, NODE_FLAGS[2], 4, seed=54)
    edge_mlp, edge_rep, x_send, rec, es = args
    bf16_ops, io = fk.fused_precision(rec.dtype)
    edge_in, x_io, rec_io, wts = fk._kernel_inputs(edge_mlp, None, edge_rep, None, io,
                                                   x_send, rec)
    nw = [w if w is None else w.float() for w in fk._node_weights(kw["aggr_mlp"])]
    out = torch.float32 if mode != "bf16" else torch.bfloat16
    with torch.no_grad():
        aggr, new_edge, pre = fused_edge_fwd(
            edge_in, x_io, rec_io, es, wts, False, True, False, bf16_ops=bf16_ops,
            out_dtype=out if bf16_ops else None, aggr_dtype=torch.float32)
        base = fused_edge_fwd(edge_in, x_io, rec_io, es, wts, False, True, False,
                              bf16_ops=bf16_ops, out_dtype=torch.float32 if bf16_ops else None)
        assert pre is None and aggr.dtype == torch.float32 and new_edge.dtype == out
        assert torch.equal(aggr, base[0]) and torch.equal(new_edge, base[1].to(out))
        node = fk.fused_node_fwd(rec_io, aggr, nw, bf16_ops, out if bf16_ops else None)
        want = fk._plain_node(rec_io.float(), aggr, nw, bf16_ops).to(out)
        gen = torch.Generator(device=cuda).manual_seed(55)
        d_node = torch.randn(tuple(rec.shape), device=cuda, generator=gen).to(io)
        d_aggr, d_rec, grads = fk.fused_node_bwd(d_node, rec_io, aggr, nw, bf16_ops)
        w_aggr, w_rec, w_grads = fk._plain_node_bwd(d_node.float(), rec_io.float(), aggr, nw,
                                                     bf16_ops)
        with pytest.raises(TypeError, match="need bf16_ops"):
            fk.fused_node_bwd(d_node.bfloat16(), rec_io.bfloat16(), aggr, nw, False)
        with pytest.raises(TypeError, match="need bf16_ops"):
            fk.fused_node_fwd(rec_io.bfloat16(), aggr, nw, False)
    assert node.dtype == out and d_aggr.dtype == io and d_rec.dtype == torch.float32
    _node_close(mode if bf16_ops else "float32", node, want, "node update")
    # bf16 operands: d_pre, rounded to bf16 as an operand, can land one bf16
    # ulp apart in kernel and plain version (the bounds above)
    _node_close(mode if bf16_ops else "float32", d_aggr, w_aggr.to(io), "d_aggr")
    for i, (g, w) in enumerate(zip([d_rec, *grads], [w_rec, *w_grads])):
        if w is not None:
            _node_close(mode if bf16_ops else "float32", g, w, f"node gradient {i}")


# (receivers, batch) of the row kernels' cases: rows 0, 1, 63, 64, 65 (and
# 64 at batch 32), three tiles at batch 32, and 601 tiles, more than either
# kernel's grid has blocks or warpgroups on an H100
NODE_ROWS = [(0, 4), (1, 1), (63, 1), (16, 4), (65, 1), (2, 32), (3, 32), (9_601, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(NODE_MODES))
@pytest.mark.parametrize("n_rec,batch", NODE_ROWS)
@pytest.mark.parametrize("node_ln", [True, False])
def test_node_row_kernels_match_plain(cuda, monkeypatch, mode, n_rec, batch, node_ln):
    """The node update and the node backward alone, on (receiver, b) rows
    with no graph: against ``_plain_node`` and ``_plain_node_bwd`` (the
    update, ``d_aggr``, ``d_rec`` and the seven weight gradients), the same
    bits on a second launch, one launch of each (none without rows, whose
    gradients are zeros)."""
    if mode == "float32":
        monkeypatch.delenv("NEURAL_LAM_TPU_MATMUL_PRECISION", raising=False)
        dtype = torch.float32
    else:
        dtype = _bf16_mode(monkeypatch, mode)
    bf16_ops, io = fk.fused_precision(dtype)
    out = dtype
    rng = np.random.default_rng(60 + n_rec)
    d = 64

    def t(*shape, scale=1.0, dt=torch.float32):
        return torch.tensor(scale * rng.normal(size=shape), dtype=torch.float32,
                            device=cuda).to(dt)

    rec, d_node = t(n_rec, batch, d, dt=io), t(n_rec, batch, d, dt=io)
    aggr = t(n_rec, batch, d, scale=3.0)  # a sum of messages
    aggr_mlp = make_mlp([2 * d, d, d], layer_norm=node_ln,
                        generator=torch.Generator().manual_seed(61)).to(cuda)
    nw = [w if w is None else w.float() for w in fk._node_weights(aggr_mlp)]
    _, fwd_count, bwd_count = _node_counters(mode)
    with torch.no_grad():
        got = []
        ticks = _ticks(lambda: got.append((fk.fused_node_fwd(rec, aggr, nw, bf16_ops, out),
                                           fk.fused_node_bwd(d_node, rec, aggr, nw, bf16_ops))))
        (node, (d_aggr, d_rec, grads)), = got
        again = fk.fused_node_fwd(rec, aggr, nw, bf16_ops, out)
        again_bwd = fk.fused_node_bwd(d_node, rec, aggr, nw, bf16_ops)
        want = fk._plain_node(rec.float(), aggr, nw, bf16_ops).to(out)
        w_aggr, w_rec, w_grads = fk._plain_node_bwd(d_node.float(), rec.float(), aggr, nw,
                                                     bf16_ops)
    torch.cuda.synchronize()
    live = n_rec * batch > 0
    assert {k: v for k, v in ticks.items() if v} == (
        {fwd_count: 1, bwd_count: 1} if live else {})
    assert node.dtype == out and d_aggr.dtype == io and d_rec.dtype == torch.float32
    assert [g is None for g in grads] == [w is None for w in nw]
    flat = [node, d_aggr, d_rec, *(g for g in grads if g is not None)]
    flat_again = [again, again_bwd[0], again_bwd[1], *(g for g in again_bwd[2] if g is not None)]
    assert all(torch.equal(a, b) for a, b in zip(flat, flat_again))
    if not live:
        assert all(torch.count_nonzero(g) == 0 for g in grads if g is not None)
        return
    close = mode if bf16_ops else "float32"
    _node_close(close, node, want, "node update")
    _node_close(close, d_aggr, w_aggr.to(io), "d_aggr")
    for i, (g, w) in enumerate(zip([d_rec, *grads], [w_rec, *w_grads])):
        if w is not None:
            _node_close(close, g, w, f"node gradient {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(NODE_MODES))
@pytest.mark.parametrize("kind", ["mesh", "down", "up", "top"])
def test_node_route_on_level_set_shapes(cuda, monkeypatch, mode, kind):
    """The whole phase under the node-MLP route (K3, the node update; the
    node backward, K4) on edge sets shaped like the hierarchical models'
    level sets (degree 1 down, 9 up, a 40-edge top level, a 400-edge
    receiver beside receivers without edges), batch 4: the node update, the
    new edges and every gradient against autograd of the plain version."""
    if mode == "float32":
        monkeypatch.delenv("NEURAL_LAM_TPU_MATMUL_PRECISION", raising=False)
        dtype = torch.float32
    else:
        dtype = _bf16_mode(monkeypatch, mode)
    es, n_send, n_rec = _degree_edge_set(kind, cuda)
    rng = np.random.default_rng(62)
    d, batch = 64, 4
    gen = torch.Generator().manual_seed(63)
    edge_mlp = make_mlp([3 * d, d, d], generator=gen).to(cuda, dtype)
    aggr_mlp = make_mlp([2 * d, d, d], generator=gen).to(cuda, dtype)

    def t(*shape, grad=True):
        x = torch.tensor(rng.normal(size=shape), dtype=torch.float32, device=cuda)
        return x.to(dtype).requires_grad_(grad)

    x_send, rec, edge = (t(es.num_edges, batch, d), t(n_rec, batch, d),
                         t(es.num_edges, batch, d))
    leaves = [x_send, rec, edge] + list(edge_mlp.parameters()) + list(aggr_mlp.parameters())
    w_node, w_edge = t(n_rec, batch, d, grad=False), t(es.num_edges, batch, d, grad=False)
    kw = dict(update_edges=True, aggr_mlp=aggr_mlp)

    def loss(out):
        return (out[0].float() * w_node.float()).sum() + (out[1].float() * w_edge.float()).sum()

    got = fused_edge_phase(edge_mlp, edge, x_send, rec, es, **kw)
    want = fused_edge_phase_plain(edge_mlp, edge, x_send, rec, es.receivers, **kw)
    _node_close(mode, got[0], want[0], "node update")
    _node_close(mode, got[1], want[1], "new_edge")
    for i, (g, w) in enumerate(zip(torch.autograd.grad(loss(got), leaves),
                                   torch.autograd.grad(loss(want), leaves))):
        _node_close(mode, g, w, f"gradient {i}")


@pytest.mark.cuda
def test_captured_step_with_the_node_epilogue_matches_eager(cuda, tmp_path, monkeypatch):
    """GraphLAM's step under ``NEURAL_LAM_TPU_FUSED_AGGR=on`` through the
    captured graph against five eager steps, bit for bit; the capture
    launched the node update and the node backward beside K3 and K4, as
    often as K3 (every phase of GraphLAM takes the route); turning the
    variable off captures a graph of its own with K3 and K4 alone."""
    monkeypatch.setenv("NEURAL_LAM_TPU_FUSED_AGGR", "on")
    make_trainer, batches = _train_setup(tmp_path, cuda, "graph_lam", monkeypatch)
    data = batches(6)
    eager, captured = make_trainer(), make_trainer()
    want = [eager.train_step(*b).item() for b in data[:5]]
    step = captured.make_train_step()
    got = []
    first = _ticks(lambda: got.append(step(*data[0]).item()))
    got += [step(*b).item() for b in data[1:5]]
    assert got == want and np.isfinite(got).all()
    assert first["K3 node update"] == first["K3 fused_edge_phase"] > 0
    assert first["K4 node backward"] == first["K4 fused_edge_phase backward"] > 0
    monkeypatch.setenv("NEURAL_LAM_TPU_FUSED_AGGR", "off")
    want.append(eager.train_step(*data[5]).item())
    off = _ticks(lambda: got.append(step(*data[5]).item()))
    assert len(captured.graphs) == 2
    assert off["K3 fused_edge_phase"] > 0
    assert off["K3 node update"] == off["K4 node backward"] == 0
    np.testing.assert_allclose(got, want, rtol=1e-6)


# -- spatial partitioning and the stencil route ------------------------------------


def _spatial_trainer(ds, weights, device, graph="multiscale", **trainer_kw):
    model = GraphLAM(ds, hidden_dim=64, processor_layers=2, graph_name=graph, device=device)
    model.load_state_dict(weights)
    config = NeuralLAMConfig(datastore=DatastoreSelection(kind="dummydata", config_path=""))
    return Trainer(ARForecaster(model, ds), config, ds, TrainingArgs(batch_size=2),
                   device=device, **trainer_kw)


@pytest.mark.cuda
def test_sharded_step_at_one_shard_on_the_card_matches_the_cpu(cuda, tmp_path, monkeypatch):
    """The sharded executor at ``S = 1`` in an NCCL group of one: the
    captured step (its loss, gradients and AdamW in one graph, the
    executor's local model and masked loss inside) over 3 steps against
    the same executor on the CPU (losses 1e-5, the first step's gradients
    2e-4 of their largest entry, the training gate's bounds), and against
    the card's replicated step in the same group bit for bit (one shard
    exchanges nothing)."""
    from neural_lam_tpu_torch.convert_checkpoint import grads_to_numpy

    make_trainer, batches = _train_setup(tmp_path, cuda, "graph_lam", monkeypatch)
    ds = make_trainer().datastore
    weights = make_trainer().forecaster.predictor.state_dict()
    cpu_weights = {k: v.cpu() for k, v in weights.items()}
    data = batches(3)
    cpu = _spatial_trainer(ds, cpu_weights, "cpu", spatial_shards=1)
    want = [cpu.train_step(*data[0]).item()]
    want_g = grads_to_numpy(cpu.forecaster.predictor)
    want += [cpu.train_step(*b).item() for b in data[1:]]
    with _process_group("nccl", monkeypatch):
        sharded = _spatial_trainer(ds, weights, cuda, spatial_shards=1)
        step = sharded.make_train_step()
        got = [step(*data[0]).item()]
        got_g = grads_to_numpy(sharded.forecaster.predictor)
        got += [step(*b).item() for b in data[1:]]
        assert len(sharded.graphs) == 1
        replicated = _spatial_trainer(ds, weights, cuda)
        rep_step = replicated.make_train_step()
        assert [rep_step(*b).item() for b in data] == got
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for key, w in want_g.items():
        assert np.abs(got_g[key] - w).max() <= 2e-4 * max(np.abs(w).max(), 1e-30), key


@pytest.mark.cuda
def test_stencil_route_on_the_card_matches_the_cpu(cuda, tmp_path, monkeypatch):
    """GraphLAM under ``NEURAL_LAM_TPU_STENCIL=on`` on the 27x27 multiscale
    mesh: the loss and every gradient of a step on the card against the
    CPU (1e-4 of the largest entry), and the captured step gives the eager
    step's losses bit for bit."""
    from neural_lam_tpu_torch.convert_checkpoint import grads_to_numpy

    monkeypatch.setenv("NEURAL_LAM_TPU_STENCIL", "on")
    ds = DummyDatastore(root_path=tmp_path, n_grid_x=27, n_grid_y=27, n_timesteps=12)
    create_graph_from_datastore(ds, tmp_path / "graph" / "multiscale")
    torch.manual_seed(0)
    weights = GraphLAM(ds, hidden_dim=64, processor_layers=2, device="cpu").state_dict()
    rng = np.random.default_rng(3)
    n, f = ds.num_grid_points, 3 * ds.get_num_data_vars("forcing")
    data = [tuple(rng.normal(size=s).astype(np.float32)
                  for s in ((2, 2, n, 3), (2, 1, n, 3), (2, 1, n, f))) for _ in range(3)]
    runs = {}
    for device in ("cpu", cuda):
        trainer = _spatial_trainer(ds, weights, device)
        assert trainer.forecaster.predictor._m2m_stencil() is not None
        loss = trainer.train_step(*data[0]).item()
        runs[str(device)] = (loss, grads_to_numpy(trainer.forecaster.predictor))
    (want, want_g), (got, got_g) = runs["cpu"], runs[str(cuda)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for key, w in want_g.items():
        assert np.abs(got_g[key] - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-30), key
    eager, captured = (_spatial_trainer(ds, weights, cuda) for _ in range(2))
    step = captured.make_train_step()
    assert [step(*b).item() for b in data] == [eager.train_step(*b).item() for b in data]


# -- K3's and K4's bf16-operand instantiations on bf16 fragments
# (csrc/tc_bf16.cuh): wgmma and mma.sync at k16, bf16 weights and tiles ----
#
# Each instantiation against its plain version over the edge cases: five
# receivers without edges and one of 400 edges (a chunk over many tiles), a
# shared unbatched edge rep, the raw embedder, update_edges and
# propagation, batch 1, 2, 3, 4 and 32, bf16 and float32 streams, and each
# pre that K3 saves for K4 (float32, bf16, none). The bounds are the bf16
# ones of the tests above: the same function as before, in another order of
# the tensor cores' sums.

BF_STREAM_MODES = ["bf16", "high-kernels"]  # bf16 streams; float32 streams
BF_CASES = [
    # (edge mode, update_edges, propagation)
    ("raw", False, False),  # g2m / m2g
    ("raw", True, False),  # m2m layer 0
    ("batched", True, True),
    ("shared", True, False),  # a shared edge rep
    ("raw", False, True),  # PropagationNet
]
BF_PRE = {"on": torch.float32, "bf16": torch.bfloat16, "off": None}


def _bf_case(cuda, monkeypatch, mode, flags, batch, seed):
    """The kernel arguments of one phase in ``mode``'s streams over 1,300
    edges into 50 receivers (five without edges, one with 400 more):
    ``(edge_in, x_send, rec, es, wts, raw, update, prop, bf16_ops)``."""
    dtype = _bf16_mode(monkeypatch, mode)
    edge_mode, update, prop = flags
    rng = np.random.default_rng(seed)
    d, n_send, n_rec = 64, 70, 50
    snd = rng.integers(0, n_send, 1300)
    rcv = np.concatenate([rng.integers(0, n_rec - 5, 900), np.full(400, 3)])
    es, _ = make_edge_set(snd, rcv, num_rec=n_rec, num_send=n_send)
    es = es.to(cuda)
    gen = torch.Generator().manual_seed(seed)
    edge_mlp = make_mlp([3 * d, d, d], generator=gen)
    embedder = make_mlp([3, d, d], generator=gen) if edge_mode == "raw" else None
    # the weights as a bf16 model holds them
    wts = [None if w is None else w.detach().to(dtype).float().to(cuda)
           for w in _weights(edge_mlp, embedder)]
    bf16_ops, io = fk.fused_precision(dtype)
    assert bf16_ops

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32, device=cuda).to(io)

    x_send, rec = t(es.num_edges, batch, d), t(n_rec, batch, d)
    if edge_mode == "raw":
        edge_in = t(es.num_edges, 3)
    elif edge_mode == "shared":
        edge_in = t(es.num_edges, d)
    else:
        edge_in = t(es.num_edges, batch, d)
    return edge_in, x_send, rec, es, wts, edge_mode == "raw", update, prop, bf16_ops


@pytest.mark.cuda
@pytest.mark.parametrize("mode", BF_STREAM_MODES)
@pytest.mark.parametrize("pre", list(BF_PRE))
@pytest.mark.parametrize("flags", BF_CASES)
@pytest.mark.parametrize("batch", [1, 2, 3, 4, 32])
def test_bf16_fragments_forward_matches_plain(cuda, monkeypatch, mode, pre, flags, batch):
    """K3's BF instantiations (each stream type, each pre type) against
    the plain version: the aggregate (0 for receivers without edges), the
    updated edges and the saved pre (a bf16 one is the float32 one rounded);
    the same bits on a second launch."""
    edge_in, x_send, rec, es, wts, raw, update, prop, bf16_ops = _bf_case(
        cuda, monkeypatch, mode, flags, batch, seed=60
    )
    pre_dtype = BF_PRE[pre]

    def run():
        with torch.no_grad():
            return fused_edge_fwd(edge_in, x_send, rec, es, wts, raw, update, prop,
                                  save_pre=pre_dtype is not None, bf16_ops=bf16_ops,
                                  pre_dtype=pre_dtype or torch.float32)

    got = run()
    torch.cuda.synchronize()
    want = fk._plain(edge_in.float(), x_send.float(), rec.float(), es.receivers, wts, raw,
                     update, prop, bf16_ops=True, return_pre=True)
    assert got[0].dtype == rec.dtype
    _close_bf16(got[0], want[0].to(rec.dtype), "aggr")
    assert torch.all(got[0][-5:] == 0)
    if update:
        _close_bf16(got[1], want[1].to(rec.dtype), "new_edge")
    if pre_dtype is None:
        assert got[2] is None
    else:
        assert got[2].dtype == pre_dtype
        _close_bf16(got[2].float(), want[2], "pre")
    again = run()
    assert all(a is None or torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", BF_STREAM_MODES)
@pytest.mark.parametrize("pre", list(BF_PRE))
@pytest.mark.parametrize("flags", BF_CASES)
@pytest.mark.parametrize("batch", [1, 2, 3, 4, 32])
def test_bf16_fragments_backward_matches_plain(cuda, monkeypatch, mode, pre, flags, batch):
    """K4's BF main kernel from a float32 pre, a bf16 pre or recomputing
    it, against the plain backward from the same pre (or recomputing it):
    every input and weight gradient, the same bits on a second run, and the
    launch counted by its instantiation."""
    edge_in, x_send, rec, es, wts, raw, update, prop, bf16_ops = _bf_case(
        cuda, monkeypatch, mode, flags, batch, seed=61
    )
    pre_dtype = BF_PRE[pre]
    saved = None
    if pre_dtype is not None:
        with torch.no_grad():
            saved = fused_edge_fwd(edge_in, x_send, rec, es, wts, raw, update, prop,
                                   save_pre=True, bf16_ops=bf16_ops, pre_dtype=pre_dtype)[2]
    rng = np.random.default_rng(62)
    d_aggr = torch.tensor(rng.normal(size=tuple(rec.shape)), device=cuda).to(rec.dtype)
    d_new = None
    if update:
        d_new = torch.tensor(rng.normal(size=tuple(x_send.shape)), device=cuda).to(rec.dtype)

    def run():
        return fused_edge_bwd(d_aggr, d_new, saved, edge_in, x_send, rec, es, wts, raw, prop,
                              bf16_ops)

    got = []
    ticks = _ticks(lambda: got.append(run()))
    torch.cuda.synchronize()
    counter = {"on": fk.FUSED_EDGE_BWD_BF16_OPS if mode == "high-kernels"
               else fk.FUSED_EDGE_BWD_BF16,
               "bf16": fk.FUSED_EDGE_BWD_BF16_PRE, "off": fk.FUSED_EDGE_BWD_RECOMPUTE}[pre]
    assert {k for k, v in ticks.items() if v} == {counter.name, fk.FUSED_EDGE_BWD_RECEIVER.name}
    want = fk._plain_bwd(d_aggr.float(), None if d_new is None else d_new.float(),
                         edge_in.float(), x_send.float(), rec.float(), es, wts, raw, update,
                         prop, bf16_ops, pre=saved)
    flat = lambda r: [r[0], r[1], r[2], *r[3]]  # noqa: E731
    _close_grads(flat(got[0]), flat(want), mode)
    again = run()
    assert all(a is None or torch.equal(a, b) for a, b in zip(flat(got[0]), flat(again)))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", BF_STREAM_MODES)
@pytest.mark.parametrize("pre", list(BF_PRE))
@pytest.mark.parametrize("flags", NODE_FLAGS)
@pytest.mark.parametrize("batch", [2, 3])
def test_bf16_fragments_node_epilogue_matches_plain(cuda, monkeypatch, mode, pre, flags, batch):
    """K3's BF instantiations on the node-MLP route (the float32 aggregate
    beside bf16 updated edges, then the node update) under each
    ``NEURAL_LAM_TPU_CACHE_PRE``, beside a receiver of 400 edges and five
    without: the node update, the updated edges and every gradient (the
    node backward, then K4) against the plain version."""
    monkeypatch.setenv("NEURAL_LAM_TPU_CACHE_PRE", pre)
    args, kw, leaves = _node_case(cuda, monkeypatch, mode, flags, batch, seed=63, grad=True,
                                  degree=400)
    _, counter, _ = _node_counters(mode)
    result = []
    ticks = _ticks(lambda: result.append(fused_edge_phase(*args, **kw)))
    (got,) = result
    assert ticks[counter] == 1
    want = _node_plain(args, kw)
    _node_close(mode, got[0], want[0], "node update")
    if flags[1]:
        _node_close(mode, got[1], want[1], "new_edge")
    seed = torch.randn(tuple(got[0].shape), device=cuda)

    def loss(out):
        total = (out[0].float() * seed).sum()
        return total + (out[1].float().sum() if flags[1] else 0.0)

    for i, (g, w) in enumerate(zip(torch.autograd.grad(loss(got), leaves),
                                   torch.autograd.grad(loss(want), leaves))):
        _node_close(mode, g, w, f"gradient {i}")


@pytest.mark.cuda
def test_float32_and_bf16_instantiations_share_no_state(cuda):
    """At the MEPS g2m shapes (100,656 edges from 63,784 grid nodes into
    6,561 mesh nodes, the raw embedder, batch 4), K3's and K4's float32
    outputs and gradients are the same bits before and after a launch of
    their bf16-operand instantiations on other inputs."""
    rng = np.random.default_rng(64)
    d, b, n_send, n_rec, n_e = 64, 4, 63_784, 6_561, 100_656
    es, _ = make_edge_set(rng.integers(0, n_send, n_e), rng.integers(0, n_rec, n_e),
                          num_rec=n_rec, num_send=n_send)
    es = es.to(cuda)
    gen = torch.Generator().manual_seed(64)
    wts = [None if w is None else w.detach().to(cuda) for w in
           _weights(make_mlp([3 * d, d, d], generator=gen), make_mlp([3, d, d], generator=gen))]

    def t(*shape, dtype=torch.float32):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32, device=cuda).to(dtype)

    def phase(dtype, ops):
        feats, x_send, rec = t(n_e, 3, dtype=dtype), t(n_e, b, d, dtype=dtype), t(n_rec, b, d,
                                                                                  dtype=dtype)
        d_aggr = t(n_rec, b, d, dtype=dtype)

        def run():
            with torch.no_grad():
                aggr, _, pre = fused_edge_fwd(feats, x_send, rec, es, wts, True, False, False,
                                              save_pre=True, bf16_ops=ops)
            d_edge, d_send, d_rec, grads = fused_edge_bwd(d_aggr, None, pre, feats, x_send,
                                                          rec, es, wts, True, False, ops)
            return [aggr, pre, d_send, d_rec] + [g for g in grads if g is not None]

        return run

    f32, bf = phase(torch.float32, False), phase(torch.bfloat16, True)
    before = [x.clone() for x in f32()]
    bf()
    after = f32()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(before, after))


@pytest.mark.cuda
def test_occupancy_rows_match_the_launches(cuda):
    """Every instantiation of K3, K7 and of K4's and K8's main kernels fits
    a block on an SM; K4's main kernels run the 3 groups a block and K8's
    the 3 (4 with bf16 operands) that the wrappers size the grids and the
    workspaces by, K7 as K3 does; ``kernel_occupancy``'s rows are the
    float32 instantiations'."""
    f32 = fk.instantiation_occupancy(bf16_ops=False)
    rows = f32 + fk.instantiation_occupancy(bf16_ops=True)
    assert all(r["blocks"] >= 1 for r in rows)
    assert all(r["threads"] == 128 * fk._GROUPS for r in rows if r["kernel"] == "K4")
    for r in rows:
        if r["kernel"] in ("K7", "K8"):
            assert r["threads"] == 128 * fk._V2_BWD_GROUPS[bool(r["bf16_ops"])], r["name"]
    keys = ("blocks", "warps", "threads", "regs", "smem")
    for kernel in ("K3", "K4", "K7", "K8"):
        occ = fk.kernel_occupancy(kernel)
        for name, mode in (("shared", 1), ("batched", 2)):
            (row,) = [r for r in f32 if r["kernel"] == kernel and r["mode"] == mode
                      and r["pre"] == "float32"]
            assert occ[name] == {k: row[k] for k in keys}


@pytest.mark.cuda
def test_node_occupancy_rows_match_the_launches(cuda):
    """Every instantiation of the node update and the node backward fits a
    block on an SM, one block an SM as the wrappers size the grids: the node
    update 3 warpgroups a block (4 with bf16 operands), the node backward a
    row warpgroup (two with bf16 operands) and a gradient warpgroup."""
    rows = fk.node_occupancy()
    assert len(rows) == 6 and all(r["blocks"] == 1 for r in rows)
    for r in rows:
        if r["name"].startswith("K3"):
            assert r["threads"] == 128 * fk._NODE_FWD_GROUPS[bool(r["bf16_ops"])]
        else:
            assert r["threads"] == 128 * (3 if r["bf16_ops"] else 2)


# -- K4's tail: the edge pass, the receiver slice, the workspace reduce ------------

# precision -> (bf16_ops, the streams' dtype)
TAIL_PRECISIONS = {
    "float32": (False, torch.float32),
    "bf16 streams": (True, torch.bfloat16),
    "bf16 operands": (True, torch.float32),
}


def _tail_weights(cuda, feat, seed=3):
    gen = torch.Generator().manual_seed(seed)
    d = 64
    edge_mlp = make_mlp([3 * d, d, d], generator=gen).to(cuda)
    embedder = make_mlp([feat, d, d], generator=gen).to(cuda) if feat else None
    return [None if w is None else w.detach() for w in _weights(edge_mlp, embedder)]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", list(TAIL_PRECISIONS))
@pytest.mark.parametrize("batch", [1, 4, 32])
@pytest.mark.parametrize("n_edges", [0, 1, 63, 64, 65, 1000])
@pytest.mark.parametrize("new_edge", [False, True])
@pytest.mark.parametrize("feat", [1, 3, 8, 0], ids=["raw1", "raw3", "raw8", "shared"])
def test_edge_pass_matches_plain(cuda, feat, new_edge, n_edges, batch, precision):
    """K4's edge pass alone (``fused_edge_bwd_edge_pass``, on the tensor
    cores) against its plain version on the same inputs: ``dW1e``, the
    shared edge input's gradient and the embedder's gradients, within 1e-4
    of each one's largest entry in float32 (3xTF32 against exact float32)
    and within the bf16 bounds with bf16 operands (the same roundings, in
    another summation order)."""
    bf16_ops, io = TAIL_PRECISIONS[precision]
    rng = np.random.default_rng(n_edges + 3 * batch + feat)
    raw = feat > 0
    weights = _tail_weights(cuda, feat)

    def t(*shape, dtype=torch.float32):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32, device=cuda).to(dtype)

    s = t(n_edges, 64)
    edge_in = t(n_edges, feat, dtype=io) if raw else t(n_edges, 64, dtype=io)
    d_new = t(n_edges, batch, 64, dtype=io) if new_edge else None
    before = fk.fused_edge_bwd_edge_pass.launches
    got = fk.fused_edge_bwd_edge_pass(s, edge_in, d_new, weights, raw, bf16_ops)
    torch.cuda.synchronize()
    assert fk.fused_edge_bwd_edge_pass.launches == before + (n_edges > 0)
    want = fk._plain_edge_pass(s, edge_in, d_new, weights, raw, bf16_ops)
    pairs = [(got[1], want[1])] + ([] if raw else [(got[0].float(), want[0])])
    pairs += [(g, w) for g, w in zip(got[2], want[2]) if w is not None]
    for i, (g, w) in enumerate(pairs):
        assert g.shape == w.shape, i
        if w.numel() == 0:
            continue
        if bf16_ops:
            _close_bf16(g.float(), w.float(), f"edge pass output {i}")
        else:
            scale = max(w.abs().max().item(), 1e-30)
            assert (g - w).abs().max().item() <= 1e-4 * scale, i
    again = fk.fused_edge_bwd_edge_pass(s, edge_in, d_new, weights, raw, bf16_ops)
    assert all(torch.equal(a, b) for a, b in zip(
        [got[1], *(g for g in got[2] if g is not None)],
        [again[1], *(g for g in again[2] if g is not None)]))


@pytest.mark.cuda
@pytest.mark.parametrize("rows_dtype", [torch.float32, torch.bfloat16], ids=["float32", "bf16"])
@pytest.mark.parametrize("n_rec,batch", [(1, 1), (50, 3), (64, 1), (1000, 4), (33, 32)])
def test_receiver_slice_matches_plain(cuda, n_rec, batch, rows_dtype):
    """K4's receiver slice alone against the two ``torch`` products it
    replaces (``_plain_receiver_slice``: float32, TF32 off), with the
    receiver rows in float32 and in bf16: 3xTF32 in both, within 2e-5 of
    the largest entry."""
    rng = np.random.default_rng(n_rec + batch)
    w1 = _tail_weights(cuda, 0)[0]
    rec = torch.tensor(rng.normal(size=(n_rec, batch, 64)), dtype=torch.float32,
                       device=cuda).to(rows_dtype)
    d_recproj = torch.tensor(rng.normal(size=(n_rec, batch, 64)), dtype=torch.float32,
                             device=cuda)
    got = fk.fused_edge_bwd_receiver_slice(d_recproj, rec, w1)
    want = fk._plain_receiver_slice(d_recproj, rec, w1)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        scale = max(w.abs().max().item(), 1e-30)
        assert (g - w).abs().max().item() <= 2e-5 * scale
    again = fk.fused_edge_bwd_receiver_slice(d_recproj, rec, w1)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("parts,stride", [(1, 1), (15, 100), (16, 64), (17, 8448),
                                          (396, 8448), (528, 4096), (3, 8960)])
def test_reduce_sums_in_block_order(cuda, parts, stride):
    """The workspace reduce gives the bits of a float32 sum over the parts
    in part order from zero (``reduce_workspace_plain``), twice."""
    gen = torch.Generator(device=cuda).manual_seed(parts)
    ws = torch.randn((parts, stride), generator=gen, device=cuda)
    got = fk.reduce_workspace(ws)
    again = fk.reduce_workspace(ws)
    want = fk.reduce_workspace_plain(ws)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(again, want)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", list(TAIL_PRECISIONS))
@pytest.mark.parametrize("mode", ["raw", "shared", "batched"])
def test_captured_k4_replays_the_same_bits(cuda, mode, precision):
    """K4 (main kernel, edge input's share, receiver slice and reduce)
    captured in a CUDA graph and replayed twice gives the eager call's bits
    each time: nothing in its launches carries state from one run to the
    next."""
    bf16_ops, io = TAIL_PRECISIONS[precision]
    rng = np.random.default_rng(40)
    d, b, n_rec = 64, 4, 60
    es, _ = _edge_set(rng, 80, n_rec, 1500, cuda, empty_rec=3)
    feat = 3 if mode == "raw" else 0
    weights = _tail_weights(cuda, feat, seed=5)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32, device=cuda).to(io)

    x_send, rec = t(es.num_edges, b, d), t(n_rec, b, d)
    edge_in = {"raw": t(es.num_edges, feat), "shared": t(es.num_edges, d),
               "batched": t(es.num_edges, b, d)}[mode]
    d_aggr, d_new = t(n_rec, b, d), t(es.num_edges, b, d)
    raw = mode == "raw"
    _, _, pre = fused_edge_fwd(edge_in, x_send, rec, es, weights, raw, True, False,
                               save_pre=True, bf16_ops=bf16_ops)

    def run():
        d_edge, d_send, d_rec, grads = fused_edge_bwd(d_aggr, d_new, pre, edge_in, x_send,
                                                      rec, es, weights, raw, False, bf16_ops)
        return [x for x in (d_edge, d_send, d_rec, *grads) if x is not None]

    eager = run()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run()  # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    for _ in range(2):
        for x in captured:
            x.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(captured, eager))


@pytest.mark.cuda
def test_tail_occupancy_rows(cuda):
    """Every piece of K4's tail fits a block on an SM in every precision,
    and the edge pass runs the groups the wrapper sizes its grid and
    workspace by."""
    rows = fk.tail_occupancy(bf16_ops=False) + fk.tail_occupancy(bf16_ops=True)
    assert len(rows) == 12 and all(r["blocks"] >= 1 for r in rows)
    for r in rows:
        if "edge pass" in r["name"]:
            assert r["threads"] == 128 * fk._EDGE_GROUPS, r


# -- K7's and K8's bf16-operand instantiations on bf16 fragments
# (csrc/tc_bf16.cuh): K7's first layer in k-slot order with sp gathered
# straight into it, wgmma and mma.sync at k16, one bf16 copy of each weight;
# K8's main kernel K4's BF chain without its sender half ---------------------
#
# Each instantiation through its launcher against its plain version, over the
# edge cases: five receivers without edges and one of 400 more edges (a chunk
# over many tiles), a sender whose sp row no edge reads (the port's edge lists
# have no dead slots: that is what one leaves behind), a shard that owns no
# edges, a shared unbatched edge rep, the raw embedder, LayerNorm on and off,
# batch 1, 2, 3, 4 and 32, bf16 and float32 streams. The bounds are the bf16
# ones of the tests above.

V2_BF_CASES = [
    # (edge mode, update_edges, LayerNorm)
    ("raw", False, True),  # g2m / m2g
    ("raw", True, True),  # m2m layer 0
    ("batched", True, True),  # m2m layers 1-3
    ("shared", True, True),  # HiLAMParallel's sections
    ("batched", False, False),
    ("raw", False, False),
]


def _v2_bf_case(cuda, monkeypatch, mode, flags, batch, seed, n_edges=1300):
    """The launcher arguments of one v2 call in ``mode``'s streams, over
    ``n_edges`` edges from 70 senders (the last without edges) into 50
    receivers (five without edges; receiver 3 takes 400 more): ``(edge_in,
    sp, rp, es, wts, raw, update, bf16_ops)``."""
    dtype = _bf16_mode(monkeypatch, mode)
    edge_mode, update, ln = flags
    rng = np.random.default_rng(seed)
    d, n_send, n_rec = 64, 70, 50
    many = min(400, n_edges)
    snd = rng.integers(0, n_send - 1, n_edges)
    rcv = np.concatenate([rng.integers(0, n_rec - 5, n_edges - many), np.full(many, 3)])
    es, _ = make_edge_set(snd, rcv, num_rec=n_rec, num_send=n_send)
    es = es.to(cuda)
    gen = torch.Generator().manual_seed(seed)
    edge_mlp = make_mlp([3 * d, d, d], layer_norm=ln, generator=gen)
    embedder = make_mlp([3, d, d], generator=gen) if edge_mode == "raw" else None
    # the weights as a bf16 model holds them
    wts = [None if w is None else w.detach().to(dtype).float().to(cuda)
           for w in _weights(edge_mlp, embedder)]
    bf16_ops, io = fk.fused_precision(dtype)
    assert bf16_ops

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32, device=cuda).to(io)

    sp, rp = t(n_send, batch, d), t(n_rec, batch, d)
    if edge_mode == "raw":
        edge_in = t(es.num_edges, 3)
    elif edge_mode == "shared":
        edge_in = t(es.num_edges, d)
    else:
        edge_in = t(es.num_edges, batch, d)
    return edge_in, sp, rp, es, wts, edge_mode == "raw", update, bf16_ops


def _v2_bf_plain(edge_in, sp, rp, es, wts, raw, update):
    return fk._plain_v2(edge_in.float(), sp.float(), rp.float(), es.senders, es.receivers,
                        wts, raw, update, bf16_ops=True)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", BF_STREAM_MODES)
@pytest.mark.parametrize("flags", V2_BF_CASES)
@pytest.mark.parametrize("batch", [1, 2, 3, 4, 32])
def test_v2_bf16_fragments_forward_matches_plain(cuda, monkeypatch, mode, flags, batch):
    """K7's BF instantiations (each stream type) against the plain version:
    the aggregate in the streams' dtype and in float32 (0 for receivers
    without edges), the updated edges and the float32 pre, each in natural
    column order; the launch counted by its instantiation; the same bits
    on a second launch."""
    edge_in, sp, rp, es, wts, raw, update, bf16_ops = _v2_bf_case(
        cuda, monkeypatch, mode, flags, batch, seed=70
    )
    counter = fk.FUSED_EDGE_V2_BF16_OPS if mode == "high-kernels" else fk.FUSED_EDGE_V2_BF16
    want = _v2_bf_plain(edge_in, sp, rp, es, wts, raw, update)
    for out in {rp.dtype, torch.float32}:
        def run():
            return fused_edge_v2_fwd(edge_in, sp, rp, es, wts, raw, update, save_pre=True,
                                     bf16_ops=bf16_ops, out_dtype=out)

        before = counter.launches
        got = run()
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        assert got[0].dtype == out and got[2].dtype == torch.float32
        _close_bf16(got[0], want[0].to(out), "aggr")
        assert torch.all(got[0][-5:] == 0)
        if update:
            _close_bf16(got[1], want[1].to(out), "new_edge")
        else:
            assert got[1] is None
        _close_bf16(got[2], want[2], "pre")
        again = run()
        assert all(a is None or torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", BF_STREAM_MODES)
@pytest.mark.parametrize("flags", V2_BF_CASES)
@pytest.mark.parametrize("batch,use_new_edge", [(1, True), (2, True), (3, True), (4, True),
                                                (4, False), (32, True)])
def test_v2_bf16_fragments_backward_matches_plain(cuda, monkeypatch, mode, flags, batch,
                                                  use_new_edge):
    """K8's BF main kernel (with its edge pass or rows pass and reduce)
    from K7's pre, against autograd of the plain version: ``d_pre``,
    ``d_recproj`` (0 for receivers without edges), the edge input's
    gradient in the streams' dtype and every weight gradient; the launch
    counted by its instantiation; the same bits on a second run."""
    edge_in, sp, rp, es, wts, raw, update, bf16_ops = _v2_bf_case(
        cuda, monkeypatch, mode, flags, batch, seed=71
    )
    with torch.no_grad():
        pre = fused_edge_v2_fwd(edge_in, sp, rp, es, wts, raw, update, save_pre=True,
                                bf16_ops=bf16_ops)[2]
    rng = np.random.default_rng(72)
    io = rp.dtype
    d_aggr = torch.tensor(rng.normal(size=tuple(rp.shape)), device=cuda).to(io)
    d_new = None
    if update and use_new_edge:
        d_new = torch.tensor(rng.normal(size=(es.num_edges, batch, 64)), device=cuda).to(io)
    counter = (fk.FUSED_EDGE_V2_BWD_BF16_OPS if mode == "high-kernels"
               else fk.FUSED_EDGE_V2_BWD_BF16)

    def run():
        d_edge, d_pre, d_recproj, grads = fk.fused_edge_v2_bwd(
            d_aggr, d_new, pre, edge_in, es, wts, raw, bf16_ops=bf16_ops)
        return [d_pre, d_recproj] + ([] if raw else [d_edge]) + [g for g in grads
                                                                 if g is not None]

    before = counter.launches
    got = run()
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    d_edge, d_pre, d_recproj, grads = fk._plain_v2_bwd(
        d_aggr.float(), None if d_new is None else d_new.float(), edge_in.float(), sp.float(),
        rp.float(), es, wts, raw, update, bf16_ops=True)
    want = [d_pre, d_recproj] + ([] if raw else [d_edge]) + [g for g in grads if g is not None]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close_bf16(g, w.to(g.dtype), f"gradient {i}")
    assert got[1][-5:].abs().max().item() == 0  # receivers without edges
    assert all(torch.equal(a, b) for a, b in zip(got, run()))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", BF_STREAM_MODES)
@pytest.mark.parametrize("flags", V2_BF_CASES[:4])
def test_v2_bf16_fragments_on_a_shard_without_edges(cuda, monkeypatch, mode, flags):
    """An edge set of 50 receivers and no edge (a shard that owns none):
    K7's BF instantiation writes a zero aggregate and K8's wrapper returns
    zero gradients without a launch."""
    edge_in, sp, rp, es, wts, raw, update, bf16_ops = _v2_bf_case(
        cuda, monkeypatch, mode, flags, 4, seed=73, n_edges=0
    )
    aggr, new_edge, pre = fused_edge_v2_fwd(edge_in, sp, rp, es, wts, raw, update,
                                            save_pre=True, bf16_ops=bf16_ops)
    torch.cuda.synchronize()
    assert aggr.shape == rp.shape and torch.all(aggr == 0)
    assert pre.shape == (0, 4, 64) and (new_edge is None or new_edge.shape == (0, 4, 64))
    before = fk.FUSED_EDGE_V2_BWD_BF16.launches + fk.FUSED_EDGE_V2_BWD_BF16_OPS.launches
    d_edge, d_pre, d_recproj, grads = fk.fused_edge_v2_bwd(
        torch.ones_like(rp), None, pre, edge_in, es, wts, raw, bf16_ops=bf16_ops)
    assert fk.FUSED_EDGE_V2_BWD_BF16.launches + fk.FUSED_EDGE_V2_BWD_BF16_OPS.launches == before
    assert torch.all(d_recproj == 0) and all(g is None or torch.all(g == 0) for g in grads)


@pytest.mark.cuda
def test_v2_float32_and_bf16_instantiations_share_no_state(cuda):
    """At the MEPS g2m shapes (100,656 edges from 63,784 grid nodes into
    6,561 mesh nodes, the raw embedder, batch 4), K7's and K8's float32
    outputs and gradients are the same bits before and after a launch of
    their bf16-operand instantiations on other inputs."""
    rng = np.random.default_rng(74)
    d, b, n_send, n_rec, n_e = 64, 4, 63_784, 6_561, 100_656
    es, _ = make_edge_set(rng.integers(0, n_send, n_e), rng.integers(0, n_rec, n_e),
                          num_rec=n_rec, num_send=n_send)
    es = es.to(cuda)
    gen = torch.Generator().manual_seed(74)
    wts = [None if w is None else w.detach().to(cuda) for w in
           _weights(make_mlp([3 * d, d, d], generator=gen), make_mlp([3, d, d], generator=gen))]

    def t(*shape, dtype=torch.float32):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32, device=cuda).to(dtype)

    def phase(dtype, ops):
        feats, sp, rp = t(n_e, 3, dtype=dtype), t(n_send, b, d, dtype=dtype), t(n_rec, b, d,
                                                                                dtype=dtype)
        d_aggr = t(n_rec, b, d, dtype=dtype)

        def run():
            aggr, _, pre = fused_edge_v2_fwd(feats, sp, rp, es, wts, True, False,
                                             save_pre=True, bf16_ops=ops)
            _, d_pre, d_rec, grads = fk.fused_edge_v2_bwd(d_aggr, None, pre, feats, es, wts,
                                                          True, bf16_ops=ops)
            return [aggr, pre, d_pre, d_rec] + [g for g in grads if g is not None]

        return run

    f32, bf = phase(torch.float32, False), phase(torch.bfloat16, True)
    before = [x.clone() for x in f32()]
    bf()
    after = f32()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(before, after))


# -- the program's tracing on the card ---------------------------------------------
#
# ``utils.trace``: the captured calls' spans, the graphs counted at
# capture, the card's gap between calls and the recapture counter. Kernel
# records of the profiler are its device events other than copies and
# sets (``Memcpy ...``, ``Memset ...``).


def _device_kernels(prof) -> list[str]:
    cuda_type = torch.autograd.DeviceType.CUDA
    return [e.name for e in prof.events() if e.device_type == cuda_type
            and not e.name.startswith(("Memcpy", "Memset"))]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["train_step", "forecast"])
def test_graph_kernels_equal_the_profilers_records_per_replay(cuda, tmp_path, monkeypatch,
                                                               kind):
    """A tiny GraphLAM step's (and 3-step forecast's) graph, counted at
    capture: its kernel nodes are the kernel records the profiler keeps
    per replay of the graph, the launches of the port's kernels it holds
    are the capture call's counts over its warm-up and capture, and no
    span of the program shows on the card's timeline."""
    from torch.profiler import ProfilerActivity, profile

    from neural_lam_tpu_torch.predict import make_forecast
    from neural_lam_tpu_torch.utils import trace

    make_trainer, batches = _train_setup(tmp_path, cuda, "graph_lam", monkeypatch)
    trainer = make_trainer()
    if kind == "train_step":
        call, runs, data = trainer.make_train_step(), GRAPH_WARMUP_STEPS + 1, batches(4)
    else:
        fc = make_forecast(trainer.forecaster, trainer.datastore, device=cuda)
        call, runs = fc, 2  # one eager warm-up, the capture
        data = [tuple(torch.as_tensor(a, device=cuda) for a in b)
                for b in batches(4, steps=3)]
    trace.reset()
    ticks = _ticks(lambda: call(*data[0]))
    torch.cuda.synchronize()
    (graph,) = [g for g in trace.snapshot()["graphs"] if g["name"] == kind]
    assert graph["launches"] == {k: v // runs for k, v in ticks.items() if v}
    assert all(v % runs == 0 for v in ticks.values())
    (entry,) = (trainer.graphs if kind == "train_step" else call.graphs).values()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as replays:
        for _ in range(3):
            entry.graph.replay()
        torch.cuda.synchronize()
    kernels = _device_kernels(replays)
    # CUDA runs a graph's memcpy node as a kernel of its own
    # (``memcpy32_post``): a record beside the kernel nodes'
    lowered = [k for k in kernels if k.startswith("memcpy")]
    print(f"{kind}: graph nodes {graph['nodes']}, {len(kernels)} kernel records over 3 "
          f"replays, {len(lowered)} of them CUDA's copy kernels")
    assert graph["nodes"]["kernel"] > 0
    assert 3 * graph["nodes"]["kernel"] == len(kernels) - len(lowered)
    assert len(lowered) <= 3 * graph["nodes"]["memcpy"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in data[1:]:
            call(*b)
        torch.cuda.synchronize()
    snap = trace.snapshot()
    names = set(snap["spans"]["traced"]) | set(snap["spans"]["untraced"])
    assert f"{kind}.launch" in snap["spans"]["traced"]
    cuda_type = torch.autograd.DeviceType.CUDA
    on_card = {e.name for e in prof.events() if e.device_type == cuda_type}
    assert not on_card & names
    untraced = snap["spans"]["untraced"]
    capture = f"{kind}.capture"
    assert {capture, f"{capture}.warmup", f"{capture}.record",
            f"{capture}.first_launch"} <= set(untraced)
    # the record's spans count the graph's nodes
    assert untraced[f"{capture}.record"]["nodes"] == sum(graph["nodes"].values())
    g2m = [p for p in untraced if p.startswith(f"{capture}.record/") and p.endswith("gnn.g2m")]
    assert g2m and all(untraced[p]["nodes"] > 0 for p in g2m)


@pytest.mark.cuda
def test_device_gaps_resolve_without_a_synchronize(cuda, tmp_path, monkeypatch):
    """The card's gaps between captured steps are read from their events
    once the card has passed them: no synchronize is called. One step in
    ``GAP_EVERY`` opens a gap, the capture's first."""
    from neural_lam_tpu_torch.utils import trace

    make_trainer, batches = _train_setup(tmp_path, cuda, "graph_lam", monkeypatch)
    trainer = make_trainer()
    step = trainer.make_train_step()
    # on the card already, as a loader's prefetch leaves them
    data = [tuple(torch.as_tensor(a, device=cuda) for a in b) for b in batches(4)]
    trace.reset()
    step(*data[0])
    torch.cuda.synchronize()

    def refuse(*args, **kwargs):
        raise AssertionError("a synchronize on the traced path")

    with monkeypatch.context() as m:
        for owner in (torch.cuda, torch.cuda.Event, torch.cuda.Stream):
            m.setattr(owner, "synchronize", refuse)
        for i in range(3 * trace.GAP_EVERY):
            step(*data[1 + i % 3])
        deadline = time.perf_counter() + 30
        while True:
            gaps = trace.snapshot()["device_gaps"].get("train_step", {})
            if gaps.get("count") == 3 or time.perf_counter() > deadline:
                break
            time.sleep(0.01)
    assert gaps["count"] == 3, gaps
    assert 0 <= gaps["median_ms"] <= gaps["max_ms"]


@pytest.mark.cuda
def test_a_new_optimizer_counts_one_recapture(cuda, tmp_path, monkeypatch):
    from neural_lam_tpu_torch.utils import trace

    make_trainer, batches = _train_setup(tmp_path, cuda, "graph_lam", monkeypatch)
    trainer = make_trainer()
    step = trainer.make_train_step()
    data = batches(4)
    trace.reset()
    step(*data[0])
    step(*data[1])
    trainer.optimizer = trainer.init_state()
    step(*data[2])
    step(*data[3])
    counters = trace.snapshot()["counters"]
    assert counters["train_step.recaptures"] == 1
    assert counters["train_step.captures"] == 2
    spans = trace.snapshot()["spans"]["untraced"]
    assert spans["train_step"]["count"] == 4 and spans["train_step.launch"]["count"] == 2
    assert spans["train_step.capture"]["count"] == 2
    for child in ("check", "inputs", "grads", "loss"):
        assert spans[f"train_step.{child}"]["count"] == 4, child
