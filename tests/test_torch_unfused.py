"""The port's unfused route against the JAX package on the CPU: K5 (the
segment sum), K6 (the receiver expand), ``apply_interaction_net`` with
edge MLPs the fused kernel does not take, and ``GraphLAM(hidden_layers=2)``
as a whole.

Same scheme as ``tests/test_torch_ops.py`` and ``tests/test_torch_train.py``:
inputs from numpy seeds, weights from the JAX init carried over with
``params_from_jax``. The JAX side runs its Pallas kernels in interpret
mode (``NEURAL_LAM_TPU_PALLAS=interpret``); the port runs its kernels'
plain versions, which is what its wrappers do on CPU tensors, with the
backward going through ``ReceiverGather`` and ``SegmentSum`` as it does
on the card.

JAX keeps dead padding slots in its blocked edge layout and the port
keeps none, so edge arrays are compared on the JAX slots whose ``perm``
is valid; both sort edges stably by receiver, so those slots are in the
port's order.

Tolerances: exact float32 on both sides, different summation order only.
K6 is a copy on both sides: bit-identical. K5 sums up to 60 O(1) rows:
1e-6 of the largest sum. ``apply_interaction_net``: 2e-5 absolute and
relative on O(1) values, gradients at 5e-5 of each gradient's largest
value (as ``tests/test_torch_ops.py``). The whole model, its loss and an
AdamW trajectory: the bounds of ``tests/test_torch_train.py``, for the
reasons given there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_lam_tpu.convert_checkpoint import export_state_dict
from neural_lam_tpu.config import config_from_dict as jax_config_from_dict
from neural_lam_tpu.datastore.dummy import DummyDatastore as JaxDummyDatastore
from neural_lam_tpu.models import ARForecaster as JaxARForecaster
from neural_lam_tpu.models import GraphLAM as JaxGraphLAM
from neural_lam_tpu.ops.interaction import EdgeSet as JaxEdgeSet
from neural_lam_tpu.ops.interaction import (
    apply_interaction_net as jax_apply_interaction_net,
)
from neural_lam_tpu.ops.interaction import init_interaction_net
from neural_lam_tpu.ops.interaction import make_edge_set as jax_make_edge_set
from neural_lam_tpu.ops.mlp import init_mlp
from neural_lam_tpu.ops.pallas_segment import (
    blocked_expand_nondiff,
    blocked_segment_sum_nondiff,
)
from neural_lam_tpu.ops.segment import aggregate_sum as jax_aggregate_sum
from neural_lam_tpu.ops.segment import gather_receivers as jax_gather_receivers
from neural_lam_tpu.trainer import Trainer as JaxTrainer
from neural_lam_tpu.trainer import TrainingArgs as JaxTrainingArgs
from neural_lam_tpu_torch.config import config_from_dict
from neural_lam_tpu_torch.convert_checkpoint import (
    grads_to_numpy,
    params_from_jax,
    params_to_numpy,
)
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.graphs import create_graph_from_datastore
from neural_lam_tpu_torch.models import ARForecaster, GraphLAM
from neural_lam_tpu_torch.ops import interaction, segment
from neural_lam_tpu_torch.ops.interaction import (
    InteractionNet,
    apply_interaction_net,
    fused_edge_phase,
    fused_edge_phase_supported,
    make_edge_set,
    unfused_edge_phase,
)
from neural_lam_tpu_torch.ops.mlp import SplitMLPs, make_mlp, make_mlps
from neural_lam_tpu_torch.ops.segment_kernels import (
    receiver_expand,
    receiver_expand_plain,
    segment_sum,
    segment_sum_plain,
)
from neural_lam_tpu_torch.trainer import Trainer, TrainingArgs

TOL = dict(rtol=2e-5, atol=2e-5)
N_SEND, N_REC = 37, 23
DS_KW = dict(n_grid_x=12, n_grid_y=12, n_timesteps=12, computed_stats=True)
CONFIG = {"datastore": {"kind": "dummydata", "config_path": "ds.yaml"}}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("NEURAL_LAM_TPU_PALLAS", "interpret")
    monkeypatch.setenv("NEURAL_LAM_TPU_FUSED", "auto")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _graph(seed=3):
    """Random edges into receivers 3 .. N_REC - 2, plus: receiver 0 with
    60 edges (a high degree), receiver 1 with one edge (degree 1),
    receivers 2 and N_REC - 1 with none. Returns both packages' edge
    sets and the JAX live slots."""
    rng = np.random.default_rng(seed)
    rcv = np.concatenate(
        [rng.integers(3, N_REC - 1, 120), np.zeros(60, np.int64), [1]]
    )
    rng.shuffle(rcv)
    snd = rng.integers(0, N_SEND, rcv.size)
    jes, jperm = jax_make_edge_set(snd, rcv, num_rec=N_REC, num_send=N_SEND)
    tes, tperm = make_edge_set(snd, rcv, num_rec=N_REC, num_send=N_SEND)
    live = jperm >= 0
    np.testing.assert_array_equal(jperm[live], tperm)
    assert tes.recv_counts[0] == 60 and tes.recv_counts[1] == 1
    assert tes.recv_counts[2] == 0 and tes.recv_counts[-1] == 0
    return jes, tes, live


def _slots(arr, live, jes):
    """Port-order edge array -> JAX slot order (dead slots zero)."""
    out = np.zeros((jes.num_padded,) + arr.shape[1:], np.float32)
    out[live] = arr
    return out


def _assert_grad_close(got, want, name="", tol=5e-5):
    """``got`` within ``tol`` of ``want``'s largest absolute value."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=name)


def _assert_grad_dicts_close(got: dict, want: dict, tol=5e-5):
    assert sorted(got) == sorted(want)
    for key in want:
        _assert_grad_close(got[key], want[key], key, tol)


# -- K5 and K6 ------------------------------------------------------------------

# row shapes: batched at a 16-byte width, unbatched, and a width that is
# not a multiple of 4 floats (the kernels' scalar path on the card)
ROWS = [(2, 8), (8,), (5,), (3, 5)]


@pytest.mark.parametrize("row", ROWS)
def test_segment_sum_matches_jax_kernel(row):
    """K5's plain version vs ``blocked_segment_sum_nondiff`` (interpret)
    on the JAX layout of the same edges."""
    jes, tes, live = _graph()
    rng = np.random.default_rng(4)
    msg = rng.normal(size=(tes.num_edges, *row)).astype(np.float32)
    want = np.asarray(
        blocked_segment_sum_nondiff(
            jnp.asarray(_slots(msg.reshape(len(msg), -1), live, jes)),
            jes.layout, interpret=True,
        )
    )
    got = segment_sum(_t(msg), tes)  # CPU tensor: the plain version
    assert got.shape == (N_REC, *row)
    np.testing.assert_array_equal(
        got.numpy(), segment_sum_plain(_t(msg), tes.receivers, N_REC).numpy()
    )
    np.testing.assert_allclose(
        got.numpy().reshape(N_REC, -1), want, rtol=0,
        atol=1e-6 * np.abs(want).max(),
    )
    assert not got[2].any() and not got[-1].any()  # receivers without edges
    e1 = int(tes.rowptr[1])
    np.testing.assert_array_equal(got[1].numpy(), msg[e1])  # degree 1: a copy


@pytest.mark.parametrize("row", ROWS)
def test_receiver_expand_matches_jax_kernel(row):
    """K6's plain version vs ``blocked_expand_nondiff`` (interpret)."""
    jes, tes, live = _graph()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(N_REC, *row)).astype(np.float32)
    want = np.asarray(
        blocked_expand_nondiff(
            jnp.asarray(x.reshape(N_REC, -1)), jes.layout, interpret=True
        )
    )
    got = receiver_expand(_t(x), tes)
    assert got.shape == (tes.num_edges, *row)
    np.testing.assert_array_equal(
        got.numpy(), receiver_expand_plain(_t(x), tes.receivers).numpy()
    )
    np.testing.assert_array_equal(got.numpy().reshape(len(got), -1), want[live])
    assert not np.any(want[~live])  # JAX dead slots read zero


@pytest.mark.parametrize("batched", [True, False])
def test_gather_receivers_and_aggregate_sum_vjps_match_jax(batched):
    """``gather_receivers`` (K6, VJP K5) and ``aggregate_sum`` (K5, VJP
    K6): values and input gradients against the JAX ops' custom VJPs."""
    jes, tes, live = _graph()
    rng = np.random.default_rng(6)
    row = (2, 8) if batched else (8,)
    x = rng.normal(size=(N_REC, *row)).astype(np.float32)
    w_e = rng.normal(size=(tes.num_edges, *row)).astype(np.float32)
    msg = rng.normal(size=(tes.num_edges, *row)).astype(np.float32)
    w_n = rng.normal(size=(N_REC, *row)).astype(np.float32)

    want, vjp = jax.vjp(lambda a: jax_gather_receivers(jes, a), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(_slots(w_e, live, jes)))
    tx = _t(x).requires_grad_(True)
    got = segment.gather_receivers(tes, tx)
    (got * _t(w_e)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want)[live])
    _assert_grad_close(tx.grad.numpy(), want_dx, "d rec_rep", 1e-6)

    want, vjp = jax.vjp(
        lambda m: jax_aggregate_sum(jes, m), jnp.asarray(_slots(msg, live, jes))
    )
    (want_dm,) = vjp(jnp.asarray(w_n))
    tm = _t(msg).requires_grad_(True)
    got = segment.aggregate_sum(tes, tm)
    (got * _t(w_n)).sum().backward()
    _assert_grad_close(got.detach().numpy(), want, "sums", 1e-6)
    np.testing.assert_array_equal(tm.grad.numpy(), np.asarray(want_dm)[live])

    mean = segment.aggregate_mean(tes, _t(msg))
    counts = np.maximum(tes.recv_counts.numpy(), 1).reshape((-1,) + (1,) * len(row))
    np.testing.assert_allclose(
        mean.numpy(), got.detach().numpy() / counts, rtol=1e-6, atol=1e-7
    )


def test_segment_ops_on_an_empty_edge_set():
    """No edges: K5 gives zeros for every receiver, K6 an empty array,
    and both gradients have their inputs' shapes."""
    tes, _ = make_edge_set(np.zeros(0, int), np.zeros(0, int), num_rec=4, num_send=3)
    msg = torch.zeros((0, 2, 8), requires_grad=True)
    out = segment.aggregate_sum(tes, msg)
    assert out.shape == (4, 2, 8) and not out.any()
    out.sum().backward()
    assert msg.grad.shape == (0, 2, 8)
    x = torch.ones((4, 2, 8), requires_grad=True)
    exp = segment.gather_receivers(tes, x)
    assert exp.shape == (0, 2, 8)
    exp.sum().backward()
    assert x.grad.shape == (4, 2, 8) and not x.grad.any()


def test_segment_launchers_check_their_inputs():
    _, tes, _ = _graph()
    with pytest.raises(ValueError, match="message rows"):
        segment_sum(torch.zeros(3, 8), tes)
    with pytest.raises(ValueError, match="receivers"):
        receiver_expand(torch.zeros(N_REC + 1, 8), tes)
    for fn in (segment_sum, receiver_expand):
        assert isinstance(fn.launches, int)  # counted on the card only
    before = (segment_sum.launches, receiver_expand.launches)
    segment_sum(torch.zeros(tes.num_edges, 8), tes)
    receiver_expand(torch.zeros(N_REC, 8), tes)
    assert (segment_sum.launches, receiver_expand.launches) == before


# -- apply_interaction_net on the unfused route ---------------------------------

# (edge input, aggr, update_edges, propagation, hidden_layers, batched)
UNFUSED_CASES = [
    ("batched", "sum", True, False, 2, True),
    ("batched", "mean", True, False, 2, True),
    ("shared", "sum", True, False, 2, True),  # (E, D) edges in a batched call
    ("embed", "sum", False, False, 2, True),  # an embedder given
    ("embed", "mean", True, True, 2, True),  # propagation
    ("shared", "sum", False, False, 2, False),  # unbatched call
    ("batched", "sum", True, False, 0, True),  # a one-layer edge MLP
    ("embed", "sum", False, True, 0, True),
]


def _net_inputs(rng, tes, edge_in, batched, d=8, b=2, f=3):
    lead = (b,) if batched else ()
    send = rng.normal(size=(N_SEND, *lead, d)).astype(np.float32)
    rec = rng.normal(size=(N_REC, *lead, d)).astype(np.float32)
    feats = rng.normal(size=(tes.num_edges, f)).astype(np.float32)
    edge = None
    if edge_in == "batched":
        edge = rng.normal(size=(tes.num_edges, b, d)).astype(np.float32)
    elif edge_in == "shared":
        edge = rng.normal(size=(tes.num_edges, d)).astype(np.float32)
    return send, rec, feats, edge


def _load(module, jax_params):
    sd = {k[2:]: v for k, v in params_from_jax({"m": jax_params}).items()}
    module.load_state_dict(sd, strict=True)
    return module


def _state(jax_tree) -> dict:
    """A JAX MLP or GNN pytree under the port's state-dict names."""
    exported = export_state_dict({"m": jax.device_get(jax_tree)})
    return {k[2:]: v for k, v in exported.items()}


@pytest.mark.parametrize("edge_in,aggr,update,prop,hl,batched", UNFUSED_CASES)
def test_unfused_interaction_net_matches_jax(edge_in, aggr, update, prop, hl, batched):
    """Outputs and every gradient (inputs, net and embedder weights) of
    the unfused route against the JAX package's."""
    jes, tes, live = _graph(seed=11)
    rng = np.random.default_rng(7)
    d, f = 8, 3
    jp = init_interaction_net(jax.random.PRNGKey(7), d, hidden_layers=hl)
    jemb = init_mlp(jax.random.PRNGKey(8), [f, d, d])
    net = _load(InteractionNet(d, hidden_layers=hl), jp)
    emb = _load(make_mlp([f, d, d]), jemb)
    assert not fused_edge_phase_supported(net.edge_mlp, tes, *(torch.zeros(1, d),) * 3)
    send, rec, feats, edge = _net_inputs(rng, tes, edge_in, batched)
    kw = dict(aggr=aggr, update_edges=update, propagation=prop)
    n_out = 2 if update else 1
    w_node = rng.normal(size=(N_REC, *send.shape[1:])).astype(np.float32)
    w_edge = rng.normal(size=(tes.num_edges, *send.shape[1:])).astype(np.float32)

    def jax_loss(p, e, s, r, ed):
        if edge_in == "embed":
            out = jax_apply_interaction_net(
                p, jes, s, r, None, edge_embedder=e,
                edge_features=jnp.asarray(_slots(feats, live, jes)), **kw,
            )
        else:
            out = jax_apply_interaction_net(p, jes, s, r, ed, **kw)
        out = out if update else (out,)
        total = jnp.sum(out[0] * w_node)
        if update:
            total = total + jnp.sum(out[1][live] * w_edge)
        return total, out

    j_edge = None if edge is None else jnp.asarray(_slots(edge, live, jes))
    argnums = (0, 1, 2, 3) + ((4,) if edge is not None else ())
    (_, want), want_g = jax.value_and_grad(jax_loss, argnums=argnums, has_aux=True)(
        jp, jemb, jnp.asarray(send), jnp.asarray(rec), j_edge
    )

    t_send, t_rec = _t(send).requires_grad_(True), _t(rec).requires_grad_(True)
    t_edge = None if edge is None else _t(edge).requires_grad_(True)
    if edge_in == "embed":
        got = apply_interaction_net(
            net, tes, t_send, t_rec, None, edge_embedder=emb,
            edge_features=_t(feats), **kw,
        )
    else:
        got = apply_interaction_net(net, tes, t_send, t_rec, t_edge, **kw)
    got = got if update else (got,)
    assert len(got) == n_out
    total = (got[0] * _t(w_node)).sum()
    if update:
        total = total + (got[1] * _t(w_edge)).sum()
    total.backward()

    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]), **TOL)
    if update:
        np.testing.assert_allclose(
            got[1].detach().numpy(), np.asarray(want[1])[live], **TOL
        )
    _assert_grad_dicts_close(grads_to_numpy(net), _state(want_g[0]))
    if edge_in == "embed":
        _assert_grad_dicts_close(grads_to_numpy(emb), _state(want_g[1]))
    _assert_grad_close(t_send.grad.numpy(), want_g[2], "d send_rep")
    _assert_grad_close(t_rec.grad.numpy(), want_g[3], "d rec_rep")
    if edge is not None:
        _assert_grad_close(t_edge.grad.numpy(), np.asarray(want_g[4])[live], "d edge_rep")


@pytest.mark.parametrize("hl", [1, 2])
def test_chunked_interaction_net_matches_jax(hl):
    """Per-chunk edge and node MLPs (``edge_mlp.mlps.<k>``,
    ``aggr_mlp.mlps.<k>``): three edge chunks and two receiver chunks.
    The JAX edge set lists the port's sorted edges without a layout, as
    HiLAMParallel's combined set does, so chunk ``k`` is the same run of
    edges on both sides. Outputs and every gradient."""
    _, tes, _ = _graph(seed=12)
    rng = np.random.default_rng(8)
    d, e = 8, tes.num_edges
    receivers = tes.receivers.numpy().astype(np.int32)
    jes = JaxEdgeSet(
        senders=jnp.asarray(tes.senders.numpy()),
        receivers=jnp.asarray(receivers),
        recv_gather=jnp.asarray(receivers),
        recv_counts=jnp.asarray(tes.recv_counts.numpy().astype(np.int32)),
        num_rec=N_REC, num_valid=e, sorted_by_receiver=False,
    )
    edge_chunks, aggr_chunks = [50, 70, e - 120], [10, N_REC - 10]
    jp = init_interaction_net(
        jax.random.PRNGKey(9), d, hidden_layers=hl, num_edge_chunks=3,
        num_aggr_chunks=2,
    )
    net = _load(
        InteractionNet(d, hidden_layers=hl, num_edge_chunks=3, num_aggr_chunks=2), jp
    )
    assert isinstance(net.edge_mlp, SplitMLPs) and len(net.aggr_mlp.mlps) == 2
    assert "edge_mlp.mlps.2.0.weight" in net.state_dict()
    send, rec, _, edge = _net_inputs(rng, tes, "batched", True)
    w_node = rng.normal(size=rec.shape).astype(np.float32)
    w_edge = rng.normal(size=edge.shape).astype(np.float32)
    kw = dict(edge_chunk_sizes=edge_chunks, aggr_chunk_sizes=aggr_chunks)

    def jax_loss(p, s, r, ed):
        out = jax_apply_interaction_net(p, jes, s, r, ed, **kw)
        return jnp.sum(out[0] * w_node) + jnp.sum(out[1] * w_edge), out

    (_, want), want_g = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3), has_aux=True)(
        jp, jnp.asarray(send), jnp.asarray(rec), jnp.asarray(edge)
    )
    leaves = [_t(a).requires_grad_(True) for a in (send, rec, edge)]
    got = apply_interaction_net(net, tes, *leaves, **kw)
    ((got[0] * _t(w_node)).sum() + (got[1] * _t(w_edge)).sum()).backward()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    _assert_grad_dicts_close(grads_to_numpy(net), _state(want_g[0]))
    for leaf, w, name in zip(leaves, want_g[1:], ("send", "rec", "edge")):
        _assert_grad_close(leaf.grad.numpy(), w, name)
    with pytest.raises(ValueError, match="chunk sizes"):
        apply_interaction_net(net, tes, *leaves)
    with pytest.raises(ValueError, match="do not split"):
        apply_interaction_net(
            net, tes, *leaves, edge_chunk_sizes=[1, 2, 3], aggr_chunk_sizes=aggr_chunks
        )


@pytest.mark.parametrize("prop", [False, True])
@pytest.mark.parametrize("edge_in", ["shared", "batched"])
def test_edge_phase_routes_agree(monkeypatch, edge_in, prop):
    """The per-section entries: ``fused_edge_phase`` (K1, K3) and
    ``unfused_edge_phase`` (K1, K6, MLP, K5) compute the same sums and
    edge update for a two-layer edge MLP, and ``apply_interaction_net``
    takes the unfused route where ``fused_edge_phase_supported`` says no."""
    _, tes, _ = _graph(seed=13)
    rng = np.random.default_rng(9)
    net = InteractionNet(8, generator=torch.Generator().manual_seed(0))
    send, rec, _, edge = _net_inputs(rng, tes, edge_in, True)
    args = (net.edge_mlp, tes, _t(send), _t(rec[:, 0]), _t(edge))
    assert fused_edge_phase_supported(net.edge_mlp, tes, *args[2:])
    with torch.no_grad():
        fused = fused_edge_phase(*args, update_edges=True, propagation=prop)
        unfused = unfused_edge_phase(*args, update_edges=True, propagation=prop)
        auto = apply_interaction_net(net, tes, *args[2:], propagation=prop)
        monkeypatch.setattr(interaction, "fused_edge_phase_supported", lambda *a: False)
        off = apply_interaction_net(net, tes, *args[2:], propagation=prop)
    for a, b in zip(fused + auto, unfused + off):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    assert fused_edge_phase(*args, update_edges=False)[1] is None
    assert unfused_edge_phase(*args, update_edges=False)[1] is None
    # an unbatched call drops the batch axis again
    one = unfused_edge_phase(net.edge_mlp, tes, _t(send[:, 0]), _t(rec[:, 0]),
                             _t(edge if edge.ndim == 2 else edge[:, 0]))
    assert one[0].shape == (N_REC, 8) and one[1].shape == (tes.num_edges, 8)


def test_split_mlps_apply_chunks_in_order():
    gen = torch.Generator().manual_seed(1)
    mlps = make_mlps([6, 4, 4], 3, generator=gen)
    assert isinstance(make_mlps([6, 4, 4], 1, generator=gen), torch.nn.Sequential)
    x = torch.randn(10, 2, 6, generator=gen)
    with torch.no_grad():
        got = mlps(x, [3, 0, 7])
        want = torch.cat([mlps.mlps[0](x[:3]), mlps.mlps[2](x[3:])])
    assert torch.equal(got, want)
    assert sorted(mlps.state_dict())[0] == "mlps.0.0.bias"


# -- GraphLAM(hidden_layers=2): the whole model on the unfused route ---------


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """One graph on disk, built by the port, read by both packages."""
    root = tmp_path_factory.mktemp("torch_unfused")
    ds = DummyDatastore(root_path=root, **DS_KW)
    create_graph_from_datastore(ds, root / "graph" / "multiscale")
    return root


MODEL_KW = dict(hidden_dim=16, hidden_layers=2, processor_layers=2)


def _models(root, **extra):
    jds = JaxDummyDatastore(root_path=root, **DS_KW)
    tds = DummyDatastore(root_path=root, **DS_KW)
    jm = JaxGraphLAM(jds, **MODEL_KW, **extra)
    params = jm.init_params(jax.random.PRNGKey(0))
    tm = GraphLAM(tds, **MODEL_KW, **extra, device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    return jds, tds, jm, params, tm


def _batch(ds, batch, steps, seed=2):
    rng = np.random.default_rng(seed)
    n = ds.num_grid_points
    d = ds.get_num_data_vars("state")
    f = ds.get_num_data_vars("forcing") * 3
    return (
        rng.normal(size=(batch, 2, n, d)).astype(np.float32),
        rng.normal(size=(batch, steps, n, d)).astype(np.float32),
        rng.normal(size=(batch, steps, n, f)).astype(np.float32),
    )


@pytest.mark.parametrize("batch", [1, 2])
def test_graph_lam_unfused_step_and_forecast_match_jax(root, batch):
    """``GraphLAM(hidden_layers=2).step`` and a 3-step forecast: every
    GNN call takes the unfused route on both sides."""
    jds, tds, jm, params, tm = _models(root, mesh_aggr="mean" if batch == 1 else "sum")
    rng = np.random.default_rng(1)
    n = tds.num_grid_points
    prev, prev_prev = (rng.normal(size=(n, batch, 3)).astype(np.float32) for _ in range(2))
    forcing = rng.normal(size=(n, batch, 6)).astype(np.float32)
    want, _ = jm.step(params, *(jnp.asarray(a) for a in (prev, prev_prev, forcing)))
    with torch.no_grad():
        got, std = tm.step(*(_t(a) for a in (prev, prev_prev, forcing)))
    assert std is None and got.shape == prev.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:n], rtol=5e-5, atol=5e-5)

    init, boundary, forc = _batch(tds, batch, 3)
    want, _ = JaxARForecaster(jm, jds).forward(
        params, jnp.asarray(init), jnp.asarray(forc), jnp.asarray(boundary)
    )
    with torch.no_grad():
        got, _ = ARForecaster(tm, tds)(_t(init), _t(forc), _t(boundary))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5, atol=5e-5)


def _trainers(root, batch_size=2, lr=1e-3, loss="wmse"):
    jds, tds, jm, params, tm = _models(root)
    jt = JaxTrainer(
        JaxARForecaster(jm, jds), jax_config_from_dict(CONFIG), jds,
        JaxTrainingArgs(batch_size=batch_size, lr=lr, loss=loss),
    )
    tt = Trainer(
        ARForecaster(tm, tds), config_from_dict(CONFIG), tds,
        TrainingArgs(batch_size=batch_size, lr=lr, loss=loss), device="cpu",
    )
    return jt, params, tt, tm, tds


def test_graph_lam_unfused_loss_and_grads_match_jax(root):
    """``Trainer._loss`` and every parameter gradient for one batch of 2
    at 2 AR steps."""
    jt, params, tt, tm, tds = _trainers(root)
    batch = _batch(tds, 2, 2)
    want_loss, want_grads = jax.value_and_grad(jt._loss)(params, *batch)
    got_loss = tt._loss(*batch)
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=2e-5)
    _assert_grad_dicts_close(
        grads_to_numpy(tm), export_state_dict(jax.device_get(want_grads)), tol=1e-4
    )


def test_graph_lam_unfused_train_steps_match_jax_trajectory(root):
    """Five AdamW steps from one init on identical batches: the losses
    and the final parameters against the JAX ``make_train_step``."""
    steps, lr = 5, 1e-3
    jt, params, tt, tm, tds = _trainers(root, lr=lr)
    batches = [_batch(tds, 2, 1, seed=10 + k) for k in range(steps)]
    step = jt.make_train_step()
    j_params, opt_state = jt.place_state(
        jax.tree_util.tree_map(jnp.array, params), jt.optimizer.init(params)
    )
    want_losses = []
    for batch in batches:
        j_params, opt_state, loss = step(j_params, opt_state, *batch)
        want_losses.append(float(loss))
    got_losses = [tt.train_step(*batch).item() for batch in batches]
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    want = export_state_dict(jax.device_get(j_params))
    got = params_to_numpy(tm)
    assert sorted(got) == sorted(want)
    worst = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    assert worst <= 0.05 * steps * lr, worst
    mean = np.mean([np.abs(got[k] - want[k]).mean() for k in want])
    assert mean <= 1e-3 * steps * lr, mean
