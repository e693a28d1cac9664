"""The port's v2 fused edge phase (K7, K8) against the JAX package's v2
route on the CPU.

Both packages run with ``NEURAL_LAM_TPU_FUSED_V2=on``: the JAX side
through ``make_fused_interaction_v2`` with its Pallas kernels in
interpret mode (``NEURAL_LAM_TPU_PALLAS=interpret``), the port through
``FusedEdgePhaseV2`` with the plain versions of K7, K8 and K2, which is
what its wrappers run on CPU tensors. Same numpy inputs, weights from the
JAX init carried over with ``params_from_jax``. A spy on each side shows
that the v2 route really ran: the JAX edge set's ``fn_cache`` holds a
``"fused_v2"`` closure, and the port applied ``FusedEdgePhaseV2``, ran
the plain versions of K8 and K2 in its backward, and no sender gather
(K1).

The edge set is the multi-window one of ``tests/test_pallas_fused_v2.py``
(600 senders, 420 receivers, 2,600 edges, senders banded around the
receiver position, so the JAX kernel's chunks straddle sender windows),
with one receiver and one sender without edges.

Routing: both packages read the same three environment variables at
call time, and the port counts without the JAX padding (edges and
``send_rows + num_rec`` where the JAX package counts padded slots and
block-padded receiver rows). On the test's edge set the ratio is 2.55
for the port and 3.22 for the JAX package, so ``auto`` under a ratio
between the two routes differently by design; the truth table uses
ratios away from both.

Tolerances: exact float32 on both sides, different summation order only
(the projection of each sender is formed once per node here and per edge
on the v1 route). Outputs within 2e-5 absolute and relative on O(1)
values; every gradient within 1e-4 of its largest absolute value (a
weight gradient sums a term per edge and batch member).
"""

import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_lam_tpu.convert_checkpoint import export_state_dict
from neural_lam_tpu.datastore.dummy import DummyDatastore as JaxDummyDatastore
from neural_lam_tpu.models import ARForecaster as JaxARForecaster
from neural_lam_tpu.models import GraphLAM as JaxGraphLAM
from neural_lam_tpu.models import HiLAMParallel as JaxHiLAMParallel
from neural_lam_tpu.ops import interaction as jax_interaction
from neural_lam_tpu.ops.interaction import init_interaction_net
from neural_lam_tpu.ops.mlp import init_mlp
from neural_lam_tpu.ops.pallas_fused import fused_v2_routed as jax_fused_v2_routed
from neural_lam_tpu_torch.convert_checkpoint import grads_to_numpy, params_from_jax
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.graphs import create_graph_from_datastore
from neural_lam_tpu_torch.models import ARForecaster, GraphLAM, HiLAMParallel
from neural_lam_tpu_torch.ops import fused_kernels, interaction, segment_kernels
from neural_lam_tpu_torch.ops.mlp import make_mlp

REPO = Path(__file__).resolve().parent.parent
TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = 1e-4
N_SEND, N_REC, N_EDGES, D, B, F = 600, 420, 2600, 64, 2, 3


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("NEURAL_LAM_TPU_PALLAS", "interpret")
    monkeypatch.setenv("NEURAL_LAM_TPU_FUSED", "auto")
    monkeypatch.setenv("NEURAL_LAM_TPU_FUSED_V2", "on")
    for name in ("NEURAL_LAM_TPU_FUSED_V2_RATIO", "NEURAL_LAM_TPU_CACHE_PRE"):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def graph():
    """Both packages' edge sets over the same edges, and the JAX slots
    that hold a live edge (in the port's order)."""
    rng = np.random.default_rng(0)
    rcv = np.sort(rng.integers(0, N_REC - 1, N_EDGES))  # N_REC - 1 gets none
    snd = np.clip(
        (rcv * N_SEND / N_REC).astype(int) + rng.integers(-60, 60, N_EDGES),
        0, N_SEND - 1,
    )
    snd[snd == 100] = 101  # sender 100 sends nothing
    jes, jperm = jax_interaction.make_edge_set(snd, rcv, num_rec=N_REC, num_send=N_SEND)
    tes, tperm = interaction.make_edge_set(snd, rcv, num_rec=N_REC, num_send=N_SEND)
    assert jes.banded is not None
    assert int(jes.banded.gvisit_chunk.shape[0]) > int(jes.banded.n_chunks)
    live = jperm >= 0
    np.testing.assert_array_equal(jperm[live], tperm)
    return jes, tes, live


@pytest.fixture
def spies(monkeypatch):
    """Counts of the port's ``FusedEdgePhaseV2`` applications, and of the
    plain versions of K8, K2 and K1."""
    counts = dict.fromkeys(["k7", "k8", "k2", "k1"], 0)

    def spy(module, name, key):
        fn = getattr(module, name)

        def counted(*args, **kwargs):
            counts[key] += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, name, counted)

    spy(fused_kernels.FusedEdgePhaseV2, "apply", "k7")
    spy(fused_kernels, "_plain_v2_bwd", "k8")
    spy(segment_kernels, "sender_scatter_plain", "k2")
    spy(segment_kernels, "sender_gather_plain", "k1")
    return counts


def _t(a, grad=False):
    out = torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))
    return out.requires_grad_(grad)


def _slots(arr, live, jes):
    """Port-order edge array -> JAX slot order (dead slots zero)."""
    out = np.zeros((jes.num_padded,) + arr.shape[1:], np.float32)
    out[live] = arr
    return out


def _load(jax_params, module):
    sd = {k[2:]: v for k, v in params_from_jax({"m": jax_params}).items()}
    module.load_state_dict(sd, strict=True)
    return module


def _grads(jax_tree) -> dict:
    return {k: v.numpy() for k, v in params_from_jax(jax.device_get(jax_tree)).items()}


def _assert_grad_close(got, want, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * scale, err_msg=name)


def _assert_grad_dicts_close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key in want:
        _assert_grad_close(got[key], want[key], key)


def _took_v2(jax_edge_sets) -> bool:
    return any(k[0] == "fused_v2" for es in jax_edge_sets for k in es.fn_cache)


def _clear(jax_edge_sets) -> None:
    for es in jax_edge_sets:
        es.fn_cache.clear()


# -- one InteractionNet --------------------------------------------------------


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("update_edges", [False, True])
@pytest.mark.parametrize("embed", [False, True])
def test_interaction_net_v2_matches_jax(graph, spies, embed, update_edges, batched):
    """``apply_interaction_net`` on the v2 route, in the wirings of the
    MEPS sites (the in-kernel embedder on g2m, m2g and m2m layer 0, a
    batched edge state on the later m2m layers) and an unbatched call:
    outputs, every parameter gradient and the node and edge gradients."""
    jes, tes, live = graph
    rng = np.random.default_rng(1)
    jp = init_interaction_net(jax.random.PRNGKey(0), D)
    jemb = init_mlp(jax.random.PRNGKey(4), [F, D, D])
    net = _load(jp, interaction.InteractionNet(D))
    emb = _load(jemb, make_mlp([F, D, D]))
    lead = (B,) if batched else ()
    send = rng.normal(size=(N_SEND, *lead, D)).astype(np.float32)
    rec = rng.normal(size=(N_REC, *lead, D)).astype(np.float32)
    edge = rng.normal(size=(N_EDGES, *lead, D)).astype(np.float32)
    feats = rng.normal(size=(N_EDGES, F)).astype(np.float32)
    j_feats = jnp.asarray(_slots(feats, live, jes))
    valid = jnp.asarray(live.reshape((-1,) + (1,) * len(lead) + (1,)))

    def jax_loss(p, e_params, s, r, e):
        kw = dict(update_edges=update_edges)
        if embed:
            out = jax_interaction.apply_interaction_net(
                p, jes, s, r, None, edge_embedder=e_params, edge_features=j_feats, **kw
            )
        else:
            out = jax_interaction.apply_interaction_net(p, jes, s, r, e, **kw)
        if update_edges:
            # dead padding slots hold arbitrary values
            return jnp.sum(jnp.sin(out[0])) + jnp.sum(jnp.sin(out[1]) * valid), out
        return jnp.sum(jnp.sin(out)), out

    _clear([jes])
    (_, j_out), j_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        jp, jemb, jnp.asarray(send), jnp.asarray(rec), jnp.asarray(_slots(edge, live, jes))
    )
    assert _took_v2([jes])

    t_send, t_rec, t_edge = _t(send, True), _t(rec, True), _t(edge, not embed)
    kw = dict(update_edges=update_edges)
    if embed:
        kw.update(edge_embedder=emb, edge_features=_t(feats))
    out = interaction.apply_interaction_net(
        net, tes, t_send, t_rec, None if embed else t_edge, **kw
    )
    outs = out if update_edges else (out,)
    sum(o.sin().sum() for o in outs).backward()
    assert spies == dict(k7=1, k8=1, k2=1, k1=0)

    j_outs = j_out if update_edges else (j_out,)
    np.testing.assert_allclose(outs[0].detach().numpy(), np.asarray(j_outs[0]), **TOL)
    if update_edges:
        np.testing.assert_allclose(
            outs[1].detach().numpy(), np.asarray(j_outs[1])[live], **TOL
        )
    want = _grads({"m": j_grads[0]})
    got = {f"m.{k}": p.grad.numpy() for k, p in net.named_parameters()}
    if embed:
        want.update(_grads({"e": j_grads[1]}))
        got.update({f"e.{k}": p.grad.numpy() for k, p in emb.named_parameters()})
    else:
        _assert_grad_close(t_edge.grad.numpy(), np.asarray(j_grads[4])[live], "d_edge")
    _assert_grad_dicts_close(got, want)
    _assert_grad_close(t_send.grad.numpy(), np.asarray(j_grads[2]), "d_send")
    assert not np.any(t_send.grad.numpy()[100])  # the sender without edges
    _assert_grad_close(t_rec.grad.numpy(), np.asarray(j_grads[3]), "d_rec")


def test_section_entry_v2_matches_jax(graph, spies):
    """``fused_edge_phase``, HiLAMParallel's per-section entry, on v2: a
    shared ``(E, D)`` edge state beside batched node rows, with the edge
    update, against the JAX ``fused_edge_phase`` on its v2 route."""
    jes, tes, live = graph
    rng = np.random.default_rng(2)
    jmlp = init_interaction_net(jax.random.PRNGKey(3), D)["edge"][0]
    mlp = _load(jmlp, make_mlp([3 * D, D, D]))
    send = rng.normal(size=(N_SEND, B, D)).astype(np.float32)
    rec = rng.normal(size=(N_REC, B, D)).astype(np.float32)
    edge = rng.normal(size=(N_EDGES, D)).astype(np.float32)
    w_aggr = rng.normal(size=(N_REC, B, D)).astype(np.float32)
    w_edge = rng.normal(size=(N_EDGES, B, D)).astype(np.float32)
    j_w_edge = jnp.asarray(_slots(w_edge, live, jes))

    def jax_loss(m, s, r, e):
        aggr, new_edge = jax_interaction.fused_edge_phase(m, jes, s, r, e, update_edges=True)
        return jnp.sum(aggr * w_aggr) + jnp.sum(new_edge * j_w_edge), (aggr, new_edge)

    _clear([jes])
    (_, j_out), j_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3), has_aux=True)(
        jmlp, jnp.asarray(send), jnp.asarray(rec), jnp.asarray(_slots(edge, live, jes))
    )
    assert _took_v2([jes])
    leaves = [_t(send, True), _t(rec, True), _t(edge, True)]
    aggr, new_edge = interaction.fused_edge_phase(mlp, tes, *leaves, update_edges=True)
    ((aggr * _t(w_aggr)).sum() + (new_edge * _t(w_edge)).sum()).backward()
    assert spies == dict(k7=1, k8=1, k2=1, k1=0)
    np.testing.assert_allclose(aggr.detach().numpy(), np.asarray(j_out[0]), **TOL)
    np.testing.assert_allclose(new_edge.detach().numpy(), np.asarray(j_out[1])[live], **TOL)
    _assert_grad_dicts_close(
        {f"m.{k}": p.grad.numpy() for k, p in mlp.named_parameters()},
        _grads({"m": j_grads[0]}),
    )
    for leaf, want, name in zip(leaves, j_grads[1:], ["d_send", "d_rec", "d_edge"]):
        want = np.asarray(want)
        _assert_grad_close(leaf.grad.numpy(), want[live] if name == "d_edge" else want, name)


# -- routing -------------------------------------------------------------------

# (NEURAL_LAM_TPU_FUSED_V2, _RATIO, _CACHE_PRE) -> v2 on the test's edge set
ROUTES = [
    ((None, None, None), False),  # auto at the default ratio 8
    (("auto", "2", None), True),
    (("auto", "50", None), False),
    (("on", None, None), True),
    (("on", "50", None), True),
    (("off", "2", None), False),
    (("on", None, "off"), False),  # K8 needs the saved pre
    (("auto", "2", "off"), False),
    (("on", None, "on"), True),
]
ENV = ("NEURAL_LAM_TPU_FUSED_V2", "NEURAL_LAM_TPU_FUSED_V2_RATIO", "NEURAL_LAM_TPU_CACHE_PRE")


@pytest.mark.parametrize("env,want", ROUTES)
def test_both_packages_route_alike(graph, spies, monkeypatch, env, want):
    """The routing rule of ``test_v2_routing_and_gates`` and
    ``test_v2_auto_ratio_routing`` (tests/test_pallas_fused_v2.py), each
    package with its own counts, and the port's phase takes the route its
    rule names."""
    jes, tes, _ = graph
    for name, value in zip(ENV, env):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    lay = jes.layout
    j_route = jax_fused_v2_routed(
        lay.num_blocked, N_SEND + lay.num_blocks * lay.block_rows
    )
    t_route = fused_kernels.fused_v2_routed(tes.num_edges, N_SEND + tes.num_rec)
    assert j_route == t_route == want
    net = interaction.InteractionNet(8)
    with torch.no_grad():
        interaction.apply_interaction_net(
            net, tes, torch.zeros(N_SEND, 8), torch.zeros(N_REC, 8),
            torch.zeros(N_EDGES, 8), update_edges=False,
        )
    assert (spies["k7"], spies["k1"]) == ((1, 0) if want else (0, 1))


def test_routing_rule_at_meps_counts(monkeypatch):
    """The MEPS sets with the port's counts: g2m 1.4, m2g 3.6 and m2m 4.4
    edges per hoisted row, so ``auto`` keeps all three on v1 at the default
    ratio, as the JAX package does with its padded counts (1.5, 3.6, 4.9)."""
    sites = dict(g2m=(100_656, 63_784 + 6_561), m2g=(255_136, 6_561 + 63_784),
                 m2m=(57_616, 6_561 + 6_561))
    monkeypatch.setenv("NEURAL_LAM_TPU_FUSED_V2", "auto")
    assert not any(fused_kernels.fused_v2_routed(*s) for s in sites.values())
    assert fused_kernels.fused_v2_routed(10 * 70_345, 70_345)  # an 8x+ set would
    monkeypatch.setenv("NEURAL_LAM_TPU_FUSED_V2_RATIO", "3")
    assert [fused_kernels.fused_v2_routed(*s) for s in sites.values()] == [False, True, True]
    monkeypatch.setenv("NEURAL_LAM_TPU_FUSED_V2", "on")
    assert all(fused_kernels.fused_v2_routed(*s) for s in sites.values())
    monkeypatch.setenv("NEURAL_LAM_TPU_CACHE_PRE", "off")
    assert not fused_kernels.fused_v2_enabled()
    assert not any(fused_kernels.fused_v2_routed(*s) for s in sites.values())
    monkeypatch.setenv("NEURAL_LAM_TPU_CACHE_PRE", "on")
    monkeypatch.setenv("NEURAL_LAM_TPU_FUSED_V2", "off")
    assert not fused_kernels.fused_v2_enabled()


@pytest.mark.parametrize("name", ENV)
def test_route_env_reads_every_routing_variable(monkeypatch, name):
    """``route_env``, the key by which captured training steps are cached
    per route, changes with each variable the routing rule reads."""
    for n in ENV:
        monkeypatch.delenv(n, raising=False)
    before = fused_kernels.route_env()
    monkeypatch.setenv(name, "off")
    assert fused_kernels.route_env() != before


def test_propagation_stays_on_v1(graph, spies, monkeypatch):
    """A PropagationNet keeps K1 + K3 under ``on``, as in the JAX package,
    and computes what it computes under ``off``."""
    _, tes, _ = graph
    rng = np.random.default_rng(5)
    net = interaction.InteractionNet(16, generator=torch.Generator().manual_seed(0))
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((N_SEND, B, 16), (N_REC, B, 16), (N_EDGES, 16))]
    kw = dict(update_edges=False, propagation=True)
    with torch.no_grad():
        on = interaction.apply_interaction_net(net, tes, *map(_t, arrays), **kw)
        monkeypatch.setenv("NEURAL_LAM_TPU_FUSED_V2", "off")
        off = interaction.apply_interaction_net(net, tes, *map(_t, arrays), **kw)
    assert (spies["k7"], spies["k1"]) == (0, 2)
    assert torch.equal(on, off)


def test_v2_launchers_refuse_other_devices(graph):
    _, tes, _ = graph
    mlp = make_mlp([3 * D, D, D])
    meta = torch.zeros((N_REC, B, D), device="meta")
    with pytest.raises(RuntimeError, match="fused_edge_phase_v2: unsupported device"):
        fused_kernels.fused_edge_phase_v2(mlp, None, meta, meta, tes)
    with pytest.raises(ValueError, match="two-layer"):
        fused_kernels.fused_edge_phase_v2(make_mlp([3 * D, D, D, D]), None,
                                          torch.zeros(N_SEND, B, D),
                                          torch.zeros(N_REC, B, D), tes)


# -- models ----------------------------------------------------------------------

DS_KW = dict(n_grid_x=27, n_grid_y=27, n_timesteps=12, computed_stats=True)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_fused_v2")
    ds = DummyDatastore(root_path=root, **DS_KW)
    create_graph_from_datastore(ds, root / "graph" / "multiscale")
    create_graph_from_datastore(ds, root / "graph" / "hierarchical", hierarchical=True)
    return root


def _jax_edge_sets(jm):
    g = jm.graph
    return [p.edges for p in (g.g2m, g.m2g, *g.m2m, *g.up, *g.down)]


MODELS = [
    # (JAX class, port class, graph, processor layers)
    (JaxGraphLAM, GraphLAM, "multiscale", 2),
    (JaxHiLAMParallel, HiLAMParallel, "hierarchical", 1),
]


@pytest.mark.parametrize("jcls,tcls,graph_name,layers", MODELS)
def test_model_on_v2_matches_jax(root, spies, monkeypatch, jcls, tcls, graph_name, layers):
    """A small GraphLAM and HiLAMParallel (hidden 64, the kernels' width)
    with every fused phase on v2 in both packages: a 3-step rollout, and a
    weighted sum of one step with every parameter gradient. The same
    converted parameters also drive the port's v1 route to the same
    values."""
    jds = JaxDummyDatastore(root_path=root, **DS_KW)
    tds = DummyDatastore(root_path=root, **DS_KW)
    kw = dict(hidden_dim=D, processor_layers=layers, graph_name=graph_name)
    jm = jcls(jds, **kw)
    params = jm.init_params(jax.random.PRNGKey(0))
    tm = tcls(tds, device="cpu", **kw)
    tm.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    rng = np.random.default_rng(3)
    n = tds.num_grid_points
    d_state = tds.get_num_data_vars("state")
    f_dim = tds.get_num_data_vars("forcing") * 3
    init = rng.normal(size=(B, 2, n, d_state)).astype(np.float32)
    forcing = rng.normal(size=(B, 3, n, f_dim)).astype(np.float32)
    boundary = rng.normal(size=(B, 3, n, d_state)).astype(np.float32)
    w = rng.normal(size=(n, B, d_state)).astype(np.float32)
    step_in = [np.moveaxis(a, 0, 1) for a in (init[:, 1], init[:, 0], forcing[:, 0])]

    _clear(_jax_edge_sets(jm))
    want_roll, _ = JaxARForecaster(jm, jds).forward(
        params, jnp.asarray(init), jnp.asarray(forcing), jnp.asarray(boundary)
    )

    def jax_loss(p):
        out, _ = jm.step(p, *(jnp.asarray(a) for a in step_in))
        return jnp.sum(out[:n] * w)

    want_grads = export_state_dict(jax.device_get(jax.grad(jax_loss)(params)))
    assert _took_v2(_jax_edge_sets(jm))

    def port_run():
        tm.zero_grad(set_to_none=True)
        with torch.no_grad():
            roll, _ = ARForecaster(tm, tds)(_t(init), _t(forcing), _t(boundary))
        out, _ = tm.step(*map(_t, step_in))
        (out * _t(w)).sum().backward()
        return roll.numpy(), out.detach().numpy(), grads_to_numpy(tm)

    roll, out, grads = port_run()
    levels = len(tm.graph.m2m)  # GNN applications per step, as chip_smoke counts them
    applications = 2 + layers if levels == 1 else 2 * levels + layers * (3 * levels - 2)
    assert spies["k7"] == 4 * applications and spies["k8"] == applications
    assert spies["k1"] == 0
    np.testing.assert_allclose(roll, np.asarray(want_roll), rtol=5e-5, atol=5e-5)
    _assert_grad_dicts_close(grads, want_grads)

    monkeypatch.setenv("NEURAL_LAM_TPU_FUSED_V2", "off")
    roll_v1, out_v1, grads_v1 = port_run()
    assert spies["k1"] > 0
    np.testing.assert_allclose(roll_v1, roll, rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(out_v1, out, rtol=2e-5, atol=2e-5)
    _assert_grad_dicts_close(grads_v1, grads)


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", ["graph_lam", "hi_lam_parallel"])
def test_expected_v2_launches_match_the_calls_of_the_plain_versions(root, monkeypatch, name):
    """On the CPU a wrapper runs its plain version exactly where it would
    launch its kernel on the card, so counting the plain versions' calls
    over one served step and one training step on the v2 route checks the
    counts ``chip_smoke.py`` asserts there: K7 per GNN application, and K8
    and K2 per application in training; no K1, K3 or K4."""
    smoke = _load_chip_smoke()
    monkeypatch.setattr(smoke, "HIDDEN", 8)
    tds = DummyDatastore(root_path=root, **DS_KW)
    if name == "graph_lam":
        tm = GraphLAM(tds, hidden_dim=8, processor_layers=2, device="cpu")
    else:
        tm = smoke.build_model(torch, name, tds, device="cpu", processor_layers=2)
    plain = {
        "K1 sender_gather": (segment_kernels, "sender_gather_plain"),
        "K2 sender_scatter": (segment_kernels, "sender_scatter_plain"),
        "K3 fused_edge_phase": (fused_kernels, "_plain"),
        "K4 fused_edge_phase backward": (fused_kernels, "_plain_bwd"),
        "K5 segment_sum": (segment_kernels, "segment_sum_plain"),
        "K6 receiver_expand": (segment_kernels, "receiver_expand_plain"),
        "K7 fused_edge_phase_v2": (fused_kernels.FusedEdgePhaseV2, "apply"),
        "K8 fused_edge_phase_v2 backward": (fused_kernels, "_plain_v2_bwd"),
    }
    calls = dict.fromkeys(smoke.kernel_counters(), 0)
    assert sorted(calls) == sorted(plain)
    for key, (owner, attr) in plain.items():
        fn = getattr(owner, attr)

        def counted(*args, _key=key, _fn=fn, **kw):
            calls[_key] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(owner, attr, counted)
    rng = np.random.default_rng(4)
    n = tds.num_grid_points
    d, f = tds.get_num_data_vars("state"), tds.get_num_data_vars("forcing") * 3
    inputs = [_t(rng.normal(size=(n, B, w))) for w in (d, d, f)]
    with smoke.fused_v2("on"):
        with torch.no_grad():
            tm.step(*inputs)
        assert calls == smoke.expected_launches(tm, training=False)
        calls.update(dict.fromkeys(calls, 0))
        out, _ = tm.step(*inputs)
        out.sum().backward()
        assert calls == smoke.expected_launches(tm, training=True)
    n_app = smoke.gnn_applications(tm)
    assert calls["K7 fused_edge_phase_v2"] == calls["K8 fused_edge_phase_v2 backward"] == n_app
    assert os.environ["NEURAL_LAM_TPU_FUSED_V2"] == "on"  # restored to this test's own


def test_remat_recompute_takes_the_v2_route(root, spies):
    """``ARForecaster``'s per-step remat recomputes each step in the
    backward; the route is read at every call, so the recompute runs K7
    again (never K1 + K3) and the gradients equal those without remat."""
    tds = DummyDatastore(root_path=root, **DS_KW)
    tm = GraphLAM(tds, hidden_dim=8, processor_layers=1, device="cpu")
    rng = np.random.default_rng(6)
    n, steps = tds.num_grid_points, 3
    d, f = tds.get_num_data_vars("state"), tds.get_num_data_vars("forcing") * 3
    init = _t(rng.normal(size=(B, 2, n, d)))
    forcing = _t(rng.normal(size=(B, steps, n, f)))
    boundary = _t(rng.normal(size=(B, steps, n, d)))
    w = _t(rng.normal(size=(B, steps, n, d)))
    results = {}
    for remat in (True, False):
        spies.update(dict.fromkeys(spies, 0))
        tm.zero_grad(set_to_none=True)
        pred, _ = ARForecaster(tm, tds, remat_steps=remat)(init, forcing, boundary)
        (pred * w).sum().backward()
        results[remat] = (dict(spies), grads_to_numpy(tm))
    applications = steps * (2 + 1)  # g2m, one m2m layer, m2g per step
    assert results[False][0] == dict(k7=applications, k8=applications,
                                     k2=applications, k1=0)
    assert results[True][0] == dict(k7=2 * applications, k8=applications,
                                    k2=applications, k1=0)
    for key, want in results[False][1].items():
        np.testing.assert_allclose(results[True][1][key], want, rtol=1e-6, atol=1e-7,
                                   err_msg=key)
