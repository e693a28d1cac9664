"""The node-MLP epilogue of the fused edge phase
(``NEURAL_LAM_TPU_FUSED_AGGR=on``) against the JAX package on the CPU.

Under ``on`` the JAX kernel applies the node MLP and the receiver residual
per output block and returns the node update (pallas_fused.py:335-391), and
its backward runs the node MLP's backward (:509-599); the port's K3 does the
same at a chunk's end and its node backward runs before K4. Here the
port's plain versions (its wrappers on CPU tensors) are held against the
JAX package's Pallas kernels in interpret mode, both under ``on``, on the
multi-block fixture of ``tests/test_fused_aggr_epilogue.py`` (420
receivers in four JAX blocks, 2,400 edges of uneven in-degree, the same
numpy seeds), as ``tests/test_torch_ops.py`` holds K3 and K4: the same
numpy inputs and the JAX init's weights carried over with
``params_from_jax``.

Tolerances. In float32 both sides compute exactly and differ in summation
order only: outputs within 1e-5 and gradients within 1e-4 of their
largest entry (a weight gradient sums a term per edge and batch member).
Under bf16 mixed precision both round to bf16 at different places (see
``tests/test_torch_bf16.py``), at that file's phase bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_lam_tpu.ops.pallas_fused as jax_pallas_fused
from neural_lam_tpu import config as jax_config
from neural_lam_tpu import models as jax_models
from neural_lam_tpu.datastore.dummy import DummyDatastore as JaxDummyDatastore
from neural_lam_tpu.models import ARForecaster as JaxARForecaster
from neural_lam_tpu.ops import interaction as jax_interaction
from neural_lam_tpu.ops.interaction import init_interaction_net
from neural_lam_tpu.ops.mlp import init_mlp
from neural_lam_tpu.trainer import Trainer as JaxTrainer
from neural_lam_tpu.trainer import TrainingArgs as JaxTrainingArgs
from neural_lam_tpu_torch import config, models
from neural_lam_tpu_torch.convert_checkpoint import grads_to_numpy, params_from_jax
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.graphs import create_graph_from_datastore
from neural_lam_tpu_torch.models import ARForecaster
from neural_lam_tpu_torch.ops import fused_kernels, interaction
from neural_lam_tpu_torch.ops.mlp import make_mlp
from neural_lam_tpu_torch.trainer import Trainer, TrainingArgs

OUT_TOL, GRAD_TOL = 1e-5, 1e-4
# the worst errors of a phase in tests/test_torch_bf16.py (its bf16 inputs)
BF16_OUT_TOL, BF16_GRAD_TOL = 5.4e-3, 1e-2
LOSS_RTOL, MODEL_GRAD_TOL = 2e-5, 1e-4
N_SEND, N_REC, N_EDGES, D, B, F = 300, 420, 2400, 64, 2, 3
AGGR = "NEURAL_LAM_TPU_FUSED_AGGR"
CONFIG = {"datastore": {"kind": "dummydata", "config_path": "ds.yaml"}}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("NEURAL_LAM_TPU_PALLAS", "interpret")
    monkeypatch.setenv(AGGR, "on")
    for name in ("NEURAL_LAM_TPU_FUSED", "NEURAL_LAM_TPU_FUSED_V2",
                 "NEURAL_LAM_TPU_CACHE_PRE", "NEURAL_LAM_TPU_MATMUL_PRECISION",
                 "NEURAL_LAM_TPU_BF16_KERNELS"):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def graph():
    """``test_fused_aggr_epilogue.py``'s edge set in both packages, and the
    JAX slots that hold the port's edges (both sort stably by receiver)."""
    rng = np.random.default_rng(7)
    senders = rng.integers(0, N_SEND, N_EDGES)
    receivers = np.sort(rng.integers(0, N_REC, N_EDGES))
    receivers[0], receivers[-1] = 0, N_REC - 1
    jes, jperm = jax_interaction.make_edge_set(senders, receivers, num_rec=N_REC,
                                               num_send=N_SEND)
    tes, tperm = interaction.make_edge_set(senders, receivers, num_rec=N_REC,
                                           num_send=N_SEND)
    assert jes.layout.num_blocks > 1, "the fixture must be multi-block"
    live = jperm >= 0
    np.testing.assert_array_equal(jperm[live], tperm)
    return jes, tes, live


def _slots(arr, live, jes):
    out = np.zeros((jes.num_padded,) + arr.shape[1:], np.float32)
    out[live] = arr
    return out


def _t(a, grad=False, dtype=torch.float32):
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32))).to(dtype)
    return t.requires_grad_(grad)


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _module(jax_params, module):
    sd = {k[2:]: v for k, v in params_from_jax({"m": jax_params}).items()}
    module.load_state_dict(sd, strict=True)
    return module


def _step(graph, batched, update, embed, bf16=False):
    """One interaction step with the epilogue in both packages, forward and
    backward from seeded cotangents. Returns the worst output and gradient
    errors over the node update, the new edges and every gradient (the
    node MLP's weights included), and the port's launches of the phase."""
    jes, tes, live = graph
    jes.fn_cache.clear()  # the JAX package reads NEURAL_LAM_TPU_CACHE_PRE when it builds
    rng = np.random.default_rng(3)
    shape = (lambda n: (n, B, D)) if batched else (lambda n: (n, D))
    send, rec = (rng.normal(size=shape(n)).astype(np.float32) for n in (N_SEND, N_REC))
    edge = rng.normal(size=shape(N_EDGES)).astype(np.float32)
    feats = rng.normal(size=(N_EDGES, F)).astype(np.float32)
    jp = init_interaction_net(jax.random.PRNGKey(0), D)
    jemb = init_mlp(jax.random.PRNGKey(8), [F, D, D])
    dt_j = jnp.bfloat16 if bf16 else jnp.float32
    dt_t = torch.bfloat16 if bf16 else torch.float32
    cast = lambda tree: jax.tree_util.tree_map(lambda a: a.astype(dt_j), tree)  # noqa: E731

    def j_fn(p, e, s, r):
        kw = dict(update_edges=update)
        if embed:
            kw.update(edge_embedder=e, edge_features=jnp.asarray(_slots(feats, live, jes)))
            return jax_interaction.apply_interaction_net(p, jes, s, r, None, **kw)
        return jax_interaction.apply_interaction_net(p, jes, s, r, e, **kw)

    j_edge_in = cast(jemb) if embed else jnp.asarray(_slots(edge, live, jes), dt_j)
    j_out, vjp = jax.vjp(j_fn, cast(jp), j_edge_in, jnp.asarray(send, dt_j),
                         jnp.asarray(rec, dt_j))
    j_rec_out = j_out[0] if update else j_out
    # the cotangents, in the outputs' shapes (an embedded edge is batched)
    d_rec = rng.normal(size=j_rec_out.shape).astype(np.float32)
    seeds = jnp.asarray(d_rec, j_rec_out.dtype)
    if update:
        d_edge = rng.normal(size=(N_EDGES,) + j_out[1].shape[1:]).astype(np.float32)
        seeds = (seeds, jnp.asarray(_slots(d_edge, live, jes), j_out[1].dtype))
    j_grads = vjp(seeds)

    net = _module(jp, interaction.InteractionNet(D)).to(dt_t)
    emb = _module(jemb, make_mlp([F, D, D])).to(dt_t)
    t_send, t_rec = _t(send, True, dt_t), _t(rec, True, dt_t)
    t_edge = _t(edge, not embed, dt_t)
    kw = dict(update_edges=update)
    if embed:
        kw.update(edge_embedder=emb, edge_features=_t(feats))
    launches = []
    apply = fused_kernels.FusedEdgePhase.apply

    def spy(*args):
        launches.append(args[15] is not None)  # the node MLP's first weight
        return apply(*args)

    with pytest.MonkeyPatch.context() as m:
        m.setattr(fused_kernels.FusedEdgePhase, "apply", spy)
        out = interaction.apply_interaction_net(
            net, tes, t_send, t_rec, None if embed else t_edge, **kw)
    t_rec_out = out[0] if update else out
    assert str(t_rec_out.dtype).replace("torch.", "") == str(j_rec_out.dtype)
    total = (t_rec_out.float() * _t(d_rec)).sum()
    out_err = _rel(t_rec_out, j_rec_out)
    if update:
        t_new = out[1].float()
        total = total + (t_new * _t(d_edge)).sum()
        out_err = max(out_err, _rel(t_new, np.asarray(j_out[1], np.float32)[live]))
    total.backward()

    grad_err = max(_rel(t_send.grad, j_grads[2]), _rel(t_rec.grad, j_grads[3]))
    want = params_from_jax({"m": jax.device_get(j_grads[0])})
    named = {f"m.{k}": p for k, p in net.named_parameters()}
    if embed:
        want.update(params_from_jax({"e": jax.device_get(j_grads[1])}))
        named.update({f"e.{k}": p for k, p in emb.named_parameters()})
    else:
        grad_err = max(grad_err, _rel(t_edge.grad, np.asarray(j_grads[1], np.float32)[live]))
    assert sorted(named) == sorted(want)
    assert any(k.startswith("m.aggr_mlp") for k in want)
    for k, p in named.items():
        grad_err = max(grad_err, _rel(p.grad, want[k]))
    return out_err, grad_err, launches


@pytest.mark.parametrize("cache_pre", ["on", "off"])
@pytest.mark.parametrize("embed", [False, True])
@pytest.mark.parametrize("update", [False, True])
@pytest.mark.parametrize("batched", [False, True])
def test_epilogue_matches_jax(graph, monkeypatch, batched, update, embed, cache_pre):
    """The port's interaction step under ``on`` (K3's epilogue and the node
    backward, plain versions) against ``jax.vjp`` of the JAX step under
    ``on`` (interpret): the node update, the new edges, the sender,
    receiver and edge gradients and every weight gradient, the node MLP's
    seven included, with the edge embedder in the kernel or not and K4
    from a saved ``pre`` or recomputing it. The phase took the epilogue.
    Measured worst: outputs 2.7e-7, gradients 1.7e-6 of their largest
    entry."""
    monkeypatch.setenv("NEURAL_LAM_TPU_CACHE_PRE", cache_pre)
    out_err, grad_err, launches = _step(graph, batched, update, embed)
    assert launches == [True]
    assert out_err <= OUT_TOL and grad_err <= GRAD_TOL, (out_err, grad_err)


def test_epilogue_bf16_matches_jax(graph):
    """bf16 mixed precision (bf16 weights and inputs on both sides): the
    node MLP's products take bf16 operands on the float32 aggregate, the
    node update comes out in bf16, as the JAX kernel's. Measured:
    outputs 4.7e-3, gradients 5.8e-3 of their largest entry."""
    out_err, grad_err, launches = _step(graph, True, True, False, bf16=True)
    assert launches == [True]
    assert out_err <= BF16_OUT_TOL and grad_err <= BF16_GRAD_TOL, (out_err, grad_err)


@pytest.mark.parametrize("batched,bf16", [(False, False), (True, False), (True, True)])
def test_node_update_wrapper_matches_the_jax_epilogue(graph, monkeypatch, batched, bf16):
    """The node update's wrapper on CPU tensors (``fused_node_fwd``, its
    plain version), fed the port's K3 aggregate (``_plain``) and the inputs
    the phase hands to ``FusedEdgePhase``, against the JAX step's node
    update under ``on`` (``make_fused_interaction``'s ``node_epilogue``,
    interpret), and the same bits as the port's phase. Tolerances: the
    step's, float32 ``OUT_TOL`` (measured 2.7e-7 for the step) and, on the
    batched input the bf16 step test takes, ``BF16_OUT_TOL`` (measured
    4.7e-3)."""
    jes, tes, live = graph
    jes.fn_cache.clear()
    rng = np.random.default_rng(3)
    shape = (lambda n: (n, B, D)) if batched else (lambda n: (n, D))
    send, rec = (rng.normal(size=shape(n)).astype(np.float32) for n in (N_SEND, N_REC))
    edge = rng.normal(size=shape(N_EDGES)).astype(np.float32)
    jp = init_interaction_net(jax.random.PRNGKey(0), D)
    dt_j = jnp.bfloat16 if bf16 else jnp.float32
    dt_t = torch.bfloat16 if bf16 else torch.float32
    jp_c = jax.tree_util.tree_map(lambda a: a.astype(dt_j), jp)
    j_node = jax_interaction.apply_interaction_net(
        jp_c, jes, jnp.asarray(send, dt_j), jnp.asarray(rec, dt_j),
        jnp.asarray(_slots(edge, live, jes), dt_j), update_edges=False)
    net = _module(jp, interaction.InteractionNet(D)).to(dt_t)
    seen = []
    apply = fused_kernels.FusedEdgePhase.apply

    def spy(*args):
        seen.append(args)
        return apply(*args)

    monkeypatch.setattr(fused_kernels.FusedEdgePhase, "apply", spy)
    with torch.no_grad():
        t_node = interaction.apply_interaction_net(
            net, tes, _t(send, dtype=dt_t), _t(rec, dtype=dt_t), _t(edge, dtype=dt_t),
            update_edges=False)
    (args,) = seen
    edge_in, x_send, rec_rep = args[:3]
    weights, node_weights = args[3:15], args[15:21]
    edge_set, raw, update, prop, _, bf16_ops, out_dtype = args[21:28]
    assert node_weights[0] is not None and bf16_ops == bf16
    with torch.no_grad():
        aggr, _ = fused_kernels._plain(edge_in.float(), x_send.float(), rec_rep.float(),
                                       edge_set.receivers, weights, raw, update, prop, bf16_ops)
        node = fused_kernels.fused_node_fwd(rec_rep, aggr, node_weights, bf16_ops, out_dtype)
    assert node.dtype == dt_t
    assert torch.equal(node.reshape(t_node.shape), t_node)
    err = _rel(node.reshape(j_node.shape), np.asarray(j_node, np.float32))
    assert err <= (BF16_OUT_TOL if bf16 else OUT_TOL), err


# -- the models ------------------------------------------------------------------


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """A root per graph kind, the graph built by the port, read by both
    packages (as ``tests/test_torch_bf16.py`` builds them)."""
    out = {}
    for kind, (nx, ny) in (("multiscale", (9, 9)), ("hierarchical", (27, 27))):
        root = tmp_path_factory.mktemp(f"torch_fused_aggr_{kind}")
        ds = DummyDatastore(root_path=root, n_grid_x=nx, n_grid_y=ny, n_timesteps=12,
                            computed_stats=True)
        create_graph_from_datastore(ds, root / "graph" / kind,
                                    hierarchical=kind == "hierarchical")
        out[kind] = (root, nx, ny)
    return out


class _Count:
    """Counts fused phases in both packages: the JAX ``_fused_fwd_impl``
    calls and the port's ``FusedEdgePhase`` applications, each split by
    whether it carried the node MLP."""

    def __init__(self, monkeypatch):
        self.jax, self.port = [], []
        impl, apply = jax_pallas_fused._fused_fwd_impl, fused_kernels.FusedEdgePhase.apply

        def jax_spy(*args, **kw):
            self.jax.append(kw.get("node_weights") is not None)
            return impl(*args, **kw)

        def port_spy(*args):
            self.port.append(args[15] is not None)
            return apply(*args)

        monkeypatch.setattr(jax_pallas_fused, "_fused_fwd_impl", jax_spy)
        monkeypatch.setattr(fused_kernels.FusedEdgePhase, "apply", port_spy)


@pytest.mark.parametrize("cls,kind", [("GraphLAM", "multiscale"), ("HiLAM", "hierarchical")])
def test_model_step_matches_jax(roots, monkeypatch, cls, kind):
    """A training step's loss and every parameter gradient of GraphLAM and
    HiLAM (hidden 8, one processor layer) under ``on``: the port's trainer
    against ``jax.value_and_grad`` of the JAX trainer's ``_loss`` from the
    same weights and batch. Every fused phase of both takes the epilogue
    (all of these nets are interaction-wired with sum aggregation). Measured: loss 1.5e-7 (GraphLAM) and 2.2e-7
    (HiLAM) relative, gradients 2.4e-6 and 5.8e-6 of their largest
    entry."""
    root, nx, ny = roots[kind]
    ds_kw = dict(n_grid_x=nx, n_grid_y=ny, n_timesteps=12, computed_stats=True)
    jds = JaxDummyDatastore(root_path=root, **ds_kw)
    tds = DummyDatastore(root_path=root, **ds_kw)
    kw = dict(hidden_dim=8, processor_layers=1, graph_name=kind)
    jm = getattr(jax_models, cls)(jds, **kw)
    params = jm.init_params(jax.random.PRNGKey(0))
    tm = getattr(models, cls)(tds, device="cpu", **kw)
    tm.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    jt = JaxTrainer(JaxARForecaster(jm, jds), jax_config.config_from_dict(CONFIG), jds,
                    JaxTrainingArgs(batch_size=2))
    tt = Trainer(ARForecaster(tm, tds), config.config_from_dict(CONFIG), tds,
                 TrainingArgs(batch_size=2), device="cpu")
    rng = np.random.default_rng(2)
    n, d = tds.num_grid_points, tds.get_num_data_vars("state")
    f = 3 * tds.get_num_data_vars("forcing")
    batch = tuple(rng.normal(size=s).astype(np.float32)
                  for s in ((2, 2, n, d), (2, 1, n, d), (2, 1, n, f)))
    count = _Count(monkeypatch)
    want_loss, want_grads = jax.jit(jax.value_and_grad(jt._loss))(params, *batch)
    got_loss = tt._loss(*batch)
    got_loss.backward()
    assert count.jax and all(count.jax) and count.port and all(count.port)
    assert abs(got_loss.item() - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    want = params_from_jax(jax.device_get(want_grads))
    got = grads_to_numpy(tm)
    assert sorted(got) == sorted(want)
    worst = max(_rel(got[k], want[k].numpy()) for k in want)
    assert worst <= MODEL_GRAD_TOL, worst


# -- routing ---------------------------------------------------------------------


class _Stop(Exception):
    """Raised by the routing spies once the phase's route is known."""


# case -> (environment, apply_interaction_net keywords, net variant); the
# epilogue engages in the first case only
ROUTES = {
    "on": ({AGGR: "on"}, {}, None),
    "off": ({AGGR: "off"}, {}, None),
    "default": ({AGGR: None}, {}, None),
    "other value": ({AGGR: "yes"}, {}, None),
    "mean": ({AGGR: "on"}, dict(aggr="mean"), None),
    "propagation": ({AGGR: "on"}, dict(propagation=True), None),
    "aggr hidden_layers=2": ({AGGR: "on"}, {}, "deep aggr"),
    "chunked aggr": ({AGGR: "on"}, dict(aggr_chunk_sizes=[20, 23]), "chunked aggr"),
    "v2 on": ({AGGR: "on", "NEURAL_LAM_TPU_FUSED_V2": "on"}, {}, None),
    "fused off": ({AGGR: "on", "NEURAL_LAM_TPU_FUSED": "off"}, {}, None),
}


def _routes(monkeypatch, run_jax, run_port) -> tuple[list, list]:
    """The fused v1 phases that each package starts, each as whether it
    carries the node MLP; the phase is stopped there."""
    seen_jax, seen_port = [], []

    def jax_spy(*args, **kw):
        seen_jax.append(kw.get("node_weights") is not None)
        raise _Stop

    def port_spy(*args):
        seen_port.append(args[15] is not None)
        raise _Stop

    with monkeypatch.context() as m:
        m.setattr(jax_pallas_fused, "_fused_fwd_impl", jax_spy)
        m.setattr(fused_kernels.FusedEdgePhase, "apply", port_spy)
        for run in (run_jax, run_port):
            try:
                run()
            except _Stop:
                pass
    return seen_jax, seen_port


@pytest.mark.parametrize("case", list(ROUTES))
def test_epilogue_engages_where_jax_does(monkeypatch, case):
    """The routing truth table against the JAX package's decision
    (neural_lam_tpu/ops/interaction.py:654-679): the epilogue runs only
    under ``on`` on the fused v1 route of an interaction-wired sum step with
    one two-layer node MLP, and both packages start the same phases."""
    env, kw, variant = ROUTES[case]
    for name, value in env.items():
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    d, n_send, n_rec, n_edges = 8, 30, 43, 200
    rng = np.random.default_rng(1)
    snd, rcv = rng.integers(0, n_send, n_edges), rng.integers(0, n_rec, n_edges)
    jes, _ = jax_interaction.make_edge_set(snd, rcv, num_rec=n_rec, num_send=n_send)
    tes, _ = interaction.make_edge_set(snd, rcv, num_rec=n_rec, num_send=n_send)
    chunks = 2 if variant == "chunked aggr" else 1
    jp = init_interaction_net(jax.random.PRNGKey(0), d, num_aggr_chunks=chunks)
    net = interaction.InteractionNet(d, num_aggr_chunks=chunks)
    if variant == "deep aggr":
        jp = dict(jp, aggr=[init_mlp(jax.random.PRNGKey(1), [2 * d, d, d, d])])
        net.aggr_mlp = make_mlp([2 * d, d, d, d])
    send, rec, edge = (rng.normal(size=(n, d)).astype(np.float32)
                       for n in (n_send, n_rec, n_edges))
    j_edge = np.zeros((jes.num_padded, d), np.float32)
    seen_jax, seen_port = _routes(
        monkeypatch,
        lambda: jax_interaction.apply_interaction_net(
            jp, jes, jnp.asarray(send), jnp.asarray(rec), jnp.asarray(j_edge), **kw),
        lambda: interaction.apply_interaction_net(
            net, tes, _t(send), _t(rec), _t(edge), **kw),
    )
    assert seen_port == seen_jax
    assert seen_port == ([True] if case == "on" else [False] if seen_port else [])
    if case in ("v2 on", "fused off", "chunked aggr"):
        assert seen_port == []  # the v2 or the unfused route


def test_sections_never_take_the_epilogue(monkeypatch):
    """HiLAMParallel's per-section phases (``ops.interaction.fused_edge_phase``,
    the JAX package's ``fused_edge_phase`` in hi_lam_parallel.py:150) return
    the sum under ``on`` too: the node update waits for every section."""
    d, n_send, n_rec, n_edges = 8, 30, 43, 200
    rng = np.random.default_rng(4)
    snd, rcv = rng.integers(0, n_send, n_edges), rng.integers(0, n_rec, n_edges)
    jes, _ = jax_interaction.make_edge_set(snd, rcv, num_rec=n_rec, num_send=n_send)
    tes, _ = interaction.make_edge_set(snd, rcv, num_rec=n_rec, num_send=n_send)
    jmlp = init_mlp(jax.random.PRNGKey(0), [3 * d, d, d])
    mlp = make_mlp([3 * d, d, d])
    send, rec = (rng.normal(size=(n, d)).astype(np.float32) for n in (n_send, n_rec))
    seen_jax, seen_port = _routes(
        monkeypatch,
        lambda: jax_interaction.fused_edge_phase(
            jmlp, jes, jnp.asarray(send), jnp.asarray(rec),
            jnp.zeros((jes.num_padded, d), jnp.float32)),
        lambda: interaction.fused_edge_phase(
            mlp, tes, _t(send), _t(rec), torch.zeros(n_edges, d)),
    )
    assert seen_jax == seen_port == [False]


def test_variable_is_read_at_every_call_and_keys_the_graphs(monkeypatch):
    """``fused_aggr_enabled`` is the JAX package's, read at every call, and
    ``route_env`` (what a captured CUDA graph keys on) follows both
    ``NEURAL_LAM_TPU_FUSED_AGGR`` and ``NEURAL_LAM_TPU_FUSED``."""
    for value in (None, "on", "off", "ON", "1"):
        if value is None:
            monkeypatch.delenv(AGGR, raising=False)
        else:
            monkeypatch.setenv(AGGR, value)
        assert fused_kernels.fused_aggr_enabled() == jax_pallas_fused.fused_aggr_enabled()
    monkeypatch.setenv(AGGR, "on")
    on = fused_kernels.route_env()
    monkeypatch.setenv(AGGR, "off")
    assert fused_kernels.route_env() != on
    off = fused_kernels.route_env()
    monkeypatch.setenv("NEURAL_LAM_TPU_FUSED", "off")
    assert fused_kernels.route_env() != off


def test_aggr_fusable_matches_jax():
    """``aggr_fusable`` against the JAX package's on the same shapes."""
    for sizes, ln in (([16, 8, 8], True), ([16, 8, 8], False), ([16, 8, 8, 8], True),
                      ([24, 8, 8], True), ([16, 8, 4], True)):
        j = init_mlp(jax.random.PRNGKey(0), sizes, layer_norm=ln)
        assert fused_kernels.aggr_fusable(make_mlp(sizes, layer_norm=ln)) == \
            jax_pallas_fused.aggr_fusable(j), sizes


# -- checkpoints -----------------------------------------------------------------


def test_parameters_and_checkpoints_unchanged(monkeypatch):
    """The epilogue adds no parameter and no state-dict key: the node MLP's
    weights are ``aggr_mlp``'s as they were, so ``params_from_jax`` carries
    a JAX net across unchanged, and the same module gives the same node
    update with the epilogue and without (the node MLP then runs with
    ``torch`` on the aggregate) within float32 summation order."""
    d = 8
    jp = init_interaction_net(jax.random.PRNGKey(3), d)
    net = _module(jp, interaction.InteractionNet(d))
    keys = sorted(net.state_dict())
    assert keys == sorted(interaction.InteractionNet(d).state_dict())
    assert sorted(k[2:] for k in params_from_jax({"m": jp})) == keys
    rng = np.random.default_rng(5)
    snd, rcv = rng.integers(0, 30, 200), rng.integers(0, 43, 200)
    tes, _ = interaction.make_edge_set(snd, rcv, num_rec=43, num_send=30)
    send, rec, edge = (_t(rng.normal(size=(n, 2, d))) for n in (30, 43, 200))
    outs = {}
    for value in ("on", "off"):
        monkeypatch.setenv(AGGR, value)
        with torch.no_grad():
            outs[value] = interaction.apply_interaction_net(net, tes, send, rec, edge)
    assert sorted(net.state_dict()) == keys
    for a, b in zip(outs["on"], outs["off"]):
        assert _rel(a, b.numpy()) <= OUT_TOL
