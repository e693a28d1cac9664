"""The port's reduced-precision path against the JAX package on the CPU:
bf16 mixed precision, ``NEURAL_LAM_TPU_BF16_KERNELS`` and
``NEURAL_LAM_TPU_MATMUL_PRECISION=high`` / ``high-kernels``.

Same scheme as ``tests/test_torch_ops.py`` and ``tests/test_torch_train.py``:
the same numpy inputs and the same weights (the JAX init, carried over
with ``params_from_jax``) go through the JAX function, its Pallas kernels
in interpret mode, and through the port's counterpart, whose wrappers run
their kernels' plain versions on CPU tensors. Under mixed precision both
sides get bf16 copies of the weights and bf16 inputs, as their trainers
make them.

Tolerances. Both sides multiply bf16 operands exactly and sum in float32,
but they round to bf16 at different places: the JAX kernels also round
the receiver projection and each message before their one-hot sums, and
its MLPs and LayerNorms outside the kernels round after every operation,
where PyTorch's round once per call. So values agree to a few bf16 ulps
(2^-8 relative each): outputs are held to 2e-2 and gradients to 5e-2 of
their largest entry (the JAX package's own bound, tests/
test_pallas_fused.py:287), losses to 2e-2 relative; the sender gather is a
copy on both sides and must match bit for bit, its backward's sums to
8e-3 of the largest. Each test's docstring states the worst error
measured when it was written. Dtypes must be equal to the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from neural_lam_tpu import config as jax_config
from neural_lam_tpu import models as jax_models
from neural_lam_tpu.convert_checkpoint import export_state_dict
from neural_lam_tpu.datastore.dummy import DummyDatastore as JaxDummyDatastore
from neural_lam_tpu.models import ARForecaster as JaxARForecaster
from neural_lam_tpu.ops.interaction import make_edge_set as jax_make_edge_set
from neural_lam_tpu.ops.mlp import init_mlp
from neural_lam_tpu.ops.pallas_fused import make_fused_interaction
from neural_lam_tpu.ops.segment import _gather_io_dtype
from neural_lam_tpu.ops.segment import gather_senders as jax_gather_senders
from neural_lam_tpu.trainer import Trainer as JaxTrainer
from neural_lam_tpu.trainer import TrainingArgs as JaxTrainingArgs
from neural_lam_tpu_torch import config, models
from neural_lam_tpu_torch.convert_checkpoint import grads_to_numpy, params_from_jax
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.graphs import create_graph_from_datastore
from neural_lam_tpu_torch.models import ARForecaster
from neural_lam_tpu_torch.ops import fused_kernels, interaction, segment
from neural_lam_tpu_torch.ops.fused_kernels import fused_edge_phase, fused_edge_phase_plain
from neural_lam_tpu_torch.ops.interaction import make_edge_set
from neural_lam_tpu_torch.ops.mlp import make_mlp
from neural_lam_tpu_torch.trainer import Trainer, TrainingArgs

OUT_TOL, GRAD_TOL, LOSS_RTOL, SCATTER_TOL = 2e-2, 5e-2, 2e-2, 8e-3
N_SEND, N_REC, N_EDGES = 37, 23, 180
BF16 = torch.bfloat16
CONFIG = {"datastore": {"kind": "dummydata", "config_path": "ds.yaml"}}
GRIDS = {"multiscale": (9, 9), "hierarchical": (27, 27)}
# mode -> (NEURAL_LAM_TPU_MATMUL_PRECISION, bf16 inputs and weights)
MODES = {"bf16": (None, True), "high": ("high", False), "high-kernels": ("high-kernels", False)}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("NEURAL_LAM_TPU_PALLAS", "interpret")
    monkeypatch.setenv("NEURAL_LAM_TPU_FUSED", "auto")
    for name in ("NEURAL_LAM_TPU_MATMUL_PRECISION", "NEURAL_LAM_TPU_BF16_KERNELS",
                 "NEURAL_LAM_TPU_FUSED_V2"):
        monkeypatch.delenv(name, raising=False)


def _mode(monkeypatch, mode) -> bool:
    """Set ``mode``'s environment; returns whether its inputs are bf16."""
    env, bf16 = MODES[mode]
    if env is not None:
        monkeypatch.setenv("NEURAL_LAM_TPU_MATMUL_PRECISION", env)
    return bf16


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rel(got, want) -> float:
    """Max error of ``got`` over ``want``'s largest absolute entry."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _same_dtype(t: torch.Tensor, a) -> None:
    assert str(t.dtype).replace("torch.", "") == str(jnp.asarray(a).dtype)


def _to_bf16(tree):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), tree)


# -- the precision variables ------------------------------------------------------


@pytest.mark.parametrize("env", [None, "default", "highest", "high", "high-kernels"])
@pytest.mark.parametrize("kernels", [None, "off"])
def test_precision_choice_matches_jax(monkeypatch, env, kernels):
    """``gather_io_dtype`` against the JAX package's ``_gather_io_dtype``,
    and ``fused_precision`` against ``make_fused_interaction``'s ``cdt``
    and ``io_dt`` rule (pallas_fused.py:1430-1453), for float32 and bf16
    rows."""
    if env is not None:
        monkeypatch.setenv("NEURAL_LAM_TPU_MATMUL_PRECISION", env)
    if kernels is not None:
        monkeypatch.setenv("NEURAL_LAM_TPU_BF16_KERNELS", kernels)
    for t_dt, j_dt in ((torch.float32, jnp.float32), (BF16, jnp.bfloat16)):
        assert str(segment.gather_io_dtype(t_dt)).replace("torch.", "") == str(
            jnp.dtype(_gather_io_dtype(j_dt))
        )
        bf16_streams = j_dt == jnp.bfloat16 and kernels != "off"
        ops = bf16_streams or env in ("high", "high-kernels")
        io = BF16 if (bf16_streams or env == "high") else torch.float32
        assert fused_kernels.fused_precision(t_dt) == (ops, io)


@pytest.mark.parametrize("name", ["NEURAL_LAM_TPU_MATMUL_PRECISION",
                                  "NEURAL_LAM_TPU_BF16_KERNELS"])
def test_route_env_reads_the_precision_variables(monkeypatch, name):
    """``route_env``, the key of the captured steps and inference graphs,
    changes with each precision variable, so a change captures anew."""
    before = fused_kernels.route_env()
    monkeypatch.setenv(name, "high-kernels")
    assert fused_kernels.route_env() != before


def test_unknown_matmul_precision_raises(monkeypatch):
    monkeypatch.setenv("NEURAL_LAM_TPU_MATMUL_PRECISION", "fast")
    with pytest.raises(ValueError, match="high-kernels"):
        segment.apply_matmul_precision()
    with pytest.raises(ValueError, match="fast"):
        fused_kernels.fused_precision(torch.float32)


# -- K1 and K2: the sender gather and its VJP ---------------------------------------


def _graph(seed=3):
    """Random edges, receiver N_REC - 1 without any (its aggregate is 0);
    both packages' edge sets and the JAX layout's live slots (the others
    are dead padding slots)."""
    rng = np.random.default_rng(seed)
    snd = rng.integers(0, N_SEND, N_EDGES)
    rcv = rng.integers(0, N_REC - 1, N_EDGES)
    jes, jperm = jax_make_edge_set(snd, rcv, num_rec=N_REC, num_send=N_SEND)
    tes, tperm = make_edge_set(snd, rcv, num_rec=N_REC, num_send=N_SEND)
    live = jperm >= 0
    np.testing.assert_array_equal(jperm[live], tperm)
    assert not live.all()
    return jes, tes, live


def _slots(arr, live, jes):
    out = np.zeros((jes.num_padded,) + arr.shape[1:], np.float32)
    out[live] = arr
    return out


@pytest.mark.parametrize("mode", ["bf16", "high"])
@pytest.mark.parametrize("batched", [False, True])
def test_gather_senders_and_vjp_match_jax(monkeypatch, mode, batched):
    """K1's and K2's plain versions through ``gather_senders`` against the
    JAX ``gather_senders`` and its VJP (``banded_expand_nondiff``,
    ``banded_scatter_nondiff`` with float32 sums, cast back): the gather
    bit for bit, the gradient within 8e-3 of its largest entry (measured:
    0 in every case), each in the JAX dtype."""
    bf16 = _mode(monkeypatch, mode)
    jes, tes, live = _graph()
    rng = np.random.default_rng(4)
    shape = (N_SEND, 2, 8) if batched else (N_SEND, 8)
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=(N_EDGES,) + shape[1:]).astype(np.float32)
    j_dt, t_dt = (jnp.bfloat16, BF16) if bf16 else (jnp.float32, torch.float32)

    out, vjp = jax.vjp(lambda a: jax_gather_senders(jes, a), jnp.asarray(x, j_dt))
    (want,) = vjp(jnp.asarray(_slots(g, live, jes), out.dtype))
    tx = torch.from_numpy(x).to(t_dt).requires_grad_(True)
    got = segment.gather_senders(tes, tx)
    got.backward(torch.from_numpy(g).to(got.dtype))
    _same_dtype(got, out)
    _same_dtype(tx.grad, want)
    np.testing.assert_array_equal(_np(got), _np(out)[live])
    if mode == "high":  # the rows went through bf16 and back
        assert not np.array_equal(_np(got), x[tes.senders.numpy()])
    assert _rel(tx.grad, np.asarray(want)[:N_SEND]) <= SCATTER_TOL


# -- K3 and K4: the fused edge phase and its backward ---------------------------------

PHASE_CASES = [
    # (edge input, update_edges, batch)
    ("raw", False, 2),  # g2m, m2g: the embedder inside the kernel
    ("raw", True, 2),  # m2m layer 0
    ("batched", True, 2),  # later m2m layers
    ("shared", True, 2),
    ("batched", True, 1),
    ("raw", False, 32),
]


def _phase(monkeypatch, mode, edge_mode, update, b, kernels="auto"):
    """One fused phase on both sides in ``mode``: the JAX outputs and the
    VJP's gradients, the port's outputs and its leaves' gradients."""
    bf16 = _mode(monkeypatch, mode)
    monkeypatch.setenv("NEURAL_LAM_TPU_BF16_KERNELS", kernels)
    jes, tes, live = _graph()
    rng = np.random.default_rng(5)
    d, f = 8, 3
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    mlp, emb = init_mlp(k1, [3 * d, d, d]), init_mlp(k2, [f, d, d])
    t_mlp, t_emb = make_mlp([3 * d, d, d]), make_mlp([f, d, d])
    t_mlp.load_state_dict({k[2:]: v for k, v in params_from_jax({"m": mlp}).items()})
    t_emb.load_state_dict({k[2:]: v for k, v in params_from_jax({"m": emb}).items()})
    j_dt, t_dt = (jnp.bfloat16, BF16) if bf16 else (jnp.float32, torch.float32)
    if bf16:
        mlp, emb = _to_bf16(mlp), _to_bf16(emb)
        t_mlp, t_emb = t_mlp.to(BF16), t_emb.to(BF16)
    send = rng.normal(size=(N_EDGES, b, d)).astype(np.float32)
    rec = rng.normal(size=(N_REC, b, d)).astype(np.float32)
    edge = {
        "raw": rng.normal(size=(N_EDGES, f)),
        "shared": rng.normal(size=(N_EDGES, d)),
        "batched": rng.normal(size=(N_EDGES, b, d)),
    }[edge_mode].astype(np.float32)
    d_aggr = rng.normal(size=(N_REC, b, d)).astype(np.float32)
    d_new = rng.normal(size=(N_EDGES, b, d)).astype(np.float32)

    run = make_fused_interaction(jes.layout, update_edges=update, propagation=False,
                                 interpret=True)
    raw = edge_mode == "raw"
    # the raw features are the model's static edge features, in its
    # compute dtype on both sides
    j_edge = jnp.asarray(_slots(edge, live, jes), j_dt)
    args = [mlp, emb if raw else j_edge, jnp.asarray(_slots(send, live, jes), j_dt),
            jnp.asarray(rec, j_dt)]
    if raw:
        fn = lambda m, e, s, r: run(m, None, s, r, emb_params=e, edge_feats=j_edge)  # noqa: E731
    else:
        fn = lambda m, e, s, r: run(m, e, s, r)  # noqa: E731
    j_out, vjp = jax.vjp(fn, *args)
    seeds = (jnp.asarray(d_aggr, j_out[0].dtype),
             jnp.asarray(_slots(d_new, live, jes), j_out[0].dtype) if update else None)
    j_grads = vjp(seeds)

    t_send = torch.from_numpy(send).to(t_dt).requires_grad_(True)
    t_rec = torch.from_numpy(rec).to(t_dt).requires_grad_(True)
    t_edge = torch.from_numpy(edge).to(t_dt).requires_grad_(not raw)
    got = fused_edge_phase(
        t_mlp, None if raw else t_edge, t_send, t_rec, tes,
        embedder=t_emb if raw else None, edge_feats=t_edge if raw else None,
        update_edges=update,
    )
    outs, grads = [got[0]], [torch.from_numpy(d_aggr).to(got[0].dtype)]
    if update:
        outs.append(got[1])
        grads.append(torch.from_numpy(d_new).to(got[1].dtype))
    torch.autograd.backward(outs, grads)
    return dict(j_out=j_out, j_grads=j_grads, live=live, got=got, t_send=t_send,
                t_rec=t_rec, t_edge=t_edge, t_mlp=t_mlp, t_emb=t_emb, raw=raw,
                tes=tes, update=update)


def _check_phase(r) -> tuple[float, float]:
    """Outputs and gradients within their bounds, each in the JAX dtype;
    returns the worst relative errors."""
    live, got, j_out, j_grads = r["live"], r["got"], r["j_out"], r["j_grads"]
    _same_dtype(got[0], j_out[0])
    out_err = _rel(got[0], j_out[0])
    assert not _np(got[0])[-1].any()  # the receiver without edges
    if r["update"]:
        _same_dtype(got[1], j_out[1])
        out_err = max(out_err, _rel(got[1], np.asarray(j_out[1], np.float32)[live]))
    pairs = [(r["t_send"].grad, j_grads[2], live), (r["t_rec"].grad, j_grads[3], None)]
    if not r["raw"]:
        pairs.append((r["t_edge"].grad, j_grads[1], live))
    want = params_from_jax({"m": jax.device_get(j_grads[0])})
    named = [(p, want["m." + n]) for n, p in r["t_mlp"].named_parameters()]
    if r["raw"]:
        want_e = params_from_jax({"e": jax.device_get(j_grads[1])})
        named += [(p, want_e["e." + n]) for n, p in r["t_emb"].named_parameters()]
    grad_err = 0.0
    for t, j, rows in pairs:
        _same_dtype(t, j)
        grad_err = max(grad_err, _rel(t, _np(j) if rows is None else _np(j)[rows]))
    for p, w in named:
        assert p.grad.dtype == p.dtype
        grad_err = max(grad_err, _rel(p.grad, w))
    assert out_err <= OUT_TOL and grad_err <= GRAD_TOL, (out_err, grad_err)
    return out_err, grad_err


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("edge_mode,update,b", PHASE_CASES)
def test_fused_phase_and_backward_match_jax(monkeypatch, mode, edge_mode, update, b):
    """K3's and K4's plain versions (``FusedEdgePhase`` on CPU tensors)
    against ``jax.vjp`` of ``make_fused_interaction`` (interpret), with
    dead slots on the JAX side and a receiver without edges: the
    aggregate, the updated edges, the sender, receiver and edge gradients
    and every weight gradient, each in the JAX dtype. Measured worst:
    outputs 5.4e-3 (bf16), 2.3e-3 (high), 2.3e-3 (high-kernels) of the
    largest entry; gradients 8.8e-3, 9.2e-3 and 1.0e-2."""
    _check_phase(_phase(monkeypatch, mode, edge_mode, update, b))


@pytest.mark.parametrize("edge_mode,update", [("raw", False), ("batched", True)])
def test_bf16_kernels_off_matches_jax(monkeypatch, edge_mode, update):
    """``NEURAL_LAM_TPU_BF16_KERNELS=off`` under mixed precision: the
    float32 kernels with casts at their boundary on both sides (bf16
    outputs, float32 operands). Measured: the same bits as the JAX
    package in every output and gradient."""
    r = _phase(monkeypatch, "bf16", edge_mode, update, 2, kernels="off")
    assert fused_kernels.fused_precision(BF16) == (False, torch.float32)
    assert r["got"][0].dtype == BF16
    _check_phase(r)


def test_plain_version_follows_the_precision(monkeypatch):
    """``fused_edge_phase_plain`` is the plain version of the variant that
    runs: under ``high-kernels`` it equals ``FusedEdgePhase`` on the CPU
    and differs from the float32 phase, which it equals under
    ``highest``."""
    _, tes, _ = _graph()
    rng = np.random.default_rng(6)
    mlp = make_mlp([24, 8, 8], generator=torch.Generator().manual_seed(0))
    edge, send = (torch.from_numpy(rng.normal(size=(N_EDGES, 2, 8)).astype(np.float32))
                  for _ in range(2))
    rec = torch.from_numpy(rng.normal(size=(N_REC, 2, 8)).astype(np.float32))
    outs = {}
    with torch.no_grad():
        for env in ("highest", "high-kernels"):
            monkeypatch.setenv("NEURAL_LAM_TPU_MATMUL_PRECISION", env)
            outs[env] = fused_edge_phase_plain(mlp, edge, send, rec, tes.receivers)
            torch.testing.assert_close(
                fused_edge_phase(mlp, edge, send, rec, tes, update_edges=False)[0],
                outs[env][0], rtol=0, atol=0,
            )
    assert not torch.equal(outs["highest"][0], outs["high-kernels"][0])


# -- the models ------------------------------------------------------------------


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """A root per graph kind, the graph built by the port, read by both
    packages."""
    out = {}
    for kind, (nx, ny) in GRIDS.items():
        root = tmp_path_factory.mktemp(f"torch_bf16_{kind}")
        ds = DummyDatastore(root_path=root, n_grid_x=nx, n_grid_y=ny, n_timesteps=12,
                            computed_stats=True)
        create_graph_from_datastore(ds, root / "graph" / kind,
                                    hierarchical=kind == "hierarchical")
        out[kind] = root
    return out


MODEL_CASES = {
    # name -> (class, graph, model kwargs)
    "graph_lam": ("GraphLAM", "multiscale", {}),
    "graph_lam_h2": ("GraphLAM", "multiscale", dict(hidden_layers=2)),
    "hi_lam": ("HiLAM", "hierarchical", {}),
    "hi_lam_parallel": ("HiLAMParallel", "hierarchical", {}),
}


def _models(roots, name, compute_dtype=True):
    """The JAX model with its ``PRNGKey(0)`` init and the port's holding
    the same weights, both with bf16 compute."""
    cls, graph, kw = MODEL_CASES[name]
    nx, ny = GRIDS[graph]
    ds_kw = dict(n_grid_x=nx, n_grid_y=ny, n_timesteps=12, computed_stats=True)
    jds = JaxDummyDatastore(root_path=roots[graph], **ds_kw)
    tds = DummyDatastore(root_path=roots[graph], **ds_kw)
    kw = dict(hidden_dim=8, processor_layers=2, graph_name=graph, **kw)
    jm = getattr(jax_models, cls)(jds, compute_dtype=jnp.bfloat16, **kw)
    params = jm.init_params(jax.random.PRNGKey(0))
    tm = getattr(models, cls)(tds, device="cpu", compute_dtype=BF16, **kw)
    tm.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    return jds, tds, jm, params, tm


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_model_step_with_bf16_compute_matches_jax(roots, name):
    """One step of each model with ``compute_dtype`` bf16 on bf16 copies
    of the weights, against the JAX model's on the same copies: the new
    state (float32 on both sides) within 2e-2 of its largest entry, the
    static features in bf16. Measured worst: 5.1e-3 (GraphLAM),
    1.7e-3 (hidden_layers=2), 5.4e-3 (HiLAM), 4.3e-3 (HiLAMParallel)."""
    _, tds, jm, params, tm = _models(roots, name)
    assert tm.grid_static_features.dtype == BF16
    assert tm.graph.mesh_static_features[0].dtype == BF16
    assert tm.graph.g2m.features.dtype == BF16
    rng = np.random.default_rng(1)
    n, b = tds.num_grid_points, 2
    d, f = tds.get_num_data_vars("state"), 3 * tds.get_num_data_vars("forcing")
    inputs = [rng.normal(size=(n, b, w)).astype(np.float32) for w in (d, d, f)]
    want, _ = jm.step(_to_bf16(params), *(jnp.asarray(a) for a in inputs))
    copies = {k: p.to(BF16) for k, p in tm.named_parameters()}
    with torch.no_grad():
        got, _ = functional_call(tm, copies, tuple(torch.from_numpy(a) for a in inputs))
    _same_dtype(got, want)
    err = _rel(got, np.asarray(want, np.float32)[:n])
    assert err <= OUT_TOL, err


def test_compute_dtype_names_and_refusals(roots):
    tds = DummyDatastore(root_path=roots["multiscale"], n_grid_x=9, n_grid_y=9,
                         n_timesteps=12, computed_stats=True)
    model = models.GraphLAM(tds, hidden_dim=8, processor_layers=1, device="cpu",
                            compute_dtype="bfloat16")
    assert model.compute_dtype == BF16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with pytest.raises(ValueError, match="compute_dtype"):
        models.GraphLAM(tds, hidden_dim=8, processor_layers=1, device="cpu",
                        compute_dtype=torch.float16)


# -- the trainer -----------------------------------------------------------------


def _trainers(roots, name, lr=1e-3):
    jds, tds, jm, params, tm = _models(roots, name)
    jt = JaxTrainer(JaxARForecaster(jm, jds), jax_config.config_from_dict(CONFIG), jds,
                    JaxTrainingArgs(batch_size=2, lr=lr, precision="bf16"))
    tt = Trainer(ARForecaster(tm, tds), config.config_from_dict(CONFIG), tds,
                 TrainingArgs(batch_size=2, lr=lr, precision="bf16"), device="cpu")
    return jt, params, tt, tm, tds


def _batch(ds, steps, seed=2):
    rng = np.random.default_rng(seed)
    n, d = ds.num_grid_points, ds.get_num_data_vars("state")
    f = 3 * ds.get_num_data_vars("forcing")
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((2, 2, n, d), (2, steps, n, d), (2, steps, n, f)))


def test_bf16_trainer_loss_and_grads_match_jax(roots):
    """``Trainer(precision="bf16")._loss`` and every parameter gradient of
    GraphLAM against ``jax.value_and_grad`` of the JAX trainer's bf16
    ``_loss``: the gradients land on the float32 parameters, in float32.
    Measured: loss 8.5e-4 relative, gradients 3.4e-2 of their largest
    entry (the JAX bf16 gradients are 3.9e-2 from the float32 ones)."""
    jt, params, tt, tm, tds = _trainers(roots, "graph_lam")
    batch = _batch(tds, 1)
    want_loss, want_grads = jax.value_and_grad(jt._loss)(params, *batch)
    got_loss = tt._loss(*batch)
    got_loss.backward()
    assert got_loss.dtype == torch.float32
    assert abs(got_loss.item() - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    assert all(p.grad.dtype == torch.float32 for p in tm.parameters())
    want = export_state_dict(jax.device_get(want_grads))
    got = grads_to_numpy(tm)
    assert sorted(got) == sorted(want)
    worst = max(_rel(got[k], want[k]) for k in want)
    assert worst <= GRAD_TOL, worst


def test_bf16_hi_lam_gradients_as_close_to_float32_as_jax(roots):
    """HiLAM at 2 AR steps (rematerialised): the loss within 2e-2 of the
    JAX trainer's bf16 loss. Its gradients cannot be held entry by entry:
    those of the GNNs far from the loss are 1e-5 to 1e-6 in size, and there
    the JAX package's own bf16 gradients differ from its float32 ones by up
    to 34 % of their largest entry (so by up to 19 % from the port's). So
    each gradient's error against the float32 gradient, relative to its
    largest entry, is averaged over the 256 gradients, and the port's
    average may not exceed the JAX bf16 trainer's. Measured: loss 1.4e-4
    relative; average error 0.073 (port) against 0.090 (JAX bf16)."""
    jt, params, tt, tm, tds = _trainers(roots, "hi_lam")
    batch = _batch(tds, 2)
    want_loss, want_grads = jax.value_and_grad(jt._loss)(params, *batch)
    jt.args.precision = "32"
    _, exact = jax.value_and_grad(jt._loss)(params, *batch)
    got_loss = tt._loss(*batch)
    got_loss.backward()
    assert abs(got_loss.item() - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    want = export_state_dict(jax.device_get(want_grads))
    exact = export_state_dict(jax.device_get(exact))
    got = grads_to_numpy(tm)
    assert sorted(got) == sorted(want) and len(want) == 256
    port = np.mean([_rel(got[k], exact[k]) for k in exact])
    jax_bf16 = np.mean([_rel(want[k], exact[k]) for k in exact])
    assert port <= jax_bf16, (port, jax_bf16)


def test_bf16_train_steps_and_eval_step_match_jax(roots):
    """Three AdamW steps of mixed-precision training from one init, then
    the eval step (float32 parameters on bf16 inputs, the JAX eval step's
    dtypes), against the JAX trainer: the losses within 2e-2 relative;
    the parameters and AdamW's state stay float32. Measured: training
    losses 5.4e-4, eval loss 1.3e-4 relative."""
    jt, params, tt, tm, tds = _trainers(roots, "graph_lam")
    batches = [_batch(tds, 1, seed=10 + k) for k in range(3)]
    step = jt.make_train_step()
    j_params, opt_state = jt.place_state(
        jax.tree_util.tree_map(jnp.array, params), jt.optimizer.init(params)
    )
    want = []
    for batch in batches:
        j_params, opt_state, loss = step(j_params, opt_state, *batch)
        want.append(float(loss))
    got = [tt.train_step(*batch).item() for batch in batches]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    for state in tt.optimizer.state.values():
        assert all(t.dtype == torch.float32 for t in state.values() if torch.is_tensor(t))

    eval_batch = _batch(tds, 2, seed=20)
    want_eval = jt.make_eval_step(2)(j_params, *eval_batch)
    got_eval = tt.make_eval_step(2)(*(torch.from_numpy(a) for a in eval_batch))
    assert got_eval["loss"].dtype == torch.float32
    np.testing.assert_allclose(got_eval["loss"].numpy(), np.asarray(want_eval["loss"]),
                               rtol=LOSS_RTOL)


# -- the v2 route -----------------------------------------------------------------


def _took_v2(jax_edge_sets) -> bool:
    return any(k[0] == "fused_v2" for es in jax_edge_sets for k in es.fn_cache)


@pytest.mark.parametrize("mode", list(MODES) + ["bf16 kernels off", "float32"])
def test_v2_route_takes_a_reduced_precision(monkeypatch, mode):
    """An InteractionNet step (a shared edge state, the edge update) that
    ``fused_v2_routed`` sends to v2 runs there under bf16 inputs (also with
    ``NEURAL_LAM_TPU_BF16_KERNELS=off``), ``high``, ``high-kernels`` and
    float32, in both packages, and the port's outputs and gradients match
    the JAX package's within 2e-2 and 5e-2 of their largest entry (float32
    within 1e-4): the node projections, K7, K8 and K2 in the mode's
    precision, no K1. Measured worst: outputs 8.2e-3 and gradients 3.5e-2
    (bf16 inputs; 9.2e-3 and 3.1e-2 with the kernels off, 1.6e-3 and 7.4e-3
    under ``high``, 2.7e-3 and 9.1e-3 under ``high-kernels``); float32
    3.2e-7 and 5.5e-7."""
    from neural_lam_tpu.ops import interaction as jax_interaction
    from neural_lam_tpu.ops.interaction import init_interaction_net

    bf16 = mode in ("bf16", "bf16 kernels off")
    if mode in MODES:
        _mode(monkeypatch, mode)
    if mode.endswith("off"):
        monkeypatch.setenv("NEURAL_LAM_TPU_BF16_KERNELS", "off")
    monkeypatch.setenv("NEURAL_LAM_TPU_FUSED_V2", "on")
    jes, tes, live = _graph()
    jp = init_interaction_net(jax.random.PRNGKey(5), 8)
    net = interaction.InteractionNet(8)
    net.load_state_dict({k[2:]: v for k, v in params_from_jax({"m": jp}).items()})
    j_dt, t_dt = (jnp.bfloat16, BF16) if bf16 else (jnp.float32, torch.float32)
    if bf16:
        jp, net = _to_bf16(jp), net.to(BF16)
    rng = np.random.default_rng(9)
    send, rec = (rng.normal(size=(n, 2, 8)).astype(np.float32) for n in (N_SEND, N_REC))
    edge = rng.normal(size=(N_EDGES, 8)).astype(np.float32)
    w_rec, w_edge = (rng.normal(size=s).astype(np.float32)
                     for s in ((N_REC, 2, 8), (N_EDGES, 2, 8)))

    def jax_loss(p, s, r, e):
        new_rec, new_edge = jax_interaction.apply_interaction_net(p, jes, s, r, e)
        loss = jnp.sum(new_rec.astype(jnp.float32) * w_rec)
        loss += jnp.sum(new_edge.astype(jnp.float32) * _slots(w_edge, live, jes))
        return loss, (new_rec, new_edge)

    jes.fn_cache.clear()
    (_, j_out), j_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3), has_aux=True)(
        jp, *(jnp.asarray(a, j_dt) for a in (send, rec, _slots(edge, live, jes)))
    )
    assert _took_v2([jes])

    calls = []
    apply = fused_kernels.FusedEdgePhaseV2.apply
    monkeypatch.setattr(fused_kernels.FusedEdgePhaseV2, "apply",
                        lambda *a: calls.append(a[-2]) or apply(*a))
    gather = segment.SenderGather.apply
    monkeypatch.setattr(segment.SenderGather, "apply",
                        lambda *a: calls.append("K1") or gather(*a))
    leaves = [torch.from_numpy(a).to(t_dt).requires_grad_(True) for a in (send, rec, edge)]
    new_rec, new_edge = interaction.apply_interaction_net(net, tes, *leaves)
    ((new_rec.float() * torch.from_numpy(w_rec)).sum()
     + (new_edge.float() * torch.from_numpy(w_edge)).sum()).backward()
    # one v2 application, with bf16 operands unless float32 or kernels off
    assert calls == [mode in MODES]
    out_tol, grad_tol = (OUT_TOL, GRAD_TOL) if mode != "float32" else (1e-4, 1e-4)
    _same_dtype(new_rec, j_out[0])
    _same_dtype(new_edge, j_out[1])
    out_err = max(_rel(new_rec, j_out[0]), _rel(new_edge, np.asarray(j_out[1], np.float32)[live]))
    want = params_from_jax({"m": jax.device_get(j_grads[0])})
    grad_err = max(_rel(p.grad, want["m." + n]) for n, p in net.named_parameters())
    for leaf, j, rows in zip(leaves, j_grads[1:], (None, None, live)):
        _same_dtype(leaf.grad, j)
        grad_err = max(grad_err, _rel(leaf.grad, _np(j) if rows is None else _np(j)[rows]))
    assert out_err <= out_tol and grad_err <= grad_tol, (out_err, grad_err)


def test_bf16_trainer_on_v2_matches_jax(roots, monkeypatch):
    """``Trainer(precision="bf16")._loss`` and every parameter gradient of
    GraphLAM with every fused phase on the v2 route
    (``NEURAL_LAM_TPU_FUSED_V2=on``: the bf16 instantiations of K7 and K8)
    against the JAX bf16 trainer on its v2 route, as
    ``test_bf16_trainer_loss_and_grads_match_jax`` holds the v1 route.
    Measured: loss 6.1e-4 relative, gradients 2.5e-2 of their largest
    entry."""
    monkeypatch.setenv("NEURAL_LAM_TPU_FUSED_V2", "on")
    jt, params, tt, tm, tds = _trainers(roots, "graph_lam")
    batch = _batch(tds, 1)
    want_loss, want_grads = jax.value_and_grad(jt._loss)(params, *batch)
    calls = []
    apply, v1 = fused_kernels.FusedEdgePhaseV2.apply, fused_kernels.FusedEdgePhase.apply
    monkeypatch.setattr(fused_kernels.FusedEdgePhaseV2, "apply",
                        lambda *a: calls.append(a[-2]) or apply(*a))
    monkeypatch.setattr(fused_kernels.FusedEdgePhase, "apply",
                        lambda *a: calls.append("v1") or v1(*a))
    g = jt.forecaster.predictor.graph
    assert _took_v2([p.edges for p in (g.g2m, g.m2g, *g.m2m)])
    got_loss = tt._loss(*batch)
    got_loss.backward()
    assert calls and set(calls) == {True}  # every phase on v2, with bf16 operands
    assert abs(got_loss.item() - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    want = export_state_dict(jax.device_get(want_grads))
    got = grads_to_numpy(tm)
    assert sorted(got) == sorted(want)
    worst = max(_rel(got[k], want[k]) for k in want)
    assert worst <= GRAD_TOL, worst
