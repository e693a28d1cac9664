"""The port's hierarchical models (HiLAM, HiLAMParallel) against the JAX
package on the CPU, and the generator of the model-gate fixtures.

Same scheme as ``tests/test_torch_train.py``: both packages get the same
seeded ``DummyDatastore``, the same hierarchical graph on disk (built by
the port, two mesh levels on a 27x27 grid and three on 81x27) and the
same weights (the JAX init carried over with ``params_from_jax``);
inputs come from numpy seeds. The JAX side runs its Pallas kernels in
interpret mode (``NEURAL_LAM_TPU_PALLAS=interpret``,
``NEURAL_LAM_TPU_FUSED=auto``), or, where a test says so, its combined
chunked edge set through XLA (``NEURAL_LAM_TPU_FUSED=off``) or its plain
XLA reference (``NEURAL_LAM_TPU_PALLAS=off``, which the interpreter is
several times slower than; every model and flag also runs interpreted in
at least one test). The port runs its kernels' plain versions, which is
what its wrappers do on CPU tensors.

Tolerances: exact float32 on both sides, different summation order only,
compounded through up to 26 GNN applications per step. States: 5e-5
absolute and relative on O(1) values. Loss: 2e-5 relative. Gradients:
1e-4 of each gradient's largest absolute value. Losses along an AdamW
trajectory: 1e-4 relative; parameters after ``k`` steps within
``0.05 k lr`` (see ``tests/test_torch_train.py`` for why that bound is
absolute).

The model-gate fixtures ``tests/fixtures/accuracy/gate_<model>_meps.npz``
hold, for ``GraphLAM(hidden_layers=2)``, ``HiLAM`` and ``HiLAMParallel``
at the ``bench.py`` configuration (MEPS grid, hidden 64, 4 processor
layers, batch 4) with the parameters of ``chip_smoke.seeded_state_dict``:
the states after AR steps 1 and 3 of the rollout of
``chip_smoke.gate_rollout_inputs`` at every 257th grid node, the training
loss of the ``bench.make_bench_batch`` batch, per gradient its largest
entry and 16 sampled entries, and the losses of three further AdamW
steps at ``lr`` 1e-3, computed by the JAX package on the CPU in exact
float32 with Pallas off. ``chip_smoke.py`` holds the port to them on the
GPU. Regenerate them with
``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_hier.py``;
:func:`test_gate_fixture_path_small_grid` runs the same generator and the
same gate at a small grid.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neural_lam_tpu import config as jax_config
from neural_lam_tpu import models as jax_models
from neural_lam_tpu.convert_checkpoint import convert_state_dict, export_state_dict
from neural_lam_tpu.datastore.dummy import DummyDatastore as JaxDummyDatastore
from neural_lam_tpu.models import ARForecaster as JaxARForecaster
from neural_lam_tpu.trainer import Trainer as JaxTrainer
from neural_lam_tpu.trainer import TrainingArgs as JaxTrainingArgs
from neural_lam_tpu_torch import config, models
from neural_lam_tpu_torch.convert_checkpoint import (
    grads_to_numpy,
    params_from_jax,
    params_to_numpy,
)
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.graphs import create_graph_from_datastore
from neural_lam_tpu_torch.models import ARForecaster, GraphLAM, HiLAM, HiLAMParallel
from neural_lam_tpu_torch.models import hi_lam_parallel
from neural_lam_tpu_torch.ops import interaction
from neural_lam_tpu_torch.predict import run_forecasts
from neural_lam_tpu_torch.trainer import Trainer, TrainingArgs

REPO = Path(__file__).resolve().parent.parent
GRIDS = {2: (27, 27), 3: (81, 27)}  # mesh levels -> grid
MEPS_FEATURES = dict(n_state_features=17, n_forcing_features=6, n_static_features=4)
CONFIG = {"datastore": {"kind": "dummydata", "config_path": "ds.yaml"}}
TOL = dict(rtol=5e-5, atol=5e-5)
FIXTURE_LR = 1e-3
FIXTURE_EXTRA_STEPS = 3
NAMES = {"hi_lam": "HiLAM", "hi_lam_parallel": "HiLAMParallel", "graph_lam": "GraphLAM"}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("NEURAL_LAM_TPU_PALLAS", "interpret")
    monkeypatch.setenv("NEURAL_LAM_TPU_FUSED", "auto")


def _ds_kw(levels):
    nx, ny = GRIDS[levels]
    return dict(n_grid_x=nx, n_grid_y=ny, n_timesteps=12, computed_stats=True)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Per number of mesh levels, a root with the hierarchical and the
    multiscale graph on disk, built by the port, read by both packages."""
    out = {}
    for levels in GRIDS:
        root = tmp_path_factory.mktemp(f"torch_hier{levels}")
        ds = DummyDatastore(root_path=root, **_ds_kw(levels))
        create_graph_from_datastore(
            ds, root / "graph" / "hierarchical", hierarchical=True
        )
        create_graph_from_datastore(ds, root / "graph" / "multiscale")
        out[levels] = root
    return out


def _models(roots, name, levels=2, hidden=8, layers=2, **kw):
    """The JAX model with its ``PRNGKey(0)`` init and the port's model
    holding the same weights."""
    root = roots[levels]
    jds = JaxDummyDatastore(root_path=root, **_ds_kw(levels))
    tds = DummyDatastore(root_path=root, **_ds_kw(levels))
    kw = dict(hidden_dim=hidden, processor_layers=layers, **kw)
    jm = getattr(jax_models, NAMES[name])(jds, **kw)
    params = jm.init_params(jax.random.PRNGKey(0))
    tm = getattr(models, NAMES[name])(tds, device="cpu", **kw)
    tm.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    return jds, tds, jm, params, tm


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _step_inputs(ds, batch, seed=1):
    rng = np.random.default_rng(seed)
    n = ds.num_grid_points
    d = ds.get_num_data_vars("state")
    f = ds.get_num_data_vars("forcing") * 3
    lead = (n,) if batch is None else (n, batch)
    return [rng.normal(size=(*lead, w)).astype(np.float32) for w in (d, d, f)]


def _batch(ds, batch, steps, seed=2):
    """A batch in the order of ``bench.make_bench_batch``: init, target,
    forcing."""
    rng = np.random.default_rng(seed)
    n = ds.num_grid_points
    d = ds.get_num_data_vars("state")
    f = ds.get_num_data_vars("forcing") * 3
    return (
        rng.normal(size=(batch, 2, n, d)).astype(np.float32),
        rng.normal(size=(batch, steps, n, d)).astype(np.float32),
        rng.normal(size=(batch, steps, n, f)).astype(np.float32),
    )


def _assert_grad_dicts_close(got: dict, want: dict, tol=1e-4):
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.shape == w.shape, key
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale, err_msg=key)


def _jax_step(jm, params, inputs):
    out, std = jm.step(params, *(jnp.asarray(a) for a in inputs))
    n = inputs[0].shape[0]
    return np.asarray(out)[:n], None if std is None else np.asarray(std)[:n]


# -- forward -----------------------------------------------------------------------

STEP_CASES = [
    # (model, mesh levels, batch, hidden_layers)
    ("hi_lam", 2, 2, 1),
    ("hi_lam", 3, 1, 1),
    ("hi_lam", 2, None, 2),  # unbatched (N, d) inputs, the unfused route
    ("hi_lam_parallel", 2, 1, 1),
    ("hi_lam_parallel", 3, 2, 1),
    ("hi_lam_parallel", 2, 2, 2),  # per-chunk MLPs on the unfused route
]
# the three-level cases against the plain XLA reference: the two-level
# cases already run each model through the interpreter
XLA_STEP_CASES = {("hi_lam", 3), ("hi_lam_parallel", 3)}


@pytest.mark.parametrize("name,levels,batch,hl", STEP_CASES)
def test_hi_model_step_matches_jax(roots, monkeypatch, name, levels, batch, hl):
    if (name, levels) in XLA_STEP_CASES:
        monkeypatch.setenv("NEURAL_LAM_TPU_PALLAS", "off")
    # two processor layers on three levels (26 GNN applications for HiLAM),
    # one on two levels, where the JAX side runs interpreted
    _, tds, jm, params, tm = _models(
        roots, name, levels, layers=levels - 1, hidden_layers=hl
    )
    assert tm.num_levels == levels == len(tm.level_mesh_sizes)
    inputs = _step_inputs(tds, batch)
    want, _ = _jax_step(jm, params, inputs)
    with torch.no_grad():
        got, std = tm.step(*(_t(a) for a in inputs))
    assert std is None and got.shape == inputs[0].shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name", ["hi_lam", "hi_lam_parallel"])
def test_hi_model_forecast_matches_jax(roots, name):
    """A 3-step ``ARForecaster.forward`` at batch 2 on three mesh levels."""
    jds, tds, jm, params, tm = _models(roots, name, levels=3)
    init, boundary, forcing = _batch(tds, 2, 3)
    want, _ = JaxARForecaster(jm, jds).forward(
        params, jnp.asarray(init), jnp.asarray(forcing), jnp.asarray(boundary)
    )
    with torch.no_grad():
        got, std = ARForecaster(tm, tds)(_t(init), _t(forcing), _t(boundary))
    assert std is None and got.shape == boundary.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


FLAGS = ["g2m_gnn_type", "m2g_gnn_type", "mesh_up_gnn_type", "mesh_down_gnn_type"]


@pytest.mark.parametrize("flag", FLAGS + ["all"])
def test_hi_lam_propagation_flags_match_jax(roots, monkeypatch, flag):
    """Each GNN-type flag set to ``PropagationNet`` (mean aggregation and
    the sender residual on that part of the model), and all four at once:
    the step and its parameter gradients."""
    kw = {f: "PropagationNet" for f in (FLAGS if flag == "all" else [flag])}
    if flag != "all":  # the single flags against the plain XLA reference
        monkeypatch.setenv("NEURAL_LAM_TPU_PALLAS", "off")
    _, tds, jm, params, tm = _models(roots, "hi_lam", layers=1, **kw)
    inputs = _step_inputs(tds, 2, seed=3)
    w = np.random.default_rng(4).normal(size=inputs[0].shape).astype(np.float32)
    n = inputs[0].shape[0]

    def jax_loss(p):
        out, _ = jm.step(p, *(jnp.asarray(a) for a in inputs))
        return jnp.sum(out[:n] * w), out[:n]

    (_, want), want_g = jax.value_and_grad(jax_loss, has_aux=True)(params)
    got, _ = tm.step(*(_t(a) for a in inputs))
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    _assert_grad_dicts_close(
        grads_to_numpy(tm), export_state_dict(jax.device_get(want_g))
    )
    with pytest.raises(ValueError, match="Unknown GNN type"):
        HiLAM(tds, device="cpu", mesh_up_gnn_type="Nope")


def test_hi_lam_parallel_routes_match_each_other_and_both_jax_routes(roots, monkeypatch):
    """``HiLAMParallel(hidden_layers=1)``: the port's per-section fused
    phases, its per-section unfused phases (``fused_edge_phase_supported``
    patched to say no),
    the JAX package's per-section fused kernels and its combined chunked
    edge set (``NEURAL_LAM_TPU_FUSED=off``) all compute the same step and
    the same gradients."""
    _, tds, jm, params, tm = _models(roots, "hi_lam_parallel", layers=1)
    inputs = _step_inputs(tds, 2, seed=5)
    w = np.random.default_rng(6).normal(size=inputs[0].shape).astype(np.float32)
    n = inputs[0].shape[0]

    def jax_run():
        def loss(p):
            out, _ = jm.step(p, *(jnp.asarray(a) for a in inputs))
            return jnp.sum(out[:n] * w), out[:n]

        (_, out), grads = jax.value_and_grad(loss, has_aux=True)(params)
        return np.asarray(out), export_state_dict(jax.device_get(grads))

    def port_run():
        tm.zero_grad(set_to_none=True)
        out, _ = tm.step(*(_t(a) for a in inputs))
        (out * _t(w)).sum().backward()
        return out.detach().numpy(), grads_to_numpy(tm)

    jax_fused = jax_run()
    port_fused = port_run()
    monkeypatch.setenv("NEURAL_LAM_TPU_FUSED", "off")
    for module in (interaction, hi_lam_parallel):
        monkeypatch.setattr(module, "fused_edge_phase_supported", lambda *a: False)
    jax_combined = jax_run()
    port_unfused = port_run()
    for got in (port_fused, port_unfused):
        for want in (jax_fused, jax_combined):
            np.testing.assert_allclose(got[0], want[0], **TOL)
            _assert_grad_dicts_close(got[1], want[1])
    np.testing.assert_allclose(port_fused[0], port_unfused[0], rtol=1e-5, atol=1e-5)
    assert not np.array_equal(port_fused[0], port_unfused[0])  # two routes ran


# -- training ----------------------------------------------------------------------


def _trainers(roots, name, batch_size=2, lr=1e-3, loss="wmse", **model_kw):
    jds, tds, jm, params, tm = _models(roots, name, **model_kw)
    jt = JaxTrainer(
        JaxARForecaster(jm, jds), jax_config.config_from_dict(CONFIG), jds,
        JaxTrainingArgs(batch_size=batch_size, lr=lr, loss=loss),
    )
    tt = Trainer(
        ARForecaster(tm, tds), config.config_from_dict(CONFIG), tds,
        TrainingArgs(batch_size=batch_size, lr=lr, loss=loss), device="cpu",
    )
    return jt, params, tt, tm, tds


LOSS_CASES = [
    # (model, loss, JAX Pallas mode, model kwargs)
    ("hi_lam", "wmse", "interpret", dict(layers=1)),
    ("hi_lam_parallel", "wmse", "off", dict(levels=3, layers=1)),
    ("hi_lam_parallel", "nll", "interpret", dict(output_std=True, layers=1)),
    ("hi_lam", "crps_gauss", "off", dict(output_std=True, hidden_layers=2, layers=1)),
]


@pytest.mark.parametrize("name,loss,pallas,kw", LOSS_CASES)
def test_hi_model_loss_and_grads_match_jax(roots, monkeypatch, name, loss, pallas, kw):
    """``Trainer._loss`` and every parameter gradient for one batch of 2
    at 2 AR steps; with ``output_std=True`` the predicted std feeds the
    ``nll`` / ``crps_gauss`` loss."""
    monkeypatch.setenv("NEURAL_LAM_TPU_PALLAS", pallas)
    jt, params, tt, tm, tds = _trainers(roots, name, loss=loss, **kw)
    assert (tt.per_var_std is None) == bool(kw.get("output_std"))
    batch = _batch(tds, 2, 2)
    want_loss, want_grads = jax.value_and_grad(jt._loss)(params, *batch)
    got_loss = tt._loss(*batch)
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=2e-5)
    _assert_grad_dicts_close(
        grads_to_numpy(tm), export_state_dict(jax.device_get(want_grads))
    )


@pytest.mark.parametrize(
    "name,pallas", [("hi_lam", "off"), ("hi_lam_parallel", "interpret")]
)
def test_hi_model_train_steps_match_jax_trajectory(roots, monkeypatch, name, pallas):
    """Five AdamW steps from one init on identical batches: the losses
    and the final parameters against the JAX ``make_train_step``."""
    monkeypatch.setenv("NEURAL_LAM_TPU_PALLAS", pallas)
    steps, lr = 5, 1e-3
    jt, params, tt, tm, tds = _trainers(roots, name, lr=lr, layers=1)
    batches = [_batch(tds, 2, 1, seed=10 + k) for k in range(steps)]
    step = jt.make_train_step()
    # the jitted step donates its arguments: hand it copies
    j_params, opt_state = jt.place_state(
        jax.tree_util.tree_map(jnp.array, params), jt.optimizer.init(params)
    )
    want_losses = []
    for batch in batches:
        j_params, opt_state, loss = step(j_params, opt_state, *batch)
        want_losses.append(float(loss))
    got_losses = [tt.train_step(*batch).item() for batch in batches]
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    assert got_losses[-1] != got_losses[0]
    want = export_state_dict(jax.device_get(j_params))
    got = params_to_numpy(tm)
    assert sorted(got) == sorted(want)
    worst = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    assert worst <= 0.05 * steps * lr, worst
    mean = np.mean([np.abs(got[k] - want[k]).mean() for k in want])
    assert mean <= 1e-3 * steps * lr, mean


# -- parameters, imports, entry points -----------------------------------------------

PARAM_CASES = [
    ("graph_lam", dict(hidden_layers=2), "processor.module_1.edge_mlp.4.weight"),
    ("hi_lam", dict(levels=3), "mesh_down_gnns.1.0.aggr_mlp.3.bias"),
    ("hi_lam", dict(levels=3), "mesh_up_same_gnns.0.2.edge_mlp.0.weight"),
    ("hi_lam_parallel", dict(levels=3), "processor.module_0.edge_mlp.mlps.6.2.weight"),
    ("hi_lam_parallel", dict(hidden_layers=2), "processor.module_1.aggr_mlp.mlps.1.5.bias"),
]


@pytest.mark.parametrize("name,kw,key", PARAM_CASES)
def test_params_round_trip_equals_export_state_dict(roots, name, kw, key):
    """``params_from_jax`` -> ``load_state_dict`` -> ``params_to_numpy``
    equals ``export_state_dict`` key for key, nested and chunked names
    included."""
    kw = dict(kw)
    if name == "graph_lam":
        kw["graph_name"] = "multiscale"
    _, _, _, params, tm = _models(roots, name, **kw)
    want = export_state_dict(jax.device_get(params))
    assert key in want
    assert list(params_from_jax(jax.device_get(params))) == list(want)
    got = params_to_numpy(tm)
    assert sorted(got) == sorted(want) == sorted(tm.state_dict())
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_hi_lam_parallel_sections_are_the_placed_graph(roots):
    """The sections are read from the model's graph as it stands after
    the move to the model's device, not from the copy the constructor
    started with (on the card that copy stays on the CPU)."""
    tds = DummyDatastore(root_path=roots[3], **_ds_kw(3))
    tm = HiLAMParallel(tds, hidden_dim=4, processor_layers=1, device="cpu")
    g = tm.graph
    assert [ge.edges for _, ge in tm._sections] == [
        ge.edges for ge in (*g.m2m, *g.up, *g.down)
    ]
    assert all(a.edges is b.edges
               for (_, a), b in zip(tm._sections, (*g.m2m, *g.up, *g.down)))
    # each named as its span, gnn.<name>
    assert [name for name, _ in tm._sections] == [
        "m2m.0", "m2m.1", "m2m.2", "mesh_up.0", "mesh_up.1", "mesh_down.0", "mesh_down.1"]
    tm.graph = g.to(torch.device("meta"))
    assert all(ge.edges.rowptr.device.type == "meta" for _, ge in tm._sections)
    assert len(tm._sections) == len(tm.processor["module_0"].edge_mlp.mlps) == 7
    assert tm._section_send_levels == [0, 1, 2, 0, 1, 1, 2]
    assert tm._section_recv_levels == [0, 1, 2, 1, 2, 0, 1]


def test_hierarchical_models_need_a_hierarchical_graph(roots):
    tds = DummyDatastore(root_path=roots[2], **_ds_kw(2))
    for cls in (HiLAM, HiLAMParallel):
        with pytest.raises(ValueError, match="requires a hierarchical mesh graph"):
            cls(tds, graph_name="multiscale", hidden_dim=4, device="cpu")
    with pytest.raises(ValueError, match="does not use a hierarchical"):
        GraphLAM(tds, graph_name="hierarchical", hidden_dim=4, device="cpu")
    assert models.MODELS == {
        "graph_lam": GraphLAM, "hi_lam": HiLAM, "hi_lam_parallel": HiLAMParallel,
    }
    assert sorted(models.MODELS) == sorted(jax_models.MODELS)


def test_hi_entry_points_need_cuda_or_cpu(roots, tmp_path):
    """Without a GPU, the new models raise unless the CPU is asked for,
    and run through ``run_forecasts`` with a std head on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tds = DummyDatastore(root_path=roots[2], **_ds_kw(2))
    for cls in (HiLAM, HiLAMParallel):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(tds, hidden_dim=4, processor_layers=1)
    tm = HiLAMParallel(
        tds, hidden_dim=4, processor_layers=1, output_std=True, device="cpu"
    )
    fc = ARForecaster(tm, tds)
    assert run_forecasts(
        fc, tds, ar_steps=2, batch_size=2, n_samples=2, out_dir=tmp_path, device="cpu"
    ) == 2
    with np.load(tmp_path / "forecast_test_00000.npz") as f:
        assert f["pred_std"].shape == f["prediction"].shape
        assert np.isfinite(f["pred_std"]).all() and (f["pred_std"] > 0).all()


def test_hi_models_import_neither_jax_nor_reference_package(tmp_path):
    """Import every port module, then forecast and train the hierarchical
    models and ``GraphLAM(hidden_layers=2)`` at a tiny size, in a process
    where ``jax`` and ``neural_lam_tpu`` cannot be imported."""
    code = f"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "neural_lam_tpu", "yaml"):
    sys.modules[name] = None
import numpy as np, torch
import neural_lam_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
for name in ("models.hierarchical", "models.hi_lam", "models.hi_lam_parallel"):
    assert "neural_lam_tpu_torch." + name in names
from neural_lam_tpu_torch.config import DatastoreSelection, NeuralLAMConfig
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.graphs import create_graph_from_datastore
from neural_lam_tpu_torch.models import ARForecaster, GraphLAM, HiLAM, HiLAMParallel
from neural_lam_tpu_torch.models import hi_lam_parallel
from neural_lam_tpu_torch.ops import interaction
from neural_lam_tpu_torch.predict import run_forecasts
from neural_lam_tpu_torch.trainer import Trainer, TrainingArgs
ds = DummyDatastore(n_grid_x=27, n_grid_y=27, n_timesteps=8, root_path={str(tmp_path)!r})
create_graph_from_datastore(ds, ds.root_path / "graph" / "hierarchical", hierarchical=True)
create_graph_from_datastore(ds, ds.root_path / "graph" / "multiscale")
cfg = NeuralLAMConfig(datastore=DatastoreSelection(kind="dummydata", config_path=""))
rng = np.random.default_rng(0)
n = ds.num_grid_points
batch = [rng.normal(size=(2, t, n, w)).astype(np.float32) for t, w in ((2, 3), (1, 3), (1, 6))]
for cls, kw in ((HiLAM, {{}}), (HiLAMParallel, {{}}), (HiLAMParallel, dict(hidden_layers=2)),
                (GraphLAM, dict(hidden_layers=2))):
    fc = ARForecaster(cls(ds, hidden_dim=4, processor_layers=1, device="cpu", **kw), ds)
    assert run_forecasts(fc, ds, ar_steps=2, n_samples=1, out_dir={str(tmp_path / "out")!r}, device="cpu") == 1
    trainer = Trainer(fc, cfg, ds, TrainingArgs(batch_size=2), device="cpu")
    losses = [trainer.train_step(*batch).item() for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
assert not any(m == "jax" or m.startswith(("jax.", "neural_lam_tpu.")) for m in sys.modules if sys.modules[m] is not None)
print("isolated ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert "isolated ok" in res.stdout


@pytest.mark.parametrize("script", ["chip_smoke.py", "profile_forecast.py"])
def test_scripts_import_neither_jax_nor_reference_package(script):
    """The card scripts name no module of JAX or of the JAX package."""
    import ast

    tree = ast.parse((REPO / script).read_text())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            imported.add(node.module)
    roots_ = {name.split(".")[0] for name in imported}
    assert not roots_ & {"jax", "jaxlib", "neural_lam_tpu", "optax", "flax"}
    assert "neural_lam_tpu_torch" in roots_ or script == "profile_forecast.py"


# -- the model-gate fixtures -----------------------------------------------------------


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _write_gate_fixture(smoke, name: str, jds, path: Path, batch: int = 4) -> None:
    """The fixture of one of ``chip_smoke.GATE_MODELS`` from the JAX
    package on ``jds`` (see the module docstring for the file's layout).
    The graph must be on disk under the datastore's root."""
    cls, graph_name, kwargs = smoke.GATE_MODELS[name]
    jm = getattr(jax_models, cls)(
        jds, graph_name=graph_name, hidden_dim=smoke.HIDDEN,
        processor_layers=smoke.PROC_LAYERS, **kwargs,
    )
    fc = JaxARForecaster(jm, jds)
    template = fc.init_params(jax.random.PRNGKey(0))
    shapes = {
        k: v.shape for k, v in export_state_dict(jax.device_get(template)).items()
    }
    params = convert_state_dict(smoke.seeded_state_dict(shapes), template)

    steps, stride = smoke.GATE_ROLLOUT_STEPS, smoke.GATE_NODE_STRIDE
    pred, _ = jax.jit(fc.forward)(params, *smoke.gate_rollout_inputs(jds, batch, steps))
    states = np.asarray(pred)[:, [0, steps - 1]][:, :, ::stride]

    trainer = JaxTrainer(
        fc, jax_config.config_from_dict(CONFIG), jds,
        JaxTrainingArgs(batch_size=batch, lr=FIXTURE_LR),
    )
    data = smoke.bench_batch(jds, batch)
    value_and_grad = jax.jit(jax.value_and_grad(trainer._loss))
    tx = optax.adamw(FIXTURE_LR, b1=0.9, b2=0.95, weight_decay=0.01)
    opt_state = tx.init(params)
    losses, first_grads = [], None
    for _ in range(1 + FIXTURE_EXTRA_STEPS):
        loss, grads = value_and_grad(params, *data)
        losses.append(float(loss))
        if first_grads is None:
            first_grads = export_state_dict(jax.device_get(grads))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    names = sorted(first_grads)
    flat = [np.asarray(first_grads[k], np.float32).ravel() for k in names]
    np.savez_compressed(
        path,
        states=states.astype(np.float32),
        rollout_steps=np.int64(steps),
        node_stride=np.int64(stride),
        losses=np.array(losses, np.float64),
        lr=np.float64(FIXTURE_LR),
        batch=np.int64(batch),
        grid=np.array([jds.grid_shape_state.x, jds.grid_shape_state.y], np.int64),
        grad_names=np.array(names),
        grad_max=np.array([np.abs(g).max() for g in flat], np.float32),
        grad_samples=np.stack([g[smoke.grad_sample_index(g.size)] for g in flat]),
    )


@pytest.mark.parametrize("name", ["hi_lam_parallel"])
def test_gate_fixture_path_small_grid(tmp_path, monkeypatch, name):
    """The fixtures' generator and ``chip_smoke.py``'s model gate, end to
    end at a 27x27 grid with the MEPS feature counts and widths and two
    processor layers, for the model with per-chunk parameter names (the
    generator and the gate are the same code for all three models); a
    wrong state and a wrong gradient each fail the gate."""
    smoke = _load_chip_smoke()
    lines = []
    monkeypatch.setattr(smoke, "GATE_NODE_STRIDE", 7)
    monkeypatch.setattr(smoke, "PROC_LAYERS", 2)
    monkeypatch.setattr(smoke, "log", lines.append)
    monkeypatch.setenv("NEURAL_LAM_TPU_PALLAS", "off")  # as the generator runs
    kw = dict(n_grid_x=27, n_grid_y=27, n_timesteps=8, root_path=tmp_path, **MEPS_FEATURES)
    tds = DummyDatastore(**kw)
    tm = smoke.build_model(torch, name, tds, device="cpu")  # builds the graph
    path = tmp_path / "gate.npz"
    _write_gate_fixture(smoke, name, JaxDummyDatastore(**kw), path)

    report = smoke.phase_model_gate(torch, name, tm, tds, path)
    assert report["state_max_rel"] <= smoke.GATE_STATE_MAX_REL
    assert report["loss_rel"] <= smoke.TRAIN_LOSS_RTOL
    assert report["grad_rel"] <= smoke.TRAIN_GRAD_TOL
    assert len(report["losses"]) == 1 + FIXTURE_EXTRA_STEPS
    assert sum(f"{name} gate" in line for line in lines) == 2
    n_app = smoke.gnn_applications(tm)
    assert n_app == 12
    want = smoke.expected_launches(tm, training=True)
    assert want["K2 sender_scatter"] == want["K4 fused_edge_phase backward"] == n_app
    assert want["K5 segment_sum"] == 0

    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    for key, match in (("states", "states outside"), ("grad_samples", "is off by")):
        bad = dict(data)
        bad[key] = bad[key] * 1.01
        np.savez_compressed(tmp_path / "bad.npz", **bad)
        smoke.load_seeded(torch, tm)  # the gate trained the model in place
        with pytest.raises(AssertionError, match=match):
            smoke.phase_model_gate(torch, name, tm, tds, tmp_path / "bad.npz")


COUNT_CASES = [
    ("graph_lam_h2", {}), ("hi_lam", {}), ("hi_lam_parallel", {}),
    ("hi_lam_parallel", dict(hidden_layers=2, processor_layers=1)),
]


@pytest.mark.parametrize("name,overrides", COUNT_CASES)
def test_expected_launches_match_the_calls_of_the_plain_versions(
    roots, monkeypatch, name, overrides
):
    """On the CPU a wrapper runs its plain version exactly where it would
    launch its kernel on the card, so counting the plain versions' calls
    over one served step and one training step checks the launch counts
    that ``chip_smoke.py`` derives from the levels and layers (3 levels
    here) and asserts on the card."""
    from neural_lam_tpu_torch.ops import fused_kernels, segment_kernels

    smoke = _load_chip_smoke()
    monkeypatch.setattr(smoke, "HIDDEN", 8)
    calls = dict.fromkeys(smoke.kernel_counters(), 0)
    plain = {
        "K1 sender_gather": (segment_kernels, "sender_gather_plain"),
        "K2 sender_scatter": (segment_kernels, "sender_scatter_plain"),
        "K3 fused_edge_phase": (fused_kernels, "_plain"),
        "K4 fused_edge_phase backward": (fused_kernels, "_plain_bwd"),
        "K5 segment_sum": (segment_kernels, "segment_sum_plain"),
        "K6 receiver_expand": (segment_kernels, "receiver_expand_plain"),
    }
    tds = DummyDatastore(root_path=roots[3], **_ds_kw(3))
    tm = smoke.build_model(torch, name, tds, device="cpu", **overrides)

    def counted(key, fn, depth):
        def wrapper(*args, **kw):
            # K4's plain version differentiates K3's: count the outer call only
            if not depth["k4"] or key != "K3 fused_edge_phase":
                calls[key] += 1
            if key == "K4 fused_edge_phase backward":
                # K4's entry launches its receiver slice; the plain version covers both
                calls[smoke.K4_RECEIVER_SLICE] += 1
                depth["k4"] += 1
                try:
                    return fn(*args, **kw)
                finally:
                    depth["k4"] -= 1
            return fn(*args, **kw)
        return wrapper

    depth = {"k4": 0}
    for key, (module, attr) in plain.items():
        monkeypatch.setattr(module, attr, counted(key, getattr(module, attr), depth))
    inputs = [_t(a) for a in _step_inputs(tds, 2)]
    with torch.no_grad():
        tm.step(*inputs)
    assert calls == smoke.expected_launches(tm, training=False)
    calls.update(dict.fromkeys(calls, 0))
    out, _ = tm.step(*inputs)
    out.sum().backward()
    assert calls == smoke.expected_launches(tm, training=True)
    levels, layers = 3, tm.processor_layers
    assert smoke.gnn_applications(tm) == {
        "graph_lam_h2": 2 + layers,
        "hi_lam": 2 + 2 * (levels - 1) + layers * 2 * (2 * levels - 1),
        "hi_lam_parallel": 2 + 2 * (levels - 1) + layers * (3 * levels - 2),
    }[name]


def test_expected_launches_on_the_node_mlp_route_match_the_plain_versions(roots, monkeypatch):
    """Under ``NEURAL_LAM_TPU_FUSED_AGGR=on`` every HiLAM application runs
    K3 and the node update after it, and in training the node backward
    before K4: the plain versions' calls over one served and one training
    step (3 levels) against ``chip_smoke.expected_launches``, which counts
    each as one launch."""
    from neural_lam_tpu_torch.ops import fused_kernels, segment_kernels

    monkeypatch.setenv("NEURAL_LAM_TPU_FUSED_AGGR", "on")
    smoke = _load_chip_smoke()
    monkeypatch.setattr(smoke, "HIDDEN", 8)
    calls = dict.fromkeys(smoke.kernel_counters(), 0)
    plain = {
        "K1 sender_gather": (segment_kernels, "sender_gather_plain"),
        "K2 sender_scatter": (segment_kernels, "sender_scatter_plain"),
        "K3 fused_edge_phase": (fused_kernels, "_plain"),
        "K4 fused_edge_phase backward": (fused_kernels, "_plain_bwd"),
        "K3 node update": (fused_kernels, "_plain_node"),
        "K4 node backward": (fused_kernels, "_plain_node_bwd"),
    }
    tds = DummyDatastore(root_path=roots[3], **_ds_kw(3))
    tm = smoke.build_model(torch, "hi_lam", tds, device="cpu")
    inner = {"K4 fused_edge_phase backward": "K3 fused_edge_phase",
             "K4 node backward": "K3 node update"}
    depth = dict.fromkeys(inner, 0)

    def counted(key, fn):
        def wrapper(*args, **kw):
            # a backward's plain version differentiates its forward's: count
            # the outer call only
            if not any(depth[b] and inner[b] == key for b in inner):
                calls[key] += 1
            if key not in inner:
                return fn(*args, **kw)
            if key == "K4 fused_edge_phase backward":
                calls[smoke.K4_RECEIVER_SLICE] += 1  # K4's entry launches it
            depth[key] += 1
            try:
                return fn(*args, **kw)
            finally:
                depth[key] -= 1
        return wrapper

    for key, (module, attr) in plain.items():
        monkeypatch.setattr(module, attr, counted(key, getattr(module, attr)))
    inputs = [_t(a) for a in _step_inputs(tds, 2)]
    with torch.no_grad():
        tm.step(*inputs)
    want = smoke.expected_launches(tm, training=False)
    assert want["K3 node update"] == want["K3 fused_edge_phase"] == smoke.gnn_applications(tm)
    assert calls == want
    calls.update(dict.fromkeys(calls, 0))
    out, _ = tm.step(*inputs)
    out.sum().backward()
    want = smoke.expected_launches(tm, training=True)
    assert want["K4 node backward"] == want["K4 fused_edge_phase backward"] > 0
    assert calls == want


@pytest.mark.parametrize("name", ["graph_lam_h2", "hi_lam", "hi_lam_parallel"])
def test_committed_gate_fixture_layout(name):
    """The committed fixture names every parameter of its MEPS model and
    records its own configuration."""
    smoke = _load_chip_smoke()
    with np.load(smoke.gate_fixture(name)) as f:
        names = [str(n) for n in f["grad_names"]]
        assert f["losses"].shape == (1 + FIXTURE_EXTRA_STEPS,)
        assert np.isfinite(f["losses"]).all() and f["losses"][-1] < f["losses"][0]
        assert float(f["lr"]) == FIXTURE_LR and int(f["batch"]) == smoke.BATCH
        assert tuple(f["grid"]) == (smoke.GRID_X, smoke.GRID_Y)
        n_sub = len(range(0, smoke.GRID_X * smoke.GRID_Y, int(f["node_stride"])))
        assert f["states"].shape == (smoke.BATCH, 2, n_sub, smoke.N_STATE)
        assert np.isfinite(f["states"]).all()
        assert f["grad_samples"].shape == (len(names), smoke.GATE_GRAD_SAMPLES)
        assert np.isfinite(f["grad_samples"]).all() and (f["grad_max"] > 0).all()
    prefixes = {
        "graph_lam_h2": ["processor.module_3.edge_mlp.4."],
        "hi_lam": ["mesh_up_same_gnns.3.3.", "mesh_read_gnns.2."],
        "hi_lam_parallel": ["processor.module_3.edge_mlp.mlps.9.", "mesh_embedders.3."],
    }[name]
    for prefix in prefixes:
        assert any(n.startswith(prefix) for n in names), prefix
    assert len(names) == len(set(names)) == {
        "graph_lam_h2": 150, "hi_lam": 880, "hi_lam_parallel": 544,
    }[name]


def _export_gate_fixtures():
    """Write the three fixtures at the MEPS grid (Pallas off, exact f32)."""
    os.environ["NEURAL_LAM_TPU_PALLAS"] = "off"
    os.environ["NEURAL_LAM_TPU_STENCIL"] = "off"
    smoke = _load_chip_smoke()
    root = smoke.CACHE / "meps"
    kw = dict(
        n_grid_x=smoke.GRID_X, n_grid_y=smoke.GRID_Y, n_timesteps=smoke.GATE_TIMESTEPS,
        n_state_features=smoke.N_STATE, n_forcing_features=smoke.N_FORCING,
        n_static_features=smoke.N_STATIC, root_path=root,
    )
    tds = DummyDatastore(**kw)
    for name in sys.argv[1:] or list(smoke.GATE_MODELS):
        graph_name = smoke.GATE_MODELS[name][1]
        graph_dir = root / "graph" / graph_name
        if not (graph_dir / "graph.npz").exists():
            create_graph_from_datastore(
                tds, graph_dir, hierarchical=graph_name == "hierarchical"
            )
        _write_gate_fixture(smoke, name, JaxDummyDatastore(**kw), smoke.gate_fixture(name))
        print(name, smoke.gate_fixture(name).stat().st_size, "bytes", flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    _export_gate_fixtures()
