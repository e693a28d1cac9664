"""The port's GraphLAM forecast against the JAX package on the CPU.

Both packages get the same 9x9 DummyDatastore (same seed, so the same
arrays), the same graph on disk, and the same weights: the JAX model's
``init_params`` carried over with ``params_from_jax`` and loaded with
``load_state_dict(strict=True)``. The JAX side runs its Pallas kernels
in interpret mode (``NEURAL_LAM_TPU_PALLAS=interpret``,
``NEURAL_LAM_TPU_FUSED=auto``) and keeps its node arrays block-padded
(``graph_base.py:219-278``), so only the valid node rows are compared;
the port's outputs have exactly the grid's rows.

Tolerance: exact float32 on both sides, different summation order only
(one-hot/block-diagonal matmuls vs plain matmuls and ``index_add_``),
compounded through the encode-process-decode step and a 3-step rollout:
5e-5 absolute and relative on O(1) standardized states.

The MEPS parameter fixture ``tests/fixtures/accuracy/graph_lam_meps_params_seed0.npz``
holds the JAX GraphLAM parameters of ``bench.build_trainer()`` from
``jax.random.PRNGKey(0)`` (hidden 64, 4 processor layers, 17 state, 6
forcing and 4 static features), flattened to ``/``-joined pytree paths.
Parameter shapes do not depend on the grid size, so
:func:`test_meps_params_fixture_is_jax_init` regenerates them on a small
grid and checks every value. Regenerate the file with
``JAX_PLATFORMS=cpu python tests/test_torch_graph_lam.py``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_lam_tpu.convert_checkpoint import export_state_dict
from neural_lam_tpu.datastore.dummy import DummyDatastore as JaxDummyDatastore
from neural_lam_tpu.graphs import (
    create_graph_from_datastore as jax_create_graph,
)
from neural_lam_tpu.graphs import load_graph as jax_load_graph
from neural_lam_tpu.models import ARForecaster as JaxARForecaster
from neural_lam_tpu.models import GraphLAM as JaxGraphLAM
from neural_lam_tpu.trainer import Trainer
from neural_lam_tpu_torch.convert_checkpoint import (
    load_jax_params_npz,
    params_from_jax,
)
from neural_lam_tpu_torch.dataset import WeatherDataset
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.graphs import create_graph_from_datastore, load_graph
from neural_lam_tpu_torch.loader import DataLoader
from neural_lam_tpu_torch.models import ARForecaster, GraphLAM
from neural_lam_tpu_torch.models.graph_buffers import build_graph_buffers
from neural_lam_tpu_torch.predict import run_forecasts
from neural_lam_tpu_torch.config import DatastoreSelection, NeuralLAMConfig
from neural_lam_tpu_torch.trainer import Trainer as TorchTrainer
from neural_lam_tpu_torch.trainer import TrainingArgs as TorchTrainingArgs
from neural_lam_tpu_torch.trainer import standardization_stats, standardize_batch

REPO = Path(__file__).resolve().parent.parent
PARAMS_FIXTURE = REPO / "tests/fixtures/accuracy/graph_lam_meps_params_seed0.npz"
TOL = dict(rtol=5e-5, atol=5e-5)
DS_KW = dict(n_grid_x=9, n_grid_y=9, n_timesteps=12, computed_stats=True)
MODEL_KW = dict(hidden_dim=8, processor_layers=2)
CLAMP = dict(
    output_clamping_lower={"state_var_0": -0.5, "state_var_2": -1.0},
    output_clamping_upper={"state_var_1": 0.5, "state_var_2": 1.0},
)


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("NEURAL_LAM_TPU_PALLAS", "interpret")
    monkeypatch.setenv("NEURAL_LAM_TPU_FUSED", "auto")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """One graph on disk, built by the port, read by both packages."""
    root = tmp_path_factory.mktemp("torch_graph_lam")
    ds = DummyDatastore(root_path=root, **DS_KW)
    create_graph_from_datastore(ds, root / "graph" / "multiscale")
    return root


def _models(root):
    jds = JaxDummyDatastore(root_path=root, **DS_KW)
    tds = DummyDatastore(root_path=root, **DS_KW)
    jm = JaxGraphLAM(jds, **MODEL_KW, **CLAMP)
    params = jm.init_params(jax.random.PRNGKey(0))
    tm = GraphLAM(tds, **MODEL_KW, **CLAMP, device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    return jds, tds, jm, params, tm


def _assert_graph_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = got[key], want[key]
        if isinstance(w, list):
            assert len(g) == len(w), key
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.mark.parametrize("hierarchical", [False, True])
def test_graph_build_matches_jax(tmp_path, hierarchical):
    """The port's graph construction writes the JAX package's arrays,
    and the port's loader reads them as the JAX loader does."""
    kw = dict(DS_KW, n_grid_x=30, n_grid_y=30)  # 3 mesh levels
    jds = JaxDummyDatastore(root_path=tmp_path, **kw)
    tds = DummyDatastore(root_path=tmp_path, **kw)
    jax_create_graph(jds, tmp_path / "jax", hierarchical=hierarchical)
    create_graph_from_datastore(tds, tmp_path / "port", hierarchical=hierarchical)
    with np.load(tmp_path / "jax" / "graph.npz") as want, np.load(
        tmp_path / "port" / "graph.npz"
    ) as got:
        assert sorted(want.files) == sorted(got.files)
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    meta = json.loads((tmp_path / "port" / "metainfo.yaml").read_text())
    assert meta["hierarchical"] is hierarchical
    assert (meta["n_levels"] > 1) is hierarchical
    assert meta["spec_version"] == "tpu-0.1.0"

    # the JAX loader reads the port's JSON metainfo; both loaders agree
    got_h, got = load_graph(tmp_path / "port", 8000.0)
    want_h, want = jax_load_graph(tmp_path / "port", 8000.0)
    assert got_h is want_h is hierarchical
    _assert_graph_dicts_equal(got, want)
    bufs = build_graph_buffers(got_h, got, tds.num_grid_points)
    assert bufs.num_levels == meta["n_levels"]
    assert len(bufs.up) == len(bufs.down) == meta["n_levels"] - 1
    assert bufs.g2m.edges.num_rec == bufs.level_mesh_sizes[0]
    assert bufs.m2g.edges.num_rec == tds.num_grid_points


def test_dataset_batches_match_jax(root):
    from neural_lam_tpu.dataset import WeatherDataset as JaxWeatherDataset
    from neural_lam_tpu.loader import DataLoader as JaxDataLoader

    jds = JaxDummyDatastore(root_path=root, **DS_KW)
    tds = DummyDatastore(root_path=root, **DS_KW)
    want = list(JaxDataLoader(JaxWeatherDataset(jds, "val", ar_steps=3), batch_size=2))
    got = list(DataLoader(WeatherDataset(tds, "val", ar_steps=3), batch_size=2))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_params_from_jax_matches_export_state_dict(root):
    _, _, _, params, tm = _models(root)
    want = export_state_dict(jax.device_get(params))
    got = params_from_jax(jax.device_get(params))
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    assert set(tm.state_dict()) == set(want)


def _inputs(tds, batch, steps=None, seed=1):
    rng = np.random.default_rng(seed)
    n = tds.num_grid_points
    d = tds.get_num_data_vars("state")
    f = tds.get_num_data_vars("forcing") * 3
    if steps is None:
        return [rng.normal(size=(n, batch, w)).astype(np.float32) for w in (d, d, f)]
    return [
        rng.normal(size=(batch, t, n, w)).astype(np.float32)
        for t, w in ((2, d), (steps, f), (steps, d))
    ]


def test_graph_lam_step_matches_jax(root):
    """``GraphLAM.step`` on node-major (N, B, d) inputs, with output
    clamping and computed diff statistics."""
    _, tds, jm, params, tm = _models(root)
    prev, prev_prev, forcing = _inputs(tds, batch=2)
    want, _ = jm.step(params, jnp.asarray(prev), jnp.asarray(prev_prev), jnp.asarray(forcing))
    with torch.no_grad():
        got, std = tm.step(torch.from_numpy(prev), torch.from_numpy(prev_prev), torch.from_numpy(forcing))
    assert std is None and got.shape == prev.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[: prev.shape[0]], **TOL)


def test_forecast_matches_jax(root):
    """A 3-step ``ARForecaster.forward``: the slice as a whole."""
    jds, tds, jm, params, tm = _models(root)
    init, forcing, boundary = _inputs(tds, batch=2, steps=3)
    want, _ = JaxARForecaster(jm, jds).forward(
        params, jnp.asarray(init), jnp.asarray(forcing), jnp.asarray(boundary)
    )
    with torch.no_grad():
        got, std = ARForecaster(tm, tds)(
            torch.from_numpy(init), torch.from_numpy(forcing), torch.from_numpy(boundary)
        )
    assert std is None and got.shape == boundary.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # boundary nodes carry the given boundary states exactly
    mask = tds.boundary_mask.data.astype(bool)
    np.testing.assert_array_equal(got.numpy()[:, :, mask], boundary[:, :, mask])


def test_standardize_batch_matches_jax(root):
    jds = JaxDummyDatastore(root_path=root, **DS_KW)
    tds = DummyDatastore(root_path=root, **DS_KW)
    init, forcing, target = _inputs(tds, batch=2, steps=3)
    jm = JaxGraphLAM(jds, **MODEL_KW)
    from neural_lam_tpu.config import DatastoreSelection, NeuralLAMConfig
    from neural_lam_tpu.trainer import TrainingArgs

    trainer = Trainer(
        JaxARForecaster(jm, jds),
        NeuralLAMConfig(datastore=DatastoreSelection(kind="dummydata", config_path="")),
        jds,
        TrainingArgs(batch_size=2),
    )
    want = trainer.standardize_batch(init, target, forcing)
    got = standardize_batch(
        *(torch.from_numpy(a) for a in (init, target, forcing)),
        standardization_stats(tds),
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_run_forecasts_writes_destandardized_fields(root, tmp_path):
    tds = DummyDatastore(root_path=root, **DS_KW)
    tm = GraphLAM(tds, **MODEL_KW, device="cpu")
    fc = ARForecaster(tm, tds)
    n = run_forecasts(
        fc, tds, split="test", ar_steps=3, batch_size=2, n_samples=3,
        out_dir=tmp_path, device="cpu",
    )
    assert n == 3
    meta = json.loads((tmp_path / "forecast_meta.json").read_text())
    assert meta["ar_steps"] == 3 and meta["grid_shape"] == [9, 9]
    files = sorted(tmp_path.glob("forecast_test_*.npz"))
    assert len(files) == 3
    # the first sample, rolled out directly, destandardized by hand
    stats = standardization_stats(tds)
    init, target, forcing, times = next(
        iter(DataLoader(WeatherDataset(tds, "test", ar_steps=3), batch_size=1))
    )
    with torch.no_grad():
        i_s, t_s, f_s = standardize_batch(
            *(torch.from_numpy(a) for a in (init, target, forcing)), stats
        )
        pred, _ = fc(i_s, f_s, t_s)
    want = pred[0].numpy() * stats["state_std"] + stats["state_mean"]
    with np.load(files[0]) as got:
        # the same rollout at batch 2 vs batch 1: summation order only
        np.testing.assert_allclose(got["prediction"], want, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got["target_times"], times[0])
        assert np.isfinite(got["prediction"]).all()


def test_entry_points_need_cuda_or_cpu(root):
    """Without a GPU, entry points raise unless the CPU is asked for."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tds = DummyDatastore(root_path=root, **DS_KW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphLAM(tds, **MODEL_KW)
    fc = ARForecaster(GraphLAM(tds, **MODEL_KW, device="cpu"), tds)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_forecasts(fc, tds, ar_steps=1, n_samples=1, out_dir=root / "x")
    config = NeuralLAMConfig(datastore=DatastoreSelection(kind="dummydata", config_path=""))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchTrainer(fc, config, tds, TorchTrainingArgs())
    assert TorchTrainer(fc, config, tds, TorchTrainingArgs(), device="cpu").device.type == "cpu"


def _flatten(tree, prefix=""):
    """JAX parameter pytree -> {"a/0/layers/1/w": array}; ``ln: None``
    entries are left out."""
    if tree is None:
        return {}
    if isinstance(tree, (dict, list, tuple)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for key, value in items:
            out.update(_flatten(value, f"{prefix}{key}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def test_meps_params_fixture_is_jax_init(tmp_path):
    """The committed MEPS params equal a fresh JAX init from
    PRNGKey(0) at the MEPS feature counts, and load into the port."""
    kw = dict(
        n_grid_x=9, n_grid_y=9, n_timesteps=8, n_state_features=17,
        n_forcing_features=6, n_static_features=4,
    )
    jds = JaxDummyDatastore(root_path=tmp_path, **kw)
    create_graph_from_datastore(
        DummyDatastore(root_path=tmp_path, **kw), tmp_path / "graph" / "multiscale"
    )
    jm = JaxGraphLAM(jds, hidden_dim=64, processor_layers=4)
    want = _flatten(jax.device_get(jm.init_params(jax.random.PRNGKey(0))))
    with np.load(PARAMS_FIXTURE) as got:
        assert sorted(got.files) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    tm = GraphLAM(DummyDatastore(root_path=tmp_path, **kw), hidden_dim=64,
                  processor_layers=4, device="cpu")
    tm.load_state_dict(params_from_jax(load_jax_params_npz(PARAMS_FIXTURE)), strict=True)


def test_port_imports_neither_jax_nor_reference_package(tmp_path):
    """Import every port module, and run a tiny forecast and a tiny
    training step, in a process where ``jax``, ``neural_lam_tpu`` and
    ``yaml`` cannot be imported."""
    code = f"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "neural_lam_tpu", "yaml"):
    sys.modules[name] = None
import numpy as np, torch
import neural_lam_tpu_torch as pkg
for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(mod.name)
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.graphs import create_graph_from_datastore
from neural_lam_tpu_torch.models import ARForecaster, GraphLAM
from neural_lam_tpu_torch.predict import run_forecasts
ds = DummyDatastore(n_grid_x=9, n_grid_y=9, n_timesteps=8, root_path={str(tmp_path)!r})
create_graph_from_datastore(ds, ds.root_path / "graph" / "multiscale")
fc = ARForecaster(GraphLAM(ds, hidden_dim=4, processor_layers=1, device="cpu"), ds)
assert run_forecasts(fc, ds, ar_steps=2, n_samples=1, out_dir={str(tmp_path / "out")!r}, device="cpu") == 1
from neural_lam_tpu_torch.config import DatastoreSelection, NeuralLAMConfig
from neural_lam_tpu_torch.trainer import Trainer, TrainingArgs
trainer = Trainer(fc, NeuralLAMConfig(datastore=DatastoreSelection(kind="dummydata", config_path="")), ds, TrainingArgs(batch_size=2), device="cpu")
rng = np.random.default_rng(0)
n = ds.num_grid_points
batch = [rng.normal(size=(2, t, n, w)).astype(np.float32) for t, w in ((2, 3), (1, 3), (1, 6))]
losses = [trainer.train_step(*batch).item() for _ in range(3)]
assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
for name in ("config", "loss_weighting", "metrics", "trainer"):
    assert "neural_lam_tpu_torch." + name in sys.modules
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


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    """``chip_smoke.py`` exits non-zero and prints no result line where
    there is no CUDA device, and also where the rest of the repo is
    missing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((REPO / "chip_smoke.py").read_text())
        res = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, env=env,
            capture_output=True, text=True, timeout=300,
        )
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout


def _export_meps_params(path=PARAMS_FIXTURE):
    """Write the MEPS params fixture from ``bench.build_trainer()``."""
    sys.path.insert(0, str(REPO))
    import bench

    trainer, _ = bench.build_trainer()
    params, _ = trainer.init_state(jax.random.PRNGKey(0))
    np.savez_compressed(path, **_flatten(jax.device_get(params)))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    _export_meps_params()
