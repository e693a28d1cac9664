"""The port's ensemble datastore, data module and npy-files workflow
against the JAX package's, on the CPU.

1. ``EnsembleDummyDatastore`` and ``WeatherDataModule``: the ensemble
   cases of ``tests/test_datasets.py`` on the port, and both packages'
   samples and batches equal (the same seeded arrays through copies of
   the same numpy code: the tolerance is exact equality).
2. The CLIs on a small MEPS npy-files store (``chip_smoke.write_npy_store``
   at 14 x 12 points): the JAX CLI trains one epoch, its checkpoints are
   carried into a port run (``tests/test_torch_cli.py``'s
   ``_carry_across``), then ``--eval test`` and ``predict`` of both CLIs
   agree within 1e-5 relative (float32 on both sides, another summation
   order only). ``predict`` runs the 4 test samples in batches of 3, so
   its tail batch of 1 is padded to 3 by repeating its last sample, in
   both CLIs.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from neural_lam_tpu import predict as jax_predict
from neural_lam_tpu import train_model as jax_train_model
from neural_lam_tpu.dataset import WeatherDataset as JaxWeatherDataset
from neural_lam_tpu.datastore.dummy import DummyDatastore as JaxDummy
from neural_lam_tpu.datastore.dummy import EnsembleDummyDatastore as JaxEnsemble
from neural_lam_tpu.loader import WeatherDataModule as JaxDataModule
from neural_lam_tpu_torch import DataLoader, WeatherDataModule, create_graph, predict, train_model
from neural_lam_tpu_torch.dataset import WeatherDataset
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore, EnsembleDummyDatastore
from test_torch_cli import _carry_across

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("NEURAL_LAM_TPU_PALLAS", "off")


def _assert_same_samples(dataset, jax_dataset):
    assert len(dataset) == len(jax_dataset)
    for i in range(len(dataset)):
        for got, want in zip(dataset[i], jax_dataset[i]):
            np.testing.assert_array_equal(got, want)


# -- 1. the ensemble datastore and the data module ---------------------------------


def test_ensemble_analysis_datastore_exact_values(tmp_path):
    """Members are independent samples, time-major; the port's and the
    JAX package's datasets give the same samples."""
    kw = dict(n_members=3, n_grid_x=4, n_grid_y=4, n_timesteps=10)
    ds = EnsembleDummyDatastore(root_path=tmp_path / "torch", **kw)
    jax_ds = JaxEnsemble(root_path=tmp_path / "jax", **kw)
    dataset = WeatherDataset(ds, split="train", ar_steps=2)
    base_len = 10 - (2 + 2 + 1) + 1
    assert len(dataset) == base_len * 3
    # idx 4 -> sample 1, member 1: times [1, 2] init, [3, 4] targets
    init, target, _, _ = dataset[4]
    np.testing.assert_allclose(init[:, 0, 0], [1 * 100 + 1, 2 * 100 + 1])
    np.testing.assert_allclose(target[:, 0, 0], [3 * 100 + 1, 4 * 100 + 1])
    _assert_same_samples(dataset, JaxWeatherDataset(jax_ds, split="train", ar_steps=2))
    # load_single_member uses member 0 only
    with pytest.warns(UserWarning):
        single = WeatherDataset(ds, split="train", ar_steps=2, load_single_member=True)
    assert len(single) == base_len
    np.testing.assert_allclose(single[1][0][:, 0, 0], [100, 200])
    with pytest.warns(UserWarning):
        jax_single = JaxWeatherDataset(jax_ds, split="train", ar_steps=2,
                                       load_single_member=True)
    _assert_same_samples(single, jax_single)
    for split in ("val", "test"):
        _assert_same_samples(WeatherDataset(ds, split=split, ar_steps=3),
                             JaxWeatherDataset(jax_ds, split=split, ar_steps=3))


def test_ensemble_standardized_arrays_match_the_jax_package(tmp_path):
    """The ensemble store's arrays standardized by its computed stats: the
    same arrays, for each split and category."""
    kw = dict(n_members=2, n_grid_x=4, n_grid_y=3, n_timesteps=9, computed_stats=True)
    ds = EnsembleDummyDatastore(root_path=tmp_path / "torch", **kw)
    jax_ds = JaxEnsemble(root_path=tmp_path / "jax", **kw)
    for split in ("train", "val", "test"):
        for cat in ("state", "forcing"):
            got = ds.get_dataarray(cat, split, standardize=True)
            want = jax_ds.get_dataarray(cat, split, standardize=True)
            assert got.dims == want.dims
            np.testing.assert_array_equal(np.asarray(got.data), np.asarray(want.data))


def test_weather_data_module(tmp_path):
    """The loader bundle (reference: weather_dataset.py:641-772): the
    rollout lengths of its splits, and every batch of each loader, the
    shuffled training one included, equal to the JAX package's."""
    kw = dict(n_grid_x=5, n_grid_y=5, n_timesteps=16)
    ds = DummyDatastore(root_path=tmp_path / "torch", **kw)
    jax_ds = JaxDummy(root_path=tmp_path / "jax", **kw)
    dm = WeatherDataModule(ds, ar_steps_train=1, ar_steps_eval=3, batch_size=2, seed=3)
    jax_dm = JaxDataModule(jax_ds, ar_steps_train=1, ar_steps_eval=3, batch_size=2, seed=3)
    train_batch = next(iter(dm.train_dataloader()))
    assert train_batch[1].shape[1] == 1
    assert next(iter(dm.val_dataloader()))[1].shape[1] == 3
    assert next(iter(dm.test_dataloader()))[0].shape == (2, 2, 25, 3)
    assert isinstance(dm.train_dataloader(), DataLoader)
    for split in ("train", "val", "test"):
        got = list(getattr(dm, f"{split}_dataloader")())
        want = list(getattr(jax_dm, f"{split}_dataloader")())
        assert len(got) == len(want) > 0
        for b_got, b_want in zip(got, want):
            for a, b in zip(b_got, b_want):
                np.testing.assert_array_equal(a, b)


def test_weather_data_module_on_an_ensemble_store(tmp_path):
    """One member per sample with ``load_single_member``, the test split
    as ``eval_split``, the same batches as the JAX package's."""
    store = dict(n_members=2, n_grid_x=4, n_grid_y=4, n_timesteps=10)
    ds = EnsembleDummyDatastore(root_path=tmp_path / "torch", **store)
    jax_ds = JaxEnsemble(root_path=tmp_path / "jax", **store)
    kw = dict(ar_steps_train=2, ar_steps_eval=2, batch_size=3, load_single_member=True,
              eval_split="val")
    with pytest.warns(UserWarning):
        dm = WeatherDataModule(ds, **kw)
    with pytest.warns(UserWarning):
        jax_dm = JaxDataModule(jax_ds, **kw)
    assert len(dm.test_dataset) == 10 - (2 + 2 + 1) + 1
    for split in ("train", "val", "test"):
        for b_got, b_want in zip(getattr(dm, f"{split}_dataloader")(),
                                 getattr(jax_dm, f"{split}_dataloader")()):
            for a, b in zip(b_got, b_want):
                np.testing.assert_array_equal(a, b)


def test_ensemble_computed_stats_are_per_feature():
    """Computed stats over a 4-d (T, member, grid, feat) ensemble store
    reduce to per-feature vectors, equal to the JAX package's."""
    ds = EnsembleDummyDatastore(n_grid_x=3, n_grid_y=3, n_timesteps=8, computed_stats=True)
    jax_ds = JaxEnsemble(n_grid_x=3, n_grid_y=3, n_timesteps=8, computed_stats=True)
    stats = ds.get_standardization_dataarray(category="state")
    want = jax_ds.get_standardization_dataarray(category="state")
    n_feat = ds.get_num_data_vars("state")
    for key in ("state_mean", "state_std", "state_diff_mean_standardized",
                "state_diff_std_standardized"):
        assert stats[key].shape == (n_feat,), (key, stats[key].shape)
        np.testing.assert_array_equal(stats[key], want[key])


# -- 2. the CLIs on an npy-files store, against the JAX CLI ------------------------


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def npy_runs(tmp_path_factory):
    """A small npy-files store (14 x 12 points, 5 stored state features,
    4 kept; 2 members; analysis times 2/1/2; 7 steps a forecast) with the
    port's standardization statistics and 1-level graph, one epoch of the
    JAX CLI, and its checkpoints carried into a port run."""
    from neural_lam_tpu_torch.datastore.npyfilesmeps import compute_standardization_stats

    root = tmp_path_factory.mktemp("torch_npy_cli")
    smoke = _load_chip_smoke()
    config = smoke.write_npy_store(root / "store", 14, 12, splits=(2, 1, 2), members=2,
                                   n_stored=5, removed=(1,), timesteps=7, border=2, seed=1)
    compute_standardization_stats.main(
        ["--datastore_config_path", str(root / "store" / "data_config.yaml")])
    create_graph.main(["--config_path", str(config), "--name", "1level", "--levels", "1"])
    runs = root / "runs"
    common = ["--config_path", str(config), "--graph", "1level", "--hidden_dim", "8",
              "--processor_layers", "2", "--batch_size", "2", "--val_steps_to_log", "1",
              "2", "--ar_steps_eval", "2", "--seed", "3"]
    jax_train_model.main(common + ["--epochs", "1", "--runs_root", str(runs / "jax"),
                                   "--logger_run_name", "run"])
    _carry_across(runs / "jax" / "run", runs / "torch" / "run", config)
    return config, runs, common


def test_npy_eval_metrics_match_the_jax_cli(npy_runs):
    config, runs, common = npy_runs
    argv = common + ["--eval", "test", "--ar_steps_eval", "3", "--logger_run_name", "ev",
                     "--n_example_pred", "0"]
    jax_train_model.main(argv + ["--runs_root", str(runs / "jax"), "--load",
                                 str(runs / "jax" / "run")])
    train_model.main(argv + ["--runs_root", str(runs / "torch"), "--load",
                             str(runs / "torch" / "run")], device="cpu")
    want = json.loads((runs / "jax" / "ev" / "test_metrics.json").read_text())
    got = json.loads((runs / "torch" / "ev" / "test_metrics.json").read_text())
    assert sorted(got) == sorted(want) and "test_loss_unroll2" in got
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)
    np.testing.assert_allclose(
        np.load(runs / "torch" / "ev" / "mean_spatial_loss.npy"),
        np.load(runs / "jax" / "ev" / "mean_spatial_loss.npy"), rtol=RTOL, atol=1e-6,
    )


def test_npy_forecasts_with_a_padded_tail_match_the_jax_cli(npy_runs):
    """4 test samples in batches of 3: the tail batch of 1 is padded to 3
    by repeating its last sample and its padded rows dropped; every file
    equals the JAX CLI's within 1e-5 (relative, and of the mean absolute
    prediction)."""
    config, runs, _ = npy_runs
    argv = ["--config_path", str(config), "--ar_steps", "3", "--batch_size", "3"]
    jax_predict.main(argv + ["--load", str(runs / "jax" / "run" / "checkpoints"
                                           / "min_val_loss"), "--out", str(runs / "fc_jax")])
    predict.main(argv + ["--load", str(runs / "torch" / "run" / "checkpoints"
                                       / "min_val_loss"), "--out", str(runs / "fc_torch")],
                 device="cpu")
    assert (json.loads((runs / "fc_torch" / "forecast_meta.json").read_text())
            == json.loads((runs / "fc_jax" / "forecast_meta.json").read_text()))
    want_files = sorted(p.name for p in (runs / "fc_jax").glob("forecast_*.npz"))
    assert sorted(p.name for p in (runs / "fc_torch").glob("forecast_*.npz")) == want_files
    assert len(want_files) == 4
    for name in want_files:
        want, got = np.load(runs / "fc_jax" / name), np.load(runs / "fc_torch" / name)
        assert sorted(got.files) == sorted(want.files)
        np.testing.assert_array_equal(got["target_times"], want["target_times"])
        scale = np.abs(want["prediction"]).mean()
        np.testing.assert_allclose(got["prediction"], want["prediction"], rtol=RTOL,
                                   atol=RTOL * scale)
