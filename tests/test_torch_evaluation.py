"""The port's test-phase evaluation, loggers and figures.

Mirrors ``tests/test_evaluation.py`` and ``tests/test_loggers.py`` on the
port (CPU, the kernels' plain versions), and holds
``evaluation.run_test_evaluation`` to the JAX package's on a dummy
datastore with the JAX weights carried over: the metrics, the tables and
the mean spatial loss within 1e-5 relative (float32 on both sides,
another summation order only). Where matplotlib is missing the metrics
and tables are still written and stderr names the figures not drawn.
"""

import json
import sys
import types

import jax
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from neural_lam_tpu.config import DatastoreSelection as JaxSelection  # noqa: E402
from neural_lam_tpu.config import NeuralLAMConfig as JaxConfig  # noqa: E402
from neural_lam_tpu.dataset import WeatherDataset as JaxWeatherDataset  # noqa: E402
from neural_lam_tpu.datastore.dummy import DummyDatastore as JaxDummyDatastore  # noqa: E402
from neural_lam_tpu.evaluation import run_test_evaluation as jax_evaluation  # noqa: E402
from neural_lam_tpu.loader import DataLoader as JaxDataLoader  # noqa: E402
from neural_lam_tpu.models import ARForecaster as JaxARForecaster  # noqa: E402
from neural_lam_tpu.models import GraphLAM as JaxGraphLAM  # noqa: E402
from neural_lam_tpu.trainer import Trainer as JaxTrainer  # noqa: E402
from neural_lam_tpu.trainer import TrainingArgs as JaxTrainingArgs  # noqa: E402
from neural_lam_tpu_torch import evaluation, vis  # noqa: E402
from neural_lam_tpu_torch.config import DatastoreSelection, NeuralLAMConfig  # noqa: E402
from neural_lam_tpu_torch.convert_checkpoint import params_from_jax  # noqa: E402
from neural_lam_tpu_torch.dataset import WeatherDataset  # noqa: E402
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore  # noqa: E402
from neural_lam_tpu_torch.evaluation import run_test_evaluation  # noqa: E402
from neural_lam_tpu_torch.graphs import create_graph_from_datastore  # noqa: E402
from neural_lam_tpu_torch.loader import DataLoader  # noqa: E402
from neural_lam_tpu_torch.loggers import (  # noqa: E402
    BaseLogger,
    CSVLogger,
    MLFlowLogger,
    NullLogger,
    WandbLogger,
    setup_training_logger,
)
from neural_lam_tpu_torch.models import ARForecaster, GraphLAM  # noqa: E402
from neural_lam_tpu_torch.trainer import Trainer, TrainingArgs  # noqa: E402

DS_KW = dict(n_grid_x=10, n_grid_y=10, n_timesteps=14)
RTOL = 1e-5


class _CountingLogger(BaseLogger):
    def __init__(self):
        self.images = []
        self.metrics = {}

    def log_metrics(self, metrics, step=None):
        self.metrics.update(metrics)

    def log_image(self, key, figure, step=None):
        self.images.append(key)


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("NEURAL_LAM_TPU_PALLAS", "off")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A dummy datastore, its 1-level graph and the JAX GraphLAM's
    parameters, carried into the port's model."""
    root = tmp_path_factory.mktemp("torch_eval_ds")
    ds = DummyDatastore(root_path=root, **DS_KW)
    create_graph_from_datastore(ds, root / "graph" / "1level", n_max_levels=1)
    jds = JaxDummyDatastore(root_path=root, **DS_KW)
    jm = JaxGraphLAM(jds, graph_name="1level", hidden_dim=8, processor_layers=2)
    params = jm.init_params(jax.random.PRNGKey(0))
    model = GraphLAM(ds, graph_name="1level", hidden_dim=8, processor_layers=2, device="cpu")
    model.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    config = NeuralLAMConfig(datastore=DatastoreSelection(kind="dummydata", config_path=""))
    return ds, ARForecaster(model, ds), config, jds, JaxARForecaster(jm, jds), params


def _run(setup, run_dir, batch_size, n_example_pred=0, **kw):
    ds, fc, config = setup[:3]
    trainer = Trainer(fc, config, ds, TrainingArgs(batch_size=batch_size,
                                                   val_steps_to_log=(1,)), device="cpu")
    dataset = WeatherDataset(ds, split="test", ar_steps=2)
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=False)
    logger = _CountingLogger()
    metrics = run_test_evaluation(trainer, loader, ds, run_dir, logger=logger, split="test",
                                  n_example_pred=n_example_pred, **kw)
    return metrics, logger, len(dataset)


def test_spatial_loss_unbiased_by_tail_padding(setup, tmp_path):
    ds = setup[0]
    n = len(WeatherDataset(ds, split="test", ar_steps=2))
    assert n % 4 != 0, f"fixture must leave a ragged tail (n={n})"
    _run(setup, tmp_path / "ragged", 4)
    _run(setup, tmp_path / "b1", 1)
    np.testing.assert_allclose(np.load(tmp_path / "ragged" / "mean_spatial_loss.npy"),
                               np.load(tmp_path / "b1" / "mean_spatial_loss.npy"),
                               rtol=2e-5, atol=1e-7)


def test_example_plots_span_batches(setup, tmp_path):
    n_examples = 3
    _, logger, n = _run(setup, tmp_path, batch_size=2, n_example_pred=n_examples)
    assert n >= n_examples
    n_vars = len(setup[0].get_vars_names("state"))
    keys = [k for k in logger.images if "_example_" in k]
    assert len(keys) == n_examples * n_vars
    assert {k.split("_example_")[1].split("/")[0] for k in keys} == {"0", "1", "2"}


def test_evaluation_matches_jax(setup, tmp_path):
    """Metrics with watched rmse/mae/mse/wmae scalars, the RMSE and MAE
    tables and the mean spatial loss, against the JAX package's on the
    same weights and samples; the same files."""
    ds, fc, config, jds, jfc, params = setup
    watch = dict(metrics_watch=["test_rmse", "test_mae", "test_mse", "test_wmae"],
                 var_leads_metrics_watch={"state_var_0": [1, 2], "state_var_2": [2]})
    jt = JaxTrainer(jfc, JaxConfig(datastore=JaxSelection(kind="dummydata", config_path="")),
                    jds, JaxTrainingArgs(batch_size=3, val_steps_to_log=(1, 2)))
    jloader = JaxDataLoader(JaxWeatherDataset(jds, split="test", ar_steps=2), batch_size=3)
    want = jax_evaluation(jt, params, jloader, jds, tmp_path / "jax", n_example_pred=0,
                          **watch)
    trainer = Trainer(fc, config, ds, TrainingArgs(batch_size=3, val_steps_to_log=(1, 2)),
                      device="cpu")
    loader = DataLoader(WeatherDataset(ds, split="test", ar_steps=2), batch_size=3)
    got = run_test_evaluation(trainer, loader, ds, tmp_path / "torch", n_example_pred=0,
                              **watch)
    assert sorted(got) == sorted(want) and "test_wmae_state_var_2_step2" in got
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)
    assert (sorted(p.name for p in (tmp_path / "torch").iterdir())
            == sorted(p.name for p in (tmp_path / "jax").iterdir()))
    for name in ("test_rmse.csv", "test_mae.csv"):
        w = np.loadtxt(tmp_path / "jax" / name, delimiter=",", skiprows=1)
        g = np.loadtxt(tmp_path / "torch" / name, delimiter=",", skiprows=1)
        np.testing.assert_allclose(g, w, rtol=1e-5)
    np.testing.assert_allclose(np.load(tmp_path / "torch" / "mean_spatial_loss.npy"),
                               np.load(tmp_path / "jax" / "mean_spatial_loss.npy"),
                               rtol=RTOL, atol=1e-7)
    assert json.loads((tmp_path / "torch" / "test_metrics.json").read_text()) == got


def test_without_matplotlib_tables_are_written(setup, tmp_path, monkeypatch, capsys):
    """No matplotlib: the metrics, CSV tables and spatial loss are
    written, no figure, and one stderr line names what was not drawn."""
    monkeypatch.setattr(evaluation, "_import_vis",
                        lambda: (None, "No module named 'matplotlib'"))
    metrics, logger, _ = _run(setup, tmp_path, batch_size=2, n_example_pred=1)
    assert not logger.images
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["mean_spatial_loss.npy", "test_mae.csv", "test_metrics.json",
                     "test_rmse.csv"]
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "No module named 'matplotlib'" in err[0]
    for name in ("test example predictions", "test_rmse_heatmap.pdf",
                 "test_spatial_loss_step2.pdf"):
        assert name in err[0]
    assert metrics["test_loss"] > 0


def test_save_metrics_csv_matches_jax(setup, tmp_path):
    from neural_lam_tpu.vis import save_metrics_csv as jax_save

    jds = setup[3]
    errors = np.abs(np.random.default_rng(0).normal(size=(3, 3)))
    jax_save(errors, jds, tmp_path / "a.csv")
    vis.save_metrics_csv(errors, setup[0], tmp_path / "b.csv")
    assert (tmp_path / "a.csv").read_text() == (tmp_path / "b.csv").read_text()


# -- loggers (tests/test_loggers.py on the port) ---------------------------------


@pytest.fixture()
def fig():
    f = plt.figure(figsize=(1, 1))
    yield f
    plt.close(f)


def test_csv_logger_roundtrip(tmp_path, fig):
    logger = CSVLogger(tmp_path)
    logger.log_hparams({"lr": 1e-3, "model": "graph_lam"})
    logger.log_metrics({"train_loss": 1.5}, step=0)
    logger.log_metrics({"train_loss": 1.25, "val_loss": 2.0}, step=1)
    logger.log_image("val/example", fig, step=1)
    logger.finish()
    records = [json.loads(line)
               for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert records[0] == {"train_loss": 1.5, "step": 0}
    assert records[1]["val_loss"] == 2.0
    assert json.loads((tmp_path / "hparams.json").read_text())["model"] == "graph_lam"
    assert (tmp_path / "figures" / "val_example_1.png").exists()


class _FakeWandb(types.ModuleType):
    def __init__(self):
        super().__init__("wandb")
        self.calls = []
        self.init_kwargs = None

    def init(self, **kwargs):
        self.init_kwargs = kwargs
        self.run = types.SimpleNamespace(
            config=types.SimpleNamespace(update=lambda *a, **k: self.calls.append(("config", a))),
            define_metric=lambda key, summary=None: self.calls.append(
                ("define_metric", key, summary)),
        )
        return self.run

    def log(self, data, step=None):
        self.calls.append(("log", data, step))

    def Image(self, figure):
        return ("image", figure)

    def finish(self):
        self.calls.append(("finish",))


def test_wandb_adapter_contract(monkeypatch, fig):
    fake = _FakeWandb()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    logger = WandbLogger(project="proj", run_name="run", run_id="abc123", config={"a": 1})
    assert fake.init_kwargs["id"] == "abc123" and fake.init_kwargs["resume"] == "allow"
    logger.watch_min_metrics(["val_loss", "val_loss_unroll1"])
    logger.log_metrics({"loss": 1.0}, step=3)
    logger.log_image("examples/t2m", fig, step=3)
    logger.finish()
    assert [c[0] for c in fake.calls] == [
        "define_metric", "define_metric", "log", "log", "finish"]
    assert fake.calls[0][1:] == ("val_loss", "min")
    assert fake.calls[2][1:] == ({"loss": 1.0}, 3)
    assert fake.calls[3][1]["examples/t2m_step3"] == ("image", fig)
    assert fake.calls[3][2] is None


class _FakeMLflow(types.ModuleType):
    def __init__(self):
        super().__init__("mlflow")
        self.calls = []

    def set_tracking_uri(self, uri):
        self.calls.append(("uri", uri))

    def set_experiment(self, name):
        self.calls.append(("experiment", name))

    def start_run(self, run_name=None):
        self.calls.append(("start", run_name))
        return types.SimpleNamespace()

    def log_metrics(self, metrics, step=None):
        self.calls.append(("metrics", metrics, step))

    def log_figure(self, figure, name):
        self.calls.append(("figure", name))

    def log_params(self, params):
        self.calls.append(("params", params))

    def end_run(self):
        self.calls.append(("end",))


def test_mlflow_adapter_contract(monkeypatch, fig):
    fake = _FakeMLflow()
    monkeypatch.setitem(sys.modules, "mlflow", fake)
    logger = MLFlowLogger(experiment="exp", run_name="r1", tracking_uri="file:/tmp/mlf")
    logger.log_metrics({"loss": np.float32(2.5)}, step=1)
    logger.log_image("maps/pred", fig, step=4)
    logger.log_hparams({"hidden_dim": 64})
    logger.finish()
    assert [c[0] for c in fake.calls] == [
        "uri", "experiment", "start", "metrics", "figure", "params", "end"]
    (_, metrics, step) = fake.calls[3]
    assert isinstance(metrics["loss"], float) and step == 1
    assert fake.calls[4][1] == "maps_pred_4.png"
    assert fake.calls[5][1] == {"hidden_dim": "64"}


@pytest.mark.parametrize("backend", ["wandb", "mlflow"])
def test_setup_logger_fallbacks(tmp_path, monkeypatch, capsys, backend):
    assert isinstance(setup_training_logger("none", tmp_path), NullLogger)
    monkeypatch.setitem(sys.modules, backend, None)
    assert isinstance(setup_training_logger(backend, tmp_path), CSVLogger)
    assert "falling back to CSV logger" in capsys.readouterr().out
    with pytest.raises(ValueError, match="Unknown logger"):
        setup_training_logger("tensorboard", tmp_path)


def test_plot_error_map_deprecated_alias():
    ds = DummyDatastore(n_grid_x=4, n_grid_y=4, n_timesteps=8)
    errors = np.abs(np.random.default_rng(0).normal(size=(3, 3)))
    with pytest.warns(DeprecationWarning):
        fig = vis.plot_error_map(errors, ds)
    plt.close(fig)
    for plot in (vis.plot_error_heatmap(errors, ds),
                 vis.plot_spatial_error(np.arange(16.0), ds),
                 vis.plot_prediction(np.arange(16.0), np.ones(16), ds, title="t")):
        assert plot.axes
        plt.close(plot)
