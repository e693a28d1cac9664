"""The port's training loop against the JAX package's on the CPU.

``fit``, ``make_train_step(scan_steps=k)``, ``evaluate`` with the watched
metrics, the preemption stop, the zero-batch epoch and the prefetch
generator's early exit, each against ``neural_lam_tpu.trainer.Trainer``
or the behaviour its tests pin (``tests/test_trainer.py``). Both packages
get the same seeded ``DummyDatastore``, the same graph on disk and the
same weights (the JAX init carried over with ``params_from_jax``), and
their own loaders over the same samples in the same order. The JAX side
runs with Pallas off, its plain reference, as its own trainer tests run
on the CPU; the port runs its kernels' plain versions, which is what its
wrappers do on CPU tensors. On the CPU ``make_train_step`` is the eager
step; its CUDA graph is held to the eager step in
``tests/test_torch_cuda.py``.

Tolerances: exact float32 on both sides, another summation order only.
Losses and metrics, also along a few AdamW steps: 1e-5 relative.
Parameters after ``k`` AdamW steps are held as in
``tests/test_torch_train.py``: Adam divides each gradient by its running
magnitude, so a weight whose gradient is near zero moves by up to ``lr``
a step on rounding alone, and the bound is absolute in ``k * lr``.
"""

import dataclasses
import os
import signal
import threading

import jax
import numpy as np
import pytest
import torch

from neural_lam_tpu import config as jax_config
from neural_lam_tpu.convert_checkpoint import export_state_dict
from neural_lam_tpu.dataset import WeatherDataset as JaxWeatherDataset
from neural_lam_tpu.datastore.dummy import DummyDatastore as JaxDummyDatastore
from neural_lam_tpu.loader import DataLoader as JaxDataLoader
from neural_lam_tpu.models import ARForecaster as JaxARForecaster
from neural_lam_tpu.models import GraphLAM as JaxGraphLAM
from neural_lam_tpu.trainer import Trainer as JaxTrainer
from neural_lam_tpu.trainer import TrainingArgs as JaxTrainingArgs
from neural_lam_tpu_torch import config
from neural_lam_tpu_torch.convert_checkpoint import params_from_jax, params_to_numpy
from neural_lam_tpu_torch.dataset import WeatherDataset
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.graphs import create_graph_from_datastore
from neural_lam_tpu_torch.loader import DataLoader
from neural_lam_tpu_torch.models import ARForecaster, GraphLAM
from neural_lam_tpu_torch.trainer import Trainer, TrainingArgs

DS_KW = dict(n_grid_x=9, n_grid_y=9, n_timesteps=12, computed_stats=True)
HIDDEN = 16
RTOL = 1e-5
CONFIG = {"datastore": {"kind": "dummydata", "config_path": "ds.yaml"}}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("NEURAL_LAM_TPU_PALLAS", "off")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """One graph on disk, built by the port, read by both packages."""
    root = tmp_path_factory.mktemp("torch_fit")
    ds = DummyDatastore(root_path=root, **DS_KW)
    create_graph_from_datastore(ds, root / "graph" / "multiscale")
    return root


def _trainers(root, layers=1, **args):
    """A JAX trainer and its state, and a port trainer on the CPU holding
    the same weights, both with ``TrainingArgs(**args)``."""
    jds = JaxDummyDatastore(root_path=root, **DS_KW)
    tds = DummyDatastore(root_path=root, **DS_KW)
    jt = JaxTrainer(
        JaxARForecaster(JaxGraphLAM(jds, hidden_dim=HIDDEN, processor_layers=layers), jds),
        jax_config.config_from_dict(CONFIG), jds, JaxTrainingArgs(**args),
    )
    params, opt_state = jt.init_state(jax.random.PRNGKey(0))
    tm = GraphLAM(tds, hidden_dim=HIDDEN, processor_layers=layers, device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    tt = Trainer(
        ARForecaster(tm, tds), config.config_from_dict(CONFIG), tds,
        TrainingArgs(**args), device="cpu",
    )
    return jt, params, opt_state, tt, tm


def _loaders(root, split, ar_steps, batch_size, shuffle):
    """The same samples in the same order from each package's loader."""
    jds = JaxDummyDatastore(root_path=root, **DS_KW)
    tds = DummyDatastore(root_path=root, **DS_KW)
    kw = dict(batch_size=batch_size, shuffle=shuffle, seed=0, prefetch=0)
    return (
        JaxDataLoader(JaxWeatherDataset(jds, split=split, ar_steps=ar_steps), **kw),
        DataLoader(WeatherDataset(tds, split=split, ar_steps=ar_steps), **kw),
    )


def _assert_records_close(got: dict, want: dict) -> None:
    timing = {"epoch_seconds", "input_wait_seconds", "grid_points_per_s"}
    assert sorted(got) == sorted(want)
    for key in sorted(set(want) - timing - {"epoch"}):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)
    assert got["epoch"] == want["epoch"]
    assert all(got[k] >= 0 for k in timing)


def _assert_params_close(tm, params, steps, lr):
    want = export_state_dict(jax.device_get(params))
    got = params_to_numpy(tm)
    worst = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    assert worst <= 0.05 * steps * lr, worst


def test_fit_history_matches_jax(root):
    """Two epochs of ``fit`` with validation, at two processor layers:
    every record's loss and validation metrics, and the weights at the
    end."""
    args = dict(
        lr=1e-3, batch_size=2, val_steps_to_log=(1, 2), metrics_watch=("val_rmse",),
        var_leads_metrics_watch={"state_var_0": [1, 2]},
    )
    jt, params, opt_state, tt, tm = _trainers(root, layers=2, **args)
    j_train, t_train = _loaders(root, "train", 1, 2, shuffle=True)
    j_val, t_val = _loaders(root, "val", 2, 2, shuffle=False)
    params, _, want = jt.fit(params, opt_state, j_train, j_val, epochs=2)
    logged = []
    got = tt.fit(t_train, t_val, epochs=2, log_fn=logged.append)
    assert logged == got and len(got) == 2
    for g, w in zip(got, want):
        _assert_records_close(g, w)
    assert "val_loss_unroll2" in got[0] and "val_rmse_state_var_0_step2" in got[1]
    assert got[1]["train_loss"] < got[0]["train_loss"]
    _assert_params_close(tm, params, 2 * len(t_train), 1e-3)


def test_fit_validates_every_val_interval_epochs(root):
    """With ``val_interval`` 2 only every second epoch's record has the
    validation keys; ``start_epoch`` counts on from where it says."""
    _, _, _, tt, _ = _trainers(root, batch_size=2, val_interval=2, val_steps_to_log=(1,))
    _, t_train = _loaders(root, "train", 1, 2, shuffle=True)
    _, t_val = _loaders(root, "val", 1, 2, shuffle=False)
    history = tt.fit(t_train, t_val, epochs=3, start_epoch=1)
    assert [r["epoch"] for r in history] == [1, 2, 3]
    assert ["val_loss" in r for r in history] == [True, False, True]
    assert all(np.isfinite(r["train_loss"]) for r in history)


def test_fit_profiles_and_warns_on_a_padded_batch(root, tmp_path):
    """``profile_dir`` writes a ``torch.profiler`` trace of steps from step
    2; a short last training batch is padded with its last sample and
    warned about once."""
    _, _, _, tt, _ = _trainers(
        root, batch_size=2, profile_dir=str(tmp_path / "prof"), profile_steps=1,
    )
    train = DataLoader(
        WeatherDataset(DummyDatastore(root_path=root, **DS_KW), split="train", ar_steps=1),
        batch_size=2, shuffle=True, drop_last=False, prefetch=0,
    )
    assert len(train.dataset) % 2 and len(train) >= 3
    with pytest.warns(UserWarning, match="Partial train batch padded") as caught:
        history = tt.fit(train, epochs=2)
    assert len([w for w in caught if "Partial" in str(w.message)]) == 1
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert all(np.isfinite(r["train_loss"]) for r in history)


def test_scan_steps_matches_jax(root):
    """``make_train_step(scan_steps=3)`` over a 3-stack of batches: the
    three losses against JAX's ``lax.scan`` step and against three
    single steps, and the weights after them."""
    jt, params, opt_state, tt, tm = _trainers(root, lr=1e-3, batch_size=2)
    _, loader = _loaders(root, "train", 1, 2, shuffle=True)
    batches = [b[:3] for _, b in zip(range(3), loader)]
    stacked = tuple(np.stack([b[i] for b in batches]) for i in range(3))

    params, _, want = jt.make_train_step(scan_steps=3)(params, opt_state, *stacked)
    got = tt.make_train_step(scan_steps=3)(*stacked)
    assert tuple(got.shape) == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    _assert_params_close(tm, params, 3, 1e-3)

    # the same three steps one at a time, from the same start
    _, _, _, seq, _ = _trainers(root, lr=1e-3, batch_size=2)
    step = seq.make_train_step()
    assert step == seq.train_step  # on the CPU: the eager step
    one_by_one = [step(*b).item() for b in batches]
    np.testing.assert_array_equal(got.numpy(), np.float32(one_by_one))


@pytest.mark.parametrize("scan_steps", [2, 4])
def test_scan_steps_refuses_another_depth(root, scan_steps):
    """A stack of 3 batches given to ``make_train_step(scan_steps=k)`` for
    another ``k`` raises and takes no step."""
    _, _, _, tt, tm = _trainers(root, batch_size=2)
    _, loader = _loaders(root, "train", 1, 2, shuffle=True)
    batches = [b[:3] for _, b in zip(range(3), loader)]
    stacked = tuple(np.stack([b[i] for b in batches]) for i in range(3))
    before = params_to_numpy(tm)
    with pytest.raises(ValueError, match="stacked 3 deep"):
        tt.make_train_step(scan_steps=scan_steps)(*stacked)
    after = params_to_numpy(tm)
    assert all(np.array_equal(after[k], v) for k, v in before.items())


@pytest.mark.parametrize(
    "watch,keys",
    [
        (("val_rmse",), ("rmse",)),
        (("val_mse", "val_mae", "val_wmae"), ("mse", "mae", "wmae")),
        (("val_rmse", "val_mae", "val_wmae"), ("rmse", "mae", "wmae")),
    ],
)
def test_evaluate_watched_metrics_and_tail_match_jax(root, watch, keys):
    """``evaluate`` at batch 3 over a split whose last batch is short:
    the losses per unroll step and the promoted watched scalars against
    JAX, and against the same pass at batch 1 (padded rows dropped)."""
    args = dict(
        batch_size=3, val_steps_to_log=(1, 2), metrics_watch=watch,
        var_leads_metrics_watch={"state_var_0": [1, 2], "state_var_2": [2]},
    )
    jt, params, _, tt, _ = _trainers(root, **args)
    j_val, t_val = _loaders(root, "val", 2, 3, shuffle=False)
    n = len(t_val.dataset)
    assert n % 3, f"needs a short last batch, got {n} samples"
    want = jt.evaluate(params, j_val, "val")
    got = tt.evaluate(t_val, "val")
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)
    for key in keys:
        assert f"val_{key}_state_var_2_step2" in got
    assert not any(k.endswith("_table") for k in got)
    _, t_one = _loaders(root, "val", 2, 1, shuffle=False)
    one = dataclasses.replace(tt.args, batch_size=1)
    tt.args = one
    by_one = tt.evaluate(t_one, "val")
    for key in got:
        np.testing.assert_allclose(got[key], by_one[key], rtol=RTOL, err_msg=key)


def test_unsupported_watch_warns_once(root):
    _, params, _, tt, _ = _trainers(
        root, batch_size=2, val_steps_to_log=(1,), metrics_watch=("val_nll",),
        var_leads_metrics_watch={"state_var_0": [1]},
    )
    _, t_val = _loaders(root, "val", 1, 2, shuffle=False)
    with pytest.warns(UserWarning, match="nll"):
        got = tt.evaluate(t_val, "val")
    assert "val_nll_state_var_0_step1" not in got


def test_preemption_signal_stops_training(root):
    """A SIGTERM during a step: ``fit`` returns after that step with one
    record marked ``preempted`` and no validation, with the keys the JAX
    loop writes for such an epoch."""
    _, _, _, tt, _ = _trainers(root, batch_size=2)
    _, t_train = _loaders(root, "train", 1, 2, shuffle=True)
    _, t_val = _loaders(root, "val", 1, 2, shuffle=False)
    tt.install_preemption_handler()
    step, calls = tt.make_train_step(), []

    def signalled_step(*batch):
        calls.append(1)
        if len(calls) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(*batch)

    tt._train_step = signalled_step
    try:
        history = tt.fit(t_train, t_val, epochs=5)
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        signal.signal(signal.SIGUSR1, signal.SIG_DFL)
    assert tt.preempt_event.is_set()
    assert len(calls) == 2 < len(t_train)
    assert len(history) == 1 and history[0]["preempted"] is True
    assert sorted(history[0]) == sorted([
        "epoch", "train_loss", "epoch_seconds", "input_wait_seconds",
        "grid_points_per_s", "preempted",
    ])
    assert np.isfinite(history[0]["train_loss"])


def test_fit_zero_batch_epoch_matches_jax(root):
    """An epoch without a batch records a NaN loss, as the JAX loop does."""

    class EmptyLoader:
        def set_epoch(self, epoch):
            pass

        def __iter__(self):
            return iter(())

    jt, params, opt_state, tt, _ = _trainers(root, batch_size=2)
    _, _, want = jt.fit(params, opt_state, EmptyLoader(), epochs=1)
    got = tt.fit(EmptyLoader(), epochs=1)
    assert len(got) == 1 and sorted(got[0]) == sorted(want[0])
    assert np.isnan(got[0]["train_loss"]) and np.isnan(want[0]["train_loss"])


def test_device_prefetch_early_exit_joins_producer(root):
    """Abandoning the prefetch generator unblocks and joins the producer
    thread instead of leaving it on a full queue."""
    _, _, _, tt, _ = _trainers(root, batch_size=2)
    _, t_train = _loaders(root, "train", 1, 2, shuffle=True)
    t_train.set_epoch(0)
    gen = tt.device_prefetch(t_train, depth=1)
    (init, target, forcing), real = next(gen)
    assert real == 2 and init.dtype == torch.float32
    gen.close()
    assert not any(
        t.name == "neural-lam-prefetch" and t.is_alive() for t in threading.enumerate()
    )


def test_device_put_batch_pads_with_the_last_sample(root):
    """A short batch is padded to ``batch_size`` with copies of its last
    sample; ``real`` counts the samples before padding."""
    _, _, _, tt, _ = _trainers(root, batch_size=4)
    _, loader = _loaders(root, "val", 1, 3, shuffle=False)
    batch = next(iter(loader))
    (init, target, forcing), real = tt.device_put_batch(batch)
    assert real == 3 and init.shape[0] == target.shape[0] == forcing.shape[0] == 4
    for got, host in zip((init, target, forcing), batch):
        np.testing.assert_array_equal(got[:3].numpy(), host)
        np.testing.assert_array_equal(got[3].numpy(), host[2])


def test_training_args_defaults_match_jax():
    """Every field of the port's ``TrainingArgs`` is one of the JAX
    package's, with the same default."""
    jax_fields = {f.name: f for f in dataclasses.fields(JaxTrainingArgs)}
    for f in dataclasses.fields(TrainingArgs):
        assert f.name in jax_fields, f.name
        assert f.default == jax_fields[f.name].default, f.name
