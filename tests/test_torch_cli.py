"""The port's entry points: create_graph, train_model, predict.

Two parts, both on the CPU (``device="cpu"``, the kernels' plain
versions):

1. ``tests/test_cli.py`` on the port: create a graph, train two epochs,
   evaluate from the checkpoint, ``--eval`` without ``--load`` warns, the
   ``--load`` forms, a resume continues the epochs and keeps the best
   checkpoint, the kernel flags, the reference-compat flags, the forecast
   export; and what the JAX CLI has and the port does not yet: each such
   flag raises ``SystemExit`` naming its ROADMAP item.
2. The port held to the JAX CLI on one tiny MDP store: the JAX CLI trains
   one epoch; its checkpoints are carried across (``params_from_jax``,
   ``opt_state_from_jax``) into a port run directory; then the test
   metrics (``--eval test``), the losses of a resumed epoch (``--load
   --restore_opt``) and the exported forecasts (``predict``) of both CLIs
   agree within 1e-5 relative (float32 on both sides, another summation
   order only), with the same keys and an equal ``forecast_meta.json``.
   From the same carried-over checkpoint, an epoch under ``--precision
   bf16`` (also with ``--bf16_kernels off``) and under ``--matmul_precision
   high`` and ``high-kernels`` agrees with the JAX CLI's within 2e-2
   relative, the bf16 tolerance of ``tests/test_torch_bf16.py`` (the JAX
   CLI runs with Pallas off here, so its bf16 rounds where XLA's
   operations do), and a bf16 run's checkpoint loads into a float32 run.
"""

import importlib.util
import json
import shutil
import signal
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from neural_lam_tpu import predict as jax_predict
from neural_lam_tpu import train_model as jax_train_model
from neural_lam_tpu.checkpoint import CheckpointManager as JaxCheckpointManager
from neural_lam_tpu.checkpoint import build_forecaster_from_hparams as jax_build
from neural_lam_tpu.config import load_config_and_datastore as jax_load
from neural_lam_tpu.trainer import make_optimizer as jax_make_optimizer
from neural_lam_tpu_torch import create_graph, predict, train_model
from neural_lam_tpu_torch.checkpoint import (
    CheckpointManager,
    build_forecaster_from_hparams,
    load_forecaster_from_checkpoint,
)
from neural_lam_tpu_torch.config import load_config_and_datastore
from neural_lam_tpu_torch.convert_checkpoint import opt_state_from_jax, params_from_jax
from neural_lam_tpu_torch.dataset import WeatherDataset
from neural_lam_tpu_torch.ops.fused_kernels import CACHE_PRE_ENV, FUSED_V2_ENV
from neural_lam_tpu_torch.ops.segment import BF16_KERNELS_ENV, MATMUL_PRECISION_ENV
from neural_lam_tpu_torch.trainer import Trainer, TrainingArgs, make_optimizer

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-5
BF16_RTOL = 2e-2


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("NEURAL_LAM_TPU_PALLAS", "off")


@pytest.fixture(scope="module")
def config_path(tmp_path_factory):
    """The dummy datastore of ``tests/test_cli.py`` and its 1-level graph."""
    root = tmp_path_factory.mktemp("torch_cli_ds")
    (root / "dummy.datastore.yaml").write_text(
        yaml.safe_dump({"n_grid_x": 10, "n_grid_y": 10, "n_timesteps": 16, "seed": 7}),
        encoding="utf-8",
    )
    cfg = root / "config.yaml"
    cfg.write_text(
        yaml.safe_dump({"datastore": {"kind": "dummydata",
                                      "config_path": "dummy.datastore.yaml"}}),
        encoding="utf-8",
    )
    create_graph.main(["--config_path", str(cfg), "--name", "1level", "--levels", "1"])
    return cfg


def _common(config_path, runs_root, run_name=None):
    argv = [
        "--config_path", str(config_path),
        "--graph", "1level",
        "--hidden_dim", "8",
        "--processor_layers", "2",
        "--batch_size", "2",
        "--runs_root", str(runs_root),
        "--val_steps_to_log", "1",
    ]
    return argv + (["--logger_run_name", run_name] if run_name else [])


def _history(run_dir):
    return [json.loads(line) for line in (run_dir / "history.jsonl").read_text().splitlines()]


def _main(argv):
    train_model.main(argv, device="cpu")


# -- 1. the port's CLI ------------------------------------------------------------


def test_create_graph_cli(config_path):
    graph_dir = config_path.parent / "graph" / "1level"
    assert (graph_dir / "graph.npz").exists()
    create_graph.main(["--config_path", str(config_path), "--name", "again", "--levels", "1"])
    a = np.load(graph_dir / "graph.npz")
    b = np.load(config_path.parent / "graph" / "again" / "graph.npz")
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        np.testing.assert_array_equal(a[key], b[key])


def test_train_and_eval_cli(config_path, tmp_path):
    runs_root = tmp_path / "runs"
    common = _common(config_path, runs_root, "testrun")
    before = signal.getsignal(signal.SIGTERM)
    _main(common + ["--epochs", "2"])
    # the preemption handler (which holds the trainer) is put back
    assert signal.getsignal(signal.SIGTERM) is before
    run_dir = runs_root / "testrun"
    for name in ("latest", "min_val_loss"):
        assert (run_dir / "checkpoints" / name / "state.pt").exists()
        assert (run_dir / "checkpoints" / name / "hparams.json").exists()
    history = _history(run_dir)
    assert [h["epoch"] for h in history] == [0, 1]
    assert all(np.isfinite([h["train_loss"], h["val_loss"]]).all() for h in history)

    _main(common + ["--eval", "test", "--ar_steps_eval", "2", "--load", str(run_dir),
                    "--logger_run_name", "testeval"])
    eval_dir = runs_root / "testeval"
    metrics = json.loads((eval_dir / "test_metrics.json").read_text(encoding="utf-8"))
    assert "test_loss" in metrics and metrics["test_loss"] > 0
    for name in ("test_rmse.csv", "test_mae.csv", "test_rmse_heatmap.pdf",
                 "test_mae_heatmap.pdf", "test_spatial_loss_step1.pdf",
                 "test_spatial_loss_step2.pdf", "mean_spatial_loss.npy"):
        assert (eval_dir / name).exists(), name


def test_eval_without_load_warns(config_path, tmp_path, capsys):
    _main(_common(config_path, tmp_path / "runs_warn", "warnrun")
          + ["--eval", "test", "--ar_steps_eval", "1"])
    assert "--eval without --load" in capsys.readouterr().out


def test_eval_with_gif_and_watch(config_path, tmp_path):
    runs_root = tmp_path / "runs2"
    common = _common(config_path, runs_root)
    _main(common + ["--epochs", "1", "--logger_run_name", "gifrun"])
    _main(common + [
        "--eval", "test", "--ar_steps_eval", "3", "--load", str(runs_root / "gifrun"),
        "--logger_run_name", "gifeval", "--create_gif", "--metrics_watch", "test_rmse",
        "--var_leads_metrics_watch", '{"state_var_0": [1, 3]}',
    ])
    eval_dir = runs_root / "gifeval"
    metrics = json.loads((eval_dir / "test_metrics.json").read_text(encoding="utf-8"))
    assert "test_rmse_state_var_0_step1" in metrics
    assert "test_rmse_state_var_0_step3" in metrics
    assert list(eval_dir.glob("*.gif")), "expected example-prediction GIFs"
    with pytest.raises(SystemExit, match="unknown state variables"):
        _main(common + ["--eval", "test", "--ar_steps_eval", "1",
                        "--var_leads_metrics_watch", '{"nosuch": [1]}'])


def test_debug_nans_cli(config_path, tmp_path, monkeypatch):
    """``--debug_nans``: normal training completes with the flag; a loss
    that is not finite raises at its step."""
    common = _common(config_path, tmp_path / "runs") + ["--epochs", "1"]
    _main(common + ["--debug_nans", "--logger_run_name", "nanrun"])
    assert _history(tmp_path / "runs" / "nanrun")[0]["epoch"] == 0

    def nan_loss(self, *batch):
        return torch.tensor(float("nan"))

    monkeypatch.setattr(Trainer, "train_step", nan_loss)
    with pytest.raises(FloatingPointError, match="non-finite training loss"):
        _main(common + ["--debug_nans", "--logger_run_name", "nanrun2"])
    # without the flag the epoch ends, its loss not finite
    _main(common + ["--logger_run_name", "nanrun3"])
    assert np.isnan(_history(tmp_path / "runs" / "nanrun3")[0]["train_loss"])


def test_load_accepts_checkpoints_dir_and_named_checkpoint(config_path, tmp_path):
    runs_root = tmp_path / "runs"
    common = _common(config_path, runs_root)
    _main(common + ["--epochs", "1", "--logger_run_name", "loadsrc"])
    run_dir = runs_root / "loadsrc"
    for i, load_path in enumerate((run_dir / "checkpoints",
                                   run_dir / "checkpoints" / "min_val_loss")):
        _main(common + ["--eval", "test", "--ar_steps_eval", "1", "--load", str(load_path),
                        "--logger_run_name", f"loadeval{i}"])
        metrics = json.loads((runs_root / f"loadeval{i}" / "test_metrics.json").read_text())
        assert "test_loss" in metrics
    assert not (runs_root / "checkpoints").exists()
    with pytest.raises(SystemExit, match="no checkpoint"):
        _main(common + ["--eval", "test", "--ar_steps_eval", "1", "--load",
                        str(runs_root / "nosuchrun"), "--logger_run_name", "missing"])


def test_resume_continues_epochs_and_keeps_best(config_path, tmp_path):
    runs_root = tmp_path / "runs"
    common = _common(config_path, runs_root, "resumerun")
    _main(common + ["--epochs", "2"])
    run_dir = runs_root / "resumerun"
    best = json.loads((run_dir / "checkpoints" / "best.json").read_text())
    _main(common + ["--epochs", "4", "--load", str(run_dir), "--restore_opt"])
    history = _history(run_dir)
    assert [h["epoch"] for h in history] == [0, 1, 2, 3]
    best2 = json.loads((run_dir / "checkpoints" / "best.json").read_text())
    assert best2["val_loss"] <= best["val_loss"]
    assert best2["val_loss"] == min(h["val_loss"] for h in history)


def test_kernel_tuning_flags(monkeypatch, capsys):
    """``--fused_v2`` and ``--cache_pre`` set the port's routing variables,
    an explicitly set variable winning; the flags of TPU layouts are
    accepted and named on stderr, and set nothing."""
    import os

    for env in (FUSED_V2_ENV, CACHE_PRE_ENV, "NEURAL_LAM_TPU_PALLAS",
                "NEURAL_LAM_TPU_TILING", "NEURAL_LAM_TPU_ALIGNED"):
        monkeypatch.setenv(env, "sentinel")
        monkeypatch.delenv(env)
    args = train_model.build_parser().parse_args([
        "--config_path", "unused", "--fused_v2", "off", "--cache_pre", "off",
        "--pallas", "interpret", "--kernel_tiling", "sweep", "--aligned_layout", "auto",
    ])
    train_model.apply_kernel_flags(args)
    assert os.environ[FUSED_V2_ENV] == "off" and os.environ[CACHE_PRE_ENV] == "off"
    assert "NEURAL_LAM_TPU_PALLAS" not in os.environ
    assert "NEURAL_LAM_TPU_TILING" not in os.environ
    err = capsys.readouterr().err
    assert "--pallas, --kernel_tiling, --aligned_layout" in err and "no effect" in err
    monkeypatch.setenv(FUSED_V2_ENV, "on")
    train_model.apply_kernel_flags(args)
    assert os.environ[FUSED_V2_ENV] == "on"
    for flag in train_model._KERNEL_FLAG_ENV:
        assert hasattr(args, flag)


@pytest.mark.parametrize("argv", [
    ["--config_path", "x", "--wandb_id", "abc123"],
    ["--config_path", "x", "--epochs", "4", "--load", "r", "--restore_opt"],
    ["--config_path", "x", "--pallas", "interpret", "--matmul_precision", "high-kernels",
     "--cache_pre", "off"],
    ["--config_path", "x", "--eval", "test", "--create_gif", "--metrics_watch", "test_rmse",
     "--var_leads_metrics_watch", '{"state_var_0": [1, 3]}', "--spatial_shards", "4",
     "--devices", "2", "--num_workers", "1", "--num_nodes", "1"],
])
def test_jax_cli_argv_parses_unchanged(argv):
    """Argvs of ``tests/test_cli.py`` parse to the same namespace."""
    got = vars(train_model.build_parser().parse_args(argv))
    assert got == vars(jax_train_model.build_parser().parse_args(argv))


def test_reference_compat_flags(config_path, tmp_path):
    args = train_model.build_parser().parse_args(["--config_path", "x", "--wandb_id", "abc"])
    assert args.logger_run_id == "abc"
    _main(_common(config_path, tmp_path / "runs", "compat")
          + ["--epochs", "1", "--devices", "1", "--num_workers", "1", "--num_nodes", "1"])
    assert (tmp_path / "runs" / "compat" / "history.jsonl").exists()
    with pytest.raises(SystemExit, match="num_nodes"):
        _main(["--config_path", str(config_path), "--num_nodes", "7",
               "--runs_root", str(tmp_path / "runs")])


def test_profile_dir_writes_a_trace(config_path, tmp_path):
    """``--profile_dir`` writes a ``torch.profiler`` trace of the first
    epoch's steps (closed early on an epoch this short)."""
    _main(_common(config_path, tmp_path / "runs", "prof")
          + ["--epochs", "1", "--profile_dir", str(tmp_path / "trace")])
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]


@pytest.mark.parametrize("flags,message", [
    (["--spatial_shards", "4"], "--spatial_shards 4 does not divide the device count 1"),
])
def test_unported_flags_raise(tmp_path, flags, message):
    """No flag is left unported; a flag the launch cannot honour raises
    the JAX CLI's ``SystemExit`` before anything is written (one process
    cannot hold 4 spatial shards)."""
    assert train_model.UNPORTED == ()
    with pytest.raises(SystemExit, match=message):
        _main(["--config_path", "unused", "--runs_root", str(tmp_path)] + flags)
    assert not list(tmp_path.iterdir())


def _group_of_one(monkeypatch):
    """``torchrun``'s environment for one process."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for key, value in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="1",
                           RANK="0", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1").items():
        monkeypatch.setenv(key, value)


def test_multihost_trains_in_a_process_group(config_path, tmp_path, monkeypatch):
    """``--multihost`` joins the process group of ``torchrun``'s
    environment (here one gloo process), trains through ``FlatAdamW``
    (ZeRO-1 on, by default) and leaves the group after; its history is
    the run's without the flag."""
    from neural_lam_tpu_torch.utils import distributed

    _main(_common(config_path, tmp_path / "runs", "plain") + ["--epochs", "1"])
    _group_of_one(monkeypatch)
    _main(_common(config_path, tmp_path / "runs", "group") + ["--epochs", "1", "--multihost"])
    assert not distributed.active()
    (want,), (got,) = _history(tmp_path / "runs" / "plain"), _history(tmp_path / "runs" / "group")
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-6)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-6)
    hparams = json.loads((tmp_path / "runs" / "group" / "checkpoints" / "latest"
                          / "hparams.json").read_text())
    assert hparams["multihost"] is True


def test_num_nodes_against_the_launch_raises(tmp_path):
    """``--num_nodes 2`` in a launch of one node: the JAX CLI's message."""
    with pytest.raises(SystemExit, match="--num_nodes 2 but torch.distributed discovered "
                                         "1 node"):
        _main(["--config_path", "unused", "--runs_root", str(tmp_path), "--num_nodes", "2"])
    assert not list(tmp_path.iterdir())


def test_devices_above_the_local_count_raises(tmp_path):
    """``--devices 2`` with one process on the node: the JAX CLI's message
    (``neural_lam_tpu/train_model.py:455-460``)."""
    with pytest.raises(SystemExit, match=r"--devices 2 outside 1\.\.1 \(local devices per host\)"):
        _main(["--config_path", "unused", "--runs_root", str(tmp_path), "--devices", "2"])
    assert not list(tmp_path.iterdir())


def test_flat_opt_trains_and_resumes(config_path, tmp_path):
    """``--flat_opt``: the same epoch as the per-tensor AdamW, the
    optimizer state saved as one vector, the setting in ``hparams.json``,
    and a resume with ``--load --restore_opt --flat_opt``."""
    runs = tmp_path / "runs"
    _main(_common(config_path, runs, "tensors") + ["--epochs", "1"])
    _main(_common(config_path, runs, "flat") + ["--epochs", "1", "--flat_opt"])
    (want,), (got,) = _history(runs / "tensors"), _history(runs / "flat")
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-6)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-6)
    latest = runs / "flat" / "checkpoints" / "latest"
    assert json.loads((latest / "hparams.json").read_text())["flat_opt"] is True
    saved = torch.load(latest / "state.pt", weights_only=True)["optimizer"]
    n = sum(v.numel() for v in torch.load(latest / "state.pt", weights_only=True)["model"].values())
    assert saved["param_groups"][0]["params"] == [0]
    assert saved["state"][0]["exp_avg"].shape == (n,)
    _main(_common(config_path, runs, "flat") + ["--epochs", "2", "--flat_opt", "--load",
                                                str(runs / "flat"), "--restore_opt"])
    assert [r["epoch"] for r in _history(runs / "flat")] == [0, 1]


def test_matmul_precision_highest_is_the_ports_default(config_path, tmp_path):
    _main(_common(config_path, tmp_path, "hi") + ["--epochs", "1",
                                                  "--matmul_precision", "highest"])
    assert (tmp_path / "hi" / "checkpoints" / "latest").exists()


@pytest.mark.parametrize("module", ["train_model", "create_graph", "predict",
                                    "convert_checkpoint"])
def test_modules_run_as_scripts(module):
    """``python -m neural_lam_tpu_torch.<module> --help``."""
    import os
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-m", f"neural_lam_tpu_torch.{module}", "--help"], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert out.returncode == 0, out.stderr
    assert "--config_path" in out.stdout


@pytest.mark.parametrize("entry", ["train_model", "predict", "convert_checkpoint"])
def test_entry_points_default_to_cuda(config_path, tmp_path, entry):
    """Without ``device="cpu"`` an entry point asks for the card, and
    raises where there is none."""
    from neural_lam_tpu_torch import convert_checkpoint

    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a GPU")

    argv = {
        "train_model": ["--config_path", str(config_path), "--runs_root", str(tmp_path)],
        "predict": ["--config_path", str(config_path), "--load", str(tmp_path),
                    "--out", str(tmp_path)],
        "convert_checkpoint": ["--ckpt", "x", "--config_path", str(config_path),
                               "--out", str(tmp_path)],
    }[entry]
    module = {"train_model": train_model, "predict": predict,
              "convert_checkpoint": convert_checkpoint}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)


def test_predict_cli_exports_forecasts(config_path, tmp_path):
    runs_root = tmp_path / "runs"
    _main(_common(config_path, runs_root, "servetrain") + ["--epochs", "1"])
    out_dir = tmp_path / "forecasts"
    predict.main(["--config_path", str(config_path), "--load", str(runs_root / "servetrain"),
                  "--split", "test", "--ar_steps", "3", "--batch_size", "2",
                  "--n_samples", "3", "--out", str(out_dir)], device="cpu")
    meta = json.loads((out_dir / "forecast_meta.json").read_text(encoding="utf-8"))
    _, datastore = load_config_and_datastore(config_path)
    n, d = datastore.num_grid_points, datastore.get_num_data_vars("state")
    assert meta["num_grid_points"] == n and len(meta["var_names"]) == d
    assert meta["model"] == "graph_lam"
    files = sorted(out_dir.glob("forecast_test_*.npz"))
    assert len(files) == 3
    first = np.load(files[0])
    assert first["prediction"].shape == (3, n, d) and first["target_times"].shape == (3,)

    # destandardizing the raw forward by hand reproduces the file exactly
    fc, _ = load_forecaster_from_checkpoint(runs_root / "servetrain", datastore, device="cpu")
    init, target, forcing, _ = WeatherDataset(datastore, split="test", ar_steps=3)[0]
    trainer = Trainer(fc, load_config_and_datastore(config_path)[0], datastore,
                      TrainingArgs(batch_size=1), device="cpu")
    with torch.inference_mode():
        init_s, target_s, forcing_s = trainer._standardize(init[None], target[None],
                                                           forcing[None])
        pred_s, _ = fc(init_s, forcing_s, target_s)
    stats = trainer.stats
    want = pred_s[0].numpy() * stats["state_std"] + stats["state_mean"]
    np.testing.assert_array_equal(first["prediction"], want.astype(np.float32))

    # a batch of 1 runs at its own size: the same fields within rounding
    out_b1 = tmp_path / "forecasts_b1"
    predict.main(["--config_path", str(config_path), "--load", str(runs_root / "servetrain"),
                  "--ar_steps", "3", "--batch_size", "1", "--n_samples", "2",
                  "--out", str(out_b1)], device="cpu")
    for fa, fb in zip(sorted(out_b1.glob("forecast_test_*.npz")), files):
        np.testing.assert_allclose(np.load(fa)["prediction"], np.load(fb)["prediction"],
                                   rtol=1e-5, atol=1e-6)


# -- 2. against the JAX CLI on an MDP store --------------------------------------


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _carry_across(jax_run: Path, port_run: Path, config: Path) -> None:
    """The JAX CLI's checkpoints as port checkpoints: parameters, AdamW
    moments and step count, step and ``hparams.json``, and ``best.json``."""
    _, jds = jax_load(config)
    _, tds = load_config_and_datastore(config)
    src, dst = JaxCheckpointManager(jax_run), CheckpointManager(port_run)
    for name in ("latest", "min_val_loss"):
        hparams = src.load_hparams(name)
        template = jax_build(hparams, jds).init_params(jax.random.PRNGKey(0))
        opt_template = jax_make_optimizer(hparams["lr"], hparams["weight_decay"]).init(template)
        params, opt_state, step = src.restore(name, template, opt_template)
        model = build_forecaster_from_hparams(hparams, tds, device="cpu").predictor
        model.load_state_dict(params_from_jax(params), strict=True)
        optimizer = make_optimizer(model.parameters(), hparams["lr"], hparams["weight_decay"])
        adam = opt_state[0]
        opt_state_from_jax(adam.mu, adam.nu, adam.count, optimizer, model)
        dst.save(name, model, optimizer, step, hparams)
    shutil.copy(jax_run / "checkpoints" / "best.json", port_run / "checkpoints" / "best.json")


@pytest.fixture(scope="module")
def mdp_runs(tmp_path_factory):
    """A tiny MDP store (64 x 62, the datastore's 30-point boundary), one
    epoch of the JAX CLI, and its checkpoints carried into a port run."""
    root = tmp_path_factory.mktemp("torch_cli_mdp")
    smoke = _load_chip_smoke()
    config = smoke.write_mdp_store(root / "store", 64, 62, splits=(10, 7, 8), n_state=3,
                                   n_forcing=2, n_static=1, seed=1)
    create_graph.main(["--config_path", str(config), "--name", "multiscale"])
    runs = root / "runs"
    common = ["--config_path", str(config), "--hidden_dim", "8", "--processor_layers", "2",
              "--batch_size", "2", "--val_steps_to_log", "1", "2", "--ar_steps_eval", "2",
              "--seed", "3"]
    jax_train_model.main(common + ["--epochs", "1", "--runs_root", str(runs / "jax"),
                                   "--logger_run_name", "run"])
    _carry_across(runs / "jax" / "run", runs / "torch" / "run", config)
    return config, runs, common


def test_eval_metrics_match_the_jax_cli(mdp_runs):
    config, runs, common = mdp_runs
    argv = common + ["--eval", "test", "--ar_steps_eval", "3", "--logger_run_name", "ev",
                     "--metrics_watch", "test_rmse", "test_mae",
                     "--var_leads_metrics_watch", '{"state1": [1, 3]}']
    jax_train_model.main(argv + ["--runs_root", str(runs / "jax"), "--load",
                                 str(runs / "jax" / "run")])
    _main(argv + ["--runs_root", str(runs / "torch"), "--load", str(runs / "torch" / "run")])
    want = json.loads((runs / "jax" / "ev" / "test_metrics.json").read_text())
    got = json.loads((runs / "torch" / "ev" / "test_metrics.json").read_text())
    assert sorted(got) == sorted(want) and "test_rmse_state1_step3" in got
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)
    np.testing.assert_allclose(
        np.load(runs / "torch" / "ev" / "mean_spatial_loss.npy"),
        np.load(runs / "jax" / "ev" / "mean_spatial_loss.npy"), rtol=RTOL, atol=1e-6,
    )


def test_resumed_losses_match_the_jax_cli(mdp_runs, tmp_path):
    """``--load <run> --restore_opt --epochs 2`` resumes at epoch 1 in both
    CLIs, from the same parameters and AdamW state and with the same
    shuffle order: the epoch's training and validation losses agree."""
    config, runs, common = mdp_runs
    for pkg in ("jax", "torch"):
        shutil.copytree(runs / pkg / "run", tmp_path / pkg / "run")
    argv = common + ["--epochs", "2", "--restore_opt", "--logger_run_name", "run"]
    jax_train_model.main(argv + ["--runs_root", str(tmp_path / "jax"), "--load",
                                 str(tmp_path / "jax" / "run")])
    _main(argv + ["--runs_root", str(tmp_path / "torch"), "--load",
                  str(tmp_path / "torch" / "run")])
    want = _history(tmp_path / "jax" / "run")
    got = _history(tmp_path / "torch" / "run")
    assert [h["epoch"] for h in want] == [0, 1] and [h["epoch"] for h in got] == [1]
    for key in ("train_loss", "val_loss", "val_loss_unroll1", "val_loss_unroll2"):
        np.testing.assert_allclose(got[0][key], want[1][key], rtol=RTOL, err_msg=key)
    for pkg in ("jax", "torch"):
        best = json.loads((tmp_path / pkg / "run" / "checkpoints" / "best.json").read_text())
        assert best["val_loss"] == min(h["val_loss"] for h in _history(tmp_path / pkg / "run")
                                       + [{"val_loss": want[0]["val_loss"]}])


def test_forecasts_match_the_jax_cli(mdp_runs):
    config, runs, _ = mdp_runs
    argv = ["--config_path", str(config), "--ar_steps", "3", "--batch_size", "2",
            "--n_samples", "3"]
    jax_predict.main(argv + ["--load", str(runs / "jax" / "run" / "checkpoints"
                                           / "min_val_loss"), "--out", str(runs / "fc_jax")])
    predict.main(argv + ["--load", str(runs / "torch" / "run" / "checkpoints"
                                       / "min_val_loss"), "--out", str(runs / "fc_torch")],
                 device="cpu")
    assert (json.loads((runs / "fc_torch" / "forecast_meta.json").read_text())
            == json.loads((runs / "fc_jax" / "forecast_meta.json").read_text()))
    want_files = sorted(p.name for p in (runs / "fc_jax").glob("forecast_*.npz"))
    assert sorted(p.name for p in (runs / "fc_torch").glob("forecast_*.npz")) == want_files
    assert len(want_files) == 3
    for name in want_files:
        want, got = np.load(runs / "fc_jax" / name), np.load(runs / "fc_torch" / name)
        assert sorted(got.files) == sorted(want.files)
        np.testing.assert_array_equal(got["target_times"], want["target_times"])
        scale = np.abs(want["prediction"]).mean()
        np.testing.assert_allclose(got["prediction"], want["prediction"], rtol=RTOL,
                                   atol=RTOL * scale)


# -- the reduced precisions against the JAX CLI ----------------------------------------


def _unset_on_exit(monkeypatch, *names):
    """The CLIs set these variables in the process: have monkeypatch
    restore them after the test."""
    for name in names:
        monkeypatch.setenv(name, "sentinel")
        monkeypatch.delenv(name)


def _epoch_from_checkpoint(mdp_runs, tmp_path, flags):
    """One epoch of both CLIs from the carried-over ``min_val_loss``
    parameters (a fresh optimizer, the same shuffle order) under
    ``flags``: the port's and the JAX CLI's history records."""
    config, runs, common = mdp_runs
    argv = common + ["--epochs", "1", "--logger_run_name", "r"] + flags
    jax_train_model.main(argv + ["--runs_root", str(tmp_path / "jax"), "--load",
                                 str(runs / "jax" / "run" / "checkpoints" / "min_val_loss")])
    _main(argv + ["--runs_root", str(tmp_path / "torch"), "--load",
                  str(runs / "torch" / "run" / "checkpoints" / "min_val_loss")])
    return _history(tmp_path / "torch" / "r")[0], _history(tmp_path / "jax" / "r")[0]


def _losses_close(got, want):
    for key in ("train_loss", "val_loss", "val_loss_unroll1", "val_loss_unroll2"):
        np.testing.assert_allclose(got[key], want[key], rtol=BF16_RTOL, err_msg=key)


@pytest.mark.parametrize("kernels", [None, "off"])
def test_bf16_epoch_matches_the_jax_cli(mdp_runs, tmp_path, monkeypatch, kernels):
    """``--precision bf16`` (and with ``--bf16_kernels off``): float32
    parameters, bf16 compute, an epoch's losses against the JAX CLI's;
    the checkpoint's parameters stay float32."""
    _unset_on_exit(monkeypatch, BF16_KERNELS_ENV, MATMUL_PRECISION_ENV)
    flags = ["--precision", "bf16"] + ([] if kernels is None else ["--bf16_kernels", kernels])
    got, want = _epoch_from_checkpoint(mdp_runs, tmp_path, flags)
    _losses_close(got, want)
    if kernels is not None:
        import os

        assert os.environ[BF16_KERNELS_ENV] == kernels
    state = torch.load(tmp_path / "torch" / "r" / "checkpoints" / "latest" / "state.pt",
                       weights_only=False)
    floats = [v for v in state["model"].values() if torch.is_tensor(v)]
    assert floats and all(v.dtype == torch.float32 for v in floats)


@pytest.mark.parametrize("precision", ["high", "high-kernels"])
def test_matmul_precision_epoch_matches_the_jax_cli(mdp_runs, tmp_path, monkeypatch,
                                                    precision):
    """``--matmul_precision high`` and ``high-kernels`` set the variable
    the kernels read and train an epoch whose losses agree with the JAX
    CLI's."""
    import os

    _unset_on_exit(monkeypatch, MATMUL_PRECISION_ENV)
    got, want = _epoch_from_checkpoint(
        mdp_runs, tmp_path, ["--matmul_precision", precision]
    )
    assert os.environ[MATMUL_PRECISION_ENV] == precision
    _losses_close(got, want)


def test_bf16_checkpoint_loads_into_a_float32_run(config_path, tmp_path, monkeypatch):
    """A ``--precision bf16`` run's checkpoint holds float32 parameters
    and AdamW state: ``--load --restore_opt`` continues it in float32,
    from exactly its parameters."""
    _unset_on_exit(monkeypatch, BF16_KERNELS_ENV, MATMUL_PRECISION_ENV)
    common = _common(config_path, tmp_path / "runs")
    _main(common + ["--epochs", "1", "--precision", "bf16", "--logger_run_name", "b"])
    run = tmp_path / "runs" / "b"
    _, tds = load_config_and_datastore(config_path)
    saved, _ = load_forecaster_from_checkpoint(run, tds, name="latest", device="cpu")
    assert saved.predictor.compute_dtype == torch.float32  # forecasts are float32
    _main(common + ["--epochs", "2", "--load", str(run), "--restore_opt",
                    "--logger_run_name", "f"])
    history = _history(tmp_path / "runs" / "f")
    assert [h["epoch"] for h in history] == [1] and np.isfinite(history[0]["train_loss"])
    state = torch.load(run / "checkpoints" / "latest" / "state.pt", weights_only=False)
    for name, p in saved.predictor.named_parameters():
        assert p.dtype == torch.float32 and torch.equal(p, state["model"][name])
