"""Data-parallel training of the port on the CPU, against the JAX package.

The ranks are gloo processes (``tests/torch_dp_worker.py``, which imports
``torch`` and the port only), started with ``torchrun``'s environment:
two ranks on one node, and four ranks as two nodes of two. Both groups
start together, each with its own deadline, so that a hang fails these
tests and not the suite. The JAX side runs here, on ``conftest.py``'s
eight host devices, with Pallas off (its plain reference), as its own
trainer tests run on the CPU.

- 2 and 4 ranks against the JAX ``Trainer`` at the same global batch of
  4: the loss within 2e-5 relative, each gradient within 2e-4 of its
  largest entry, three further losses within 1e-4 (float32 on both
  sides, another summation order, Adam's amplification near zero
  gradients), the same losses on every rank;
- ZeRO-1 against replicated moments: the same trajectory (1e-6), each
  rank holding ``1/P`` of the moments;
- ``flat_opt`` against the per-tensor AdamW (1e-6) and against
  ``optax.flatten`` (the JAX bounds above), and a JAX ``--flat_opt``
  checkpoint carried into the port (``opt_state_from_jax`` with the
  parameter pytree as template), both going on alike (1e-5);
- a ZeRO-1 checkpoint written at two ranks restored by one process, whose
  next losses are those of the two ranks (1e-5);
- the merged ``evaluate`` with a tail smaller than the rank count against
  one process at batch 1 (1e-6) and the JAX trainer (1e-5), and
  ``run_test_evaluation``'s merged metrics and rank-0 artifacts against
  one process's (1e-6);
- SIGTERM to rank 0 alone stops every rank at the same step;
- ``compute_standardization_stats --multihost`` at two ranks against one
  process (1e-6, the float32 rounding of float64 sums added in another
  order);
- the samples of every global batch against the JAX loader's hosts and
  their devices, at two nodes of two ranks.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from neural_lam_tpu import config as jax_config
from neural_lam_tpu.checkpoint import CheckpointManager as JaxCheckpointManager
from neural_lam_tpu.convert_checkpoint import export_state_dict
from neural_lam_tpu.dataset import WeatherDataset as JaxWeatherDataset
from neural_lam_tpu.datastore.dummy import DummyDatastore as JaxDummyDatastore
from neural_lam_tpu.loader import DataLoader as JaxDataLoader
from neural_lam_tpu.models import ARForecaster as JaxARForecaster
from neural_lam_tpu.models import GraphLAM as JaxGraphLAM
from neural_lam_tpu.trainer import Trainer as JaxTrainer
from neural_lam_tpu.trainer import TrainingArgs as JaxTrainingArgs
from neural_lam_tpu_torch import config
from neural_lam_tpu_torch.checkpoint import CheckpointManager
from neural_lam_tpu_torch.convert_checkpoint import opt_state_from_jax, params_from_jax
from neural_lam_tpu_torch.dataset import WeatherDataset
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.datastore.npyfilesmeps import NpyFilesDatastoreMEPS
from neural_lam_tpu_torch.datastore.npyfilesmeps.compute_standardization_stats import (
    compute_stats,
)
from neural_lam_tpu_torch.graphs import create_graph_from_datastore
from neural_lam_tpu_torch.loader import DataLoader, block_rows
from neural_lam_tpu_torch.models import ARForecaster, GraphLAM
from neural_lam_tpu_torch.optim import FlatAdamW
from neural_lam_tpu_torch.trainer import Trainer, TrainingArgs

from test_torch_npyfilesmeps import write_meps_store

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_dp_worker.py"
DS_KW = dict(n_grid_x=9, n_grid_y=9, n_timesteps=12, computed_stats=True)
CONFIG = {"datastore": {"kind": "dummydata", "config_path": "ds.yaml"}}
HIDDEN, LAYERS, LR = 16, 1, 1e-3
GLOBAL_BATCH = 4
# 9 validation samples in node batches of 4: a tail of 1, below 2 ranks
EVAL_BATCH = 4
GROUP_TIMEOUT_S = 240
LOSS_RTOL, GRAD_TOL, TRAJ_RTOL = 2e-5, 2e-4, 1e-4


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("NEURAL_LAM_TPU_PALLAS", "off")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_group(spec: dict, world: int, local_world: int) -> list:
    out = Path(spec["out"])
    out.mkdir(parents=True)
    (out / "spec.json").write_text(json.dumps(spec), encoding="utf-8")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    env.update(PYTHONPATH=str(REPO), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(local_world), OMP_NUM_THREADS="1")
    return [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(out / "spec.json")],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r % local_world),
                     GROUP_RANK=str(r // local_world)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(world)
    ]


def _finish_group(procs: list, out: Path, started: float) -> list[dict]:
    """Each rank's results; a rank that fails or outlives the group's
    deadline fails the group (every rank is killed)."""
    logs = []
    try:
        for p in procs:
            left = max(GROUP_TIMEOUT_S - (time.monotonic() - started), 1.0)
            logs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"process group under {out} did not finish in {GROUP_TIMEOUT_S} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(len(procs))]


def _global_batch():
    rng = np.random.default_rng(3)
    n = DS_KW["n_grid_x"] * DS_KW["n_grid_y"]
    return dict(
        init=rng.normal(size=(GLOBAL_BATCH, 2, n, 3)).astype(np.float32),
        target=rng.normal(size=(GLOBAL_BATCH, 1, n, 3)).astype(np.float32),
        forcing=rng.normal(size=(GLOBAL_BATCH, 1, n, 6)).astype(np.float32),
    )


def _jax_trainer(root, **args):
    jds = JaxDummyDatastore(root_path=root, **DS_KW)
    jt = JaxTrainer(
        JaxARForecaster(JaxGraphLAM(jds, hidden_dim=HIDDEN, processor_layers=LAYERS), jds),
        jax_config.config_from_dict(CONFIG), jds,
        JaxTrainingArgs(batch_size=GLOBAL_BATCH, lr=LR, **args),
    )
    params, opt_state = jt.init_state(jax.random.PRNGKey(0))
    return jt, params, opt_state


def _port_trainer(root, state_dict, **args):
    ds = DummyDatastore(root_path=root, **DS_KW)
    model = GraphLAM(ds, hidden_dim=HIDDEN, processor_layers=LAYERS, device="cpu")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()}, strict=True)
    trainer = Trainer(ARForecaster(model, ds), config.config_from_dict(CONFIG), ds,
                      TrainingArgs(batch_size=GLOBAL_BATCH, lr=LR, **args), device="cpu")
    return trainer, model, ds


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two process groups, started together, and what they found;
    the weights are the JAX trainer's initial ones."""
    root = tmp_path_factory.mktemp("torch_dp")
    ds = DummyDatastore(root_path=root, **DS_KW)
    create_graph_from_datastore(ds, root / "graph" / "multiscale")
    _, params, _ = _jax_trainer(root)
    state = {k: v.numpy() for k, v in params_from_jax(jax.device_get(params)).items()}
    np.savez(root / "params.npz", **state)
    batch = _global_batch()
    np.savez(root / "batch.npz", **batch)
    stats_root = write_meps_store(root / "meps")
    spec = dict(root=str(root), ds_kw=DS_KW, hidden=HIDDEN, layers=LAYERS, lr=LR,
                params=str(root / "params.npz"), batch=str(root / "batch.npz"),
                batch_size=GLOBAL_BATCH, eval_batch_size=EVAL_BATCH, preempt_batch_size=2,
                samples_n=11, samples_batch_size=4,
                stats_cfg=str(stats_root / "data_config.yaml"))
    started = time.monotonic()
    groups = {
        2: (_start_group(dict(spec, out=str(root / "w2"), batch_size=GLOBAL_BATCH,
                              scenarios=["train", "eval", "test_eval", "preempt", "stats"]),
                              2, 2),
            root / "w2"),
        # two nodes of two ranks: the per-node batch is half the global one
        4: (_start_group(dict(spec, out=str(root / "w4"), batch_size=GLOBAL_BATCH // 2,
                              samples_batch_size=2, scenarios=["train", "samples"]), 4, 2),
            root / "w4"),
    }
    results = {w: _finish_group(procs, out, started) for w, (procs, out) in groups.items()}
    return dict(root=root, state=state, batch=batch, results=results, stats_root=stats_root)


@pytest.fixture(scope="module")
def jax_runs(runs):
    """The JAX trainer's four steps on the global batch, per-tensor and
    flat (``optax.flatten``): losses, the first step's gradients, and the
    flat run's state after two steps."""
    root, batch = runs["root"], runs["batch"]
    data = tuple(batch[k] for k in ("init", "target", "forcing"))
    out = {}
    for flat in (False, True):
        jt, params, opt_state = _jax_trainer(root, flat_opt=flat)
        assert jt.num_data_shards == GLOBAL_BATCH
        db, _ = jt.device_put_batch(data)
        grads = jax.grad(jt._loss)(params, *db)
        step = jt.make_train_step()
        losses, saved = [], None
        for k in range(4):
            if k == 2:
                saved = jax.device_get((params, opt_state))
            params, opt_state, loss = step(params, opt_state, *db)
            losses.append(float(loss))
        out[flat] = dict(losses=np.array(losses), saved=saved, jt=jt,
                         grads=export_state_dict(jax.device_get(grads)))
    return out


def _assert_matches_jax(got_losses, got_grads, want):
    losses = np.asarray(got_losses)
    np.testing.assert_allclose(losses[0], want["losses"][0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(losses[1:], want["losses"][1:], rtol=TRAJ_RTOL)
    assert sorted(got_grads) == sorted(want["grads"])
    for key, w in want["grads"].items():
        err = np.abs(got_grads[key] - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= GRAD_TOL, (key, err)


@pytest.mark.parametrize("world", [2, 4])
def test_dp_matches_the_jax_trainer(runs, jax_runs, world):
    """ZeRO-1 data parallelism (the default) at 2 and 4 ranks against the
    JAX trainer's 4-device mesh at the same global batch."""
    ranks = [r["train"]["zero"] for r in runs["results"][world]]
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]
        for key, g in r["grads"].items():
            np.testing.assert_array_equal(g, ranks[0]["grads"][key])
    _assert_matches_jax(ranks[0]["losses"], ranks[0]["grads"], jax_runs[False])


@pytest.mark.parametrize("world", [2, 4])
def test_zero1_keeps_the_trajectory_and_a_part_of_the_moments(runs, world):
    """ZeRO-1 against replicated moments (``shard_opt_state=False``): the
    same losses and weights; each rank keeps ``1/P`` of the flat buffer's
    moments against the whole buffer's (the counterpart of
    ``tests/test_trainer.py::test_sharded_optimizer_state_parity``)."""
    for r in runs["results"][world]:
        zero, rep = r["train"]["zero"], r["train"]["replicated"]
        np.testing.assert_allclose(zero["losses"], rep["losses"], rtol=1e-6)
        for key, p in zero["params"].items():
            np.testing.assert_allclose(p, rep["params"][key], rtol=1e-6, atol=1e-7)
        assert zero["moments"] * world == zero["padded"] and rep["moments"] == rep["padded"]


def test_flat_opt_matches_per_tensor_and_optax_flatten(runs, jax_runs):
    """``flat_opt`` at 2 ranks against the per-tensor optimizer (same
    trajectory) and against the JAX trainer under ``optax.flatten``."""
    r = runs["results"][2][0]["train"]
    np.testing.assert_allclose(r["flat"]["losses"], r["replicated"]["losses"], rtol=1e-6)
    for key, p in r["flat"]["params"].items():
        np.testing.assert_allclose(p, r["replicated"]["params"][key], rtol=1e-6, atol=1e-7)
    _assert_matches_jax(r["flat"]["losses"], r["flat"]["grads"], jax_runs[True])
    np.testing.assert_allclose(jax_runs[True]["losses"], jax_runs[False]["losses"], rtol=1e-6)


def test_jax_flat_opt_checkpoint_crosses_over(runs, jax_runs, tmp_path):
    """A JAX checkpoint written under ``--flat_opt`` after two steps: its
    weights and flat moments (``ravel_pytree``'s order, unravelled with
    the parameter pytree) into the port's flat optimizer and into the
    per-tensor one; the two further steps' losses are the JAX run's."""
    run = jax_runs[True]
    params, opt_state = run["saved"]
    ckpt = JaxCheckpointManager(tmp_path / "jax_run")
    ckpt.save("latest", params, opt_state, step=2)
    jt, t_params, t_opt = _jax_trainer(runs["root"], flat_opt=True)
    params, opt_state, step = ckpt.restore("latest", jax.device_get(t_params),
                                           jax.device_get(t_opt))
    assert step == 2 and np.ndim(opt_state[0].mu) == 1
    data = tuple(runs["batch"][k] for k in ("init", "target", "forcing"))
    for flat in (True, False):
        state = params_from_jax(params)
        trainer, model, _ = _port_trainer(runs["root"], state, flat_opt=flat)
        assert isinstance(trainer.optimizer, FlatAdamW) == flat
        adam = opt_state[0]
        opt_state_from_jax(adam.mu, adam.nu, adam.count, trainer.optimizer, model,
                           template=params)
        got = [trainer.train_step(*data).item() for _ in range(2)]
        np.testing.assert_allclose(got, run["losses"][2:], rtol=1e-5)


def test_zero1_checkpoint_restores_at_world_1(runs):
    """The checkpoint two ZeRO-1 ranks saved holds the full moments per
    parameter, as one process saves them; restored by one process (per
    tensor, and flat), its next two steps on the global batch give the two
    ranks' losses."""
    ckpt = CheckpointManager(runs["root"] / "w2" / "ckpt_w2")
    saved = torch.load(ckpt.ckpt_dir / "latest" / "state.pt", weights_only=True)
    trainer, model, _ = _port_trainer(runs["root"], runs["state"])
    shapes = [p.shape for p in model.parameters()]
    assert len(saved["optimizer"]["state"]) == len(shapes)
    for i, shape in enumerate(shapes):
        assert saved["optimizer"]["state"][i]["exp_avg"].shape == shape
    data = tuple(runs["batch"][k] for k in ("init", "target", "forcing"))
    want = runs["results"][2][0]["train"]["zero"]["after_ckpt"]
    for flat in (False, True):
        trainer, model, _ = _port_trainer(runs["root"], runs["state"], flat_opt=flat)
        assert ckpt.restore("latest", model, trainer.optimizer) == 4
        got = [trainer.train_step(*data).item() for _ in range(2)]
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_merged_evaluate_with_a_tail_smaller_than_the_world(runs):
    """Two ranks evaluate 9 samples in node batches of 4 (the tail: one
    sample, padded to a block per rank, rank 1's all padding); the merged
    metrics equal one process's at batch 1 and the JAX trainer's
    (``tests/test_trainer.py::test_eval_tail_batch_smaller_than_mesh``)."""
    got = [r["eval"] for r in runs["results"][2]]
    assert got[0] == got[1]
    trainer, _, ds = _port_trainer(runs["root"], runs["state"], val_steps_to_log=(1,))
    dataset = WeatherDataset(ds, "val", ar_steps=1)
    assert len(dataset) % EVAL_BATCH == 1
    want = trainer.evaluate(DataLoader(dataset, batch_size=1), "val")
    assert sorted(got[0]) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[0][key], want[key], rtol=1e-6, err_msg=key)
    jt, params, _ = _jax_trainer(runs["root"], val_steps_to_log=(1,))
    jds = JaxDummyDatastore(root_path=runs["root"], **DS_KW)
    loader = JaxDataLoader(JaxWeatherDataset(jds, split="val", ar_steps=1),
                           batch_size=EVAL_BATCH)
    np.testing.assert_allclose(got[0]["val_loss"],
                               jt.evaluate(params, loader, "val")["val_loss"], rtol=1e-5)


def test_test_evaluation_merges_and_rank_0_writes(runs, tmp_path):
    """``run_test_evaluation`` at two ranks (8 test samples at 2 AR steps,
    node batches of 4): every rank returns one process's metrics, and the
    artifacts in the shared directory are rank 0's, as one process writes
    them (``neural_lam_tpu/evaluation.py:258``)."""
    from neural_lam_tpu_torch.evaluation import run_test_evaluation

    got = [r["test_eval"] for r in runs["results"][2]]
    assert got[0] == got[1]
    trainer, _, ds = _port_trainer(runs["root"], runs["state"], val_steps_to_log=(1,))
    loader = DataLoader(WeatherDataset(ds, "test", ar_steps=2), batch_size=EVAL_BATCH)
    want = run_test_evaluation(trainer, loader, ds, tmp_path, split="test", n_example_pred=0)
    assert sorted(got[0]) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[0][key], want[key], rtol=1e-6, err_msg=key)
    shared = runs["root"] / "w2" / "test_eval"
    assert sorted(p.name for p in shared.iterdir()) == sorted(p.name for p in tmp_path.iterdir())
    np.testing.assert_allclose(np.load(shared / "mean_spatial_loss.npy"),
                               np.load(tmp_path / "mean_spatial_loss.npy"), rtol=1e-6)


def test_sigterm_to_rank_0_stops_every_rank_at_the_same_step(runs):
    """Rank 0 alone is signalled while reading its first batch; with
    ``preempt_check_every=2`` both ranks stop after step 2 of the first
    epoch's 4, the record marked preempted
    (``neural_lam_tpu/trainer.py:724-751``)."""
    got = [r["preempt"] for r in runs["results"][2]]
    assert got[0]["batches"] == 4
    for r in got:
        assert r == dict(steps=2, epochs=1, preempted=True, batches=4)


def test_multihost_statistics_equal_one_process(runs):
    """``compute_standardization_stats --multihost`` at two ranks (strided
    shards, moments merged over the group, rank 0 writing) against one
    process over the same files."""
    root = runs["stats_root"]
    want = compute_stats(NpyFilesDatastoreMEPS(config_path=root / "data_config.yaml"))
    for key, w in want.items():
        np.testing.assert_allclose(np.load(root / "static" / f"{key}.npy"), w, rtol=1e-6,
                                   atol=1e-7, err_msg=key)


def test_global_batch_samples_match_the_jax_loader(runs):
    """Two nodes of two ranks, 11 samples, node batches of 2, two shuffled
    epochs: each step's global batch (the ranks' blocks in rank order) is
    the JAX package's (each host's loader shard, padded to its two
    devices as ``Trainer.device_put_batch`` pads it), sample for sample,
    and each node's real counts add up to its host's."""
    ranks = [r["samples"] for r in runs["results"][4]]

    class Indices:
        def __len__(self):
            return 11

        def __getitem__(self, i):
            return (np.array([i]),)

    for epoch in range(2):
        hosts = []
        for host in range(2):
            loader = JaxDataLoader(Indices(), batch_size=2, shuffle=True, seed=0, prefetch=0,
                                   shard_index=host, num_shards=2)
            loader.set_epoch(epoch)
            hosts.append([b[0][:, 0] for b in loader])
        assert all(len(r[epoch]) == len(hosts[0]) for r in ranks)
        for step in range(len(hosts[0])):
            want, got = [], []
            for host in range(2):
                rows = hosts[host][step]
                pad = (-len(rows)) % 2
                want += list(rows) + [rows[-1]] * pad
                blocks = [ranks[2 * host + local][epoch][step] for local in range(2)]
                assert sum(real for _, real in blocks) == len(rows)
                got += [i for b, _ in blocks for i in b]
            assert got == want, (epoch, step)


@pytest.mark.parametrize("size,blocks", [(4, 2), (3, 2), (1, 2), (5, 4), (2, 1)])
def test_block_rows_pad_like_the_jax_trainer(size, blocks):
    """A node batch of ``size`` cut into ``blocks``: the padded batch
    (``neural_lam_tpu/trainer.py:340-345``) in contiguous blocks, each with
    its count of real rows."""
    padded = list(range(size)) + [size - 1] * ((-size) % blocks)
    per = len(padded) // blocks
    reals = []
    for b in range(blocks):
        rows, real = block_rows(size, b, blocks)
        assert rows.tolist() == padded[b * per:(b + 1) * per]
        reals.append(real)
    assert sum(reals) == size
