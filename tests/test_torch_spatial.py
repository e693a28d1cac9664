"""Spatial partitioning of the port on the CPU, against the JAX package.

The ranks are gloo processes (``tests/torch_spatial_worker.py``, which
imports ``torch`` and the port only), started with ``torchrun``'s
environment as ``tests/test_torch_dp.py`` starts them: ``S = 2`` (two
ranks), ``S = 4`` (four) and ``S x D = 2 x 2`` (four ranks, two spatial
groups of two), all at once, each group with its own deadline. The store
is ``tests/test_spatial_sharding.py``'s 27x27 dummy datastore with its
multiscale and hierarchical graphs; the models are at hidden 8 with 2
processor layers, with the JAX models' initial weights
(``params_from_jax``). The JAX side runs here, replicated, with Pallas
off (its plain reference).

- GraphLAM, HiLAM and HiLAMParallel sharded against the JAX replicated
  model, at ``S`` = 2, 4 and ``2 x 2``: the forecast's states after AR
  steps 1 and 3 within 1e-5, the loss within 2e-5 relative, each gradient
  within 2e-4 of its largest entry, three further AdamW losses within
  1e-4 (float32, another summation order);
- each edge set's strategy and halo rows per (shard, offset) equal to the
  JAX builder's (``_build_edge_table``, numpy), at 2, 4 and 8 shards, also
  with every halo forced;
- forced halos, a shard that owns no edge of a set (HiLAM's top level at
  ``S = 4``), the v2 and unfused routes and bf16 (against the port's
  replicated step; bf16 at the bf16 loss bound, its gradients no further
  from the float32 ones than the replicated bf16 step's), ``scan_steps``, the
  single-shard executor (the replicated bits), ZeRO-1 over the whole
  world, a checkpoint written at ``S = 2`` and restored by one process
  (1e-5), ``train_model --spatial_shards 2`` and its ``--eval test`` on a
  tiny ``mdp`` store against one process (1e-5), and the collectives the
  exchanges recorded against ``analytic_budget``.
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
import optax
import pytest
import torch

from neural_lam_tpu import config as jax_config
from neural_lam_tpu.convert_checkpoint import export_state_dict
from neural_lam_tpu.datastore.dummy import DummyDatastore as JaxDummyDatastore
from neural_lam_tpu.models import ARForecaster as JaxARForecaster
from neural_lam_tpu.models import GraphLAM as JaxGraphLAM
from neural_lam_tpu.models import HiLAM as JaxHiLAM
from neural_lam_tpu.models import HiLAMParallel as JaxHiLAMParallel
from neural_lam_tpu.parallel.spatial import _build_edge_table as jax_build_edge_table
from neural_lam_tpu.trainer import Trainer as JaxTrainer
from neural_lam_tpu.trainer import TrainingArgs as JaxTrainingArgs
from neural_lam_tpu_torch import config, create_graph, train_model
from neural_lam_tpu_torch.checkpoint import CheckpointManager
from neural_lam_tpu_torch.convert_checkpoint import grads_to_numpy, params_from_jax
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.graphs import create_graph_from_datastore
from neural_lam_tpu_torch.graphs.load import load_graph
from neural_lam_tpu_torch.models import ARForecaster, GraphLAM, HiLAM, HiLAMParallel
from neural_lam_tpu_torch.parallel.collective_budget import (
    analytic_budget,
    graph_metas,
    projected_efficiency,
    recorded_bytes,
    recorded_table,
)
from neural_lam_tpu_torch.trainer import Trainer, TrainingArgs

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_spatial_worker.py"
DS_KW = dict(n_grid_x=27, n_grid_y=27, n_timesteps=12, computed_stats=True)
CONFIG = {"datastore": {"kind": "dummydata", "config_path": "ds.yaml"}}
HIDDEN, LAYERS, LR = 8, 2, 1e-3
GLOBAL_BATCH = 4
ROLL_STEPS = 3
GROUP_TIMEOUT_S = 240
STATE_TOL, LOSS_RTOL, GRAD_TOL, TRAJ_RTOL = 1e-5, 2e-5, 2e-4, 1e-4
BF16_LOSS_RTOL = 2e-2
FAMILIES = ("graph_lam", "hi_lam", "hi_lam_parallel")
GRAPHS = {"graph_lam": "multiscale", "hi_lam": "hierarchical", "hi_lam_parallel": "hierarchical"}
JAX_MODELS = {"graph_lam": JaxGraphLAM, "hi_lam": JaxHiLAM, "hi_lam_parallel": JaxHiLAMParallel}
PORT_MODELS = {"graph_lam": GraphLAM, "hi_lam": HiLAM, "hi_lam_parallel": HiLAMParallel}
# (world, spatial shards): S = 2, S = 4, S x D = 2 x 2
GROUPS = {"s2": (2, 2), "s4": (4, 4), "s2d2": (4, 2)}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("NEURAL_LAM_TPU_PALLAS", "off")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_group(spec: dict, world: int) -> list:
    out = Path(spec["out"])
    out.mkdir(parents=True)
    (out / "spec.json").write_text(json.dumps(spec), encoding="utf-8")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    env.update(PYTHONPATH=str(REPO), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world), OMP_NUM_THREADS="1")
    return [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(out / "spec.json")],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r), GROUP_RANK="0"),
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


def _batch(ds):
    rng = np.random.default_rng(5)
    n = ds.num_grid_points
    f = ds.get_num_data_vars("forcing") * 3
    s = ds.get_num_data_vars("state")
    normal = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    return dict(init=normal(GLOBAL_BATCH, 2, n, s), target=normal(GLOBAL_BATCH, 1, n, s),
                forcing=normal(GLOBAL_BATCH, 1, n, f),
                roll_init=normal(GLOBAL_BATCH, 2, n, s),
                roll_forcing=normal(GLOBAL_BATCH, ROLL_STEPS, n, f),
                roll_boundary=normal(GLOBAL_BATCH, ROLL_STEPS, n, s))


def _jax_trainer(root, name):
    jds = JaxDummyDatastore(root_path=root, **DS_KW)
    model = JAX_MODELS[name](jds, graph_name=GRAPHS[name], hidden_dim=HIDDEN,
                             processor_layers=LAYERS)
    fc = JaxARForecaster(model, jds)
    jt = JaxTrainer(fc, jax_config.config_from_dict(CONFIG), jds,
                    JaxTrainingArgs(batch_size=GLOBAL_BATCH, lr=LR))
    params, opt_state = jt.init_state(jax.random.PRNGKey(0))
    return jt, fc, params, opt_state


def _port_model(root, name, state, **kw):
    ds = DummyDatastore(root_path=root, **DS_KW)
    cls = GraphLAM if name.startswith("graph_lam") else PORT_MODELS[name]
    model = cls(ds, graph_name=GRAPHS.get(name, "multiscale"), hidden_dim=HIDDEN,
                processor_layers=LAYERS, device="cpu", **kw)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()}, strict=True)
    return model, ds


def _port_trainer(root, name, state, model_kw=None, **args):
    model, ds = _port_model(root, name, state, **(model_kw or {}))
    trainer = Trainer(ARForecaster(model, ds), config.config_from_dict(CONFIG), ds,
                      TrainingArgs(batch_size=GLOBAL_BATCH, lr=LR, **args), device="cpu")
    return trainer, model, ds


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references, then the three process groups, started
    together, and what they found; the weights are the JAX models'
    initial ones."""
    with pytest.MonkeyPatch.context() as mp:
        # a module fixture is made before the autouse one sets this
        mp.setenv("NEURAL_LAM_TPU_PALLAS", "off")
        return _runs(tmp_path_factory.mktemp("torch_spatial"))


def _runs(root):
    ds = DummyDatastore(root_path=root, **DS_KW)
    create_graph_from_datastore(ds, root / "graph" / "multiscale", hierarchical=False)
    create_graph_from_datastore(ds, root / "graph" / "hierarchical", hierarchical=True)
    states, params_files = {}, {}
    h2 = GraphLAM(ds, hidden_dim=HIDDEN, processor_layers=LAYERS, hidden_layers=2, seed=3,
                  device="cpu")
    states["graph_lam_h2"] = {k: v.numpy() for k, v in h2.state_dict().items()}
    params_files["graph_lam_h2"] = str(root / "graph_lam_h2.npz")
    np.savez(params_files["graph_lam_h2"], **states["graph_lam_h2"])
    batch = _batch(ds)
    np.savez(root / "batch.npz", **batch)

    # a tiny mdp store for the CLI (the datastore's 30-point boundary)
    import importlib.util

    spec_ = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(smoke)
    cli_cfg = smoke.write_mdp_store(root / "mdp", 64, 62, splits=(8, 6, 6), n_state=3,
                                    n_forcing=2, n_static=1, seed=2)
    create_graph.main(["--config_path", str(cli_cfg), "--name", "multiscale"])
    cli_argv = ["--config_path", str(cli_cfg), "--hidden_dim", "8", "--processor_layers", "1",
                "--batch_size", "2", "--val_steps_to_log", "1", "2", "--ar_steps_eval", "2",
                "--seed", "3"]

    spec = dict(root=str(root), ds_kw=DS_KW, hidden=HIDDEN, layers=LAYERS, lr=LR,
                params=params_files, batch=str(root / "batch.npz"), batch_size=GLOBAL_BATCH,
                families=list(FAMILIES), cli_argv=cli_argv)
    scenarios = {"s2": ["families", "forced", "routes", "scan_ckpt", "cli"],
                 "s4": ["families", "forced"], "s2d2": ["families"]}
    # the JAX references first: the groups would slow XLA's compiles
    jax_ref = {}
    data = tuple(batch[k] for k in ("init", "target", "forcing"))
    for name in FAMILIES:
        jt, fc, params, opt_state = _jax_trainer(root, name)
        states[name] = {k: v.numpy() for k, v in params_from_jax(jax.device_get(params)).items()}
        params_files[name] = str(root / f"{name}.npz")
        np.savez(params_files[name], **states[name])
        states_ref, _ = jax.jit(fc.forward)(params, batch["roll_init"], batch["roll_forcing"],
                                            batch["roll_boundary"])
        # the JAX trainer's step (value_and_grad of its loss, its AdamW),
        # on one device, as one executable
        def step(params, opt_state, *batch):
            loss, grads = jax.value_and_grad(jt._loss)(params, *batch)
            updates, opt_state = jt.optimizer.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss, grads

        step = jax.jit(step)
        # on one device, so that the step's outputs come back as its inputs
        params, opt_state = jax.device_put((params, opt_state), jax.devices()[0])
        losses, first = [], None
        for _ in range(4):
            params, opt_state, loss, grads = step(params, opt_state, *data)
            first = grads if first is None else first
            losses.append(float(loss))
        jax_ref[name] = dict(states=np.asarray(states_ref), losses=np.array(losses),
                             grads=export_state_dict(jax.device_get(first)))
    started = time.monotonic()
    procs = {
        key: _start_group(dict(spec, out=str(root / key), shards=shards,
                               scenarios=scenarios[key]), world)
        for key, (world, shards) in GROUPS.items()
    }
    results = {key: _finish_group(p, root / key, started) for key, p in procs.items()}
    return dict(root=root, states=states, batch=batch, results=results, jax=jax_ref,
                cli_argv=cli_argv)


def _rel_grad_errors(got: dict, want: dict) -> dict:
    assert sorted(got) == sorted(want)
    return {k: float(np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30))
            for k, w in want.items()}


def _block_rows(key: str, rank: int) -> slice:
    world, shards = GROUPS[key]
    per = GLOBAL_BATCH // (world // shards)
    d = rank // shards
    return slice(d * per, (d + 1) * per)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("key", list(GROUPS))
def test_sharded_model_matches_the_jax_replicated_model(runs, key, family):
    """The forecast's states after steps 1 and 3, the loss, the gradients
    and three further losses of the sharded port against the JAX
    replicated model; the same losses and gradients on every rank."""
    want = runs["jax"][family]
    ranks = [r["families"][family] for r in runs["results"][key]]
    for rank, r in enumerate(ranks):
        ref = want["states"][_block_rows(key, rank)][:, [0, 2]]
        got = r["states"][:, [0, 2]]
        assert np.abs(got - ref).max() <= STATE_TOL * max(np.abs(ref).max(), 1.0), rank
        assert r["losses"] == ranks[0]["losses"]
        for k, g in r["grads"].items():
            np.testing.assert_array_equal(g, ranks[0]["grads"][k])
    losses = np.asarray(ranks[0]["losses"])
    np.testing.assert_allclose(losses[0], want["losses"][0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(losses[1:], want["losses"][1:], rtol=TRAJ_RTOL)
    worst = _rel_grad_errors(ranks[0]["grads"], want["grads"])
    assert max(worst.values()) <= GRAD_TOL, worst


@pytest.mark.parametrize("hierarchical", [False, True])
@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("max_nodes", [2048, 0])
def test_halo_tables_equal_the_jax_builder(runs, hierarchical, shards, max_nodes):
    """Per edge set: the JAX rule's strategy and offsets, and per (shard,
    offset) the sorted halo rows the JAX builder tabulates (its table
    pads each to the offset's largest, rounded up to 8, with zeros)."""
    root = runs["root"]
    _, graph = load_graph(root / "graph" / ("hierarchical" if hierarchical else "multiscale"),
                          mesh_node_features_scaling=1.0)
    n_grid = DS_KW["n_grid_x"] * DS_KW["n_grid_y"]
    metas = graph_metas(graph, n_grid, shards, all_gather_max_nodes=max_nodes)
    for name, meta in metas.items():
        ei = np.asarray(_edge_index(graph, name))
        jmeta, jtbl = jax_build_edge_table(
            name, ei[0], ei[1], None, _n_send(graph, name, n_grid), meta.n_send_local,
            meta.n_rec_local, shards, max_nodes, 8)
        assert meta.strategy == jmeta.strategy, name
        assert meta.offsets == jmeta.offsets, name
        for i, d in enumerate(meta.offsets):
            assert jmeta.halo_sizes[i] == -(-meta.halo_sizes[i] // 8) * 8
            table = jtbl[f"rows_{d}"]
            for s in range(shards):
                rows = meta.halo_rows.get((s, d), np.zeros(0, np.int64))
                if not 0 <= s + d < shards:
                    assert not len(rows)
                    continue
                np.testing.assert_array_equal(table[s + d, :len(rows)], rows)
                assert not table[s + d, len(rows):].any()


def _edge_index(graph, name):
    """An edge set's ``(2, E)`` index of a loaded graph, by meta name."""
    if name in ("g2m", "m2g"):
        return graph[f"{name}_edge_index"]
    m2m = graph["m2m_edge_index"]
    if name.startswith("m2m"):
        return m2m[int(name[3:])] if isinstance(m2m, (list, tuple)) else m2m
    if name.startswith("up"):
        return graph["mesh_up_edge_index"][int(name[2:])]
    return graph["mesh_down_edge_index"][int(name[4:])]


def _n_send(graph, name, n_grid):
    """The size of an edge set's sender set, by meta name."""
    mesh = graph["mesh_static_features"]
    sizes = [np.asarray(m).shape[0] for m in (mesh if isinstance(mesh, (list, tuple))
                                              else [mesh])]
    if name == "g2m":
        return n_grid
    if name in ("m2g", "m2m"):
        return sizes[0]
    if name.startswith("m2m"):
        return sizes[int(name[3:])]
    if name.startswith("up"):
        return sizes[int(name[2:])]
    return sizes[int(name[4:]) + 1]


@pytest.mark.parametrize("key", ["s2", "s4"])
def test_forced_halos_match_the_jax_replicated_forecast(runs, key):
    """``all_gather_max_nodes=0``: the fine sets exchange halos (GraphLAM's
    g2m and m2g, HiLAM's level-0 sets), and the forecasts still equal the
    JAX replicated model's."""
    for rank, r in enumerate(runs["results"][key]):
        for name, res in r["forced"].items():
            assert res["strategies"]["g2m"] == "halo" and res["strategies"]["m2g"] == "halo"
            ref = runs["jax"][name]["states"][_block_rows(key, rank)][:, [0, 2]]
            got = res["states"][:, [0, 2]]
            assert np.abs(got - ref).max() <= STATE_TOL * max(np.abs(ref).max(), 1.0)


def test_a_shard_without_edges(runs):
    """At ``S = 4`` the top mesh level of 9 nodes gives shard 3 only
    padded rows: it owns no edge of that level's same-level and up sets,
    and HiLAM and HiLAMParallel still match
    (``test_sharded_model_matches_the_jax_replicated_model``)."""
    edges = [r["families"]["hi_lam"]["edges"] for r in runs["results"]["s4"]]
    assert edges[3]["m2m1"] == 0 and edges[3]["up0"] == 0
    assert all(e["m2m1"] > 0 and e["up0"] > 0 for e in edges[:3])


def test_routes_and_bf16_match_the_port_replicated(runs):
    """GraphLAM sharded at ``S = 2`` on the v2 route and on the unfused
    route (``hidden_layers=2``) against the port's replicated step (the
    training gate's bounds), and under bf16 mixed precision: the loss
    against the replicated bf16 step's (the bf16 bound), the gradients
    against the float32 step's."""
    root, batch = runs["root"], runs["batch"]
    data = tuple(batch[k] for k in ("init", "target", "forcing"))
    got = runs["results"]["s2"][0]["routes"]
    cases = {
        "v2": ("graph_lam", {}, {}, LOSS_RTOL, "on"),
        "unfused": ("graph_lam_h2", dict(hidden_layers=2), {}, LOSS_RTOL, None),
        "bf16": ("graph_lam", dict(compute_dtype="bfloat16"), dict(precision="bf16"),
                 BF16_LOSS_RTOL, None),
    }
    for label, (name, model_kw, args, loss_tol, v2) in cases.items():
        if v2:
            os.environ["NEURAL_LAM_TPU_FUSED_V2"] = v2
        try:
            trainer, model, _ = _port_trainer(root, name, runs["states"][name], model_kw, **args)
            loss = trainer.train_step(*data).item()
            grads = grads_to_numpy(model)
        finally:
            os.environ.pop("NEURAL_LAM_TPU_FUSED_V2", None)
        np.testing.assert_allclose(got[label]["losses"][0], loss, rtol=loss_tol, err_msg=label)
        if label != "bf16":
            worst = _rel_grad_errors(got[label]["grads"], grads)
            assert max(worst.values()) <= GRAD_TOL, (label, worst)
            continue
        # bf16 gradients far from the loss (LayerNorm biases at hidden 8)
        # differ by up to 0.15 of their largest entry between any two
        # summation orders, the replicated bf16 step's against its float32
        # step's included; so the sharded bf16 gradients are held against
        # the float32 ones, no further from them than the replicated bf16
        # gradients are (worst and mean), as tests/test_torch_bf16.py holds
        # HiLAM's
        trainer, model, _ = _port_trainer(root, name, runs["states"][name])
        trainer.train_step(*data)
        f32 = grads_to_numpy(model)
        sharded = _rel_grad_errors(got[label]["grads"], f32)
        replicated = _rel_grad_errors(grads, f32)
        assert max(sharded.values()) <= max(replicated.values()), (sharded, replicated)
        assert np.mean(list(sharded.values())) <= np.mean(list(replicated.values()))


def test_scan_steps_and_the_checkpoint_at_world_1(runs):
    """``scan_steps=2`` gives the two eager steps' losses; the checkpoint
    the two ranks wrote after four steps, restored by one process, gives
    their next two losses (1e-5)."""
    r = runs["results"]["s2"][0]["scan_ckpt"]
    np.testing.assert_allclose(r["scanned"], r["eager"], rtol=1e-6)
    trainer, model, _ = _port_trainer(runs["root"], "graph_lam", runs["states"]["graph_lam"])
    ckpt = CheckpointManager(runs["root"] / "s2" / "ckpt")
    assert ckpt.restore("latest", model, trainer.optimizer) == 4
    data = tuple(runs["batch"][k] for k in ("init", "target", "forcing"))
    got = [trainer.train_step(*data).item() for _ in range(2)]
    np.testing.assert_allclose(got, r["after_ckpt"], rtol=1e-5)


def test_single_shard_executor_gives_the_replicated_bits(runs):
    """``spatial_shards=1`` in one process, no process group: the executor
    with no exchange, the replicated step's losses bit for bit."""
    data = tuple(runs["batch"][k] for k in ("init", "target", "forcing"))
    for name in FAMILIES:
        got = []
        for shards in (None, 1):
            model, ds = _port_model(runs["root"], name, runs["states"][name])
            trainer = Trainer(ARForecaster(model, ds), config.config_from_dict(CONFIG), ds,
                              TrainingArgs(batch_size=GLOBAL_BATCH, lr=LR), device="cpu",
                              spatial_shards=shards)
            got.append([trainer.train_step(*data).item() for _ in range(2)])
        assert got[0] == got[1], name


def test_zero1_over_the_whole_world(runs):
    """At ``S x D = 2 x 2`` ZeRO-1 shards AdamW's moments over all four
    ranks (``test_zero1_over_full_mesh_with_spatial`` in JAX)."""
    for r in runs["results"]["s2d2"]:
        res = r["families"]["graph_lam"]
        assert res["sharded"] and res["moments"] * 4 == res["padded"]


@pytest.mark.parametrize("key", ["s2", "s4"])
def test_recorded_collectives_equal_the_analytic_budget(runs, key):
    """GraphLAM's first training step: per edge set, the bytes the ranks
    received add up to ``analytic_budget``'s ``bytes_per_step_shards``,
    and each rank received, per forward exchange, the rows its meta says
    (per backward exchange, the rows it sent)."""
    world, shards = GROUPS[key]
    _, graph = load_graph(runs["root"] / "graph" / "multiscale", mesh_node_features_scaling=1.0)
    metas = graph_metas(graph, DS_KW["n_grid_x"] * DS_KW["n_grid_y"], shards)
    rounds = {"m2m0": LAYERS}
    budget = {a["edge_set"]: a for a in analytic_budget(
        metas, batch_local=GLOBAL_BATCH, hidden_dim=HIDDEN, rounds=rounds)}
    records = [r["families"]["graph_lam"]["records"] for r in runs["results"][key]]
    totals = {}
    for rank, recs in enumerate(records):
        for name, b in recorded_bytes(recs).items():
            totals[name] = totals.get(name, 0) + b
        for row in recorded_table(recs):
            meta = metas[row["edge_set"]]
            per = rounds.get(row["edge_set"], 1)
            if row["direction"] == "forward":
                want = meta.recv_rows(rank)
            elif meta.strategy == "all_gather":
                want = meta.n_send_local * (shards - 1)
            else:
                want = sum(meta.send_plan(rank)[1])
            assert row["count"] == per and row["rows"] == want * per, (rank, row)
    for name, a in budget.items():
        assert totals.get(name, 0) == a["bytes_per_step_shards"], (name, totals, a)
    assert any(a["collectives_per_step"] for a in budget.values())
    # the projection takes a bandwidth from the caller (here an arbitrary
    # one, not a device's): more bytes at the same rate, less efficiency
    kw = dict(step_time_s=0.02, n_collectives=sum(a["collectives_per_step"]
                                                  for a in budget.values()),
              n_shards=shards, link_bytes_s=1e9)
    total = sum(a["bytes_per_step"] for a in budget.values())
    low, high = (projected_efficiency(bytes_per_step=b, **kw)["efficiency"]
                 for b in (2 * total, total))
    assert 0.0 < low < high <= 1.0


def test_train_model_spatial_shards_matches_one_process(runs, tmp_path):
    """``train_model --spatial_shards 2`` under two gloo ranks (one epoch,
    then ``--eval test`` from its checkpoint) against the same argv in one
    process: the epoch's record and the test metrics within 1e-5, the
    per-node loss map too."""
    argv, runs_root = runs["cli_argv"], tmp_path / "runs"
    train_model.main(argv + ["--epochs", "1", "--runs_root", str(runs_root),
                             "--logger_run_name", "run"], device="cpu")
    train_model.main(argv + ["--eval", "test", "--runs_root", str(runs_root),
                             "--logger_run_name", "ev", "--load", str(runs_root / "run")],
                     device="cpu")
    got_root = runs["root"] / "s2" / "runs"

    def history(root):
        return [json.loads(line)
                for line in (root / "run" / "history.jsonl").read_text().splitlines()]

    (want,), (got,) = history(runs_root), history(got_root)
    for key in ("train_loss", "val_loss", "val_loss_unroll1", "val_loss_unroll2"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    want = json.loads((runs_root / "ev" / "test_metrics.json").read_text())
    got = json.loads((got_root / "ev" / "test_metrics.json").read_text())
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(np.load(got_root / "ev" / "mean_spatial_loss.npy"),
                               np.load(runs_root / "ev" / "mean_spatial_loss.npy"),
                               rtol=1e-5, atol=1e-7)
