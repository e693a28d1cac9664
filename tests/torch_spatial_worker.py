"""One rank of a gloo process group, for ``tests/test_torch_spatial.py``.

Run as ``python tests/torch_spatial_worker.py SPEC.json`` with
``torchrun``'s environment; it imports ``torch`` and
``neural_lam_tpu_torch`` only. It joins the group, runs the scenarios the
spec names on the CPU under spatial partitioning (``spec["shards"]``
shards per spatial group, the remaining ranks data-parallel) and writes
what each found to ``<out>/rank<r>.pt``.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

from neural_lam_tpu_torch import config
from neural_lam_tpu_torch.checkpoint import CheckpointManager
from neural_lam_tpu_torch.convert_checkpoint import grads_to_numpy
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.models import ARForecaster, GraphLAM, HiLAM, HiLAMParallel
from neural_lam_tpu_torch.parallel.spatial import ShardedModel, record_collectives
from neural_lam_tpu_torch.trainer import Trainer, TrainingArgs
from neural_lam_tpu_torch.utils import distributed

CONFIG = {"datastore": {"kind": "dummydata", "config_path": "ds.yaml"}}
FAMILIES = {
    "graph_lam": (GraphLAM, "multiscale"),
    "hi_lam": (HiLAM, "hierarchical"),
    "hi_lam_parallel": (HiLAMParallel, "hierarchical"),
    "graph_lam_h2": (GraphLAM, "multiscale"),  # hidden_layers=2: the unfused route
}


def model_for(spec, name, **kw):
    """The spec's model ``name`` on the CPU with its weights (``params`` of
    the spec, by state-dict name)."""
    ds = DummyDatastore(root_path=spec["root"], **spec["ds_kw"])
    cls, graph = FAMILIES[name]
    model = cls(ds, graph_name=graph, hidden_dim=spec["hidden"],
                processor_layers=spec["layers"], device="cpu", **kw)
    with np.load(spec["params"][name]) as f:
        model.load_state_dict({k: torch.from_numpy(f[k]) for k in f.files}, strict=True)
    return model, ds


def trainer_for(spec, name, model_kw=None, **args):
    model, ds = model_for(spec, name, **(model_kw or {}))
    args = dict(dict(batch_size=spec["batch_size"], lr=spec["lr"]), **args)
    trainer = Trainer(ARForecaster(model, ds), config.config_from_dict(CONFIG), ds,
                      TrainingArgs(**args), device="cpu", spatial_shards=spec["shards"])
    return trainer, model, ds


def my_block(spec, lay):
    """This rank's data group's block of the global batch (whole grid)."""
    with np.load(spec["batch"]) as f:
        arrays = {k: f[k] for k in f.files}
    groups = lay.world // spec["shards"]
    per = arrays["init"].shape[0] // groups
    d = lay.rank // spec["shards"]
    return {k: a[d * per:(d + 1) * per] for k, a in arrays.items()}


def rollout(sharded, forecaster, block):
    """The sharded forecast of the block's rollout inputs, gathered to the
    whole grid."""
    local = sharded.local_forecaster(forecaster)
    slab = [torch.from_numpy(sharded.grid_slab(block[k]))
            for k in ("roll_init", "roll_forcing", "roll_boundary")]
    with torch.no_grad():
        pred, _ = local(*slab)
    return sharded.gather_grid(pred).numpy()


def train_run(trainer, model, block, steps=4, record=False):
    data = [block[k] for k in ("init", "target", "forcing")]
    with record_collectives() as records:
        losses = [trainer.train_step(*data).item()]
    grads = grads_to_numpy(model)
    losses += [trainer.train_step(*data).item() for _ in range(steps - 1)]
    out = dict(losses=losses, grads=grads)
    if record:
        out["records"] = list(records)
    return out


def scenario_families(spec, lay):
    """Each family: the forecast's states, the first loss and gradients,
    and three further losses (GraphLAM's first step with its collectives
    recorded)."""
    block = my_block(spec, lay)
    out = {}
    for name in spec["families"]:
        trainer, model, _ = trainer_for(spec, name)
        res = train_run(trainer, model, block, record=name == "graph_lam")
        trainer, _, _ = trainer_for(spec, name)
        res["states"] = rollout(trainer.spatial, trainer.forecaster, block)
        res["edges"] = {k: ge.edges.num_edges for k, ge in _edge_sets(trainer.spatial)}
        opt = trainer.optimizer
        res["moments"] = opt.shard.numel()
        res["padded"] = opt.padded
        res["sharded"] = opt.sharded
        out[name] = res
    return out


def _edge_sets(sharded):
    g = sharded.graph
    yield "g2m", g.g2m
    yield "m2g", g.m2g
    for i, ge in enumerate(g.m2m):
        yield f"m2m{i}", ge
    for i, ge in enumerate(g.up):
        yield f"up{i}", ge
    for i, ge in enumerate(g.down):
        yield f"down{i}", ge


def scenario_forced(spec, lay):
    """GraphLAM's and HiLAM's forecasts with every edge set on the halo
    strategy the rule allows (``all_gather_max_nodes=0``)."""
    block = my_block(spec, lay)
    out = {}
    for name in ("graph_lam", "hi_lam"):
        model, ds = model_for(spec, name)
        sharded = ShardedModel(model, ds, spec["shards"],
                               group=distributed.spatial_group(spec["shards"]),
                               all_gather_max_nodes=0)
        out[name] = dict(states=rollout(sharded, ARForecaster(model, ds), block),
                         strategies={k: m.strategy for k, m in sharded.metas.items()})
    return out


def scenario_routes(spec, lay):
    """GraphLAM's first step on the v2 route and on the unfused route
    (``hidden_layers=2``), and in bf16 mixed precision."""
    block = my_block(spec, lay)
    out = {}
    os.environ["NEURAL_LAM_TPU_FUSED_V2"] = "on"
    trainer, model, _ = trainer_for(spec, "graph_lam")
    out["v2"] = train_run(trainer, model, block, steps=1)
    del os.environ["NEURAL_LAM_TPU_FUSED_V2"]
    trainer, model, _ = trainer_for(spec, "graph_lam_h2", model_kw=dict(hidden_layers=2))
    out["unfused"] = train_run(trainer, model, block, steps=1)
    trainer, model, _ = trainer_for(spec, "graph_lam", model_kw=dict(compute_dtype="bfloat16"),
                                    precision="bf16")
    out["bf16"] = train_run(trainer, model, block, steps=1)
    return out


def scenario_scan_ckpt(spec, lay):
    """``scan_steps=2`` against two eager steps; four steps, a checkpoint
    (every rank saves, rank 0 writes) and two more steps' losses."""
    block = my_block(spec, lay)
    data = [block[k] for k in ("init", "target", "forcing")]
    trainer, model, _ = trainer_for(spec, "graph_lam")
    eager = [trainer.train_step(*data).item() for _ in range(2)]
    trainer, model, _ = trainer_for(spec, "graph_lam")
    step = trainer.make_train_step(scan_steps=2)
    scanned = step(*(np.stack([a, a]) for a in data)).tolist()
    trainer, model, _ = trainer_for(spec, "graph_lam")
    for _ in range(4):
        trainer.train_step(*data)
    CheckpointManager(Path(spec["out"]) / "ckpt").save("latest", model, trainer.optimizer, 4,
                                                       {"shards": spec["shards"]})
    after = [trainer.train_step(*data).item() for _ in range(2)]
    return dict(eager=eager, scanned=scanned, after_ckpt=after)


def scenario_cli(spec, lay):
    """``train_model --spatial_shards`` for one epoch, then ``--eval test``
    from its checkpoint, the ranks in the group already joined."""
    from neural_lam_tpu_torch import train_model

    argv = spec["cli_argv"] + ["--spatial_shards", str(spec["shards"])]
    runs = str(Path(spec["out"]) / "runs")
    train_model.main(argv + ["--epochs", "1", "--runs_root", runs, "--logger_run_name", "run"],
                     device="cpu")
    train_model.main(argv + ["--eval", "test", "--runs_root", runs, "--logger_run_name", "ev",
                             "--load", str(Path(runs) / "run")], device="cpu")
    return True


SCENARIOS = dict(families=scenario_families, forced=scenario_forced, routes=scenario_routes,
                 scan_ckpt=scenario_scan_ckpt, cli=scenario_cli)


def main() -> None:
    spec = json.loads(Path(sys.argv[1]).read_text(encoding="utf-8"))
    torch.set_num_threads(1)
    distributed.init_from_env("gloo")
    lay = distributed.layout()
    results = {name: SCENARIOS[name](spec, lay) for name in spec["scenarios"]}
    results["layout"] = (lay.rank, lay.world)
    torch.save(results, Path(spec["out"]) / f"rank{lay.rank}.pt")
    distributed.destroy()


if __name__ == "__main__":
    main()
