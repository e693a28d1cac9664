"""One rank of a gloo process group, for ``tests/test_torch_dp.py``.

Run as ``python tests/torch_dp_worker.py SPEC.json`` with ``torchrun``'s
environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_WORLD_SIZE``, ``LOCAL_RANK``); it imports ``torch`` and
``neural_lam_tpu_torch`` only. It joins the group with
``utils.distributed.init_from_env``, runs the scenarios the spec names on
the CPU and writes what each found to ``<out>/rank<r>.pt``; the test
holds those results to the JAX package and to one process.
"""

import json
import os
import signal
import sys
from pathlib import Path

import numpy as np
import torch

from neural_lam_tpu_torch import config
from neural_lam_tpu_torch.checkpoint import CheckpointManager
from neural_lam_tpu_torch.convert_checkpoint import grads_to_numpy, params_to_numpy
from neural_lam_tpu_torch.dataset import WeatherDataset
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.loader import DataLoader
from neural_lam_tpu_torch.models import ARForecaster, GraphLAM
from neural_lam_tpu_torch.trainer import Trainer, TrainingArgs
from neural_lam_tpu_torch.utils import distributed

CONFIG = {"datastore": {"kind": "dummydata", "config_path": "ds.yaml"}}


def trainer_for(spec, **args):
    """A port trainer on the CPU holding the spec's weights."""
    ds = DummyDatastore(root_path=spec["root"], **spec["ds_kw"])
    model = GraphLAM(ds, hidden_dim=spec["hidden"], processor_layers=spec["layers"],
                     device="cpu")
    with np.load(spec["params"]) as f:
        model.load_state_dict({k: torch.from_numpy(f[k]) for k in f.files}, strict=True)
    args = dict(dict(batch_size=spec["batch_size"], lr=spec["lr"]), **args)
    trainer = Trainer(ARForecaster(model, ds), config.config_from_dict(CONFIG), ds,
                      TrainingArgs(**args), device="cpu")
    return trainer, model, ds


def my_block(spec, lay):
    """This rank's contiguous block of the spec's global batch (node-major,
    as the JAX package assembles a global batch from the hosts' blocks)."""
    with np.load(spec["batch"]) as f:
        arrays = [f[k] for k in ("init", "target", "forcing")]
    per = arrays[0].shape[0] // lay.world
    return [a[lay.rank * per:(lay.rank + 1) * per] for a in arrays]


def block_loader(dataset, spec, lay, batch_size, shuffle):
    """The loader ``train_model`` makes: the node's shard, the rank's block."""
    return DataLoader(dataset, batch_size=batch_size, shuffle=shuffle, seed=0, prefetch=0,
                      shard_index=lay.node, num_shards=lay.nodes,
                      block_index=lay.local_rank, num_blocks=lay.local_world)


def scenario_train(spec, lay):
    """Four steps on the global batch under ZeRO-1, replicated moments and
    flat_opt: the losses, the first step's gradients (the mean over the
    ranks), the weights after, this rank's moment sizes; under ZeRO-1 a
    checkpoint saved after the four steps and two more steps' losses."""
    block = my_block(spec, lay)
    out = {}
    for mode, args in (("zero", {}), ("replicated", dict(shard_opt_state=False)),
                       ("flat", dict(flat_opt=True))):
        trainer, model, _ = trainer_for(spec, **args)
        losses = [trainer.train_step(*block).item()]
        grads = grads_to_numpy(model)
        losses += [trainer.train_step(*block).item() for _ in range(3)]
        opt = trainer.optimizer
        res = dict(losses=losses, grads=grads, params=params_to_numpy(model),
                   moments=opt.state[opt.shard]["exp_avg"].numel(), padded=opt.padded)
        if mode == "zero":
            ckpt = Path(spec["out"]) / f"ckpt_w{lay.world}"
            CheckpointManager(ckpt).save("latest", model, opt, 4, {"world": lay.world})
            res["after_ckpt"] = [trainer.train_step(*block).item() for _ in range(2)]
        out[mode] = res
    return out


def scenario_eval(spec, lay):
    """``evaluate`` over the validation split through the rank's blocks,
    the node batch leaving a tail smaller than the rank count."""
    trainer, _, ds = trainer_for(spec, val_steps_to_log=(1,))
    loader = block_loader(WeatherDataset(ds, "val", ar_steps=1), spec, lay,
                          spec["eval_batch_size"], shuffle=False)
    return trainer.evaluate(loader, "val")


def scenario_test_eval(spec, lay):
    """``run_test_evaluation`` over the test split through the rank's
    blocks, every rank into one directory: the metrics."""
    from neural_lam_tpu_torch.evaluation import run_test_evaluation

    trainer, _, ds = trainer_for(spec, val_steps_to_log=(1,))
    loader = block_loader(WeatherDataset(ds, "test", ar_steps=2), spec, lay,
                          spec["eval_batch_size"], shuffle=False)
    run_dir = Path(spec["out"]) / "test_eval"
    return run_test_evaluation(trainer, loader, ds, run_dir, split="test", n_example_pred=0)


def scenario_preempt(spec, lay):
    """Two epochs of ``fit`` with ``preempt_check_every=2``: rank 0 alone
    is sent SIGTERM while its first batch is read. Every rank counts the
    steps it took."""
    trainer, _, ds = trainer_for(spec, preempt_check_every=2)
    trainer.install_preemption_handler()
    loader = block_loader(WeatherDataset(ds, "train", ar_steps=1), spec, lay,
                          spec["preempt_batch_size"], shuffle=True)
    signalled = []

    class Signalling:
        def set_epoch(self, epoch):
            loader.set_epoch(epoch)

        def __iter__(self):
            for i, batch in enumerate(loader):
                if lay.rank == 0 and i == 0 and not signalled:
                    signalled.append(True)
                    os.kill(os.getpid(), signal.SIGTERM)
                yield batch

    steps = []
    step = trainer.make_train_step()
    trainer._train_step = lambda *b: steps.append(1) or step(*b)
    history = trainer.fit(Signalling(), None, epochs=2)
    return dict(steps=len(steps), epochs=len(history),
                preempted=bool(history[-1].get("preempted")), batches=len(loader))


def scenario_samples(spec, lay):
    """The sample indices of each batch block of two shuffled epochs."""

    class Indices:
        def __len__(self):
            return spec["samples_n"]

        def __getitem__(self, i):
            return (np.array([i]),)

    loader = block_loader(Indices(), spec, lay, spec["samples_batch_size"], shuffle=True)
    out = []
    for epoch in range(2):
        loader.set_epoch(epoch)
        out.append([(b[0][:, 0].tolist(), b.real) for b in loader])
    return out


def scenario_stats(spec, lay):
    """``compute_standardization_stats --multihost`` on the spec's store."""
    from neural_lam_tpu_torch.datastore.npyfilesmeps.compute_standardization_stats import (
        main as stats_main,
    )

    stats_main(["--datastore_config_path", spec["stats_cfg"], "--multihost",
                "--num_workers", "1"])
    return True


SCENARIOS = dict(train=scenario_train, eval=scenario_eval, test_eval=scenario_test_eval,
                 preempt=scenario_preempt, samples=scenario_samples, stats=scenario_stats)


def main() -> None:
    spec = json.loads(Path(sys.argv[1]).read_text(encoding="utf-8"))
    torch.set_num_threads(1)
    distributed.init_from_env("gloo")
    lay = distributed.layout()
    results = {name: SCENARIOS[name](spec, lay) for name in spec["scenarios"]}
    results["layout"] = (lay.rank, lay.world, lay.local_rank, lay.local_world)
    torch.save(results, Path(spec["out"]) / f"rank{lay.rank}.pt")
    distributed.destroy()


if __name__ == "__main__":
    main()
