"""Train/eval CLI: ``python -m neural_lam_tpu_torch.train_model``.

Counterpart of ``neural_lam_tpu/train_model.py`` with the same flag set
(reference: neural_lam/train_model.py:76-548), so that an argv written
for the JAX CLI parses unchanged, on top of the port's
:class:`~neural_lam_tpu_torch.trainer.Trainer`. It runs on ``cuda``
unless :func:`main` is called with ``device="cpu"``.

On several GPUs it runs one process per GPU, as ``torchrun`` starts
them::

    torchrun --nproc_per_node=N -m neural_lam_tpu_torch.train_model ...

``torchrun``'s environment (``WORLD_SIZE`` above 1), or ``--multihost``,
makes each process join the process group (NCCL on CUDA, gloo on the
CPU) on ``cuda:<LOCAL_RANK>``. ``--batch_size`` is per node, as in the
JAX CLI (and not per process, as under Lightning's DDP): the global
batch is ``batch_size x nodes``, each node reads its shard of every epoch
and each of its ranks its contiguous block of the node's batch, so that
each step sees the samples the JAX CLI's step sees with the same
``--num_nodes``, ``--devices`` and ``--batch_size``. ``--devices`` caps
the ranks per node, ``--num_nodes`` is checked against the launch, rank 0
logs and writes the files, and every rank saves the checkpoints
collectively. ``--spatial_shards S`` partitions the grid and the mesh
over groups of ``S`` ranks of a node (``parallel/spatial.py``): the ranks
form a ``(data, spatial)`` layout as the JAX CLI's mesh, the ranks of a
spatial group read the same block of the node's batch, and the node's
batch is cut into ``ranks per node / S`` blocks. The flags fall into four
groups:

- flags with a counterpart, which do what they do in the JAX CLI;
- ``--fused_v2``, ``--cache_pre``, ``--bf16_kernels`` and
  ``--matmul_precision``, which set the port's routing and precision
  variables (``ops/fused_kernels.py``, ``ops/segment.py``), an explicitly
  set variable winning over the flag;
- flags of TPU layouts the port does not have (``--pallas``,
  ``--fused_embed``, ``--kernel_tiling``, ``--banded_gather``,
  ``--aligned_layout``): accepted, with no effect, named on stderr;
- flags of work not ported yet, which would raise ``SystemExit`` naming
  the ROADMAP item that brings them (:data:`UNPORTED`, empty now).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
from pathlib import Path

import torch

from . import utils
from .checkpoint import CheckpointManager, resolve_load
from .config import load_config_and_datastore
from .dataset import WeatherDataset
from .loader import DataLoader
from .metrics import DEFINED_METRICS
from .models import MODELS, ARForecaster
from .ops.fused_kernels import CACHE_PRE_ENV, FUSED_V2_ENV
from .ops.segment import BF16_KERNELS_ENV, MATMUL_PRECISION_ENV, apply_matmul_precision
from .trainer import Trainer, TrainingArgs
from .utils import distributed
from .utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train or evaluate neural-lam-tpu models",
    )
    core = parser.add_argument_group("Core Configuration")
    core.add_argument(
        "--config_path",
        type=str,
        help="Path to the configuration for neural-lam-tpu",
    )
    core.add_argument(
        "--model",
        type=str,
        default="graph_lam",
        choices=sorted(MODELS),
        help="Model architecture to train/evaluate",
    )
    core.add_argument("--seed", type=int, default=42, help="random seed")

    runtime = parser.add_argument_group("Runtime & Device Settings")
    runtime.add_argument(
        "--multihost",
        action="store_true",
        help="Join the torch.distributed process group that torchrun's "
        "environment describes (also done without the flag when "
        "WORLD_SIZE is above 1)",
    )
    runtime.add_argument(
        "--devices",
        type=int,
        default=None,
        help="Ranks (GPUs) per node that train, the first N local ranks "
        "of every node (reference: Lightning's --devices); the others exit",
    )
    runtime.add_argument(
        "--num_nodes",
        type=int,
        default=None,
        help="Expected number of nodes, checked against the launch "
        "(the reference passes it to Lightning DDP)",
    )
    runtime.add_argument(
        "--num_workers",
        type=int,
        default=2,
        help="Loader prefetch depth (the counterpart of the "
        "reference's DataLoader worker count; loading here is "
        "memmap-backed threads, not worker processes)",
    )
    runtime.add_argument(
        "--debug_nans",
        action="store_true",
        help="Error out at the first non-finite training loss (the "
        "counterpart of the reference's detect_anomaly NaN tripwire, "
        "reference: tests/test_training.py:77): every step's loss is "
        "read on the host, which waits for the device each step",
    )
    runtime.add_argument(
        "--spatial_shards",
        type=int,
        default=1,
        help="Shard grid+mesh nodes over this many devices (a 'spatial' "
        "axis of ranks; the remaining ranks form the data axis)",
    )
    runtime.add_argument(
        "--precision",
        type=str,
        default="32",
        choices=["32", "bf16"],
        help="Numerical precision for compute (32/bf16)",
    )
    runtime.add_argument(
        "--load",
        type=str,
        help="Run dir or checkpoint dir to load model parameters from",
    )
    runtime.add_argument(
        "--restore_opt",
        action="store_true",
        help="If optimizer state should be restored with model",
    )
    runtime.add_argument(
        "--flat_opt",
        action="store_true",
        help="Run AdamW on one flat parameter buffer (the counterpart "
        "of optax.flatten); the optimizer state is one vector, so a "
        "checkpoint restores with the same setting",
    )
    runtime.add_argument(
        "--profile_dir",
        type=str,
        default=None,
        help="Write a torch.profiler trace of a few training steps of "
        "the first epoch to <profile_dir>/trace.json, and the program's "
        "spans and counters to <profile_dir>/trace_spans.json after each "
        "epoch's validation and after --eval",
    )

    kernels = parser.add_argument_group(
        "TPU Kernel Tuning",
        "The JAX package's kernel flags, accepted unchanged. --fused_v2, "
        "--cache_pre, --bf16_kernels and --matmul_precision map to the "
        "port's NEURAL_LAM_TPU_FUSED_V2, NEURAL_LAM_TPU_CACHE_PRE, "
        "NEURAL_LAM_TPU_BF16_KERNELS and NEURAL_LAM_TPU_MATMUL_PRECISION "
        "(an env var already set wins); the flags of TPU layouts the port "
        "does not have (--pallas, --fused_embed, --kernel_tiling, "
        "--banded_gather, --aligned_layout) have no effect.",
    )
    kernels.add_argument(
        "--pallas",
        choices=["auto", "off", "interpret"],
        default=None,
        help="Pallas aggregation kernels: auto (on for TPU backends), "
        "off (XLA segment_sum fallback), interpret (kernel interpreter, "
        "for CPU debugging). [NEURAL_LAM_TPU_PALLAS]",
    )
    kernels.add_argument(
        "--fused_embed",
        choices=["on", "off"],
        default=None,
        help="Run the static edge-feature embedder INSIDE the fused "
        "kernel (fastest, but cold-compiles in tens of minutes through "
        "the remote helper; amortised by the persistent cache). "
        "[NEURAL_LAM_TPU_FUSED_EMBED]",
    )
    kernels.add_argument(
        "--fused_v2",
        choices=["auto", "off"],
        default=None,
        help="Merged-prologue fused kernel (v2): the banded sender "
        "gather runs inside the edge kernel and the first-layer "
        "node projections hoist outside. off restores the v1 "
        "expand->fused pipeline. Requires --cache_pre on. "
        "[NEURAL_LAM_TPU_FUSED_V2]",
    )
    kernels.add_argument(
        "--cache_pre",
        choices=["on", "off"],
        default=None,
        help="Save the fused kernels' per-edge first-layer "
        "pre-activations as a VJP residual (+3.6%% step time for "
        "~(E x lanes) f32 of HBM per edge set). [NEURAL_LAM_TPU_CACHE_PRE]",
    )
    kernels.add_argument(
        "--bf16_kernels",
        choices=["auto", "off"],
        default=None,
        help="Under --precision bf16, let bf16 streams reach into the "
        "kernels' matmul operands; off keeps kernels f32 with boundary "
        "casts. [NEURAL_LAM_TPU_BF16_KERNELS]",
    )
    kernels.add_argument(
        "--matmul_precision",
        choices=["default", "highest", "high", "high-kernels"],
        default=None,
        help="f32 matmul operand handling. default = the hardware fast "
        "path: on TPU, f32 matmul OPERANDS round to bf16 implicitly "
        "(f32 accumulation) — the TPU counterpart of the reference's "
        "CUDA TF32 default, and what the headline numbers are measured "
        "under. highest = exact f32 operands everywhere (sets "
        "jax_default_matmul_precision, reaching the Pallas kernels "
        "too) for on-TPU parity verification, at multi-pass matmul "
        "cost. high / high-kernels = EXPLICIT bf16 stream/operand "
        "casts (measured slower than default — the rounding already "
        "happens implicitly). [NEURAL_LAM_TPU_MATMUL_PRECISION]",
    )
    kernels.add_argument(
        "--kernel_tiling",
        choices=["default", "sweep"],
        default=None,
        help="Per-edge-set kernel tiling: default = the (256, 512) "
        "tiling tuned for the embed-fused step; sweep = per-set "
        "measured tilings (faster for the non-embed-fused variant). "
        "[NEURAL_LAM_TPU_TILING]",
    )
    kernels.add_argument(
        "--banded_gather",
        choices=["auto", "off"],
        default=None,
        help="Banded sender gather/scatter visit tables; off falls back "
        "to the sender-sorted layout + slot permutation. "
        "[NEURAL_LAM_TPU_BANDED]",
    )
    kernels.add_argument(
        "--aligned_layout",
        choices=["auto", "off"],
        default=None,
        help="Degree-aligned layouts for uniform-degree edge sets "
        "(m2g's 4-NN): the fused kernel replaces its one-hot "
        "gather/aggregate matmuls with static slices. Measured "
        "perf-neutral on v5e (the kernels are stream-bound) with "
        "slightly better numerics under the hardware-default matmul "
        "precision; off (default) keeps the compiled HLO stable. "
        "[NEURAL_LAM_TPU_ALIGNED]",
    )

    arch = parser.add_argument_group("Model Architecture")
    arch.add_argument("--graph", type=str, default="multiscale")
    arch.add_argument("--hidden_dim", type=int, default=64)
    arch.add_argument("--hidden_layers", type=int, default=1)
    arch.add_argument("--processor_layers", type=int, default=4)
    arch.add_argument(
        "--mesh_aggr", type=str, default="sum", choices=["sum", "mean"]
    )
    arch.add_argument("--output_std", action="store_true")
    for flag in (
        "--g2m_gnn_type",
        "--m2g_gnn_type",
        "--mesh_up_gnn_type",
        "--mesh_down_gnn_type",
    ):
        arch.add_argument(
            flag,
            type=str,
            default="InteractionNet",
            choices=["InteractionNet", "PropagationNet"],
        )

    train = parser.add_argument_group("Training Options")
    train.add_argument("--epochs", type=int, default=200)
    train.add_argument("--batch_size", type=int, default=4)
    train.add_argument("--ar_steps_train", type=int, default=1)
    train.add_argument(
        "--loss", type=str, default="wmse", choices=sorted(DEFINED_METRICS)
    )
    train.add_argument("--lr", type=float, default=1e-3)
    train.add_argument(
        "--weight_decay",
        type=float,
        default=0.01,
        help="AdamW decoupled weight decay (default matches the "
        "reference's torch.optim.AdamW default of 0.01, "
        "reference: models/module.py:284-287)",
    )
    train.add_argument("--val_interval", type=int, default=1)

    evalg = parser.add_argument_group("Evaluation Options")
    evalg.add_argument(
        "--eval",
        type=str,
        choices=["val", "test"],
        help="Eval model on given data split instead of training",
    )
    evalg.add_argument("--ar_steps_eval", type=int, default=10)
    evalg.add_argument("--n_example_pred", type=int, default=1)
    evalg.add_argument(
        "--create_gif",
        action="store_true",
        help="Animate example predictions over lead time as GIFs",
    )

    logger = parser.add_argument_group("Logger Settings")
    logger.add_argument(
        "--logger",
        type=str,
        default="csv",
        choices=["csv", "wandb", "mlflow", "none"],
    )
    logger.add_argument("--logger_project", type=str, default="neural_lam")
    logger.add_argument("--logger_run_name", type=str, default=None)
    logger.add_argument(
        "--logger_run_id",
        "--wandb_id",  # drop-in alias for the reference flag name
        dest="logger_run_id",
        type=str,
        default=None,
        help="Resume an existing W&B run by id "
        "(reference --wandb_id, train_model.py:300-306)",
    )
    logger.add_argument("--runs_root", type=str, default="runs")

    metrics = parser.add_argument_group("Metrics & Monitoring")
    metrics.add_argument(
        "--val_steps_to_log",
        type=int,
        nargs="+",
        default=[1, 2, 3, 5, 10],
    )
    metrics.add_argument("--metrics_watch", nargs="+", default=[])
    metrics.add_argument(
        "--var_leads_metrics_watch",
        type=str,
        default="{}",
        help="JSON mapping of variable name -> list of lead steps to "
        'watch, e.g. \'{"t2m": [1, 5]}\'',
    )

    data = parser.add_argument_group("Data Loading & Forcing")
    data.add_argument("--num_past_forcing_steps", type=int, default=1)
    data.add_argument("--num_future_forcing_steps", type=int, default=1)
    data.add_argument(
        "--load_single_member",
        action="store_true",
        help="Only use first ensemble member of ensemble datastores",
    )
    return parser


# Kernel flags with a counterpart in the port: flag -> routing or
# precision variable
_KERNEL_FLAG_ENV = {
    "fused_v2": FUSED_V2_ENV,
    "cache_pre": CACHE_PRE_ENV,
    "bf16_kernels": BF16_KERNELS_ENV,
    "matmul_precision": MATMUL_PRECISION_ENV,
}
# Flags of TPU layouts the port does not have: accepted, no effect
NO_EFFECT_FLAGS = (
    "pallas", "fused_embed", "kernel_tiling", "banded_gather", "aligned_layout",
)
# Flags of work not ported yet: (flag, is it asked for, ROADMAP item)
UNPORTED: tuple = ()


def check_unported(args) -> None:
    """Raise ``SystemExit`` for a flag of work the port does not do yet,
    naming the ROADMAP.md item that brings it; none is ignored."""
    for flag, asked, item in UNPORTED:
        if asked(args):
            raise SystemExit(
                f"{flag}: not ported to neural_lam_tpu_torch yet (ROADMAP.md {item})"
            )


def apply_kernel_flags(args) -> None:
    """Propagate ``--fused_v2``, ``--cache_pre``, ``--bf16_kernels`` and
    ``--matmul_precision`` to the port's routing and precision variables,
    which the kernels read at every call; a variable already set in the
    environment wins over the flag (the JAX CLI's rule). Then
    ``apply_matmul_precision``, as the JAX CLI calls it. The flags of TPU
    layouts are named on stderr, and have no effect."""
    for flag, env in _KERNEL_FLAG_ENV.items():
        value = getattr(args, flag, None)
        if value is not None and env not in os.environ:
            os.environ[env] = value
    apply_matmul_precision()
    given = [f"--{f}" for f in NO_EFFECT_FLAGS if getattr(args, f, None) is not None]
    if given:
        print(
            f"note: {', '.join(given)} select TPU kernel layouts that "
            "neural_lam_tpu_torch does not have; no effect",
            file=sys.stderr,
        )


def check_launch(args, launch: distributed.Layout) -> None:
    """The JAX CLI's checks of ``--devices``, ``--num_nodes`` and the
    global batch against the launch (``neural_lam_tpu/train_model.py:438-488``),
    with its messages."""
    if args.devices is not None and not 1 <= args.devices <= launch.local_world:
        raise SystemExit(
            f"--devices {args.devices} outside 1..{launch.local_world} "
            f"(local devices per host)"
        )
    if args.num_nodes is not None and launch.nodes != args.num_nodes:
        raise SystemExit(
            f"--num_nodes {args.num_nodes} but torch.distributed discovered "
            f"{launch.nodes} node(s); check the launch configuration"
        )
    per_node = args.devices or launch.local_world
    shards = args.spatial_shards
    if shards < 1 or (per_node * launch.nodes) % shards:
        raise SystemExit(
            f"--spatial_shards {shards} does not divide the device count "
            f"{per_node * launch.nodes}"
        )
    if per_node % shards:
        raise SystemExit(
            f"--spatial_shards {shards} does not divide the {per_node} ranks per "
            "node: a spatial group lies within one node"
        )
    global_batch = args.batch_size * launch.nodes
    if global_batch % (per_node * launch.nodes // shards):
        raise SystemExit(
            f"--devices {per_node * launch.nodes // shards} does not divide the global "
            f"batch size {global_batch}"
        )


def main(argv=None, device: str = "cuda") -> None:
    """Train, or with ``--eval`` evaluate, on ``device``; over a process
    group (``torchrun``), on ``cuda:<LOCAL_RANK>`` or the CPU."""
    args = build_parser().parse_args(argv)
    if args.config_path is None:
        raise SystemExit("--config_path is required")
    check_unported(args)
    dev = resolve_device(device)
    launch = distributed.launch_layout()
    check_launch(args, launch)
    join = (args.multihost or launch.world > 1) and not distributed.active()
    if dev.type == "cuda" and (join or distributed.active()):
        dev = torch.device("cuda", launch.local_rank)
        torch.cuda.set_device(dev)
    if join and not distributed.init_from_env(
        "nccl" if dev.type == "cuda" else "gloo", devices=args.devices
    ):
        print(f"rank {launch.rank}: beyond --devices {args.devices} on its node, "
              "not training", file=sys.stderr)
        return
    try:
        _run(args, dev)
    finally:
        if join:
            distributed.destroy()


def _run(args, dev: torch.device) -> None:
    lay = distributed.layout()
    is_rank_zero = lay.rank == 0
    if dev.type == "cuda" and lay.world > 1:
        # every rank would build the kernels on first use: one per node
        # builds them first
        from .ops import kernel_build

        if lay.local_rank == 0:
            kernel_build.build()
        distributed.barrier()
    apply_kernel_flags(args)
    # Validate eval step logging against rollout length. Validation
    # during training also unrolls ar_steps_eval steps, so the check is
    # against ar_steps_eval in both modes
    # (reference: train_model.py:362-407).
    invalid = [s for s in args.val_steps_to_log if s > args.ar_steps_eval]
    if invalid:
        print(
            f"warning: val_steps_to_log {invalid} exceed rollout length "
            f"{args.ar_steps_eval}; they will be skipped",
            file=sys.stderr,
        )

    utils.seed_everything(args.seed)
    config, datastore = load_config_and_datastore(args.config_path)

    predictor_kwargs = dict(
        graph_name=args.graph,
        hidden_dim=args.hidden_dim,
        hidden_layers=args.hidden_layers,
        processor_layers=args.processor_layers,
        mesh_aggr=args.mesh_aggr,
        num_past_forcing_steps=args.num_past_forcing_steps,
        num_future_forcing_steps=args.num_future_forcing_steps,
        output_std=args.output_std,
        output_clamping_lower=config.training.output_clamping.lower,
        output_clamping_upper=config.training.output_clamping.upper,
        g2m_gnn_type=args.g2m_gnn_type,
        m2g_gnn_type=args.m2g_gnn_type,
        seed=args.seed,
        device=dev,
        compute_dtype="bfloat16" if args.precision == "bf16" else "float32",
    )
    if args.model != "graph_lam":
        predictor_kwargs.update(
            mesh_up_gnn_type=args.mesh_up_gnn_type,
            mesh_down_gnn_type=args.mesh_down_gnn_type,
        )
    predictor = MODELS[args.model](datastore, **predictor_kwargs)
    forecaster = ARForecaster(predictor, datastore)

    targs = TrainingArgs(
        lr=args.lr,
        weight_decay=args.weight_decay,
        epochs=args.epochs,
        batch_size=args.batch_size,
        ar_steps_train=args.ar_steps_train,
        ar_steps_eval=args.ar_steps_eval,
        loss=args.loss,
        val_interval=args.val_interval,
        val_steps_to_log=tuple(args.val_steps_to_log),
        profile_dir=args.profile_dir,
        precision=args.precision,
        metrics_watch=tuple(args.metrics_watch),
        var_leads_metrics_watch=json.loads(args.var_leads_metrics_watch),
        flat_opt=args.flat_opt,
    )
    trainer = Trainer(
        forecaster, config, datastore, targs, device=dev, debug_nans=args.debug_nans,
        spatial_shards=args.spatial_shards if args.spatial_shards > 1 else None,
    )

    run_name = args.logger_run_name or (
        f"{args.model}-{time.strftime('%m_%d_%H_%M_%S')}"
    )
    run_dir = Path(args.runs_root) / run_name
    run_dir.mkdir(parents=True, exist_ok=True)
    ckpt = CheckpointManager(run_dir)
    hparams = dict(vars(args))
    # Clamping bounds come from the YAML config, not argparse — record
    # them so checkpoints stay fully self-describing (reference
    # self-describing contract: train_model.py:41-72).
    hparams["output_clamping_lower"] = config.training.output_clamping.lower
    hparams["output_clamping_upper"] = config.training.output_clamping.upper

    start_epoch = 0
    if args.load:
        root, name = resolve_load(args.load)
        if not (root / "checkpoints" / name).exists():
            raise SystemExit(
                f"--load: no checkpoint {name!r} under {root / 'checkpoints'}"
            )
        src = CheckpointManager(root)
        # parameters and optimizer state are loaded into the live tensors
        # and optimizer, in place: the module is not rebuilt
        if args.restore_opt:
            # Continue epoch numbering where the checkpoint left off
            start_epoch = src.restore(name, predictor, trainer.optimizer) + 1
        else:
            src.restore_params_only(name, predictor)
        if is_rank_zero:
            print(f"loaded checkpoint {name!r} from {src.ckpt_dir}")

    def make_loader(split, ar_steps, shuffle):
        dataset = WeatherDataset(
            datastore,
            split=split,
            ar_steps=ar_steps,
            num_past_forcing_steps=args.num_past_forcing_steps,
            num_future_forcing_steps=args.num_future_forcing_steps,
            load_single_member=args.load_single_member,
        )
        # each node reads its shard of every epoch (the explicit per-host
        # index scheme replacing the reference's DistributedSampler,
        # SURVEY.md 7), each rank its block of the node's batch (the ranks
        # of a spatial group the same block)
        shards = args.spatial_shards
        return DataLoader(
            dataset,
            batch_size=args.batch_size,
            shuffle=shuffle,
            seed=args.seed,
            prefetch=args.num_workers,
            shard_index=lay.node,
            num_shards=lay.nodes,
            block_index=lay.local_rank // shards,
            num_blocks=lay.local_world // shards,
        )

    from .evaluation import run_test_evaluation
    from .loggers import NullLogger, setup_training_logger

    if args.logger_run_id and args.logger != "wandb" and is_rank_zero:
        print(
            f"warning: --logger_run_id is set but logger is "
            f"{args.logger!r}; the run id has no effect "
            "(reference: utils.py:754-757)"
        )
    # rank 0 logs; the others get a logger that does nothing (reference:
    # Lightning's rank_zero_only gating)
    if is_rank_zero:
        logger = setup_training_logger(
            args.logger,
            run_dir,
            project=args.logger_project,
            run_name=run_name,
            run_id=args.logger_run_id,
            config=hparams,
        )
    else:
        logger = NullLogger()
    logger.log_hparams(hparams)
    # Run-level min summaries for the validation losses
    # (reference: neural_lam/utils.py:689-713)
    logger.watch_min_metrics(
        ["val_loss"] + [f"val_loss_unroll{s}" for s in args.val_steps_to_log]
    )

    if args.eval:
        if not args.load:
            # reference: train_model.py:382-385
            print(
                "warning: --eval without --load evaluates freshly "
                "initialised parameters; no checkpoint is loaded"
            )
        loader = make_loader(args.eval, args.ar_steps_eval, shuffle=False)
        var_leads = json.loads(args.var_leads_metrics_watch)
        # Validate watched variables against the datastore at CLI time
        # (reference: train_model.py:396-407).
        unknown = set(var_leads) - set(datastore.get_vars_names("state"))
        if unknown:
            raise SystemExit(
                f"--var_leads_metrics_watch names unknown state "
                f"variables: {sorted(unknown)}"
            )
        metrics = run_test_evaluation(
            trainer,
            loader,
            datastore,
            run_dir,
            logger=logger,
            split=args.eval,
            n_example_pred=args.n_example_pred,
            create_gif=args.create_gif,
            metrics_watch=args.metrics_watch,
            var_leads_metrics_watch=var_leads,
        )
        trainer.write_spans()
        if is_rank_zero:
            print(json.dumps(metrics, indent=2))
        logger.finish()
        return

    # Validation unrolls ar_steps_eval steps, like the reference DataModule
    # (reference: weather_dataset.py:710-726).
    train_loader = make_loader("train", args.ar_steps_train, shuffle=True)
    val_loader = make_loader("val", args.ar_steps_eval, shuffle=False)
    history_path = run_dir / "history.jsonl"

    def log_fn(record):
        if is_rank_zero:
            with open(history_path, "a", encoding="utf-8") as f:
                f.write(json.dumps(record) + "\n")
            print(json.dumps(record))
            logger.log_metrics(record, step=record["epoch"])
        # every rank saves: the optimizer's state is gathered, rank 0 writes
        ckpt.save_latest(predictor, trainer.optimizer, record["epoch"], hparams)
        if "val_loss" in record:
            ckpt.maybe_save_best(
                record["val_loss"], predictor, trainer.optimizer, record["epoch"],
                hparams,
            )

    # Preemption-signal rescue (SURVEY.md 5.3): a SIGTERM from the
    # scheduler drains the current epoch and writes the latest checkpoint
    # below before the process exits. The handlers are put back on
    # return: their closure holds the trainer, which a caller in the same
    # process would otherwise keep alive with its model, optimizer and
    # captured graphs.
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGUSR1)}
    trainer.install_preemption_handler()
    try:
        # Run epoch-by-epoch so checkpoints always see the current state
        for epoch in range(start_epoch, args.epochs):
            history = trainer.fit(
                train_loader,
                val_loader if (epoch + 1) % args.val_interval == 0 else None,
                epochs=1,
                start_epoch=epoch,
            )
            record = dict(history[0])
            record["epoch"] = epoch
            log_fn(record)
            if trainer.preempt_event.is_set():
                if is_rank_zero:
                    print(
                        "preemption signal received: latest checkpoint saved, "
                        "exiting (resume with --load <run_dir> --restore_opt)"
                    )
                break
    finally:
        for s, handler in handlers.items():
            signal.signal(s, handler)
    logger.finish()


if __name__ == "__main__":
    main()
