"""Training loop: counterpart of ``neural_lam_tpu/trainer.py``.

- batch standardization on the device (reference: module.py:307-337),
- loss = ``mean(loss_fn(pred, target, pred_std, mask=interior))``
  (reference: module.py:361-386),
- ``per_var_std = diff_std / sqrt(feature_weights)`` when the model has
  no std head (reference: module.py:142-163),
- AdamW with betas (0.9, 0.95) (reference: module.py:275-287),
- the step as one CUDA graph (:meth:`Trainer.make_train_step`), the
  port's counterpart of the JAX step's one jitted executable; with
  ``scan_steps=k``, ``k`` steps in one graph, as ``lax.scan`` makes them
  one executable,
- the loop around it: :meth:`Trainer.device_prefetch` (host-to-device
  copies on a side stream, ahead of the step), :meth:`Trainer.evaluate`
  with the watched-metric promotion (reference: module.py:806-817), the
  preemption handler and :meth:`Trainer.fit`.

The trainer holds the ``nn.Module`` and the optimizer and updates both
in place; ``checkpoint.CheckpointManager`` saves and restores them.

Data parallelism (the JAX package's ``Mesh`` data axis) runs one process
per GPU in a ``torch.distributed`` process group (``utils/distributed.py``),
each rank on its own block of the global batch. Over a group the
optimizer is :class:`~.optim.FlatAdamW`: the step all-reduces the
gradients (and the loss) as one flat buffer, inside the captured graph,
and with ``shard_opt_state`` (ZeRO-1, on by default as in the JAX
package) each rank keeps ``1/P`` of AdamW's moments and all-gathers the
updated parameters. ``flat_opt`` is the same optimizer without a group.
The preemption flag is agreed every ``preempt_check_every`` steps and at
each epoch's end, and ``evaluate`` merges the ranks' sums once per pass.
Without a group the trainer runs as before: ``torch.optim.AdamW`` over
the parameters, and the multi-host merges are the identity.

Spatial partitioning (``spatial_shards=S``, the JAX trainer's ``spatial``
mesh axis, ``neural_lam_tpu/trainer.py:172-186``) runs the model through
``parallel.spatial.ShardedModel``: rank ``r`` is data index ``r // S`` and
shard ``r % S``, as the JAX package reshapes its devices into a ``(data,
spatial)`` mesh; the ranks of one spatial group take the same batch
block, each its own slab of the grid (``device_put_batch``; a step takes
whole-grid arrays or this shard's slab). A rank's loss is its shard's part
(the interior sum over the global interior count), whose backward sends
the halo gradients home through the exchanges; the flat all-reduce then
sums the gradients and the loss over every rank and divides by the data
rank count ``D``, so every rank holds the gradient of the mean over the
global batch. ZeRO-1 and ``flat_opt`` shard over the whole world. The eval
step sums its metrics over the spatial group inside the step, and the
test evaluation gathers the per-node maps and the plotted forecasts.

Mixed precision (``TrainingArgs.precision="bf16"``, with a model built
with ``compute_dtype=torch.bfloat16``) is the JAX package's
(``neural_lam_tpu/trainer.py:427-448``): the parameters and AdamW's state
stay float32, and the loss runs the model on bf16 copies of the
parameters made inside the step, under autograd, so that the gradients
land on the float32 parameters. The eval step passes the float32
parameters themselves, as the JAX eval step does (``:532-560``): the
model's bf16 inputs and static features promote to float32 at their first
product.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import queue
import threading
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from .config import NeuralLAMConfig
from .datastore.base import BaseDatastore
from .loss_weighting import get_state_feature_weighting
from .metrics import get_metric
from .models.forecaster import ARForecaster
from .ops.fused_kernels import route_env
from .optim import FlatAdamW
from .utils import distributed, trace
from .utils.cuda_graph import CapturedFunction
from .utils.device import resolve_device

# Eager steps run before a capture, and undone after it (see
# ``Trainer.make_train_step``)
GRAPH_WARMUP_STEPS = 2


@dataclasses.dataclass
class TrainingArgs:
    """Training hyperparameters: the fields of the JAX package's
    ``TrainingArgs`` that the port reads (reference:
    neural_lam/train_model.py:208-262)."""

    lr: float = 1e-3
    # AdamW decoupled weight decay: the reference's
    # ``torch.optim.AdamW(params, lr=..., betas=(0.9, 0.95))``
    # (reference: models/module.py:284-287) inherits torch's default 0.01
    weight_decay: float = 0.01
    epochs: int = 200
    batch_size: int = 4
    ar_steps_train: int = 1
    # the validation rollout's length, for the loaders the caller builds
    ar_steps_eval: int = 10
    loss: str = "wmse"
    val_interval: int = 1
    val_steps_to_log: tuple[int, ...] = (1, 2, 3, 5, 10)
    # Watched (metric, variable, lead-time) scalars in every validation
    # record, keys like ``val_rmse_<var>_step<k>`` (reference:
    # models/module.py:806-817)
    metrics_watch: tuple[str, ...] = ()
    var_leads_metrics_watch: Optional[dict] = None
    # "32" (reference default) or "bf16": float32 parameters, bf16 compute
    precision: str = "32"
    # torch.profiler trace of steps [2, 2 + profile_steps) of the first
    # epoch, written to <profile_dir>/trace.json; the spans' snapshot to
    # <profile_dir>/trace_spans.json (write_spans)
    profile_dir: Optional[str] = None
    profile_steps: int = 5
    # ZeRO-1 over a process group: each rank keeps 1/P of AdamW's moments
    # (neural_lam_tpu/trainer.py:69-72); the numbers do not change
    shard_opt_state: bool = True
    # AdamW over one flat parameter buffer, the counterpart of
    # optax.flatten (neural_lam_tpu/trainer.py:73-82): the optimizer state
    # is one vector, so a checkpoint restores with the same setting
    flat_opt: bool = False
    # over a process group, the preemption flag is agreed every k steps
    # (and at each epoch's end); 0: at the epoch's end only
    preempt_check_every: int = 50


def make_optimizer(
    params, lr: float, weight_decay: float = 0.01, flat_opt: bool = False,
    shard_opt_state: bool = True, grad_divisor: Optional[int] = None,
) -> torch.optim.Optimizer | FlatAdamW:
    """The training optimizer: AdamW matching the reference recipe,
    ``torch.optim.AdamW(params, lr=..., betas=(0.9, 0.95))`` (reference:
    models/module.py:284-287), the same update as the JAX package's
    ``optax.adamw(lr, b1=0.9, b2=0.95, weight_decay=...)``.

    With ``flat_opt``, or over a process group, it is a
    :class:`~.optim.FlatAdamW` over the parameters, which then live in its
    flat buffer (sharded over the ranks with ``shard_opt_state``; state
    saved per parameter unless ``flat_opt``; the summed gradients divided
    by ``grad_divisor``, default the rank count); otherwise
    ``torch.optim.AdamW`` over them.

    Over CUDA parameters it is built ``capturable=True``, so that its
    update can be captured in a CUDA graph (:meth:`Trainer.make_train_step`):
    the step count lives on the device and the bias corrections are
    computed there in float32, where the default computes them on the
    host in Python doubles. The updates differ by float32 rounding only."""
    params = list(params)
    if flat_opt or distributed.active():
        return FlatAdamW(params, lr, weight_decay, flat_layout=flat_opt,
                         shard=shard_opt_state, grad_divisor=grad_divisor)
    return torch.optim.AdamW(
        params, lr=lr, betas=(0.9, 0.95), eps=1e-8, weight_decay=weight_decay,
        capturable=any(p.device.type == "cuda" for p in params),
    )


def standardization_stats(datastore: BaseDatastore) -> dict[str, np.ndarray]:
    """State and forcing mean/std, stds clamped away from zero
    (reference: module.py:289-305)."""
    eps = np.finfo(np.float32).eps
    stats = datastore.get_standardization_dataarray(category="state")
    if datastore.get_num_data_vars("forcing") > 0:
        f_stats = datastore.get_standardization_dataarray(category="forcing")
    else:
        f_stats = {}
    return {
        "state_mean": np.asarray(stats["state_mean"], np.float32),
        "state_std": np.maximum(np.asarray(stats["state_std"], np.float32), eps),
        "forcing_mean": np.asarray(f_stats.get("forcing_mean", np.zeros(0)), np.float32),
        "forcing_std": np.maximum(
            np.asarray(f_stats.get("forcing_std", np.ones(0)), np.float32), eps
        ),
    }


def device_stats(
    stats: dict[str, np.ndarray], forcing_width: int, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(state_mean, state_std, forcing_mean, forcing_std)`` on
    ``device``, the forcing stats repeated per window position,
    feature-major, to ``forcing_width`` (reference: module.py:307-337);
    without forcing the last two are a no-op mean 0 and std 1."""
    n_f = stats["forcing_mean"].shape[-1]
    if forcing_width > 0 and n_f > 0:
        window = forcing_width // n_f
        f_mean = np.repeat(stats["forcing_mean"], window)
        f_std = np.repeat(stats["forcing_std"], window)
    else:
        f_mean = np.zeros(forcing_width, np.float32)
        f_std = np.ones(forcing_width, np.float32)
    return tuple(
        torch.as_tensor(a, device=device)
        for a in (stats["state_mean"], stats["state_std"], f_mean, f_std)
    )


def standardize_batch(
    init_states: torch.Tensor,
    target_states: torch.Tensor,
    forcing: torch.Tensor,
    stats: dict[str, np.ndarray] | tuple[torch.Tensor, ...],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Standardize state and windowed forcing on their device. ``stats``
    is the dictionary of :func:`standardization_stats`, or the tensors
    :func:`device_stats` made of it once, which saves a loop four small
    copies to the device per batch."""
    if isinstance(stats, dict):
        stats = device_stats(stats, forcing.shape[-1], init_states.device)
    mean, std, f_mean, f_std = stats
    init_states = (init_states - mean) / std
    target_states = (target_states - mean) / std
    if forcing.shape[-1] > 0:
        forcing = (forcing - f_mean) / f_std
    return init_states, target_states, forcing


@dataclasses.dataclass
class CapturedStep:
    """One captured training step (``k`` of them with ``scan_steps``):
    the graph, the static inputs it reads, and the loss and the
    parameters' gradients it writes."""

    graph: "torch.cuda.CUDAGraph"
    inputs: tuple[torch.Tensor, ...]
    loss: torch.Tensor
    grads: list[Optional[torch.Tensor]]


class Trainer:
    """The training loop around an :class:`ARForecaster`.

    The trainer runs on ``device``: ``"cuda"`` unless the caller asks
    for ``"cpu"``, and the forecaster's parameters must live there.
    ``train_step`` is one eager optimizer step; ``make_train_step`` the
    captured one that ``fit`` drives. With ``debug_nans`` ``fit`` reads
    every step's loss on the host and raises ``FloatingPointError`` at the
    first that is not finite (the CLI's ``--debug_nans``; it waits for the
    device every step).
    """

    def __init__(
        self,
        forecaster: ARForecaster,
        config: NeuralLAMConfig,
        datastore: BaseDatastore,
        args: TrainingArgs,
        device: str | torch.device = "cuda",
        debug_nans: bool = False,
        spatial_shards: Optional[int] = None,
    ) -> None:
        if args.precision not in ("32", "bf16"):
            raise ValueError(f"precision {args.precision!r}: '32' or 'bf16'")
        self.device = resolve_device(device)
        param_device = next(forecaster.parameters()).device
        if param_device.type != self.device.type or (
            self.device.index is not None
            and param_device.index != self.device.index
        ):
            raise ValueError(
                f"forecaster on {param_device}, trainer on {self.device}"
            )
        self.forecaster = forecaster
        self.args = args
        self.datastore = datastore
        self.debug_nans = debug_nans

        # Interior mask (reference: module.py:129-140): the host bool array,
        # and a copy on the device so that a step moves nothing across.
        boundary = np.asarray(datastore.boundary_mask.data) > 0.5
        self.interior_mask_bool = ~boundary
        self._interior_mask = torch.from_numpy(self.interior_mask_bool).to(self.device)

        # per_var_std substitute when the model has no std head
        # (reference: module.py:142-163).
        if not forecaster.predicts_std:
            stats = datastore.get_standardization_dataarray(category="state")
            weights = get_state_feature_weighting(config, datastore)
            diff_std = np.asarray(stats["state_diff_std_standardized"], np.float32)
            self.per_var_std = torch.from_numpy(diff_std / np.sqrt(weights)).to(
                self.device
            )
        else:
            self.per_var_std = None

        self.stats = standardization_stats(datastore)
        self._device_stats: dict[int, tuple[torch.Tensor, ...]] = {}
        self.loss_fn = get_metric(args.loss)

        # spatial partitioning: this rank's shard of the model
        self.spatial = None
        self.data_shards = distributed.world_size()
        self.data_index = distributed.rank()
        self._local_fc = forecaster
        if spatial_shards is not None:
            from .parallel.spatial import ShardedModel

            world = distributed.world_size()
            if spatial_shards < 1 or world % spatial_shards:
                raise ValueError(f"--spatial_shards {spatial_shards} does not divide the "
                                 f"device count {world}")
            self.spatial = ShardedModel(forecaster.predictor, datastore, spatial_shards,
                                        group=distributed.spatial_group(spatial_shards))
            self.data_shards = world // spatial_shards
            self.data_index = distributed.rank() // spatial_shards
            self._local_fc = self.spatial.local_forecaster(forecaster)
        self.optimizer = self.init_state()

        # captured steps by (scan_steps, route, input shapes), the state
        # they were captured on, and the memory pool and stream they share
        self.graphs: dict[tuple, CapturedStep] = {}
        self._graph_state: Optional[tuple] = None
        self._graph_pool = None
        self._graph_stream: Optional[torch.cuda.Stream] = None
        self._train_step: Optional[Callable] = None
        # the eval steps by pred_steps (CUDA graphs on the card)
        self.eval_steps: dict[int, CapturedFunction] = {}
        self._warned_padded_train = False
        self._warned_watch = False
        # Set by the preemption handler's signal (SLURM's SIGTERM); fit()
        # stops after the current step so that the caller can save
        # (SURVEY.md 5.3; reference: train_model.py:500-516)
        self.preempt_event = threading.Event()

    def init_state(self) -> torch.optim.Optimizer | FlatAdamW:
        """A fresh AdamW (zero moments, step 0) over the forecaster's
        parameters (:func:`make_optimizer`); the steps use the one in
        ``self.optimizer``. Over a process group every rank must call it."""
        return make_optimizer(
            self.forecaster.parameters(), self.args.lr, self.args.weight_decay,
            flat_opt=self.args.flat_opt, shard_opt_state=self.args.shard_opt_state,
            grad_divisor=self.data_shards,
        )

    def install_preemption_handler(self, signals=None) -> None:
        """Install SIGTERM/SIGUSR1 handlers that request a graceful stop:
        ``fit`` returns after the current step, its last record marked
        ``preempted``. Over a process group the ranks agree on the flag
        every ``preempt_check_every`` steps and at each epoch's end
        (:meth:`_sync_preempt_flag`), so that all of them stop at the same
        step: a rank that left alone would leave its peers waiting in a
        collective."""
        import signal as signal_mod

        if signals is None:
            signals = (signal_mod.SIGTERM, signal_mod.SIGUSR1)

        def handler(signum, frame):
            self.preempt_event.set()

        for s in signals:
            signal_mod.signal(s, handler)

    def _sync_preempt_flag(self) -> bool:
        """Over more than one rank, whether any rank was signalled (one
        collective), which then sets the local flag too; returns the flag
        (``neural_lam_tpu/trainer.py:277-291``)."""
        if distributed.world_size() > 1 and distributed.any_flag(self.preempt_event.is_set()):
            self.preempt_event.set()
        return self.preempt_event.is_set()

    # -- batches -----------------------------------------------------------
    def _to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32).to(self.device)

    def device_put_batch(self, batch: tuple) -> tuple[tuple, int]:
        """Move a host batch ``(init, target, forcing, ...)`` to the
        device: returns ``((init, target, forcing), real)``.

        A batch of fewer than ``batch_size`` samples (an eval tail) is
        padded to ``batch_size`` by repeating its last sample, so that
        every step has one shape and one captured graph; ``real`` is the
        count before padding, by which ``evaluate`` drops the padded rows
        (the JAX package pads to its mesh the same way,
        ``neural_lam_tpu/trainer.py:323-360``). Over a process group a
        rank's batch is its block of the node's batch, padded by the
        loader as the JAX package pads a host's batch to its devices
        (``loader.Block``, whose ``real`` is used), and nothing is added.
        Under spatial partitioning only this shard's slab of the grid axis
        is copied. On CUDA the arrays are pinned and copied without
        blocking, on the current stream."""
        real = int(np.asarray(batch[0]).shape[0])
        if distributed.active():
            real, pad = getattr(batch, "real", real), 0
        else:
            pad = max(self.args.batch_size - real, 0)
        out = []
        for a in batch[:3]:
            a = np.asarray(a)
            if self.spatial is not None:
                a = self.spatial.grid_slab(a)
            t = torch.as_tensor(a, dtype=torch.float32)
            if pad:
                t = torch.cat([t, t[-1:].expand(pad, *t.shape[1:])])
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out.append(t)
        return tuple(out), real

    def device_prefetch(self, loader, depth: int = 2):
        """Iterate ``(device_batch, real)`` with the copies of the next
        ``depth`` batches under way while the current step runs.

        A producer thread pins each host batch and copies it to the
        device on a side stream, then records an event; the consumer's
        stream waits for the event before the batch is read, so the
        step's copy into its graph inputs is ordered after both the
        transfer and the previous replay. Abandoning the generator (a
        preemption, a step that raises) stops and joins the producer."""
        q: queue.Queue = queue.Queue(maxsize=depth)
        sentinel = object()
        stop = threading.Event()
        err: list[BaseException] = []
        cuda = self.device.type == "cuda"
        copy_stream = torch.cuda.Stream(self.device) if cuda else None

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with torch.cuda.stream(copy_stream) if cuda else contextlib.nullcontext():
                    for batch in loader:
                        if stop.is_set():
                            return
                        device_batch, real = self.device_put_batch(batch)
                        event = None
                        if cuda:
                            event = torch.cuda.Event()
                            event.record(copy_stream)
                        if not put((device_batch, real, event)):
                            return
            except BaseException as e:
                err.append(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=producer, daemon=True, name="neural-lam-prefetch")
        t.start()
        try:
            while True:
                # time blocked on the input pipeline: when it grows, the
                # epoch's grid_points_per_s stops measuring the device
                with trace.span("fit.input_wait"):
                    item = q.get()
                if item is sentinel:
                    break
                device_batch, real, event = item
                if event is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(event)
                    for a in device_batch:  # made on the copy stream
                        a.record_stream(stream)
                yield device_batch, real
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=10.0)
        if err:
            raise err[0]

    # -- steps -------------------------------------------------------------
    def _local_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Under spatial partitioning, this shard's slab of a batch array
        given for the whole grid (or already cut to the slab)."""
        sp = self.spatial
        if sp is None or t.shape[-2] == sp.n_grid_local:
            return t
        if t.shape[-2] != sp.n_grid:
            raise ValueError(f"{t.shape[-2]} grid rows: want {sp.n_grid} (the grid) or "
                             f"{sp.n_grid_local} (this shard's slab)")
        return sp.slab(t, sp.n_grid_local, axis=-2)

    def _standardize(self, init_states, target_states, forcing):
        init_states, target_states, forcing = (
            self._local_rows(self._to_device(a)) for a in (init_states, target_states, forcing))
        width = forcing.shape[-1]
        if width not in self._device_stats:
            self._device_stats[width] = device_stats(self.stats, width, self.device)
        return standardize_batch(
            self._to_device(init_states),
            self._to_device(target_states),
            forcing,
            self._device_stats[width],
        )

    def _loss(self, init_states, target_states, forcing) -> torch.Tensor:
        """Scalar training loss of one batch ``(B, 2, N, d)``,
        ``(B, T, N, d)``, ``(B, T, N, f)`` in physical units."""
        with trace.span("forward"):
            init_states, target_states, forcing = self._standardize(
                init_states, target_states, forcing
            )
            params = None
            if self.args.precision == "bf16":
                # float32 master parameters; bf16 compute copies inside the step
                params = {
                    name: p.to(torch.bfloat16)
                    for name, p in self.forecaster.predictor.named_parameters()
                }
            prediction, pred_std = self._local_fc(
                init_states, forcing, target_states, params=params
            )
        with trace.span("loss"):
            prediction = prediction.float()
            if pred_std is None:
                pred_std = self.per_var_std
            return torch.mean(
                self.masked_metric(self.args.loss, prediction, target_states, pred_std)
            )

    def masked_metric(self, name: str, prediction, target, pred_std,
                      sum_vars: bool = True) -> torch.Tensor:
        """The interior-masked grid mean of metric ``name`` per (sample,
        step) (per variable too without ``sum_vars``); under spatial
        partitioning this shard's part of it, which
        :meth:`_spatial_sum` adds up over the spatial group."""
        if self.spatial is not None:
            return self.spatial.masked_metric(name, prediction, target, pred_std, sum_vars)
        return get_metric(name)(prediction, target, pred_std, mask=self._interior_mask,
                                sum_vars=sum_vars)

    def _spatial_sum(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each tensor summed over the spatial group (one all-reduce of a
        flat buffer); the identity without spatial partitioning."""
        if self.spatial is None or self.spatial.n_shards == 1:
            return tensors
        flat = self.spatial.spatial_sum_(torch.cat([t.reshape(-1) for t in tensors]))
        return [part.reshape(t.shape) for part, t in
                zip(flat.split([t.numel() for t in tensors]), tensors)]

    def train_step(self, init_states, target_states, forcing) -> torch.Tensor:
        """Forward, backward and one AdamW update on one batch, eagerly;
        returns the loss before the update as a 0-d tensor on the device
        (read it with ``.item()``, which waits for the device). Over a
        process group the gradients and the loss are the means over the
        ranks (:meth:`FlatAdamW.reduce_gradients`), so every rank takes
        the same step and returns the same loss."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._loss(init_states, target_states, forcing)
        with trace.span("backward"):
            loss.backward()
            if isinstance(self.optimizer, FlatAdamW):
                loss = self.optimizer.reduce_gradients(loss)
        with trace.span("optimizer"):
            self.optimizer.step()
        return loss.detach()

    def make_train_step(self, scan_steps: Optional[int] = None) -> Callable:
        """The training step ``step(init, target, forcing) -> loss``.

        With ``scan_steps=k`` it takes batches stacked on a leading axis
        of ``k`` and runs ``k`` sequential optimizer steps, returning their
        ``(k,)`` losses, as the JAX package's step does with ``lax.scan``
        (``neural_lam_tpu/trainer.py:452-530``); a stack of another length
        raises ``ValueError``.

        On CUDA the step is a CUDA graph. The first call for an input
        shape and route runs ``GRAPH_WARMUP_STEPS`` eager steps on a side
        stream (kernel builds, launch attributes, the optimizer's state,
        the libraries' workspaces: all that happens only on a first call),
        puts the parameters and the optimizer's state back as they were,
        and captures zero-grad, ``_loss``, backward and the AdamW update
        (``k`` times with ``scan_steps``) over static input buffers. Every
        call, the first included, copies its batch into those buffers and
        replays, so the steps follow ``train_step``'s trajectory: the same
        kernels on the same values. The returned loss is a copy that later
        replays leave alone. After a call the parameters' ``.grad`` are the
        gradients of that call's (last) step, whichever graph it replayed:
        each graph keeps the gradient tensors it writes, and a replay
        points ``.grad`` at its own.

        A graph fixes the route (``fused_kernels.route_env``, read at
        capture), the hyperparameters and the addresses of the parameters
        and of the optimizer's state. Graphs are kept per input shape,
        ``scan_steps`` and route, share one memory pool, and are all
        dropped and captured again when a parameter or a tensor of the
        optimizer's state is replaced rather than updated in place (a new
        ``self.optimizer``, a restored optimizer state) or a
        hyperparameter changes. Parameters loaded with ``load_state_dict``
        are copied in place and keep them valid. A capture that fails
        raises: there is no eager fallback.

        Over a process group the graph holds the step's collectives
        (NCCL captures them once its communicator exists, which the
        warm-up steps' collectives create); a CUDA step over any other
        backend raises, since gloo's collectives cannot be captured:
        ``train_step`` is the eager step there.

        On CPU tensors the step is ``train_step``, looped ``k`` times with
        ``scan_steps``."""
        if self.device.type == "cuda" and distributed.active() and not distributed.is_nccl():
            raise RuntimeError(
                "the captured training step needs an NCCL process group on CUDA "
                "(gloo's collectives cannot be captured); use Trainer.train_step "
                "for eager steps"
            )
        if self.device.type != "cuda" and not scan_steps:
            return self.train_step

        def step(init, target, forcing):
            if scan_steps and len(init) != scan_steps:
                raise ValueError(
                    f"scan_steps={scan_steps}, but the batches are stacked "
                    f"{len(init)} deep"
                )
            if self.device.type != "cuda":
                return torch.stack(
                    [self.train_step(*b) for b in zip(init, target, forcing)]
                )
            return self._replay(bool(scan_steps), (init, target, forcing))

        return step

    def _state_tensors(self) -> tuple[list[torch.Tensor], dict[tuple, torch.Tensor]]:
        """What a step updates in place: the forecaster's parameters (the
        optimizer's, or views of its flat buffer), and the optimizer's
        state tensors by ``(id(param), name)``."""
        params = list(self.forecaster.parameters())
        state = {
            (id(p), name): t
            for g in self.optimizer.param_groups
            for p in g["params"]
            for name, t in self.optimizer.state.get(p, {}).items()
            if torch.is_tensor(t)
        }
        return params, state

    def _graph_fingerprint(self) -> tuple:
        params, state = self._state_tensors()
        hyper = tuple(
            (g["lr"], g["betas"], g["eps"], g["weight_decay"])
            for g in self.optimizer.param_groups
        )
        return (
            id(self.optimizer),
            tuple(p.data_ptr() for p in params),
            tuple(t.data_ptr() for t in state.values()),
            hyper,
        )

    def _replay(self, scanned: bool, batch: tuple) -> torch.Tensor:
        with trace.span("train_step"):
            with trace.span(".check"):
                if self._graph_fingerprint() != self._graph_state:
                    if self.graphs:
                        trace.count("train_step.recaptures", len(self.graphs))
                    self.graphs.clear()
                key = (scanned, route_env(), tuple(tuple(a.shape) for a in batch))
                entry = self.graphs.get(key)
            with trace.span(".inputs"):
                trace.call_start("train_step", self.device)
                batch = tuple(self._to_device(a) for a in batch)
                if entry is not None:
                    for static, a in zip(entry.inputs, batch):
                        static.copy_(a)
            if entry is None:
                with trace.span(".capture"):
                    entry = self.graphs[key] = self._capture(scanned, batch)
                    self._graph_state = self._graph_fingerprint()
                    with trace.span(".first_launch"):
                        for static, a in zip(entry.inputs, batch):
                            static.copy_(a)
                        entry.graph.replay()
            else:
                with trace.span(".launch"):
                    entry.graph.replay()
            with trace.span(".grads"):
                for p, grad in zip(self.forecaster.parameters(), entry.grads):
                    if p.grad is not grad:
                        p.grad = grad
            with trace.span(".loss"):
                loss = entry.loss.clone()
                trace.call_end("train_step", self.device)
            return loss

    def _capture(self, scanned: bool, batch: tuple) -> CapturedStep:
        """Warm up, restore and capture one step (or a stack of them) on
        ``batch``; see :meth:`make_train_step`."""
        if self._graph_stream is None:
            self._graph_stream = torch.cuda.Stream(self.device)
            self._graph_pool = torch.cuda.graph_pool_handle()
        stream = self._graph_stream
        inputs = tuple(a.clone() for a in batch)  # the graph's static inputs
        first = tuple(a[0] for a in inputs) if scanned else inputs
        stream.wait_stream(torch.cuda.current_stream(self.device))
        # the outer context restores the caller's stream even when the
        # capture raises (torch.cuda.graph then skips its own restore)
        with torch.cuda.stream(stream):
            params, state = self._state_tensors()
            with trace.span(".warmup"):
                saved = [p.detach().clone() for p in params]
                saved_state = {k: t.clone() for k, t in state.items()}
                for _ in range(GRAPH_WARMUP_STEPS):
                    self.train_step(*first)
                with torch.no_grad():
                    for p, v in zip(params, saved):
                        p.copy_(v)
                    # a fresh AdamW's state, created by the warm-up, is zeros
                    for k, t in self._state_tensors()[1].items():
                        if k in saved_state:
                            t.copy_(saved_state[k])
                        else:
                            t.zero_()
            graph = torch.cuda.CUDAGraph()
            # "thread_local": the prefetch thread may pin and copy while
            # this thread captures
            with torch.cuda.graph(
                graph, pool=self._graph_pool, stream=stream,
                capture_error_mode="thread_local",
            ), trace.graph_capture("train_step", stream):
                if scanned:
                    loss = torch.stack([
                        self.train_step(*(a[i] for a in inputs))
                        for i in range(inputs[0].shape[0])
                    ])
                else:
                    loss = self.train_step(*inputs)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        # the gradients the capture allocated in the pool: held here, so
        # that no later capture reuses their memory
        return CapturedStep(graph, inputs, loss, [p.grad for p in params])

    # -- evaluation ----------------------------------------------------------
    def make_eval_step(self, pred_steps: int) -> Callable:
        """The eval step: per sample the loss over the rollout and at each
        logged step, and the ``(B, T, d)`` tables of the watched metrics
        (reference: module.py:465-477; ``neural_lam_tpu/trainer.py:532-583``).

        On CUDA it is a :class:`~.utils.cuda_graph.CapturedFunction`: one
        CUDA graph per input shape and route, captured by the first call
        of that shape (after one eager call) and replayed after, and
        captured again when a parameter of the forecaster is replaced
        rather than updated in place; its outputs are clones that later
        replays leave alone. On CPU tensors it runs eagerly. Both run
        under ``torch.no_grad()``."""
        steps_to_log = [s for s in self.args.val_steps_to_log if s <= pred_steps]
        tables = self._watched_tables()

        def eval_step(init, target, forcing) -> dict[str, torch.Tensor]:
            init_s, target_s, forcing_s = self._standardize(init, target, forcing)
            prediction, pred_std = self._local_fc(init_s, forcing_s, target_s)
            if pred_std is None:
                pred_std = self.per_var_std
            # (B, pred_steps), per sample so padded rows can be dropped;
            # standardized per-(step, var) tables for the watch promotion
            # (mse and mae take no std)
            time_step_loss, *table_vals = self._spatial_sum(
                [self.masked_metric(self.args.loss, prediction, target_s, pred_std)]
                + [self.masked_metric(key, prediction, target_s, pred_std, sum_vars=False)
                   for key in tables]
            )
            out = {"loss": time_step_loss.mean(dim=-1)}
            for s in steps_to_log:
                out[f"loss_unroll{s}"] = time_step_loss[:, s - 1]
            for key, val in zip(tables, table_vals):
                out[f"{key}_table"] = val  # (B, T, d)
            return out

        return CapturedFunction(eval_step, self.forecaster, self.device,
                                eager=self._eager_inference(), name="eval_step")

    def _eager_inference(self) -> bool:
        """Whether inference runs eagerly on the card: under spatial
        partitioning over a group that is not NCCL's, whose collectives
        inside the function a CUDA graph cannot hold."""
        return self.spatial is not None and distributed.active() and not distributed.is_nccl()

    def _watched_tables(self) -> tuple[str, ...]:
        """The per-(step, var) metric tables the eval step computes for
        ``metrics_watch``: ``mse`` covers the rmse and mse watches (rmse
        is sqrt(mse) rescaled), ``mae`` and ``wmae`` their own."""
        if not self.args.metrics_watch:
            return ()
        watch = {m.split("_")[-1] for m in self.args.metrics_watch}
        tables = []
        if watch & {"rmse", "mse"} or not watch & {"mae", "wmae"}:
            # an unrecognised watch entry still warns from the mse table
            tables.append("mse")
        if "mae" in watch:
            tables.append("mae")
        if "wmae" in watch:
            tables.append("wmae")
        return tuple(tables)

    def _merge_host_sums(self, sums: dict, count: int) -> tuple[dict, int]:
        """Over more than one rank, the sums and the sample count of every
        rank added up, the same on each: one all-gather of one float64
        vector per pass (``neural_lam_tpu/trainer.py:807-834``). The
        identity on one rank or on empty sums."""
        if distributed.world_size() == 1 or not sums:
            return sums, count
        keys = sorted(sums)
        shapes = {k: np.shape(sums[k]) for k in keys}
        flat = np.concatenate(
            [np.ravel(np.asarray(sums[k], np.float64)) for k in keys]
            + [np.array([count], np.float64)]
        )
        total = distributed.allgather_sums(flat).sum(axis=0)
        merged, off = {}, 0
        for k in keys:
            size = int(np.prod(shapes[k]))
            merged[k] = total[off : off + size].reshape(shapes[k])
            off += size
        return merged, int(round(total[-1]))

    def evaluate(self, loader, prefix: str = "val") -> dict:
        """Mean eval metrics over a loader, padded tail rows dropped
        (reference metric sync: module.py:399-418), with the watched
        scalars promoted. Over a process group each rank sums its own
        rows, and one merge per pass (:meth:`_merge_host_sums`) gives
        every rank the same means."""
        sums: dict[str, np.ndarray] = {}
        count = 0
        for batch in loader:
            pred_steps = int(np.asarray(batch[1]).shape[1])
            if pred_steps not in self.eval_steps:
                self.eval_steps[pred_steps] = self.make_eval_step(pred_steps)
            device_batch, real = self.device_put_batch(batch)
            out = self.eval_steps[pred_steps](*device_batch)
            for k, v in out.items():
                rows = v[:real].cpu().numpy()
                sums[k] = sums.get(k, 0.0) + rows.sum(axis=0)
            count += real
        sums, count = self._merge_host_sums(sums, count)
        means = {k: v / max(count, 1) for k, v in sums.items()}
        tables = {
            k[: -len("_table")]: means.pop(k)
            for k in [k for k in means if k.endswith("_table")]
        }
        result = {f"{prefix}_{k}": float(v) for k, v in means.items()}
        if tables:
            result.update(self._promote_watched_metrics(tables, prefix))
        return result

    def _promote_watched_metrics(self, tables: dict, prefix: str) -> dict:
        """Per-epoch (metric, variable, lead) scalars from the standardized
        per-(step, var) tables: rmse and mae in physical units (rescaled
        by the state std, rmse = sqrt(mse)), mse standardized, wmae as
        computed (reference: models/module.py:806-817)."""
        out: dict = {}
        watch = {m.split("_")[-1] for m in self.args.metrics_watch}
        unsupported = watch - {"rmse", "mse", "mae", "wmae"}
        if unsupported and not self._warned_watch:
            self._warned_watch = True
            warnings.warn(
                f"metrics_watch entries {sorted(unsupported)} are not "
                "promoted per epoch: only rmse/mse/mae/wmae scalars are "
                "derived from the per-(step, var) metric tables.",
                stacklevel=2,
            )
        var_names = list(self.datastore.get_vars_names("state"))
        state_std = self.stats["state_std"]
        promoted: dict[str, np.ndarray] = {}
        if "mse" in tables:
            if "rmse" in watch:
                promoted["rmse"] = np.sqrt(tables["mse"]) * state_std
            if "mse" in watch:
                promoted["mse"] = tables["mse"]
        if "mae" in tables and "mae" in watch:
            promoted["mae"] = tables["mae"] * state_std
        if "wmae" in tables and "wmae" in watch:
            promoted["wmae"] = tables["wmae"]
        for var, leads in (self.args.var_leads_metrics_watch or {}).items():
            if var not in var_names:
                continue
            vi = var_names.index(var)
            for lead in leads:
                for name, table in promoted.items():
                    if lead <= table.shape[0]:
                        out[f"{prefix}_{name}_{var}_step{lead}"] = float(table[lead - 1, vi])
        return out

    # -- the loop ------------------------------------------------------------
    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(self.args.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.args.profile_dir, "trace.json"))

    def write_spans(self) -> None:
        """With ``profile_dir``, write the snapshot of the program's spans
        and counters (``utils.trace``) to ``<profile_dir>/trace_spans.json``:
        ``fit`` after each epoch and its validation, the CLI after
        ``--eval``."""
        if not self.args.profile_dir:
            return
        os.makedirs(self.args.profile_dir, exist_ok=True)
        with open(os.path.join(self.args.profile_dir, "trace_spans.json"), "w",
                  encoding="utf-8") as f:
            json.dump(trace.snapshot(), f)

    def fit(
        self,
        train_loader,
        val_loader=None,
        epochs: Optional[int] = None,
        log_fn: Optional[Callable[[dict], None]] = None,
        start_epoch: int = 0,
    ) -> list[dict]:
        """Train for ``epochs`` (``args.epochs`` by default) through
        ``make_train_step()``, validating every ``val_interval`` epochs;
        returns one record per epoch (``neural_lam_tpu/trainer.py:664-795``).
        The losses stay on the device until the epoch ends. Over more than
        one rank a preemption stops every rank at the same step (the first
        agreement point after the signal), and ``n_samples`` and
        ``grid_points_per_s`` count this rank's samples."""
        if self._train_step is None:
            self._train_step = self.make_train_step()
        epochs = self.args.epochs if epochs is None else epochs
        ranks = distributed.world_size()
        check_every = self.args.preempt_check_every
        history = []
        for epoch in range(start_epoch, start_epoch + epochs):
            train_loader.set_epoch(epoch)
            t0 = time.perf_counter()
            waited = trace.total_s("fit.input_wait")
            losses = []
            n_samples = 0
            profiler = None
            try:
                for step_idx, (device_batch, real) in enumerate(
                    self.device_prefetch(train_loader)
                ):
                    if real < device_batch[0].shape[0] and not self._warned_padded_train:
                        self._warned_padded_train = True
                        warnings.warn(
                            "Partial train batch padded by repeating the last "
                            "sample, which then carries extra weight in that "
                            "step's gradient. Pass drop_last=True to the train "
                            "loader to skip ragged tails instead.",
                            stacklevel=2,
                        )
                    if self.args.profile_dir and epoch == start_epoch and step_idx == 2:
                        profiler = self._start_profile()
                    losses.append(self._train_step(*device_batch))
                    n_samples += real
                    if self.debug_nans and not torch.isfinite(losses[-1]).all():
                        raise FloatingPointError(
                            f"non-finite training loss {losses[-1].tolist()} at step "
                            f"{step_idx} of epoch {epoch}"
                        )
                    if profiler is not None and step_idx == 1 + self.args.profile_steps:
                        self._stop_profile(profiler)
                        profiler = None
                    if self.preempt_event.is_set() and ranks == 1:
                        break
                    # every rank checks at the same step index, and the
                    # loaders give every rank the same number of batches
                    if (ranks > 1 and check_every > 0 and step_idx % check_every
                            == check_every - 1 and self._sync_preempt_flag()):
                        break
            finally:
                if profiler is not None:  # a short epoch: close the trace
                    self._stop_profile(profiler)
            # a signal after the epoch's last agreement point: agree once
            # more, so that no rank validates while another stops
            self._sync_preempt_flag()
            if losses:
                train_loss = float(torch.stack(losses).mean())
            else:
                # an epoch with no batch (drop_last on a tiny dataset)
                train_loss = float("nan")
            epoch_seconds = time.perf_counter() - t0
            record = {
                "epoch": epoch,
                "train_loss": train_loss,
                "epoch_seconds": epoch_seconds,
                "input_wait_seconds": round(trace.total_s("fit.input_wait") - waited, 3),
                "grid_points_per_s": (
                    n_samples
                    * self.datastore.num_grid_points
                    * self.args.ar_steps_train
                    / max(epoch_seconds, 1e-9)
                ),
            }
            if self.preempt_event.is_set():
                record["preempted"] = True
            elif val_loader is not None and (epoch + 1) % self.args.val_interval == 0:
                record.update(self.evaluate(val_loader, "val"))
            self.write_spans()
            history.append(record)
            if log_fn is not None:
                log_fn(record)
            if self.preempt_event.is_set():
                break
        return history
