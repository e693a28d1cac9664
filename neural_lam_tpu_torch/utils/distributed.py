"""Process groups for data-parallel training, one process per GPU.

The port's counterpart of what the JAX package takes from
``jax.distributed`` (``initialize``, ``process_index``/``process_count``)
and ``multihost_utils`` (``process_allgather``, ``sync_global_devices``).
The JAX package runs one process per host over all of its devices; the
port runs one process per GPU, as ``torchrun`` starts them, so a "host"
of the JAX package is a node here, holding ``local_world`` ranks:

- :func:`launch_layout` reads the launch from ``torchrun``'s environment
  (``WORLD_SIZE``, ``RANK``, ``LOCAL_WORLD_SIZE``, ``LOCAL_RANK``,
  ``GROUP_RANK``), :func:`init_from_env` joins its process group and
  :func:`layout` answers for the group joined, from the group and the
  launch's node count;
- :func:`barrier`, :func:`allgather_sums` (float64 host sums, one row per
  rank), :func:`any_flag`, :func:`broadcast_` and :func:`all_reduce_`
  are the collectives the trainer, the checkpoints and the statistics
  need; :func:`spatial_group`, :func:`all_to_all_`,
  :func:`all_gather_into_` and :func:`reduce_scatter_` (over a group of
  ranks) those of spatial partitioning (``parallel/spatial.py``).

Without a process group every function answers for one process and does
nothing, exactly as the port ran before data parallelism. An NCCL group
takes the tensors where they are (on the rank's GPU); any other backend
(gloo) gets CPU copies of CUDA tensors, so that the same calls run over
gloo on a card.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a process sits: ``rank`` of ``world``, on node
    ``rank // local_world`` of ``world // local_world``, local rank
    ``local_rank`` of that node's ``local_world``."""

    rank: int = 0
    world: int = 1
    local_rank: int = 0
    local_world: int = 1

    @property
    def node(self) -> int:
        return self.rank // self.local_world

    @property
    def nodes(self) -> int:
        return self.world // self.local_world


def active() -> bool:
    """Whether a process group is initialised."""
    return dist.is_available() and dist.is_initialized()


def launch_layout() -> Layout:
    """The layout ``torchrun``'s environment describes (one process, rank 0
    of 1, without it)."""
    env = os.environ
    world = int(env.get("WORLD_SIZE", 1))
    rank = int(env.get("RANK", 0))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    local_rank = int(env.get("LOCAL_RANK", rank % local_world))
    if world % local_world:
        raise ValueError(f"WORLD_SIZE {world} is not a multiple of LOCAL_WORLD_SIZE "
                         f"{local_world}")
    node = int(env.get("GROUP_RANK", rank // local_world))
    return Layout(node * local_world + local_rank, world, local_rank, local_world)


def layout() -> Layout:
    """The layout of the group this process joined (one process without
    a group): its ranks spread evenly over the launch's nodes, node-major,
    as :func:`init_from_env` numbers them."""
    if not active():
        return Layout()
    rank, world = dist.get_rank(), dist.get_world_size()
    nodes = launch_layout().nodes
    local_world = world // nodes if world % nodes == 0 else world
    return Layout(rank, world, rank % local_world, local_world)


def init_from_env(backend: str, devices: Optional[int] = None) -> bool:
    """Join the process group of ``torchrun``'s environment (``env://``:
    ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), the
    counterpart of ``jax.distributed.initialize()``. ``devices`` caps the
    ranks per node (the CLI's ``--devices``): the first ``devices`` local
    ranks of every node form the group, renumbered, and a rank beyond the
    cap joins nothing and gets False back."""
    missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
               if k not in os.environ]
    if missing:
        raise SystemExit(
            f"no process group to join: {', '.join(missing)} not set (launch with "
            "torchrun, which sets them)"
        )
    launched = launch_layout()
    local_world = launched.local_world
    if devices is not None:
        if launched.local_rank >= devices:
            return False
        local_world = devices
    dist.init_process_group(backend, init_method="env://",
                            world_size=launched.nodes * local_world,
                            rank=launched.node * local_world + launched.local_rank)
    return True


def destroy() -> None:
    """Leave the process group, if any."""
    _SPATIAL_GROUPS.clear()
    if active():
        dist.destroy_process_group()


def rank() -> int:
    return layout().rank


def world_size() -> int:
    return layout().world


def is_nccl() -> bool:
    return active() and dist.get_backend() == "nccl"


def _collective_device() -> torch.device:
    return torch.device("cuda", torch.cuda.current_device()) if is_nccl() else torch.device("cpu")


def barrier() -> None:
    """Wait until every rank gets here (``sync_global_devices``)."""
    if active():
        dist.barrier()


def _staged(fn, *tensors: torch.Tensor) -> None:
    """Run the collective ``fn`` on ``tensors`` in place: as they are on
    NCCL or on the CPU, else on CPU copies written back."""
    if is_nccl() or all(t.device.type == "cpu" for t in tensors):
        fn(*tensors)
        return
    host = [t.detach().cpu() for t in tensors]
    fn(*host)
    for t, h in zip(tensors, host):
        t.copy_(h)


def all_reduce_(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``tensor`` over the ranks (of ``group``, default all), in
    place."""
    if active():
        _staged(lambda t: dist.all_reduce(t, group=group), tensor)
    return tensor


def broadcast_(tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``tensor`` on every rank, in place."""
    if active():
        _staged(lambda t: dist.broadcast(t, src), tensor)
    return tensor


def group_size(group=None) -> int:
    """The ranks in ``group`` (default all; 1 without a process group)."""
    return dist.get_world_size(group) if active() else 1


def all_gather_into_(out: torch.Tensor, part: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``part`` (of ``group``, default all) concatenated in
    rank order into ``out`` (the group's size times ``part``'s size), which
    covers every entry of ``out``."""
    size = group_size(group)
    if out.numel() != part.numel() * size:
        raise ValueError(f"all_gather: {out.numel()} entries for {size} parts "
                         f"of {part.numel()}")
    if not active():
        out.copy_(part.reshape(out.shape))
        return out
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    _staged(lambda o, p: gather(o, p, group=group), out, part)
    return out


def reduce_scatter_(out: torch.Tensor, full: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the ranks of ``group`` of their ``full``, cut into
    as many parts along the first axis: this rank's part, into ``out``
    (the transpose of :func:`all_gather_into_`)."""
    if not active():
        out.copy_(full.reshape(out.shape))
        return out
    scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    _staged(lambda o, f: scatter(o, f, group=group), out, full)
    return out


def all_to_all_(out: torch.Tensor, inp: torch.Tensor, out_splits: list[int],
                in_splits: list[int], group=None) -> torch.Tensor:
    """One all-to-all over ``group``: ``inp``'s first ``in_splits[q]``
    rows (then the next ...) go to rank ``q`` of the group, and ``out``
    receives ``out_splits[t]`` rows from each rank ``t``, in rank order."""
    if active():
        _staged(lambda o, i: dist.all_to_all_single(
            o, i, output_split_sizes=out_splits, input_split_sizes=in_splits, group=group),
            out, inp)
    else:
        out.copy_(inp)
    return out


def spatial_group(shards: int):
    """This rank's spatial group: ranks ``d * shards`` to ``d * shards +
    shards - 1`` for data index ``d = rank // shards``, as the JAX package
    reshapes its devices into a ``(data, spatial)`` mesh
    (``neural_lam_tpu/train_model.py:465-477``). Every rank makes every
    group, in the same order, as ``torch.distributed.new_group`` asks, once
    per process group joined (later calls return the same group);
    ``None`` (the default group) when the groups are the whole world or
    there is no process group."""
    world = world_size()
    if world % shards:
        raise ValueError(f"{shards} spatial shards do not divide the {world} ranks")
    if not active() or shards == world:
        return None
    if shards not in _SPATIAL_GROUPS:  # made once per group joined
        groups = [dist.new_group(list(range(d * shards, (d + 1) * shards)))
                  for d in range(world // shards)]
        _SPATIAL_GROUPS[shards] = groups[rank() // shards]
    return _SPATIAL_GROUPS[shards]


_SPATIAL_GROUPS: dict = {}


def allgather_sums(values: np.ndarray) -> np.ndarray:
    """``process_allgather`` of a float64 vector: ``(world, n)``, row ``r``
    rank ``r``'s ``values``, the same on every rank."""
    values = np.asarray(values, np.float64).ravel()
    if not active():
        return values[None]
    part = torch.from_numpy(values).to(_collective_device())
    out = torch.empty(world_size() * values.size, dtype=torch.float64, device=part.device)
    all_gather_into_(out, part)
    return out.cpu().numpy().reshape(world_size(), values.size)


def any_flag(flag: bool) -> bool:
    """Whether ``flag`` is set on any rank (one collective)."""
    if not active():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())
