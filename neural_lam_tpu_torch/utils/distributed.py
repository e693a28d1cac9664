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
  need.

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


def all_reduce_(tensor: torch.Tensor) -> torch.Tensor:
    """Sum ``tensor`` over the ranks, in place."""
    if active():
        _staged(dist.all_reduce, tensor)
    return tensor


def broadcast_(tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``tensor`` on every rank, in place."""
    if active():
        _staged(lambda t: dist.broadcast(t, src), tensor)
    return tensor


def all_gather_into_(out: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
    """Every rank's ``part`` concatenated in rank order into ``out``
    (``world`` times ``part``'s size), which covers every entry of
    ``out``."""
    if out.numel() != part.numel() * world_size():
        raise ValueError(f"all_gather: {out.numel()} entries for {world_size()} parts "
                         f"of {part.numel()}")
    if not active():
        out.copy_(part.reshape(out.shape))
        return out
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    _staged(gather, out, part)
    return out


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
