"""Spatial graph partitioning: sharded nodes, halo exchange, any model.

Counterpart of ``neural_lam_tpu/parallel/spatial.py``. The grid and every
mesh level are cut into ``P`` slabs of ``ceil(n / P)`` rows, one per rank
of a spatial process group (``utils.distributed.spatial_group``); each edge
belongs to the shard of its receiver. On its rank a shard's edge set is an
ordinary receiver-sorted :class:`~..ops.interaction.EdgeSet`:

- its receivers are the shard's local rows;
- its senders index the *extended sender array*: the shard's own rows of
  the sender set, then the halo rows, the rows of other shards that its
  edges read, offset by offset;
- ``num_send`` is the extended size, so that K2's sender tables cover the
  halo rows.

:meth:`ShardedModel.local_model` is a shallow copy of the model whose graph
holds these edge sets, each with an exchange (``GraphEdges.exchange``)
that builds the extended array from the local one before the edge phase.
The model's own ``step`` then runs unchanged on the shard, and with it the
three routes of the edge phase and their kernels (fused: K1, K3, backward
K4, K2; v2: K7, backward K8, K2; unfused: K1, K6, K5, backward K2, K5,
K6). The JAX executor threads per-shard blocked and banded tables, padded
to one static shape, into its Pallas kernels; the port's kernels take
their CSR tables as tensors, so none of that exists here.

The exchange of one edge set is one collective, by the JAX package's
rule (``_build_edge_table``), with the same defaults:

- ``halo``: one ``all_to_all`` in which shard ``t`` sends shard ``t - d``
  the rows it needs from it, for each offset ``d``. The payload is
  packed by K1 (its backward, K2, adds the returned halo gradients into
  the owned rows); the backward of the all-to-all is the same call with
  the split sizes swapped. The port sends each halo at its exact size;
  the JAX package pads every halo of an offset to the largest one,
  rounded up to 8 rows, and the strategy is decided on those numbers
  here too, so both packages choose alike.
- ``all_gather``: one all-gather of the whole sender set (small sets,
  coarse mesh levels); its backward is a reduce-scatter that sums.

Each collective the exchange issues is recorded while
:func:`record_collectives` is active (operation, edge set, rows and bytes
received by this rank), for ``collective_budget.recorded_table``.

Parameters are replicated. The loss of a shard is its part of the
interior-masked sum divided by the *global* interior count; the trainer
sums the gradients over every rank and divides by the data-parallel rank
count (``Trainer``, ``optim.FlatAdamW``).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..metrics import get_metric_entry
from ..models.graph_buffers import GraphEdges
from ..ops.interaction import make_edge_set
from ..ops.segment import gather_senders
from ..utils import distributed

ALL_GATHER_MAX_NODES = 2048
MAX_HALO_OFFSETS = 8


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass(frozen=True)
class EdgeMeta:
    """One sharded edge set, as every shard sees it.

    ``halo_rows[(s, d)]`` are the sorted rows of shard ``s + d`` that shard
    ``s``'s edges read; ``offsets`` the offsets ``d`` that occur (halo
    strategy only); ``halo_sizes`` per offset the most rows any shard
    receives, which the JAX package rounds up to 8 and gives every shard.
    """

    name: str
    n_shards: int
    n_rec_local: int
    n_send_local: int
    strategy: str  # "halo" | "all_gather"
    offsets: tuple[int, ...]
    halo_sizes: tuple[int, ...]
    halo_rows: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def recv_rows(self, shard: int) -> int:
        """Rows one exchange delivers to ``shard`` from the others."""
        if self.strategy == "all_gather":
            return self.n_send_local * (self.n_shards - 1)
        return sum(len(self.halo_rows.get((shard, d), ())) for d in self.offsets)

    def ext_size(self, shard: int) -> int:
        """Rows of ``shard``'s extended (local + halo) sender array."""
        return self.n_send_local + self.recv_rows(shard)

    def send_plan(self, shard: int) -> tuple[np.ndarray, list[int], list[int]]:
        """``(rows, in_splits, out_splits)`` of ``shard``'s all-to-all on
        the halo strategy: the local rows it sends, by destination rank in
        order, the count for each destination, and the count it receives
        from each source."""
        rows, ins, outs = [], [], []
        for q in range(self.n_shards):
            sent = self.halo_rows.get((q, shard - q), np.zeros(0, np.int64))
            rows.append(sent)
            ins.append(len(sent) if q != shard else 0)
            outs.append(len(self.halo_rows.get((shard, q - shard), ())) if q != shard else 0)
        return np.concatenate(rows).astype(np.int64), ins, outs


def build_edge_table(
    name: str,
    senders: np.ndarray,
    receivers: np.ndarray,
    n_send_global: int,
    n_send_local: int,
    n_rec_local: int,
    n_shards: int,
    all_gather_max_nodes: int = ALL_GATHER_MAX_NODES,
    max_halo_offsets: int = MAX_HALO_OFFSETS,
) -> tuple[EdgeMeta, list[tuple[np.ndarray, np.ndarray, np.ndarray]]]:
    """Shard the edges by receiver and find the halos (the JAX package's
    ``_build_edge_table``, ``neural_lam_tpu/parallel/spatial.py:112-364``,
    without the blocked and banded layouts). Returns the meta and per
    shard ``(edge ids, extended sender ids, local receiver ids)``, the
    edges in their given order."""
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    P_ = n_shards
    shard_of_edge = receivers // n_rec_local
    shard_of_sender = senders // n_send_local
    per_shard = [np.nonzero(shard_of_edge == s)[0] for s in range(P_)]

    needs: dict[tuple[int, int], np.ndarray] = {}
    offsets_set: set[int] = set()
    for s in range(P_):
        sel = per_shard[s]
        remote = sel[shard_of_sender[sel] != s]
        for t in np.unique(shard_of_sender[remote]):
            d = int(t - s)
            needs[(s, d)] = np.unique(
                senders[remote[shard_of_sender[remote] == t]] - t * n_send_local
            )
            offsets_set.add(d)
    offsets_all = tuple(sorted(offsets_set))
    exact = tuple(max(len(needs.get((s, d), ())) for s in range(P_)) for d in offsets_all)
    # the JAX package's padded halo sizes decide the strategy
    padded = tuple(_round_up(h or 1, 8) for h in exact)
    use_all_gather = (
        n_send_global <= all_gather_max_nodes
        or len(offsets_all) > max_halo_offsets
        or sum(padded) >= n_send_local * max(P_ - 1, 1)
    )
    meta = EdgeMeta(
        name=name,
        n_shards=P_,
        n_rec_local=n_rec_local,
        n_send_local=n_send_local,
        strategy="all_gather" if use_all_gather else "halo",
        offsets=() if use_all_gather else offsets_all,
        halo_sizes=() if use_all_gather else exact,
        halo_rows={} if use_all_gather else needs,
    )
    shards = []
    for s in range(P_):
        sel = per_shard[s]
        u = senders[sel]
        t = shard_of_sender[sel]
        local_ids = u - t * n_send_local
        if use_all_gather:
            ext = u  # the global id is t * n_send_local + the local one
        else:
            ext = np.where(t == s, local_ids, -1)
            base = n_send_local
            for d in meta.offsets:
                rows = needs.get((s, d))
                if rows is None:
                    continue
                in_d = t == s + d
                ext[in_d] = base + np.searchsorted(rows, local_ids[in_d])
                base += len(rows)
            if (ext < 0).any():
                raise AssertionError(f"unmapped sender in {name}")
        shards.append((sel, ext, receivers[sel] - s * n_rec_local))
    return meta, shards


# ---------------------------------------------------------------------------
# the exchange
# ---------------------------------------------------------------------------
_RECORD: Optional[list] = None


@contextlib.contextmanager
def record_collectives():
    """Record every collective the exchanges issue while active: a list
    of ``dict(op, edge_set, direction, rows, bytes)``, the rows and bytes
    this rank receives. Only Python runs are seen: a CUDA graph's replays
    issue the collectives they captured without recording them."""
    global _RECORD
    outer, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = outer


def _record(op: str, name: str, direction: str, rows: int, like: torch.Tensor) -> None:
    if _RECORD is not None:
        row_bytes = int(np.prod(like.shape[1:])) * like.element_size()
        _RECORD.append(dict(op=op, edge_set=name, direction=direction, rows=int(rows),
                            bytes=int(rows) * int(row_bytes)))


class _AllToAll(torch.autograd.Function):
    """One all-to-all of rows over the spatial group; its backward is the
    same collective with the split sizes swapped."""

    @staticmethod
    def forward(ctx, x, out_splits, in_splits, group, name):
        ctx.splits, ctx.group, ctx.name = (out_splits, in_splits), group, name
        out = x.new_empty((sum(out_splits),) + tuple(x.shape[1:]))
        distributed.all_to_all_(out, x.contiguous(), out_splits, in_splits, group)
        _record("all_to_all", name, "forward", sum(out_splits), out)
        return out

    @staticmethod
    def backward(ctx, g):
        out_splits, in_splits = ctx.splits
        dx = g.new_empty((sum(in_splits),) + tuple(g.shape[1:]))
        distributed.all_to_all_(dx, g.contiguous(), in_splits, out_splits, ctx.group)
        _record("all_to_all", ctx.name, "backward", sum(in_splits), dx)
        return dx, None, None, None, None


class _AllGather(torch.autograd.Function):
    """The rank-ordered concatenation of every shard's rows; its backward
    is the reduce-scatter that sums each shard's part over the group."""

    @staticmethod
    def forward(ctx, x, n_shards, group, name):
        ctx.n_shards, ctx.group, ctx.name = n_shards, group, name
        x = x.contiguous()
        out = x.new_empty((x.shape[0] * n_shards,) + tuple(x.shape[1:]))
        distributed.all_gather_into_(out, x, group)
        _record("all_gather", name, "forward", x.shape[0] * (n_shards - 1), x)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dx = g.new_empty((g.shape[0] // ctx.n_shards,) + tuple(g.shape[1:]))
        distributed.reduce_scatter_(dx, g, ctx.group)
        _record("reduce_scatter", ctx.name, "backward", dx.shape[0] * (ctx.n_shards - 1), dx)
        return dx, None, None, None


class Exchange:
    """The exchange of one edge set on one shard: ``x`` (the shard's rows
    of the sender set, ``(n_send_local, ...)``) to the extended sender
    array its local edge set indexes."""

    def __init__(self, meta: EdgeMeta, shard: int, group, device: torch.device) -> None:
        self.meta, self.group = meta, group
        self.collective = meta.n_shards > 1 and (
            meta.strategy == "all_gather" or bool(meta.offsets))
        self.pack = None
        if self.collective and meta.strategy == "halo":
            rows, self.in_splits, self.out_splits = meta.send_plan(shard)
            if len(rows):
                # K1 packs the payload; K2 (its backward) adds the returned
                # halo gradients into the owned rows
                self.pack, _ = make_edge_set(rows, np.arange(len(rows)), num_rec=len(rows),
                                             num_send=meta.n_send_local)
                self.pack = self.pack.to(device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        meta = self.meta
        if not self.collective:
            return x
        if not distributed.active():
            raise RuntimeError(f"{meta.name}: exchanging halos needs the spatial process "
                               "group")
        if meta.strategy == "all_gather":
            return _AllGather.apply(x, meta.n_shards, self.group, meta.name)
        if self.pack is not None:
            payload = gather_senders(self.pack, x)
        else:
            payload = x[:0]
        halo = _AllToAll.apply(payload, self.out_splits, self.in_splits, self.group, meta.name)
        return torch.cat([x, halo], dim=0)


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------
class ShardedModel:
    """Spatially sharded execution of a graph model on one rank.

    Every rank of the spatial group builds it for its own ``shard`` (by
    default ``rank % n_shards``) and runs :meth:`local_forecaster`'s
    forward on its slabs; ``group`` is the spatial process group
    (``utils.distributed.spatial_group``; ``None``: the default group, or
    no group at all with one shard). The edge tables are built for every
    shard from the model's graph, on the host, and only this shard's are
    placed on the model's device. Without a process group a shard of
    several can be built (its tables, slabs and shapes), but its exchanges
    raise.
    """

    def __init__(
        self,
        model,
        datastore,
        n_shards: int,
        shard: Optional[int] = None,
        group=None,
        all_gather_max_nodes: int = ALL_GATHER_MAX_NODES,
        max_halo_offsets: int = MAX_HALO_OFFSETS,
    ) -> None:
        P_ = self.n_shards = int(n_shards)
        if P_ < 1:
            raise ValueError(f"n_shards {n_shards}: at least 1")
        if distributed.active() and distributed.group_size(group) != P_:
            raise ValueError(f"{P_} shards over a group of {distributed.group_size(group)} "
                             "ranks")
        self.shard = distributed.rank() % P_ if shard is None else int(shard)
        self.group = group
        self.model = model
        device = model.device
        g = model.graph
        n_grid = self.n_grid = g.num_grid_nodes
        level_sizes = list(g.level_mesh_sizes)
        # exact ceil slabs: the node sets are x-major, so equal-fraction
        # slabs keep them aligned across shards and the halo offsets small
        self.n_grid_local = -(-n_grid // P_)
        self.n_grid_pad = self.n_grid_local * P_
        self.level_local = [-(-n // P_) for n in level_sizes]
        s = self.shard

        self.metas: dict[str, EdgeMeta] = {}
        local: dict[str, GraphEdges] = {}

        def add(name, ge, n_send_global, n_send_local, n_rec_local):
            senders = ge.edges.senders.cpu().numpy()
            receivers = ge.edges.receivers.cpu().numpy()
            meta, shards = build_edge_table(
                name, senders, receivers, n_send_global, n_send_local, n_rec_local, P_,
                all_gather_max_nodes, max_halo_offsets,
            )
            self.metas[name] = meta
            sel, ext, loc_r = shards[s]
            edges, perm = make_edge_set(ext, loc_r, num_rec=n_rec_local,
                                        num_send=meta.ext_size(s))
            feats = ge.features[torch.from_numpy(sel[perm]).to(ge.features.device)]
            local[name] = GraphEdges(edges.to(device), feats,
                                     exchange=Exchange(meta, s, group, device))

        add("g2m", g.g2m, n_grid, self.n_grid_local, self.level_local[0])
        add("m2g", g.m2g, level_sizes[0], self.level_local[0], self.n_grid_local)
        for lev, ge in enumerate(g.m2m):
            add(f"m2m{lev}", ge, level_sizes[lev], self.level_local[lev], self.level_local[lev])
        for lev, ge in enumerate(g.up):
            add(f"up{lev}", ge, level_sizes[lev], self.level_local[lev],
                self.level_local[lev + 1])
        for lev, ge in enumerate(g.down):
            add(f"down{lev}", ge, level_sizes[lev + 1], self.level_local[lev + 1],
                self.level_local[lev])

        # slabs in the model's compute dtype (a bf16 model's static features
        # must not come back as float32)
        self.graph = dataclasses.replace(
            g,
            num_grid_nodes=self.n_grid_local,
            g2m=local["g2m"],
            m2g=local["m2g"],
            m2m=tuple(local[f"m2m{i}"] for i in range(len(g.m2m))),
            up=tuple(local[f"up{i}"] for i in range(len(g.up))),
            down=tuple(local[f"down{i}"] for i in range(len(g.down))),
            mesh_static_features=tuple(
                self.slab(m, self.level_local[lev])
                for lev, m in enumerate(g.mesh_static_features)
            ),
        )
        self.grid_static = self.slab(model.grid_static_features, self.n_grid_local)
        boundary = np.ones(self.n_grid_pad, np.float32)
        boundary[:n_grid] = np.asarray(datastore.boundary_mask.data, np.float32).reshape(-1)
        interior = np.zeros(self.n_grid_pad, np.float32)
        interior[:n_grid] = 1.0 - boundary[:n_grid]
        self.n_interior = int(interior.sum())
        # a device tensor, divided by as the replicated masked mean divides
        # by its count (one shard then gives the replicated bits)
        self._n_interior = torch.tensor(self.n_interior, device=device)
        rows = slice(s * self.n_grid_local, (s + 1) * self.n_grid_local)
        self.boundary_mask = torch.from_numpy(boundary[rows].copy()).to(device)
        self.interior_mask = torch.from_numpy(interior[rows].copy()).to(device)

    # -- slabs ---------------------------------------------------------------
    def slab(self, t: torch.Tensor, n_local: int, axis: int = 0) -> torch.Tensor:
        """This shard's ``n_local`` rows of ``t`` along ``axis``, zero rows
        past its end."""
        axis = axis % t.dim()
        lo = self.shard * n_local
        part = t.narrow(axis, min(lo, t.shape[axis]),
                        max(min(n_local, t.shape[axis] - lo), 0))
        pad = n_local - part.shape[axis]
        if pad:
            shape = list(part.shape)
            shape[axis] = pad
            part = torch.cat([part, part.new_zeros(shape)], dim=axis)
        return part.contiguous()

    def grid_slab(self, arr) -> np.ndarray:
        """This shard's slab of a host array's grid axis (-2), zero-padded
        past the grid (the JAX package's ``pad_grid`` and the sharding of
        that axis)."""
        arr = np.asarray(arr)
        lo = self.shard * self.n_grid_local
        part = arr[..., lo:lo + self.n_grid_local, :]
        pad = self.n_grid_local - part.shape[-2]
        if pad:
            widths = [(0, 0)] * (arr.ndim - 2) + [(0, pad), (0, 0)]
            part = np.pad(part, widths)
        return np.ascontiguousarray(part)

    def gather_grid(self, t: torch.Tensor) -> torch.Tensor:
        """Every shard's slab of ``t`` along its grid axis (-2), in shard
        order and cut to the grid: the global array (a collective over the
        spatial group)."""
        moved = t.movedim(-2, 0).contiguous()
        out = moved.new_empty((moved.shape[0] * self.n_shards,) + tuple(moved.shape[1:]))
        distributed.all_gather_into_(out, moved, self.group)
        return out[: self.n_grid].movedim(0, -2)

    def spatial_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the spatial group, in place."""
        if self.n_shards > 1:
            distributed.all_reduce_(t, self.group)
        return t

    # -- the local model -------------------------------------------------------
    def local_model(self):
        """A shallow copy of the model that acts on this shard: its graph
        holds the local edge sets (each with its exchange) and slabs, its
        grid static features are the shard's slab, and ``_sharded_view``
        keeps the stencil processor off. It shares the model's parameters
        and submodules."""
        model = self.model
        local = copy.copy(model)
        local._buffers = dict(model._buffers)
        local.graph = self.graph
        local.grid_static_features = self.grid_static
        local.num_grid_nodes = self.n_grid_local
        local._sharded_view = True
        if hasattr(local, "level_mesh_sizes"):
            local.level_mesh_sizes = list(self.level_local)
        return local

    def local_forecaster(self, forecaster):
        """A shallow copy of ``forecaster`` whose predictor is
        :meth:`local_model` and whose boundary mask is this shard's slab
        (grid rows past the grid count as boundary)."""
        local = copy.copy(forecaster)
        local._buffers = dict(forecaster._buffers)
        local._modules = dict(forecaster._modules)
        local.predictor = self.local_model()
        local.boundary_mask = self.boundary_mask.reshape(-1, 1, 1)
        return local

    # -- the loss ------------------------------------------------------------
    def masked_metric(self, name: str, pred, target, pred_std, sum_vars: bool = True):
        """This shard's part of the interior-masked grid mean of a metric
        per (sample, step): its interior rows' sum over the *global*
        interior count (``ShardedModel._masked_metric``,
        ``neural_lam_tpu/parallel/spatial.py:1133-1154``, before its psum).
        The parts of the shards add up to ``loss_fn(..., mask=interior)``;
        the double ``where`` keeps NaN targets outside the interior out of
        the value and the gradients."""
        m = self.interior_mask[:, None] > 0
        target = torch.where(m, target, torch.zeros_like(target))
        pred = torch.where(m, pred, torch.zeros_like(pred))
        if pred_std.dim() == pred.dim():
            pred_std = torch.where(m, pred_std, torch.ones_like(pred_std))
        entry = get_metric_entry(name)(pred, target, pred_std)
        sums = (entry * self.interior_mask[:, None]).sum(dim=-2) / self._n_interior
        return sums.sum(dim=-1) if sum_vars else sums
