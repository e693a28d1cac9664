"""Regular-structure (stencil) m2m processor for uniform quad meshes.

Counterpart of ``neural_lam_tpu/ops/stencil.py``, which is written with
XLA operations and no Pallas kernel; this is the same formulation in
plain ``torch``. On the multiscale mesh (factor-3 coarsened quad grids
merged into one level-0 lattice, reference: create_graph.py:279-332,
645-681) every m2m edge belongs to one of 8 offset classes per stride,
and its static features are constant within the class. Message passing
then needs no edge list: per class, the sender field is a shifted copy of
the node lattice (a receiver-side mask drops the rows that wrap around),
the edge state is a dense ``(n_offsets, nsx, nsy, [B,] d)`` tensor per
stride group, and one InteractionNet application is a few masked dense
MLPs and adds.

:func:`detect_stencil` (numpy, as in the JAX package) recovers the
structure from the edge arrays and returns ``None`` whenever the graph is
not exactly stencil-decomposable; the caller then keeps the edge-list
route. The numbers match the edge-list route up to float32 summation
order.

``NEURAL_LAM_TPU_STENCIL`` chooses the route (:func:`stencil_enabled`);
it is one of ``fused_kernels.route_env``'s variables, so captured graphs
key on it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from .fused_kernels import STENCIL_ENV
from .mlp import apply_mlp_split_first


@dataclasses.dataclass(frozen=True)
class StencilGroup:
    """All offset classes sharing one (stride, subgrid origin)."""

    stride: int
    origin: tuple[int, int]  # lattice coords of subgrid position (0, 0)
    dims: tuple[int, int]  # (nsx, nsy) subgrid shape
    offsets: tuple[tuple[int, int], ...]  # per class, in subgrid units
    feats: np.ndarray  # (n_offsets, d_feat) class-constant edge features
    masks: np.ndarray  # (n_offsets, nsx, nsy) float32 receiver validity


@dataclasses.dataclass(frozen=True)
class StencilLayout:
    dims: tuple[int, int]  # (nx, ny) full lattice
    # x_lat = x[perm] maps node-index order -> row-major lattice order;
    # None when the graph already stores nodes row-major
    perm: Optional[np.ndarray]
    inv_perm: Optional[np.ndarray]
    groups: tuple[StencilGroup, ...]
    counts: np.ndarray  # (nx, ny) float32 in-degree (for mean aggr)
    n_nodes: int

    @property
    def num_edges(self) -> int:
        return int(sum(g.masks.sum() for g in self.groups))


def detect_stencil(
    senders: np.ndarray,
    receivers: np.ndarray,
    features: np.ndarray,
    xy: np.ndarray,
    feat_tol: float = 1e-6,
) -> Optional[StencilLayout]:
    """Recover the stencil decomposition of an edge set, or ``None``
    (``neural_lam_tpu/ops/stencil.py:72-169``). ``xy`` are the (possibly
    normalized) mesh node positions; the lattice is the outer product of
    their unique coordinate values, so any affine scaling of a regular
    grid works."""
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    features = np.asarray(features, np.float64)
    xy = np.asarray(xy, np.float64)
    n = xy.shape[0]
    if n == 0 or senders.size == 0:
        return None

    ux, uy = np.unique(xy[:, 0]), np.unique(xy[:, 1])
    nx, ny = len(ux), len(uy)
    if nx * ny != n:
        return None
    ix = np.searchsorted(ux, xy[:, 0])
    iy = np.searchsorted(uy, xy[:, 1])
    lat = ix * ny + iy
    if len(np.unique(lat)) != n:
        return None
    perm = np.empty(n, np.int64)
    perm[lat] = np.arange(n)
    identity = bool(np.array_equal(perm, np.arange(n)))
    inv = None if identity else np.argsort(perm)

    di = ix[senders] - ix[receivers]
    dj = iy[senders] - iy[receivers]
    class_key = di * (2 * max(nx, ny) + 1) + dj
    counts = np.zeros((nx, ny), np.float64)
    groups: dict[tuple[int, tuple[int, int]], dict] = {}
    for key in np.unique(class_key):
        sel = class_key == key
        cdi, cdj = int(di[sel][0]), int(dj[sel][0])
        stride = max(abs(cdi), abs(cdj))
        if stride == 0:
            return None  # self loops are not stencil edges
        if abs(cdi) not in (0, stride) or abs(cdj) not in (0, stride):
            return None
        rix, riy = ix[receivers[sel]], iy[receivers[sel]]
        ox = np.unique(rix % stride)
        oy = np.unique(riy % stride)
        if len(ox) != 1 or len(oy) != 1:
            return None
        origin = (int(ox[0]), int(oy[0]))
        dims = (
            (nx - origin[0] + stride - 1) // stride,
            (ny - origin[1] + stride - 1) // stride,
        )
        feats_sel = features[sel]
        if np.ptp(feats_sel, axis=0).max() > feat_tol:
            return None  # features not class-constant
        mask = np.zeros(dims, np.float64)
        px = (rix - origin[0]) // stride
        py = (riy - origin[1]) // stride
        # np.add.at, not fancy-index +=: the latter applies a duplicate
        # index once, which would drop a multi-edge instead of failing
        np.add.at(mask, (px, py), 1.0)
        if mask.max() > 1.0:
            return None  # multi-edge within a class
        np.add.at(counts, (rix, riy), 1.0)
        g = groups.setdefault(
            (stride, origin),
            {"dims": dims, "offsets": [], "feats": [], "masks": []},
        )
        if g["dims"] != dims:
            return None
        g["offsets"].append((cdi // stride, cdj // stride))
        g["feats"].append(feats_sel[0])
        g["masks"].append(mask)

    return StencilLayout(
        dims=(nx, ny),
        perm=None if identity else perm,
        inv_perm=inv,
        groups=tuple(
            StencilGroup(
                stride=s,
                origin=o,
                dims=g["dims"],
                offsets=tuple(g["offsets"]),
                feats=np.asarray(g["feats"], np.float32),
                masks=np.asarray(g["masks"], np.float32),
            )
            for (s, o), g in sorted(groups.items())
        ),
        counts=counts.astype(np.float32),
        n_nodes=n,
    )


def stencil_enabled() -> bool:
    """``NEURAL_LAM_TPU_STENCIL``: ``on``, ``off`` or ``auto`` (the
    default), read at every call. ``auto`` is off: the JAX package turns
    the stencil on wherever its backend is not a TPU, a choice made on
    its own hardware; in the port the edge-list route with its CUDA
    kernels stays the default until a benchmark cell on the card has
    measured the two routes against each other. ``on`` takes the stencil
    route wherever the mesh is a stencil."""
    mode = os.environ.get(STENCIL_ENV, "auto")
    if mode not in ("on", "off", "auto"):
        raise ValueError(f"{STENCIL_ENV}={mode!r}: expected on, off or auto")
    return mode == "on"


@dataclasses.dataclass
class DeviceStencil:
    """A :class:`StencilLayout`'s index and mask arrays on a device, made
    once (a captured step may copy nothing from the host)."""

    layout: StencilLayout
    perm: Optional[torch.Tensor]
    inv_perm: Optional[torch.Tensor]
    feats: list[torch.Tensor]
    masks: list[torch.Tensor]
    counts: torch.Tensor


def to_device(layout: StencilLayout, device, dtype) -> DeviceStencil:
    def as_index(a):
        return None if a is None else torch.from_numpy(a).to(device)

    return DeviceStencil(
        layout=layout,
        perm=as_index(layout.perm),
        inv_perm=as_index(layout.inv_perm),
        feats=[torch.from_numpy(g.feats).to(device, dtype) for g in layout.groups],
        masks=[torch.from_numpy(g.masks).to(device, dtype) for g in layout.groups],
        counts=torch.from_numpy(layout.counts).to(device, dtype),
    )


def _shift(xs: torch.Tensor, du: int, dv: int) -> torch.Tensor:
    """Sender field for offset (du, dv): position p reads p + (du, dv).
    Wrap-around rows are dropped by the class mask."""
    return torch.roll(xs, shifts=(-du, -dv), dims=(0, 1))


def init_edge_states(embedder, st: DeviceStencil, like: torch.Tensor) -> list[torch.Tensor]:
    """Initial per-group edge states: the edge embedder on each class's
    constant feature row (``n_offsets`` rows per group instead of E),
    broadcast over the subgrid and any batch axis of ``like``, the
    ``(nx, ny, [B,] d)`` lattice."""
    states = []
    extra = like.shape[2:]
    for g, feats in zip(st.layout.groups, st.feats):
        emb = embedder(feats)  # (n_off, d)
        shape = (len(g.offsets),) + g.dims + tuple(extra[:-1]) + (emb.shape[-1],)
        emb = emb.reshape((len(g.offsets), 1, 1) + (1,) * (len(extra) - 1) + (emb.shape[-1],))
        states.append(emb.expand(shape).to(like.dtype))
    return states


def apply_stencil_interaction(
    net,
    st: DeviceStencil,
    x_lat: torch.Tensor,
    e_states: Sequence[torch.Tensor],
    aggr: str = "sum",
) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """One InteractionNet application in stencil form
    (``apply_interaction_net``'s semantics: messages = edge MLP of (edge,
    sender, receiver), masked sum or count-clamped mean into the
    receivers, receiver residual plus node MLP, edge residual).
    ``x_lat``: ``(nx, ny, [B,] d)``; ``e_states``: per group
    ``(n_offsets, nsx, nsy, [B,] d)``."""
    agg = torch.zeros_like(x_lat)
    new_states = []
    for g, mask, e_state in zip(st.layout.groups, st.masks, e_states):
        s = g.stride
        ox, oy = g.origin
        xs = x_lat[ox::s, oy::s]
        shifted = torch.stack([_shift(xs, du, dv) for du, dv in g.offsets])
        msg = apply_mlp_split_first(net.edge_mlp, (e_state, shifted, xs.unsqueeze(0)))
        msg = msg * mask.reshape(mask.shape + (1,) * (msg.dim() - 3)).to(msg.dtype)
        new_states.append(e_state + msg)
        agg[ox::s, oy::s] += msg.sum(dim=0)
    if aggr == "mean":
        c = st.counts.clamp(min=1.0).to(agg.dtype)
        agg = agg / c.reshape(c.shape + (1,) * (x_lat.dim() - 2))
    rec_diff = apply_mlp_split_first(net.aggr_mlp, (x_lat, agg))
    return x_lat + rec_diff, new_states


def apply_stencil_processor(
    processor_nets: Sequence,
    embedder,
    st: DeviceStencil,
    mesh_rep: torch.Tensor,
    aggr: str = "sum",
) -> torch.Tensor:
    """GraphLAM's processor chain in stencil form: the first layer takes
    the embedded class-constant features, later layers thread the updated
    edge states (reference: graph/graph_lam.py:102-121). ``mesh_rep`` is
    ``(N, [B,] d)`` in node order."""
    layout = st.layout
    n = layout.n_nodes
    rows = mesh_rep.shape[0]
    x = mesh_rep[:n]
    if st.perm is not None:
        x = x[st.perm]
    x_lat = x.reshape(layout.dims + tuple(x.shape[1:]))
    e_states = init_edge_states(embedder, st, x_lat)
    for net in processor_nets:
        x_lat, e_states = apply_stencil_interaction(net, st, x_lat, e_states, aggr=aggr)
    x = x_lat.reshape((n,) + tuple(x_lat.shape[2:]))
    if st.inv_perm is not None:
        x = x[st.inv_perm]
    if rows != n:
        x = torch.cat([x, x.new_zeros((rows - n,) + tuple(x.shape[1:]))], dim=0)
    return x
