"""Device-ready graph buffers: receiver-sorted edge sets + static features.

Counterpart of ``neural_lam_tpu/models/graph_buffers.py``. Every edge
set becomes a receiver-sorted :class:`~neural_lam_tpu_torch.ops.interaction.EdgeSet`
plus its per-edge features in the same order. There is no padding: the
JAX package's dead slots and block-padded rows are TPU layout devices.

Index convention is zero-based per node set (sender indices into the
sender set, receiver indices into the receiver set), matching the
reference graph storage spec
(reference: docs/graph_storage_spec.md:132-160). Receiver-set sizes are
given by the owning node set (grid or mesh level), not ``max(recv)+1``,
so receivers with no incoming edges still get a (zero) aggregate.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..ops.interaction import EdgeSet, make_edge_set, place_edge_features


@dataclasses.dataclass(frozen=True)
class GraphEdges:
    """An edge set with its per-edge features, in sorted edge order
    (the counterpart of the JAX package's ``PaddedEdges``).

    ``exchange``, set on a shard's edge sets under spatial partitioning
    (``parallel/spatial.py``), maps the shard's rows of the sender set to
    the extended array (its rows, then the halo rows) that the edge set's
    sender ids index; every edge phase takes its senders through
    :meth:`sender_rows`."""

    edges: EdgeSet
    features: torch.Tensor  # (E, d_feat), in the model's compute dtype
    exchange: Optional[Callable[[torch.Tensor], torch.Tensor]] = dataclasses.field(
        default=None, compare=False)

    @property
    def feature_dim(self) -> int:
        return int(self.features.shape[-1])

    def sender_rows(self, send_rep: torch.Tensor) -> torch.Tensor:
        """The sender array the edge set's sender ids index: ``send_rep``,
        or on a shard its exchange's extended array."""
        return send_rep if self.exchange is None else self.exchange(send_rep)

    def to(self, device: torch.device) -> "GraphEdges":
        return GraphEdges(self.edges.to(device), self.features.to(device))


def _make_edges(
    edge_index: np.ndarray, features: np.ndarray, num_rec: int, num_send: int,
    dtype: torch.dtype = torch.float32,
) -> GraphEdges:
    edges, perm = make_edge_set(
        edge_index[0], edge_index[1], num_rec=num_rec, num_send=num_send
    )
    feats = place_edge_features(np.asarray(features, np.float32), perm)
    return GraphEdges(edges=edges, features=torch.from_numpy(feats.copy()).to(dtype))


@dataclasses.dataclass(frozen=True)
class GraphBuffers:
    """All graph connectivity and static features of one model.

    Level lists follow the reference convention: level 0 is the finest
    mesh level; ``up[l]`` connects level ``l`` -> ``l+1`` and ``down[l]``
    connects level ``l+1`` -> ``l`` (reference: neural_lam/utils.py:465-535).
    Flat graphs have single-element ``m2m`` / ``mesh_static_features``
    and empty ``up`` / ``down``.
    """

    hierarchical: bool
    num_grid_nodes: int
    g2m: GraphEdges  # senders: grid, receivers: mesh level 0
    m2g: GraphEdges  # senders: mesh level 0, receivers: grid
    m2m: tuple[GraphEdges, ...]
    mesh_static_features: tuple[torch.Tensor, ...]  # (n_mesh[l], 2)
    up: tuple[GraphEdges, ...]
    down: tuple[GraphEdges, ...]

    @property
    def num_levels(self) -> int:
        return len(self.mesh_static_features)

    @property
    def level_mesh_sizes(self) -> tuple[int, ...]:
        return tuple(int(m.shape[0]) for m in self.mesh_static_features)

    @property
    def num_mesh_nodes(self) -> int:
        return sum(self.level_mesh_sizes)

    def to(self, device: torch.device) -> "GraphBuffers":
        def edges(seq):
            return tuple(e.to(device) for e in seq)

        return dataclasses.replace(
            self,
            g2m=self.g2m.to(device),
            m2g=self.m2g.to(device),
            m2m=edges(self.m2m),
            mesh_static_features=tuple(
                m.to(device) for m in self.mesh_static_features
            ),
            up=edges(self.up),
            down=edges(self.down),
        )


def build_graph_buffers(
    hierarchical: bool, graph: dict[str, Any], num_grid_nodes: int,
    dtype: torch.dtype = torch.float32,
) -> GraphBuffers:
    """Convert a loaded (numpy) graph dict into CPU graph buffers, the
    static edge and mesh features in ``dtype`` (the model's compute dtype,
    as the JAX package's ``build_graph_buffers(dtype=...)``)."""
    if hierarchical:
        mesh_static = [np.asarray(m, np.float32) for m in graph["mesh_static_features"]]
        m2m_indices = graph["m2m_edge_index"]
        m2m_features = graph["m2m_features"]
    else:
        mesh_static = [np.asarray(graph["mesh_static_features"], np.float32)]
        m2m_indices = [graph["m2m_edge_index"]]
        m2m_features = [graph["m2m_features"]]
    sizes = [m.shape[0] for m in mesh_static]

    m2m = tuple(
        _make_edges(idx, feat, num_rec=sizes[lev], num_send=sizes[lev], dtype=dtype)
        for lev, (idx, feat) in enumerate(zip(m2m_indices, m2m_features))
    )
    g2m = _make_edges(
        graph["g2m_edge_index"], graph["g2m_features"],
        num_rec=sizes[0], num_send=num_grid_nodes, dtype=dtype,
    )
    m2g = _make_edges(
        graph["m2g_edge_index"], graph["m2g_features"],
        num_rec=num_grid_nodes, num_send=sizes[0], dtype=dtype,
    )
    up: tuple[GraphEdges, ...] = ()
    down: tuple[GraphEdges, ...] = ()
    if hierarchical:
        up = tuple(
            _make_edges(idx, feat, num_rec=sizes[lev + 1], num_send=sizes[lev],
                        dtype=dtype)
            for lev, (idx, feat) in enumerate(
                zip(graph["mesh_up_edge_index"], graph["mesh_up_features"])
            )
        )
        down = tuple(
            _make_edges(idx, feat, num_rec=sizes[lev], num_send=sizes[lev + 1],
                        dtype=dtype)
            for lev, (idx, feat) in enumerate(
                zip(graph["mesh_down_edge_index"], graph["mesh_down_features"])
            )
        )
    return GraphBuffers(
        hierarchical=hierarchical,
        num_grid_nodes=num_grid_nodes,
        g2m=g2m,
        m2g=m2g,
        m2m=m2m,
        mesh_static_features=tuple(
            torch.from_numpy(m.copy()).to(dtype) for m in mesh_static
        ),
        up=up,
        down=down,
    )
