"""Base for hierarchical (multi-level mesh) graph models.

Counterpart of ``neural_lam_tpu/models/hierarchical.py`` (reference:
neural_lam/models/step_predictors/graph/hierarchical.py:15-318):
per-level node and edge embedders, an upward MESH INIT sweep, a
subclass-defined processor and a downward MESH READ OUT sweep. The level
lists are ``nn.ModuleList``s named as in the reference's state dict
(``mesh_embedders.<l>``, ``mesh_init_gnns.<l>``, ...).

The static embeddings of the levels above the bottom and of every mesh
edge set are unbatched, ``(N, D)`` / ``(E, D)``, and computed once per
step; they become batched with the first GNN that updates them.
"""

from __future__ import annotations

import torch
from torch import nn

from ..datastore.base import BaseDatastore
from .graph_base import BaseGraphModel, is_propagation


class BaseHiGraphModel(BaseGraphModel):
    """Hierarchical encode-process-decode model."""

    def __init__(
        self,
        datastore: BaseDatastore,
        graph_name: str = "hierarchical",
        *args,
        mesh_up_gnn_type: str = "InteractionNet",
        mesh_down_gnn_type: str = "InteractionNet",
        **kwargs,
    ) -> None:
        super().__init__(datastore, graph_name, *args, **kwargs)
        if not self.hierarchical:
            raise ValueError(
                f"{type(self).__name__} requires a hierarchical mesh graph "
                f"(got a flat graph for {graph_name!r})"
            )
        self.up_propagation = is_propagation(mesh_up_gnn_type)
        self.down_propagation = is_propagation(mesh_down_gnn_type)
        g = self.graph
        self.num_levels = g.num_levels
        self.level_mesh_sizes = list(g.level_mesh_sizes)

        # Embedders per level, init and read-out GNNs per gap between
        # levels (reference: hierarchical.py:89-141).
        n_gaps = self.num_levels - 1
        end = [self.hidden_dim] * (self.hidden_layers + 1)

        def embedders(dim: int, n: int) -> nn.ModuleList:
            return nn.ModuleList([self._mlp([dim] + end) for _ in range(n)])

        mesh_dim = int(g.mesh_static_features[0].shape[1])
        self.mesh_embedders = embedders(mesh_dim, self.num_levels)
        self.mesh_same_embedders = embedders(g.m2m[0].feature_dim, self.num_levels)
        self.mesh_up_embedders = embedders(g.up[0].feature_dim, n_gaps)
        self.mesh_down_embedders = embedders(g.down[0].feature_dim, n_gaps)
        self.mesh_init_gnns = self._gnns(n_gaps)
        self.mesh_read_gnns = self._gnns(n_gaps)

    def embed_mesh_nodes(self) -> torch.Tensor:
        """Bottom level only; higher levels are embedded in process_step
        (reference: hierarchical.py:161-174)."""
        return self.mesh_embedders[0](self.graph.mesh_static_features[0])

    def process_step(self, mesh_rep: torch.Tensor) -> torch.Tensor:
        """Full init -> processor -> read-out cycle (reference:
        hierarchical.py:176-282)."""
        g = self.graph

        # Embed the remaining (level >= 1) mesh nodes and all edge sets
        mesh_rep_levels = [mesh_rep] + [
            emb(static)
            for emb, static in zip(
                list(self.mesh_embedders)[1:], g.mesh_static_features[1:]
            )
        ]
        mesh_same_rep = [
            emb(ge.features) for emb, ge in zip(self.mesh_same_embedders, g.m2m)
        ]
        mesh_up_rep = [
            emb(ge.features) for emb, ge in zip(self.mesh_up_embedders, g.up)
        ]
        mesh_down_rep = [
            emb(ge.features) for emb, ge in zip(self.mesh_down_embedders, g.down)
        ]

        # MESH INIT: upward sweep over levels 1..L-1
        for level_l, gnn in enumerate(self.mesh_init_gnns, 1):
            mesh_rep_levels[level_l], mesh_up_rep[level_l - 1] = self.gnn_apply(
                gnn,
                g.up[level_l - 1],
                send_rep=mesh_rep_levels[level_l - 1],
                rec_rep=mesh_rep_levels[level_l],
                edge_rep=mesh_up_rep[level_l - 1],
                name=f"mesh_up.{level_l - 1}",
                update_edges=True,
                propagation=self.up_propagation,
            )

        # PROCESSOR (subclass)
        mesh_rep_levels, _, _, mesh_down_rep = self.hi_processor_step(
            mesh_rep_levels, mesh_same_rep, mesh_up_rep, mesh_down_rep
        )

        # MESH READ OUT: downward sweep over levels L-2..0
        for level_l in range(self.num_levels - 2, -1, -1):
            mesh_rep_levels[level_l] = self.gnn_apply(
                self.mesh_read_gnns[level_l],
                g.down[level_l],
                send_rep=mesh_rep_levels[level_l + 1],
                rec_rep=mesh_rep_levels[level_l],
                edge_rep=mesh_down_rep[level_l],
                name=f"mesh_down.{level_l}",
                update_edges=False,
                propagation=self.down_propagation,
            )
        return mesh_rep_levels[0]

    def hi_processor_step(
        self,
        mesh_rep_levels: list[torch.Tensor],
        mesh_same_rep: list[torch.Tensor],
        mesh_up_rep: list[torch.Tensor],
        mesh_down_rep: list[torch.Tensor],
    ) -> tuple[list, list, list, list]:
        """Processor between mesh init and read-out; returns the updated
        lists."""
        raise NotImplementedError
