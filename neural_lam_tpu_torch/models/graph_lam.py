"""Flat-mesh graph LAM model (GraphCast/Keisler style).

Counterpart of ``neural_lam_tpu/models/graph_lam.py`` (reference:
neural_lam/models/step_predictors/graph/graph_lam.py:16-183): the
processor is a chain of InteractionNets on the single-level m2m edge set,
threading both node and edge representations through the layers. This
is the edge-list processor; the JAX package's stencil branch
(``ops/stencil.py``) is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from .graph_base import BaseGraphModel


class GraphLAM(BaseGraphModel):
    """Graph model on a flat (possibly multiscale-merged) mesh."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        if self.hierarchical:
            raise ValueError("GraphLAM does not use a hierarchical mesh graph")
        end = [self.hidden_dim] * (self.hidden_layers + 1)
        mesh_dim = int(self.graph.mesh_static_features[0].shape[1])
        self.mesh_embedder = self._mlp([mesh_dim] + end)
        self.m2m_embedder = self._mlp([self.graph.m2m[0].feature_dim] + end)
        # "processor.module_<i>" as in the reference's pyg Sequential
        self.processor = nn.ModuleDict(
            {f"module_{i}": self._gnn() for i in range(self.processor_layers)}
        )
        self._place()

    def embed_mesh_nodes(self) -> torch.Tensor:
        return self.mesh_embedder(self.graph.mesh_static_features[0])

    def process_step(self, mesh_rep: torch.Tensor) -> torch.Tensor:
        """Chained InteractionNets with edge-representation threading
        (reference: graph/graph_lam.py:102-121, 152-183). Layer 0 embeds
        the static m2m features inside K3; later layers thread the
        updated, batched edge representation."""
        edge_rep = None
        for i, net in enumerate(self.processor.values()):
            mesh_rep, edge_rep = self.gnn_apply(
                net,
                self.graph.m2m[0],
                send_rep=mesh_rep,
                rec_rep=mesh_rep,
                edge_rep=edge_rep,
                edge_embedder=self.m2m_embedder if i == 0 else None,
                aggr=self.mesh_aggr,
                update_edges=True,
            )
        return mesh_rep
