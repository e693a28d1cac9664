"""Flat-mesh graph LAM model (GraphCast/Keisler style).

Counterpart of ``neural_lam_tpu/models/graph_lam.py`` (reference:
neural_lam/models/step_predictors/graph/graph_lam.py:16-183): the
processor is a chain of InteractionNets on the single-level m2m edge set,
threading both node and edge representations through the layers. On a
mesh that is an exact offset-class lattice the chain can run in stencil
form instead (``ops/stencil.py``, ``NEURAL_LAM_TPU_STENCIL=on``), as in
the JAX package (``neural_lam_tpu/models/graph_lam.py:48-95``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import stencil
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

    def _m2m_stencil(self):
        """The m2m set's stencil decomposition on the model's device, or
        ``None``: when ``NEURAL_LAM_TPU_STENCIL`` is not ``on`` (read at
        every call), on a shard of a spatially partitioned model (the
        halo exchange owns message passing there), or when the mesh is
        not an exact offset-class lattice. Detected once, from the edge
        arrays themselves."""
        if not stencil.stencil_enabled() or getattr(self, "_sharded_view", False):
            return None
        if "_m2m_stencil_cache" not in self.__dict__:
            ge = self.graph.m2m[0]
            layout = stencil.detect_stencil(
                ge.edges.senders.cpu().numpy(),
                ge.edges.receivers.cpu().numpy(),
                ge.features.float().cpu().numpy(),
                self.graph.mesh_static_features[0].float().cpu().numpy(),
            )
            self._m2m_stencil_cache = None if layout is None else stencil.to_device(
                layout, self.device, self.compute_dtype)
        return self._m2m_stencil_cache

    def process_step(self, mesh_rep: torch.Tensor) -> torch.Tensor:
        """Chained InteractionNets with edge-representation threading
        (reference: graph/graph_lam.py:102-121, 152-183). Layer 0 embeds
        the static m2m features inside K3; later layers thread the
        updated, batched edge representation. On a stencil mesh under
        ``NEURAL_LAM_TPU_STENCIL=on`` the whole chain runs in stencil form
        (per-offset-class shifted dense MLPs, no edge list)."""
        st = self._m2m_stencil()
        if st is not None:
            return stencil.apply_stencil_processor(
                list(self.processor.values()), self.m2m_embedder, st, mesh_rep,
                aggr=self.mesh_aggr,
            )
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
