"""Encode-process-decode base for graph step predictors.

Counterpart of ``neural_lam_tpu/models/graph_base.py`` (reference:
neural_lam/models/step_predictors/graph/base.py:15-344). Parameters are
``nn.Module`` attributes named as in the reference's state dict; the
graph is a set of receiver-sorted edge sets on the model's device; the
step runs on node-major ``(N, B, d)`` arrays.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..datastore.base import BaseDatastore
from ..graphs.load import load_graph
from ..ops.interaction import InteractionNet, apply_interaction_net
from ..ops.mlp import make_mlp
from ..utils import trace
from ..utils.device import resolve_device
from .base import StepPredictor
from .graph_buffers import GraphBuffers, GraphEdges, build_graph_buffers

GNN_TYPES = ("InteractionNet", "PropagationNet")


def is_propagation(gnn_type: str) -> bool:
    """Map a reference GNN-type name to the ``propagation`` flag
    (reference: neural_lam/gnn_layers.py:193-250)."""
    if gnn_type not in GNN_TYPES:
        raise ValueError(
            f"Unknown GNN type: {gnn_type} (must be one of {GNN_TYPES})"
        )
    return gnn_type == "PropagationNet"


class BaseGraphModel(StepPredictor):
    """Abstract encode-process-decode graph model.

    Parameters are drawn from ``torch.Generator().manual_seed(seed)``;
    the model is built on ``device`` (``"cuda"`` unless the caller asks
    for ``"cpu"``) and its graph lives there too.

    Mixed precision (``compute_dtype``, a ``torch.dtype`` or its name, as
    the JAX package's, ``neural_lam_tpu/models/graph_base.py:66-83``): the
    static grid, mesh and edge features and the hidden activations are in
    this dtype; the parameters stay float32 and the caller passes bf16
    copies of them (``Trainer``'s ``precision="bf16"``). The output map's
    result is cast to float32, and the state update and its clamping run
    in float32.
    """

    def __init__(
        self,
        datastore: BaseDatastore,
        graph_name: str = "multiscale",
        hidden_dim: int = 64,
        hidden_layers: int = 1,
        processor_layers: int = 4,
        mesh_aggr: str = "sum",
        num_past_forcing_steps: int = 1,
        num_future_forcing_steps: int = 1,
        output_std: bool = False,
        output_clamping_lower: Optional[dict[str, float]] = None,
        output_clamping_upper: Optional[dict[str, float]] = None,
        g2m_gnn_type: str = "InteractionNet",
        m2g_gnn_type: str = "InteractionNet",
        seed: int = 0,
        device: str | torch.device = "cuda",
        compute_dtype: str | torch.dtype = torch.float32,
    ) -> None:
        super().__init__(
            datastore=datastore,
            output_std=output_std,
            output_clamping_lower=output_clamping_lower,
            output_clamping_upper=output_clamping_upper,
        )
        self.device = resolve_device(device)
        if isinstance(compute_dtype, str):
            compute_dtype = getattr(torch, compute_dtype)
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype {compute_dtype}: float32 or bfloat16")
        self.compute_dtype = compute_dtype
        self.grid_static_features = self.grid_static_features.to(compute_dtype)
        self.hidden_dim = hidden_dim
        self.hidden_layers = hidden_layers
        self.processor_layers = processor_layers
        if mesh_aggr not in ("sum", "mean"):
            raise ValueError(f"Unknown aggregation method: {mesh_aggr}")
        self.mesh_aggr = mesh_aggr
        self.g2m_propagation = is_propagation(g2m_gnn_type)
        self.m2g_propagation = is_propagation(m2g_gnn_type)

        # One-step difference statistics for output rescaling
        # (reference: graph/base.py:76-92).
        stats = datastore.get_standardization_dataarray(category="state")
        for name in ("state_diff_mean_standardized", "state_diff_std_standardized"):
            self.register_buffer(
                name.replace("state_", "").replace("_standardized", ""),
                torch.from_numpy(np.asarray(stats[name], np.float32).copy()),
                persistent=False,
            )

        # Graph (reference: graph/base.py:100-119).
        extent = datastore.get_xy_extent(category="state")
        hierarchical, graph_dict = load_graph(
            graph_dir_path=datastore.root_path / "graph" / graph_name,
            mesh_node_features_scaling=max(
                extent[1] - extent[0], extent[3] - extent[2]
            ),
        )
        self.hierarchical = hierarchical
        self.graph: GraphBuffers = build_graph_buffers(
            hierarchical, graph_dict, self.num_grid_nodes, dtype=compute_dtype
        )
        self.num_mesh_nodes = self.graph.num_mesh_nodes

        # Total per-grid-node input dim (reference: graph/base.py:128-137).
        num_forcing_vars = datastore.get_num_data_vars(category="forcing")
        self.grid_input_dim = (
            2 * self.num_state_vars
            + self.grid_static_features.shape[1]
            + num_forcing_vars
            * (num_past_forcing_steps + num_future_forcing_steps + 1)
        )

        # Submodules of the reference constructor (graph/base.py:142-175).
        self.generator = torch.Generator().manual_seed(seed)
        end = [hidden_dim] * (hidden_layers + 1)
        self.grid_embedder = self._mlp([self.grid_input_dim] + end)
        self.g2m_embedder = self._mlp([self.graph.g2m.feature_dim] + end)
        self.m2g_embedder = self._mlp([self.graph.m2g.feature_dim] + end)
        self.g2m_gnn = self._gnn()
        self.encoding_grid_mlp = self._mlp([hidden_dim] + end)
        self.m2g_gnn = self._gnn()
        self.output_map = self._mlp(
            [hidden_dim] * (hidden_layers + 1) + [self.grid_output_dim],
            layer_norm=False,  # no LayerNorm on the output head
        )

    def _mlp(self, blueprint, layer_norm: bool = True):
        return make_mlp(blueprint, layer_norm=layer_norm, generator=self.generator)

    def _gnn(self, **chunks: int) -> InteractionNet:
        """One InteractionNet at the model's widths; ``num_edge_chunks`` /
        ``num_aggr_chunks`` give it per-chunk MLPs."""
        return InteractionNet(
            self.hidden_dim, hidden_layers=self.hidden_layers,
            generator=self.generator, **chunks,
        )

    def _gnns(self, n: int, **chunks: int) -> nn.ModuleList:
        """``n`` InteractionNets (the JAX package's
        ``init_processor_nets``)."""
        return nn.ModuleList([self._gnn(**chunks) for _ in range(n)])

    def _place(self) -> None:
        """Move parameters, buffers and graph to ``self.device``; the
        subclass calls this once its own submodules exist."""
        del self.generator
        self.to(self.device)
        self.graph = self.graph.to(self.device)
        self.clamp = self.clamp.to(self.device)

    def gnn_apply(
        self,
        net: InteractionNet,
        ge: GraphEdges,
        send_rep: torch.Tensor,
        rec_rep: torch.Tensor,
        edge_rep: Optional[torch.Tensor],
        edge_embedder=None,
        *,
        name: str,
        **kwargs: Any,
    ):
        """Apply one GNN over the edge bundle ``ge``, named ``name`` after
        its edge set (the span ``gnn.<name>``, ``utils.trace``); passing
        ``edge_embedder`` (with ``edge_rep=None``) delegates the static
        edge embedding to the op, which fuses it into K3. The senders go
        through ``ge.sender_rows`` (the halo exchange on a shard)."""
        with trace.span("gnn." + name):
            return apply_interaction_net(
                net,
                ge.edges,
                send_rep=ge.sender_rows(send_rep),
                rec_rep=rec_rep,
                edge_rep=edge_rep,
                edge_embedder=edge_embedder,
                edge_features=ge.features if edge_embedder is not None else None,
                **kwargs,
            )

    def embed_mesh_nodes(self) -> torch.Tensor:
        """Embed static mesh node features (bottom level for hierarchies)."""
        raise NotImplementedError

    def process_step(self, mesh_rep: torch.Tensor) -> torch.Tensor:
        """Run the processor on the (bottom-level) mesh representation."""
        raise NotImplementedError

    def step(
        self,
        prev_state: torch.Tensor,
        prev_prev_state: torch.Tensor,
        forcing: torch.Tensor,
    ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One-step prediction on node-major ``(N, B, d)`` (or unbatched
        ``(N, d)``) arrays: embed, g2m, process, m2g, output map,
        diff-stat rescale, clamped residual add (reference:
        graph/base.py:228-344). The hidden compute runs in
        ``compute_dtype``; the state update in float32."""
        dtype = self.compute_dtype
        static = self.grid_static_features
        if prev_state.dim() == 3:
            static = static.unsqueeze(1).expand(-1, prev_state.shape[1], -1)
        grid_features = torch.cat(
            (prev_state.to(dtype), prev_prev_state.to(dtype), forcing.to(dtype), static),
            dim=-1,
        )
        grid_emb = self.grid_embedder(grid_features)
        mesh_emb = self.embed_mesh_nodes()

        mesh_rep = self.gnn_apply(
            self.g2m_gnn,
            self.graph.g2m,
            send_rep=grid_emb,
            rec_rep=mesh_emb,
            edge_rep=None,
            edge_embedder=self.g2m_embedder,
            name="g2m",
            update_edges=False,
            propagation=self.g2m_propagation,
        )
        grid_rep = grid_emb + self.encoding_grid_mlp(grid_emb)
        mesh_rep = self.process_step(mesh_rep)
        grid_rep = self.gnn_apply(
            self.m2g_gnn,
            self.graph.m2g,
            send_rep=mesh_rep,
            rec_rep=grid_rep,
            edge_rep=None,
            edge_embedder=self.m2g_embedder,
            name="m2g",
            update_edges=False,
            propagation=self.m2g_propagation,
        )
        net_output = self.output_map(grid_rep).float()
        if self.output_std:
            pred_delta_mean, pred_std_raw = net_output.chunk(2, dim=-1)
            pred_std = F.softplus(pred_std_raw)
        else:
            pred_delta_mean, pred_std = net_output, None

        rescaled_delta_mean = pred_delta_mean * self.diff_std + self.diff_mean
        new_state = self.get_clamped_new_state(rescaled_delta_mean, prev_state.float())
        return new_state, pred_std
