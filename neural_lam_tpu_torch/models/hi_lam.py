"""Hi-LAM: sequential hierarchical processor (Oskarsson et al. 2023).

Counterpart of ``neural_lam_tpu/models/hi_lam.py`` (reference:
neural_lam/models/step_predictors/graph/hi_lam.py:16-360): each
processor layer runs a Down sweep (top -> bottom, alternating down-edge
GNN and same-level GNN) followed by an Up sweep (bottom -> top), with
separate GNNs per (layer, level). The order of the sweeps is semantic.
"""

from __future__ import annotations

from torch import nn

from .hierarchical import BaseHiGraphModel


class HiLAM(BaseHiGraphModel):
    """Sequential hierarchical message passing."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        levels, gaps = self.num_levels, self.num_levels - 1

        # Nested stacks ``<name>.<layer>.<level or gap>`` (reference:
        # hi_lam.py:87-101).
        def stacks(n: int) -> nn.ModuleList:
            return nn.ModuleList(
                [self._gnns(n) for _ in range(self.processor_layers)]
            )

        self.mesh_down_gnns = stacks(gaps)
        self.mesh_down_same_gnns = stacks(levels)
        self.mesh_up_gnns = stacks(gaps)
        self.mesh_up_same_gnns = stacks(levels)
        self._place()

    def _same_level(self, gnn, level_l, node_rep, mesh_same_rep):
        """Same-level GNN on ``node_rep``: the new ``(nodes, edges)``."""
        return self.gnn_apply(
            gnn,
            self.graph.m2m[level_l],
            send_rep=node_rep,
            rec_rep=node_rep,
            edge_rep=mesh_same_rep[level_l],
            name=f"m2m.{level_l}",
            update_edges=True,
        )

    def _mesh_down_step(
        self, mesh_rep_levels, mesh_same_rep, mesh_down_rep, down_gnns, same_gnns
    ):
        """Down sweep (reference: hi_lam.py:165-234)."""
        top = self.num_levels - 1
        # Same-level processing on the top level first
        mesh_rep_levels[top], mesh_same_rep[top] = self._same_level(
            same_gnns[top], top, mesh_rep_levels[top], mesh_same_rep
        )
        for level_l in range(self.num_levels - 2, -1, -1):
            new_node_rep, mesh_down_rep[level_l] = self.gnn_apply(
                down_gnns[level_l],
                self.graph.down[level_l],
                send_rep=mesh_rep_levels[level_l + 1],
                rec_rep=mesh_rep_levels[level_l],
                edge_rep=mesh_down_rep[level_l],
                name=f"mesh_down.{level_l}",
                update_edges=True,
                propagation=self.down_propagation,
            )
            mesh_rep_levels[level_l], mesh_same_rep[level_l] = self._same_level(
                same_gnns[level_l], level_l, new_node_rep, mesh_same_rep
            )
        return mesh_rep_levels, mesh_same_rep, mesh_down_rep

    def _mesh_up_step(
        self, mesh_rep_levels, mesh_same_rep, mesh_up_rep, up_gnns, same_gnns
    ):
        """Up sweep (reference: hi_lam.py:236-300)."""
        mesh_rep_levels[0], mesh_same_rep[0] = self._same_level(
            same_gnns[0], 0, mesh_rep_levels[0], mesh_same_rep
        )
        for level_l in range(1, self.num_levels):
            new_node_rep, mesh_up_rep[level_l - 1] = self.gnn_apply(
                up_gnns[level_l - 1],
                self.graph.up[level_l - 1],
                send_rep=mesh_rep_levels[level_l - 1],
                rec_rep=mesh_rep_levels[level_l],
                edge_rep=mesh_up_rep[level_l - 1],
                name=f"mesh_up.{level_l - 1}",
                update_edges=True,
                propagation=self.up_propagation,
            )
            mesh_rep_levels[level_l], mesh_same_rep[level_l] = self._same_level(
                same_gnns[level_l], level_l, new_node_rep, mesh_same_rep
            )
        return mesh_rep_levels, mesh_same_rep, mesh_up_rep

    def hi_processor_step(
        self, mesh_rep_levels, mesh_same_rep, mesh_up_rep, mesh_down_rep
    ):
        """Down then Up sweep per processor layer (reference:
        hi_lam.py:302-360)."""
        for down, down_same, up, up_same in zip(
            self.mesh_down_gnns, self.mesh_down_same_gnns,
            self.mesh_up_gnns, self.mesh_up_same_gnns,
        ):
            mesh_rep_levels, mesh_same_rep, mesh_down_rep = self._mesh_down_step(
                mesh_rep_levels, mesh_same_rep, mesh_down_rep, down, down_same
            )
            mesh_rep_levels, mesh_same_rep, mesh_up_rep = self._mesh_up_step(
                mesh_rep_levels, mesh_same_rep, mesh_up_rep, up, up_same
            )
        return mesh_rep_levels, mesh_same_rep, mesh_up_rep, mesh_down_rep
