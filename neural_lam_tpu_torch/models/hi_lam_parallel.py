"""Hi-LAM-Parallel: all mesh edge sets processed in one GNN layer.

Counterpart of ``neural_lam_tpu/models/hi_lam_parallel.py`` (reference:
neural_lam/models/step_predictors/graph/hi_lam_parallel.py:16-209): each
processor layer updates every level at once from its same-level, up and
down edge sets ("sections"), with a separate edge MLP per section and a
separate node MLP per level (the SplitMLPs mechanism, reference:
neural_lam/gnn_layers.py:275-325).

The reference concatenates the sections into one global edge set over
the flattened node space. Here a layer is computed per section on the
section's own receiver-sorted edge set: the edge phase with the
section's MLP, the sum of the sections' aggregates per receiving level
in section order, then the level's node MLP and the residual. That is
the same function (it is the JAX package's ``_fused_sections_step``),
and it keeps every edge set in the sorted order the kernels walk. The
edge phase is the fused one (K1, K3) when the edge MLP has the shape K3
implements, and the unfused one (K1, K6, the MLP, K5) otherwise.
"""

from __future__ import annotations

from torch import nn

from ..ops.interaction import (
    chunk_mlps,
    fused_edge_phase,
    fused_edge_phase_supported,
    unfused_edge_phase,
)
from ..ops.mlp import apply_mlp_split_first
from .hierarchical import BaseHiGraphModel


class HiLAMParallel(BaseHiGraphModel):
    """Parallel hierarchical message passing over per-section edge
    phases."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        levels, gaps = self.num_levels, self.num_levels - 1
        # Each section's sender and receiver level, in section order
        self._section_send_levels = (
            list(range(levels)) + list(range(gaps)) + [l + 1 for l in range(gaps)]
        )
        self._section_recv_levels = (
            list(range(levels)) + [l + 1 for l in range(gaps)] + list(range(gaps))
        )
        # "processor.module_<i>" as in the reference's pyg Sequential
        self.processor = nn.ModuleDict(
            {
                f"module_{i}": self._gnn(
                    num_edge_chunks=levels + 2 * gaps, num_aggr_chunks=levels
                )
                for i in range(self.processor_layers)
            }
        )
        self._place()

    @property
    def _sections(self) -> list:
        """The mesh edge sets of the model's graph (on its device) in
        section order: all same-level, then up, then down (reference:
        hi_lam_parallel.py:122-124)."""
        g = self.graph
        return [*g.m2m, *g.up, *g.down]

    def _sections_step(self, net, mesh_rep_levels, edge_reps, edge_phase):
        """One processor layer as per-section edge phases: every section
        has its own edge MLP, a level's aggregate is the sum of its
        incoming sections' sums, and one node MLP per level applies
        after. A section's senders go through ``ge.sender_rows`` (the halo
        exchange on a shard, as the JAX package's ``_sharded_combined``
        exchanges per section)."""
        agg = [None] * self.num_levels
        new_edges = []
        for k, (ge, mlp) in enumerate(zip(self._sections, chunk_mlps(net.edge_mlp))):
            a, new_edge = edge_phase(
                mlp,
                ge.edges,
                ge.sender_rows(mesh_rep_levels[self._section_send_levels[k]]),
                mesh_rep_levels[self._section_recv_levels[k]],
                edge_reps[k],
                update_edges=True,
            )
            rl = self._section_recv_levels[k]
            agg[rl] = a if agg[rl] is None else agg[rl] + a
            new_edges.append(new_edge)
        new_levels = []
        for rep, a, mlp in zip(mesh_rep_levels, agg, chunk_mlps(net.aggr_mlp)):
            if rep.dim() < a.dim():  # an unbatched level under batched sums
                rep = rep.unsqueeze(1)
            new_levels.append(rep + apply_mlp_split_first(mlp, (rep, a)))
        return new_levels, new_edges

    def hi_processor_step(
        self, mesh_rep_levels, mesh_same_rep, mesh_up_rep, mesh_down_rep
    ):
        """All levels and edge sets at once, layer by layer (reference:
        hi_lam_parallel.py:147-209)."""
        levels = self.num_levels
        edge_reps = mesh_same_rep + mesh_up_rep + mesh_down_rep
        # Every processor layer has identically shaped MLPs, so the first
        # layer's sections decide the route for all of them.
        first = next(iter(self.processor.values()))
        use_fused = all(
            fused_edge_phase_supported(
                mlp,
                ge.edges,
                mesh_rep_levels[self._section_send_levels[k]],
                mesh_rep_levels[self._section_recv_levels[k]],
                edge_reps[k],
            )
            for k, (ge, mlp) in enumerate(
                zip(self._sections, chunk_mlps(first.edge_mlp))
            )
        )
        edge_phase = fused_edge_phase if use_fused else unfused_edge_phase
        for net in self.processor.values():
            mesh_rep_levels, edge_reps = self._sections_step(
                net, mesh_rep_levels, edge_reps, edge_phase
            )
        return (
            list(mesh_rep_levels),
            edge_reps[:levels],
            edge_reps[levels : 2 * levels - 1],
            edge_reps[2 * levels - 1 :],
        )
