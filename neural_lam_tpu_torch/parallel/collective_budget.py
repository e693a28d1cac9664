"""Per-step collective payloads of the sharded executor, and a projection.

Counterpart of ``neural_lam_tpu/parallel/collective_budget.py``. Two
sources, held against each other:

- :func:`analytic_budget` (ported as it is) computes the exchange bytes of
  each edge set per training step from the partition's
  :class:`~.spatial.EdgeMeta` alone. ``rows_per_exchange`` is what the
  shard with the most halo rows receives; the port sends each halo at its
  exact size, so ``bytes_per_step_shards`` adds up what every shard of the
  group receives.
- :func:`recorded_table` tabulates the collectives the exchanges issued
  while ``spatial.record_collectives`` was active (operation, edge set,
  direction, the rows and bytes this rank received). It takes the place of
  the JAX package's ``hlo_collective_table``, which reads XLA's compiled
  HLO: the port issues its collectives itself, so it records them.

:func:`projected_efficiency` projects the scaling efficiency at ``P``
cards from a measured one-card step time, the bytes per step and a link
bandwidth that the caller measures on its own machine: there is no
bandwidth constant here.

``python -m neural_lam_tpu_torch.parallel.collective_budget`` writes the
analytic table at MEPS size (the 268x238 grid and its multiscale and
hierarchical graphs, batch 4 per data rank, hidden 64, float32) for ``P``
= 2, 4 and 8, on the CPU: the partition needs no card.
"""

from __future__ import annotations

import argparse
from collections import defaultdict
from typing import Optional, Sequence

# fixed cost per collective launch in the projection's latency term
COLLECTIVE_LATENCY_S = 1e-6


def analytic_budget(
    metas: dict,
    batch_local: int,
    hidden_dim: int,
    itemsize: int = 4,
    rounds: Optional[dict] = None,
) -> list[dict]:
    """Expected exchange bytes per edge set per training step, from the
    partition metadata alone (``neural_lam_tpu/parallel/collective_budget.py:174-210``).
    ``rounds`` maps edge-set name -> exchanges per FORWARD (default 1;
    GraphLAM's m2m runs once per processor layer); the backward mirrors
    each exchange (the all-to-all's backward is the all-to-all with the
    splits swapped, the all-gather's a reduce-scatter of the same size),
    hence the x2. ``bytes_per_step`` is for the shard that receives the
    most, ``bytes_per_step_shards`` the sum over the group's shards."""
    rounds = rounds or {}
    out = []
    for name, meta in metas.items():
        n_ex = rounds.get(name, 1) * 2
        per_row = batch_local * hidden_dim * itemsize
        shards = range(meta.n_shards)
        if meta.strategy == "all_gather":
            rows_moved = meta.n_send_local * (meta.n_shards - 1)
            n_coll = 1 if meta.n_shards > 1 else 0
        else:
            rows_moved = max((meta.recv_rows(s) for s in shards), default=0)
            n_coll = 1 if meta.offsets and meta.n_shards > 1 else 0
        out.append(
            {
                "edge_set": name,
                "strategy": meta.strategy,
                "offsets": list(meta.offsets),
                "rows_per_exchange": rows_moved,
                "exchanges_per_step": n_ex,
                "collectives_per_step": n_coll * n_ex,
                "bytes_per_step": rows_moved * per_row * n_ex,
                "bytes_per_step_shards": sum(meta.recv_rows(s) for s in shards)
                * per_row * n_ex,
            }
        )
    return out


def recorded_table(records: Sequence[dict]) -> list[dict]:
    """The recorded collectives grouped by (edge set, operation,
    direction): count, rows and bytes this rank received."""
    rows: dict = defaultdict(lambda: dict(count=0, rows=0, bytes=0))
    for r in records:
        row = rows[(r["edge_set"], r["op"], r["direction"])]
        row["count"] += 1
        row["rows"] += r["rows"]
        row["bytes"] += r["bytes"]
    return [dict(edge_set=k[0], op=k[1], direction=k[2], **v) for k, v in sorted(rows.items())]


def recorded_bytes(records: Sequence[dict]) -> dict[str, int]:
    """Bytes received per edge set over the recorded collectives."""
    out: dict[str, int] = defaultdict(int)
    for r in records:
        out[r["edge_set"]] += r["bytes"]
    return dict(out)


def projected_efficiency(
    step_time_s: float,
    bytes_per_step: float,
    n_collectives: int,
    n_shards: int,
    link_bytes_s: float,
) -> dict:
    """Projected grid-points/s scaling efficiency at ``n_shards`` cards:
    compute shrinks as 1/P, communication is added serially (no overlap,
    a floor). ``link_bytes_s`` is a bandwidth measured on the machine."""
    t_comp = step_time_s / n_shards
    t_comm = bytes_per_step / link_bytes_s + n_collectives * COLLECTIVE_LATENCY_S
    return {
        "n_shards": n_shards,
        "t_comp_ms": t_comp * 1e3,
        "t_comm_ms": t_comm * 1e3,
        "efficiency": t_comp / (t_comp + t_comm),
    }


def format_markdown(analytic: Sequence[dict], header: str) -> str:
    lines = [f"## Collective budget: {header}", ""]
    lines += [
        "| edge set | strategy | offsets | rows/exchange | exchanges/step |"
        " bytes/step (largest shard) | bytes/step (all shards) |",
        "|---|---|---|---|---|---|---|",
    ]
    for a in analytic:
        lines.append(
            f"| {a['edge_set']} | {a['strategy']} | {a['offsets']} |"
            f" {a['rows_per_exchange']:,} | {a['exchanges_per_step']} |"
            f" {a['bytes_per_step']:,} | {a['bytes_per_step_shards']:,} |"
        )
    lines.append("")
    return "\n".join(lines)


def graph_metas(graph: dict, n_grid: int, n_shards: int, **rule) -> dict:
    """The partition metas of a loaded graph (``graphs.load.load_graph``'s
    dict) over ``n_shards``, by edge set name; ``rule`` passes
    ``all_gather_max_nodes`` and ``max_halo_offsets`` on."""
    import numpy as np

    from .spatial import build_edge_table

    hierarchical = isinstance(graph["m2m_edge_index"], (list, tuple))
    mesh = graph["mesh_static_features"]
    sizes = [int(np.asarray(m).shape[0]) for m in (mesh if hierarchical else [mesh])]
    local = [-(-n // n_shards) for n in sizes]
    g_local = -(-n_grid // n_shards)
    m2m = graph["m2m_edge_index"] if hierarchical else [graph["m2m_edge_index"]]
    sets = [("g2m", graph["g2m_edge_index"], n_grid, g_local, local[0]),
            ("m2g", graph["m2g_edge_index"], sizes[0], local[0], g_local)]
    sets += [(f"m2m{l}", ei, sizes[l], local[l], local[l]) for l, ei in enumerate(m2m)]
    if hierarchical:
        sets += [(f"up{l}", ei, sizes[l], local[l], local[l + 1])
                 for l, ei in enumerate(graph["mesh_up_edge_index"])]
        sets += [(f"down{l}", ei, sizes[l + 1], local[l + 1], local[l])
                 for l, ei in enumerate(graph["mesh_down_edge_index"])]
    metas = {}
    for name, ei, n_send, n_send_local, n_rec_local in sets:
        ei = np.asarray(ei)
        metas[name], _ = build_edge_table(name, ei[0], ei[1], n_send, n_send_local,
                                          n_rec_local, n_shards, **rule)
    return metas


def meps_metas(n_shards: int, hierarchical: bool, root) -> tuple[dict, dict]:
    """The partition metas of the MEPS-size graph (written once under
    ``root``) at ``n_shards``, and GraphLAM's or HiLAM's forward rounds
    per edge set (4 processor layers)."""
    from pathlib import Path

    from ..datastore.dummy import DummyDatastore
    from ..graphs import create_graph_from_datastore
    from ..graphs.load import load_graph

    root = Path(root)
    ds = DummyDatastore(n_grid_x=268, n_grid_y=238, n_timesteps=8, root_path=root)
    path = root / "graph" / ("hierarchical" if hierarchical else "multiscale")
    if not (path / "graph.npz").exists():
        create_graph_from_datastore(ds, path, hierarchical=hierarchical)
    _, graph = load_graph(path, mesh_node_features_scaling=1.0)
    metas = graph_metas(graph, ds.num_grid_points, n_shards)
    layers = 4
    if hierarchical:
        levels = sum(name.startswith("m2m") for name in metas)
        rounds = {f"m2m{l}": 2 * layers for l in range(levels)}
        rounds.update({f"up{l}": 1 + layers for l in range(levels - 1)})
        rounds.update({f"down{l}": 1 + layers for l in range(levels - 1)})
    else:
        rounds = {"m2m0": layers}
    return metas, rounds


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None, help="markdown file (default: stdout)")
    parser.add_argument("--root", default=".bench_cache/collective_budget",
                        help="where the MEPS-size graphs are written once")
    parser.add_argument("--shards", type=int, nargs="+", default=[2, 4, 8])
    parser.add_argument("--batch_local", type=int, default=4)
    parser.add_argument("--hidden_dim", type=int, default=64)
    args = parser.parse_args(argv)
    parts = []
    for hierarchical in (False, True):
        for p in args.shards:
            metas, rounds = meps_metas(p, hierarchical, args.root)
            table = analytic_budget(metas, args.batch_local, args.hidden_dim, rounds=rounds)
            total = sum(a["bytes_per_step"] for a in table)
            model = "HiLAM (hierarchical graph)" if hierarchical else "GraphLAM (multiscale)"
            parts.append(format_markdown(
                table, f"{model}, MEPS 268x238, P={p}, batch {args.batch_local} per data "
                f"rank, hidden {args.hidden_dim}, float32; largest shard {total:,} bytes "
                "per training step"))
    text = "\n".join(parts)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text)
    else:
        print(text)


if __name__ == "__main__":
    main()
