"""3-D graph visualisation: ``python -m neural_lam_tpu_torch.plot_graph``.

Counterpart of the reference's plotly-based graph viewer
(reference: neural_lam/plot_graph.py:17-297) on matplotlib's 3-D axes
(plotly is not a dependency of this build): grid nodes at z=0, mesh
levels stacked above with per-level z offsets, edges drawn as line
collections. Saves to a file (PNG/PDF) instead of opening a browser.

The port's own copy of ``neural_lam_tpu/plot_graph.py``. Host only, no
device. matplotlib is imported where the figure is drawn; without it
:func:`main` stops with one message.
"""

from __future__ import annotations

import argparse

import numpy as np

from .config import load_config_and_datastore
from .graphs import load_graph

GRID_Z = 0.0
MESH_LEVEL_DZ = 1.0  # z offset per mesh level (reference: plot_graph.py:17-19)
GRID_LIMIT_FRACTION = 0.2  # cap on plotted grid nodes for readability


def _edges_3d(pos_send, pos_recv, z_send, z_recv):
    segs = np.stack(
        [
            np.concatenate(
                [pos_send, np.full((len(pos_send), 1), z_send)], axis=1
            ),
            np.concatenate(
                [pos_recv, np.full((len(pos_recv), 1), z_recv)], axis=1
            ),
        ],
        axis=1,
    )
    return segs


def require_matplotlib(tool: str) -> None:
    """Stop ``tool`` with one message where matplotlib is not installed."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise SystemExit(
            f"{tool} draws with matplotlib, which is not installed ({e})"
        )


def plot_graph(
    datastore, graph_name: str = "multiscale", show_grid_edges: bool = False
):
    """Build the 3-D figure for a stored graph."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Line3DCollection

    graph_dir = datastore.root_path / "graph" / graph_name
    extent = datastore.get_xy_extent(category="state")
    span = max(extent[1] - extent[0], extent[3] - extent[2])
    hierarchical, g = load_graph(graph_dir, mesh_node_features_scaling=span)

    grid_xy = datastore.get_xy("state", stacked=True) / span
    if hierarchical:
        mesh_levels = [np.asarray(m[:, :2]) for m in g["mesh_static_features"]]
        m2m_sets = list(zip(g["m2m_edge_index"], range(len(mesh_levels))))
    else:
        mesh_levels = [np.asarray(g["mesh_static_features"][:, :2])]
        m2m_sets = [(g["m2m_edge_index"], 0)]

    fig = plt.figure(figsize=(12, 10))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(
        grid_xy[:, 0], grid_xy[:, 1], GRID_Z, s=1, c="dimgray", alpha=0.3,
        label="grid",
    )
    colors = plt.cm.viridis(np.linspace(0.2, 0.9, len(mesh_levels)))
    for lev, mesh in enumerate(mesh_levels):
        z = GRID_Z + MESH_LEVEL_DZ * (lev + 1)
        ax.scatter(
            mesh[:, 0], mesh[:, 1], z, s=8, color=colors[lev],
            label=f"mesh level {lev}",
        )
    for (edge_index, lev) in m2m_sets:
        mesh = mesh_levels[lev]
        z = GRID_Z + MESH_LEVEL_DZ * (lev + 1)
        segs = _edges_3d(
            mesh[edge_index[0]], mesh[edge_index[1]], z, z
        )
        ax.add_collection3d(
            Line3DCollection(
                segs, colors=colors[lev], linewidths=0.3, alpha=0.4
            )
        )
    for lev, edge_index in enumerate(g.get("mesh_up_edge_index", [])):
        lower, upper = mesh_levels[lev], mesh_levels[lev + 1]
        segs = _edges_3d(
            lower[edge_index[0]],
            upper[edge_index[1]],
            GRID_Z + MESH_LEVEL_DZ * (lev + 1),
            GRID_Z + MESH_LEVEL_DZ * (lev + 2),
        )
        ax.add_collection3d(
            Line3DCollection(segs, colors="tab:red", linewidths=0.3,
                             alpha=0.3)
        )
    if show_grid_edges:
        # g2m edges, subsampled for readability
        ei = g["g2m_edge_index"]
        keep = np.arange(0, ei.shape[1], max(1, ei.shape[1] // 2000))
        mesh0 = mesh_levels[0]
        segs = _edges_3d(
            grid_xy[ei[0][keep]], mesh0[ei[1][keep]],
            GRID_Z, GRID_Z + MESH_LEVEL_DZ,
        )
        ax.add_collection3d(
            Line3DCollection(segs, colors="tab:blue", linewidths=0.2,
                             alpha=0.2)
        )
    ax.set_title(f"graph {graph_name!r} ({graph_dir})")
    ax.legend(loc="upper left", fontsize=8)
    return fig


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Plot a stored mesh graph")
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--graph", type=str, default="multiscale")
    parser.add_argument(
        "--save", type=str, default="graph.png",
        help="Output image path (PNG/PDF)",
    )
    parser.add_argument("--show_grid_edges", action="store_true")
    args = parser.parse_args(argv)
    require_matplotlib("plot_graph")
    _, datastore = load_config_and_datastore(args.config_path)
    fig = plot_graph(
        datastore, args.graph, show_grid_edges=args.show_grid_edges
    )
    fig.savefig(args.save, dpi=200, bbox_inches="tight")
    print(f"Saved graph plot to {args.save}")


if __name__ == "__main__":
    main()
