"""Frozen copy of the port's NumPy graph builder.

Copied from ``neural_lam_tpu_torch/graphs/build.py`` at commit feda1b7
(``create_graph`` and ``save_graph``; ``create_graph_from_datastore`` left
out), so that the benchmark makes its graphs with code that later changes
to the program cannot move. It writes the port's graph storage format,
``docs/graph_storage_spec.md`` (``graph.npz`` and ``metainfo.yaml``,
``spec_version: tpu-0.1.0``), which the port loads through its own
``graphs/load.py``.

The original's notes follow.

Reproduces the geometry of the reference graph construction
(reference: neural_lam/create_graph.py:357-861) with direct numpy index
arithmetic instead of networkx graph objects:

- mesh levels: ``nx=3`` coarsening,
  ``nlev = int(np.log(max(Nx, Ny)) / np.log(3))`` — the reference's
  exact fp expression (create_graph.py:439-446), kept bit-compatible
  rather than a true floor(log3): at max(Nx, Ny)=243 both give 4 (not
  the mathematical 5) because np.log(243)/np.log(3) = 4.9999...,
  level ``l`` is an ``n x n`` quad grid (``n = 3**(nlev-l)``) placed with
  half-cell offsets inside the grid extent; edges are the 4-neighbourhood
  plus both diagonals, directed both ways,
- multiscale: all levels merged onto the bottom-level node set (coarse
  nodes coincide with bottom nodes at stride ``3**(l-1)``, offset
  ``(3**(l-1)-1)/2``),
- hierarchical: levels kept separate with 1-NN up edges (KDTree) and
  mirrored down edges,
- g2m: grid->mesh edges within radius ``0.67 * dm`` of each bottom-mesh
  node (``dm`` = bottom-mesh x spacing),
- m2g: 4-NN mesh->grid edges.

Edge features are ``[length, dx, dy]`` with the coordinate difference
``sender_pos - receiver_pos`` (raw units; normalisation happens at load
time, matching the current reference graph spec).

Storage: one ``graph.npz`` per graph directory plus ``metainfo.yaml`` with
``spec_version: tpu-0.1.0``. The port writes the metainfo as JSON, which
is valid YAML, so graphs built here load in ``neural_lam_tpu`` and the
port needs no YAML library.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional

import numpy as np
import scipy.spatial

METAINFO_FILENAME = "metainfo.yaml"
GRAPH_FILENAME = "graph.npz"
CURRENT_GRAPH_SPEC_VERSION = "tpu-0.1.0"
_MESH_COARSENING_FACTOR = 3
_G2M_RADIUS_SCALE = 0.67  # reference: create_graph.py:697
_M2G_NUM_NEIGHBOURS = 4  # reference: create_graph.py:781


def _mesh_level_positions(xy: np.ndarray, n: int) -> np.ndarray:
    """Positions of an ``n x n`` mesh level, shape ``(n, n, 2)`` (x-major).

    Nodes sit half a cell inside the grid extent
    (reference: create_graph.py:297-306).
    """
    xm, xM = float(xy[:, :, 0][:, 0].min()), float(xy[:, :, 0][:, 0].max())
    ym, yM = float(xy[:, :, 1][0, :].min()), float(xy[:, :, 1][0, :].max())
    dx = (xM - xm) / n
    dy = (yM - ym) / n
    lx = np.linspace(xm + dx / 2, xM - dx / 2, n)
    ly = np.linspace(ym + dy / 2, yM - dy / 2, n)
    return np.stack(np.meshgrid(lx, ly, indexing="ij"), axis=-1)


# Directed neighbour offsets: 4-neighbourhood + both diagonals, both ways.
_NEIGHBOUR_OFFSETS = np.array(
    [
        (1, 0),
        (-1, 0),
        (0, 1),
        (0, -1),
        (1, 1),
        (-1, -1),
        (1, -1),
        (-1, 1),
    ],
    dtype=np.int64,
)


def _quad_grid_edges(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Directed (senders, receivers) for an ``n x n`` diagonal quad grid.

    Node index is x-major: ``idx = i * n + j``.
    """
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    base = np.stack([ii.ravel(), jj.ravel()], axis=1)  # (n*n, 2)
    senders = []
    receivers = []
    for di, dj in _NEIGHBOUR_OFFSETS:
        ni = base[:, 0] + di
        nj = base[:, 1] + dj
        valid = (ni >= 0) & (ni < n) & (nj >= 0) & (nj < n)
        senders.append(base[valid, 0] * n + base[valid, 1])
        receivers.append(ni[valid] * n + nj[valid])
    return (
        np.concatenate(senders).astype(np.int32),
        np.concatenate(receivers).astype(np.int32),
    )


def _edge_features(
    pos_send: np.ndarray, pos_recv: np.ndarray
) -> np.ndarray:
    """``[length, dx, dy]`` with vdiff = sender - receiver (float32)."""
    vdiff = pos_send - pos_recv
    length = np.sqrt((vdiff**2).sum(axis=-1, keepdims=True))
    return np.concatenate([length, vdiff], axis=-1).astype(np.float32)


def create_graph(
    graph_dir_path: str | Path,
    xy: np.ndarray,
    n_max_levels: Optional[int] = None,
    hierarchical: bool = False,
    grid_pos_stacked: Optional[np.ndarray] = None,
) -> dict:
    """Create graph components for the ``(Nx, Ny, 2)`` grid coordinates.

    Writes ``graph.npz`` + ``metainfo.yaml`` into ``graph_dir_path`` and
    returns the raw component dict (see :func:`save_graph` for keys).

    ``grid_pos_stacked`` gives the grid positions in the DATASTORE's
    ``grid_index`` order (``stack_grid_coords`` semantics) — required
    whenever that order is not x-major (y-major mdp zarr stores,
    mdp.py:260-267): g2m/m2g edges index grid nodes by ``grid_index``,
    and an x-major flatten of a y-major store would silently connect
    spatially wrong grid points. Defaults to the x-major flatten.
    """
    assert xy.ndim == 3 and xy.shape[-1] == 2, "xy must be (Nx, Ny, 2)"
    nx_f = _MESH_COARSENING_FACTOR
    nlev = int(np.log(max(xy.shape[:2])) / np.log(nx_f))
    nleaf = nx_f**nlev
    mesh_levels = nlev - 1
    if n_max_levels:
        mesh_levels = min(mesh_levels, n_max_levels)
    if mesh_levels < 1:
        raise ValueError(
            f"Grid of shape {xy.shape[:2]} is too small to build a mesh "
            f"(needs max(Nx, Ny) >= {nx_f**2})"
        )
    if hierarchical and mesh_levels < 2:
        # Loading derives hierarchy from n_levels > 1 (graphs/load.py),
        # so a 1-level "hierarchical" graph would silently load as flat
        # with empty up/down sets; fail here with the reason instead.
        raise ValueError(
            f"hierarchical graph needs >= 2 mesh levels, but grid "
            f"{xy.shape[:2]} (with n_max_levels={n_max_levels}) "
            "yields only 1 — build a flat graph or enlarge the grid"
        )

    # Per-level square mesh sizes, bottom (level index 0) first.
    level_ns = [nleaf // (nx_f**lev) for lev in range(1, mesh_levels + 1)]
    level_pos = [_mesh_level_positions(xy, n) for n in level_ns]
    level_edges = [_quad_grid_edges(n) for n in level_ns]

    graph: dict = {"hierarchical": hierarchical}

    if hierarchical:
        m2m = []
        mesh_features = []
        for pos, (snd, rcv) in zip(level_pos, level_edges):
            flat = pos.reshape(-1, 2)
            m2m.append(
                (snd, rcv, _edge_features(flat[snd], flat[rcv]))
            )
            mesh_features.append(flat.astype(np.float32))

        up, down = [], []
        for lower, upper in zip(level_pos[:-1], level_pos[1:]):
            lower_flat = lower.reshape(-1, 2)
            upper_flat = upper.reshape(-1, 2)
            kdt = scipy.spatial.KDTree(upper_flat)
            # 1-NN parent for every lower node (reference: :491-510)
            _, parent = kdt.query(lower_flat, 1)
            snd = np.arange(lower_flat.shape[0], dtype=np.int32)
            rcv = parent.astype(np.int32)
            up.append(
                (snd, rcv, _edge_features(lower_flat[snd], upper_flat[rcv]))
            )
            down.append(
                (rcv, snd, _edge_features(upper_flat[rcv], lower_flat[snd]))
            )
        graph["m2m"] = m2m
        graph["mesh_features"] = mesh_features
        graph["mesh_up"] = up
        graph["mesh_down"] = down
        bottom_pos = level_pos[0].reshape(-1, 2)
    else:
        # Multiscale: map every level onto the bottom-level node set.
        # Level l (0-based) nodes coincide with bottom nodes at
        # offset (3**l - 1) / 2 and stride 3**l in each axis.
        n1 = level_ns[0]
        bottom_pos = level_pos[0].reshape(-1, 2)
        senders_all, receivers_all, feats_all = [], [], []
        for lev, (n_l, (snd, rcv)) in enumerate(zip(level_ns, level_edges)):
            stride = nx_f**lev
            offset = (stride - 1) // 2
            # map level-l (i, j) -> bottom index
            li = snd // n_l
            lj = snd % n_l
            ri = rcv // n_l
            rj = rcv % n_l
            snd_b = (offset + stride * li) * n1 + (offset + stride * lj)
            rcv_b = (offset + stride * ri) * n1 + (offset + stride * rj)
            senders_all.append(snd_b.astype(np.int32))
            receivers_all.append(rcv_b.astype(np.int32))
            flat = level_pos[lev].reshape(-1, 2)
            feats_all.append(_edge_features(flat[snd], flat[rcv]))
        m2m_snd = np.concatenate(senders_all)
        m2m_rcv = np.concatenate(receivers_all)
        m2m_feat = np.concatenate(feats_all)
        graph["m2m"] = [(m2m_snd, m2m_rcv, m2m_feat)]
        graph["mesh_features"] = [bottom_pos.astype(np.float32)]
        graph["mesh_up"] = []
        graph["mesh_down"] = []

    # g2m / m2g operate on the bottom mesh (all nodes for multiscale).
    Nx, Ny = xy.shape[:2]
    if grid_pos_stacked is not None:
        assert grid_pos_stacked.shape == (Nx * Ny, 2)
        grid_pos = np.asarray(grid_pos_stacked)
    else:
        grid_pos = xy.reshape(-1, 2)  # x-major grid_index order
    # dm: x spacing of the bottom mesh (reference: create_graph.py:703-705
    # measures nodes (1, 0) and (0, 0), i.e. x neighbours).
    n_bottom = level_ns[0]
    dm = float(
        np.sqrt(
            ((bottom_pos[n_bottom] - bottom_pos[0]) ** 2).sum()
        )
    )

    kdt_grid = scipy.spatial.KDTree(grid_pos)
    g2m_snd, g2m_rcv = [], []
    for mesh_idx in range(bottom_pos.shape[0]):
        neigh = kdt_grid.query_ball_point(
            bottom_pos[mesh_idx], dm * _G2M_RADIUS_SCALE
        )
        for g in neigh:
            g2m_snd.append(g)
            g2m_rcv.append(mesh_idx)
    g2m_snd = np.asarray(g2m_snd, dtype=np.int32)
    g2m_rcv = np.asarray(g2m_rcv, dtype=np.int32)
    graph["g2m"] = (
        g2m_snd,
        g2m_rcv,
        _edge_features(grid_pos[g2m_snd], bottom_pos[g2m_rcv]),
    )

    kdt_mesh = scipy.spatial.KDTree(bottom_pos)
    _, m2g_snd = kdt_mesh.query(grid_pos, _M2G_NUM_NEIGHBOURS)
    m2g_rcv = np.repeat(
        np.arange(Nx * Ny, dtype=np.int32), _M2G_NUM_NEIGHBOURS
    )
    m2g_snd = m2g_snd.reshape(-1).astype(np.int32)
    graph["m2g"] = (
        m2g_snd,
        m2g_rcv,
        _edge_features(bottom_pos[m2g_snd], grid_pos[m2g_rcv]),
    )

    save_graph(graph, graph_dir_path)
    return graph


def save_graph(graph: dict, graph_dir_path: str | Path) -> None:
    """Persist a graph component dict as ``graph.npz`` + metainfo."""
    graph_dir_path = Path(graph_dir_path)
    os.makedirs(graph_dir_path, exist_ok=True)

    arrays: dict[str, np.ndarray] = {}

    def put_edges(name: str, triple) -> None:
        snd, rcv, feat = triple
        arrays[f"{name}_senders"] = np.asarray(snd, dtype=np.int32)
        arrays[f"{name}_receivers"] = np.asarray(rcv, dtype=np.int32)
        arrays[f"{name}_features"] = np.asarray(feat, dtype=np.float32)

    put_edges("g2m", graph["g2m"])
    put_edges("m2g", graph["m2g"])
    for lev, triple in enumerate(graph["m2m"]):
        put_edges(f"m2m__{lev}", triple)
    for lev, feat in enumerate(graph["mesh_features"]):
        arrays[f"mesh_features__{lev}"] = np.asarray(feat, dtype=np.float32)
    for lev, triple in enumerate(graph.get("mesh_up", [])):
        put_edges(f"mesh_up__{lev}", triple)
    for lev, triple in enumerate(graph.get("mesh_down", [])):
        put_edges(f"mesh_down__{lev}", triple)

    np.savez_compressed(graph_dir_path / GRAPH_FILENAME, **arrays)
    meta = {
        "spec_version": CURRENT_GRAPH_SPEC_VERSION,
        "hierarchical": bool(graph["hierarchical"]),
        "n_levels": len(graph["m2m"]),
    }
    (graph_dir_path / METAINFO_FILENAME).write_text(
        json.dumps(meta, sort_keys=True) + "\n", encoding="utf-8"
    )
