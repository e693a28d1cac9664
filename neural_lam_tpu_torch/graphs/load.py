"""Graph loading and normalisation.

Mirrors the reference loader semantics
(reference: neural_lam/utils.py:259-535):

- mesh node coordinate features are divided by the grid's max x/y span,
- all edge features are divided by the longest m2m edge (column 0 of the
  edge features is the edge length),
- a graph is hierarchical iff it stores more than one m2m level.

Returns plain numpy arrays; conversion to padded :class:`EdgeSet`s happens
in the model layer (``models/graph_buffers.py``).
"""

from __future__ import annotations

import json
import warnings
from pathlib import Path
from typing import Any

import numpy as np

from .build import (
    CURRENT_GRAPH_SPEC_VERSION,
    GRAPH_FILENAME,
    METAINFO_FILENAME,
)


def _read_metainfo(path: Path) -> dict:
    """Metainfo written by the port is JSON; graphs written by
    ``neural_lam_tpu`` are YAML, read with PyYAML where it is installed."""
    text = path.read_text(encoding="utf-8")
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        import yaml

        return yaml.safe_load(text)


def load_graph(
    graph_dir_path: str | Path, mesh_node_features_scaling: float
) -> tuple[bool, dict[str, Any]]:
    """Load all graph tensors from ``graph_dir_path``.

    Returns ``(hierarchical, graph_dict)`` with keys
    ``g2m_edge_index``/``m2g_edge_index`` (``(2, E)`` int32),
    ``g2m_features``/``m2g_features`` (``(E, 3)`` float32),
    ``m2m_edge_index``/``m2m_features``/``mesh_static_features`` (single
    arrays for flat graphs, lists per level for hierarchical ones) and the
    hierarchical-only ``mesh_up_*``/``mesh_down_*`` lists.
    """
    graph_dir_path = Path(graph_dir_path)
    meta_path = graph_dir_path / METAINFO_FILENAME
    if not meta_path.exists():
        raise FileNotFoundError(f"Missing {METAINFO_FILENAME} in {graph_dir_path}")
    meta = _read_metainfo(meta_path)
    spec = meta.get("spec_version")
    if spec != CURRENT_GRAPH_SPEC_VERSION:
        raise ValueError(
            f"Unsupported graph spec version {spec!r} "
            f"(expected {CURRENT_GRAPH_SPEC_VERSION!r})"
        )

    with np.load(graph_dir_path / GRAPH_FILENAME) as data:
        arrays = {k: data[k] for k in data.files}

    n_levels = int(meta["n_levels"])
    hierarchical = n_levels > 1

    def edge_index(name: str) -> np.ndarray:
        return np.stack(
            [arrays[f"{name}_senders"], arrays[f"{name}_receivers"]]
        ).astype(np.int32)

    m2m_edge_index = [edge_index(f"m2m__{lev}") for lev in range(n_levels)]
    m2m_features = [
        arrays[f"m2m__{lev}_features"].astype(np.float32)
        for lev in range(n_levels)
    ]
    mesh_static_features = [
        arrays[f"mesh_features__{lev}"].astype(np.float32).copy()
        for lev in range(n_levels)
    ]

    # Normalise mesh coordinates by the grid's max span
    # (reference: utils.py:404-416). Graphs converted from the
    # reference's legacy format store already-normalized coordinates
    # (convert_graph.py marks them), so their scaling is skipped —
    # same rule as the reference loader (utils.py:395-403).
    if not meta.get("mesh_features_prenormalized", False):
        if mesh_node_features_scaling == 0:
            warnings.warn(
                "Mesh node feature scaling is zero; falling back to 1.0",
                RuntimeWarning,
                stacklevel=2,
            )
            mesh_node_features_scaling = 1.0
        for m in mesh_static_features:
            m[:, :2] /= mesh_node_features_scaling

    # Normalise all edge features by the longest m2m edge
    # (reference: utils.py:455-463).
    longest_edge = max(float(f[:, 0].max()) for f in m2m_features)
    m2m_features = [f / longest_edge for f in m2m_features]
    g2m_features = arrays["g2m_features"].astype(np.float32) / longest_edge
    m2g_features = arrays["m2g_features"].astype(np.float32) / longest_edge

    g2m_edge_index = edge_index("g2m")
    m2g_edge_index = edge_index("m2g")
    assert g2m_edge_index.min() >= 0, "Negative node index in g2m"
    assert m2g_edge_index.min() >= 0, "Negative node index in m2g"

    graph: dict[str, Any] = {
        "g2m_edge_index": g2m_edge_index,
        "m2g_edge_index": m2g_edge_index,
        "g2m_features": g2m_features,
        "m2g_features": m2g_features,
    }

    if hierarchical:
        graph["m2m_edge_index"] = m2m_edge_index
        graph["m2m_features"] = m2m_features
        graph["mesh_static_features"] = mesh_static_features
        graph["mesh_up_edge_index"] = [
            edge_index(f"mesh_up__{lev}") for lev in range(n_levels - 1)
        ]
        graph["mesh_down_edge_index"] = [
            edge_index(f"mesh_down__{lev}") for lev in range(n_levels - 1)
        ]
        graph["mesh_up_features"] = [
            arrays[f"mesh_up__{lev}_features"].astype(np.float32)
            / longest_edge
            for lev in range(n_levels - 1)
        ]
        graph["mesh_down_features"] = [
            arrays[f"mesh_down__{lev}_features"].astype(np.float32)
            / longest_edge
            for lev in range(n_levels - 1)
        ]
    else:
        graph["m2m_edge_index"] = m2m_edge_index[0]
        graph["m2m_features"] = m2m_features[0]
        graph["mesh_static_features"] = mesh_static_features[0]
        graph["mesh_up_edge_index"] = []
        graph["mesh_down_edge_index"] = []
        graph["mesh_up_features"] = []
        graph["mesh_down_features"] = []

    return hierarchical, graph
