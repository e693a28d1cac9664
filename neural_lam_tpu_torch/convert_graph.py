"""Convert reference ``.pt`` graph directories to the npz format.

The reference stores graphs as ``torch.save``'d tensors
(``{g2m,m2g}_edge_index/features.pt`` single tensors,
``m2m_edge_index/features.pt`` + ``mesh_features.pt`` lists, and for
hierarchical graphs ``mesh_{up,down}_edge_index/features.pt`` lists)
in either the spec-0.1.0 layout (zero-based per-node-set indices,
``metainfo.yaml``; reference: docs/graph_storage_spec.md:29-256) or the
legacy pre-spec layout with combined node-index offsets that the
reference fixes up on load (reference: neural_lam/utils.py:134-256,
340-487). This converter reproduces those fixups in numpy and writes
the graph in this framework's ``graph.npz`` spec, so graphs built with
the reference's ``create_graph`` CLI are directly usable here.

Legacy graphs store mesh coordinates already normalized; the converter
marks this in ``metainfo.yaml`` (``mesh_features_prenormalized``) so
the loader skips its own span normalization for them.

CLI: ``python -m neural_lam_tpu_torch.convert_graph <ref_graph_dir> <out_dir>``

The port's own copy of ``neural_lam_tpu/convert_graph.py``: the same
reference directory gives the same ``graph.npz``. Host only, no device.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .graphs.build import (
    CURRENT_GRAPH_SPEC_VERSION,
    METAINFO_FILENAME,
    save_graph,
)

REFERENCE_SPEC_VERSION = "0.1.0"


def _zero_index_edge_index(ei: np.ndarray) -> np.ndarray:
    """Per-row min subtraction (reference: utils.py:134-149)."""
    return ei - ei.min(axis=1, keepdims=True)


def _zero_index_g2m(
    ei: np.ndarray, num_mesh_nodes: int, num_grid_nodes: int,
    mesh_first: bool,
) -> np.ndarray:
    """reference: utils.py:205-256 (grid count passed explicitly; the
    reference derives it from ``g2m[0].max()+1``, which undercounts
    when boundary grid nodes send no g2m edge)."""
    if mesh_first:
        return np.stack([ei[0] - num_mesh_nodes, ei[1]])
    return np.stack([ei[0], ei[1] - num_grid_nodes])


def _zero_index_m2g(
    ei: np.ndarray, num_mesh_nodes: int, num_grid_nodes: int,
    mesh_first: bool,
) -> np.ndarray:
    """reference: utils.py:151-203."""
    if mesh_first:
        return np.stack([ei[0], ei[1] - num_mesh_nodes])
    return np.stack([ei[0] - num_grid_nodes, ei[1]])


def _as_list(obj) -> list:
    return list(obj) if isinstance(obj, (list, tuple)) else [obj]


def _load_pt(path: Path):
    return torch.load(path, weights_only=True, map_location="cpu")


def _np(t) -> np.ndarray:
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def convert_reference_graph(
    ref_dir: str | Path, out_dir: str | Path
) -> dict:
    """Convert one reference graph directory; returns the graph dict."""
    import yaml  # where the files are read, as in config.load_config

    ref_dir = Path(ref_dir)
    meta_path = ref_dir / METAINFO_FILENAME
    legacy = True
    if meta_path.exists():
        meta = yaml.safe_load(meta_path.read_text(encoding="utf-8")) or {}
        spec = meta.get("spec_version")
        if spec == REFERENCE_SPEC_VERSION:
            legacy = False
        elif spec is not None and spec != REFERENCE_SPEC_VERSION:
            raise ValueError(
                f"Unsupported reference graph spec {spec!r} "
                f"(supported: {REFERENCE_SPEC_VERSION!r} or legacy)"
            )

    mesh_features = [
        _np(t).astype(np.float32)
        for t in _as_list(_load_pt(ref_dir / "mesh_features.pt"))
    ]
    num_mesh_nodes = sum(m.shape[0] for m in mesh_features)

    m2m_ei = [
        _np(t).astype(np.int64)
        for t in _as_list(_load_pt(ref_dir / "m2m_edge_index.pt"))
    ]
    m2m_feat = [
        _np(t).astype(np.float32)
        for t in _as_list(_load_pt(ref_dir / "m2m_features.pt"))
    ]
    g2m_ei = _np(_load_pt(ref_dir / "g2m_edge_index.pt")).astype(np.int64)
    m2g_ei = _np(_load_pt(ref_dir / "m2g_edge_index.pt")).astype(np.int64)
    g2m_feat = _np(_load_pt(ref_dir / "g2m_features.pt")).astype(np.float32)
    m2g_feat = _np(_load_pt(ref_dir / "m2g_features.pt")).astype(np.float32)

    if legacy:
        # Combined-offset layout -> per-node-set zero-based indices
        # (reference: utils.py:425-441)
        m2m_ei = [_zero_index_edge_index(ei) for ei in m2m_ei]
        m2g_min = m2g_ei.min(axis=1)
        mesh_first = bool(m2g_min[0] < m2g_min[1])
        # grid count from BOTH grid-indexed rows: m2g receivers (4-NN,
        # full coverage) guard against boundary grid nodes that send no
        # g2m edge, which would undercount via g2m alone
        if mesh_first:
            num_grid_nodes = 0  # unused in the mesh-first fixups
        else:
            num_grid_nodes = int(
                max(g2m_ei[0].max(), m2g_ei[1].max()) + 1
            )
        g2m_ei = _zero_index_g2m(
            g2m_ei, num_mesh_nodes, num_grid_nodes, mesh_first
        )
        m2g_ei = _zero_index_m2g(
            m2g_ei, num_mesh_nodes, num_grid_nodes, mesh_first
        )
    assert g2m_ei.min() >= 0, "Negative node index in g2m"
    assert m2g_ei.min() >= 0, "Negative node index in m2g"

    n_levels = len(m2m_ei)
    hierarchical = n_levels > 1
    graph = {
        "hierarchical": hierarchical,
        "g2m": (g2m_ei[0], g2m_ei[1], g2m_feat),
        "m2g": (m2g_ei[0], m2g_ei[1], m2g_feat),
        "m2m": [
            (ei[0], ei[1], feat) for ei, feat in zip(m2m_ei, m2m_feat)
        ],
        "mesh_features": mesh_features,
    }
    if hierarchical:
        up_ei = [
            _np(t).astype(np.int64)
            for t in _as_list(_load_pt(ref_dir / "mesh_up_edge_index.pt"))
        ]
        down_ei = [
            _np(t).astype(np.int64)
            for t in _as_list(
                _load_pt(ref_dir / "mesh_down_edge_index.pt")
            )
        ]
        if legacy:
            up_ei = [_zero_index_edge_index(ei) for ei in up_ei]
            down_ei = [_zero_index_edge_index(ei) for ei in down_ei]
        up_feat = [
            _np(t).astype(np.float32)
            for t in _as_list(_load_pt(ref_dir / "mesh_up_features.pt"))
        ]
        down_feat = [
            _np(t).astype(np.float32)
            for t in _as_list(
                _load_pt(ref_dir / "mesh_down_features.pt")
            )
        ]
        graph["mesh_up"] = [
            (ei[0], ei[1], feat) for ei, feat in zip(up_ei, up_feat)
        ]
        graph["mesh_down"] = [
            (ei[0], ei[1], feat) for ei, feat in zip(down_ei, down_feat)
        ]

    save_graph(graph, out_dir)
    if legacy:
        # Legacy mesh coordinates are pre-normalized
        # (reference: utils.py:395-416): tell the loader to skip its
        # own grid-span normalization.
        meta_out = Path(out_dir) / METAINFO_FILENAME
        meta = yaml.safe_load(meta_out.read_text(encoding="utf-8"))
        meta["mesh_features_prenormalized"] = True
        meta["converted_from"] = "reference-legacy"
        meta_out.write_text(yaml.dump(meta), encoding="utf-8")
    else:
        meta_out = Path(out_dir) / METAINFO_FILENAME
        meta = yaml.safe_load(meta_out.read_text(encoding="utf-8"))
        meta["converted_from"] = f"reference-{REFERENCE_SPEC_VERSION}"
        meta_out.write_text(yaml.dump(meta), encoding="utf-8")
    assert meta["spec_version"] == CURRENT_GRAPH_SPEC_VERSION
    return graph


def main(argv: Optional[list[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        description="Convert a reference .pt graph dir to graph.npz"
    )
    parser.add_argument("ref_dir", help="reference graph directory")
    parser.add_argument("out_dir", help="output graph directory")
    args = parser.parse_args(argv)
    graph = convert_reference_graph(args.ref_dir, args.out_dir)
    n_lev = len(graph["m2m"])
    print(
        f"converted {'hierarchical' if graph['hierarchical'] else 'flat'} "
        f"graph ({n_lev} level{'s' if n_lev != 1 else ''}) "
        f"-> {args.out_dir}"
    )


if __name__ == "__main__":
    main()
