"""Graph directory validator: ``python -m neural_lam_tpu_torch.validate_graph``.

Validates a graph directory against the ``tpu-0.1.0`` storage spec
(``docs/graph_storage_spec.md``). Counterpart of the reference's
standalone spec validator (reference: docs/validate_graph.py:502-1242,
2078-2184), adapted to the npz storage format.

Exit code 0 = valid; 1 = violations found (printed one per line).

The port's own copy of ``neural_lam_tpu/validate_graph.py``: the same
directory gives the same messages. Host only, no device.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from .graphs.build import (
    CURRENT_GRAPH_SPEC_VERSION,
    GRAPH_FILENAME,
    METAINFO_FILENAME,
)

_FEATURE_DIM = 3
_LENGTH_RTOL = 1e-4


class GraphValidationError(Exception):
    """Raised (by :func:`validate_graph_directory` with ``raise_on_error``)
    when a graph directory violates the storage spec."""


def _edge_set_names(n_levels: int, hierarchical: bool) -> list[str]:
    names = ["g2m", "m2g"] + [f"m2m__{lev}" for lev in range(n_levels)]
    if hierarchical:
        names += [f"mesh_up__{lev}" for lev in range(n_levels - 1)]
        names += [f"mesh_down__{lev}" for lev in range(n_levels - 1)]
    return names


def validate_graph_directory(
    graph_dir: str | Path,
    num_grid_nodes: int | None = None,
    raise_on_error: bool = False,
) -> list[str]:
    """Return a list of spec violations (empty if the directory is valid).

    ``num_grid_nodes`` enables the grid-side index range checks; without
    it, grid index ranges are only checked for non-negativity.
    """
    errors: list[str] = []
    graph_dir = Path(graph_dir)

    def err(msg: str) -> None:
        errors.append(msg)

    meta_path = graph_dir / METAINFO_FILENAME
    npz_path = graph_dir / GRAPH_FILENAME
    if not meta_path.exists():
        err(f"missing {METAINFO_FILENAME}")
    if not npz_path.exists():
        err(f"missing {GRAPH_FILENAME}")
    if errors:
        if raise_on_error:
            raise GraphValidationError("; ".join(errors))
        return errors

    import yaml  # where the file is read, as in config.load_config

    meta = yaml.safe_load(meta_path.read_text(encoding="utf-8")) or {}
    spec = meta.get("spec_version")
    if spec != CURRENT_GRAPH_SPEC_VERSION:
        err(
            f"spec_version {spec!r} != {CURRENT_GRAPH_SPEC_VERSION!r}"
        )
    n_levels = meta.get("n_levels")
    hierarchical = meta.get("hierarchical")
    if not isinstance(n_levels, int) or n_levels < 1:
        err(f"n_levels must be a positive int, got {n_levels!r}")
        n_levels = 1
    if not isinstance(hierarchical, bool):
        err(f"hierarchical must be a bool, got {hierarchical!r}")
        hierarchical = n_levels > 1
    if hierarchical != (n_levels > 1):
        err(
            f"hierarchical={hierarchical} inconsistent with "
            f"n_levels={n_levels}"
        )

    with np.load(npz_path) as data:
        arrays = {k: data[k] for k in data.files}

    # -- expected key set --------------------------------------------------
    expected: set[str] = set()
    for name in _edge_set_names(n_levels, hierarchical):
        expected |= {
            f"{name}_senders", f"{name}_receivers", f"{name}_features"
        }
    n_feature_levels = n_levels if hierarchical else 1
    expected |= {
        f"mesh_features__{lev}" for lev in range(n_feature_levels)
    }
    missing = expected - set(arrays)
    unknown = set(arrays) - expected
    for key in sorted(missing):
        err(f"missing array {key}")
    for key in sorted(unknown):
        err(f"unknown array {key}")
    if missing:
        if raise_on_error:
            raise GraphValidationError("; ".join(errors))
        return errors

    # -- mesh node features ------------------------------------------------
    level_sizes = []
    for lev in range(n_feature_levels):
        feat = arrays[f"mesh_features__{lev}"]
        if feat.dtype != np.float32:
            err(f"mesh_features__{lev} dtype {feat.dtype} != float32")
        if feat.ndim != 2 or feat.shape[1] != 2:
            err(
                f"mesh_features__{lev} shape {feat.shape} != (N, 2)"
            )
        if not np.isfinite(feat).all():
            err(f"mesh_features__{lev} contains non-finite values")
        level_sizes.append(feat.shape[0])

    def node_range(name: str, side: str) -> int | None:
        """Max valid index (exclusive) for an edge-set side."""
        level = (
            int(name.split("__")[1]) if "__" in name else None
        )
        if name == "g2m":
            return num_grid_nodes if side == "senders" else level_sizes[0]
        if name == "m2g":
            return level_sizes[0] if side == "senders" else num_grid_nodes
        if name.startswith("m2m"):
            return level_sizes[level if hierarchical else 0]
        if name.startswith("mesh_up"):
            return (
                level_sizes[level]
                if side == "senders"
                else level_sizes[level + 1]
            )
        if name.startswith("mesh_down"):
            return (
                level_sizes[level + 1]
                if side == "senders"
                else level_sizes[level]
            )
        return None

    # -- edge sets ---------------------------------------------------------
    for name in _edge_set_names(n_levels, hierarchical):
        snd = arrays[f"{name}_senders"]
        rcv = arrays[f"{name}_receivers"]
        feat = arrays[f"{name}_features"]
        for label, idx in (("senders", snd), ("receivers", rcv)):
            if idx.dtype != np.int32:
                err(f"{name}_{label} dtype {idx.dtype} != int32")
            if idx.ndim != 1:
                err(f"{name}_{label} must be 1-D, got shape {idx.shape}")
        if snd.shape != rcv.shape:
            err(
                f"{name}: senders shape {snd.shape} != receivers "
                f"shape {rcv.shape}"
            )
        if feat.dtype != np.float32:
            err(f"{name}_features dtype {feat.dtype} != float32")
        if feat.ndim != 2 or feat.shape[1] != _FEATURE_DIM:
            err(
                f"{name}_features shape {feat.shape} != "
                f"(E, {_FEATURE_DIM})"
            )
        elif feat.shape[0] != snd.shape[0]:
            err(
                f"{name}: {feat.shape[0]} feature rows != "
                f"{snd.shape[0]} edges"
            )
        else:
            lengths = np.sqrt(feat[:, 1] ** 2 + feat[:, 2] ** 2)
            if not np.allclose(feat[:, 0], lengths, rtol=_LENGTH_RTOL):
                err(
                    f"{name}_features column 0 is not the edge length "
                    "sqrt(dx^2 + dy^2)"
                )
            # Zero lengths are legitimate (hierarchical up/down edges
            # between coincident nodes); only negatives/NaNs are errors.
            if not np.isfinite(feat).all() or (feat[:, 0] < 0).any():
                err(
                    f"{name}_features has negative or non-finite "
                    "edge lengths"
                )
        for label, idx in (("senders", snd), ("receivers", rcv)):
            if idx.size and idx.min() < 0:
                err(f"{name}_{label} has negative indices")
            bound = node_range(name, label)
            if bound is not None and idx.size and idx.max() >= bound:
                err(
                    f"{name}_{label} max index {idx.max()} out of "
                    f"range [0, {bound})"
                )

    # -- hierarchical mirror property -------------------------------------
    if hierarchical:
        for lev in range(n_levels - 1):
            up_s = arrays[f"mesh_up__{lev}_senders"]
            up_r = arrays[f"mesh_up__{lev}_receivers"]
            dn_s = arrays[f"mesh_down__{lev}_senders"]
            dn_r = arrays[f"mesh_down__{lev}_receivers"]
            up_f = arrays[f"mesh_up__{lev}_features"]
            dn_f = arrays[f"mesh_down__{lev}_features"]
            if up_s.shape != dn_r.shape or not (
                np.array_equal(up_s, dn_r) and np.array_equal(up_r, dn_s)
            ):
                err(
                    f"mesh_down__{lev} is not the mirror of "
                    f"mesh_up__{lev}"
                )
            elif up_f.shape == dn_f.shape and up_f.shape[1] == 3:
                if not (
                    np.allclose(up_f[:, 0], dn_f[:, 0], rtol=1e-5)
                    and np.allclose(up_f[:, 1:], -dn_f[:, 1:], rtol=1e-5)
                ):
                    err(
                        f"mesh_down__{lev} features are not the "
                        f"negated mirror of mesh_up__{lev}"
                    )

    # -- m2g grid coverage -------------------------------------------------
    if num_grid_nodes is not None and "m2g_receivers" in arrays:
        covered = np.unique(arrays["m2g_receivers"])
        if covered.size != num_grid_nodes:
            err(
                f"m2g receivers cover {covered.size} of "
                f"{num_grid_nodes} grid nodes"
            )

    if errors and raise_on_error:
        raise GraphValidationError("; ".join(errors))
    return errors


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Validate a graph directory against the storage spec"
    )
    parser.add_argument("graph_dir", type=str)
    parser.add_argument(
        "--num_grid_nodes",
        type=int,
        default=None,
        help="Enable grid-side index range and coverage checks",
    )
    args = parser.parse_args(argv)
    errors = validate_graph_directory(
        args.graph_dir, num_grid_nodes=args.num_grid_nodes
    )
    if errors:
        for e in errors:
            print(f"INVALID: {e}")
        return 1
    print(f"OK: {args.graph_dir} conforms to {CURRENT_GRAPH_SPEC_VERSION}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
