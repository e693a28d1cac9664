"""In-memory dummy datastore for development and tests.

Plays the role of the reference's test fixture datastore
(reference: tests/dummy_datastore.py:23-480): random state/forcing/static
fields on a regular grid, no disk or network access (the port's copy of
``neural_lam_tpu.datastore.dummy``: the same seed gives the same arrays). Default standardisation statistics are identity so
normalisation is a no-op unless ``computed_stats=True``.
"""

from __future__ import annotations

import tempfile
from datetime import timedelta
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils.labeled import FieldArray
from .base import BaseRegularGridDatastore, CartesianGridShape

SPLITS = ("train", "val", "test")


class DummyDatastore(BaseRegularGridDatastore):
    """Random-data regular-grid datastore held fully in memory."""

    is_forecast = False
    is_ensemble = False
    has_ensemble_forcing = False

    def __init__(
        self,
        config_path=None,
        n_grid_x: int = 10,
        n_grid_y: int = 10,
        n_timesteps: int = 15,
        n_state_features: int = 3,
        n_forcing_features: int = 2,
        n_static_features: int = 1,
        n_boundary: int = 2,
        step_length_hours: int = 3,
        computed_stats: bool = False,
        root_path: Optional[Path] = None,
        seed: int = 42,
    ) -> None:
        if config_path is not None:
            # Allow registry-style construction with a small YAML config.
            import yaml

            with open(config_path, "r", encoding="utf-8") as f:
                cfg = yaml.safe_load(f) or {}
            root_path = Path(config_path).parent
            self._config = cfg
            n_grid_x = cfg.get("n_grid_x", n_grid_x)
            n_grid_y = cfg.get("n_grid_y", n_grid_y)
            n_timesteps = cfg.get("n_timesteps", n_timesteps)
            n_state_features = cfg.get("n_state_features", n_state_features)
            n_forcing_features = cfg.get(
                "n_forcing_features", n_forcing_features
            )
            n_static_features = cfg.get("n_static_features", n_static_features)
            n_boundary = cfg.get("n_boundary", n_boundary)
            seed = cfg.get("seed", seed)
            step_length_hours = cfg.get(
                "step_length_hours", step_length_hours
            )
            computed_stats = cfg.get("computed_stats", computed_stats)
            known = {
                "n_grid_x", "n_grid_y", "n_timesteps",
                "n_state_features", "n_forcing_features",
                "n_static_features", "n_boundary", "seed",
                "step_length_hours", "computed_stats",
            }
            unknown = set(cfg) - known
            if unknown:
                raise ValueError(
                    f"Unknown keys in dummydata config {config_path}: "
                    f"{sorted(unknown)} (expected a subset of "
                    f"{sorted(known)})"
                )
        else:
            self._config = {
                "n_grid_x": n_grid_x,
                "n_grid_y": n_grid_y,
                "n_timesteps": n_timesteps,
            }

        self._root_path = (
            Path(root_path)
            if root_path is not None
            else Path(tempfile.mkdtemp(prefix="nlam_torch_dummy_"))
        )
        self._grid_shape = CartesianGridShape(x=n_grid_x, y=n_grid_y)
        self._step_length = timedelta(hours=step_length_hours)
        self._n_boundary = min(n_boundary, min(n_grid_x, n_grid_y) // 2)
        self._computed_stats = computed_stats

        rng = np.random.default_rng(seed)
        n_grid = n_grid_x * n_grid_y

        # One contiguous analysis time axis per split.
        t0 = np.datetime64("1990-09-02T00:00")
        step = np.timedelta64(step_length_hours, "h")
        self._times = {
            split: t0 + step * np.arange(i * n_timesteps, (i + 1) * n_timesteps)
            for i, split in enumerate(SPLITS)
        }

        self._num_features = {
            "state": n_state_features,
            "forcing": n_forcing_features,
            "static": n_static_features,
        }
        self._values: dict[str, dict[str, np.ndarray]] = {}
        for split in SPLITS:
            self._values[split] = {
                "state": rng.normal(
                    size=(n_timesteps, n_grid, n_state_features)
                ).astype(np.float32),
                "forcing": rng.normal(
                    size=(n_timesteps, n_grid, n_forcing_features)
                ).astype(np.float32),
            }
        self._static = rng.normal(size=(n_grid, n_static_features)).astype(
            np.float32
        )

        # Projection-plane coordinates: a plain kilometre grid.
        x = 1000.0 * np.arange(n_grid_x)
        y = 1000.0 * np.arange(n_grid_y)
        self._xy = np.stack(
            np.meshgrid(x, y, indexing="ij"), axis=-1
        )  # (Nx, Ny, 2)

    # -- metadata --------------------------------------------------------
    @property
    def root_path(self) -> Path:
        return self._root_path

    @property
    def config(self):
        return self._config

    @property
    def step_length(self) -> timedelta:
        return self._step_length

    @property
    def grid_shape_state(self) -> CartesianGridShape:
        return self._grid_shape

    def get_vars_names(self, category: str) -> list[str]:
        return [
            f"{category}_var_{i}" for i in range(self._num_features[category])
        ]

    def get_vars_units(self, category: str) -> list[str]:
        return ["unit"] * self._num_features[category]

    def get_vars_long_names(self, category: str) -> list[str]:
        return [
            f"{category} variable {i}"
            for i in range(self._num_features[category])
        ]

    def get_num_data_vars(self, category: str) -> int:
        return self._num_features[category]

    # -- data ------------------------------------------------------------
    def get_standardization_dataarray(self, category: str) -> dict:
        n = self._num_features[category]
        if not self._computed_stats:
            stats = {
                f"{category}_mean": np.zeros(n, dtype=np.float32),
                f"{category}_std": np.ones(n, dtype=np.float32),
            }
            if category == "state":
                stats["state_diff_mean_standardized"] = np.zeros(
                    n, dtype=np.float32
                )
                stats["state_diff_std_standardized"] = np.ones(
                    n, dtype=np.float32
                )
            return stats

        vals = self._values["train"].get(category)
        if vals is None or category == "static":
            vals = self._static[None]
        # Reduce over every axis except the trailing feature axis, so
        # ensemble stores with an extra member axis (T, M, grid, feat)
        # still produce per-feature (feat,) stats.
        red_axes = tuple(range(vals.ndim - 1))
        mean = vals.mean(axis=red_axes)
        std = vals.std(axis=red_axes)
        stats = {f"{category}_mean": mean, f"{category}_std": std}
        if category == "state":
            standardized = (vals - mean) / std
            diffs = np.diff(standardized, axis=0)
            stats["state_diff_mean_standardized"] = diffs.mean(axis=red_axes)
            # Clamp away from zero: deterministic-value fixtures (the
            # ensemble store's t*100+m encoding) have constant diffs,
            # and a zero diff-std would silently zero model outputs
            # through the diff-stat rescaling (graph_base).
            stats["state_diff_std_standardized"] = np.maximum(
                diffs.std(axis=red_axes), np.finfo(np.float32).eps
            )
        return stats

    def get_dataarray(
        self, category: str, split: Optional[str], standardize: bool = False
    ) -> Optional[FieldArray]:
        n_grid = self.num_grid_points
        if category == "static":
            da = FieldArray(
                data=self._static,
                dims=("grid_index", "static_feature"),
                coords={
                    "grid_index": np.arange(n_grid),
                    "static_feature": np.array(self.get_vars_names("static")),
                },
            )
        else:
            if self._num_features[category] == 0:
                return None
            assert split in SPLITS, f"Unknown split {split!r}"
            da = FieldArray(
                data=self._values[split][category],
                dims=("time", "grid_index", f"{category}_feature"),
                coords={
                    "time": self._times[split],
                    "grid_index": np.arange(n_grid),
                    f"{category}_feature": np.array(
                        self.get_vars_names(category)
                    ),
                },
            )
        if standardize:
            da = self._standardize_dataarray(da, category)
        return da

    @property
    def boundary_mask(self) -> FieldArray:
        nx, ny = self._grid_shape.x, self._grid_shape.y
        nb = self._n_boundary
        mask2d = np.zeros((nx, ny), dtype=np.float32)
        if nb > 0:
            mask2d[:nb, :] = 1
            mask2d[-nb:, :] = 1
            mask2d[:, :nb] = 1
            mask2d[:, -nb:] = 1
        return FieldArray(
            data=mask2d.reshape(-1),
            dims=("grid_index",),
            coords={"grid_index": np.arange(nx * ny)},
        )

    def get_xy(self, category: str, stacked: bool) -> np.ndarray:
        if stacked:
            return self._xy.reshape(-1, 2)
        return self._xy

