"""MDP (mllam-data-prep) zarr datastore.

Counterpart of the reference ``MDPDatastore``
(reference: neural_lam/datastore/mdp.py:25-420), reading the zarr
datasets that mllam-data-prep produces — via the pure-python
:mod:`~neural_lam_tpu_torch.utils.minizarr` reader, so no zarr/xarray/dask
dependency is needed. Dataset *creation* (running mllam-data-prep from
its config) is out of scope here: the zarr archive must already exist
next to the config file (``<name>.datastore.yaml`` -> ``<name>.datastore.zarr``),
which matches the reference's ``reuse_existing`` path
(reference: mdp.py:77-92).

Expected dataset contents (as written by mllam-data-prep):
- ``state`` (time, grid_index, state_feature), optional ``forcing``,
  ``static`` (grid_index, static_feature),
- coordinate arrays ``{category}_feature`` (+ ``_units`` /
  ``_long_name``), ``time``, per-grid-point ``x`` / ``y``,
- ``splits`` (split_name, split_part) start/end timestamps,
- stats arrays ``{category}__train__{mean,std}`` and
  ``state__train__diff_{mean,std}``.

The port's own copy of ``neural_lam_tpu/datastore/mdp.py``. The arrays
the reader returns are read-only, and ``get_dataarray`` hands out views
of them (one decompressed array serves every split): copy before writing.
"""

from __future__ import annotations

import functools
import warnings
from datetime import timedelta
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils.labeled import FieldArray
from ..utils.minizarr import ZarrGroup
from .base import BaseRegularGridDatastore, CartesianGridShape


class MDPDatastore(BaseRegularGridDatastore):
    """Datastore over an mllam-data-prep zarr dataset."""

    SHORT_NAME = "mdp"
    is_forecast = False

    def __init__(
        self,
        config_path,
        n_boundary_points: int = 30,
    ) -> None:
        self._config_path = Path(config_path)
        self._root_path = self._config_path.parent
        self._read_cache: dict[str, np.ndarray] = {}
        import yaml  # where the file is read, as in config.load_config

        with open(self._config_path, "r", encoding="utf-8") as f:
            self._config = yaml.safe_load(f) or {}

        name = self._config_path.name
        for suffix in (".datastore.yaml", ".datastore.yml", ".yaml", ".yml"):
            if name.endswith(suffix):
                name = name[: -len(suffix)] + suffix.replace(
                    "yaml", "zarr"
                ).replace("yml", "zarr")
                break
        else:
            raise ValueError(
                f"MDP datastore config must be a .yaml/.yml file, got "
                f"{self._config_path.name!r}"
            )
        fp_ds = self._root_path / name
        if not fp_ds.exists():
            # Dataset creation through mllam-data-prep when installed,
            # mirroring the reference's on-demand create path
            # (reference: neural_lam/datastore/mdp.py:77-92); without
            # the package the zarr must be pre-built.
            try:
                import mllam_data_prep as mdp
            except ImportError:
                raise FileNotFoundError(
                    f"No zarr dataset at {fp_ds} and mllam-data-prep is "
                    "not installed. Either install mllam_data_prep so "
                    "the dataset can be created from the config, or run "
                    "`python -m mllam_data_prep <config>` elsewhere and "
                    "place the resulting .zarr next to the config."
                ) from None
            print(f"creating zarr dataset at {fp_ds} via mllam-data-prep")
            mdp_config = mdp.Config.from_yaml_file(self._config_path)
            ds = mdp.create_dataset(config=mdp_config)
            ds.to_zarr(fp_ds)
        self._store = ZarrGroup(fp_ds)
        self._n_boundary_points = n_boundary_points

        state_dims = self._store["state"].dims or ()
        self.is_ensemble = "ensemble_member" in state_dims
        self.has_ensemble_forcing = (
            "forcing" in self._store
            and "ensemble_member" in (self._store["forcing"].dims or ())
        )

        # Validate splits coverage (reference: mdp.py:108-117)
        split_names = [
            str(s) for s in self._read("splits_split_name")
        ] if "splits_split_name" in self._store else ["train", "val", "test"]
        missing = {"train", "val", "test"} - set(split_names)
        if missing and "splits" in self._store:
            raise ValueError(f"Missing required splits: {sorted(missing)}")

        # Determine grid stacking order from x/y per-grid coords
        x = self._read("x")
        y = self._read("y")
        self._x_vals = np.unique(x)
        self._y_vals = np.unique(y)
        nx, ny = len(self._x_vals), len(self._y_vals)
        # x-major iff consecutive grid points share x
        self._x_major = bool(nx > 1 and x[0] == x[1]) or nx == 1
        self._grid_shape = CartesianGridShape(x=nx, y=ny)
        self._grid_x = np.asarray(x)
        self._grid_y = np.asarray(y)

    # -- helpers -----------------------------------------------------------
    def _read(self, name: str) -> np.ndarray:
        # per-INSTANCE cache, not functools.lru_cache: an lru_cache on
        # an instance method pins every datastore (and its decompressed
        # arrays) in a module-global cache for the process lifetime
        # (convention: datastore/base.py:144-147)
        if name not in self._read_cache:
            self._read_cache[name] = self._store[name].read()
        return self._read_cache[name]

    # -- metadata ----------------------------------------------------------
    @property
    def root_path(self) -> Path:
        return self._root_path

    @property
    def config(self):
        return self._config

    @functools.cached_property
    def step_length(self) -> timedelta:
        times = self._read("time")
        dt = (times[1] - times[0]).astype("timedelta64[s]").astype(int)
        return timedelta(seconds=int(dt))

    @property
    def grid_shape_state(self) -> CartesianGridShape:
        return self._grid_shape

    def _feature_list(self, category: str, suffix: str = "") -> list[str]:
        name = f"{category}_feature{suffix}"
        if name not in self._store:
            base_name = f"{category}_feature"
            if suffix and base_name in self._store:
                # Only the auxiliary metadata array (units/long names) is
                # missing — the category itself exists. Return same-length
                # placeholders so name/unit zips stay aligned.
                n = len(self._read(base_name))
                warnings.warn(
                    f"datastore has no {name!r} array; using placeholder "
                    f"{suffix.lstrip('_')} metadata for {n} "
                    f"{category} features",
                    stacklevel=2,
                )
                return ["unknown"] * n
            if category == "forcing":
                warnings.warn(
                    "no forcing data found in datastore", stacklevel=2
                )
                return []
            raise KeyError(name)
        return [str(v) for v in self._read(name)]

    def get_vars_names(self, category: str) -> list[str]:
        return self._feature_list(category)

    def get_vars_units(self, category: str) -> list[str]:
        return self._feature_list(category, "_units")

    def get_vars_long_names(self, category: str) -> list[str]:
        return self._feature_list(category, "_long_name")

    def get_num_data_vars(self, category: str) -> int:
        return len(self.get_vars_names(category))

    # -- data --------------------------------------------------------------
    def _split_time_range(self, split: str) -> tuple[int, int]:
        """Index range [i0, i1] of the split on the time axis."""
        times = self._read("time")
        starts = self._read("splits")  # (split_name, split_part)
        split_names = [str(s) for s in self._read("splits_split_name")]
        parts = [str(p) for p in self._read("splits_split_part")]
        i_split = split_names.index(split)
        start = starts[i_split, parts.index("start")]
        end = starts[i_split, parts.index("end")]
        i0 = int(np.searchsorted(times, start, side="left"))
        i1 = int(np.searchsorted(times, end, side="right"))
        return i0, i1

    def get_dataarray(
        self, category: str, split: Optional[str], standardize: bool = False
    ) -> Optional[FieldArray]:
        if category not in self._store:
            if category == "forcing":
                warnings.warn(
                    "no forcing data found in datastore", stacklevel=2
                )
                return None
            raise KeyError(category)
        arr = self._store[category]
        # cached full read: one decompression serves all three splits
        # (train/val/test loaders each call get_dataarray)
        values = self._read(category)
        dims = list(arr.dims or ())
        coords: dict[str, np.ndarray] = {
            f"{category}_feature": np.array(
                self.get_vars_names(category)
            ),
        }
        if "time" in dims and split is not None:
            i0, i1 = self._split_time_range(split)
            t_axis = dims.index("time")
            # basic slice: a view, not a copy (np.take would duplicate
            # the split's whole array)
            key = (slice(None),) * t_axis + (slice(i0, i1),)
            values = values[key]
            coords["time"] = self._read("time")[i0:i1]
        elif "time" in dims:
            coords["time"] = self._read("time")
        coords["grid_index"] = np.arange(self.num_grid_points)
        if self.is_ensemble and "ensemble_member" in dims:
            coords["ensemble_member"] = np.arange(
                values.shape[dims.index("ensemble_member")]
            )

        da = FieldArray(
            data=np.asarray(values, dtype=np.float32),
            dims=tuple(dims),
            coords=coords,
        )
        expected = self.expected_dim_order(category=category)
        if da.dims != expected:
            da = da.transpose(*expected)
        if standardize:
            da = self._standardize_dataarray(da, category)
        return da

    def get_standardization_dataarray(self, category: str) -> dict:
        mean = self._read(f"{category}__train__mean").astype(np.float32)
        std = self._read(f"{category}__train__std").astype(np.float32)
        out = {f"{category}_mean": mean, f"{category}_std": std}
        if category == "state":
            # Standardized diff stats = raw diff stats / state std
            # (reference: mdp.py:364-374)
            for op in ("mean", "std"):
                raw = self._read(f"state__train__diff_{op}").astype(
                    np.float32
                )
                out[f"state_diff_{op}_standardized"] = raw / std
        return out

    @functools.cached_property
    def boundary_mask(self) -> FieldArray:
        """Edge frame of ``n_boundary_points`` in unstacked x/y space
        (reference: mdp.py:378-407)."""
        nx, ny = self._grid_shape.x, self._grid_shape.y
        nb = self._n_boundary_points
        mask2d = np.ones((nx, ny), dtype=np.float32)
        if nx > 2 * nb and ny > 2 * nb:
            mask2d[nb:-nb, nb:-nb] = 0
        mask = self.stack_grid_coords(mask2d)
        return FieldArray(
            data=mask,
            dims=("grid_index",),
            coords={"grid_index": np.arange(nx * ny)},
            name="boundary_mask",
        )

    def get_xy(self, category: str, stacked: bool) -> np.ndarray:
        xy_flat = np.stack([self._grid_x, self._grid_y], axis=-1)
        if stacked:
            return xy_flat
        nx, ny = self._grid_shape.x, self._grid_shape.y
        if self._x_major:
            return xy_flat.reshape(nx, ny, 2)
        return xy_flat.reshape(ny, nx, 2).transpose(1, 0, 2)

    def stack_grid_coords(self, field_xy: np.ndarray) -> np.ndarray:
        if self._x_major:
            return super().stack_grid_coords(field_xy)
        # y-major stacking: grid_index = y_idx * Nx + x_idx
        shape = self.grid_shape_state
        lead = field_xy.shape[:-2]
        assert field_xy.shape[-2:] == (shape.x, shape.y)
        return np.swapaxes(field_xy, -1, -2).reshape(
            lead + (shape.x * shape.y,)
        )

    def unstack_grid_coords(self, field_grid: np.ndarray) -> np.ndarray:
        if self._x_major:
            return super().unstack_grid_coords(field_grid)
        shape = self.grid_shape_state
        lead = field_grid.shape[:-1]
        out = field_grid.reshape(lead + (shape.y, shape.x))
        return np.swapaxes(out, -1, -2)

    @functools.cached_property
    def coords_projection(self):
        """Projection from the config's ``extra.projection`` section
        (reference: mdp.py:396-420)."""
        extra = (self._config or {}).get("extra") or {}
        proj = extra.get("projection")
        if not proj:
            return None
        try:
            import cartopy.crs as ccrs
        except ImportError:
            return None
        return getattr(ccrs, proj["class_name"])(**proj.get("kwargs", {}))
