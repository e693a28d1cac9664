"""MEPS numpy-file datastore: lazy memmap loading, no dask.

Re-design of the reference MEPS datastore
(reference: neural_lam/datastore/npyfilesmeps/store.py:63-844). The
reference builds dask-delayed xarray stacks; here each analysis time is
an item of a :class:`~neural_lam_tpu_torch.utils.lazy.LazyTimeSeries` whose
loader memory-maps the underlying ``.npy`` files — same laziness, no
scheduler, and fork-safe (the dask/fork hang the reference works around
at weather_dataset.py:694-697 cannot occur).

On-disk layout, filename formats, forcing/static feature sets, datetime
forcing encodings and stats files all match the reference so existing
MEPS datasets load unchanged. Stats tensors are read from ``.npy`` or
legacy torch ``.pt`` files.

The port's own copy of ``neural_lam_tpu/datastore/npyfilesmeps/store.py``:
the same files give the same arrays.
"""

from __future__ import annotations

import datetime as dt
import functools
import re
import warnings
from datetime import timedelta
from pathlib import Path
from typing import Optional

import numpy as np

from ...utils.labeled import FieldArray
from ...utils.lazy import LazyTimeSeries
from ..base import BaseRegularGridDatastore, CartesianGridShape
from .config import NpyDatastoreConfig

STATE_FILENAME_RE = re.compile(
    r"nwp_(\d{10})_mbr(\d{3})\.npy$"
)  # nwp_{analysis_time:%Y%m%d%H}_mbr{member_id:03d}.npy
STATE_FILENAME_FORMAT = "nwp_{atime}_mbr{member:03d}.npy"
TOA_FLUX_FILENAME_FORMAT = "nwp_toa_downwelling_shortwave_flux_{atime}.npy"
OPEN_WATER_FILENAME_FORMAT = "wtr_{atime}.npy"

FORCING_VAR_NAMES = [
    "toa_downwelling_shortwave_flux",
    "open_water_fraction",
    "sin_hour",
    "cos_hour",
    "sin_year",
    "cos_year",
]
STATIC_VAR_NAMES = ["surface_geopotential", "border_mask", "x", "y"]


def _fmt_time(t: np.datetime64) -> str:
    return (
        t.astype("datetime64[s]")
        .item()
        .strftime("%Y%m%d%H")
    )


def _member_index(m: int, n_members: int) -> int:
    """Range-checked ensemble-member index with numpy's negative-index
    convention — matching what the non-pushdown path (plain numpy
    indexing) would do, instead of silently wrapping via modulo."""
    if not -n_members <= m < n_members:
        raise IndexError(
            f"ensemble_member index {m} out of range for "
            f"{n_members} members"
        )
    return m % n_members


class NpyFilesDatastoreMEPS(BaseRegularGridDatastore):
    """Datastore over the MEPS per-forecast ``.npy`` file layout."""

    SHORT_NAME = "npyfilesmeps"
    is_forecast = True
    has_ensemble_forcing = False

    def __init__(self, config_path) -> None:
        self._config_path = Path(config_path)
        self._root_path = self._config_path.parent
        self._config = NpyDatastoreConfig.from_yaml_file(self._config_path)

        self._num_ensemble_members = (
            self.config.dataset.num_ensemble_members
        )
        self._num_timesteps = self.config.dataset.num_timesteps
        self._step_length = self.config.dataset.step_length
        self._remove_state_features_with_index = list(
            self.config.dataset.remove_state_features_with_index
        )
        self.is_ensemble = self._num_ensemble_members > 1

    # -- metadata ----------------------------------------------------------
    @property
    def root_path(self) -> Path:
        return self._root_path

    @property
    def config(self) -> NpyDatastoreConfig:
        return self._config

    @property
    def step_length(self) -> timedelta:
        return self._step_length

    @functools.cached_property
    def grid_shape_state(self) -> CartesianGridShape:
        ny, nx = self.config.grid_shape_state
        return CartesianGridShape(x=nx, y=ny)

    def get_vars_names(self, category: str) -> list[str]:
        if category == "state":
            return list(self.config.dataset.var_names)
        if category == "forcing":
            return list(FORCING_VAR_NAMES)
        if category == "static":
            return list(STATIC_VAR_NAMES)
        raise NotImplementedError(f"Category {category} not supported")

    def get_vars_units(self, category: str) -> list[str]:
        if category == "state":
            return list(self.config.dataset.var_units)
        if category == "forcing":
            return ["W/m^2", "1", "1", "1", "1", "1"]
        if category == "static":
            return ["m^2/s^2", "1", "m", "m"]
        raise NotImplementedError(f"Category {category} not supported")

    def get_vars_long_names(self, category: str) -> list[str]:
        if category == "state":
            return list(self.config.dataset.var_longnames)
        return self.get_vars_names(category=category)

    def get_num_data_vars(self, category: str) -> int:
        return len(self.get_vars_names(category=category))

    # -- geometry ----------------------------------------------------------
    @functools.cached_property
    def _xy(self) -> np.ndarray:
        """(Nx, Ny, 2) projection coordinates, x-major.

        The on-disk array is ``[2, N_y, N_x]``
        (reference: store.py:657-692).
        """
        arr = np.load(self.root_path / "static" / "nwp_xy.npy")
        assert arr.shape[0] == 2, "Expected leading [x,y] axis in nwp_xy.npy"
        shape = self.grid_shape_state
        assert arr.shape[1:] == (shape.y, shape.x), (
            f"nwp_xy.npy shape {arr.shape} does not match grid "
            f"({shape.y}, {shape.x})"
        )
        return arr.transpose(2, 1, 0)

    def get_xy(self, category: str, stacked: bool) -> np.ndarray:
        xy = self._xy
        return xy.reshape(-1, 2) if stacked else xy

    @functools.cached_property
    def coords_projection(self):
        try:
            import cartopy.crs as ccrs
        except ImportError:
            return None
        proj_class = getattr(ccrs, self.config.projection.class_name)
        return proj_class(**self.config.projection.kwargs)

    @functools.cached_property
    def boundary_mask(self) -> FieldArray:
        values = np.load(self.root_path / "static" / "border_mask.npy")
        # (Ny, Nx) on disk -> x-major grid_index
        stacked = values.T.reshape(-1).astype(np.float32)
        return FieldArray(
            data=stacked,
            dims=("grid_index",),
            coords={"grid_index": np.arange(stacked.shape[0])},
            name="boundary_mask",
        )

    # -- file access -------------------------------------------------------
    def _get_analysis_times(self, split: str) -> list[np.datetime64]:
        """Parse analysis times out of the state filenames
        (reference: store.py:539-569)."""
        sample_dir = self.root_path / "samples" / split
        times = set()
        for fp in sample_dir.glob("nwp_*_mbr*.npy"):
            m = STATE_FILENAME_RE.match(fp.name)
            if m:
                t = dt.datetime.strptime(m.group(1), "%Y%m%d%H")
                times.add(np.datetime64(t, "ns"))
        if not times:
            raise ValueError(f"No state files found in {sample_dir}")
        return sorted(times)

    def _grid_stack_yx(self, arr: np.ndarray) -> np.ndarray:
        """``(..., Ny, Nx)`` file layout -> ``(..., grid_index)`` x-major,
        matching the xarray ``stack(grid_index=("x","y"))`` convention
        (reference: datastore/base.py:590-628)."""
        shape = self.grid_shape_state
        assert arr.shape[-2:] == (shape.y, shape.x), (
            f"Expected trailing (Ny={shape.y}, Nx={shape.x}), "
            f"got {arr.shape}"
        )
        arr = np.swapaxes(arr, -1, -2)
        return arr.reshape(arr.shape[:-2] + (shape.x * shape.y,))

    def _grid_stack_yxf(self, arr: np.ndarray) -> np.ndarray:
        """``(..., Ny, Nx, f)`` -> ``(..., grid_index, f)`` x-major."""
        shape = self.grid_shape_state
        assert arr.shape[-3:-1] == (shape.y, shape.x), (
            f"Expected (Ny={shape.y}, Nx={shape.x}) before the feature "
            f"axis, got {arr.shape}"
        )
        arr = np.swapaxes(arr, -2, -3)
        return arr.reshape(
            arr.shape[:-3] + (shape.x * shape.y,) + arr.shape[-1:]
        )

    def _state_feature_mask(self) -> Optional[np.ndarray]:
        drop = self._remove_state_features_with_index
        if not drop:
            return None
        n_total = len(self.get_vars_names("state")) + len(drop)
        mask = np.ones(n_total, dtype=bool)
        mask[drop] = False
        return mask

    def _load_state_file(
        self, split: str, atime: np.datetime64, member: int,
        t_key=slice(None),
    ) -> np.ndarray:
        """One ``(T', grid, d_state)`` member forecast, feature-masked.

        ``t_key`` slices the forecast-step axis ON THE MEMMAP, before
        the grid reshape forces a copy — a window read costs
        O(window), not O(num_timesteps) (~10x less I/O per training
        sample at MEPS size, where files hold 65 steps but a sample
        needs ~2+ar_steps).
        """
        fp = (
            self.root_path
            / "samples"
            / split
            / STATE_FILENAME_FORMAT.format(
                atime=_fmt_time(atime), member=member
            )
        )
        arr = np.load(fp, mmap_mode="r")  # (T, y, x, f_total)
        if not (isinstance(t_key, slice) and t_key == slice(None)):
            arr = arr[t_key]
        mask = self._state_feature_mask()
        if mask is not None:
            arr = np.asarray(arr)[..., mask]
        return self._grid_stack_yxf(np.asarray(arr, dtype=np.float32))

    def _datetime_forcing(self, atime: np.datetime64) -> np.ndarray:
        """(T, 4) sinusoidal hour/day-of-year encodings rescaled to [0,1]
        (reference: store.py:571-606)."""
        steps = np.arange(self._num_timesteps)
        times = atime + np.array(
            [self._step_length * int(s) for s in steps], dtype="timedelta64[s]"
        )
        times_py = times.astype("datetime64[s]").tolist()
        hours = np.array([t.hour + t.minute / 60 for t in times_py])
        doy = np.array([t.timetuple().tm_yday for t in times_py])
        hour_angle = hours / 12 * np.pi
        year_angle = doy / 365 * 2 * np.pi
        feats = np.stack(
            [
                np.sin(hour_angle),
                np.cos(hour_angle),
                np.sin(year_angle),
                np.cos(year_angle),
            ],
            axis=-1,
        )
        return ((feats + 1) / 2).astype(np.float32)

    def _load_forcing_item(
        self, split: str, atime: np.datetime64
    ) -> np.ndarray:
        """One ``(T, grid, 6)`` forcing forecast: flux, open water,
        datetime features (reference: store.py:263-290)."""
        n_grid = self.num_grid_points
        T = self._num_timesteps
        tstr = _fmt_time(atime)
        samples = self.root_path / "samples" / split

        flux = np.load(
            samples / TOA_FLUX_FILENAME_FORMAT.format(atime=tstr),
            mmap_mode="r",
        )  # (T, y, x)
        flux = self._grid_stack_yx(np.asarray(flux, np.float32))[..., None]

        water = np.load(
            samples / OPEN_WATER_FILENAME_FORMAT.format(atime=tstr),
            mmap_mode="r",
        )  # (y, x)
        water = self._grid_stack_yx(np.asarray(water, np.float32))
        water = np.broadcast_to(water[None, :, None], (T, n_grid, 1))

        datetime_f = np.broadcast_to(
            self._datetime_forcing(atime)[:, None, :], (T, n_grid, 4)
        )
        return np.concatenate(
            [flux, water, datetime_f], axis=-1
        ).astype(np.float32)

    # -- data arrays -------------------------------------------------------
    def get_dataarray(
        self, category: str, split: Optional[str], standardize: bool = False
    ) -> Optional[FieldArray]:
        n_grid = self.num_grid_points
        if category == "state":
            analysis_times = self._get_analysis_times(split)
            d = self.get_num_data_vars("state")
            T = self._num_timesteps
            M = self._num_ensemble_members

            if self.is_ensemble:
                def loader(i, _split=split, _times=analysis_times):
                    return np.stack(
                        [
                            self._load_state_file(_split, _times[i], m)
                            for m in range(M)
                        ],
                        axis=1,
                    )  # (T, M, grid, d)

                def pushdown(i, rest, _split=split, _times=analysis_times):
                    # Selection over one analysis item's (T, M, grid, d)
                    # axes. Members live in separate files, so resolve the
                    # member key FIRST and read only the selected files —
                    # isel(ensemble_member=m) costs one file per analysis
                    # time instead of M.
                    t_key = rest[0] if len(rest) >= 1 else slice(None)
                    m_key = rest[1] if len(rest) >= 2 else slice(None)
                    tail = rest[2:]
                    n_adv = sum(
                        not isinstance(k, (int, np.integer, slice))
                        for k in rest
                    )
                    if n_adv > 1:
                        # Multiple advanced indices reorder axes under
                        # numpy semantics; take the simple (full) path.
                        return loader(i)[rest]
                    drop_m = isinstance(m_key, (int, np.integer))
                    if drop_m:
                        members = [_member_index(int(m_key), M)]
                    elif isinstance(m_key, slice):
                        members = list(range(*m_key.indices(M)))
                    else:
                        m_arr = np.asarray(m_key)
                        if m_arr.dtype == bool:
                            # boolean mask -> positions (element-wise
                            # int() would read mask VALUES as indices)
                            m_arr = np.nonzero(m_arr.reshape(-1))[0]
                        members = [
                            _member_index(int(x), M)
                            for x in m_arr.reshape(-1)
                        ]
                    t_is_int = isinstance(t_key, (int, np.integer))
                    rest_key = (
                        tail if t_is_int else (slice(None),) + tail
                    )
                    subs = [
                        self._load_state_file(
                            _split, _times[i], m, t_key=t_key
                        )[rest_key]
                        for m in members
                    ]
                    if drop_m:
                        return subs[0]
                    m_axis = 0 if isinstance(t_key, (int, np.integer)) else 1
                    return np.stack(subs, axis=m_axis)

                item_shape = (T, M, n_grid, d)
                dims = (
                    "analysis_time",
                    "elapsed_forecast_duration",
                    "ensemble_member",
                    "grid_index",
                    "state_feature",
                )
            else:
                def loader(i, _split=split, _times=analysis_times):
                    return self._load_state_file(_split, _times[i], 0)

                def pushdown(i, rest, _split=split,
                             _times=analysis_times):
                    # time-slice pushdown: slice the memmap before the
                    # grid reshape copy (see _load_state_file)
                    n_adv = sum(
                        not isinstance(k, (int, np.integer, slice))
                        for k in rest
                    )
                    if n_adv > 1:
                        return loader(i)[rest]
                    t_key = rest[0]
                    tail = rest[1:]
                    arr = self._load_state_file(
                        _split, _times[i], 0, t_key=t_key
                    )
                    if tail:
                        k = (
                            tail
                            if isinstance(t_key, (int, np.integer))
                            else (slice(None),) + tail
                        )
                        arr = arr[k]
                    return arr

                item_shape = (T, n_grid, d)
                dims = (
                    "analysis_time",
                    "elapsed_forecast_duration",
                    "grid_index",
                    "state_feature",
                )

            data = LazyTimeSeries(
                loader,
                len(analysis_times),
                item_shape,
                pushdown=pushdown,
            )
            coords = {
                "analysis_time": np.array(analysis_times),
                "elapsed_forecast_duration": np.array(
                    [self._step_length * int(s) for s in range(T)],
                    dtype="timedelta64[s]",
                ).astype("timedelta64[ns]"),
                "grid_index": np.arange(n_grid),
                "state_feature": np.array(self.get_vars_names("state")),
            }
            if self.is_ensemble:
                coords["ensemble_member"] = np.arange(M)
            da = FieldArray(data=data, dims=dims, coords=coords)

        elif category == "forcing":
            analysis_times = self._get_analysis_times(split)
            T = self._num_timesteps

            def loader(i, _split=split, _times=analysis_times):
                return self._load_forcing_item(_split, _times[i])

            data = LazyTimeSeries(
                loader, len(analysis_times), (T, n_grid, 6)
            )
            da = FieldArray(
                data=data,
                dims=(
                    "analysis_time",
                    "elapsed_forecast_duration",
                    "grid_index",
                    "forcing_feature",
                ),
                coords={
                    "analysis_time": np.array(analysis_times),
                    "elapsed_forecast_duration": np.array(
                        [self._step_length * int(s) for s in range(T)],
                        dtype="timedelta64[s]",
                    ).astype("timedelta64[ns]"),
                    "grid_index": np.arange(n_grid),
                    "forcing_feature": np.array(FORCING_VAR_NAMES),
                },
            )

        elif category == "static":
            static_dir = self.root_path / "static"
            geop = self._grid_stack_yx(
                np.asarray(
                    np.load(static_dir / "surface_geopotential.npy"),
                    np.float32,
                )
            )[:, None]
            border = np.asarray(
                self.boundary_mask.data, np.float32
            )[:, None]
            xy = self.get_xy("static", stacked=True).astype(np.float32)
            values = np.concatenate([geop, border, xy], axis=-1)
            da = FieldArray(
                data=values,
                dims=("grid_index", "static_feature"),
                coords={
                    "grid_index": np.arange(n_grid),
                    "static_feature": np.array(STATIC_VAR_NAMES),
                },
            )
        else:
            raise NotImplementedError(category)

        if standardize:
            da = self._standardize_dataarray(da, category=category)
        return da

    # -- stats -------------------------------------------------------------
    def _load_stats_tensor(self, stem: str) -> np.ndarray:
        """Load a stats array from ``static/``: ``.npy`` preferred, legacy
        torch ``.pt`` accepted (reference: store.py:765-772)."""
        static_dir = self.root_path / "static"
        npy = static_dir / f"{stem}.npy"
        if npy.exists():
            return np.asarray(np.load(npy), dtype=np.float32)
        pt = static_dir / f"{stem}.pt"
        if pt.exists():
            import torch

            return np.asarray(
                torch.load(pt, weights_only=True, map_location="cpu")
                .numpy(),
                dtype=np.float32,
            )
        raise FileNotFoundError(f"Missing stats file {stem}.npy/.pt")

    def get_standardization_dataarray(self, category: str) -> dict:
        if category == "state":
            mean = self._load_stats_tensor("parameter_mean")
            std = self._load_stats_tensor("parameter_std")
            try:
                diff_mean = self._load_stats_tensor("diff_mean")
                diff_std = self._load_stats_tensor("diff_std")
            except FileNotFoundError:
                warnings.warn(
                    f"Could not load diff mean/std for {category}; "
                    "falling back to diff_mean=0 / diff_std=1 "
                    "(identity delta rescaling)",
                    stacklevel=2,
                )
                # NOT np.empty_like (the reference's fallback,
                # store.py:747-829): uninitialised memory would flow
                # into the per-step delta rescaling (graph_base) and
                # the per_var_std loss weighting as silent garbage.
                diff_mean = np.zeros_like(mean)
                diff_std = np.ones_like(std)
            return {
                "state_mean": mean,
                "state_std": std,
                "state_diff_mean_standardized": diff_mean,
                "state_diff_std_standardized": diff_std,
            }
        if category == "forcing":
            flux_mean, flux_std = self._load_stats_tensor("flux_stats")
            return {
                "forcing_mean": np.array(
                    [flux_mean, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32
                ),
                "forcing_std": np.array(
                    [flux_std, 1.0, 1.0, 1.0, 1.0, 1.0], np.float32
                ),
            }
        if category == "static":
            da = self.get_dataarray(category="static", split="train")
            values = np.asarray(da.data)
            return {
                "static_mean": values.mean(axis=0),
                "static_std": values.std(axis=0),
            }
        raise NotImplementedError(f"Category {category} not supported")
