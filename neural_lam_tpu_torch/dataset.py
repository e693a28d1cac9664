"""Temporal sampling of datastores into autoregressive training samples.

Window arithmetic matches the reference ``WeatherDataset``
(reference: neural_lam/weather_dataset.py:18-533) exactly:

- each sample = 2 init states + ``ar_steps`` target states,
- forcing windowed over ``[t - num_past, ..., t + num_future]`` and stacked
  feature-major into a single forcing dimension,
- analysis data: valid start indices are ``[0 .. T - W]`` with
  ``W = max(2, num_past) + ar_steps + num_future``,
- forecast data: one sample per analysis time, starting at forecast step
  ``max(2, num_past)``,
- ensemble members exposed as independent samples via
  ``divmod(idx, n_members)``.

Returned arrays are **unstandardised** float32 numpy; standardisation
happens on-device inside the jitted train step (see ``trainer.py``),
mirroring the reference's ``on_after_batch_transfer``
(reference: neural_lam/models/module.py:307-337).
"""

from __future__ import annotations

import warnings
import numpy as np

from .datastore.base import BaseDatastore
from .utils.labeled import FieldArray


class WeatherDataset:
    """Sliceable dataset of (init, target, forcing, times) samples."""

    def __init__(
        self,
        datastore: BaseDatastore,
        split: str = "train",
        ar_steps: int = 3,
        num_past_forcing_steps: int = 1,
        num_future_forcing_steps: int = 1,
        load_single_member: bool = False,
    ) -> None:
        self.datastore = datastore
        self.split = split
        self.ar_steps = ar_steps
        self.num_past_forcing_steps = num_past_forcing_steps
        self.num_future_forcing_steps = num_future_forcing_steps
        self.load_single_member = load_single_member

        self.da_state = datastore.get_dataarray(category="state", split=split)
        self.da_forcing = datastore.get_dataarray(
            category="forcing", split=split
        )
        if self.da_state is None:
            raise ValueError(
                "The datastore must provide state data for the WeatherDataset."
            )

        if datastore.is_ensemble and load_single_member:
            warnings.warn(
                "only using first ensemble member, so dataset size is "
                "effectively reduced by the number of ensemble members",
                UserWarning,
                stacklevel=2,
            )

        if len(self) <= 0:
            raise ValueError(
                "Too few time steps in the datastore to create a single "
                f"sample in split {split!r} with ar_steps={ar_steps}, "
                f"num_past_forcing_steps={num_past_forcing_steps}, "
                f"num_future_forcing_steps={num_future_forcing_steps}"
            )

        for part, da in (("state", self.da_state), ("forcing", self.da_forcing)):
            if da is None:
                continue
            expected = datastore.expected_dim_order(category=part)
            if da.dims != expected:
                raise ValueError(
                    f"The dimension order of the `{part}` data ({da.dims}) "
                    "does not match the expected dimension order "
                    f"({expected})."
                )

        # Analysis-mode slicing pairs state and forcing POSITIONALLY
        # (_slice_forcing_time indexes the same idx into both arrays),
        # so their time coordinates must line up element-for-element
        # over the overlap — otherwise every sample would silently pair
        # shifted forcing with its targets.
        if (
            not datastore.is_forecast
            and self.da_forcing is not None
        ):
            t_state = np.asarray(self.da_state.get_coord("time"))
            t_forcing = np.asarray(self.da_forcing.get_coord("time"))
            k = min(len(t_state), len(t_forcing))
            if not np.array_equal(t_state[:k], t_forcing[:k]):
                raise ValueError(
                    "state and forcing time coordinates are not "
                    "positionally aligned in split "
                    f"{split!r}; the dataset slices both by the same "
                    "index, so misaligned series would silently pair "
                    "wrong forcing with each target"
                )

    # -- length ------------------------------------------------------------
    def __len__(self) -> int:
        ds = self.datastore
        if ds.is_forecast:
            n_forecast_steps = len(
                self.da_state.get_coord("elapsed_forecast_duration")
            )
            required_state = (
                max(2, self.num_past_forcing_steps) + self.ar_steps
            )
            if n_forecast_steps < required_state:
                raise ValueError(
                    f"The number of forecast steps available "
                    f"({n_forecast_steps}) is less than the required "
                    f"{required_state} for creating a sample."
                )
            if self.da_forcing is not None:
                n_forcing_steps = len(
                    self.da_forcing.get_coord("elapsed_forecast_duration")
                )
                required_forcing = (
                    required_state + self.num_future_forcing_steps
                )
                if n_forcing_steps < required_forcing:
                    raise ValueError(
                        f"The number of forcing forecast steps available "
                        f"({n_forcing_steps}) is less than the required "
                        f"{required_forcing}."
                    )
            base_len = len(self.da_state.get_coord("analysis_time"))
        else:
            window = (
                max(2, self.num_past_forcing_steps)
                + self.ar_steps
                + self.num_future_forcing_steps
            )
            n_state = len(self.da_state.get_coord("time")) - window + 1
            if self.da_forcing is not None:
                n_forcing = len(self.da_forcing.get_coord("time")) - window + 1
                base_len = max(0, min(n_state, n_forcing))
            else:
                base_len = max(0, n_state)
        if ds.is_ensemble and not self.load_single_member:
            return base_len * len(self.da_state.get_coord("ensemble_member"))
        return base_len

    # -- slicing helpers -----------------------------------------------------
    def _slice_state_time(
        self, da_state: FieldArray, idx: int, n_steps: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Return ``(values (T', N, d), times (T',))`` for one sample.

        ``T' = max(2, num_past) - max(0, num_past - 2)_offset + n_steps``; the
        first two of the *used* steps are the init states.
        """
        init_steps = 2
        past = self.num_past_forcing_steps
        if self.datastore.is_forecast:
            start_idx = max(0, past - init_steps)
            end_idx = max(init_steps, past) + n_steps
            sliced = da_state.isel(
                analysis_time=idx,
                elapsed_forecast_duration=slice(start_idx, end_idx),
            )
            analysis_time = da_state.get_coord("analysis_time")[idx]
            elapsed = sliced.get_coord("elapsed_forecast_duration")
            times = analysis_time + elapsed
            values = np.asarray(sliced.data, dtype=np.float32)
        else:
            start_idx = idx + max(0, past - init_steps)
            end_idx = idx + max(init_steps, past) + n_steps
            sliced = da_state.isel(time=slice(start_idx, end_idx))
            times = sliced.get_coord("time")
            # a copy: the datastore may hand out read-only views of its
            # cache (the MDP reader does)
            values = np.array(sliced.data, dtype=np.float32)
        return values, times

    def _slice_forcing_time(
        self, da_forcing: FieldArray, idx: int, n_steps: int
    ) -> np.ndarray:
        """Windowed forcing, shape ``(n_steps, N, n_forcing * window)``.

        The (feature, window) axes are stacked feature-major, i.e. for each
        feature all window positions are contiguous — matching xarray
        ``stack(forcing_feature_windowed=("forcing_feature", "window"))``
        (reference: neural_lam/weather_dataset.py:439-444).
        """
        past = self.num_past_forcing_steps
        future = self.num_future_forcing_steps
        init_steps = 2
        window = past + future + 1

        if self.datastore.is_forecast:
            offset = max(init_steps, past)
            base = da_forcing.isel(analysis_time=idx)
            data = np.asarray(base.data, dtype=np.float32)
            time_axis = 0
        else:
            offset = idx + max(init_steps, past)
            data = np.asarray(da_forcing.data, dtype=np.float32)
            time_axis = 0

        n_grid = data.shape[1]
        n_feat = data.shape[2]
        out = np.empty(
            (n_steps, n_grid, n_feat, window), dtype=np.float32
        )
        for step in range(n_steps):
            start_idx = offset + step - past
            end_idx = offset + step + future
            win = np.take(
                data, np.arange(start_idx, end_idx + 1), axis=time_axis
            )  # (window, N, F)
            out[step] = np.moveaxis(win, 0, -1)  # (N, F, window)
        return out.reshape(n_steps, n_grid, n_feat * window)

    # -- item access ----------------------------------------------------------
    def __getitem__(self, idx: int):
        """Return ``(init_states, target_states, forcing, target_times)``.

        Shapes: ``(2, N, d_state)``, ``(ar_steps, N, d_state)``,
        ``(ar_steps, N, d_forcing * window)``, ``(ar_steps,)`` int64 (ns).
        """
        n_samples = len(self)
        if idx < 0:
            idx += n_samples
        if not 0 <= idx < n_samples:
            raise IndexError(
                f"index {idx} out of range for WeatherDataset of length "
                f"{n_samples}"
            )

        sample_idx = idx
        i_ensemble = 0
        da_state = self.da_state
        if self.datastore.is_ensemble:
            n_members = len(self.da_state.get_coord("ensemble_member"))
            if not self.load_single_member:
                sample_idx, i_ensemble = divmod(idx, n_members)
            da_state = da_state.isel(ensemble_member=i_ensemble)

        da_forcing = self.da_forcing
        if da_forcing is not None and self.datastore.has_ensemble_forcing:
            da_forcing = da_forcing.isel(ensemble_member=i_ensemble)

        state_vals, state_times = self._slice_state_time(
            da_state, sample_idx, self.ar_steps
        )
        init_states = state_vals[:2]
        target_states = state_vals[2:]
        target_times = state_times[2:]

        if da_forcing is not None:
            forcing = self._slice_forcing_time(
                da_forcing, sample_idx, self.ar_steps
            )
        else:
            forcing = np.zeros(
                (self.ar_steps, init_states.shape[1], 0), dtype=np.float32
            )

        target_times_int = (
            np.asarray(target_times, dtype="datetime64[ns]")
            .astype("int64")
        )
        return init_states, target_states, forcing, target_times_int

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def create_dataarray_from_array(
        self, array: np.ndarray, time, category: str
    ) -> FieldArray:
        """Wrap a ``(T, N, d)`` or ``(N, d)`` array as a labeled FieldArray."""
        da_ref = getattr(self, f"da_{category}")
        feat_coord = da_ref.get_coord(f"{category}_feature")
        grid_coord = da_ref.get_coord("grid_index")
        if array.ndim == 2:
            return FieldArray(
                data=np.asarray(array),
                dims=("grid_index", f"{category}_feature"),
                coords={
                    "grid_index": grid_coord,
                    f"{category}_feature": feat_coord,
                    "time": np.asarray(time),
                },
            )
        if array.ndim == 3:
            return FieldArray(
                data=np.asarray(array),
                dims=("time", "grid_index", f"{category}_feature"),
                coords={
                    "time": np.asarray(time),
                    "grid_index": grid_coord,
                    f"{category}_feature": feat_coord,
                },
            )
        raise ValueError(
            f"Expected 2 or 3 dims, got array with shape {array.shape}"
        )
