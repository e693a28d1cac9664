"""Abstract datastore interfaces.

Behavioural contract follows the reference
(reference: neural_lam/datastore/base.py:19-628):

- all spatial dims stacked into a single ``grid_index`` dimension,
- all variables/levels stacked into a ``{category}_feature`` dimension,
- categories: ``state`` (required), ``forcing`` / ``static`` (optional),
- flags ``is_forecast`` / ``is_ensemble`` / ``has_ensemble_forcing`` switch
  the time dims between ``time`` and
  ``(analysis_time, elapsed_forecast_duration)`` plus ``ensemble_member``.

Arrays are :class:`~neural_lam_tpu_torch.utils.labeled.FieldArray` (numpy-backed)
instead of xarray; standardisation statistics are plain dicts of numpy
arrays keyed ``{category}_mean``, ``{category}_std`` and, for state,
``state_diff_mean_standardized`` / ``state_diff_std_standardized``.
"""

from __future__ import annotations

import abc
import dataclasses
from datetime import timedelta
from pathlib import Path
from typing import Mapping, Optional

import numpy as np

from ..utils.labeled import FieldArray


class BaseDatastore(abc.ABC):
    """Base class for weather data access used across the framework."""

    is_ensemble: bool = False
    has_ensemble_forcing: bool = False
    is_forecast: bool = False

    @property
    @abc.abstractmethod
    def root_path(self) -> Path:
        """Root path; derived artifacts (graphs) are stored relative to it."""

    @property
    @abc.abstractmethod
    def config(self) -> Mapping:
        """The datastore configuration mapping."""

    @property
    @abc.abstractmethod
    def step_length(self) -> timedelta:
        """Time interval between consecutive steps."""

    @abc.abstractmethod
    def get_vars_units(self, category: str) -> list[str]:
        """Units for each variable in the category."""

    @abc.abstractmethod
    def get_vars_names(self, category: str) -> list[str]:
        """Names for each variable in the category."""

    @abc.abstractmethod
    def get_vars_long_names(self, category: str) -> list[str]:
        """Long names for each variable in the category."""

    @abc.abstractmethod
    def get_num_data_vars(self, category: str) -> int:
        """Number of (stacked) variables in the category."""

    @abc.abstractmethod
    def get_standardization_dataarray(self, category: str) -> dict:
        """Standardisation stats for the category.

        Returns a dict with keys ``{category}_mean`` and ``{category}_std``
        (each shaped ``({category}_feature,)``) and, for ``state``, also
        ``state_diff_mean_standardized`` / ``state_diff_std_standardized``.
        """

    def _standardize_dataarray(
        self, da: FieldArray, category: str
    ) -> FieldArray:
        """Standardise a dataarray with near-zero stds clamped to eps."""
        stats = self.get_standardization_dataarray(category=category)
        mean = np.asarray(stats[f"{category}_mean"], dtype=np.float64)
        std = np.asarray(stats[f"{category}_std"], dtype=np.float64)
        eps = np.finfo(std.dtype).eps
        std = np.where(std > eps, std, eps)
        out = da.copy()
        out.data = (np.asarray(da.data) - mean) / std
        return out

    @abc.abstractmethod
    def get_dataarray(
        self,
        category: str,
        split: Optional[str],
        standardize: bool = False,
    ) -> Optional[FieldArray]:
        """Full data for a category and split; ``None`` if not provided.

        Dim order must equal :meth:`expected_dim_order` for the category.
        """

    @property
    @abc.abstractmethod
    def boundary_mask(self) -> FieldArray:
        """Per-grid-node 1/0 mask (1 = boundary), dims ``(grid_index,)``."""

    @abc.abstractmethod
    def get_xy(self, category: str, stacked: bool) -> np.ndarray:
        """Projection x/y coordinates.

        ``stacked=True``: shape ``(num_grid_points, 2)``;
        ``stacked=False``: shape ``(Nx, Ny, 2)`` for regular grids.
        """

    @property
    def coords_projection(self):
        """Optional projection object for plotting; ``None`` if unknown."""
        return None

    def get_xy_extent(self, category: str) -> list[float]:
        """``[xmin, xmax, ymin, ymax]`` extent of the grid coordinates."""
        xy = self.get_xy(category, stacked=True)
        return [
            float(xy[:, 0].min()),
            float(xy[:, 0].max()),
            float(xy[:, 1].min()),
            float(xy[:, 1].max()),
        ]

    def get_lat_lon(self, category: str) -> np.ndarray:
        """Lat/lon of grid points, shape ``(num_grid_points, 2)``.

        Default assumes the projection coordinates already are lon/lat.
        """
        return self.get_xy(category, stacked=True)

    @property
    @abc.abstractmethod
    def num_grid_points(self) -> int:
        """Number of grid points (after spatial stacking)."""

    # NOTE: deliberately uncached — an ``lru_cache`` on an instance method
    # would pin every datastore instance (and its in-memory data) in a
    # module-global cache for the process lifetime, and the list build is
    # trivially cheap.
    def expected_dim_order(
        self, category: Optional[str] = None
    ) -> tuple[str, ...]:
        """Expected dim order of ``get_dataarray`` output.

        ``[..., grid_index, {category}_feature]`` with time/ensemble dims in
        front (reference: neural_lam/datastore/base.py:395-458).
        """
        dim_order: list[str] = []
        if category is not None:
            if category != "static":
                if self.is_forecast:
                    dim_order.extend(
                        ["analysis_time", "elapsed_forecast_duration"]
                    )
                else:
                    dim_order.append("time")
            if (category == "state" and self.is_ensemble) or (
                category == "forcing" and self.has_ensemble_forcing
            ):
                dim_order.append("ensemble_member")
        dim_order.append("grid_index")
        if category is not None:
            dim_order.append(f"{category}_feature")
        return tuple(dim_order)


@dataclasses.dataclass
class CartesianGridShape:
    """Shape of a regular x/y grid."""

    x: int
    y: int


class BaseRegularGridDatastore(BaseDatastore):
    """Datastore over a regular Cartesian grid.

    Provides stack/unstack between ``(x, y)`` and ``grid_index``. The
    stacking order is x-major (``grid_index = x_idx * Ny + y_idx``),
    matching the reference's ``stack(grid_index=("x", "y"))`` convention
    (reference: neural_lam/datastore/base.py:590-628) and the grid-node
    enumeration used during graph construction
    (reference: neural_lam/create_graph.py:710-730).
    """

    spatial_coordinates = ("x", "y")

    @property
    @abc.abstractmethod
    def grid_shape_state(self) -> CartesianGridShape:
        """Shape of the state-variable grid."""

    @property
    def num_grid_points(self) -> int:
        shape = self.grid_shape_state
        return shape.x * shape.y

    def stack_grid_coords(self, field_xy: np.ndarray) -> np.ndarray:
        """Reshape ``(..., Nx, Ny)`` trailing spatial dims to grid_index."""
        shape = self.grid_shape_state
        lead = field_xy.shape[:-2]
        assert field_xy.shape[-2:] == (shape.x, shape.y)
        return field_xy.reshape(lead + (shape.x * shape.y,))

    def unstack_grid_coords(self, field_grid: np.ndarray) -> np.ndarray:
        """Reshape trailing ``grid_index`` dim back to ``(Nx, Ny)``."""
        shape = self.grid_shape_state
        lead = field_grid.shape[:-1]
        assert field_grid.shape[-1] == shape.x * shape.y
        return field_grid.reshape(lead + (shape.x, shape.y))
