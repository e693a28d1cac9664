"""Visualization: prediction maps, error heatmaps, spatial error plots.

Counterpart of the reference vis module
(reference: neural_lam/vis.py:342-777) on matplotlib. Cartopy is
optional: with a projection available axes get coastlines and a
geographic transform; otherwise plots fall back to plain projection-
coordinate axes (pure-numpy pcolormesh), so the artifact set is
produced in every environment.

The port's own copy of ``neural_lam_tpu/vis.py``, on matplotlib's
``Agg`` backend; ``save_metrics_csv``, which draws nothing, lives in
``evaluation`` and is re-exported here.
"""

from __future__ import annotations

from typing import Optional

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

from .datastore.base import BaseRegularGridDatastore  # noqa: E402
from .evaluation import save_metrics_csv  # noqa: E402,F401

_TITLE_SIZE = 11
_TICK_SIZE = 8


def _grid_values(
    datastore: BaseRegularGridDatastore, values: np.ndarray
) -> np.ndarray:
    """(num_grid_nodes,) -> (Nx, Ny) via the datastore's stacking order.

    Delegates to the datastore so y-major stores (MDPDatastore with
    ``_x_major=False``) unstack correctly rather than scrambling."""
    return datastore.unstack_grid_coords(np.asarray(values))


def _make_axis(fig, datastore, index=(1, 1, 1)):
    """Create a (possibly projection-aware) axis."""
    projection = datastore.coords_projection
    if projection is not None:
        ax = fig.add_subplot(*index, projection=projection)
        try:
            ax.coastlines(resolution="50m")
        except Exception:  # offline: coastline data not downloadable
            pass
        return ax, True
    return fig.add_subplot(*index), False


def plot_on_axis(
    ax,
    values: np.ndarray,
    datastore: BaseRegularGridDatastore,
    vmin: Optional[float] = None,
    vmax: Optional[float] = None,
    ax_title: Optional[str] = None,
    cmap="plasma",
    boundary_alpha: Optional[float] = None,
    crop_to_interior: bool = False,
):
    """Plot per-grid-node ``values`` on an axis
    (reference: vis.py:342-469)."""
    xy = datastore.get_xy("state", stacked=False)  # (Nx, Ny, 2)
    xs, ys = xy[..., 0], xy[..., 1]
    grid_vals = _grid_values(datastore, values)

    mesh = ax.pcolormesh(
        xs, ys, grid_vals, vmin=vmin, vmax=vmax, cmap=cmap, shading="auto"
    )

    mask_2d = _grid_values(
        datastore, np.asarray(datastore.boundary_mask.data)
    )
    if boundary_alpha is not None:
        overlay = np.where(mask_2d == 1, 1.0, np.nan)
        ax.pcolormesh(
            xs,
            ys,
            overlay,
            cmap=matplotlib.colors.ListedColormap(
                [(1, 1, 1, boundary_alpha)]
            ),
            shading="auto",
        )
    if crop_to_interior and np.any(mask_2d == 0):
        interior = mask_2d == 0
        ax.set_xlim(xs[interior].min(), xs[interior].max())
        ax.set_ylim(ys[interior].min(), ys[interior].max())
    if ax_title:
        ax.set_title(ax_title, size=_TITLE_SIZE)
    return mesh


def plot_prediction(
    pred: np.ndarray,
    target: np.ndarray,
    datastore: BaseRegularGridDatastore,
    title: Optional[str] = None,
    vrange: Optional[tuple[float, float]] = None,
):
    """Side-by-side target/prediction maps on a shared color scale
    (reference: vis.py:617-699)."""
    if vrange is None:
        vmin = float(min(np.nanmin(pred), np.nanmin(target)))
        vmax = float(max(np.nanmax(pred), np.nanmax(target)))
    else:
        vmin, vmax = vrange

    fig = plt.figure(figsize=(13, 7))
    ax_t, _ = _make_axis(fig, datastore, (1, 2, 1))
    ax_p, _ = _make_axis(fig, datastore, (1, 2, 2))
    plot_on_axis(
        ax_t, target, datastore, vmin, vmax, "Ground Truth",
        boundary_alpha=0.4,
    )
    mesh = plot_on_axis(
        ax_p, pred, datastore, vmin, vmax, "Prediction",
        boundary_alpha=0.4,
    )
    cbar = fig.colorbar(mesh, ax=fig.axes, orientation="horizontal",
                        fraction=0.05, aspect=40)
    cbar.ax.tick_params(labelsize=_TICK_SIZE)
    if title:
        fig.suptitle(title, size=_TITLE_SIZE + 2)
    return fig


def plot_spatial_error(
    error: np.ndarray,
    datastore: BaseRegularGridDatastore,
    title: Optional[str] = None,
    vrange: Optional[tuple[float, float]] = None,
):
    """Map of per-grid-node error (reference: vis.py:702-777)."""
    if vrange is None:
        vmin, vmax = float(np.nanmin(error)), float(np.nanmax(error))
    else:
        vmin, vmax = vrange
    fig = plt.figure(figsize=(8, 6))
    ax, _ = _make_axis(fig, datastore)
    mesh = plot_on_axis(
        ax, error, datastore, vmin, vmax, cmap="OrRd", boundary_alpha=0.4
    )
    cbar = fig.colorbar(mesh, ax=ax, orientation="horizontal",
                        fraction=0.05, aspect=40)
    cbar.ax.tick_params(labelsize=_TICK_SIZE)
    if title:
        fig.suptitle(title, size=_TITLE_SIZE + 2)
    return fig


def plot_error_heatmap(
    errors: np.ndarray,
    datastore,
    title: Optional[str] = None,
    step_length_hours: Optional[float] = None,
):
    """Heatmap of error per (variable, lead time), normalized per-variable
    for color (reference: vis.py:469-583)."""
    errors = np.asarray(errors)  # (pred_steps, n_vars)
    n_steps, n_vars = errors.shape
    var_names = datastore.get_vars_names("state")
    var_units = datastore.get_vars_units("state")
    if step_length_hours is None:
        step_length_hours = datastore.step_length.total_seconds() / 3600

    # Normalize each variable row to [0, 1] for the color scale
    emin = errors.min(axis=0, keepdims=True)
    emax = errors.max(axis=0, keepdims=True)
    span = np.where(emax - emin > 0, emax - emin, 1.0)
    norm = (errors - emin) / span

    height = 1 + 0.3 * n_vars
    fig, ax = plt.subplots(figsize=(15, height))
    ax.imshow(
        norm.T,
        cmap="OrRd",
        vmin=0,
        vmax=1.0,
        interpolation="none",
        aspect="auto",
        alpha=0.8,
    )
    for (j, i), value in np.ndenumerate(errors.T):
        ax.text(i, j, f"{value:.3f}", ha="center", va="center", fontsize=7)

    lead_times = step_length_hours * np.arange(1, n_steps + 1)
    ax.set_xticks(np.arange(n_steps))
    ax.set_xticklabels(
        [f"{t:g}" for t in lead_times], size=_TICK_SIZE
    )
    ax.set_xlabel("Lead time (h)", size=_TITLE_SIZE)
    ax.set_yticks(np.arange(n_vars))
    ax.set_yticklabels(
        [
            f"{name} ({unit})"
            for name, unit in zip(var_names, var_units)
        ],
        rotation=30,
        size=_TICK_SIZE,
    )
    if title:
        ax.set_title(title, size=_TITLE_SIZE + 2)
    fig.tight_layout()
    return fig


def plot_error_map(errors, datastore, title: Optional[str] = None):
    """Deprecated alias kept for reference API parity
    (reference: neural_lam/vis.py:586-614): forwards to
    :func:`plot_error_heatmap` with a DeprecationWarning."""
    import warnings

    warnings.warn(
        "plot_error_map is deprecated, use plot_error_heatmap instead",
        DeprecationWarning,
        stacklevel=2,
    )
    return plot_error_heatmap(errors, datastore=datastore, title=title)
