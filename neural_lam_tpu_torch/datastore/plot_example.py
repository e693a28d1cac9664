"""Facet plot of a datastore variable over time.

Counterpart of the reference example plotter
(reference: neural_lam/datastore/plot_example.py:10-193), on the
cartopy-optional ``vis`` helpers. CLI:
``python -m neural_lam_tpu_torch.datastore.plot_example``.

The port's own copy of ``neural_lam_tpu/datastore/plot_example.py``.
Host only, no device. ``vis`` (matplotlib) is imported where the figure
is drawn; without it :func:`main` stops with one message.
"""

from __future__ import annotations

import argparse

import numpy as np


def plot_example_from_datastore(
    category: str,
    datastore,
    col_dim: str = "time",
    split: str = "train",
    standardize: bool = False,
    selection: dict | None = None,
    variable: str | int = 0,
    n_cols: int = 4,
    n_examples: int = 4,
):
    """Plot ``n_examples`` time steps of one variable as a facet grid."""
    from .. import vis

    da = datastore.get_dataarray(
        category=category, split=split, standardize=standardize
    )
    if da is None:
        raise ValueError(f"No {category!r} data in datastore")
    names = datastore.get_vars_names(category)
    if isinstance(variable, str):
        var_idx = names.index(variable)
    else:
        var_idx = int(variable)
    if selection:
        da = da.isel(**selection)

    time_dim = (
        "time" if "time" in da.dims else "elapsed_forecast_duration"
    )
    n_steps = da.sizes.get(time_dim, 1)
    n_examples = min(n_examples, n_steps)
    n_cols = min(n_cols, n_examples)
    n_rows = -(-n_examples // n_cols)

    fig = vis.plt.figure(figsize=(4 * n_cols, 3.2 * n_rows))
    for i in range(n_examples):
        values = np.asarray(
            da.isel(**{time_dim: i}).data
        )[..., var_idx]
        ax, _ = vis._make_axis(
            fig, datastore, (n_rows, n_cols, i + 1)
        )
        vis.plot_on_axis(
            ax, values, datastore, ax_title=f"{names[var_idx]} t={i}"
        )
    fig.tight_layout()
    return fig


def main(argv=None) -> None:
    from ..config import load_config_and_datastore
    from ..plot_graph import require_matplotlib

    parser = argparse.ArgumentParser(
        description="Plot example fields from a datastore"
    )
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--category", type=str, default="state")
    parser.add_argument("--split", type=str, default="train")
    parser.add_argument("--variable", type=str, default=None)
    parser.add_argument("--save", type=str, default="example.png")
    args = parser.parse_args(argv)
    require_matplotlib("plot_example")
    _, datastore = load_config_and_datastore(args.config_path)
    fig = plot_example_from_datastore(
        args.category,
        datastore,
        split=args.split,
        variable=args.variable if args.variable is not None else 0,
    )
    fig.savefig(args.save, dpi=150, bbox_inches="tight")
    print(f"Saved example plot to {args.save}")


if __name__ == "__main__":
    main()
