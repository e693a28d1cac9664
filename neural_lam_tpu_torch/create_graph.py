"""Graph-creation CLI: ``python -m neural_lam_tpu_torch.create_graph``.

Counterpart of ``neural_lam_tpu/create_graph.py``, with the same flags
(reference: neural_lam/create_graph.py:903-958): loads the config and
datastore, then builds and saves the requested graph under
``<datastore root>/graph/<name>`` with the port's
:func:`~neural_lam_tpu_torch.graphs.create_graph_from_datastore`. The
graph is built on the host (numpy and scipy); no device is involved.
"""

from __future__ import annotations

import argparse

from .config import load_config_and_datastore
from .graphs import create_graph_from_datastore


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Create mesh graphs for neural-lam-tpu models"
    )
    parser.add_argument(
        "--config_path",
        type=str,
        required=True,
        help="Path to the configuration for neural-lam-tpu",
    )
    parser.add_argument(
        "--name",
        type=str,
        default="multiscale",
        help="Name to save graph as (under <root>/graph/)",
    )
    parser.add_argument(
        "--levels",
        type=int,
        help="Limit multi-scale mesh to given number of levels",
    )
    parser.add_argument(
        "--hierarchical",
        action="store_true",
        help="Generate hierarchical mesh graph",
    )
    args = parser.parse_args(argv)

    _, datastore = load_config_and_datastore(args.config_path)
    graph_dir = datastore.root_path / "graph" / args.name
    create_graph_from_datastore(
        datastore,
        graph_dir,
        n_max_levels=args.levels,
        hierarchical=args.hierarchical,
    )
    print(f"Graph saved to {graph_dir}")


if __name__ == "__main__":
    main()
