"""Compute MEPS standardization statistics (two streaming passes).

Counterpart of the reference script
(reference: neural_lam/datastore/npyfilesmeps/compute_standardization_stats.py:215-465):
pass 1 accumulates per-variable mean/std of the state (and flux forcing)
over the train split; pass 2 computes mean/std of the *standardized*
one-step state differences. The reference optionally shards the passes
over a torch.distributed NCCL/Gloo group
(reference: c_s_s.py:92-139, 304-358); here one process streams the
memory-mapped files with a thread pool, and ``shard_index`` /
``num_shards`` cut the analysis times into strided shards whose moments
merge exactly on the host (:func:`merge_moments`). Results are written
as ``.npy`` files in ``static/`` (the store also reads the legacy
``.pt`` names).

The port's own copy of
``neural_lam_tpu/datastore/npyfilesmeps/compute_standardization_stats.py``.
The JAX package's ``--multihost`` merge over a process group waits for
data parallelism (ROADMAP §1 item 8): here the flag raises.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from .store import NpyFilesDatastoreMEPS


class _RunningMoments:
    """Streaming per-feature mean/std over (…, feature) arrays."""

    def __init__(self, n_features: int) -> None:
        self.count = 0
        self.sum = np.zeros(n_features, dtype=np.float64)
        self.sumsq = np.zeros(n_features, dtype=np.float64)

    def update(self, arr: np.ndarray) -> None:
        flat = arr.reshape(-1, arr.shape[-1]).astype(np.float64)
        self.count += flat.shape[0]
        self.sum += flat.sum(axis=0)
        self.sumsq += (flat * flat).sum(axis=0)

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        mean = self.sum / self.count
        var = np.maximum(self.sumsq / self.count - mean * mean, 0.0)
        return mean.astype(np.float32), np.sqrt(var).astype(np.float32)


def merge_moments(parts: list[_RunningMoments]) -> _RunningMoments:
    """The moments of the union of the parts' samples: counts, sums and
    sums of squares add, in float64, so strided shards merge to the
    single-pass statistics (the algebra of the reference's
    ``all_gather_object`` merge, reference: c_s_s.py:304-358)."""
    merged = _RunningMoments(parts[0].sum.shape[0])
    for part in parts:
        merged.count += part.count
        merged.sum = merged.sum + part.sum
        merged.sumsq = merged.sumsq + part.sumsq
    return merged


def compute_stats(
    datastore: NpyFilesDatastoreMEPS,
    subsample_step: int = 1,
    num_workers: int = 1,
    shard_index: int = 0,
    num_shards: int = 1,
) -> dict[str, np.ndarray]:
    """Return all stats arrays for the train split.

    ``subsample_step`` matches the reference's diff subsampling: one-step
    differences are taken between states ``subsample_step`` file-steps
    apart (the effective model step, reference: c_s_s.py:363-465).
    ``num_workers > 1`` parallelises the per-analysis-time reads with a
    thread pool; ``shard_index``/``num_shards`` restrict this process to
    a strided slice of the analysis times (the multi-node variant of the
    reference, reference: c_s_s.py:92-139, merges such shards across
    processes; that merge is not ported yet). Sharding is by whole
    analysis-time series, so the one-step diffs within each series stay
    intact on one shard.
    """
    from concurrent.futures import ThreadPoolExecutor

    da_state = datastore.get_dataarray(category="state", split="train")
    da_forcing = datastore.get_dataarray(category="forcing", split="train")

    n_state = datastore.get_num_data_vars("state")
    n_analysis = da_state.shape[0]

    def load_pair(i):
        return (
            np.asarray(da_state.data[i]),
            np.asarray(da_forcing.data[i]),
        )

    my_indices = list(range(shard_index, n_analysis, num_shards))

    state_mom = _RunningMoments(n_state)
    flux_mom = _RunningMoments(1)
    with ThreadPoolExecutor(max_workers=max(num_workers, 1)) as pool:
        for state, forcing in pool.map(load_pair, my_indices):
            state_mom.update(state)  # (T[, M], grid, d)
            flux_mom.update(forcing[..., :1])
    state_mean, state_std = state_mom.finalize()
    flux_mean, flux_std = flux_mom.finalize()

    diff_mom = _RunningMoments(n_state)
    with ThreadPoolExecutor(max_workers=max(num_workers, 1)) as pool:
        for state in pool.map(
            lambda i: np.asarray(da_state.data[i]), my_indices
        ):
            standardized = (state - state_mean) / state_std
            sub = (
                standardized[::subsample_step]
                if subsample_step > 1
                else standardized
            )
            diffs = np.diff(sub, axis=0)
            diff_mom.update(diffs)
    diff_mean, diff_std = diff_mom.finalize()

    return {
        "parameter_mean": state_mean,
        "parameter_std": state_std,
        "diff_mean": diff_mean,
        "diff_std": diff_std,
        "flux_stats": np.array([flux_mean[0], flux_std[0]], np.float32),
    }


def save_stats(static_dir: Path, stats: dict[str, np.ndarray]) -> None:
    static_dir.mkdir(parents=True, exist_ok=True)
    for name, arr in stats.items():
        np.save(static_dir / f"{name}.npy", arr)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Compute standardization stats for a MEPS npy datastore"
    )
    parser.add_argument(
        "--datastore_config_path",
        type=str,
        required=True,
        help="Path to the datastore config (data_config.yaml)",
    )
    parser.add_argument("--subsample_step", type=int, default=1)
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument(
        "--multihost",
        action="store_true",
        help="Shard the passes over a process group (not ported yet: "
        "raises)",
    )
    args = parser.parse_args(argv)
    if args.multihost:
        raise SystemExit(
            "--multihost is not ported yet: the merge of the moments across "
            "processes comes with data parallelism (ROADMAP.md §1 item 8)"
        )

    datastore = NpyFilesDatastoreMEPS(config_path=args.datastore_config_path)
    stats = compute_stats(
        datastore,
        subsample_step=args.subsample_step,
        num_workers=args.num_workers,
    )
    save_stats(datastore.root_path / "static", stats)
    for name, arr in stats.items():
        print(f"{name}: shape {arr.shape}")


if __name__ == "__main__":
    main()
