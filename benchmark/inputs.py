"""The inputs of a run, made from ``--seed``: the standardization
statistics, the static fields, the boundary mask, the graph and the pools
of batches. Both sides get the same: the program through its datastore
interface and its normal graph loader, the plain reference as these raw
arrays and the raw ``graph.npz``.

Every size comes from the configuration; the seed changes values only, so
every seed does the same work.
"""

from __future__ import annotations

import numpy as np
import torch

from . import graphbuild

SEED_MASK = 2**63 - 1


def substream(seed: int, k: int) -> int:
    """An independent seed for the ``k``-th kind of input."""
    return (int(seed) * 1_000_003 + 7_919 * k) & SEED_MASK


def grid_xy(cfg: dict) -> np.ndarray:
    """``(Nx, Ny, 2)`` projection coordinates of a regular grid."""
    x = cfg["grid_spacing_m"] * np.arange(cfg["grid_x"], dtype=np.float64)
    y = cfg["grid_spacing_m"] * np.arange(cfg["grid_y"], dtype=np.float64)
    return np.stack(np.meshgrid(x, y, indexing="ij"), axis=-1)


def xy_span(cfg: dict) -> float:
    """The grid's larger extent, which mesh positions are divided by."""
    return float(cfg["grid_spacing_m"] * (max(cfg["grid_x"], cfg["grid_y"]) - 1))


def graph_dir(cache, cfg: dict):
    """The configuration's graph under the cache directory, built by the
    frozen builder the first time. It depends on the sizes only."""
    name = cfg["graph"]
    key = f"{cfg['grid_x']}x{cfg['grid_y']}_{cfg['grid_spacing_m']}"
    root = cache / "graphs" / key
    out = root / "graph" / name
    if not (out / "metainfo.yaml").exists():
        tmp = root / "graph" / f".{name}.partial"
        graphbuild.create_graph(tmp, grid_xy(cfg), hierarchical=cfg["hierarchical"])
        tmp.rename(out)
    return root, out


def boundary_mask(cfg: dict) -> np.ndarray:
    """``(N,)`` float32, 1 on a border ``boundary_width`` cells wide."""
    nb = cfg["boundary_width"]
    mask = np.zeros((cfg["grid_x"], cfg["grid_y"]), np.float32)
    mask[:nb, :] = mask[-nb:, :] = mask[:, :nb] = mask[:, -nb:] = 1
    return mask.reshape(-1)


def statistics(cfg: dict, seed: int) -> dict[str, np.ndarray]:
    """Standardization statistics and static fields: physical means and
    spreads of the kind MEPS's fields have, and the standardized one-step
    differences' mean and spread."""
    rng = np.random.default_rng([substream(seed, 1)])
    n, f, s = cfg["state_vars"], cfg["forcing_vars"], cfg["static_vars"]
    n_grid = cfg["grid_x"] * cfg["grid_y"]
    static_mean = rng.normal(0.0, 5.0, s).astype(np.float32)
    static_std = rng.uniform(0.5, 3.0, s).astype(np.float32)
    return {
        "state_mean": rng.normal(0.0, 10.0, n).astype(np.float32),
        "state_std": rng.uniform(0.5, 5.0, n).astype(np.float32),
        "forcing_mean": rng.normal(0.0, 2.0, f).astype(np.float32),
        "forcing_std": rng.uniform(0.5, 2.0, f).astype(np.float32),
        "diff_mean": rng.normal(0.0, 0.02, n).astype(np.float32),
        "diff_std": rng.uniform(0.05, 0.5, n).astype(np.float32),
        "static_mean": static_mean,
        "static_std": static_std,
        "static": (static_mean + static_std * rng.standard_normal((n_grid, s))).astype(np.float32),
    }


def make_pool(cfg: dict, mix: dict, stats: dict, seed: int, device) -> list[tuple]:
    """``mix["pool"]`` batches ``(init, target, forcing)`` in physical units
    on ``device``, each ``(B, 2, N, d)``, ``(B, T, N, d)``, ``(B, T, N, f*w)``,
    drawn from ``seed`` on the device: normal about the statistics' means
    with their spreads, so that standardized values are unit normal."""
    b, t = mix["batch"], mix["ar_steps"]
    n_grid = cfg["grid_x"] * cfg["grid_y"]
    d, w = cfg["state_vars"], cfg["forcing_window"]
    gen = torch.Generator(device=device).manual_seed(substream(seed, 2))

    def tensor(a):
        return torch.as_tensor(a, device=device)

    mean, std = tensor(stats["state_mean"]), tensor(stats["state_std"])
    f_mean = tensor(np.repeat(stats["forcing_mean"], w))
    f_std = tensor(np.repeat(stats["forcing_std"], w))
    pool = []
    for _ in range(mix["pool"]):
        state = torch.randn((b, t + 2, n_grid, d), generator=gen, device=device)
        state = mean + std * state
        forcing = f_mean + f_std * torch.randn((b, t, n_grid, f_mean.numel()), generator=gen,
                                               device=device)
        pool.append((state[:, :2].contiguous(), state[:, 2:].contiguous(), forcing))
    return pool
