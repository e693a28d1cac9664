"""Batch standardization (counterpart of ``Trainer.standardize_batch`` in
``neural_lam_tpu/trainer.py``). The training loop comes with the
training slice."""

from __future__ import annotations

import numpy as np
import torch

from .datastore.base import BaseDatastore


def standardization_stats(datastore: BaseDatastore) -> dict[str, np.ndarray]:
    """State and forcing mean/std, stds clamped away from zero
    (reference: module.py:289-305)."""
    eps = np.finfo(np.float32).eps
    stats = datastore.get_standardization_dataarray(category="state")
    if datastore.get_num_data_vars("forcing") > 0:
        f_stats = datastore.get_standardization_dataarray(category="forcing")
    else:
        f_stats = {}
    return {
        "state_mean": np.asarray(stats["state_mean"], np.float32),
        "state_std": np.maximum(np.asarray(stats["state_std"], np.float32), eps),
        "forcing_mean": np.asarray(f_stats.get("forcing_mean", np.zeros(0)), np.float32),
        "forcing_std": np.maximum(
            np.asarray(f_stats.get("forcing_std", np.ones(0)), np.float32), eps
        ),
    }


def standardize_batch(
    init_states: torch.Tensor,
    target_states: torch.Tensor,
    forcing: torch.Tensor,
    stats: dict[str, np.ndarray],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Standardize state and windowed forcing on their device. The
    forcing stats repeat per window position, feature-major
    (reference: module.py:307-337)."""
    dev = init_states.device
    mean = torch.as_tensor(stats["state_mean"], device=dev)
    std = torch.as_tensor(stats["state_std"], device=dev)
    init_states = (init_states - mean) / std
    target_states = (target_states - mean) / std
    width = forcing.shape[-1]
    n_f = stats["forcing_mean"].shape[-1]
    if width > 0 and n_f > 0:
        window = width // n_f
        f_mean = torch.as_tensor(np.repeat(stats["forcing_mean"], window), device=dev)
        f_std = torch.as_tensor(np.repeat(stats["forcing_std"], window), device=dev)
        forcing = (forcing - f_mean) / f_std
    return init_states, target_states, forcing
