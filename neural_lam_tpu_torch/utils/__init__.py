"""Numpy and device helpers, and seeding."""

import random

import numpy as np
import torch


def seed_everything(seed: int) -> None:
    """Seed Python's, numpy's and torch's global RNGs, the counterpart of
    Lightning's ``seed_everything`` (reference:
    neural_lam/train_model.py:391). The models draw their parameters
    from their own seeded generator, not from these."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
