"""Fixtures of the benchmark's own tests: a checkout-shaped copy of the
benchmark whose cells are cut to a size the CPU runs in seconds, and the
``cuda`` fixture that skips a test without a card."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a grid of 30 x 28 has two mesh levels, the least a hierarchy needs
TINY_CONFIG = dict(grid_x=30, grid_y=28, hidden_dim=16, processor_layers=2, boundary_width=2)
TINY_MIX = {"train": dict(batch=2, pool=4), "forecast": dict(batch=2, pool=2, ar_steps=3)}
SEED = 2**31 + 977


def write_json(path: Path, obj: dict) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n", encoding="utf-8")


def shrink(root: Path) -> Path:
    """Cut every configuration and mix under ``root`` to the tiny sizes."""
    bench = root / "benchmark"
    for path in (bench / "configs").glob("*.json"):
        write_json(path, {**json.loads(path.read_text()), **TINY_CONFIG})
    for path in (bench / "mixes").glob("*.json"):
        mix = json.loads(path.read_text())
        write_json(path, {**mix, **TINY_MIX[mix["kind"]]})
    return root


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A copy of ``BENCHMARK.json`` and the benchmark's data files under
    ``tmp_path``, cut to the tiny sizes."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    return shrink(tmp_path)


@pytest.fixture
def cuda():
    """Skip without a CUDA card (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
