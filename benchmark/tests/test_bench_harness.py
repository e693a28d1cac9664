"""The harness finds every part of a cell by name, runs a cell made of
files alone, and prints the contract's result line; no module it loads
is JAX or the JAX package."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import harness
from conftest import ROOT, SEED, write_json

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_part_of_a_cell_is_found_by_name(cell):
    c = harness.Cell(ROOT, cell)
    assert c.cfg["family"] and c.mix["kind"] and c.limits
    c.module("models", c.cfg["family"])
    c.module("drivers", c.mix["kind"])
    for section in ("end_to_end", "per_layer"):
        assert c.metrics(section), section
    assert "setup_s" in [m["name"] for m in c.metrics("end_to_end")]


@pytest.mark.parametrize("metric", [m["name"] for m in MANIFEST["per_layer"]])
def test_each_metric_reader_reads_nothing_where_nothing_is(metric):
    read = harness.Cell(ROOT, MANIFEST["workloads"][0]["name"]).reader(metric)
    for kind in ("train", "forecast"):
        obs = {"kind": kind, "calls": 0, "window_s": 1.0, "trace": None, "precision": "32",
               "enqueue_s": [], "gap_s": [], "flops_per_call": 0.0, "kernel_bounds_s": {}}
        assert read(obs) is None


def test_a_cell_added_as_files_runs_through_the_harness(tiny_root):
    """A new configuration, mix, limits file, per-layer metric and cell,
    added as files and entries only."""
    bench = tiny_root / "benchmark"
    cfg = json.loads((bench / "configs" / "graphlam_meps.json").read_text())
    write_json(bench / "configs" / "graphlam_wide.json", {**cfg, "processor_layers": 3})
    mix = json.loads((bench / "mixes" / "train_b4.json").read_text())
    write_json(bench / "mixes" / "train_b1.json", {**mix, "batch": 1})
    limits = json.loads((bench / "limits" / "graphlam_train_f32.json").read_text())
    write_json(bench / "limits" / "graphlam_wide_train_b1.json", limits)
    (bench / "metrics" / "calls_seen.train.py").write_text(
        "def read(obs):\n    return float(obs['calls']) if obs['kind'] == 'train' else None\n")
    man = json.loads((tiny_root / "BENCHMARK.json").read_text())
    man["configs"].append({**man["configs"][0], "name": "graphlam_wide",
                           "file": "benchmark/configs/graphlam_wide.json"})
    man["workloads"].append({"name": "graphlam_wide_train_b1", "config": "graphlam_wide",
                             "traffic": "train_b1", "chips": 1, "why": "test"})
    man["per_layer"].append({"name": "calls_seen.train", "unit": "calls", "better": "higher",
                             "source": "program_counter", "layer": "training loop",
                             "moves": "train_gps", "workloads": ["graphlam_wide_train_b1"]})
    for m in man["end_to_end"] + man["per_layer"]:
        if "graphlam_train_f32" in m.get("workloads", []):
            m["workloads"].append("graphlam_wide_train_b1")
    write_json(tiny_root / "BENCHMARK.json", man)

    out = harness.run_cell(tiny_root, "graphlam_wide_train_b1", SEED, 0.5, True, device="cpu")
    assert out["correct"], out["checks"]
    assert out["metrics"]["calls_seen.train"]["value"] == out["attempted"] > 0
    assert {"enqueue_ms.train", "mfu.train"} <= set(out["metrics"])


def test_the_result_line_has_the_contracts_shape(tiny_root):
    out = harness.run_cell(tiny_root, "graphlam_forecast_f32", SEED, 0.5, False, device="cpu")
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"forecast_gps", "forecast_p95_ms", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for check in out["checks"].values():
        assert set(check) == {"value", "limit"}
    json.loads(json.dumps(out))
    assert harness.summary_lines(out)[0].startswith("check forecast_rel_l2: ")


def test_a_run_without_a_card_prints_no_result(tmp_path):
    """No card: exit 1, no line on standard output (this machine has none
    where the test runs on the CPU; on a card the run would measure)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    got = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
                          "graphlam_train_f32", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=120)
    assert got.returncode == 1 and got.stdout == ""
    assert "needs 1 CUDA device" in got.stderr


def test_no_module_a_run_loads_is_jax_or_the_jax_package(tiny_root):
    """The whole run on the CPU in a fresh process: nothing loaded has the
    top-level name jax, jaxlib, flax or neural_lam_tpu, compared whole."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness\n"
        "harness.run_cell(__import__('pathlib').Path(%r), 'hilam_train_f32', 5, 0.2, False, "
        "device='cpu')\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    ) % (str(ROOT), str(tiny_root))
    got = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert got.returncode == 0, got.stderr[-3000:]
    loaded = set(eval(got.stdout.strip().splitlines()[-1]))
    assert "neural_lam_tpu_torch" in loaded and "torch" in loaded
    assert not harness.forbidden_modules(loaded)
    assert harness.forbidden_modules(["jax.numpy", "neural_lam_tpu.ops"]) == ["jax",
                                                                              "neural_lam_tpu"]
    assert harness.forbidden_modules(["neural_lam_tpu_torch.ops"]) == []


def test_the_reference_loads_nothing_of_the_program(tiny_root):
    """The plain reference's run, apart from the program: no module of
    ``neural_lam_tpu_torch`` (nor JAX) is loaded."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from pathlib import Path\n"
        "from benchmark import checks, harness\n"
        "from benchmark.control import reference_inputs\n"
        "cell = harness.Cell(Path(%r), 'graphlam_train_f32')\n"
        "ctx = reference_inputs(cell, 3, 'cpu')\n"
        "checks.reference_training(ctx, 1)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    ) % (str(ROOT), str(tiny_root))
    got = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin"})
    assert got.returncode == 0, got.stderr[-3000:]
    loaded = set(eval(got.stdout.strip().splitlines()[-1]))
    assert "torch" in loaded
    assert "neural_lam_tpu_torch" not in loaded and not harness.forbidden_modules(loaded)
