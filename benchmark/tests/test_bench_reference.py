"""The plain reference against the port's CPU path at a tiny size, and (on
the card) the control, the reference in TF32, failing the cells' limits."""

from __future__ import annotations

import pytest
import torch

from benchmark import checks, harness, inputs
from benchmark.models import plain
from conftest import ROOT, SEED, shrink


@pytest.mark.parametrize("cell", ["graphlam_train_f32", "hilam_train_f32"])
def test_one_step_of_the_reference_is_the_ports(tiny_root, cell):
    c = harness.Cell(tiny_root, cell)
    ctx = harness.make_context(c, SEED, 0.0, False, "cpu", [])
    st = checks.reference_stats(ctx)
    g = plain.load_graph(ctx.graph_dir, inputs.xy_span(ctx.cfg), "cpu")
    step = ctx.family.make_step(ctx.weights, g, st, ctx.cfg)
    init, target, forcing = checks._standardized(ctx.pool[0], st)
    with torch.no_grad():
        want = step(init[:, 1], init[:, 0], forcing[:, 0])
        # the port's step runs node-major, (N, B, d)
        got, _ = ctx.model.step(*(a.transpose(0, 1) for a in
                                   (init[:, 1], init[:, 0], forcing[:, 0])))
    torch.testing.assert_close(got.transpose(0, 1), want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["graphlam_train_f32", "graphlam_forecast_f32"])
def test_the_control_is_not_correct(cuda, tmp_path, cell):
    """The reference in TF32 in the program's place, at a size a test run
    holds: at least one number over the cell's limit."""
    import shutil

    from benchmark.control import readings

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "tests"))
    c = harness.Cell(shrink(tmp_path), cell)
    got = readings(c, SEED, "cuda")["control"]
    assert not checks.judge(got, c.limits)[0], got
