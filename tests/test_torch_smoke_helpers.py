"""``chip_smoke.py``'s measurement helpers on the CPU: what they read from
a profile and from the parent commit's own script, with the profiler and
the subprocess stubbed, so they need no card and no compiler.
"""

import importlib.util
import types
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Profile:
    """A stand-in for ``torch.profiler.profile``: each profile taken hands
    out the next list of events."""

    runs: list = []
    taken = 0

    def __init__(self, activities=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        type(self).taken += 1
        return type(self).runs.pop(0)


def _kernel(name, us):
    return types.SimpleNamespace(device_type=torch.autograd.DeviceType.CUDA, name=name,
                                 device_time_total=us)


@pytest.mark.parametrize("empty", [0, 1, 2, 3])
def test_device_kernels_profiles_again_when_no_kernel_was_recorded(smoke, monkeypatch, empty):
    """A profile in which the profiler kept no device record of the call is
    taken again, up to three in all; the first with records is summed
    (copies and fills left out), and three empty ones raise."""
    record = [_kernel("fused_edge_v2_fwd", 1500.0), _kernel("Memcpy HtoD", 900.0),
              _kernel("gemm", 500.0)]
    monkeypatch.setattr(_Profile, "runs", [[] for _ in range(empty)] + [record])
    monkeypatch.setattr(_Profile, "taken", 0)
    monkeypatch.setattr(torch.profiler, "profile", _Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    calls = []
    if empty == 3:
        with pytest.raises(AssertionError, match="no kernel"):
            smoke.device_kernels(torch, lambda: calls.append(1))
        assert _Profile.taken == 3
        return
    assert smoke.device_kernels(torch, lambda: calls.append(1)) == (2.0, 2)
    assert _Profile.taken == empty + 1 and len(calls) == empty + 2  # a warm-up call first


# the per-step lines of the node-MLP route as the smoke's fused aggr lines
# print them (phase_fused_aggr_kernels), and so the parent's own script
PARENT_LINES = """\
K3 node update per AR step: 0.2708 ms (device 0.2101 ms; bound 0.0887 ms, plain 1.6700 ms); K3 2.1380 ms, K3 + node update 2.4097 ms (device 2.2010 ms) against 3.8618 ms with the node tail in torch
K3 node update bf16 per AR step: 0.2014 ms (device 0.1217 ms; bound 0.0591 ms, plain 3.1135 ms); K3 1.4340 ms, K3 + node update 1.6352 ms (device 1.4010 ms) against 2.9819 ms with the node tail in torch
K3 node update bf16 operands per AR step: 0.2418 ms (device 0.1346 ms; bound 0.0887 ms, plain 2.8021 ms); K3 1.4810 ms, K3 + node update 1.7228 ms (device 1.5020 ms) against 3.1630 ms with the node tail in torch
K4 node backward per training step: 0.8919 ms against 7.3055 ms unfused (bound 0.1726 ms, plain 6.8558 ms; device time (torch.profiler) 0.8186 ms, 21.1 % of the bound)
K4 node backward bf16 per training step: 0.8163 ms against 7.6733 ms unfused (bound 0.1035 ms, plain 11.0533 ms; device time (torch.profiler) 0.3569 ms, 29.0 % of the bound)
K4 node backward bf16 operands per training step: 0.6961 ms against 9.2132 ms unfused (bound 0.1478 ms, plain 12.1546 ms; device time (torch.profiler) 0.3745 ms, 39.5 % of the bound)
"""


def test_parent_aggr_run_reads_the_parent_scripts_per_step_lines(smoke, monkeypatch, tmp_path):
    """``parent_aggr_run`` reads, from the parent checkout's own
    ``profile_forecast.py --aggr-kernels``, its K3 + node update and its
    node backward per step in each precision (the lines this script prints
    too), and keeps the whole output under ``chiprun_out``."""
    seen = []

    def run(cmd, cwd, **kw):
        seen.append((cmd[1:], cwd))
        return types.SimpleNamespace(returncode=0, stdout="header\n" + PARENT_LINES, stderr="")

    monkeypatch.setattr(smoke.subprocess, "run", run)
    monkeypatch.setattr(smoke, "REPO", tmp_path)
    found = smoke.parent_aggr_run(tmp_path / "parent", "before")
    assert seen == [(["profile_forecast.py", "--aggr-kernels"], tmp_path / "parent")]
    assert found == {
        "": dict(k3_node_ms=2.4097, k3_tail_ms=3.8618, bwd_ms=0.8919, bwd_dev_ms=0.8186),
        " bf16": dict(k3_node_ms=1.6352, k3_tail_ms=2.9819, bwd_ms=0.8163, bwd_dev_ms=0.3569),
        " bf16 operands": dict(k3_node_ms=1.7228, k3_tail_ms=3.1630, bwd_ms=0.6961,
                               bwd_dev_ms=0.3745),
    }
    assert (tmp_path / "chiprun_out" / "parent_aggr_before.log").read_text().endswith(
        PARENT_LINES)
    # a run without the lines of each precision fails
    monkeypatch.setattr(smoke.subprocess, "run", lambda cmd, cwd, **kw: types.SimpleNamespace(
        returncode=0, stdout=PARENT_LINES.splitlines()[3] + "\n", stderr=""))
    with pytest.raises(AssertionError, match="no per-step line"):
        smoke.parent_aggr_run(tmp_path / "parent", "after")
