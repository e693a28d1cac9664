"""The readers of the program's own spans and counters (``spans.py``):
each on a synthetic snapshot of ``neural_lam_tpu_torch.utils.trace``,
nothing from an empty one, a run of another kind or a run with no call,
and on the CPU, where the program captures nothing, nothing at all."""

from __future__ import annotations

import json

import pytest

from benchmark import harness, spans
from conftest import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = {m["name"]: m for m in MANIFEST["per_layer"]
           if m["source"] in ("program_span", "program_counter")}


def span(count, total_s):
    return {"count": count, "total_s": total_s, "self_s": total_s / 2, "max_s": total_s,
            "median_s": total_s / count, "nodes": 0}


SNAPSHOT = {
    "spans": {
        "untraced": {
            "train_step": span(10, 0.05), "train_step.check": span(10, 0.004),
            "train_step.launch": span(9, 0.027), "train_step.capture": span(1, 2.5),
            "forecast.launch": span(40, 0.008), "forecast.capture": span(2, 1.5),
        },
        # the profiler's sub-window: never read
        "traced": {"train_step.check": span(5, 5.0), "train_step.launch": span(5, 5.0),
                   "forecast.launch": span(5, 5.0)},
    },
    "counters": {"train_step.captures": 1},
    "graphs": [
        {"name": "train_step", "call": 1, "nodes": {"kernel": 700, "memcpy": 3, "memset": 9,
                                                      "other": 0},
         "launches": {"K3 fused_edge_phase": 4}, "capture_s": 0.4},
        {"name": "forecast", "call": 1, "nodes": {"kernel": 900, "memcpy": 0, "memset": 0,
                                                    "other": 2},
         "launches": {}, "capture_s": 0.3},
        {"name": "forecast", "call": 7, "nodes": {"kernel": 1900, "memcpy": 0, "memset": 0,
                                                    "other": 2},
         "launches": {}, "capture_s": 0.3},
        {"name": "eval_step", "call": 9, "nodes": None, "launches": {}, "capture_s": 0.1},
    ],
    "device_gaps": {
        "train_step": {"count": 9, "total_ms": 0.05, "median_ms": 0.004, "max_ms": 0.02},
        "forecast": {"count": 39, "total_ms": 30.0, "median_ms": 0.7, "max_ms": 2.0},
    },
    "launch_counters": {"K3 fused_edge_phase": 12},
    "records": [],
    "clock": {"host": "time.perf_counter_ns", "unix_minus_host_ns": 0},
}

WANT = {
    "fingerprint_ms.train": 0.4,
    "launch_ms.train": 3.0,
    "launch_ms.forecast": 0.2,
    "device_gap_ms.train": 0.004,
    "device_gap_ms.forecast": 0.7,
    "graph_kernels.train": 700.0,
    "graph_kernels.forecast": 1900.0,  # the last capture's
    "capture_s.train": 2.5,
    "capture_s.forecast": 0.75,
}


def test_every_reader_of_the_program_is_here():
    assert set(READERS) == set(WANT)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_each_reader_on_a_synthetic_snapshot(metric):
    read = harness.Cell(ROOT, READERS[metric]["workloads"][0]).reader(metric)
    kind = metric.rsplit(".", 1)[1]
    other = "forecast" if kind == "train" else "train"
    assert read({"kind": kind, "calls": 3}, SNAPSHOT) == pytest.approx(WANT[metric])
    empty = {"spans": {"untraced": {}, "traced": {}}, "counters": {}, "graphs": [],
             "device_gaps": {}, "launch_counters": {},
             "records": [], "clock": {}}
    assert read({"kind": kind, "calls": 3}, empty) is None
    assert read({"kind": kind, "calls": 3}, {}) is None
    assert read({"kind": other, "calls": 3}, SNAPSHOT) is None
    assert read({"kind": kind, "calls": 0}, SNAPSHOT) is None


@pytest.mark.parametrize("metric", sorted(WANT))
def test_each_reader_reads_nothing_from_the_programs_cpu_run(metric):
    """On the CPU the program replays no graph: after eager steps its own
    snapshot holds none of what the readers read."""
    import numpy as np
    from neural_lam_tpu_torch.utils import trace

    trace.reset()
    with trace.span("forward"):
        np.zeros(3)
    read = harness.Cell(ROOT, READERS[metric]["workloads"][0]).reader(metric)
    kind = metric.rsplit(".", 1)[1]
    assert spans.program_snapshot()["spans"]["untraced"]["forward"]["count"] == 1
    assert read({"kind": kind, "calls": 3}) is None
    trace.reset()


def test_a_program_without_the_module_reads_nothing(monkeypatch):
    """A commit before the program's tracing: the import fails and every
    reader returns None."""
    import builtins

    real = builtins.__import__

    def no_trace(name, *args, **kwargs):
        if name == "neural_lam_tpu_torch.utils" and "trace" in (args[2] or ()):
            raise ImportError("cannot import name 'trace'")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_trace)
    assert spans.program_snapshot() is None
    for metric in WANT:
        kind = metric.rsplit(".", 1)[1]
        read = harness.Cell(ROOT, READERS[metric]["workloads"][0]).reader(metric)
        assert read({"kind": kind, "calls": 3}) is None
