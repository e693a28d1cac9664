"""The port's spans and counters (``neural_lam_tpu_torch.utils.trace``) on
the CPU: nesting and self time, the two buckets that follow the
profiler, the host-only record a span opens under ``torch.profiler``,
counters and the JSON snapshot, and what the training loop records on
its eager CPU path. The captured paths' spans, graph counts and device
gaps are held on the card in ``tests/test_torch_cuda.py``."""

import json
import time

import numpy as np
import pytest
import torch

from neural_lam_tpu_torch.config import DatastoreSelection, NeuralLAMConfig
from neural_lam_tpu_torch.dataset import WeatherDataset
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.graphs import create_graph_from_datastore
from neural_lam_tpu_torch.loader import DataLoader
from neural_lam_tpu_torch.models import ARForecaster, GraphLAM, HiLAM
from neural_lam_tpu_torch.trainer import Trainer, TrainingArgs
from neural_lam_tpu_torch.utils import trace

# torch's RecordScope: what record_function opens
USER_SCOPE = 7


@pytest.fixture(autouse=True)
def _fresh():
    trace.reset()
    yield
    trace.reset()


def _trainer(tmp_path, cls=GraphLAM, graph="multiscale", side=9, **args):
    ds = DummyDatastore(root_path=tmp_path, n_grid_x=side, n_grid_y=side, n_timesteps=12)
    create_graph_from_datastore(ds, tmp_path / "graph" / graph,
                                hierarchical=graph == "hierarchical")
    model = cls(ds, hidden_dim=8, processor_layers=2, graph_name=graph, device="cpu")
    config = NeuralLAMConfig(datastore=DatastoreSelection(kind="dummydata", config_path=""))
    return Trainer(ARForecaster(model, ds), config, ds, TrainingArgs(batch_size=2, **args),
                   device="cpu"), ds


def _batch(ds, seed=0):
    rng = np.random.default_rng(seed)
    n, d = ds.num_grid_points, ds.get_num_data_vars("state")
    f = 3 * ds.get_num_data_vars("forcing")
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((2, 2, n, d), (2, 1, n, d), (2, 1, n, f)))


def test_spans_nest_and_give_self_time():
    with trace.span("call"):
        time.sleep(0.002)
        with trace.span(".inner"):
            time.sleep(0.003)
        with trace.span("child"):
            with trace.span(".leaf"):
                time.sleep(0.001)
    with trace.span("call"):
        pass
    spans = trace.snapshot()["spans"]["untraced"]
    assert set(spans) == {"call", "call.inner", "call/child", "call/child.leaf"}
    call, inner, child = spans["call"], spans["call.inner"], spans["call/child"]
    assert call["count"] == 2 and inner["count"] == child["count"] == 1
    assert inner["total_s"] >= 0.003 and spans["call/child.leaf"]["total_s"] >= 0.001
    assert call["self_s"] == pytest.approx(
        call["total_s"] - inner["total_s"] - child["total_s"], abs=1e-9)
    assert call["self_s"] >= 0.002
    assert child["self_s"] == pytest.approx(
        child["total_s"] - spans["call/child.leaf"]["total_s"], abs=1e-9)
    assert call["max_s"] >= call["median_s"] > 0
    records = trace.snapshot()["records"]
    # two calls: the first's four spans share call number 1
    assert sorted({r[0] for r in records}) == [1, 2]
    assert sorted(r[1] for r in records if r[0] == 1) == sorted(spans)
    assert all(r[2] <= r[3] for r in records)


def test_buckets_follow_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    with trace.span("outside"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("inside"):
            pass
    spans = trace.snapshot()["spans"]
    assert set(spans["untraced"]) == {"outside"}
    assert set(spans["traced"]) == {"inside"}
    assert trace.total_s("inside") == spans["traced"]["inside"]["total_s"]


def test_a_span_is_a_host_record_outside_the_user_scope(monkeypatch):
    """Under the profiler a span opens a record of its path whose scope is
    not the user scope (``record_function``'s, which the profiler mirrors
    onto the device's timeline); with no profiler it opens none."""
    from torch.profiler import ProfilerActivity, profile, record_function

    opened = []
    fast = trace._RecordFunctionFast
    assert fast is not None

    def spy(name):
        opened.append(name)
        return fast(name)

    monkeypatch.setattr(trace, "_RecordFunctionFast", spy)
    with trace.span("quiet"):
        torch.ones(4).sum()
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("step"):
            with trace.span(".launch"):
                torch.ones(4).sum()
        with record_function("user.span"):
            pass
    assert opened == ["step", "step.launch"]
    events = {e.name: e for e in prof.events()}
    assert events["user.span"].scope == USER_SCOPE  # the check can tell them apart
    for name in ("step", "step.launch"):
        assert events[name].device_type == torch.autograd.DeviceType.CPU
        assert events[name].scope != USER_SCOPE


def test_counters_count_and_the_snapshot_is_json():
    trace.count("a.captures")
    trace.count("a.captures", 2)
    trace.count("b")
    with trace.span("x"):
        with trace.span(".y"):
            pass
    snap = trace.snapshot()
    assert snap["counters"] == {"a.captures": 3, "b": 1}
    assert json.loads(json.dumps(snap)) == snap
    assert set(snap) == {"spans", "counters", "graphs", "device_gaps", "launch_counters",
                         "records", "clock"}
    assert snap["graphs"] == [] and snap["device_gaps"] == {}
    # read from ops.launch_counters(), not kept
    assert "K3 fused_edge_phase" in snap["launch_counters"]


def test_one_call_in_gap_every_opens_a_device_gap(monkeypatch):
    """Device gaps with stand-in events the card has passed (one ms
    apart): one call in ``GAP_EVERY`` records an end event and the call
    after it a start event, and no call records one while a profiler
    records."""
    recorded = []

    class Event:
        def __init__(self, t):
            self.t = t

        def query(self):
            return True

        def elapsed_time(self, other):
            return float(other.t - self.t)

    def record(device):
        trace._free_events.setdefault(0, [])
        recorded.append(device)
        return 0, Event(len(recorded))

    monkeypatch.setattr(trace, "_record", record)
    device = torch.device("cpu")

    def calls(n):
        for _ in range(n):
            trace.call_start("f", device)
            trace.call_end("f", device)

    calls(2 * trace.GAP_EVERY + 1)
    # the ends of calls 1, 17 and 33; the starts of calls 2 and 18
    assert len(recorded) == 5
    gaps = trace.snapshot()["device_gaps"]["f"]
    assert gaps["count"] == 2 and gaps["median_ms"] == gaps["max_ms"] == 1.0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        calls(2 * trace.GAP_EVERY)
    assert len(recorded) == 5
    assert trace.snapshot()["device_gaps"]["f"]["count"] == 2


@pytest.mark.parametrize("model", ["graph_lam", "hi_lam"])
def test_the_eager_cpu_step_records_no_replay(tmp_path, model):
    """On the CPU ``make_train_step`` is the eager step: its forward,
    loss, backward and optimizer spans, one ``gnn.<edge set>`` span per
    GNN application, and no captured call (no ``train_step``, no
    ``.launch``, no graph, no device gap)."""
    cls, graph, side = (GraphLAM, "multiscale", 9) if model == "graph_lam" else (
        HiLAM, "hierarchical", 27)
    tr, ds = _trainer(tmp_path, cls, graph, side)
    step = tr.make_train_step()
    for seed in range(2):
        step(*_batch(ds, seed))
    snap = trace.snapshot()
    spans = snap["spans"]["untraced"]
    assert not any(p.startswith("train_step") for p in spans)
    assert not snap["graphs"] and not snap["device_gaps"]
    for top in ("forward", "loss", "backward", "optimizer"):
        assert spans[top]["count"] == 2, top
    apps = {p.split("/", 1)[1]: s["count"] for p, s in spans.items()
            if p.startswith("forward/gnn.")}
    if model == "graph_lam":
        assert apps == {"gnn.g2m": 2, "gnn.m2m.0": 4, "gnn.m2g": 2}
    else:
        # two levels: init up, 2 layers x (down: same 1, down 0, same 0;
        # up: same 0, up 0, same 1), read-out down
        assert apps == {"gnn.g2m": 2, "gnn.m2g": 2, "gnn.mesh_up.0": 2 + 4,
                        "gnn.mesh_down.0": 2 + 4, "gnn.m2m.0": 8, "gnn.m2m.1": 8}
    assert spans["forward"]["self_s"] < spans["forward"]["total_s"]


def test_fit_reads_input_wait_from_its_span(tmp_path):
    """The epoch record's ``input_wait_seconds`` is the time of that
    epoch's ``fit.input_wait`` spans (the loader's queue); with
    ``profile_dir`` the snapshot is written beside the trace."""
    tr, ds = _trainer(tmp_path, profile_dir=str(tmp_path / "prof"), profile_steps=1)
    train = DataLoader(WeatherDataset(ds, split="train", ar_steps=1), batch_size=2,
                       shuffle=False, drop_last=True, prefetch=0)
    assert len(train) >= 4
    history = tr.fit(train, epochs=2)
    spans = trace.snapshot()["spans"]
    waits = [b["fit.input_wait"] for b in spans.values() if "fit.input_wait" in b]
    # one wait a batch and one for the end of each epoch
    assert sum(w["count"] for w in waits) == 2 * (len(train) + 1)
    total = sum(w["total_s"] for w in waits)
    assert [set(r) >= {"input_wait_seconds"} for r in history] == [True, True]
    assert sum(r["input_wait_seconds"] for r in history) == pytest.approx(total, abs=2e-3)
    assert all(r["input_wait_seconds"] >= 0 for r in history)
    saved = json.loads((tmp_path / "prof" / "trace_spans.json").read_text())
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    # written after the last epoch, not when the profiler stopped
    assert sum(b["fit.input_wait"]["count"] for b in saved["spans"].values()
               if "fit.input_wait" in b) == 2 * (len(train) + 1)
    # the profiled steps' spans sit in the traced bucket
    assert saved["spans"]["traced"]["forward"]["count"] >= 1
    assert saved["spans"]["untraced"]["forward"]["count"] >= 2


def test_threads_lose_no_span_or_count():
    """Spans and counters from more threads than cores, with the
    interpreter switching threads often: every one is counted, and each
    thread's spans nest under its own parent."""
    import os
    import sys
    import threading

    workers, each = 2 * (os.cpu_count() or 4), 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(each):
                with trace.span("t"):
                    with trace.span(".inner"):
                        trace.count("n")

        threads = [threading.Thread(target=work) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    snap = trace.snapshot()
    spans = snap["spans"]["untraced"]
    assert set(spans) == {"t", "t.inner"}
    assert spans["t"]["count"] == spans["t.inner"]["count"] == workers * each
    assert snap["counters"]["n"] == workers * each
    assert len({r[0] for r in snap["records"]}) == workers * each


def test_a_capture_counts_its_graph_nodes(monkeypatch):
    """The capture's bookkeeping against a stand-in for libcuda whose
    graph gains nodes as the "capture" runs: each span inside it records
    the nodes it added, the graph its nodes by type, and the capture the
    launches the kernel wrappers counted inside it."""
    import ctypes
    from types import SimpleNamespace

    from neural_lam_tpu_torch.ops import segment_kernels

    graph = {"types": []}  # CUgraphNodeType of each node, in order

    def info(stream, status, capture_id, graph_out, *rest):
        status._obj.value = 1  # active
        graph_out._obj.value = 4096
        return 0

    def get_nodes(handle, out, count):
        if out is not None:
            slots = ctypes.cast(out, ctypes.POINTER(ctypes.c_void_p))
            for i in range(len(graph["types"])):
                slots[i] = i + 1
        count._obj.value = len(graph["types"])
        return 0

    def get_type(node, kind):
        kind._obj.value = graph["types"][node.value - 1]
        return 0

    monkeypatch.setattr(trace, "_libcuda_fns", [(info, 3, get_nodes, get_type)])
    monkeypatch.setattr(segment_kernels.sender_gather, "launches",
                        segment_kernels.sender_gather.launches)
    with trace.span("step"):
        with trace.span(".capture"):
            with trace.graph_capture("step", SimpleNamespace(cuda_stream=0)):
                with trace.span("forward"):
                    with trace.span("gnn.g2m"):
                        graph["types"] += [0, 0, 2]  # two kernels, a memset
                        segment_kernels.sender_gather.launches += 1
                    graph["types"] += [0, 1]
                with trace.span("backward"):
                    graph["types"] += [0, 0, 0, 7]  # an event record node
    snap = trace.snapshot()
    spans = snap["spans"]["untraced"]
    assert spans["step.capture.record/forward/gnn.g2m"]["nodes"] == 3
    assert spans["step.capture.record/forward"]["nodes"] == 5
    assert spans["step.capture.record/backward"]["nodes"] == 4
    assert spans["step.capture.record"]["nodes"] == 9
    assert spans["step.capture"]["nodes"] == 0  # it began before the capture
    (g,) = snap["graphs"]
    assert g["name"] == "step" and g["call"] == 1
    assert g["nodes"] == {"kernel": 6, "memcpy": 1, "memset": 1, "other": 1}
    assert g["launches"] == {"K1 sender_gather": 1}
    assert g["capture_s"] > 0 and snap["counters"] == {"step.captures": 1}
    assert json.loads(json.dumps(snap)) == snap
