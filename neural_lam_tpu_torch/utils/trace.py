"""Spans and counters inside the port, kept in memory.

One system for the program's own tracing:

- :func:`span` times a host stage. Spans nest: each records its path
  (``train_step.check``: a name that starts with ``.`` extends its
  parent's; any other is a child, ``forward/gnn.g2m``), its duration
  and its self time (the duration less what its children cover). Every
  span adds to an aggregate of its path (count, total, self total, max)
  and keeps its last :data:`RING` durations. Aggregates go into one of
  two buckets: ``traced`` while a ``torch.profiler`` is recording,
  ``untraced`` otherwise. While a profiler records, a span also opens a
  host-only record of its path (``_RecordFunctionFast``, function
  scope), so that it sits in the profiler's trace among its host events
  with no annotation on the device's timeline; with no profiler a span
  costs a flag check, two clock reads and one aggregate update.
- Each outermost span is a call and gets a number; a bounded ring keeps
  (call, path, start, end) for export, on ``time.perf_counter_ns``
  (``CLOCK_MONOTONIC``); ``snapshot()["clock"]`` gives its offset from
  the Unix clock that the profiler's events are kept on.
- :func:`count` keeps integer counters.
- :func:`call_start` and :func:`call_end` mark a captured call. One
  call in :data:`GAP_EVERY` records a CUDA event on the caller's stream
  at its end, and the next call one at its start: the card's gap between
  the two is resolved later with ``query()``, never by waiting for the
  device. No event is recorded while a profiler records (its device
  trace holds the gaps), so the device gaps are the untraced calls'.
- :func:`graph_capture` marks a CUDA graph capture: spans inside it
  record how many graph nodes the capture gained within them, and at its
  end the graph's nodes by type, the launches of the port's kernels it
  holds (``ops.launch_counters()`` over the capture: one replay's) and
  the capture's host seconds are kept (:func:`snapshot`'s ``graphs``).
  The nodes are read through libcuda (``cuStreamGetCaptureInfo``,
  ``cuGraphGetNodes``) before the graph is instantiated.

:func:`snapshot` returns all of it as one JSON-able dict.
"""

from __future__ import annotations

import ctypes
import statistics
import threading
import time
from collections import deque
from typing import Optional

import torch

try:  # a function-scope record: the profiler gives it no device annotation
    from torch._C._profiler import _RecordFunctionFast
except ImportError:  # pragma: no cover - older torch: spans stay off the trace
    _RecordFunctionFast = None

RING = 4096  # durations and device gaps kept per path
GAP_EVERY = 16  # one call in this many opens a device gap
RECORDS = 16384  # span records kept for export
GRAPHS = 64  # captured graphs kept
BUCKETS = ("untraced", "traced")
# CUgraphNodeType
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset"}

_profiling = torch.autograd._profiler_enabled
_clock = time.perf_counter_ns


class _Local(threading.local):
    """A thread's open spans and the capture it is recording, if any."""

    def __init__(self) -> None:
        self.stack: list = []
        self.capture: Optional["_Capture"] = None


_local = _Local()
_lock = threading.Lock()  # the shared aggregates, counters and rings

# path -> [count, total ns, self ns, max ns, graph nodes], per bucket
_aggregates: tuple[dict, dict] = ({}, {})
_durations: tuple[dict, dict] = ({}, {})
_records: deque = deque(maxlen=RECORDS)
_counters: dict[str, int] = {}
_graphs: deque = deque(maxlen=GRAPHS)
_calls = [0]
# name -> _Calls (device gaps); device index -> free events
_device_calls: dict[str, "_Calls"] = {}
_free_events: dict[int, list] = {}


class _Span:
    __slots__ = ("name", "path", "call", "t0", "child", "traced", "record", "nodes0")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "_Span":
        stack = _local.stack
        if stack:
            parent = stack[-1]
            self.call = parent.call
            sep = "" if self.name[0] == "." else "/"
            self.path = parent.path + sep + self.name
        else:
            with _lock:
                _calls[0] += 1
                self.call = _calls[0]
            self.path = self.name.lstrip(".")
        self.child = 0
        self.traced = _profiling()
        self.record = None
        if self.traced and _RecordFunctionFast is not None:
            self.record = _RecordFunctionFast(self.path)
            self.record.__enter__()
        capture = _local.capture
        self.nodes0 = capture.nodes() if capture is not None else None
        stack.append(self)
        self.t0 = _clock()
        return self

    def __exit__(self, *exc) -> None:
        t1 = _clock()
        stack = _local.stack
        stack.pop()
        d = t1 - self.t0
        if stack:
            stack[-1].child += d
        nodes = 0
        if self.nodes0 is not None:
            nodes = _local.capture.nodes() - self.nodes0
        if self.record is not None:
            self.record.__exit__(None, None, None)
        b = 1 if self.traced else 0
        with _lock:
            agg = _aggregates[b].get(self.path)
            if agg is None:
                agg = _aggregates[b][self.path] = [0, 0, 0, 0, 0]
                _durations[b][self.path] = deque(maxlen=RING)
            agg[0] += 1
            agg[1] += d
            agg[2] += d - self.child
            if d > agg[3]:
                agg[3] = d
            agg[4] += nodes
            _durations[b][self.path].append(d)
            _records.append((self.call, self.path, self.t0, t1))


def span(name: str) -> _Span:
    """A context manager that times a host stage named ``name`` (see the
    module's docstring); a name that starts with ``.`` extends the
    enclosing span's path."""
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def total_s(path: str) -> float:
    """Seconds spent in the spans of ``path``, in both buckets."""
    with _lock:
        return sum(bucket[path][1] for bucket in _aggregates if path in bucket) / 1e9


# -- the card's gap between calls ------------------------------------------
class _Calls:
    """The device gaps of the calls of one name: the calls ended, the
    end event of the last one sampled, and the (end, next start) pairs not
    resolved yet."""

    __slots__ = ("ended", "last_end", "pending")

    def __init__(self) -> None:
        self.ended = 0
        self.last_end = None
        self.pending: deque = deque()


# name -> ring of gaps (ms) and [count, total ms]
_gaps: dict = {}


def _record(device: torch.device):
    """A timing event from ``device``'s free list, recorded on its current
    stream, with the device's index; the caller holds ``_lock``."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    free = _free_events.setdefault(index, [])
    event = free.pop() if free else torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(index))  # an index is cheaper than a device
    return index, event


def _resolve(name: str, calls: _Calls) -> None:
    """Move the gaps of ``name`` the card has passed into their rings;
    the caller holds ``_lock``."""
    pending = calls.pending
    while pending:
        (i, end), (j, start) = pending[0]
        if not (end.query() and start.query()):
            return
        pending.popleft()
        gap = end.elapsed_time(start)
        ring = _gaps.get(name)
        if ring is None:
            ring = _gaps[name] = (deque(maxlen=RING), [0, 0.0])
        ring[0].append(gap)
        ring[1][0] += 1
        ring[1][1] += gap
        _free_events[i].append(end)
        _free_events[j].append(start)


def _calls_of(name: str) -> _Calls:
    calls = _device_calls.get(name)
    if calls is None:
        calls = _device_calls[name] = _Calls()
    return calls


def call_start(name: str, device: torch.device) -> None:
    """Mark the start of a captured call ``name`` on ``device``'s current
    stream, before its first input copy: a start event where the last
    call ended one."""
    calls = _device_calls.get(name)
    if calls is None or calls.last_end is None or _profiling():
        return
    with _lock:
        if calls.last_end is not None:
            calls.pending.append((calls.last_end, _record(device)))
            calls.last_end = None


def call_end(name: str, device: torch.device) -> None:
    """Mark the end of a captured call ``name``, after its last output
    copy: an end event on one call in :data:`GAP_EVERY`. Resolve the
    earlier gaps that the card has passed: here, once the call's work is
    queued, and not between its start and its launch, where a closed loop
    would wait for it."""
    with _lock:
        calls = _calls_of(name)
        if calls.last_end is not None:  # no start followed it: reuse it
            _free_events[calls.last_end[0]].append(calls.last_end[1])
            calls.last_end = None
        if calls.ended % GAP_EVERY == 0 and not _profiling():
            calls.last_end = _record(device)
        calls.ended += 1
        _resolve(name, calls)


# -- graphs counted at capture ---------------------------------------------
_libcuda_fns: list = []  # [libcuda's functions] once looked up, [None] without them


def _libcuda():
    """``(get_capture_info, its trailing arguments, graph_get_nodes,
    node_get_type)`` from libcuda, or None where it cannot be loaded."""
    if not _libcuda_fns:
        try:
            lib = ctypes.CDLL("libcuda.so.1")
            ptr, out = ctypes.c_void_p, ctypes.POINTER
            # the first four arguments are the same in _v2 and _v3; the
            # rest are passed as null
            for symbol, rest in (("cuStreamGetCaptureInfo_v3", 3),
                                 ("cuStreamGetCaptureInfo_v2", 2)):
                info = getattr(lib, symbol, None)
                if info is not None:
                    info.argtypes = [ptr, out(ctypes.c_int), out(ctypes.c_uint64),
                                     out(ptr)] + [ptr] * rest
                    info.restype = ctypes.c_int
                    break
            else:
                raise OSError("libcuda has no cuStreamGetCaptureInfo_v2/_v3")
            nodes = lib.cuGraphGetNodes
            nodes.argtypes = [ptr, ptr, out(ctypes.c_size_t)]
            nodes.restype = ctypes.c_int
            kind = lib.cuGraphNodeGetType
            kind.argtypes = [ptr, out(ctypes.c_int)]
            kind.restype = ctypes.c_int
            _libcuda_fns.append((info, rest, nodes, kind))
        except OSError:
            _libcuda_fns.append(None)
    return _libcuda_fns[0]


class _Capture:
    """The graph a stream is capturing into, read through libcuda."""

    __slots__ = ("name", "graph", "cuda")

    def __init__(self, name: str, stream) -> None:
        self.name = name
        self.graph = None
        self.cuda = _libcuda()
        if self.cuda is None:
            return
        info, rest = self.cuda[:2]
        status, graph = ctypes.c_int(), ctypes.c_void_p()
        err = info(ctypes.c_void_p(stream.cuda_stream), ctypes.byref(status), None,
                   ctypes.byref(graph), *([None] * rest))
        if err == 0 and status.value == 1:  # CU_STREAM_CAPTURE_STATUS_ACTIVE
            self.graph = graph

    def nodes(self) -> int:
        if self.graph is None:
            return 0
        n = ctypes.c_size_t(0)
        self.cuda[2](self.graph, None, ctypes.byref(n))
        return n.value

    def nodes_by_type(self) -> Optional[dict[str, int]]:
        if self.graph is None:
            return None
        get_nodes, get_type = self.cuda[2:]
        n = ctypes.c_size_t(self.nodes())
        handles = (ctypes.c_void_p * n.value)()
        get_nodes(self.graph, ctypes.cast(handles, ctypes.c_void_p), ctypes.byref(n))
        out = dict.fromkeys([*NODE_TYPES.values(), "other"], 0)
        kind = ctypes.c_int()
        for h in handles[: n.value]:
            get_type(ctypes.c_void_p(h), ctypes.byref(kind))
            out[NODE_TYPES.get(kind.value, "other")] += 1
        return out


class _GraphCapture:
    """The ``.record`` span of a capture into ``stream``'s graph, entered
    once the capture has begun and left before it ends."""

    __slots__ = ("name", "stream", "span", "launches", "call")

    def __init__(self, name: str, stream) -> None:
        self.name, self.stream = name, stream

    def __enter__(self) -> "_GraphCapture":
        self.launches = _launches()
        _local.capture = _Capture(self.name, self.stream)
        self.span = _Span(".record").__enter__()
        return self

    def __exit__(self, *exc) -> None:
        nodes = _local.capture.nodes_by_type() if exc[0] is None else None
        self.span.__exit__(*exc)
        _local.capture = None
        if exc[0] is not None:
            return
        after = _launches()
        _graphs.append({
            "name": self.name, "call": self.span.call, "nodes": nodes,
            "launches": {k: v - self.launches[k] for k, v in after.items()
                         if v != self.launches[k]},
            "capture_s": (_clock() - self.span.t0) / 1e9,
        })
        count(f"{self.name}.captures")


def graph_capture(name: str, stream) -> _GraphCapture:
    """Enter inside ``torch.cuda.graph(..., stream=stream)``: the capture
    of graph ``name`` as the span ``.record``, its nodes counted."""
    return _GraphCapture(name, stream)


def _launches() -> dict[str, int]:
    from ..ops import launch_counters

    return {name: fn.launches for name, fn in launch_counters().items()}


# -- export ------------------------------------------------------------------
def snapshot() -> dict:
    """Everything kept, as one JSON-able dict: ``spans`` by bucket,
    ``device_gaps`` (untraced calls), ``counters``, ``graphs``,
    ``launch_counters`` (read now from ``ops.launch_counters()``),
    ``records`` and ``clock``. Device gaps the card has passed are
    resolved first (``query()``, no synchronize)."""
    with _lock:
        return _snapshot()


def _snapshot() -> dict:
    for name, calls in _device_calls.items():
        _resolve(name, calls)
    spans = {
        bucket: {
            path: {"count": a[0], "total_s": a[1] / 1e9, "self_s": a[2] / 1e9,
                   "max_s": a[3] / 1e9, "median_s": statistics.median(_durations[b][path]) / 1e9,
                   "nodes": a[4]}
            for path, a in _aggregates[b].items()
        }
        for b, bucket in enumerate(BUCKETS)
    }
    gaps = {
        name: {"count": c, "total_ms": t, "median_ms": statistics.median(ring),
               "max_ms": max(ring)}
        for name, (ring, (c, t)) in _gaps.items()
    }
    return {
        "spans": spans,
        "counters": dict(_counters),
        "graphs": [dict(g) for g in _graphs],
        "device_gaps": gaps,
        "launch_counters": _launches(),
        "records": [list(r) for r in _records],
        "clock": {"host": "time.perf_counter_ns",
                  "unix_minus_host_ns": time.time_ns() - _clock()},
    }


def reset() -> None:
    """Forget every span, counter, graph and device gap."""
    with _lock:
        for group in (_aggregates, _durations):
            for bucket in group:
                bucket.clear()
        _gaps.clear()
        _records.clear()
        _counters.clear()
        _graphs.clear()
        _device_calls.clear()
        _calls[0] = 0
