"""The benchmark's measuring rod: the card's peaks, a kernel's least time,
and the reduction of a ``torch.profiler`` trace to busy time, idle gaps
and device time per kernel.

``bound``, the peaks and ``HBM_BYTES_PER_S`` are frozen copies of
``chip_smoke.py``'s (commit feda1b7): NVIDIA's data sheet for the H100
SXM at 700 W. The per-name mean of :func:`group_time_per_call` is that of
``chip_smoke.device_ms`` (feda1b7): the profiler may lose some of a
kernel's records in a long process, so each kernel name's time is the
mean over the records it kept times the launches it makes.
"""

from __future__ import annotations

import json
import re
from collections import defaultdict
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
# The peak a step's share is taken against, per precision. K3, K4, K7 and
# K8 run their float32 products as three TF32 products each (3xTF32), so
# float32 work is held against a third of the TF32 rate, as the kernels'
# bound is; bf16 against the dense bf16 rate.
STEP_PEAK_FLOP_PER_S = {"32": TF32_FLOP_PER_S / 3, "bf16": BF16_FLOP_PER_S}


def bound(nbytes: float, flops: float, tensor: bool = False) -> tuple[float, str]:
    """Least time in ms for ``nbytes`` moved and ``flops`` done, and
    which of the two sets it. With ``tensor`` the operations are float32
    products that the tensor cores do at float32 accuracy as three TF32
    products; else they run on the float32 SIMT units."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (3 * flops / TF32_FLOP_PER_S) if tensor else flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_table() -> dict:
    """``kernels.json``: the groups of the port's hand-written kernels
    and of the optimizer's kernels, as patterns over the names that the
    profiler reports."""
    table = json.loads((HERE / "kernels.json").read_text(encoding="utf-8"))
    return {
        key: {name: re.compile(pattern) for name, pattern in groups.items()}
        for key, groups in table.items() if isinstance(groups, dict)
    }


def group_of(name: str, groups: dict) -> Optional[str]:
    """The first group whose pattern matches the kernel ``name``."""
    for group, pattern in groups.items():
        if pattern.search(name):
            return group
    return None


def merge_intervals(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def reduce_trace(device_events: list, host_events: list, window: tuple[float, float],
                 calls: int, top: int = 10) -> dict:
    """Reduce a profiled sub-window of ``calls`` whole calls.

    ``device_events`` are ``(name, start_us, end_us)`` of every operation
    that ran on the card, ``host_events`` those of the host's spans and
    operators, ``window`` the ``(start_us, end_us)`` of the sub-window on
    the same clock. Returns the busy and window seconds, each kernel
    name's records, kept count and mean seconds, the ``top`` device
    operations by time and the ``top`` longest idle gaps, each named by
    the innermost host span that covers its middle.
    """
    w0, w1 = window
    clipped = [(max(s, w0), min(e, w1)) for _, s, e in device_events if e > w0 and s < w1]
    busy = merge_intervals(clipped)
    busy_us = sum(e - s for s, e in busy)
    per_name: dict[str, list[float]] = defaultdict(list)
    for name, s, e in device_events:
        per_name[name].append(e - s)
    ops = sorted(((n, sum(d) / 1e6) for n, d in per_name.items()), key=lambda x: -x[1])
    gaps, prev = [], w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for s, e in gaps[:top]:
        mid = 0.5 * (s + e)
        covering = [(he - hs, n) for n, hs, he in host_events if hs <= mid <= he]
        label = min(covering)[1] if covering else "host: outside any span"
        named.append([label[:96], (e - s) / 1e6])
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "records": {n: len(d) for n, d in per_name.items()},
        "mean_s": {n: sum(d) / len(d) / 1e6 for n, d in per_name.items()},
        "calls": calls,
        # names whose records are not a whole number a call: the profiler lost some
        "short_names": sorted(n for n, d in per_name.items() if len(d) % calls),
        "device_ops": [[n[:96], t] for n, t in ops[:top]],
        "idle_gaps": named,
    }


def launches_per_call(records: int, calls: int) -> int:
    """A kernel name's launches per call from its records over ``calls``
    calls; where the profiler lost records the count is rounded up to the
    next whole launch per call."""
    return -(-records // calls)


def group_time_per_call(trace: dict, groups: dict) -> dict[str, float]:
    """Device seconds per call of each kernel group: per kernel name, the
    mean over the records kept times its launches per call."""
    out: dict[str, float] = defaultdict(float)
    for name, n in trace["records"].items():
        group = group_of(name, groups)
        if group is not None:
            out[group] += trace["mean_s"][name] * launches_per_call(n, trace["calls"])
    return dict(out)

