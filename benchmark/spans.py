"""What the program's own tracing (``neural_lam_tpu_torch.utils.trace``)
holds after a run, for the per-layer metrics that read it.

Each reader takes the run's ``observed`` and, for its tests, a snapshot
in place of the program's (``snapshot``). Nothing is read from a run of
another kind, from a run that made no call, or where the program has no
such module (a commit before it): the readers return None. Spans are
read from the ``untraced`` bucket: the window and set-up, not the
profiler's sub-window.
"""

from __future__ import annotations

from typing import Optional


def program_snapshot() -> Optional[dict]:
    """The program's ``trace.snapshot()``, or None where it has none."""
    try:
        from neural_lam_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.snapshot()


def _snapshot(obs: dict, kind: str, snapshot: Optional[dict]) -> Optional[dict]:
    if obs.get("kind") != kind or not obs.get("calls"):
        return None
    return program_snapshot() if snapshot is None else snapshot


def span_mean_s(obs: dict, kind: str, path: str,
                snapshot: Optional[dict] = None) -> Optional[float]:
    """Mean seconds of the span ``path`` over its untraced occurrences."""
    snap = _snapshot(obs, kind, snapshot)
    span = snap and snap.get("spans", {}).get("untraced", {}).get(path)
    if not span or not span["count"]:
        return None
    return span["total_s"] / span["count"]


def gap_median_ms(obs: dict, kind: str, name: str,
                  snapshot: Optional[dict] = None) -> Optional[float]:
    """Median gap on the card between two calls ``name``, ms: the
    program times one untraced call's gap in ``GAP_EVERY``."""
    snap = _snapshot(obs, kind, snapshot)
    gaps = snap and snap.get("device_gaps", {}).get(name)
    if not gaps or not gaps["count"]:
        return None
    return gaps["median_ms"]


def graph_kernels(obs: dict, kind: str, name: str,
                  snapshot: Optional[dict] = None) -> Optional[float]:
    """Kernel nodes of the last graph ``name`` the program captured."""
    snap = _snapshot(obs, kind, snapshot)
    graphs = [g for g in (snap or {}).get("graphs", [])
              if g["name"] == name and g.get("nodes")]
    return float(graphs[-1]["nodes"]["kernel"]) if graphs else None
