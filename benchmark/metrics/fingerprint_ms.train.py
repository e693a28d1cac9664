"""Host time of the training step's check before it replays (the span
``train_step.check``: the route, the graph's key and ``_graph_fingerprint``
over every parameter and optimizer-state tensor), mean per call over the
untraced calls (``benchmark/spans.py``)."""

from benchmark.spans import span_mean_s


def read(obs: dict, snapshot=None):
    mean = span_mean_s(obs, "train", "train_step.check", snapshot)
    return None if mean is None else 1e3 * mean
