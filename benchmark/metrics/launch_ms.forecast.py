"""Host time of the forecast's ``graph.replay()`` (the span
``forecast.launch``), mean per replay over the untraced calls."""

from benchmark.spans import span_mean_s


def read(obs: dict, snapshot=None):
    mean = span_mean_s(obs, "forecast", "forecast.launch", snapshot)
    return None if mean is None else 1e3 * mean
