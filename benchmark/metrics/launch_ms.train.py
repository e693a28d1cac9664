"""Host time of the training step's ``graph.replay()`` (the span
``train_step.launch``), mean per replay over the untraced calls; where it
nears a step's device time, the host waits on a full launch queue."""

from benchmark.spans import span_mean_s


def read(obs: dict, snapshot=None):
    mean = span_mean_s(obs, "train", "train_step.launch", snapshot)
    return None if mean is None else 1e3 * mean
