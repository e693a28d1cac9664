"""Host seconds of the training step's capture (the span
``train_step.capture``: its eager warm-up steps, the capture and the new
graph's first replay), mean over the captures of the run's set-up."""

from benchmark.spans import span_mean_s


def read(obs: dict, snapshot=None):
    return span_mean_s(obs, "train", "train_step.capture", snapshot)
