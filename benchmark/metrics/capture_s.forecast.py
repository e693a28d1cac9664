"""Host seconds of the forecast's capture (the span ``forecast.capture``:
its eager warm-up, the capture and the new graph's first replay), mean over
the captures of the run's set-up."""

from benchmark.spans import span_mean_s


def read(obs: dict, snapshot=None):
    return span_mean_s(obs, "forecast", "forecast.capture", snapshot)
