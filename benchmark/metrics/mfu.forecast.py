"""The forecast's share of the card's peak: the model's forward FLOPs
of its AR steps (``models/counts.py``) times the forecasts of
the window, over the window's seconds and the peak of its
precision (``yardstick.STEP_PEAK_FLOP_PER_S``)."""

from benchmark.yardstick import STEP_PEAK_FLOP_PER_S


def read(obs: dict):
    if obs["kind"] != "forecast" or not obs["calls"]:
        return None
    peak = STEP_PEAK_FLOP_PER_S[obs["precision"]]
    return 100.0 * obs["flops_per_call"] * obs["calls"] / (obs["window_s"] * peak)
