"""The training step's share of the card's peak: the model's FLOPs of a
step (three times the forward's, ``models/counts.py``) times the steps of
the window, over the window's seconds and the peak of the step's
precision (``yardstick.STEP_PEAK_FLOP_PER_S``)."""

from benchmark.yardstick import STEP_PEAK_FLOP_PER_S


def read(obs: dict):
    if obs["kind"] != "train" or not obs["calls"]:
        return None
    peak = STEP_PEAK_FLOP_PER_S[obs["precision"]]
    return 100.0 * obs["flops_per_call"] * obs["calls"] / (obs["window_s"] * peak)
