"""The card's gap between two forecasts: from one forecast's end event
(after its outputs' copies) to the next one's start event (before its input
copies), CUDA events the program records on one untraced call in 16; their median."""

from benchmark.spans import gap_median_ms


def read(obs: dict, snapshot=None):
    return gap_median_ms(obs, "forecast", "forecast", snapshot)
