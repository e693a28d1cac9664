"""The card's gap between two training steps: from one step's end event
(after its loss copy) to the next step's start event (before its input
copy), CUDA events the program records on one untraced call in 16; their median."""

from benchmark.spans import gap_median_ms


def read(obs: dict, snapshot=None):
    return gap_median_ms(obs, "train", "train_step", snapshot)
