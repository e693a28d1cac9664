"""The share of the traced sub-window in which no operation ran on the
card: 100 x (1 - the union of the device operations' intervals over the
sub-window's length), from ``torch.profiler``."""

KIND = "train"


def read(obs: dict):
    trace = obs.get("trace")
    if obs["kind"] != KIND or trace is None:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
