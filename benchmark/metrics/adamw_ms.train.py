"""Device time a step of the optimizer's kernels (torch's AdamW, the
``optimizer`` group of ``kernels.json``), from the traced sub-window."""

from benchmark.yardstick import group_time_per_call, kernel_table


def read(obs: dict):
    trace = obs.get("trace")
    if obs["kind"] != "train" or trace is None:
        return None
    spent = group_time_per_call(trace, kernel_table()["optimizer"])
    return 1e3 * spent["AdamW"] if "AdamW" in spent else None
