"""The port's hand-written kernels against their least time: the sum of
each launch's bound (bytes or 3xTF32 operations, ``models/counts.py`` and
``yardstick.bound``) over the sum of their device time, per step, from the
traced sub-window (each kernel name's mean over the records the profiler
kept, times its launches a step). Nothing is read where a kernel of the
port outside the counted float32 v1 route ran, or a counted group did not.
"""

from benchmark.yardstick import group_of, group_time_per_call, kernel_table

KIND = "train"


def read(obs: dict):
    trace = obs.get("trace")
    if obs["kind"] != KIND or trace is None:
        return None
    table = kernel_table()
    uncounted = [n for n in trace["records"]
                 if group_of(n, table["port"]) and not group_of(n, table["roofline"])]
    times = group_time_per_call(trace, table["roofline"])
    bounds = obs["kernel_bounds_s"]
    if uncounted or set(times) != set(bounds):
        return None
    return 100.0 * sum(bounds.values()) / sum(times.values())
