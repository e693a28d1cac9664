"""Forecast traffic: the port's captured forecast, ``predict.make_forecast``
(standardize, then ``ARForecaster.forward`` over the mix's AR steps, one
CUDA graph), called in a closed loop by one client over a pool of seeded
batches on the device.

Each forecast is timed from its call to its outputs being ready. Set-up
makes the first call (warm-up and capture). The check compares a sample
of the window's forecasts, drawn from the seed, with the plain reference's
rollout of the same inputs.
"""

from __future__ import annotations

import random
import statistics
import time

import torch

from .. import checks, inputs, portside


def run(ctx) -> dict:
    mix, pool = ctx.mix, ctx.pool
    fc = portside.forecast(ctx.forecaster, ctx.store, ctx.cfg, ctx.device)
    ctx.mark("forecast")
    fc(*pool[0])
    ctx.sync()
    ctx.mark("warm-up and capture")
    rng = random.Random(inputs.substream(ctx.seed, 3))
    keep = mix["check_samples"]
    sample: list[tuple[int, int, torch.Tensor]] = []
    finite = []
    latency, gap, starts = [], [], []
    t0 = time.perf_counter()
    ctx.setup_done(t0)
    done = None
    n = 0
    while time.perf_counter() - t0 < ctx.seconds:
        j = n % len(pool)
        t = time.perf_counter()
        starts.append(t - t0)
        out = fc(*pool[j])[0]
        if done is not None:
            gap.append(time.perf_counter() - done)
        finite.append(torch.isfinite(out).all())
        ctx.sync()
        done = time.perf_counter()
        latency.append(done - t)
        if len(sample) < keep:
            sample.append((n, j, out))
        elif rng.random() < keep / (n + 1):
            sample[rng.randrange(keep)] = (n, j, out)
        n += 1
        del out
    window_s = time.perf_counter() - t0
    failed = int((~torch.stack(finite)).sum()) if finite else 0

    trace = None
    if ctx.trace:
        trace = ctx.profile(lambda k: fc(*pool[k % len(pool)]), sync_each=True)
    peak = ctx.memory_peak()
    del fc, finite
    ctx.release_program()

    steps = mix["ar_steps"]
    flops = ctx.family.step_flops(ctx.cfg, ctx.sizes, mix["batch"]) * steps
    ref = checks.reference_forecasts(ctx, [(j, out) for _, j, out in sample])
    numbers = checks.forecast_numbers(ref)
    return {
        "attempted": n, "failed": failed, "window_s": window_s, "memory_peak": peak,
        "end_to_end": {
            "forecast_gps": mix["batch"] * ctx.n_grid * steps * n / window_s,
            "forecast_p95_ms": 1e3 * (statistics.quantiles(latency, n=20)[18]
                                      if len(latency) > 1 else latency[0]),
        },
        "observed": {"kind": "forecast", "calls": n, "window_s": window_s, "gap_s": gap,
                     "call_starts_s": starts,
                     "flops_per_call": flops, "kernel_bounds_s": ctx.kernel_bounds(False),
                     "trace": trace, "precision": mix["precision"]},
        "numbers": numbers,
    }
