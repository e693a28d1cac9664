"""Training traffic: the port's captured step, ``Trainer.make_train_step()``
(zero-grad, loss, backward, AdamW in one CUDA graph), queued back to back
over a pool of seeded batches on the device.

Set-up drives the step through its first three calls on pool batches 0-2
(the first call warms up and captures); the window goes on with the same
step object from batch 3. The check follows those three steps with the
plain reference: each step's loss, the first gradient as AdamW holds it
after one step (its first moment over ``1 - beta1``), and the parameters'
change after three steps.
"""

from __future__ import annotations

import time
from collections import deque

import torch

from .. import checks, portside

CHECKED_STEPS = 3
IN_FLIGHT = 2  # steps queued ahead of the device, as a loader keeps it fed


def run(ctx) -> dict:
    mix, pool = ctx.mix, ctx.pool
    if mix["pool"] <= CHECKED_STEPS:
        raise ValueError(f"mix {ctx.cell['traffic']}: a pool of more than {CHECKED_STEPS} "
                         "batches, so that the checked steps and the window differ")
    tr = portside.trainer(ctx.forecaster, ctx.store, mix, ctx.device)
    step = tr.make_train_step()
    ctx.mark("trainer")
    params = dict(ctx.model.named_parameters())
    names = list(params)
    beta1 = tr.optimizer.param_groups[0]["betas"][0]
    losses, grad1 = [], {}
    for k in range(CHECKED_STEPS):
        losses.append(float(step(*pool[k])))
        if k == 0:  # a parameter the step left alone has no state: no gradient reached it
            ctx.mark("warm-up and capture")
            state = tr.optimizer.state
            grad1 = {n: float(state[params[n]]["exp_avg"].norm()) / (1 - beta1)
                     if "exp_avg" in state.get(params[n], {}) else 0.0 for n in names}
    moved = {n: float((params[n].detach() - ctx.weights[n]).norm()) for n in names}
    ctx.sync()
    t0 = time.perf_counter()
    ctx.setup_done(t0)

    enqueue, starts, outs, queued = [], [], [], deque()
    i = CHECKED_STEPS
    while time.perf_counter() - t0 < ctx.seconds:
        t = time.perf_counter()
        starts.append(t - t0)
        outs.append(step(*pool[i % len(pool)]))
        enqueue.append(time.perf_counter() - t)
        queued.append(ctx.event())
        if len(queued) > IN_FLIGHT:
            queued.popleft().synchronize()
        i += 1
    ctx.sync()
    window_s = time.perf_counter() - t0
    calls = len(outs)
    failed = int((~torch.isfinite(torch.stack(outs))).sum()) if outs else 0

    trace = None
    if ctx.trace:
        trace = ctx.profile(lambda j: step(*pool[(i + j) % len(pool)]))
    peak = ctx.memory_peak()
    del tr, step, outs, params
    ctx.release_program()

    flops = 3 * ctx.family.step_flops(ctx.cfg, ctx.sizes, mix["batch"]) * mix["ar_steps"]
    bounds = ctx.kernel_bounds(training=True)
    ref = checks.reference_training(ctx, CHECKED_STEPS)
    numbers = checks.training_numbers(
        {"losses": losses, "grad1": grad1, "moved": moved}, ref)
    return {
        "attempted": calls, "failed": failed, "window_s": window_s, "memory_peak": peak,
        "end_to_end": {"train_gps": mix["batch"] * ctx.n_grid * mix["ar_steps"] * calls
                                    / window_s},
        "observed": {"kind": "train", "calls": calls, "window_s": window_s,
                     "enqueue_s": enqueue, "call_starts_s": starts, "flops_per_call": flops,
                     "kernel_bounds_s": bounds, "trace": trace,
                     "precision": mix["precision"]},
        "numbers": numbers,
    }
