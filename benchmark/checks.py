"""What decides ``correct``: the plain reference (``models/``) run on the
same inputs as the program, and the numbers compared with its limits.

Training: the reference follows the program's first three steps from the
same seeded weights and batches. Compared are each step's loss (relative
gap), the first gradient's norm per parameter (leaf) and the norm of each
leaf's change after three steps, each as the worst leaf's gap between the
program's norm and the reference's, over the reference's norm of that
leaf or of the median leaf, whichever is larger. Leaves whose reference
gradient is under a thousandth of the median leaf's move under AdamW by
rounding alone and are left out of the change.

Forecasts: the reference rolls out each sampled forecast's inputs. Compared
are the worst step's relative L2 gap and its largest gap over the largest
value.

The reference runs in float32 with TF32 off (``plain.tf32``), after the
window, once the program's state is freed.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from . import inputs
from .models import plain

MOVING_SHARE = 1e-3  # of the median leaf's reference gradient


def reference_stats(ctx) -> dict:
    """The statistics as the reference uses them, on its device: static
    fields standardized in float64, stds clamped away from zero, the
    forcing's repeated over the window, feature-major."""
    s, cfg, dev = ctx.stats, ctx.cfg, ctx.device
    eps = np.finfo(np.float32).eps
    w = cfg["forcing_window"]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    static = ((s["static"].astype(np.float64) - s["static_mean"].astype(np.float64))
              / np.maximum(s["static_std"].astype(np.float64), np.finfo(np.float64).eps))
    n = cfg["state_vars"]
    return {
        "static": t(static),
        "diff_mean": t(s["diff_mean"]), "diff_std": t(s["diff_std"]),
        "state_mean": t(s["state_mean"]), "state_std": t(np.maximum(s["state_std"], eps)),
        "forcing_mean": t(np.repeat(s["forcing_mean"], w)),
        "forcing_std": t(np.repeat(np.maximum(s["forcing_std"], eps), w)),
        # the uniform weighting, 1/n a variable: diff_std / sqrt(1/n)
        "per_var_std": t(s["diff_std"] / np.sqrt(np.full(n, 1.0 / n, np.float32))),
        "interior": t(1.0 - ctx.mask)[:, None],
        "interior_bool": torch.as_tensor(ctx.mask < 0.5, device=dev),
    }


def _standardized(batch, st, half: bool = False):
    init, target, forcing = batch
    if half:
        keep = init.shape[0] // 2
        init, target, forcing = init[:keep], target[:keep], forcing[:keep]
    return (plain.standardize(init, st["state_mean"], st["state_std"]),
            plain.standardize(target, st["state_mean"], st["state_std"]),
            plain.standardize(forcing, st["forcing_mean"], st["forcing_std"]))


def _reference(ctx):
    plain.tf32(ctx.control_tf32)
    g = plain.load_graph(ctx.graph_dir, inputs.xy_span(ctx.cfg), ctx.device)
    return g, reference_stats(ctx)


def reference_training(ctx, steps: int, half_batch: bool = False) -> dict:
    """The reference's ``steps`` AdamW steps on pool batches ``0..steps-1``
    from the seeded weights: losses, the first gradient's leaf norms and
    each leaf's change. ``half_batch`` plants a fault: half of each batch
    left out, the loss the mean over the rest."""
    g, st = _reference(ctx)
    p = {n: w.detach().clone().requires_grad_(True) for n, w in ctx.weights.items()}
    step = ctx.family.make_step(p, g, st, ctx.cfg)
    names = list(p)
    state: dict = {}
    losses, grad1 = [], {}
    for k in range(steps):
        init, target, forcing = _standardized(ctx.pool[k], st, half_batch)
        pred = plain.rollout(step, init, forcing, target, st["interior"])
        loss = plain.wmse_loss(pred, target, st["per_var_std"], st["interior_bool"])
        grads = torch.autograd.grad(loss, [p[n] for n in names])
        losses.append(float(loss.detach()))
        if k == 0:
            grad1 = {n: float(gr.norm()) for n, gr in zip(names, grads)}
        del pred, loss
        with torch.no_grad():
            plain.adamw_(p, dict(zip(names, grads)), state, k + 1, ctx.mix["lr"],
                         weight_decay=ctx.mix["weight_decay"])
        del grads
    moved = {n: float((p[n].detach() - ctx.weights[n]).norm()) for n in names}
    return {"losses": losses, "grad1": grad1, "moved": moved}


def reference_forecasts(ctx, sample: list) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``(program, reference)`` standardized forecasts of each sampled
    ``(pool index, program output)``."""
    g, st = _reference(ctx)
    p = {n: w.detach() for n, w in ctx.weights.items()}
    step = ctx.family.make_step(p, g, st, ctx.cfg)
    out = []
    with torch.no_grad():
        for j, got in sample:
            init, target, forcing = _standardized(ctx.pool[j], st)
            out.append((got, plain.rollout(step, init, forcing, target, st["interior"])))
    return out


def _leaf_gap(prog: dict, ref: dict, leaves: list[str]) -> tuple[float, str]:
    median = statistics.median(ref[n] for n in leaves)
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], median) for n in leaves}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def training_numbers(prog: dict, ref: dict) -> dict[str, float]:
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    names = list(ref["grad1"])
    grad, _ = _leaf_gap(prog["grad1"], ref["grad1"], names)
    median = statistics.median(ref["grad1"].values())
    moving = [n for n in names if ref["grad1"][n] >= MOVING_SHARE * median]
    moved, _ = _leaf_gap(prog["moved"], ref["moved"], moving)
    return {"loss_rel": loss, "grad1_leaf": grad, "moved3_leaf": moved}


def forecast_numbers(pairs: list) -> dict[str, float]:
    rms = mx = 0.0
    for got, want in pairs:
        diff = (got.float() - want).flatten(2)
        want = want.flatten(2)
        rms = max(rms, float((diff.norm(dim=(0, 2)) / want.norm(dim=(0, 2))).max()))
        mx = max(mx, float((diff.abs().amax(dim=(0, 2)) / want.abs().amax(dim=(0, 2))).max()))
    if not pairs:
        rms = mx = math.nan
    return {"forecast_rel_l2": rms, "forecast_rel_max": mx}


def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """``correct`` and each number beside its limit; a number without a
    limit, or one that is not finite, is not correct."""
    shown = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    ok = all(k in limits and math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    return ok, shown
