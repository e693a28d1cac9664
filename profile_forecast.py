#!/usr/bin/env python3
"""Where a forecast request's, or a training step's, time goes on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 profile_forecast.py [--model NAME] [--train] [--fused-v2 MODE]
                                [--trace PATH]

It builds a MEPS model of ``chip_smoke.py``: ``--model graph_lam`` (the
default; GraphLAM with the fixture's parameters) or one of
``graph_lam_h2`` (``GraphLAM(hidden_layers=2)``, the unfused route),
``hi_lam`` and ``hi_lam_parallel`` (the hierarchical graph), with the
seeded parameters of ``chip_smoke.build_model``. It runs one warm-up
forecast of batch 4 x 19 AR steps on inputs drawn from
``np.random.default_rng(0)``, and profiles one more with
``torch.profiler``. It prints the device time summed by kernel group
(the eight kernels, matmuls, the rest), the device busy share over the
forecast's wall time and the kernel launch count, then times the host
side of a ``predict.run_forecasts`` request: one batch from the loader
and one compressed forecast file. ``--trace`` writes the Chrome trace.

With ``--train`` it profiles one ``Trainer.train_step`` instead (batch 4,
``ar_steps`` 1, the batch of ``chip_smoke.bench_batch``, after two
warm-up steps) and splits the device time by K1-K8, cuBLAS, LayerNorm,
the optimizer and the rest. It then times the host: ten steps queued back
to back, the time until the last is enqueued against the time until the
device has finished them. ``--host-profile`` runs ten more steps under
``cProfile`` and prints where the host spends them.

``--probe`` builds the kernels, prints the compiler's register report,
and runs ``chip_smoke.phase_probe``: K3 and K4 at the six GraphLAM sites
as the main path calls them, on a uniform-in-degree edge set of the same
size, with LayerNorm off and K3 with and without ``pre``, and the
occupancy of K3, K4, K7 and K8.

``--fused-v2 on|off|auto`` sets ``NEURAL_LAM_TPU_FUSED_V2`` for the run
(unset, the route's default ``auto`` keeps every MEPS edge set on K1 +
K3). With ``on`` every fused phase takes the v2 route: K7 forward, K8
and K2 backward, grouped as such (K8 shares its edge, rows and reduce
kernels' names with K4, which does not run on that route).
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

import chip_smoke as cs

GROUPS = (
    ("K7 fused_edge_phase_v2", re.compile(r"fused_edge_v2_fwd")),
    ("K8 fused_edge_phase_v2 backward", re.compile(r"fused_edge_v2_bwd")),
    ("K3 fused_edge_phase", re.compile(r"fused_edge_fwd")),
    ("K4 fused_edge_phase backward", re.compile(r"fused_edge_bwd|reduce_workspace")),
    ("K1 sender_gather", re.compile(r"gather_rows")),
    ("K2 sender_scatter", re.compile(r"scatter_rows")),
    ("K5 segment_sum", re.compile(r"segment_sum_rows")),
    ("K6 receiver_expand", re.compile(r"expand_rows")),
    ("matmul (cuBLAS)", re.compile(r"gemm|gemv|cutlass|sm90_xmma|ampere", re.I)),
    ("LayerNorm", re.compile(r"layer_norm|LayerNorm", re.I)),
    ("optimizer (AdamW)", re.compile(r"multi_tensor_apply|adam", re.I)),
)


def groups() -> tuple:
    """The kernel groups; on the v2 route K8's edge, rows and reduce
    kernels, whose names K4 shares, count as K8."""
    if os.environ.get("NEURAL_LAM_TPU_FUSED_V2") != "on":
        return GROUPS
    k8 = ("K8 fused_edge_phase_v2 backward",
          re.compile(r"fused_edge_v2_bwd|fused_edge_bwd_(edge|rows)|reduce_workspace"))
    return tuple(k8 if name == k8[0] else (name, pat) for name, pat in GROUPS)


def report(torch, prof, card: str, what: str, wall: float, per: int, unit: str) -> None:
    """Device time by kernel group, busy share and launch count of the
    profiled window; ``per`` divides the sums into a per-``unit`` column."""
    groups_ = groups()
    sums = {name: 0.0 for name, _ in groups_}
    sums["other kernels"] = 0.0
    launches = 0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.device_time_total
        if us <= 0 or evt.name.startswith("Memcpy") or evt.name.startswith("Memset"):
            continue
        if "#" in evt.name:  # an annotated range on the device, not a kernel
            continue
        launches += 1
        group = next((g for g, pat in groups_ if pat.search(evt.name)), "other kernels")
        sums[group] += us / 1e3
    busy = sum(sums.values())
    print(card)
    print(
        f"{what}: wall {wall * 1e3:.3f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / (wall * 1e3):.1f} %), {launches} kernel "
        f"launches ({launches / per:.1f} per {unit})"
    )
    for name, ms in sums.items():
        print(
            f"  {name}: {ms:.3f} ms ({ms / per:.4f} ms per {unit}, "
            f"{100 * ms / busy:.1f} % of device time)"
        )
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25))


def profile_train(torch, args, card: str, gate_ds, model) -> int:
    from torch.profiler import ProfilerActivity, profile

    trainer = cs.make_trainer(model, gate_ds, reload=args.model == "graph_lam")
    data = [torch.from_numpy(a).cuda() for a in cs.bench_batch(gate_ds)]
    for _ in range(cs.TRAIN_WARMUP):
        trainer.train_step(*data)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss = trainer.train_step(*data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if args.trace:
        args.trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.trace))
    report(
        torch, prof, card,
        f"{args.model} training step of batch {cs.BATCH}, ar_steps 1 "
        f"(loss {loss.item():.6f})",
        wall, 1, "training step",
    )

    steps = cs.TRAIN_ITERS
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.train_step(*data)
    enqueued = time.perf_counter() - t0
    torch.cuda.synchronize()
    done = time.perf_counter() - t0
    print(
        f"host on {card}: {steps} {args.model} training steps queued back to back, "
        f"{1e3 * enqueued / steps:.3f} ms per step until enqueued, "
        f"{1e3 * done / steps:.3f} ms per step until the device finished"
    )
    if args.host_profile:
        import cProfile
        import pstats

        prof = cProfile.Profile()
        prof.enable()
        for _ in range(steps):
            trainer.train_step(*data)
        prof.disable()
        torch.cuda.synchronize()
        print(f"cProfile of {steps} training steps (its own cost included):")
        pstats.Stats(prof).sort_stats("cumulative").print_stats(
            r"trainer\.py|_tensor\.py.*backward|forecaster\.py|adam\.py.*\(step\)"
            r"|fused_kernels\.py|segment_kernels\.py|mlp\.py|interaction\.py"
            r"|hi_lam|hierarchical\.py"
        )
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trace", type=Path, help="write the Chrome trace here")
    ap.add_argument("--model", default="graph_lam",
                    choices=["graph_lam", *cs.GATE_MODELS],
                    help="the MEPS model to profile (default: graph_lam)")
    ap.add_argument("--train", action="store_true",
                    help="profile one training step, not a forecast request")
    ap.add_argument("--host-profile", action="store_true",
                    help="with --train: cProfile ten more steps on the host")
    ap.add_argument("--probe", action="store_true",
                    help="build the kernels and run chip_smoke's K3/K4 probe only")
    ap.add_argument("--fused-v2", choices=["on", "off", "auto"],
                    help="set NEURAL_LAM_TPU_FUSED_V2 for the run (on: K7, K8)")
    args = ap.parse_args()
    if args.fused_v2:
        os.environ["NEURAL_LAM_TPU_FUSED_V2"] = args.fused_v2

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_forecast.py: no CUDA device is available", file=sys.stderr)
        return 1
    from neural_lam_tpu_torch.dataset import WeatherDataset
    from neural_lam_tpu_torch.loader import DataLoader

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    cs.CACHE.mkdir(exist_ok=True)
    if args.probe:
        print(card)
        cs.build_kernels()
        with torch.no_grad():
            cs.phase_probe(torch, cs.build_meps(torch)[2])
        return 0
    if args.model == "graph_lam":
        gate_ds, serve_ds, model, forecaster = cs.build_meps(torch)
    else:
        from neural_lam_tpu_torch.models import ARForecaster

        gate_ds, serve_ds = cs.meps_datastores()
        model = cs.build_model(torch, args.model, gate_ds)
        forecaster = ARForecaster(model, gate_ds)
    if args.train:
        return profile_train(torch, args, card, gate_ds, model)
    n, b, t = gate_ds.num_grid_points, cs.BATCH, cs.AR_STEPS
    rng = np.random.default_rng(0)
    inputs = [
        torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()
        for shape in ((b, 2, n, cs.N_STATE), (b, t, n, cs.N_FORCING * 3),
                      (b, t, n, cs.N_STATE))
    ]

    with torch.inference_mode():
        forecaster(*inputs)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pred, _ = forecaster(*inputs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    if args.trace:
        args.trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.trace))

    report(
        torch, prof, card, f"{args.model} forecast of {b} x {t} steps", wall, t,
        "AR step",
    )

    # host side of one run_forecasts request
    loader = DataLoader(
        WeatherDataset(serve_ds, split="test", ar_steps=t), batch_size=b
    )
    t0 = time.perf_counter()
    next(iter(loader))
    t_batch = time.perf_counter() - t0
    field = pred[0].cpu().numpy()
    with tempfile.TemporaryDirectory(dir=cs.CACHE) as tmp:
        t0 = time.perf_counter()
        np.savez_compressed(Path(tmp) / "f.npz", prediction=field)
        t_file = time.perf_counter() - t0
    print(
        f"host on {card}: one batch of {b} from the loader {t_batch:.3f} s; "
        f"one compressed forecast file ({field.nbytes / 1e6:.1f} MB) "
        f"{t_file:.3f} s, {b} per request"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
