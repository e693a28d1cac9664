#!/usr/bin/env python3
"""Where a forecast request's, or a training step's, time goes on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 profile_forecast.py [--model NAME] [--train] [--fused-v2 MODE]
                                [--fused-aggr MODE] [--trace PATH]

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

With ``--train --captured`` it profiles one replay of the captured step
(``Trainer.make_train_step()``, after its warm-up and capture) instead of
an eager step, and ``--precision bf16`` trains GraphLAM with bf16 compute
on bf16 copies of the parameters (``TrainingArgs(precision="bf16")``, as
``chip_smoke.py``'s ``bf16 train`` lines do). Without ``--train``,
``--precision bf16`` profiles the forecast of GraphLAM with bf16 compute on
bf16 copies of the gate's parameters, as ``chip_smoke.py``'s ``bf16
rollout`` lines serve it.

``--k4-split`` builds the kernels and splits K4 (the backward of the fused
edge phase) by kernel name at each of GraphLAM's MEPS training sites, in
float32 and with bf16 streams and operands, in a process of its own, by
the split that ``chip_smoke.py``'s K4 lines print: its main kernel, the
edge pass, the rows pass, the receiver slice, the workspace reduces,
cuBLAS products and the casts, each per call and per training step, from
10 calls under ``torch.profiler`` after 3 warm-up calls. ``--parent DIR``
(a checkout of an earlier commit, as ``chip_smoke.py --parent`` takes it)
splits that commit's K4 on the same inputs after each.

``--aggr-kernels`` builds the kernels and runs ``chip_smoke.py``'s
``fused aggr`` kernel lines alone (``phase_fused_aggr_kernels``: K3 and
the node update after it, and the node backward, at the six sites, in each
precision, then HiLAM's level sets, and the occupancy, registers and
spills of every instantiation of the node update and node backward); with
``--parent DIR`` the parent commit's own ``profile_forecast.py
--aggr-kernels`` runs in that checkout before and after, on this card, and
float32 K3 is held to the parent's bits. ``--train --parent DIR`` profiles
the training step (and ``--parent DIR`` alone the forecast) on that
commit's K3, K4, K7 and K8 (each wrapper launching the parent's build), for
a same-call comparison with a run without it.

``--bf16-kernels`` builds the kernels and runs ``chip_smoke.py``'s ``bf16``
kernel lines alone (``phase_bf16_kernels``: K1-K4, K7 and K8 in each
bf16-operand instantiation at the six GraphLAM sites, against their plain
versions and the float32 kernels, with per-step sums, shares of the bound
and the occupancy, registers and spills of each instantiation of K3, K7
and of K4's and K8's main kernels); with ``--parent DIR`` the parent
commit's K3, K4, K7 and K8 are timed on the same inputs beside them.

``--fused-v2 on|off|auto`` sets ``NEURAL_LAM_TPU_FUSED_V2`` for the run
(unset, the route's default ``auto`` keeps every MEPS edge set on K1 +
K3). With ``on`` every fused phase takes the v2 route: K7 forward, K8
and K2 backward, grouped as such (K8 shares its edge, rows and reduce
kernels' names with K4, which does not run on that route).

``--fused-aggr on|off`` sets ``NEURAL_LAM_TPU_FUSED_AGGR`` for the run
(unset: ``off``). With ``on`` the node update runs after K3 at every
GraphLAM and HiLAM application (``K3 node update``) and the node backward
before K4 (``K4 node backward``), in place of the node MLP's matmuls and
LayerNorm.
"""

from __future__ import annotations

import argparse
import contextlib
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
    ("K3 node update", re.compile(r"fused_node_fwd")),
    ("K3 fused_edge_phase", re.compile(r"fused_edge_fwd")),
    ("K4 node backward", re.compile(r"fused_node_bwd")),
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


def k4_sites(torch, model, bf16: bool):
    """K4's calls of one GraphLAM training step at the MEPS sites, on
    seeded inputs: ``(site, calls per step, kwargs of fused_edge_bwd)``,
    the streams in bf16 with ``bf16``; ``pre`` from K3."""
    from neural_lam_tpu_torch.ops.fused_kernels import _weights, fused_edge_fwd

    g, dev, d, b = model.graph, model.device, cs.HIDDEN, cs.BATCH
    io = torch.bfloat16 if bf16 else torch.float32
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(io)

    proc = list(model.processor.values())
    n_grid, n_mesh, m2m = g.num_grid_nodes, g.num_mesh_nodes, g.m2m[0]
    sites = [
        ("g2m", model.g2m_gnn, g.g2m, model.g2m_embedder, False, False, 1, n_mesh),
        ("m2m layer 0", proc[0], m2m, model.m2m_embedder, False, True, 1, n_mesh),
        ("m2m layers 1-2", proc[1], m2m, None, True, True, 2, n_mesh),
        ("m2m layer 3", proc[-1], m2m, None, True, False, 1, n_mesh),
        ("m2g", model.m2g_gnn, g.m2g, model.m2g_embedder, False, False, 1, n_grid),
    ]
    for site, net, ge, emb, batched, has_dne, calls, n_rec in sites:
        es, raw = ge.edges, not batched
        n_e = es.num_edges
        x_send, rec = randn(n_e, b, d), randn(n_rec, b, d)
        edge_in = ge.features.to(io) if raw else randn(n_e, b, d)
        wts = _weights(net.edge_mlp, emb)
        _, _, pre = fused_edge_fwd(edge_in, x_send, rec, es, wts, raw, has_dne, False,
                                   save_pre=True, bf16_ops=bf16)
        yield site, calls, dict(
            d_aggr=randn(n_rec, b, d), d_new_edge=randn(n_e, b, d) if has_dne else None,
            pre=pre, edge_in=edge_in, x_send=x_send, rec_rep=rec, edge_set=es,
            weights=wts, raw=raw, propagation=False, bf16_ops=bf16,
        )


def k4_split(torch, card: str, model, parent=None) -> None:
    """K4 split by kernel name at each MEPS training site, in float32 and
    bf16, per call and per training step, each tail piece beside its bound,
    by ``chip_smoke``'s split (``log_k4_split``, ``log_k4_tail``): with
    ``parent`` (``chip_smoke.parent_kernels``) the parent commit's K4 on the
    same inputs after each, in the same process."""
    from neural_lam_tpu_torch.ops.fused_kernels import fused_edge_bwd

    print(card)
    for label, bf16 in (("float32", False), ("bf16", True)):
        acc: dict = {}
        for site, calls, kw in k4_sites(torch, model, bf16):
            bounds = cs.k4_tail_bounds(
                torch, kw["edge_set"], kw["rec_rep"].shape[0], cs.BATCH, kw["raw"],
                kw["edge_in"], kw["d_new_edge"], kw["x_send"].dtype, bf16)
            cs.log_k4_split(torch, f"K4 {label} {site} ({calls} call(s) per training step)",
                            lambda: fused_edge_bwd(**kw), parent, calls, bounds, acc)
            del kw
            torch.cuda.empty_cache()
        cs.log_k4_tail(f"K4 {label} on {card}", acc, parent)


def profile_train(torch, args, card: str, gate_ds, model) -> int:
    from torch.profiler import ProfilerActivity, profile

    if args.precision == "bf16":
        if args.model != "graph_lam":
            raise SystemExit("profile_forecast.py: --precision bf16 profiles GraphLAM only")
        model = cs.bf16_graph_lam(torch, gate_ds)  # bf16 compute, the gate's parameters
    trainer = cs.make_trainer(model, gate_ds, reload=args.model == "graph_lam",
                              precision=args.precision)
    data = [torch.from_numpy(a).cuda() for a in cs.bench_batch(gate_ds)]
    step = trainer.make_train_step() if args.captured else trainer.train_step
    for _ in range(cs.TRAIN_WARMUP):
        step(*data)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss = step(*data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if args.trace:
        args.trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.trace))
    report(
        torch, prof, card,
        f"{args.model} {'captured ' if args.captured else ''}training step of batch "
        f"{cs.BATCH}, ar_steps 1, precision {args.precision} (loss {loss.item():.6f})",
        wall, 1, "training step",
    )

    steps = cs.TRAIN_ITERS
    t0 = time.perf_counter()
    for _ in range(steps):
        step(*data)
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
    ap.add_argument("--captured", action="store_true",
                    help="with --train: profile one replay of the captured step")
    ap.add_argument("--precision", choices=["32", "bf16"], default="32",
                    help="the training or, without --train, the forecast's compute "
                         "precision (GraphLAM; default 32)")
    ap.add_argument("--k4-split", action="store_true",
                    help="build the kernels and split K4 by kernel name at each MEPS site")
    ap.add_argument("--aggr-kernels", action="store_true",
                    help="build the kernels and run chip_smoke's fused aggr kernel lines")
    ap.add_argument("--bf16-kernels", action="store_true",
                    help="build the kernels and run chip_smoke's bf16 kernel lines")
    ap.add_argument("--parent", type=Path,
                    help="a checkout of the parent commit: with --k4-split its K4 runs "
                         "beside the current one, with --aggr-kernels its own script times "
                         "its node-MLP route, with --bf16-kernels its K3, K4, K7 and K8 "
                         "are timed beside the current ones, with --train or a forecast "
                         "its K3, K4, K7 and K8 run in place of the current ones")
    ap.add_argument("--probe", action="store_true",
                    help="build the kernels and run chip_smoke's K3/K4 probe only")
    ap.add_argument("--fused-v2", choices=["on", "off", "auto"],
                    help="set NEURAL_LAM_TPU_FUSED_V2 for the run (on: K7, K8)")
    ap.add_argument("--fused-aggr", choices=["on", "off"],
                    help="set NEURAL_LAM_TPU_FUSED_AGGR for the run (on: the node update "
                         "after K3, the node backward before K4)")
    args = ap.parse_args()
    if args.fused_v2:
        os.environ["NEURAL_LAM_TPU_FUSED_V2"] = args.fused_v2
    if args.fused_aggr:
        os.environ["NEURAL_LAM_TPU_FUSED_AGGR"] = args.fused_aggr

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
    parent = None
    if args.parent or args.k4_split or args.aggr_kernels or args.bf16_kernels:
        parent_build = cs.start_parent_build(args.parent.resolve()) if args.parent else None
        cs.build_kernels()
        parent = (cs.parent_kernels(torch, parent_build, args.parent.resolve())
                  if parent_build else None)
    if args.k4_split:
        with torch.no_grad():
            k4_split(torch, card, cs.build_meps(torch)[2], parent=parent)
        return 0
    if args.bf16_kernels:
        print(card)
        with torch.no_grad():
            cs.phase_bf16_kernels(torch, cs.build_meps(torch)[2], parent)
        return 0
    if args.aggr_kernels:
        print(card)
        gate_ds, _, model, _ = cs.build_meps(torch)
        # outside no_grad, as the smoke runs it: the level sets go through autograd
        cs.phase_fused_aggr_kernels(torch, model, cs.build_model(torch, "hi_lam", gate_ds),
                                    parent)
        return 0
    if args.model == "graph_lam":
        gate_ds, serve_ds, model, forecaster = cs.build_meps(torch)
    else:
        from neural_lam_tpu_torch.models import ARForecaster

        gate_ds, serve_ds = cs.meps_datastores()
        model = cs.build_model(torch, args.model, gate_ds)
        forecaster = ARForecaster(model, gate_ds)
    if args.train:
        if parent is None:
            return profile_train(torch, args, card, gate_ds, model)
        print(f"the parent's kernels, built from {args.parent}")
        with parent["use"]():
            return profile_train(torch, args, card, gate_ds, model)
    kw = {}
    if args.precision == "bf16":  # bf16 compute on bf16 copies of the gate's parameters
        if args.model != "graph_lam":
            raise SystemExit("profile_forecast.py: --precision bf16 profiles GraphLAM only")
        from neural_lam_tpu_torch.models import ARForecaster

        model = cs.bf16_graph_lam(torch, gate_ds)
        cs.make_trainer(model, gate_ds)  # loads the gate's parameters
        forecaster = ARForecaster(model, gate_ds)
        kw["params"] = {k: p.detach().to(torch.bfloat16) for k, p in model.named_parameters()}
    n, b, t = gate_ds.num_grid_points, cs.BATCH, cs.AR_STEPS
    rng = np.random.default_rng(0)
    inputs = [
        torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()
        for shape in ((b, 2, n, cs.N_STATE), (b, t, n, cs.N_FORCING * 3),
                      (b, t, n, cs.N_STATE))
    ]

    if parent is not None:
        print(f"the parent's kernels, built from {args.parent}")
    kernels = parent["use"]() if parent is not None else contextlib.nullcontext()
    with kernels, torch.inference_mode():
        forecaster(*inputs, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pred, _ = forecaster(*inputs, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    if args.trace:
        args.trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.trace))

    report(
        torch, prof, card,
        f"{args.model} forecast of {b} x {t} steps, precision {args.precision}", wall, t,
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
