#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``neural_lam_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``neural_lam_tpu_torch/csrc`` and
drives the forecast path and the training step, the GraphLAM MEPS
configuration of ``bench.py`` (268x238 grid, hidden 64, 4 processor
layers, batch 4, float32), in six phases. Each phase passes or raises;
nothing is caught.

1. Kernels against their plain PyTorch versions, at the shapes of the
   six GNN calls (g2m, m2m x 4, m2g) at batch 4: max abs/rel error
   against the stated tolerance, and times from CUDA events (the kernel,
   its plain version and, for K1 and K2, ``index_select`` and
   ``index_add_``). K3 is timed with and without the ``pre`` output that
   its backward, K4, starts from.
2. Accuracy gate: a 19-step batch-1 rollout with the JAX package's
   ``PRNGKey(0)`` parameters (``tests/fixtures/accuracy/
   graph_lam_meps_params_seed0.npz``) against the committed exact-f32
   rollout ``tests/fixtures/accuracy/rollout19_f32.npz``, with the
   metrics and thresholds of ``scripts/accuracy_probe.py``.
3. Serving: ``predict.run_forecasts`` over a MEPS-size dummy test split,
   one batch of 4 samples at 19 AR steps. The forward kernels' launch
   counters are set to 0 just before and must read 6 x ar_steps after.
4. Training gate: the loss and every parameter gradient of one batch of
   4 (made as ``bench.make_bench_batch`` makes it), then the losses of
   three further AdamW steps, against the committed exact-f32 JAX
   fixture ``tests/fixtures/accuracy/train_step_meps_seed0.npz``.
5. Training: ``Trainer.train_step`` on that batch, 2 warm-up and 10
   timed steps (``bench.py``'s counts). All four kernels' counters are
   set to 0 just before and must read 6 per step after; the losses must
   be finite and fall.
6. Report: a ``{"kernels": [...]}`` line and, last, the
   ``{"ok": true, "device": ...}`` line.

Parity is exact float32: TF32 is off for matmuls and for cuDNN. The
script needs one CUDA device and exits non-zero without one, and outside
a checkout of the repository. Generated data, the graph and the
forecasts go under ``.smoke_cache/`` in the checkout.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
CACHE = REPO / ".smoke_cache"
FIXTURES = REPO / "tests" / "fixtures" / "accuracy"
TRAIN_FIXTURE = FIXTURES / "train_step_meps_seed0.npz"
DEVICE = "cuda"

# The bench.py configuration (bench.py:26-30, build_trainer)
GRID_X, GRID_Y = 268, 238
N_STATE, N_FORCING, N_STATIC = 17, 6, 4
HIDDEN, PROC_LAYERS, BATCH = 64, 4, 4
GATE_TIMESTEPS = 8  # bench's DummyDatastore; its static features depend on it
AR_STEPS = 19  # the MEPS test protocol length
SERVE_BATCHES = 1
# batches of 4 samples: len(split) = n_timesteps - ar_steps - 2
SERVE_TIMESTEPS = AR_STEPS + 2 + SERVE_BATCHES * BATCH

# Peak rates of one H100 SXM (NVIDIA's data sheet, at 700 W): HBM3 bytes/s
# and float32 outside the tensor cores (the kernels compute in exact f32).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# Tolerances against the plain versions on the same card, exact f32 on
# both sides. K1 is a copy: bit-identical. K3 differs from the plain
# version only in summation order (64-term dot products, LayerNorm moments
# and each receiver's message sum, taken in edge order without atomics):
# values are O(1) after LayerNorm and the sums add O(10) of them.
K1_TOL = 0.0
K3_RTOL = K3_ATOL = 1e-4
# K2 sums up to ~40 O(1) edge rows per sender in slot order where
# index_add_ adds with atomics in any order: rounding only, relative to the
# largest sum. K4's weight gradients sum a term per (edge, b) row, 1e6 of
# them at m2g: each gradient is held to 1e-4 of its own largest entry.
K2_TOL = 1e-5
K4_TOL = 1e-4
# Training against the JAX package's float32 run on a CPU: the loss is a
# mean over 4.3e6 entries and each gradient a sum over as many paths, in
# another order on the card; Adam then amplifies rounding where a gradient
# is near zero, so the later losses get a wider bound.
TRAIN_LOSS_RTOL = 2e-5
TRAIN_GRAD_TOL = 2e-4
TRAIN_TRAJ_RTOL = 1e-4
TRAIN_LR = 1e-3
TRAIN_WARMUP, TRAIN_ITERS = 2, 10  # bench.py:31
# scripts/accuracy_probe.py's thresholds (:139-140), sized for the TPU's
# bf16-rounded matmuls; exact f32 on the card is expected near 1e-5.
GATE_MEAN_REL, GATE_MAX_REL = 0.025, 0.25
GATE_FAULT_MEAN_REL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events around
    ``reps`` back-to-back calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time in ms for ``nbytes`` moved and ``flops`` done, and
    which of the two sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def errors(got, want) -> tuple[float, float]:
    """Max abs error and max abs error over the reference's max abs."""
    diff = (got - want).abs().max().item()
    return diff, diff / max(want.abs().max().item(), 1e-30)


def build_meps(torch):
    """The MEPS dummy datastores, graph and GraphLAM with the fixture's
    parameters, all built with the port's own code."""
    from neural_lam_tpu_torch.convert_checkpoint import (
        load_jax_params_npz,
        params_from_jax,
    )
    from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
    from neural_lam_tpu_torch.graphs import create_graph_from_datastore
    from neural_lam_tpu_torch.models import ARForecaster, GraphLAM

    root = CACHE / "meps"
    kw = dict(
        n_grid_x=GRID_X, n_grid_y=GRID_Y, n_state_features=N_STATE,
        n_forcing_features=N_FORCING, n_static_features=N_STATIC,
        root_path=root,
    )
    t0 = time.perf_counter()
    gate_ds = DummyDatastore(n_timesteps=GATE_TIMESTEPS, **kw)
    serve_ds = DummyDatastore(n_timesteps=SERVE_TIMESTEPS, **kw)
    graph_dir = root / "graph" / "multiscale"
    if not (graph_dir / "graph.npz").exists():
        create_graph_from_datastore(gate_ds, graph_dir)
    model = GraphLAM(
        gate_ds, hidden_dim=HIDDEN, processor_layers=PROC_LAYERS, device=DEVICE
    )
    params = params_from_jax(
        load_jax_params_npz(FIXTURES / "graph_lam_meps_params_seed0.npz")
    )
    model.load_state_dict(params, strict=True)
    model.eval()
    g = model.graph
    log(
        f"MEPS set-up: {gate_ds.num_grid_points} grid nodes, "
        f"{g.num_mesh_nodes} mesh nodes, edges g2m {g.g2m.edges.num_edges} "
        f"m2m {g.m2m[0].edges.num_edges} m2g {g.m2g.edges.num_edges}, "
        f"grid_input_dim {model.grid_input_dim} "
        f"({time.perf_counter() - t0:.1f} s)"
    )
    return gate_ds, serve_ds, model, ARForecaster(model, gate_ds)


def phase_kernels(torch, model) -> list[dict]:
    """Each kernel against its plain version at the shapes of the six
    GNN calls; returns the per-kernel report, times summed over the calls
    of one AR step (K1, K3) or one training step (K2, K4)."""
    from neural_lam_tpu_torch.ops.fused_kernels import (
        _weights,
        fused_edge_bwd,
        fused_edge_fwd,
        fused_edge_phase,
        fused_edge_phase_plain,
    )
    from neural_lam_tpu_torch.ops.segment_kernels import (
        sender_gather,
        sender_gather_plain,
        sender_scatter,
        sender_scatter_plain,
    )

    g, dev, d, b = model.graph, model.device, HIDDEN, BATCH
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    n_grid, n_mesh = g.num_grid_nodes, g.num_mesh_nodes
    m2m = g.m2m[0]
    proc = list(model.processor.values())

    # K1: (site, edge set, sender rows, calls per AR step)
    k1_sites = [
        ("g2m", g.g2m, n_grid, 1),
        ("m2m", m2m, n_mesh, PROC_LAYERS),
        ("m2g", g.m2g, n_mesh, 1),
    ]
    k1 = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, err=0.0,
              ops_ms=0.0, bytes_ms=0.0)
    for site, ge, n_send, calls in k1_sites:
        x = randn(n_send, b, d)
        idx = ge.edges.senders
        idx_long = idx.long()
        got = sender_gather(x, idx)
        want = sender_gather_plain(x, idx)
        torch.cuda.synchronize()
        abs_err, rel_err = errors(got, want)
        if abs_err > K1_TOL:
            raise AssertionError(f"K1 {site}: max abs err {abs_err} > {K1_TOL}")
        ms = cuda_ms(lambda: sender_gather(x, idx))
        plain_ms = cuda_ms(lambda: sender_gather_plain(x, idx))
        lib_ms = cuda_ms(lambda: torch.index_select(x, 0, idx_long))
        b_ms, _ = bound(nbytes(x, idx, got), 0.0)
        log(
            f"K1 sender_gather {site}: x {tuple(x.shape)} -> "
            f"{tuple(got.shape)}, max abs err {abs_err:.3g}, max rel err "
            f"{rel_err:.3g} (tol {K1_TOL}); kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, index_select {lib_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms (bytes); {calls} call(s) per AR step"
        )
        k1["ms"] += calls * ms
        k1["plain_ms"] += calls * plain_ms
        k1["library_ms"] += calls * lib_ms
        k1["bound_ms"] += calls * b_ms
        k1["bytes_ms"] += calls * b_ms
        k1["err"] = max(k1["err"], abs_err)
        del x, got, want

    # K2, the backward of K1: the same sites, edge rows in, sender rows out
    k2 = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, err=0.0)
    for site, ge, n_send, calls in k1_sites:
        es = ge.edges
        grad = randn(es.num_edges, b, d)
        idx_long = es.senders.long()
        got = sender_scatter(grad, es, n_send)
        want = sender_scatter_plain(grad, es.senders, n_send)
        torch.cuda.synchronize()
        abs_err, rel_err = errors(got, want)
        if rel_err > K2_TOL:
            raise AssertionError(f"K2 {site}: max rel err {rel_err} > {K2_TOL}")
        if not torch.equal(got, sender_scatter(grad, es, n_send)):
            raise AssertionError(f"K2 {site}: two runs differ")
        ms = cuda_ms(lambda: sender_scatter(grad, es, n_send))
        plain_ms = cuda_ms(lambda: sender_scatter_plain(grad, es.senders, n_send))
        lib_ms = cuda_ms(lambda: torch.zeros_like(got).index_add_(0, idx_long, grad))
        b_ms, _ = bound(nbytes(grad, es.send_perm, es.send_rowptr, got), grad.numel())
        log(
            f"K2 sender_scatter {site}: g {tuple(grad.shape)} -> "
            f"{tuple(got.shape)}, max abs err {abs_err:.3g}, max rel err "
            f"{rel_err:.3g} (tol {K2_TOL} of the largest sum), repeatable; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_ "
            f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms (bytes); {calls} call(s) "
            "per training step"
        )
        k2["ms"] += calls * ms
        k2["plain_ms"] += calls * plain_ms
        k2["library_ms"] += calls * lib_ms
        k2["bound_ms"] += calls * b_ms
        k2["err"] = max(k2["err"], abs_err)
        del grad, got, want

    # K3: (site, net, edges, embedder, edge input, update_edges, calls)
    k3_sites = [
        ("g2m", model.g2m_gnn, g.g2m, model.g2m_embedder, "raw", False, 1, n_mesh),
        ("m2m layer 0", proc[0], m2m, model.m2m_embedder, "raw", True, 1, n_mesh),
        ("m2m layers 1-3", proc[1], m2m, None, "batched", True,
         PROC_LAYERS - 1, n_mesh),
        ("m2g", model.m2g_gnn, g.m2g, model.m2g_embedder, "raw", False, 1, n_grid),
    ]
    k3 = dict(ms=0.0, pre_ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, ops_ms=0.0,
              bytes_ms=0.0)
    for site, net, ge, emb, mode, update, calls, n_rec in k3_sites:
        es = ge.edges
        n_e = es.num_edges
        x_send = randn(n_e, b, d)
        rec = randn(n_rec, b, d)
        edge_rep = randn(n_e, b, d) if mode == "batched" else None
        feats = ge.features if mode == "raw" else None
        args = (net.edge_mlp, edge_rep, x_send, rec)
        kw = dict(embedder=emb, edge_feats=feats, update_edges=update)
        got = fused_edge_phase(*args, es, **kw)
        want = fused_edge_phase_plain(*args, es.receivers, emb, feats, update)
        torch.cuda.synchronize()
        outs = [(got[0], want[0])] + ([(got[1], want[1])] if update else [])
        abs_err = max(errors(o, w)[0] for o, w in outs)
        rel_err = max(errors(o, w)[1] for o, w in outs)
        for o, w in outs:
            torch.testing.assert_close(o, w, rtol=K3_RTOL, atol=K3_ATOL)
        ms = cuda_ms(lambda: fused_edge_phase(*args, es, **kw))
        wts = _weights(net.edge_mlp, emb)
        edge_in = feats if mode == "raw" else edge_rep
        pre_ms = cuda_ms(lambda: fused_edge_fwd(
            edge_in, x_send, rec, es, wts, mode == "raw", update, False,
            save_pre=True,
        ))
        k3["pre_ms"] += calls * pre_ms
        plain_ms = cuda_ms(
            lambda: fused_edge_phase_plain(*args, es.receivers, emb, feats, update)
        )
        weights = [p for p in net.edge_mlp.parameters()]
        if emb is not None:
            weights += list(emb.parameters())
        moved = nbytes(x_send, rec, edge_rep, feats, es.rowptr, *weights, *got)
        # multiply-adds of the products (2 ops each) and the receiver sums;
        # SiLU and LayerNorm are left out, so the bound is a lower bound
        rows = n_e * b
        flops = 2 * n_rec * b * d * d  # rec . W1r once per (receiver, b)
        flops += 2 * rows * d * d * 2  # send . W1s and the second layer
        if mode == "raw":
            f = feats.shape[1]
            flops += n_e * (2 * f * d + 2 * d * d + 2 * d * d)  # embedder, W1e
        else:
            flops += 2 * rows * d * d  # edge . W1e per (edge, b)
        flops += rows * d
        b_ms, b_by = bound(moved, flops)
        log(
            f"K3 fused_edge_phase {site}: E {n_e}, receivers {n_rec}, "
            f"edge input {mode}, update_edges {update}; max abs err "
            f"{abs_err:.3g}, max rel err {rel_err:.3g} (rtol/atol "
            f"{K3_RTOL}); kernel {ms:.4f} ms, with the pre output "
            f"{pre_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}: {moved / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP); {calls} call(s) per AR step"
        )
        k3["ms"] += calls * ms
        k3["plain_ms"] += calls * plain_ms
        k3["bound_ms"] += calls * b_ms
        k3["ops_ms" if b_by == "operations" else "bytes_ms"] += calls * b_ms
        k3["err"] = max(k3["err"], abs_err)
        del x_send, rec, edge_rep, got, want, outs
    log(
        f"K3 per AR step: {k3['ms']:.4f} ms, with the pre output (as the "
        f"training step runs it) {k3['pre_ms']:.4f} ms"
    )

    # K4, the backward of K3, at the training step's six calls: (site, net,
    # edges, embedder, edge input, update_edges, d_new_edge given, calls,
    # receivers). The last m2m layer's updated edges are never used, so no
    # gradient reaches them.
    n_mid = PROC_LAYERS - 2
    k4_sites = [
        ("g2m", model.g2m_gnn, g.g2m, model.g2m_embedder, "raw", False, False,
         1, n_mesh),
        ("m2m layer 0", proc[0], m2m, model.m2m_embedder, "raw", True, True,
         1, n_mesh),
        (f"m2m layers 1-{n_mid}", proc[1], m2m, None, "batched", True, True,
         n_mid, n_mesh),
        (f"m2m layer {PROC_LAYERS - 1}", proc[-1], m2m, None, "batched", True,
         False, 1, n_mesh),
        ("m2g", model.m2g_gnn, g.m2g, model.m2g_embedder, "raw", False, False,
         1, n_grid),
    ]
    k4 = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, ops_ms=0.0, bytes_ms=0.0)
    for site, net, ge, emb, mode, update, has_dne, calls, n_rec in k4_sites:
        es = ge.edges
        n_e = es.num_edges
        raw = mode == "raw"
        x_send, rec = randn(n_e, b, d), randn(n_rec, b, d)
        edge_in = ge.features if raw else randn(n_e, b, d)
        d_aggr = randn(n_rec, b, d)
        d_new = randn(n_e, b, d) if has_dne else None
        wts = _weights(net.edge_mlp, emb)
        _, _, pre = fused_edge_fwd(
            edge_in, x_send, rec, es, wts, raw, update, False, save_pre=True
        )

        def run_k4():
            return fused_edge_bwd(
                d_aggr, d_new, pre, edge_in, x_send, rec, es, wts, raw, False
            )

        d_edge, d_send, d_rec, w_grads = run_k4()
        # plain version: autograd through the plain forward, same inputs
        leaves = [x_send, rec] + ([] if raw else [edge_in])
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        params = [w for w in wts if w is not None]
        with torch.enable_grad():
            aggr_p, new_p = fused_edge_phase_plain(
                net.edge_mlp, None if raw else leaves[2], leaves[0], leaves[1],
                es.receivers, emb, edge_in if raw else None, update,
            )
            outs, seeds = [aggr_p], [d_aggr]
            if has_dne:
                outs.append(new_p)
                seeds.append(d_new)

        def run_plain():
            with torch.enable_grad():
                return torch.autograd.grad(
                    outs, leaves + params, seeds, retain_graph=True
                )

        want = run_plain()
        torch.cuda.synchronize()
        got = [d_send, d_rec] + ([] if raw else [d_edge])
        got += [w for w in w_grads if w is not None]
        names = ["d_send", "d_rec"] + ([] if raw else ["d_edge"])
        names += [f"weight grad {i}" for i in range(len(params))]
        abs_err = rel_err = 0.0
        for name, o, w in zip(names, got, want):
            a_err, r_err = errors(o, w)
            abs_err, rel_err = max(abs_err, a_err), max(rel_err, r_err)
            if r_err > K4_TOL:
                raise AssertionError(
                    f"K4 {site} {name}: max err {a_err} is {r_err} of the "
                    f"largest value (tol {K4_TOL})"
                )
        again = run_k4()
        if not all(
            torch.equal(x, y) for x, y in
            zip([d_send, d_rec, *[w for w in w_grads if w is not None]],
                [again[1], again[2], *[w for w in again[3] if w is not None]])
        ):
            raise AssertionError(f"K4 {site}: two runs differ")
        ms = cuda_ms(run_k4)
        plain_ms = cuda_ms(run_plain)
        moved = nbytes(
            pre, x_send, rec, edge_in, d_aggr, d_new, es.rowptr, *params, *got
        )
        rows = n_e * b
        # per (edge, b) row: z, d_h1, dW2, d_send, dW1s; the receiver
        # slice once per (receiver, b): d_rec, dW1r; the receiver sums
        flops = 2 * rows * d * d * 5 + 2 * n_rec * b * d * d * 2 + rows * d
        if raw:
            f = edge_in.shape[1]
            # per edge: d_edge_val, dW1e, the embedder again, dEW2, d_a1, dEW1
            flops += n_e * (2 * d * d * 5 + 2 * f * d * 2)
        else:
            flops += 2 * rows * d * d * 2  # d_edge and dW1e per (edge, b)
        b_ms, b_by = bound(moved, flops)
        log(
            f"K4 fused_edge_phase backward {site}: E {n_e}, receivers {n_rec}, "
            f"edge input {mode}, d_new_edge {'given' if has_dne else 'none'}; "
            f"max abs err {abs_err:.3g}, at most {rel_err:.3g} of a gradient's "
            f"largest value (tol {K4_TOL}), repeatable; kernel {ms:.4f} ms, "
            f"plain (autograd) {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
            f"{moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); {calls} call(s) "
            "per training step"
        )
        k4["ms"] += calls * ms
        k4["plain_ms"] += calls * plain_ms
        k4["bound_ms"] += calls * b_ms
        k4["ops_ms" if b_by == "operations" else "bytes_ms"] += calls * b_ms
        k4["err"] = max(k4["err"], abs_err)
        del x_send, rec, edge_in, d_aggr, d_new, pre, outs, want, got, again, leaves
        del d_edge, d_send, d_rec, w_grads, aggr_p, new_p
        torch.cuda.empty_cache()
    log(
        f"per training step: K2 {k2['ms']:.4f} ms (bound {k2['bound_ms']:.4f}, "
        f"index_add_ {k2['library_ms']:.4f}), K4 {k4['ms']:.4f} ms (bound "
        f"{k4['bound_ms']:.4f}, plain {k4['plain_ms']:.4f})"
    )

    torch.cuda.empty_cache()
    return [
        dict(
            name="K1 sender_gather",
            route="cuda",
            source="neural_lam_tpu_torch/csrc/sender_gather.cu",
            replaces="neural_lam_tpu/ops/pallas_segment.py:821",
            launches=0,
            max_abs_err=k1["err"],
            ms=k1["ms"],
            plain_ms=k1["plain_ms"],
            bound_ms=k1["bound_ms"],
            bound_by="bytes",
            library_ms=k1["library_ms"],
        ),
        dict(
            name="K3 fused_edge_phase",
            route="cuda",
            source="neural_lam_tpu_torch/csrc/fused_edge.cu",
            replaces="neural_lam_tpu/ops/pallas_fused.py:879",
            launches=0,
            max_abs_err=k3["err"],
            ms=k3["ms"],
            plain_ms=k3["plain_ms"],
            bound_ms=k3["bound_ms"],
            bound_by="operations" if k3["ops_ms"] >= k3["bytes_ms"] else "bytes",
            library_ms=None,
        ),
        dict(
            name="K2 sender_scatter",
            route="cuda",
            source="neural_lam_tpu_torch/csrc/sender_scatter.cu",
            replaces="neural_lam_tpu/ops/pallas_segment.py:766",
            launches=0,
            max_abs_err=k2["err"],
            ms=k2["ms"],
            plain_ms=k2["plain_ms"],
            bound_ms=k2["bound_ms"],
            bound_by="bytes",
            library_ms=k2["library_ms"],
        ),
        dict(
            name="K4 fused_edge_phase backward",
            route="cuda",
            source="neural_lam_tpu_torch/csrc/fused_edge_bwd.cu",
            replaces="neural_lam_tpu/ops/pallas_fused.py:1052",
            launches=0,
            max_abs_err=k4["err"],
            ms=k4["ms"],
            plain_ms=k4["plain_ms"],
            bound_ms=k4["bound_ms"],
            bound_by="operations" if k4["ops_ms"] >= k4["bytes_ms"] else "bytes",
            library_ms=None,
        ),
    ]


def phase_gate(torch, ds, forecaster) -> list[dict]:
    """19-step rollout against the committed exact-f32 JAX fixture
    (scripts/accuracy_probe.py: inputs :80-88, metrics :104-117)."""
    fx = np.load(FIXTURES / "rollout19_f32.npz")
    steps, sub = int(fx["steps"]), int(fx["subsample"])
    n = ds.num_grid_points
    rng = np.random.default_rng(0)
    init = rng.normal(size=(1, 2, n, N_STATE)).astype(np.float32)
    forcing = rng.normal(size=(1, steps, n, N_FORCING * 3)).astype(np.float32)
    boundary = rng.normal(size=(1, steps, n, N_STATE)).astype(np.float32)
    with torch.inference_mode():
        pred, _ = forecaster(
            *(torch.from_numpy(a).to(DEVICE) for a in (init, forcing, boundary))
        )
    pred = pred.cpu().numpy()
    if pred.shape != (1, steps, n, N_STATE) or not np.isfinite(pred).all():
        raise AssertionError(f"gate rollout: shape {pred.shape} or non-finite")
    want = fx["prediction_sub"]
    got = pred[:, :, ::sub, :]
    scale = np.abs(want).mean()
    rows = []
    for t in range(steps):
        d = got[:, t] - want[:, t]
        rows.append(dict(
            step=t + 1,
            mean_rel=float(np.abs(d).mean() / scale),
            max_rel=float(np.abs(d).max() / scale),
            rmse=float(np.sqrt((d ** 2).mean())),
        ))
    drift = abs(np.abs(pred).mean() - float(fx["abs_mean"])) / float(fx["abs_mean"])
    for r in rows:
        log(
            f"gate step {r['step']:2d}: mean_rel {r['mean_rel']:.3e} "
            f"max_rel {r['max_rel']:.3e} rmse {r['rmse']:.3e}"
        )
    worst_mean = max(r["mean_rel"] for r in rows)
    worst_max = max(r["max_rel"] for r in rows)
    log(
        f"gate: worst mean_rel {worst_mean:.3e} (limit {GATE_MEAN_REL}), "
        f"worst max_rel {worst_max:.3e} (limit {GATE_MAX_REL}), abs_mean "
        f"drift {drift:.3e} (limit {GATE_MEAN_REL})"
    )
    if worst_mean > GATE_FAULT_MEAN_REL:
        log(f"gate: mean_rel above {GATE_FAULT_MEAN_REL}: a fault in exact f32")
    if worst_mean > GATE_MEAN_REL or worst_max > GATE_MAX_REL or drift > GATE_MEAN_REL:
        raise AssertionError("accuracy gate: thresholds exceeded")
    return rows


def phase_serve(torch, ds, model, card: str) -> dict[str, int]:
    """Forecast requests through run_forecasts; returns each kernel's
    launches in this run, which must be 6 per AR step per batch."""
    from torch import nn

    from neural_lam_tpu_torch.models import ARForecaster
    from neural_lam_tpu_torch.ops.fused_kernels import fused_edge_phase
    from neural_lam_tpu_torch.ops.segment_kernels import sender_gather
    from neural_lam_tpu_torch.predict import run_forecasts

    class TimedForecaster(nn.Module):
        """The forecaster, with the device time of each call recorded."""

        def __init__(self, inner: ARForecaster) -> None:
            super().__init__()
            self.inner = inner
            self.predictor = inner.predictor
            self.seconds: list[float] = []

        def forward(self, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.inner(*args)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            return out

    fc = TimedForecaster(ARForecaster(model, ds))
    out_dir = CACHE / "forecasts"
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()

    sender_gather.launches = 0
    fused_edge_phase.launches = 0
    t0 = time.perf_counter()
    written = run_forecasts(
        fc, ds, split="test", ar_steps=AR_STEPS, batch_size=BATCH,
        n_samples=SERVE_BATCHES * BATCH, out_dir=out_dir, device=DEVICE,
    )
    wall = time.perf_counter() - t0
    launches = {
        "K1 sender_gather": sender_gather.launches,
        "K3 fused_edge_phase": fused_edge_phase.launches,
    }

    batches = len(fc.seconds)
    if written != SERVE_BATCHES * BATCH or batches != SERVE_BATCHES:
        raise AssertionError(f"served {written} forecasts in {batches} batches")
    want = 6 * AR_STEPS * batches
    for name, count in launches.items():
        log(f"serve: {name} launches {count} (want 6 x {AR_STEPS} x {batches} = {want})")
        if count != want:
            raise AssertionError(f"{name}: {count} launches, want {want}")
    files = sorted(out_dir.glob("forecast_test_*.npz"))
    if len(files) != written:
        raise AssertionError(f"{len(files)} forecast files for {written} forecasts")
    for path in files:
        with np.load(path) as f:
            pred = f["prediction"]
            if pred.shape != (AR_STEPS, ds.num_grid_points, N_STATE):
                raise AssertionError(f"{path.name}: shape {pred.shape}")
            if not np.isfinite(pred).all():
                raise AssertionError(f"{path.name}: non-finite values")
    shutil.rmtree(out_dir)

    fc_s = np.array(fc.seconds)
    gps = BATCH * ds.num_grid_points * AR_STEPS / fc_s.mean()
    log(
        f"serve on {card}: {written} forecasts of {AR_STEPS} steps in "
        f"{batches} requests of {BATCH}; wall per request {wall / batches:.3f} s "
        f"(forecast, standardize, copy back and npz writes); forecast per "
        f"request {', '.join(f'{s:.4f}' for s in fc_s)} s; "
        f"{gps:,.0f} grid-points/s over the forecast time; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )
    return launches


def bench_batch(ds, batch: int = BATCH):
    """One random batch ``(init, target, forcing)`` at ``ar_steps`` 1, as
    ``bench.make_bench_batch`` draws it (bench.py:363-372)."""
    n = ds.num_grid_points
    n_state = ds.get_num_data_vars("state")
    f_dim = ds.get_num_data_vars("forcing") * 3
    rng = np.random.default_rng(0)
    return (
        rng.normal(size=(batch, 2, n, n_state)).astype(np.float32),
        rng.normal(size=(batch, 1, n, n_state)).astype(np.float32),
        rng.normal(size=(batch, 1, n, f_dim)).astype(np.float32),
    )


def make_trainer(model, ds):
    """The ``bench.build_trainer`` trainer around ``model``, with the
    fixture's parameters loaded afresh and a new optimizer."""
    from neural_lam_tpu_torch.config import DatastoreSelection, NeuralLAMConfig
    from neural_lam_tpu_torch.convert_checkpoint import (
        load_jax_params_npz,
        params_from_jax,
    )
    from neural_lam_tpu_torch.models import ARForecaster
    from neural_lam_tpu_torch.trainer import Trainer, TrainingArgs

    model.load_state_dict(
        params_from_jax(
            load_jax_params_npz(FIXTURES / "graph_lam_meps_params_seed0.npz")
        ),
        strict=True,
    )
    config = NeuralLAMConfig(
        datastore=DatastoreSelection(kind="dummydata", config_path="")
    )
    args = TrainingArgs(batch_size=BATCH, ar_steps_train=1, lr=TRAIN_LR)
    return Trainer(ARForecaster(model, ds), config, ds, args, device=model.device)


def phase_train_gate(torch, trainer, fixture_path) -> dict:
    """Loss and gradients of the bench batch, then the losses of further
    AdamW steps, against the JAX package's fixture (made by
    ``tests/test_torch_train.py``). The trainer's model must hold the
    ``PRNGKey(0)`` parameters; they are updated in place."""
    from neural_lam_tpu_torch.convert_checkpoint import grads_to_numpy

    ds = trainer.datastore
    with np.load(fixture_path) as fx:
        want_losses = fx["losses"].astype(np.float64)
        grid, batch, lr = fx["grid"], int(fx["batch"]), float(fx["lr"])
        want_grads = {k[len("grad/"):]: fx[k] for k in fx.files if k.startswith("grad/")}
    shape = ds.grid_shape_state
    if tuple(grid) != (shape.x, shape.y) or lr != trainer.args.lr:
        raise AssertionError(
            f"train fixture is for grid {tuple(grid)} at lr {lr}, the trainer "
            f"has {(shape.x, shape.y)} at {trainer.args.lr}"
        )
    data = [torch.from_numpy(a).to(trainer.device) for a in bench_batch(ds, batch)]
    trainer.optimizer = trainer.init_state()
    trainer.optimizer.zero_grad(set_to_none=True)
    loss = trainer._loss(*data)
    loss.backward()
    got_grads = grads_to_numpy(trainer.forecaster.predictor)
    trainer.optimizer.step()
    losses = [loss.item()]
    losses += [trainer.train_step(*data).item() for _ in want_losses[1:]]

    if sorted(got_grads) != sorted(want_grads):
        raise AssertionError("train gate: gradient names differ from the fixture")
    grad_rel, worst = 0.0, ""
    for key, want in want_grads.items():
        got = got_grads[key]
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"train gate: gradient {key} has a wrong shape or is not finite")
        rel = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
        if rel > grad_rel:
            grad_rel, worst = rel, key
        if rel > TRAIN_GRAD_TOL:
            raise AssertionError(
                f"train gate: gradient {key} is off by {rel:.3e} of its largest "
                f"value (tol {TRAIN_GRAD_TOL})"
            )
    rels = np.abs(np.array(losses) - want_losses) / np.abs(want_losses)
    log(
        f"train gate: loss {losses[0]:.8g} vs {want_losses[0]:.8g} (rel "
        f"{rels[0]:.3e}, tol {TRAIN_LOSS_RTOL}); {len(want_grads)} gradients, "
        f"worst {grad_rel:.3e} of its largest value at {worst} (tol "
        f"{TRAIN_GRAD_TOL}); losses of {len(losses) - 1} further AdamW steps "
        f"{', '.join(f'{x:.8g}' for x in losses[1:])} vs "
        f"{', '.join(f'{x:.8g}' for x in want_losses[1:])} (rel up to "
        f"{rels[1:].max():.3e}, tol {TRAIN_TRAJ_RTOL})"
    )
    if not np.isfinite(losses).all():
        raise AssertionError("train gate: non-finite loss")
    if rels[0] > TRAIN_LOSS_RTOL or rels[1:].max() > TRAIN_TRAJ_RTOL:
        raise AssertionError("train gate: losses outside their tolerances")
    return dict(loss_rel=float(rels[0]), grad_rel=grad_rel, losses=losses)


def kernel_counters():
    from neural_lam_tpu_torch.ops.fused_kernels import fused_edge_bwd, fused_edge_phase
    from neural_lam_tpu_torch.ops.segment_kernels import sender_gather, sender_scatter

    return {
        "K1 sender_gather": sender_gather,
        "K3 fused_edge_phase": fused_edge_phase,
        "K2 sender_scatter": sender_scatter,
        "K4 fused_edge_phase backward": fused_edge_bwd,
    }


def phase_train(torch, trainer, card: str) -> dict[str, int]:
    """Training steps through ``Trainer.train_step`` on the bench batch;
    returns each kernel's launches in this run, which must be 6 per
    step."""
    ds = trainer.datastore
    data = [torch.from_numpy(a).to(trainer.device) for a in bench_batch(ds)]
    counters = kernel_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    # warm-up steps wait for the device; the timed steps are queued back
    # to back and waited for once, as bench.py times them, so the host may
    # run ahead of the device. Events mark the steps on the device's clock.
    losses = [trainer.train_step(*data).item() for _ in range(TRAIN_WARMUP)]
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_ITERS + 1)]
    timed = []
    marks[0].record()
    for mark in marks[1:]:
        timed.append(trainer.train_step(*data))
        mark.record()
    torch.cuda.synchronize()
    losses += [loss.item() for loss in timed]
    times = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()

    steps = TRAIN_WARMUP + TRAIN_ITERS
    for name, count in launches.items():
        log(f"train: {name} launches {count} (want 6 x {steps} = {6 * steps})")
        if count != 6 * steps:
            raise AssertionError(f"{name}: {count} launches, want {6 * steps}")
    log("train: loss per step " + ", ".join(f"{x:.6f}" for x in losses))
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError("train: losses are not finite and falling")
    step_ms = marks[0].elapsed_time(marks[-1]) / TRAIN_ITERS
    gps = BATCH * ds.num_grid_points / (step_ms / 1e3)
    log(
        f"train on {card}: {steps} steps of batch {BATCH}, ar_steps 1, float32 "
        f"(TF32 off); step time {step_ms:.3f} ms (the last {TRAIN_ITERS} steps "
        f"queued back to back: {', '.join(f'{t:.2f}' for t in times)}); "
        f"{gps:,.0f} training grid-points/s; peak device memory "
        f"{peak / 2**30:.2f} GiB"
    )
    return launches


def main() -> int:
    if not (REPO / "neural_lam_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(neural_lam_tpu_torch/ not found beside it)", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from neural_lam_tpu_torch.ops import kernel_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
        "TF32 off (matmul and cuDNN)"
    )

    t0 = time.perf_counter()
    kernels = ["sender_gather", "sender_scatter", "fused_edge", "fused_edge_bwd"]
    kernel_build.build(kernels)
    log(
        f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(k + '.cu' for k in kernels)}; nvcc for sm_90a, one "
        "process per source)"
    )
    for name in kernels:
        ptxas = kernel_build.build_log(name).splitlines()
        used = [line.split(":", 1)[1].strip() for line in ptxas if "registers" in line]
        spills = [line.strip() for line in ptxas if "spill" in line]
        log(f"  {name}: {'; '.join(used)}; {'; '.join(sorted(set(spills)))}")

    CACHE.mkdir(exist_ok=True)
    gate_ds, serve_ds, model, forecaster = build_meps(torch)
    with torch.no_grad():
        report = phase_kernels(torch, model)
    phase_gate(torch, gate_ds, forecaster)
    serve_launches = phase_serve(torch, serve_ds, model, card)
    phase_train_gate(torch, make_trainer(model, gate_ds), TRAIN_FIXTURE)
    train_launches = phase_train(torch, make_trainer(model, gate_ds), card)
    # each main path was driven with the counters at 0 just before it
    for entry in report:
        name = entry["name"]
        entry["launches"] = serve_launches.get(name, 0) + train_launches[name]
        log(
            f"{name}: {serve_launches.get(name, 0)} launches in the serve "
            f"phase, {train_launches[name]} in the train phase"
        )

    log(card)
    log(json.dumps({"kernels": report}))
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
