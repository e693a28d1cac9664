#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``neural_lam_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--parent DIR]

``--parent DIR`` names a checkout of the commit before the tensor-core K3
and K4 (their SIMT design and C interface): its ``fused_edge.cu`` and
``fused_edge_bwd.cu`` are built too and timed on the same inputs in the
same call, beside the current K3 and K4.

It builds the port's eight CUDA kernels from ``neural_lam_tpu_torch/csrc``
and drives the forecast path and the training step at the MEPS
configuration of ``bench.py`` (268x238 grid, hidden 64, 4 processor
layers, batch 4, float32) for three model families and the three routes
of the edge phase: fused (K1-K4), its v2 form with the sender gather
inside the kernel (K7, K8 and K2; ``NEURAL_LAM_TPU_FUSED_V2=on``, set
around whole phases) and unfused (K1, K2, K5, K6). Each phase passes or
raises; nothing is caught.

GraphLAM, ``hidden_layers=1`` (the fused route: K1-K4, and K7/K8 on v2):

1. Kernels against their plain PyTorch versions, at the shapes of the
   six GNN calls (g2m, m2m x 4, m2g) at batch 4: max abs/rel error
   against the stated tolerance, and times from CUDA events (the kernel,
   its plain version and, for K1, K2, K5 and K6, ``index_select`` and
   ``index_add_``). K3 is timed with and without the ``pre`` output that
   its backward, K4, starts from; K3 and K4 beside their bound on the
   tensor cores (3xTF32) and on the SIMT units, and then in the probe of
   ``phase_probe`` (uniform in-degree, LayerNorm off, occupancy). All six kernels are also held against
   their plain versions at each of the ten mesh edge sets of the
   hierarchical graph (from 51,520 edges into 6,561 receivers down to 40
   edges into 9; in-degrees of exactly 9 on the up sets and 1 on the
   down sets), K3 and K4 in each mode the hierarchical models use.
   K7 and K8 likewise: at the six calls against their plain versions
   (K7's aggregate, updated edges and ``pre``; K8's ``d_pre``,
   ``d_recproj``, edge and every weight gradient; the same bits on a
   second run), with K2 on K8's ``d_pre``, each timed beside K1 + K3 and
   K4 on the same inputs, and the whole v2 phase against the v1 route; at
   the ten level sets through the per-section entry, against the plain
   version and the v1 route, with LayerNorm off in one mode.
2. Accuracy gate: a 19-step batch-1 rollout with the JAX package's
   ``PRNGKey(0)`` parameters (``tests/fixtures/accuracy/
   graph_lam_meps_params_seed0.npz``) against the committed exact-f32
   rollout ``tests/fixtures/accuracy/rollout19_f32.npz``, with the
   metrics and thresholds of ``scripts/accuracy_probe.py``.
3. Serving: ``predict.run_forecasts`` over a MEPS-size dummy test split,
   one batch of 4 samples at 19 AR steps. Every kernel's launch counter
   is set to 0 just before and must read its count per AR step after.
4. Training gate: the loss and every parameter gradient of one batch of
   4 (made as ``bench.make_bench_batch`` makes it), then the losses of
   three further AdamW steps, against the committed exact-f32 JAX
   fixture ``tests/fixtures/accuracy/train_step_meps_seed0.npz``.
5. Training: ``Trainer.train_step`` on that batch, 2 warm-up and 10
   timed steps (``bench.py``'s counts). The counters are set to 0 just
   before and must read their count per step after; the losses must be
   finite and fall.

Phases 2-5 run twice: on the default route and on the v2 route, where
every GNN application launches K7 and no K1 or K3 (and K8 and K2, no K4,
backward), against the same fixtures at the same limits.

Then, for ``GraphLAM(hidden_layers=2)`` (path U, the unfused route: K1,
K6, the edge MLP, K5; K2, K5, K6 backward), ``HiLAM`` and
``HiLAMParallel`` on the hierarchical graph (path H, K1-K4 on 64 and 48
GNN applications per step):

6. Model gate against the JAX package, from ``tests/fixtures/accuracy/
   gate_<model>_meps.npz`` (made on the CPU by ``tests/test_torch_hier.py``
   from parameters both sides draw from a numpy seed by state-dict
   name): the state after AR steps 1 and 3 of a batch-4 rollout at every
   257th grid node, the training loss, per gradient its largest entry
   and 16 sampled entries, and the losses of three further AdamW steps.
7. Serving and training as in 3 and 5, with the launch counts derived
   from the number of mesh levels and processor layers.

``HiLAMParallel``'s gate runs once more on the v2 route (its per-section
``fused_edge_phase`` entry).

Last, ``HiLAMParallel(hidden_layers=2)`` at one processor layer serves
two AR steps, so that K5 and K6 also run on the level sets in a model;
then the report: a ``{"kernels": [...]}`` line and the
``{"ok": true, "device": ...}`` line.

Parity is float32: TF32 is off for PyTorch's matmuls and for cuDNN, and
K3 and K4 run their products on the tensor cores with the 3xTF32 split,
at float32 accuracy. The
script needs one CUDA device and exits non-zero without one, and outside
a checkout of the repository. Generated data, the graphs and the
forecasts go under ``.smoke_cache/`` in the checkout.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
import zlib
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

# Peak rates of one H100 SXM (NVIDIA's data sheet, at 700 W): HBM3 bytes/s,
# float32 outside the tensor cores, and dense TF32 on the tensor cores. K3
# and K4 (and, as a bound, K7 and K8) run their float32 products on the
# tensor cores at float32 accuracy as three TF32 products each (3xTF32), so
# their operations bound is 3 x FLOP / TF32_FLOP_PER_S; the SIMT bound,
# FLOP / FP32_FLOP_PER_S, is printed beside it.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12

# Tolerances against the plain versions on the same card, float32 on both
# sides (3xTF32 in K3 and K4 rounds like another summation order). K1 is a
# copy: bit-identical. K3 differs from the plain version only in rounding
# and summation order (64-term dot products, LayerNorm moments
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
# K6 is a copy: bit-identical. K5 sums up to ~40 O(1) edge rows per
# receiver in slot order where index_add_ adds with atomics in any order:
# rounding only, relative to the largest sum.
K6_TOL = 0.0
K5_TOL = 1e-5
# K7 and K8 differ from their plain versions in summation order only, as K3
# and K4 do, and are held to the same tolerances; so is the whole v2 phase
# against the v1 route (K1 + K3, K4 + K2), which sums sp[sender] formed once
# per node where v1 forms x_send . W1s per edge.

# The environment variable that routes every fused phase to K7/K8 when "on"
FUSED_V2 = "NEURAL_LAM_TPU_FUSED_V2"

# The model gates of the later paths: name -> (class, graph, model kwargs)
GATE_MODELS = {
    "graph_lam_h2": ("GraphLAM", "multiscale", dict(hidden_layers=2)),
    "hi_lam": ("HiLAM", "hierarchical", {}),
    "hi_lam_parallel": ("HiLAMParallel", "hierarchical", {}),
}
GATE_SEED = 0
GATE_ROLLOUT_STEPS = 3  # the states after steps 1 and 3 are compared
GATE_NODE_STRIDE = 257  # every 257th grid node
GATE_GRAD_SAMPLES = 16  # entries kept per gradient, beside its largest
# States of a 3-step rollout against the JAX package's float32 run on a
# CPU, relative to the mean absolute state: summation order only, as in
# the 19-step gate, which sits near 1e-6; a fault shows as 1e-2 or more.
GATE_STATE_MEAN_REL, GATE_STATE_MAX_REL = 1e-4, 1e-3

# scripts/accuracy_probe.py's thresholds (:139-140), sized for the TPU's
# bf16-rounded matmuls; exact f32 on the card is expected near 1e-5.
GATE_MEAN_REL, GATE_MAX_REL = 0.025, 0.25
GATE_FAULT_MEAN_REL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def fused_v2(mode: str):
    """``NEURAL_LAM_TPU_FUSED_V2=mode`` for a whole phase, restored after:
    the route is read at every call, so a phase never changes it midway."""
    old = os.environ.get(FUSED_V2)
    os.environ[FUSED_V2] = mode
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(FUSED_V2)
        else:
            os.environ[FUSED_V2] = old


def on_v2() -> bool:
    """Every fused phase takes the v2 route (K7; K8 and K2 backward)."""
    from neural_lam_tpu_torch.ops.fused_kernels import fused_v2_enabled

    return os.environ.get(FUSED_V2) == "on" and fused_v2_enabled()


def model_label(model) -> str:
    route = ", v2 route" if on_v2() and model.hidden_layers == 1 else ""
    return f"{type(model).__name__}(hidden_layers={model.hidden_layers}){route}"


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


def bound(nbytes: float, flops: float, tensor: bool = False) -> tuple[float, str]:
    """Least time in ms for ``nbytes`` moved and ``flops`` done, and
    which of the two sets it. With ``tensor`` the operations are float32
    products that the tensor cores do at float32 accuracy as three TF32
    products; else they run on the float32 SIMT units."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (3 * flops / TF32_FLOP_PER_S) if tensor else flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def parent_kernels(torch, parent: Path):
    """K3 and K4 of their earlier SIMT design, from a checkout of the
    commit before the tensor-core redesign at ``parent``, for a same-call
    comparison: ``(fwd, bwd)``, each called like
    ``fused_kernels.fused_edge_fwd`` / ``fused_edge_bwd`` with the same
    inputs (``fwd`` returns what that returns; ``bwd`` does the same work
    and returns None). Uses that design's C interface of
    ``nl_fused_edge_fwd`` (no work counter) and ``nl_fused_edge_bwd`` (one
    block count, a 3-matrix main workspace)."""
    import ctypes

    from neural_lam_tpu_torch.ops import fused_kernels as fk
    from neural_lam_tpu_torch.ops import kernel_build

    csrc = parent / "neural_lam_tpu_torch" / "csrc"
    libs = {}
    procs = []
    for name in ("fused_edge", "fused_edge_bwd"):
        out = kernel_build.BUILD_DIR / f"parent-{name}.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [kernel_build._nvcc(), *kernel_build.NVCC_FLAGS, "-o", str(out),
               str(csrc / f"{name}.cu")]
        procs.append((name, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, out, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"parent {name}.cu did not build:\n{text}")
        libs[name] = ctypes.CDLL(str(out))
    fwd_c = libs["fused_edge"].nl_fused_edge_fwd
    fwd_c.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 20
    bwd_c = libs["fused_edge_bwd"].nl_fused_edge_bwd
    bwd_c.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p] * 25
    ptr = fk._ptr

    def fwd(edge_in, x_send, rec, es, weights, raw, update, prop, save_pre=False):
        mode, feat = fk._check_inputs(edge_in, x_send, rec, es, weights, raw)
        dev, shape = x_send.device, tuple(x_send.shape)
        aggr = torch.empty(tuple(rec.shape), device=dev)
        new_edge = torch.empty(shape, device=dev) if update else None
        pre = torch.empty(shape, device=dev) if save_pre else None
        err = fwd_c(mode, es.num_rec, shape[1], feat, int(update), int(prop),
                    int(weights[4] is not None), ptr(edge_in), ptr(x_send), ptr(rec),
                    ptr(es.rowptr), *(ptr(w) for w in weights), ptr(aggr),
                    ptr(new_edge), ptr(pre), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent K3: CUDA error {err}")
        return aggr, new_edge, pre

    def bwd(d_aggr, d_new, pre, edge_in, x_send, rec, es, weights, raw, prop):
        mode, feat = fk._check_inputs(edge_in, x_send, rec, es, weights, raw)
        dev, d = x_send.device, HIDDEN
        n_e, b = x_send.shape[0], x_send.shape[1]
        blocks = torch.cuda.get_device_properties(dev).multi_processor_count
        batched = mode == 2
        d_edge = torch.empty((n_e, b, d) if batched else (n_e, d), device=dev)
        ws_main, out_main = torch.empty(blocks, 12544, device=dev), torch.empty(12544, device=dev)
        presum = out_edge = ws_edge = None
        if not batched:
            presum, out_edge = torch.empty(n_e, d, device=dev), torch.empty(8960, device=dev)
            ws_edge = torch.empty(blocks, 8960, device=dev)
        d_send, d_rec = torch.empty(n_e, b, d, device=dev), torch.empty(es.num_rec, b, d, device=dev)
        err = bwd_c(mode, es.num_rec, n_e, b, feat, int(prop), int(weights[4] is not None),
                    blocks, ptr(edge_in), ptr(x_send), ptr(pre), ptr(d_aggr), ptr(d_new),
                    ptr(es.rowptr), ptr(weights[0]), ptr(weights[2]), ptr(weights[3]),
                    ptr(weights[4]), *(ptr(w) for w in weights[6:]), ptr(d_send),
                    ptr(d_edge), ptr(d_rec), ptr(presum), ptr(ws_main), ptr(out_main),
                    ptr(ws_edge), ptr(out_edge), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent K4: CUDA error {err}")
        # the rest of that design's wrapper: the receiver slice's
        # node-sized products and the assembled first-layer gradient
        mats = out_main[: 3 * d * d].view(3, d, d)
        dw1e = mats[2] if batched else out_edge[: d * d].view(d, d)
        d_rec @ weights[0][:, 2 * d :]
        dw1r = torch.einsum("nbc,nbk->ck", d_rec, rec)
        torch.cat([dw1e, mats[1], dw1r], dim=1)

    return fwd, bwd


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def errors(got, want) -> tuple[float, float]:
    """Max abs error and max abs error over the reference's max abs."""
    diff = (got - want).abs().max().item()
    return diff, diff / max(want.abs().max().item(), 1e-30)


def meps_datastores():
    """The MEPS-size dummy datastores: the gates' (``bench.py``'s) and
    the longer one that serving reads its test split from."""
    from neural_lam_tpu_torch.datastore.dummy import DummyDatastore

    kw = dict(
        n_grid_x=GRID_X, n_grid_y=GRID_Y, n_state_features=N_STATE,
        n_forcing_features=N_FORCING, n_static_features=N_STATIC,
        root_path=CACHE / "meps",
    )
    return (
        DummyDatastore(n_timesteps=GATE_TIMESTEPS, **kw),
        DummyDatastore(n_timesteps=SERVE_TIMESTEPS, **kw),
    )


def build_meps(torch):
    """The MEPS dummy datastores, graph and GraphLAM with the fixture's
    parameters, all built with the port's own code."""
    from neural_lam_tpu_torch.convert_checkpoint import (
        load_jax_params_npz,
        params_from_jax,
    )
    from neural_lam_tpu_torch.graphs import create_graph_from_datastore
    from neural_lam_tpu_torch.models import ARForecaster, GraphLAM

    t0 = time.perf_counter()
    gate_ds, serve_ds = meps_datastores()
    root = gate_ds.root_path
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


def gate_fixture(name: str) -> Path:
    return FIXTURES / f"gate_{name}_meps.npz"


def seeded_state_dict(shapes: dict, seed: int = GATE_SEED) -> dict:
    """Parameters drawn from a numpy seed by state-dict name, so that the
    port and the JAX package get the same values without a parameter file
    (``tests/test_torch_hier.py`` converts this dictionary into the JAX
    pytree). ``shapes`` maps each name to its ``(out, in)`` / ``(out,)``
    shape. Linear weights are uniform in ``+-1/sqrt(fan_in)``, biases in
    ``+-0.1``; a LayerNorm (the odd index that closes an MLP's
    ``nn.Sequential``) gets a scale of ``1 +- 0.1`` and a bias of
    ``+-0.1``."""
    out = {}
    for name, shape in shapes.items():
        rng = np.random.default_rng([seed, zlib.crc32(name.encode())])
        index, kind = name.split(".")[-2:]
        u = rng.uniform(-1.0, 1.0, size=tuple(shape))
        if int(index) % 2:
            arr = 0.1 * u + (1.0 if kind == "weight" else 0.0)
        elif kind == "weight":
            arr = u / np.sqrt(shape[1])
        else:
            arr = 0.1 * u
        out[name] = arr.astype(np.float32)
    return out


def load_seeded(torch, model) -> None:
    """Load :func:`seeded_state_dict` parameters into ``model``."""
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in seeded_state_dict(shapes).items()},
        strict=True,
    )


def build_model(torch, name: str, ds, device=None, **overrides):
    """One of ``GATE_MODELS`` on ``ds`` with the seeded parameters; the
    graph it needs is built under the datastore's root if missing."""
    from neural_lam_tpu_torch import models
    from neural_lam_tpu_torch.graphs import create_graph_from_datastore

    cls, graph_name, kwargs = GATE_MODELS[name]
    graph_dir = ds.root_path / "graph" / graph_name
    if not (graph_dir / "graph.npz").exists():
        create_graph_from_datastore(
            ds, graph_dir, hierarchical=graph_name == "hierarchical"
        )
    kwargs = dict(
        dict(hidden_dim=HIDDEN, processor_layers=PROC_LAYERS), **kwargs, **overrides
    )
    model = getattr(models, cls)(
        ds, graph_name=graph_name, device=device or DEVICE, **kwargs
    )
    load_seeded(torch, model)
    model.eval()
    return model


def gnn_applications(model) -> int:
    """GNN applications of one model step, from the number of mesh
    levels ``L`` and processor layers ``P``: g2m and m2g, plus for the
    hierarchical families the init and read-out sweeps, ``2 (L - 1)``,
    and per layer HiLAM's down and up sweeps of ``2 L - 1`` each or
    HiLAMParallel's ``3 L - 2`` sections."""
    p = model.processor_layers
    if not model.hierarchical:
        return 2 + p
    levels = model.num_levels
    per_layer = (
        2 * (2 * levels - 1) if type(model).__name__ == "HiLAM" else 3 * levels - 2
    )
    return 2 + 2 * (levels - 1) + p * per_layer


def expected_launches(model, training: bool) -> dict[str, int]:
    """Launches of each kernel per AR step (serving) or per training
    step, derived from the model. On the fused route every application
    launches K1 and K3 (K2 and K4 backward), or under
    ``NEURAL_LAM_TPU_FUSED_V2=on`` K7 alone (K8 and K2 backward); on the
    unfused route K1, K6 and K5 (backward K2, and K5 and K6 once more as
    each other's VJP)."""
    n = gnn_applications(model)
    fused = model.hidden_layers == 1
    want = dict.fromkeys(kernel_counters(), 0)
    if fused and on_v2():
        want["K7 fused_edge_phase_v2"] = n
        if training:
            want["K8 fused_edge_phase_v2 backward"] = want["K2 sender_scatter"] = n
        return want
    want["K1 sender_gather"] = n
    if fused:
        want["K3 fused_edge_phase"] = n
    else:
        want["K5 segment_sum"] = want["K6 receiver_expand"] = n
    if training:
        want["K2 sender_scatter"] = n
        if fused:
            want["K4 fused_edge_phase backward"] = n
        else:
            want["K5 segment_sum"] = want["K6 receiver_expand"] = 2 * n
    return want


def phase_kernels(torch, model, parent=None) -> list[dict]:
    """Each kernel against its plain version at the shapes of the six
    GNN calls; returns the per-kernel report, times summed over the calls
    of one AR step (K1, K3) or one training step (K2, K4). With
    ``parent`` (:func:`parent_kernels`), K3 and K4 of the parent commit
    are timed on the same inputs in the same call."""
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
              bytes_ms=0.0, simt_ms=0.0, old_ms=0.0, old_pre_ms=0.0)
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
        b_ms, b_by = bound(moved, flops, tensor=True)
        simt_ms, _ = bound(moved, flops)
        old = "old design not measured"
        if parent is not None:
            old_ms = cuda_ms(lambda: parent[0](
                edge_in, x_send, rec, es, wts, mode == "raw", update, False))
            old_pre_ms = cuda_ms(lambda: parent[0](
                edge_in, x_send, rec, es, wts, mode == "raw", update, False,
                save_pre=True))
            k3["old_ms"] += calls * old_ms
            k3["old_pre_ms"] += calls * old_pre_ms
            old = f"old design {old_ms:.4f} ms, with pre {old_pre_ms:.4f} ms"
        log(
            f"K3 fused_edge_phase {site}: E {n_e}, receivers {n_rec}, "
            f"edge input {mode}, update_edges {update}; max abs err "
            f"{abs_err:.3g}, max rel err {rel_err:.3g} (rtol/atol "
            f"{K3_RTOL}); kernel {ms:.4f} ms, with the pre output "
            f"{pre_ms:.4f} ms, {old}; plain {plain_ms:.4f} ms; bound "
            f"{b_ms:.4f} ms ({b_by}, 3xTF32 tensor cores: {moved / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP; {100 * b_ms / ms:.1f} % of it), SIMT bound "
            f"{simt_ms:.4f} ms; {calls} call(s) per AR step"
        )
        k3["simt_ms"] += calls * simt_ms
        k3["ms"] += calls * ms
        k3["plain_ms"] += calls * plain_ms
        k3["bound_ms"] += calls * b_ms
        k3["ops_ms" if b_by == "operations" else "bytes_ms"] += calls * b_ms
        k3["err"] = max(k3["err"], abs_err)
        del x_send, rec, edge_rep, got, want, outs
    log(
        f"K3 per AR step: {k3['ms']:.4f} ms, with the pre output (as the "
        f"training step runs it) {k3['pre_ms']:.4f} ms; old design (same "
        f"call) {k3['old_ms']:.4f} / {k3['old_pre_ms']:.4f} ms (0 = not measured); "
        f"bound {k3['bound_ms']:.4f} ms (3xTF32), {100 * k3['bound_ms'] / k3['ms']:.1f} "
        f"% of it; SIMT bound {k3['simt_ms']:.4f} ms"
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
    k4 = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, ops_ms=0.0, bytes_ms=0.0,
              simt_ms=0.0, old_ms=0.0)
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
        b_ms, b_by = bound(moved, flops, tensor=True)
        simt_ms, _ = bound(moved, flops)
        old = "old design not measured"
        if parent is not None:
            old_ms = cuda_ms(lambda: parent[1](
                d_aggr, d_new, pre, edge_in, x_send, rec, es, wts, raw, False))
            k4["old_ms"] += calls * old_ms
            old = f"old design {old_ms:.4f} ms"
        log(
            f"K4 fused_edge_phase backward {site}: E {n_e}, receivers {n_rec}, "
            f"edge input {mode}, d_new_edge {'given' if has_dne else 'none'}; "
            f"max abs err {abs_err:.3g}, at most {rel_err:.3g} of a gradient's "
            f"largest value (tol {K4_TOL}), repeatable; kernel {ms:.4f} ms, {old}; "
            f"plain (autograd) {plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}, "
            f"3xTF32 tensor cores: {moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP; "
            f"{100 * b_ms / ms:.1f} % of it), SIMT bound {simt_ms:.4f} ms; {calls} "
            "call(s) per training step"
        )
        k4["simt_ms"] += calls * simt_ms
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
        f"index_add_ {k2['library_ms']:.4f}), K4 {k4['ms']:.4f} ms (old design "
        f"(same call) {k4['old_ms']:.4f} ms, 0 = not measured; bound "
        f"{k4['bound_ms']:.4f} ms (3xTF32), {100 * k4['bound_ms'] / k4['ms']:.1f} % "
        f"of it; SIMT bound {k4['simt_ms']:.4f} ms; plain {k4['plain_ms']:.4f})"
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


def uniform_edge_set(torch, es):
    """An edge set with the edges and receivers of ``es`` (and its
    senders) whose in-degrees differ by at most one: what ``es`` would
    cost without load imbalance."""
    from neural_lam_tpu_torch.ops.interaction import make_edge_set

    n_e, n_rec = es.num_edges, es.num_rec
    counts = np.full(n_rec, n_e // n_rec)
    counts[: n_e % n_rec] += 1
    receivers = np.repeat(np.arange(n_rec), counts)
    senders = es.senders.cpu().numpy()
    uni, _ = make_edge_set(senders, receivers, num_rec=n_rec, num_send=es.num_send)
    return uni.to(es.senders.device)


def phase_probe(torch, model) -> dict:
    """What holds K3 and K4 back at the six GraphLAM sites, batch 4, from
    their existing inputs and flags only: each timed as the main path
    calls it, on an edge set of the same size with uniform in-degree
    (the cost of load imbalance), with LayerNorm off, and K3 with and
    without the ``pre`` output; then each kernel's blocks and warps per
    SM, registers and shared memory in every edge mode. Returns the
    per-step sums."""
    from neural_lam_tpu_torch.ops.fused_kernels import (
        _weights,
        fused_edge_bwd,
        fused_edge_fwd,
        kernel_occupancy,
    )

    g, dev, d, b = model.graph, model.device, HIDDEN, BATCH
    gen = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    n_grid, n_mesh = g.num_grid_nodes, g.num_mesh_nodes
    m2m, proc = g.m2m[0], list(model.processor.values())
    # (site, net, edges, embedder, edge input, update_edges, d_new_edge
    # given, calls per AR step, calls per training step, receivers)
    sites = [
        ("g2m", model.g2m_gnn, g.g2m, model.g2m_embedder, "raw", False, False, 1, 1,
         n_mesh),
        ("m2m layer 0", proc[0], m2m, model.m2m_embedder, "raw", True, True, 1, 1,
         n_mesh),
        ("m2m layers 1-3", proc[1], m2m, None, "batched", True, True,
         PROC_LAYERS - 1, PROC_LAYERS - 2, n_mesh),
        (f"m2m layer {PROC_LAYERS - 1} (training)", proc[-1], m2m, None, "batched",
         True, False, 0, 1, n_mesh),
        ("m2g", model.m2g_gnn, g.m2g, model.m2g_embedder, "raw", False, False, 1, 1,
         n_grid),
    ]
    keys = ("k3", "k3_pre", "k3_uniform", "k3_no_ln", "k4", "k4_uniform", "k4_no_ln")
    total = dict.fromkeys(keys, 0.0)
    for site, net, ge, emb, mode, update, has_dne, fwd_calls, bwd_calls, n_rec in sites:
        es = ge.edges
        uni = uniform_edge_set(torch, es)
        n_e, raw = es.num_edges, mode == "raw"
        x_send, rec = randn(n_e, b, d), randn(n_rec, b, d)
        edge_in = ge.features if raw else randn(n_e, b, d)
        d_aggr = randn(n_rec, b, d)
        d_new = randn(n_e, b, d) if has_dne else None
        wts = _weights(net.edge_mlp, emb)
        no_ln = list(wts)
        no_ln[4] = no_ln[5] = None

        def k3(edge_set, weights=wts, save_pre=False):
            return fused_edge_fwd(edge_in, x_send, rec, edge_set, weights, raw, update,
                                  False, save_pre=save_pre)

        _, _, pre = k3(es, save_pre=True)
        _, _, pre_u = k3(uni, save_pre=True)

        def k4(edge_set, p, weights=wts):
            return fused_edge_bwd(d_aggr, d_new, p, edge_in, x_send, rec, edge_set,
                                  weights, raw, False)

        got = dict(
            k3=cuda_ms(lambda: k3(es)),
            k3_pre=cuda_ms(lambda: k3(es, save_pre=True)),
            k3_uniform=cuda_ms(lambda: k3(uni)),
            k3_no_ln=cuda_ms(lambda: k3(es, no_ln)),
            k4=cuda_ms(lambda: k4(es, pre)),
            k4_uniform=cuda_ms(lambda: k4(uni, pre_u)),
            k4_no_ln=cuda_ms(lambda: k4(es, pre, no_ln)),
        )
        deg = es.recv_counts.float()
        log(
            f"probe {site}: E {n_e}, receivers {n_rec}, in-degree "
            f"{int(deg.min())}-{int(deg.max())} (mean {deg.mean().item():.2f}); "
            f"K3 {got['k3']:.4f} ms, with pre {got['k3_pre']:.4f}, uniform "
            f"in-degree {got['k3_uniform']:.4f}, LayerNorm off {got['k3_no_ln']:.4f}; "
            f"K4 {got['k4']:.4f} ms, uniform in-degree {got['k4_uniform']:.4f}, "
            f"LayerNorm off {got['k4_no_ln']:.4f}; {fwd_calls} forward and "
            f"{bwd_calls} backward call(s) per step"
        )
        for key in keys:
            total[key] += (bwd_calls if key.startswith("k4") else fwd_calls) * got[key]
        del x_send, rec, edge_in, d_aggr, d_new, pre, pre_u, uni
        torch.cuda.empty_cache()
    log(
        "probe per step: K3 {k3:.4f} ms (with pre {k3_pre:.4f}, uniform in-degree "
        "{k3_uniform:.4f}, LayerNorm off {k3_no_ln:.4f}); K4 {k4:.4f} ms (uniform "
        "in-degree {k4_uniform:.4f}, LayerNorm off {k4_no_ln:.4f})".format(**total)
    )
    for kernel, backward in (("K3", False), ("K4 main", True)):
        for mode, occ in kernel_occupancy(backward).items():
            log(
                f"probe {kernel} {mode}: {occ['blocks']} block(s) of {occ['threads']} "
                f"threads per SM = {occ['warps']} warps; {occ['regs']} registers per "
                f"thread, {occ['smem']} bytes of shared memory per block"
            )
    return total


def phase_host_cost(torch, model, parent=None) -> None:
    """Host time per call of K4's wrapper on the small hierarchical edge
    sets, where the host, not the card, sets a call's time: calls queued
    back to back without a synchronise, timed on the host's clock, and the
    parent commit's K4 beside it when ``parent`` is given."""
    from neural_lam_tpu_torch.ops.fused_kernels import (
        _weights,
        fused_edge_bwd,
        fused_edge_fwd,
    )

    g, dev, d, b = model.graph, model.device, HIDDEN, BATCH
    gen = torch.Generator(device=dev).manual_seed(6)
    wts = _weights(model.mesh_init_gnns[0].edge_mlp, None)
    sites = [(f"m2m[{len(g.m2m) - 1}]", g.m2m[-1]), (f"up[{len(g.up) - 1}]", g.up[-1]),
             ("down[1]", g.down[1]), ("m2m[1]", g.m2m[1])]
    for site, ge in sites:
        es = ge.edges
        n_e, n_rec = es.num_edges, es.num_rec
        x = torch.randn((n_e, b, d), generator=gen, device=dev)
        rec = torch.randn((n_rec, b, d), generator=gen, device=dev)
        edge = torch.randn((n_e, d), generator=gen, device=dev)
        d_aggr = torch.randn((n_rec, b, d), generator=gen, device=dev)
        _, _, pre = fused_edge_fwd(edge, x, rec, es, wts, False, True, False, save_pre=True)
        runs = [("K4", fused_edge_bwd)] + ([("old design", parent[1])] if parent else [])
        out = []
        for name, fn in runs:
            for _ in range(3):
                fn(d_aggr, None, pre, edge, x, rec, es, wts, False, False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                fn(d_aggr, None, pre, edge, x, rec, es, wts, False, False)
            host = (time.perf_counter() - t0) / 50
            torch.cuda.synchronize()
            out.append(f"{name} {1e6 * host:.1f} us")
        log(f"host K4 wrapper {site}: E {n_e}, receivers {n_rec}, shared edge input, "
            f"batch {b}; per call until enqueued: {', '.join(out)}")


def phase_segment_kernels(torch, graph, hier_graph) -> list[dict]:
    """K5 and K6 against their plain versions at batch 4: at the three
    multiscale sites, whose times are summed over the calls of one
    training step on the unfused route (each site once forward and once
    backward, for each of the two kernels), and at the hierarchical
    graph's mesh edge sets. Each use is checked directly and as the
    other's VJP (through ``gather_receivers`` / ``aggregate_sum``)."""
    from neural_lam_tpu_torch.ops import segment
    from neural_lam_tpu_torch.ops.segment_kernels import (
        receiver_expand,
        receiver_expand_plain,
        segment_sum,
        segment_sum_plain,
    )

    dev, d, b = graph.g2m.edges.senders.device, HIDDEN, BATCH
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # (site, edge set, calls of each kernel per training step on path U)
    sites = [
        ("g2m", graph.g2m, 2),
        ("m2m", graph.m2m[0], 2 * PROC_LAYERS),
        ("m2g", graph.m2g, 2),
    ]
    for kind, sets in (("m2m", hier_graph.m2m), ("up", hier_graph.up),
                       ("down", hier_graph.down)):
        sites += [(f"hierarchical {kind}[{i}]", ge, 0) for i, ge in enumerate(sets)]
    k5 = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, err=0.0)
    k6 = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, err=0.0)
    for site, ge, calls in sites:
        es = ge.edges
        n_e, n_rec = es.num_edges, es.num_rec
        idx_long = es.receivers.long()
        msg, x = randn(n_e, b, d), randn(n_rec, b, d)
        degree = es.recv_counts
        shape = (
            f"E {n_e}, receivers {n_rec}, in-degree "
            f"{int(degree.min())}-{int(degree.max())}"
        )

        got = segment_sum(msg, es)
        want = segment_sum_plain(msg, es.receivers, n_rec)
        torch.cuda.synchronize()
        abs5, rel5 = errors(got, want)
        if rel5 > K5_TOL:
            raise AssertionError(f"K5 {site}: max rel err {rel5} > {K5_TOL}")
        if not torch.equal(got, segment_sum(msg, es)):
            raise AssertionError(f"K5 {site}: two runs differ")
        ms5 = cuda_ms(lambda: segment_sum(msg, es))
        plain5 = cuda_ms(lambda: segment_sum_plain(msg, es.receivers, n_rec))
        lib5 = cuda_ms(lambda: torch.zeros_like(got).index_add_(0, idx_long, msg))
        bound5, _ = bound(nbytes(msg, es.rowptr, got), msg.numel())

        exp = receiver_expand(x, es)
        want_exp = receiver_expand_plain(x, es.receivers)
        torch.cuda.synchronize()
        abs6, _ = errors(exp, want_exp)
        if abs6 > K6_TOL:
            raise AssertionError(f"K6 {site}: max abs err {abs6} > {K6_TOL}")
        if not torch.equal(exp, receiver_expand(x, es)):
            raise AssertionError(f"K6 {site}: two runs differ")
        ms6 = cuda_ms(lambda: receiver_expand(x, es))
        plain6 = cuda_ms(lambda: receiver_expand_plain(x, es.receivers))
        lib6 = cuda_ms(lambda: torch.index_select(x, 0, idx_long))
        bound6, _ = bound(nbytes(x, es.rowptr, exp), 0.0)

        # each as the other's VJP, through the differentiable operations
        with torch.enable_grad():
            xg = x.clone().requires_grad_(True)
            (segment.gather_receivers(es, xg) * msg).sum().backward()
            mg = msg.clone().requires_grad_(True)
            (segment.aggregate_sum(es, mg) * x).sum().backward()
        torch.cuda.synchronize()
        if not torch.equal(xg.grad, got) or not torch.equal(mg.grad, exp):
            raise AssertionError(f"K5/K6 {site}: the VJPs differ from the kernels")
        log(
            f"K5 segment_sum {site}: {shape}; max abs err {abs5:.3g}, max rel "
            f"err {rel5:.3g} (tol {K5_TOL} of the largest sum), repeatable, "
            f"equal as the VJP of K6; kernel {ms5:.4f} ms, plain {plain5:.4f} ms, "
            f"index_add_ {lib5:.4f} ms, bound {bound5:.4f} ms (bytes); {calls} "
            "call(s) per training step on the unfused route"
        )
        log(
            f"K6 receiver_expand {site}: {shape}; max abs err {abs6:.3g} (tol "
            f"{K6_TOL}), repeatable, equal as the VJP of K5; kernel {ms6:.4f} ms, "
            f"plain {plain6:.4f} ms, index_select {lib6:.4f} ms, bound "
            f"{bound6:.4f} ms (bytes); {calls} call(s) per training step on the "
            "unfused route"
        )
        for acc, ms, plain, lib, b_ms, err in (
            (k5, ms5, plain5, lib5, bound5, abs5),
            (k6, ms6, plain6, lib6, bound6, abs6),
        ):
            acc["ms"] += calls * ms
            acc["plain_ms"] += calls * plain
            acc["library_ms"] += calls * lib
            acc["bound_ms"] += calls * b_ms
            acc["err"] = max(acc["err"], err)
        del msg, x, got, want, exp, want_exp, xg, mg
    log(
        f"per training step on the unfused route: K5 {k5['ms']:.4f} ms (bound "
        f"{k5['bound_ms']:.4f}, index_add_ {k5['library_ms']:.4f}), K6 "
        f"{k6['ms']:.4f} ms (bound {k6['bound_ms']:.4f}, index_select "
        f"{k6['library_ms']:.4f})"
    )
    torch.cuda.empty_cache()
    return [
        dict(
            name="K5 segment_sum",
            route="cuda",
            source="neural_lam_tpu_torch/csrc/segment_sum.cu",
            replaces="neural_lam_tpu/ops/pallas_segment.py:331",
            launches=0,
            max_abs_err=k5["err"],
            ms=k5["ms"],
            plain_ms=k5["plain_ms"],
            bound_ms=k5["bound_ms"],
            bound_by="bytes",
            library_ms=k5["library_ms"],
        ),
        dict(
            name="K6 receiver_expand",
            route="cuda",
            source="neural_lam_tpu_torch/csrc/receiver_expand.cu",
            replaces="neural_lam_tpu/ops/pallas_segment.py:407",
            launches=0,
            max_abs_err=k6["err"],
            ms=k6["ms"],
            plain_ms=k6["plain_ms"],
            bound_ms=k6["bound_ms"],
            bound_by="bytes",
            library_ms=k6["library_ms"],
        ),
    ]


def phase_level_sets(torch, model) -> dict[str, float]:
    """K1 to K4 at every mesh edge set of the hierarchical graph (same
    level, up and down; from more blocks than SMs down to fewer receivers
    than one block's share, in-degrees of exactly 9 and exactly 1), at the
    batch and width the hierarchical models give them. K1 and K2 directly
    against their plain versions; K3 and K4 in the modes the models use:
    an unbatched (shared) edge input with and without ``propagation``, a
    batched one with and without ``update_edges``, and, through the
    per-section entry, unbatched sender rows beside batched receiver rows
    (K1 and K2 then run inside the comparison too). Outputs and every
    gradient against the plain version; returns each kernel's largest
    absolute error."""
    from neural_lam_tpu_torch.ops import interaction
    from neural_lam_tpu_torch.ops.fused_kernels import (
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
    gen = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    sites = [
        (f"{kind}[{i}]", ge)
        for kind, sets in (("m2m", g.m2m), ("up", g.up), ("down", g.down))
        for i, ge in enumerate(sets)
    ]
    # (edge input, update_edges, propagation, sender rows)
    modes = [("shared", True, False, "batched"), ("shared", True, True, "batched"),
             ("batched", True, False, "batched"), ("batched", False, False, "batched"),
             ("shared", True, False, "unbatched")]
    mlp = model.mesh_init_gnns[0].edge_mlp
    params = list(mlp.parameters())
    worst = {"K1": 0.0, "K2": 0.0, "K3": 0.0, "K4": 0.0}
    for site, ge in sites:
        es = ge.edges
        n_e, n_rec, n_send = es.num_edges, es.num_rec, es.num_send
        shape = f"E {n_e}, senders {n_send}, receivers {n_rec}"

        with torch.no_grad():
            x, grad = randn(n_send, b, d), randn(n_e, b, d)
            rows = sender_gather(x, es.senders)
            sums = sender_scatter(grad, es, n_send)
            again = sender_scatter(grad, es, n_send)
            err1, _ = errors(rows, sender_gather_plain(x, es.senders))
            err2, rel2 = errors(sums, sender_scatter_plain(grad, es.senders, n_send))
        torch.cuda.synchronize()
        if err1 > K1_TOL:
            raise AssertionError(f"K1 {site}: max abs err {err1} > {K1_TOL}")
        if rel2 > K2_TOL:
            raise AssertionError(f"K2 {site}: max rel err {rel2} > {K2_TOL}")
        if not torch.equal(sums, again):
            raise AssertionError(f"K2 {site}: two runs differ")
        worst["K1"], worst["K2"] = max(worst["K1"], err1), max(worst["K2"], err2)
        log(
            f"K1/K2 level set {site}: {shape}; K1 max abs err {err1:.3g} (tol "
            f"{K1_TOL}); K2 max abs err {err2:.3g}, max rel err {rel2:.3g} (tol "
            f"{K2_TOL} of the largest sum), repeatable"
        )

        for mode, update, prop, senders in modes:
            send = randn(n_send, b, d) if senders == "batched" else randn(n_send, d)
            send, rec = send.requires_grad_(True), randn(n_rec, b, d).requires_grad_(True)
            edge = randn(n_e, d) if mode == "shared" else randn(n_e, b, d)
            edge.requires_grad_(True)
            w_aggr, w_edge = randn(n_rec, b, d), randn(n_e, b, d)
            leaves = [send, rec, edge] + params

            def loss(out):
                total = (out[0] * w_aggr).sum()
                return total + (out[1] * w_edge).sum() if update else total

            kw = dict(update_edges=update, propagation=prop)
            # K1 (K2 backward) then K3 (K4 backward), as the models call them
            got = interaction.fused_edge_phase(mlp, es, send, rec, edge, **kw)
            send_b = send if send.dim() == 3 else send.unsqueeze(1).expand(-1, b, -1)
            want = fused_edge_phase_plain(
                mlp, edge, sender_gather_plain(send_b, es.senders), rec,
                es.receivers, **kw,
            )
            got_g = torch.autograd.grad(loss(got), leaves)
            want_g = torch.autograd.grad(loss(want), leaves)
            # K3 and K4 alone, on the same gathered rows
            x_send = sender_gather_plain(send_b, es.senders).detach().requires_grad_(True)
            alone = fused_edge_phase(mlp, edge, x_send, rec, es, **kw)
            alone_g = torch.autograd.grad(loss(alone), [x_send, rec, edge] + params)
            plain = fused_edge_phase_plain(mlp, edge, x_send, rec, es.receivers, **kw)
            plain_g = torch.autograd.grad(loss(plain), [x_send, rec, edge] + params)
            torch.cuda.synchronize()
            n_out = 2 if update else 1
            for o, w in [*zip(got[:n_out], want), *zip(alone[:n_out], plain)]:
                torch.testing.assert_close(o, w, rtol=K3_RTOL, atol=K3_ATOL)
                worst["K3"] = max(worst["K3"], errors(o.detach(), w.detach())[0])
            worst_rel = 0.0
            for o, w in [*zip(got_g, want_g), *zip(alone_g, plain_g)]:
                a_err, r_err = errors(o, w)
                worst["K4"], worst_rel = max(worst["K4"], a_err), max(worst_rel, r_err)
                if r_err > K4_TOL:
                    raise AssertionError(
                        f"K4 {site} {mode}: max err {a_err} is {r_err} of the "
                        f"largest value (tol {K4_TOL})"
                    )
            log(
                f"K3/K4 level set {site}: {shape}, edge input {mode}, sender rows "
                f"{senders}, update_edges {update}, propagation {prop}: outputs "
                f"within rtol/atol {K3_RTOL}, gradients within {worst_rel:.3g} of "
                f"their largest value (tol {K4_TOL})"
            )
    for w in params:
        w.grad = None
    torch.cuda.empty_cache()
    return worst


def phase_v2_kernels(torch, model) -> list[dict]:
    """K7 and K8 against their plain versions at the shapes of the six
    GraphLAM GNN calls, at batch 4, and K2 on K8's ``d_pre``; each timed
    beside the v1 route's K1 + K3 and K4 on the same inputs. K7's
    aggregate, updated edges and ``pre``, and K8's ``d_pre``,
    ``d_recproj``, ``d_edge`` or the embedder's gradients and every weight
    gradient, each repeatable to the bit; then the whole v2 phase (node
    projections, K7; K8, K2 and the projections' backward) against the v1
    route's outputs and gradients. Returns the report of K7 (times summed
    over one AR step) and K8 (one training step)."""
    from neural_lam_tpu_torch.ops import fused_kernels as fk
    from neural_lam_tpu_torch.ops.segment import gather_senders
    from neural_lam_tpu_torch.ops.segment_kernels import (
        sender_gather,
        sender_scatter,
        sender_scatter_plain,
    )

    g, dev, d, b = model.graph, model.device, HIDDEN, BATCH
    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    n_grid, n_mesh = g.num_grid_nodes, g.num_mesh_nodes
    m2m = g.m2m[0]
    proc = list(model.processor.values())
    n_mid = PROC_LAYERS - 2
    # (site, net, edges, embedder, edge input, update_edges, d_new_edge
    # given, calls per AR step and per training step, senders, receivers);
    # the last m2m layer's updated edges get no gradient
    sites = [
        ("g2m", model.g2m_gnn, g.g2m, model.g2m_embedder, "raw", False, False, 1,
         n_grid, n_mesh),
        ("m2m layer 0", proc[0], m2m, model.m2m_embedder, "raw", True, True, 1,
         n_mesh, n_mesh),
        (f"m2m layers 1-{n_mid}", proc[1], m2m, None, "batched", True, True, n_mid,
         n_mesh, n_mesh),
        (f"m2m layer {PROC_LAYERS - 1}", proc[-1], m2m, None, "batched", True, False,
         1, n_mesh, n_mesh),
        ("m2g", model.m2g_gnn, g.m2g, model.m2g_embedder, "raw", False, False, 1,
         n_mesh, n_grid),
    ]
    k7 = dict(ms=0.0, pre_ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, ops_ms=0.0,
              bytes_ms=0.0, proj_ms=0.0, v1_ms=0.0)
    k8 = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, ops_ms=0.0, bytes_ms=0.0,
              k2_ms=0.0, k2_bound_ms=0.0, k4_ms=0.0)
    for site, net, ge, emb, mode, update, has_dne, calls, n_send, n_rec in sites:
        es = ge.edges
        n_e, rows, raw = es.num_edges, es.num_edges * b, mode == "raw"
        mlp = net.edge_mlp
        wts = fk._weights(mlp, emb)
        params = [w for w in wts if w is not None]
        w1s, w1r = wts[0][:, d : 2 * d], wts[0][:, 2 * d :]
        send, rec = randn(n_send, b, d), randn(n_rec, b, d)
        edge_in = ge.features if raw else randn(n_e, b, d)
        sp, rp = send @ w1s.T, rec @ w1r.T

        # ---- K7 -------------------------------------------------------------
        def run7(save_pre=False):
            return fk.fused_edge_v2_fwd(edge_in, sp, rp, es, wts, raw, update, save_pre)

        aggr, new_edge, pre = run7(True)
        want = fk._plain_v2(edge_in, sp, rp, es.senders, es.receivers, wts, raw, update)
        again = run7(True)
        torch.cuda.synchronize()
        outs = [(aggr, want[0]), (pre, want[2])] + ([(new_edge, want[1])] if update else [])
        for o, w in outs:
            torch.testing.assert_close(o, w, rtol=K3_RTOL, atol=K3_ATOL)
        if not all(torch.equal(x, y) for x, y in zip((aggr, new_edge, pre), again)
                   if x is not None):
            raise AssertionError(f"K7 {site}: two runs differ")
        abs7 = max(errors(o, w)[0] for o, w in outs)
        ms7, pre_ms7 = cuda_ms(run7), cuda_ms(lambda: run7(True))
        plain7 = cuda_ms(lambda: fk._plain_v2(
            edge_in, sp, rp, es.senders, es.receivers, wts, raw, update))
        proj_ms = cuda_ms(lambda: (send @ w1s.T, rec @ w1r.T))
        x_send = sender_gather(send, es.senders)
        k1_ms = cuda_ms(lambda: sender_gather(send, es.senders))
        k3_ms = cuda_ms(lambda: fk.fused_edge_fwd(
            edge_in, x_send, rec, es, wts, raw, update, False))
        moved7 = nbytes(edge_in, sp, rp, es.rowptr, es.senders, *params, aggr, new_edge)
        # multiply-adds (2 ops each) of the second layer per (edge, b) row,
        # of edge . W1e per row (batched) or per edge, with the embedder's
        # products per edge, and the receiver sums
        flops7 = 2 * rows * d * d + rows * d
        if raw:
            flops7 += n_e * (2 * edge_in.shape[1] * d + 2 * d * d * 2)
        else:
            flops7 += 2 * rows * d * d
        bound7, by7 = bound(moved7, flops7, tensor=True)
        simt7, _ = bound(moved7, flops7)
        log(
            f"K7 fused_edge_phase_v2 {site}: E {n_e}, senders {n_send}, receivers "
            f"{n_rec}, edge input {mode}, update_edges {update}; max abs err "
            f"{abs7:.3g} (aggregate, pre{', new_edge' if update else ''}; rtol/atol "
            f"{K3_RTOL}), repeatable; kernel {ms7:.4f} ms, with the pre output "
            f"{pre_ms7:.4f} ms, plain {plain7:.4f} ms, bound {bound7:.4f} ms ({by7}, "
            f"3xTF32: {moved7 / 1e6:.1f} MB, {flops7 / 1e9:.2f} GFLOP), SIMT bound "
            f"{simt7:.4f} ms; node projections "
            f"(cuBLAS) {proj_ms:.4f} ms; v1 at this site K1 {k1_ms:.4f} + K3 "
            f"{k3_ms:.4f} ms; {calls} call(s) per AR step"
        )
        k7["ms"] += calls * ms7
        k7["pre_ms"] += calls * pre_ms7
        k7["plain_ms"] += calls * plain7
        k7["bound_ms"] += calls * bound7
        k7["ops_ms" if by7 == "operations" else "bytes_ms"] += calls * bound7
        k7["proj_ms"] += calls * proj_ms
        k7["v1_ms"] += calls * (k1_ms + k3_ms)
        k7["err"] = max(k7["err"], abs7)

        # ---- K8, then K2 on d_pre ----------------------------------------------
        d_aggr = randn(n_rec, b, d)
        d_new = randn(n_e, b, d) if has_dne else None

        def run8():
            return fk.fused_edge_v2_bwd(d_aggr, d_new, pre, edge_in, es, wts, raw)

        def plain8():
            return fk._plain_v2_bwd(d_aggr, d_new, edge_in, sp, rp, es, wts, raw, update)

        got, want, again = run8(), plain8(), run8()
        torch.cuda.synchronize()
        names = ["d_pre", "d_recproj"] + ([] if raw else ["d_edge"])
        names += [f"weight grad {i}" for i, w in enumerate(wts) if w is not None]

        def flat(out):
            d_edge, d_pre, d_recproj, grads = out
            return [d_pre, d_recproj] + ([] if raw else [d_edge]) + [
                x for x in grads if x is not None]

        abs8 = rel8 = 0.0
        for name, o, w in zip(names, flat(got), flat(want)):
            a_err, r_err = errors(o, w)
            abs8, rel8 = max(abs8, a_err), max(rel8, r_err)
            if r_err > K4_TOL:
                raise AssertionError(
                    f"K8 {site} {name}: max err {a_err} is {r_err} of the largest "
                    f"value (tol {K4_TOL})"
                )
        if not all(torch.equal(x, y) for x, y in zip(flat(got), flat(again))):
            raise AssertionError(f"K8 {site}: two runs differ")
        d_pre = got[1]
        sums = sender_scatter(d_pre, es, n_send)
        _, rel2 = errors(sums, sender_scatter_plain(d_pre, es.senders, n_send))
        if rel2 > K2_TOL:
            raise AssertionError(f"K2 {site} on d_pre: max rel err {rel2} > {K2_TOL}")
        ms8, plain_ms8 = cuda_ms(run8), cuda_ms(plain8)
        ms2 = cuda_ms(lambda: sender_scatter(d_pre, es, n_send))
        bound2, _ = bound(nbytes(d_pre, es.send_perm, es.send_rowptr, sums), d_pre.numel())
        _, _, pre1 = fk.fused_edge_fwd(edge_in, x_send, rec, es, wts, raw, update, False,
                                       save_pre=True)
        k4_ms = cuda_ms(lambda: fk.fused_edge_bwd(
            d_aggr, d_new, pre1, edge_in, x_send, rec, es, wts, raw, False))
        moved8 = nbytes(pre, edge_in, d_aggr, d_new, es.rowptr, *params, *flat(got))
        # per (edge, b) row: z, d_h1, dW2 and, batched, d_edge and dW1e; per
        # edge otherwise: d_edge and dW1e, and for raw features the embedder
        # again, dEW2, d_a1 and dEW1; the receiver sums
        flops8 = 2 * rows * d * d * 3 + rows * d
        if raw:
            flops8 += n_e * (2 * d * d * 5 + 2 * edge_in.shape[1] * d * 2)
        elif mode == "batched":
            flops8 += 2 * rows * d * d * 2
        else:
            flops8 += 2 * n_e * d * d * 2
        bound8, by8 = bound(moved8, flops8, tensor=True)
        simt8, _ = bound(moved8, flops8)
        log(
            f"K8 fused_edge_phase_v2 backward {site}: d_new_edge "
            f"{'given' if has_dne else 'none'}; max abs err {abs8:.3g}, at most "
            f"{rel8:.3g} of a gradient's largest value (tol {K4_TOL}), repeatable; "
            f"kernel {ms8:.4f} ms, plain (autograd) {plain_ms8:.4f} ms, bound "
            f"{bound8:.4f} ms ({by8}, 3xTF32: {moved8 / 1e6:.1f} MB, {flops8 / 1e9:.2f} "
            f"GFLOP), SIMT bound {simt8:.4f} ms; K2 on d_pre {ms2:.4f} ms (max rel err {rel2:.3g}, bound "
            f"{bound2:.4f} ms, bytes); v1 at this site K4 {k4_ms:.4f} ms; {calls} "
            "call(s) per training step"
        )
        k8["ms"] += calls * ms8
        k8["plain_ms"] += calls * plain_ms8
        k8["bound_ms"] += calls * bound8
        k8["ops_ms" if by8 == "operations" else "bytes_ms"] += calls * bound8
        k8["k2_ms"] += calls * ms2
        k8["k2_bound_ms"] += calls * bound2
        k8["k4_ms"] += calls * k4_ms
        k8["err"] = max(k8["err"], abs8)
        del got, want, again, sums, x_send, pre1

        # ---- the whole v2 phase against the v1 route ---------------------------
        with torch.enable_grad():
            leaves = [send.clone().requires_grad_(True), rec.clone().requires_grad_(True)]
            if not raw:
                leaves.append(edge_in.clone().requires_grad_(True))

            def phase(v2):
                kw = dict(embedder=emb, edge_feats=edge_in if raw else None,
                          update_edges=update)
                edge = None if raw else leaves[2]
                if v2:
                    out = fk.fused_edge_phase_v2(mlp, edge, leaves[0], leaves[1], es, **kw)
                else:
                    x = gather_senders(es, leaves[0])
                    out = fk.fused_edge_phase(mlp, edge, x, leaves[1], es, **kw)
                total = (out[0] * d_aggr).sum()
                if has_dne:
                    total = total + (out[1] * d_new).sum()
                outs = [o.detach() for o in out if o is not None]
                return outs, torch.autograd.grad(total, leaves + params)

            (o2, g2), (o1, g1) = phase(True), phase(False)
        torch.cuda.synchronize()
        for o, w in zip(o2, o1):
            torch.testing.assert_close(o, w, rtol=K3_RTOL, atol=K3_ATOL)
        worst = max(errors(o, w)[1] for o, w in zip(g2, g1))
        if worst > K4_TOL:
            raise AssertionError(
                f"v2 phase {site}: a gradient is {worst} of its largest value off "
                f"the v1 route's (tol {K4_TOL})"
            )
        log(
            f"v2 phase {site} against the v1 route: outputs within rtol/atol "
            f"{K3_RTOL}, max abs diff {max(errors(o, w)[0] for o, w in zip(o2, o1)):.3g}; "
            f"gradients of the node rows, the edge input and every weight within "
            f"{worst:.3g} of their largest value (tol {K4_TOL})"
        )
        del leaves, o2, g2, o1, g1, pre, d_pre, aggr, new_edge
        torch.cuda.empty_cache()
    log(
        f"v2 per AR step: node projections {k7['proj_ms']:.4f} + K7 {k7['ms']:.4f} ms "
        f"(with the pre output {k7['pre_ms']:.4f}; bound {k7['bound_ms']:.4f}) against "
        f"K1 + K3 {k7['v1_ms']:.4f} ms on the same inputs; per training step K8 "
        f"{k8['ms']:.4f} + K2 {k8['k2_ms']:.4f} ms (bounds {k8['bound_ms']:.4f}, "
        f"{k8['k2_bound_ms']:.4f}) against K4 {k8['k4_ms']:.4f} + K2"
    )
    torch.cuda.empty_cache()
    return [
        dict(
            name="K7 fused_edge_phase_v2",
            route="cuda",
            source="neural_lam_tpu_torch/csrc/fused_edge_v2.cu",
            replaces="neural_lam_tpu/ops/pallas_fused.py:2143",
            launches=0,
            max_abs_err=k7["err"],
            ms=k7["ms"],
            plain_ms=k7["plain_ms"],
            bound_ms=k7["bound_ms"],
            bound_by="operations" if k7["ops_ms"] >= k7["bytes_ms"] else "bytes",
            library_ms=None,
        ),
        dict(
            name="K8 fused_edge_phase_v2 backward",
            route="cuda",
            source="neural_lam_tpu_torch/csrc/fused_edge_v2_bwd.cu",
            replaces="neural_lam_tpu/ops/pallas_fused.py:2293",
            launches=0,
            max_abs_err=k8["err"],
            ms=k8["ms"],
            plain_ms=k8["plain_ms"],
            bound_ms=k8["bound_ms"],
            bound_by="operations" if k8["ops_ms"] >= k8["bytes_ms"] else "bytes",
            library_ms=None,
        ),
    ]


def phase_v2_level_sets(torch, model) -> dict[str, float]:
    """The v2 phase (K7; K8 and K2 backward) at every mesh edge set of the
    hierarchical graph, through ``interaction.fused_edge_phase`` as
    HiLAMParallel calls it, in five modes: a shared edge input with the
    edge update, a batched one with and without it, unbatched sender rows
    beside batched receiver rows, and an edge MLP without LayerNorm.
    Outputs and every gradient against the plain version and against the
    v1 route, and a second run to the bit; returns the largest absolute
    errors of K7 (outputs) and K8 (gradients)."""
    from neural_lam_tpu_torch.ops import interaction
    from neural_lam_tpu_torch.ops.fused_kernels import (
        fused_edge_phase_v2,
        fused_edge_phase_v2_plain,
    )
    from neural_lam_tpu_torch.ops.mlp import make_mlp
    from neural_lam_tpu_torch.ops.segment_kernels import sender_gather

    g, dev, d, b = model.graph, model.device, HIDDEN, BATCH
    gen = torch.Generator(device=dev).manual_seed(4)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    sites = [
        (f"{kind}[{i}]", ge)
        for kind, sets in (("m2m", g.m2m), ("up", g.up), ("down", g.down))
        for i, ge in enumerate(sets)
    ]
    # (edge input, update_edges, sender rows, LayerNorm)
    modes = [("shared", True, "batched", True), ("batched", True, "batched", True),
             ("batched", False, "batched", True), ("shared", True, "unbatched", True),
             ("batched", True, "batched", False)]
    mlps = {
        True: model.mesh_init_gnns[0].edge_mlp,
        False: make_mlp([3 * d, d, d], layer_norm=False,
                        generator=torch.Generator().manual_seed(GATE_SEED)).to(dev),
    }
    worst = {"K7": 0.0, "K8": 0.0}
    for site, ge in sites:
        es = ge.edges
        n_e, n_rec, n_send = es.num_edges, es.num_rec, es.num_send
        for mode, update, senders, ln in modes:
            mlp = mlps[ln]
            params = list(mlp.parameters())
            send = randn(n_send, b, d) if senders == "batched" else randn(n_send, d)
            rec = randn(n_rec, b, d)
            edge = randn(n_e, d) if mode == "shared" else randn(n_e, b, d)
            w_aggr, w_edge = randn(n_rec, b, d), randn(n_e, b, d)
            leaves = [t.requires_grad_(True) for t in (send, rec, edge)] + params

            def loss(out):
                total = (out[0] * w_aggr).sum()
                return total + (out[1] * w_edge).sum() if update else total

            def run(route):
                with fused_v2(route):
                    out = interaction.fused_edge_phase(mlp, es, send, rec, edge,
                                                       update_edges=update)
                    return out, torch.autograd.grad(loss(out), leaves)

            before = (fused_edge_phase_v2.launches, sender_gather.launches)
            got, got_g = run("on")
            _, again_g = run("on")
            after = (fused_edge_phase_v2.launches, sender_gather.launches)
            if (after[0] - before[0], after[1] - before[1]) != (2, 0):
                raise AssertionError(f"v2 level set {site}: the phase did not run K7")
            v1, v1_g = run("off")
            send_b = send if send.dim() == 3 else send.unsqueeze(1).expand(-1, b, -1)
            w1 = mlp[0].weight
            want = fused_edge_phase_v2_plain(
                mlp, edge, send_b @ w1[:, d : 2 * d].T, rec @ w1[:, 2 * d :].T,
                es.senders, es.receivers, update_edges=update,
            )
            want_g = torch.autograd.grad(loss(want), leaves)
            torch.cuda.synchronize()
            n_out = 2 if update else 1
            for o, w in [*zip(got[:n_out], want), *zip(got[:n_out], v1)]:
                torch.testing.assert_close(o, w, rtol=K3_RTOL, atol=K3_ATOL)
                worst["K7"] = max(worst["K7"], errors(o.detach(), w.detach())[0])
            worst_rel = 0.0
            for o, w in [*zip(got_g, want_g), *zip(got_g, v1_g)]:
                a_err, r_err = errors(o, w)
                worst["K8"], worst_rel = max(worst["K8"], a_err), max(worst_rel, r_err)
                if r_err > K4_TOL:
                    raise AssertionError(
                        f"K8 {site} {mode}: max err {a_err} is {r_err} of the "
                        f"largest value (tol {K4_TOL})"
                    )
            if not all(torch.equal(x, y) for x, y in zip(got_g, again_g)):
                raise AssertionError(f"K8 {site} {mode}: two runs differ")
            log(
                f"K7/K8 level set {site}: E {n_e}, senders {n_send}, receivers "
                f"{n_rec}, edge input {mode}, sender rows {senders}, update_edges "
                f"{update}, LayerNorm {ln}: outputs within rtol/atol {K3_RTOL} of "
                f"the plain version and of the v1 route, gradients within "
                f"{worst_rel:.3g} of their largest value (tol {K4_TOL}), repeatable"
            )
    for w in params:
        w.grad = None
    torch.cuda.empty_cache()
    return worst


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


def phase_serve(torch, ds, model, card: str, ar_steps: int = 0) -> dict[str, int]:
    """One forecast request through run_forecasts (``AR_STEPS`` steps
    unless ``ar_steps`` says otherwise); returns each kernel's launches in
    this run, which must be ``expected_launches(model)`` per AR step."""
    ar_steps = ar_steps or AR_STEPS
    from torch import nn

    from neural_lam_tpu_torch.models import ARForecaster
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

    label = model_label(model)
    fc = TimedForecaster(ARForecaster(model, ds))
    out_dir = CACHE / "forecasts"
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    written = run_forecasts(
        fc, ds, split="test", ar_steps=ar_steps, batch_size=BATCH,
        n_samples=SERVE_BATCHES * BATCH, out_dir=out_dir, device=DEVICE,
    )
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}

    batches = len(fc.seconds)
    if written != SERVE_BATCHES * BATCH or batches != SERVE_BATCHES:
        raise AssertionError(f"served {written} forecasts in {batches} batches")
    for name, per_step in expected_launches(model, training=False).items():
        want = per_step * ar_steps * batches
        log(
            f"serve {label}: {name} launches {launches[name]} (want {per_step} x "
            f"{ar_steps} x {batches} = {want})"
        )
        if launches[name] != want:
            raise AssertionError(f"{name}: {launches[name]} launches, want {want}")
    files = sorted(out_dir.glob("forecast_test_*.npz"))
    if len(files) != written:
        raise AssertionError(f"{len(files)} forecast files for {written} forecasts")
    for path in files:
        with np.load(path) as f:
            pred = f["prediction"]
            if pred.shape != (ar_steps, ds.num_grid_points, N_STATE):
                raise AssertionError(f"{path.name}: shape {pred.shape}")
            if not np.isfinite(pred).all():
                raise AssertionError(f"{path.name}: non-finite values")
    shutil.rmtree(out_dir)

    fc_s = np.array(fc.seconds)
    gps = BATCH * ds.num_grid_points * ar_steps / fc_s.mean()
    log(
        f"serve {label} on {card}: {written} forecasts of {ar_steps} steps in "
        f"{batches} requests of {BATCH}; wall per request {wall / batches:.3f} s "
        f"(forecast, standardize, copy back and npz writes); forecast per "
        f"request {', '.join(f'{s:.4f}' for s in fc_s)} s "
        f"({1e3 * fc_s.mean() / ar_steps:.3f} ms per AR step); "
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


def make_trainer(model, ds, reload: bool = True):
    """The ``bench.build_trainer`` trainer around ``model`` with a new
    optimizer; ``reload`` loads the GraphLAM fixture's parameters afresh."""
    from neural_lam_tpu_torch.config import DatastoreSelection, NeuralLAMConfig
    from neural_lam_tpu_torch.convert_checkpoint import (
        load_jax_params_npz,
        params_from_jax,
    )
    from neural_lam_tpu_torch.models import ARForecaster
    from neural_lam_tpu_torch.trainer import Trainer, TrainingArgs

    if reload:
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


def train_gate_run(torch, trainer, batch: int, n_losses: int):
    """The training gate's run: from a fresh optimizer, the loss and the
    gradients of the bench batch, then ``n_losses - 1`` further AdamW
    steps on it. Returns the losses and the first step's gradients by
    state-dict name."""
    from neural_lam_tpu_torch.convert_checkpoint import grads_to_numpy

    data = [
        torch.from_numpy(a).to(trainer.device)
        for a in bench_batch(trainer.datastore, batch)
    ]
    trainer.optimizer = trainer.init_state()
    trainer.optimizer.zero_grad(set_to_none=True)
    loss = trainer._loss(*data)
    loss.backward()
    grads = grads_to_numpy(trainer.forecaster.predictor)
    trainer.optimizer.step()
    losses = [loss.item()]
    losses += [trainer.train_step(*data).item() for _ in range(n_losses - 1)]
    if not np.isfinite(losses).all():
        raise AssertionError("train gate: non-finite loss")
    return losses, grads


def check_gate_fixture(trainer, grid, lr) -> None:
    shape = trainer.datastore.grid_shape_state
    if tuple(grid) != (shape.x, shape.y) or lr != trainer.args.lr:
        raise AssertionError(
            f"train fixture is for grid {tuple(grid)} at lr {lr}, the trainer "
            f"has {(shape.x, shape.y)} at {trainer.args.lr}"
        )


def phase_train_gate(torch, trainer, fixture_path) -> dict:
    """Loss and gradients of the bench batch, then the losses of further
    AdamW steps, against the JAX package's fixture (made by
    ``tests/test_torch_train.py``). The trainer's model must hold the
    ``PRNGKey(0)`` parameters; they are updated in place."""
    with np.load(fixture_path) as fx:
        want_losses = fx["losses"].astype(np.float64)
        grid, batch, lr = fx["grid"], int(fx["batch"]), float(fx["lr"])
        want_grads = {k[len("grad/"):]: fx[k] for k in fx.files if k.startswith("grad/")}
    check_gate_fixture(trainer, grid, lr)
    losses, got_grads = train_gate_run(torch, trainer, batch, len(want_losses))

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
    if rels[0] > TRAIN_LOSS_RTOL or rels[1:].max() > TRAIN_TRAJ_RTOL:
        raise AssertionError("train gate: losses outside their tolerances")
    return dict(loss_rel=float(rels[0]), grad_rel=grad_rel, losses=losses)


def gate_rollout_inputs(ds, batch: int, steps: int = GATE_ROLLOUT_STEPS):
    """Inputs of the model gates' rollout, ``(init, forcing, boundary)``,
    drawn from ``np.random.default_rng(1)``."""
    n = ds.num_grid_points
    n_state = ds.get_num_data_vars("state")
    f_dim = ds.get_num_data_vars("forcing") * 3
    rng = np.random.default_rng(1)
    return (
        rng.normal(size=(batch, 2, n, n_state)).astype(np.float32),
        rng.normal(size=(batch, steps, n, f_dim)).astype(np.float32),
        rng.normal(size=(batch, steps, n, n_state)).astype(np.float32),
    )


def grad_sample_index(size: int) -> np.ndarray:
    """The flat entries of a gradient that a model gate's fixture keeps."""
    return np.linspace(0, size - 1, GATE_GRAD_SAMPLES).astype(np.int64)


def phase_model_gate(torch, name: str, model, ds, fixture_path) -> dict:
    """One of ``GATE_MODELS`` against the JAX package's fixture (made by
    ``tests/test_torch_hier.py``): the states after the first and the
    last step of a short rollout at every ``GATE_NODE_STRIDE``-th grid
    node, then the training loss, each gradient's largest entry and
    sampled entries, and the losses of further AdamW steps. ``model``
    must hold the seeded parameters; they are updated in place."""
    from neural_lam_tpu_torch.models import ARForecaster

    with np.load(fixture_path) as fx:
        want_states = fx["states"]
        want_losses = fx["losses"].astype(np.float64)
        grid, batch, lr = fx["grid"], int(fx["batch"]), float(fx["lr"])
        names = [str(n) for n in fx["grad_names"]]
        want_max, want_samples = fx["grad_max"], fx["grad_samples"]
        stride, steps = int(fx["node_stride"]), int(fx["rollout_steps"])
    trainer = make_trainer(model, ds, reload=False)
    check_gate_fixture(trainer, grid, lr)

    inputs = gate_rollout_inputs(ds, batch, steps)
    with torch.inference_mode():
        pred, _ = ARForecaster(model, ds)(
            *(torch.from_numpy(a).to(model.device) for a in inputs)
        )
    got_states = pred[:, [0, steps - 1]][:, :, ::stride].cpu().numpy()
    if got_states.shape != want_states.shape or not np.isfinite(got_states).all():
        raise AssertionError(
            f"{name} gate: states {got_states.shape} for {want_states.shape}, "
            "or non-finite"
        )
    scale = np.abs(want_states).mean()
    diff = np.abs(got_states - want_states)
    mean_rel = [float(diff[:, i].mean() / scale) for i in range(2)]
    max_rel = [float(diff[:, i].max() / scale) for i in range(2)]
    log(
        f"{name} gate: states after AR steps 1 and {steps} at every {stride}th "
        f"grid node: mean_rel {mean_rel[0]:.3e}, {mean_rel[1]:.3e} (limit "
        f"{GATE_STATE_MEAN_REL}), max_rel {max_rel[0]:.3e}, {max_rel[1]:.3e} "
        f"(limit {GATE_STATE_MAX_REL})"
    )
    if max(mean_rel) > GATE_STATE_MEAN_REL or max(max_rel) > GATE_STATE_MAX_REL:
        raise AssertionError(f"{name} gate: states outside their tolerances")

    losses, got_grads = train_gate_run(torch, trainer, batch, len(want_losses))
    if sorted(got_grads) != sorted(names):
        raise AssertionError(f"{name} gate: gradient names differ from the fixture")
    grad_rel, worst = 0.0, ""
    for key, w_max, w_samples in zip(names, want_max, want_samples):
        got = got_grads[key]
        if not np.isfinite(got).all():
            raise AssertionError(f"{name} gate: gradient {key} is not finite")
        scale = max(float(w_max), 1e-30)
        rel = max(
            abs(float(np.abs(got).max()) - float(w_max)),
            float(np.abs(got.ravel()[grad_sample_index(got.size)] - w_samples).max()),
        ) / scale
        if rel > grad_rel:
            grad_rel, worst = rel, key
        if rel > TRAIN_GRAD_TOL:
            raise AssertionError(
                f"{name} gate: gradient {key} is off by {rel:.3e} of its "
                f"largest value (tol {TRAIN_GRAD_TOL})"
            )
    rels = np.abs(np.array(losses) - want_losses) / np.abs(want_losses)
    log(
        f"{name} gate: loss {losses[0]:.8g} vs {want_losses[0]:.8g} (rel "
        f"{rels[0]:.3e}, tol {TRAIN_LOSS_RTOL}); {len(names)} gradients, "
        f"worst {grad_rel:.3e} of its largest value at {worst} (tol "
        f"{TRAIN_GRAD_TOL}); losses of {len(losses) - 1} further AdamW steps "
        f"{', '.join(f'{x:.8g}' for x in losses[1:])} vs "
        f"{', '.join(f'{x:.8g}' for x in want_losses[1:])} (rel up to "
        f"{rels[1:].max():.3e}, tol {TRAIN_TRAJ_RTOL})"
    )
    if rels[0] > TRAIN_LOSS_RTOL or rels[1:].max() > TRAIN_TRAJ_RTOL:
        raise AssertionError(f"{name} gate: losses outside their tolerances")
    return dict(
        state_mean_rel=max(mean_rel), state_max_rel=max(max_rel),
        loss_rel=float(rels[0]), grad_rel=grad_rel, losses=losses,
    )


def kernel_counters():
    """Each kernel's wrapper, which counts its launches in ``.launches``."""
    from neural_lam_tpu_torch.ops.fused_kernels import (
        fused_edge_bwd,
        fused_edge_phase,
        fused_edge_phase_v2,
        fused_edge_v2_bwd,
    )
    from neural_lam_tpu_torch.ops.segment_kernels import (
        receiver_expand,
        segment_sum,
        sender_gather,
        sender_scatter,
    )

    return {
        "K1 sender_gather": sender_gather,
        "K3 fused_edge_phase": fused_edge_phase,
        "K2 sender_scatter": sender_scatter,
        "K4 fused_edge_phase backward": fused_edge_bwd,
        "K5 segment_sum": segment_sum,
        "K6 receiver_expand": receiver_expand,
        "K7 fused_edge_phase_v2": fused_edge_phase_v2,
        "K8 fused_edge_phase_v2 backward": fused_edge_v2_bwd,
    }


def phase_train(torch, trainer, card: str) -> dict[str, int]:
    """Training steps through ``Trainer.train_step`` on the bench batch;
    returns each kernel's launches in this run, which must be
    ``expected_launches(model, training=True)`` per step."""
    ds = trainer.datastore
    model = trainer.forecaster.predictor
    label = model_label(model)
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
    for name, per_step in expected_launches(model, training=True).items():
        want = per_step * steps
        log(
            f"train {label}: {name} launches {launches[name]} (want {per_step} "
            f"x {steps} = {want})"
        )
        if launches[name] != want:
            raise AssertionError(f"{name}: {launches[name]} launches, want {want}")
    log(f"train {label}: loss per step " + ", ".join(f"{x:.6f}" for x in losses))
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError("train: losses are not finite and falling")
    step_ms = marks[0].elapsed_time(marks[-1]) / TRAIN_ITERS
    gps = BATCH * ds.num_grid_points / (step_ms / 1e3)
    log(
        f"train {label} on {card}: {steps} steps of batch {BATCH}, ar_steps 1, "
        f"float32 (TF32 off); step time {step_ms:.3f} ms (the last {TRAIN_ITERS} "
        f"steps queued back to back: {', '.join(f'{t:.2f}' for t in times)}); "
        f"{gps:,.0f} training grid-points/s; peak device memory "
        f"{peak / 2**30:.2f} GiB"
    )
    return launches


def add_launches(total: dict[str, int], launches: dict[str, int], what: str) -> None:
    for name, count in launches.items():
        total[name] = total.get(name, 0) + count
    log(f"launches {what}: " + ", ".join(f"{k} {v}" for k, v in launches.items()))


def drive_gate_model(torch, name: str, gate_ds, serve_ds, card: str, total,
                     v2_gate: bool = False) -> None:
    """Gate, serve and train one of ``GATE_MODELS`` at full width, adding
    its launches on the two main paths to ``total``; ``v2_gate`` runs the
    gate once more on the v2 route."""
    t0 = time.perf_counter()
    model = build_model(torch, name, gate_ds)
    g = model.graph
    log(
        f"{name}: {type(model).__name__}(hidden_layers={model.hidden_layers}) on "
        f"mesh levels {list(g.level_mesh_sizes)}, m2m edges "
        f"{[e.edges.num_edges for e in g.m2m]}, up "
        f"{[e.edges.num_edges for e in g.up]}, down "
        f"{[e.edges.num_edges for e in g.down]}, g2m {g.g2m.edges.num_edges}, "
        f"m2g {g.m2g.edges.num_edges}; {gnn_applications(model)} GNN "
        f"applications per step; "
        f"{sum(p.numel() for p in model.parameters()):,} parameters "
        f"({time.perf_counter() - t0:.1f} s)"
    )
    phase_model_gate(torch, name, model, gate_ds, gate_fixture(name))
    if v2_gate:
        load_seeded(torch, model)  # the gate trained the model in place
        with fused_v2("on"):
            log(f"{name} gate on the v2 route ({FUSED_V2}=on):")
            phase_model_gate(torch, name, model, gate_ds, gate_fixture(name))
    load_seeded(torch, model)
    add_launches(total, phase_serve(torch, serve_ds, model, card), f"{name} serve")
    trainer = make_trainer(model, gate_ds, reload=False)
    add_launches(total, phase_train(torch, trainer, card), f"{name} train")
    del trainer, model
    torch.cuda.empty_cache()


def build_kernels() -> None:
    """Build every kernel from the checkout's sources and print the
    compiler's register, shared-memory and spill report of each."""
    from neural_lam_tpu_torch.ops import kernel_build

    t0 = time.perf_counter()
    kernel_build.build()
    log(
        f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(k + '.cu' for k in kernel_build.KERNELS)}; nvcc for sm_90a, "
        "one process per source)"
    )
    for name in kernel_build.KERNELS:
        ptxas = kernel_build.build_log(name).splitlines()
        kernels = [line.split("'")[1] for line in ptxas if "Compiling entry" in line]
        used = [line.split(":", 1)[1].strip() for line in ptxas if "registers" in line]
        spills = [line.strip() for line in ptxas if "spill" in line]
        for i, k in enumerate(kernels):
            log(f"  {name} {k}: {used[i] if i < len(used) else ''}; "
                f"{spills[i] if i < len(spills) else ''}")


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
        "TF32 off (matmul and cuDNN)"
    )

    build_kernels()

    parent = None
    if len(sys.argv) > 2 and sys.argv[1] == "--parent":
        parent = parent_kernels(torch, Path(sys.argv[2]).resolve())
        log(f"parent kernels (K3, K4) built from {sys.argv[2]}")

    CACHE.mkdir(exist_ok=True)
    gate_ds, serve_ds, model, forecaster = build_meps(torch)
    hi_lam = build_model(torch, "hi_lam", gate_ds)
    with torch.no_grad():
        report = phase_kernels(torch, model, parent)
        phase_probe(torch, model)
        report += phase_v2_kernels(torch, model)
        report += phase_segment_kernels(torch, model.graph, hi_lam.graph)
    with torch.no_grad():
        phase_host_cost(torch, hi_lam, parent)
    level_errs = phase_level_sets(torch, hi_lam)
    for key, err in phase_v2_level_sets(torch, hi_lam).items():
        level_errs[key] = max(level_errs.get(key, 0.0), err)
    del hi_lam
    for entry in report:
        err = level_errs.get(entry["name"][:2], 0.0)
        entry["max_abs_err"] = max(entry["max_abs_err"], err)

    # each main path is driven with the counters at 0 just before it; the
    # v2 route (K7; K8 and K2 backward) with NEURAL_LAM_TPU_FUSED_V2=on set
    # around the whole phase
    total: dict[str, int] = {}
    phase_gate(torch, gate_ds, forecaster)
    with fused_v2("on"):
        log(f"accuracy gate on the v2 route ({FUSED_V2}=on):")
        phase_gate(torch, gate_ds, forecaster)
    add_launches(total, phase_serve(torch, serve_ds, model, card), "graph_lam serve")
    with fused_v2("on"):
        add_launches(
            total, phase_serve(torch, serve_ds, model, card), "graph_lam v2 serve"
        )
    phase_train_gate(torch, make_trainer(model, gate_ds), TRAIN_FIXTURE)
    with fused_v2("on"):
        log(f"training gate on the v2 route ({FUSED_V2}=on):")
        phase_train_gate(torch, make_trainer(model, gate_ds), TRAIN_FIXTURE)
    add_launches(
        total, phase_train(torch, make_trainer(model, gate_ds), card), "graph_lam train"
    )
    with fused_v2("on"):
        add_launches(
            total, phase_train(torch, make_trainer(model, gate_ds), card),
            "graph_lam v2 train",
        )
    del model, forecaster
    torch.cuda.empty_cache()
    for name in GATE_MODELS:
        drive_gate_model(
            torch, name, gate_ds, serve_ds, card, total,
            v2_gate=name == "hi_lam_parallel",
        )
    # the per-chunk edge MLPs on the unfused operations, on the level sets
    chunked = build_model(
        torch, "hi_lam_parallel", gate_ds, hidden_layers=2, processor_layers=1
    )
    add_launches(
        total, phase_serve(torch, serve_ds, chunked, card, ar_steps=2),
        "hi_lam_parallel(hidden_layers=2) serve",
    )
    del chunked
    for entry in report:
        entry["launches"] = total[entry["name"]]
        if entry["launches"] <= 0:
            raise AssertionError(f"{entry['name']}: no launch on any main path")

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
