#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``neural_lam_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--parent DIR]

``python -m torch.distributed.run --nproc_per_node=N chip_smoke.py
--dp-cards`` runs only GraphLAM's captured data-parallel step over the
N cards of a machine (:func:`dp_cards_main`).

``--parent DIR`` names a checkout of the parent commit, which has the
current C interface of K1, K2, K3, K4, K7 and K8: their sources are built
beside the current ones and timed on the same inputs in the same call, in
float32 and in every bf16 instantiation (the ``bf16`` and ``cache pre``
kernel lines too), and K4 is split by piece beside the parent's; the
node-MLP route of that commit (K3 with its node epilogue, the node
backward) is timed by that commit's own ``profile_forecast.py
--aggr-kernels``, run in ``DIR`` before and after the ``fused aggr`` kernel
lines.

It builds the port's eleven CUDA kernel sources (with the bf16 variants of
K1-K4, K7 and K8, K4 recomputing ``pre``, and the node-MLP route's node
update and node backward) from
``neural_lam_tpu_torch/csrc``
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
   tensor cores (3xTF32) and on the SIMT units; K4 split by piece (main
   kernel, edge pass or rows pass, receiver slice, reduces) with each
   piece's bound, and its receiver slice alone against the two ``torch``
   products it replaced; and then in the probe of
   ``phase_probe`` (uniform in-degree, LayerNorm off, occupancy). All six kernels are also held against
   their plain versions at each of the ten mesh edge sets of the
   hierarchical graph (from 51,520 edges into 6,561 receivers down to 40
   edges into 9; in-degrees of exactly 9 on the up sets and 1 on the
   down sets), K3 and K4 in each mode the hierarchical models use.
   K7 and K8 likewise: at the six calls against their plain versions
   (K7's aggregate, updated edges and ``pre``; K8's ``d_pre``,
   ``d_recproj``, edge and every weight gradient; the same bits on a
   second run), with K2 on K8's ``d_pre``, each beside its bounds; per
   site the two routes on the same inputs (edges per hoisted row; v1 =
   K1 + K3 forward, K4 + K2 backward; v2 = the node projections + K7
   forward, K8 + K2 + the projections' backward), and the whole v2 phase
   against the v1 route; at the ten level sets in every edge mode (the
   per-section entry, and the in-kernel embedder), against the plain
   version and the v1 route, with LayerNorm off in one mode.
2. Accuracy gate: a 19-step batch-1 rollout with the JAX package's
   ``PRNGKey(0)`` parameters (``tests/fixtures/accuracy/
   graph_lam_meps_params_seed0.npz``) against the committed exact-f32
   rollout ``tests/fixtures/accuracy/rollout19_f32.npz``, with the
   metrics and thresholds of ``scripts/accuracy_probe.py``, through the
   captured forecast (``utils.cuda_graph.CapturedFunction``).
3. Serving: ``predict.run_forecasts`` over a MEPS-size dummy test split,
   one batch of 4 samples at 19 AR steps, its forecast a CUDA graph
   (captured by the request's first call after one eager warm-up call).
   Every kernel's launch counter is set to 0 just before and must read
   twice its count per AR step after (the warm-up and the capture); the
   graph's kernel nodes hold once that count, by kernel name. Then the
   eager forecast against the captured one on the same batch and weights
   (1e-6 of the largest entry; the count of entries with the same bits),
   each one's time per AR step beside the device's busy time.
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

5b. Training through the captured step (``train graph`` lines):
   ``Trainer.make_train_step()``, one CUDA graph per step, from the
   weights and on the batch of phase 5, 2 warm-up and 10 timed calls.
   The 12 losses against the eager step's (1e-6 relative, and how many
   are the same bits), the step time against the eager step's and
   against the device time of a replay's kernels, the host's time to
   enqueue a replay, and the launches: the wrappers count the first
   call's eager warm-up steps and the capture, and nothing after it; the
   graph's kernel nodes give one replay's, by kernel name. Then the
   training gate once more through the captured step, on both routes.

After GraphLAM's route lines (below), the reduced-precision path (the
``bf16`` lines): the bf16 variants
of K1-K4, K7 and K8 at the six GraphLAM sites in each instantiation (bf16 rows; bf16
operands on bf16 streams, with bf16 and ``high``'s float32 outputs, and
on float32 streams) against their plain versions, within ``BF16_TOL`` of
each output's largest entry, K1 bit for bit, each beside the float32
kernel's time in the same call, its bound at the dense bf16 rate and, for
K1 and K2, ``index_select`` and ``index_add_`` (K1 and K2 also by device
time, :func:`bf16_row_kernels`); GraphLAM trained under
``TrainingArgs(precision="bf16")`` from the training gate's weights on its
batch (the first loss and every gradient against the exact-f32 fixture,
12 eager and 12 captured steps with the same bits, float32 master
parameters and AdamW state, grid-points/s, device busy and peak memory
beside the float32 captured step's); 2 steps each of
``GraphLAM(hidden_layers=2)``, HiLAM and ``NEURAL_LAM_TPU_BF16_KERNELS=off``
and 1 each under ``NEURAL_LAM_TPU_MATMUL_PRECISION=high`` and
``high-kernels``; and ``scripts/accuracy_probe.py``'s bf16 check, the
19-step rollout with bf16 compute copies of the gate's weights against
``rollout19_f32.npz``; the training (without the unfused model and HiLAM)
and the rollout once more on the v2 route, where K7 and K8 run their bf16
instantiations. Then ``NEURAL_LAM_TPU_CACHE_PRE`` (the ``cache pre``
lines): K3 writing a bf16 ``pre``, K4 reading it and K4 recomputing
``pre`` at the six GraphLAM sites of a training step, each against its
plain version (and the recomputing K4 against K4 from K3's float32
``pre``, within 1e-6 of each gradient's largest entry), each beside the
kernel it stands in for; and GraphLAM's captured training step under
``on``, ``bf16`` and ``off`` against the training fixture (``bf16`` at
the bf16 bounds), with its time, peak memory and launches. Then
``NEURAL_LAM_TPU_FUSED_AGGR`` (the ``fused aggr`` lines): the node update
after K3 and the node backward at the six sites in three precisions (beside
K3 plus the node tail with ``torch``) and at HiLAM's ten level sets, each
against its plain version; under ``on`` the
accuracy gate, GraphLAM's request and training steps (captured against
eager), the training gate, bf16 training and the bf16 rollout, HiLAM's
gate, request and captured step; and GraphLAM's captured step under
``off`` and ``on`` in one call. Then data parallelism (the ``dp`` lines,
``phase_dp``): GraphLAM's captured step without a process group, then in
an NCCL group of one rank in this process under ZeRO-1 and under
``flat_opt`` (the training gate through it, captured against eager bit
for bit, step time, device busy, kernel nodes a replay and peak memory
beside the step without a group), and two gloo ranks on this one card,
each its own process (``--dp-rank``) with a deadline, at 2 samples each:
their losses and mean gradients against the one-rank run, and the merged
``evaluate`` against one process's. Then GraphLAM's
served AR step and training step on both routes, each as its kernels'
device time beside the host's time to enqueue it; and the shapes the
fused kernels do not take (``GraphLAM(hidden_dim=32)`` serving and
training, ``apply_interaction_net`` at batch 33), which route to the
unfused operations and agree with the same calls on the CPU; and one
epoch of ``Trainer.fit`` on a MEPS-size dummy store (8 training batches
of 4 through the captured step, fed by ``device_prefetch``; validation
on 2 batches at 3 AR steps with a watched metric), whose history record
is printed; and the user's workflow through the entry points (the
``cli`` lines, ``phase_cli``): on a MEPS-size ``mdp`` zarr store written
here, ``create_graph``, ``train_model`` for 2 epochs at full width, a
resume with ``--load --restore_opt`` for a third, ``--eval test`` at 19
AR steps and ``predict`` of 4 forecasts, each stage timed; a forecast is
held to the checkpoint's rollout on the CPU, and the phase's K1-K4
launches join the ``kernels`` line; and a user's MEPS workflow on a
MEPS-size npy-files store written here (the ``npy`` lines,
``phase_npy_workflow``): ``compute_standardization_stats`` against a
float64 recomputation, ``create_graph`` and ``validate_graph``, 2 epochs
with validation, ``--eval test`` at 19 AR steps, ``predict``, and the
captured validation step and test-evaluation batch against eager.
Validation, ``--eval`` and every forecast replay CUDA graphs; their
replays' launches are counted from the graphs' kernel nodes.

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
7. Serving and training as in 3, 5 and 5b, with the launch counts
   derived from the number of mesh levels and processor layers, then the
   model gate's training part once more through the captured step.

``HiLAMParallel``'s gate runs once more on the v2 route (its per-section
``fused_edge_phase`` entry).

Last, ``HiLAMParallel(hidden_layers=2)`` at one processor layer serves
two AR steps, so that K5 and K6 also run on the level sets in a model;
then the report: a ``{"kernels": [...]}`` line and the
``{"ok": true, "device": ...}`` line.

Parity is float32 outside the ``bf16`` lines: TF32 is off for PyTorch's
matmuls and for cuDNN, and K3, K4, K7 and K8 run their products on the
tensor cores with the 3xTF32 split, at float32 accuracy. The
script needs one CUDA device and exits non-zero without one, and outside
a checkout of the repository. Generated data, the graphs and the
forecasts go under ``.smoke_cache/`` in the checkout.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

STARTED = time.perf_counter()
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
# float32 outside the tensor cores, and dense TF32 on the tensor cores. K3,
# K4, K7 and K8 run their float32 products on the tensor cores at float32
# accuracy as three TF32 products each (3xTF32), so their operations bound
# is 3 x FLOP / TF32_FLOP_PER_S; the SIMT bound, FLOP / FP32_FLOP_PER_S, is
# printed beside it.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
# dense bf16 on the tensor cores: the operations bound of the bf16
# variants of K3 and K4 (whose products take bf16 operands)
BF16_FLOP_PER_S = 989e12

# Tolerances against the plain versions on the same card, float32 on both
# sides (3xTF32 in K3, K4, K7 and K8 rounds like another summation order).
# K1 is a copy: bit-identical. K3 differs from the plain version only in rounding
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
# K4's receiver slice (3xTF32) against the two float32 torch products, of
# each output's largest entry
RECEIVER_TOL = 2e-5
K4_RECEIVER_SLICE = "K4 receiver slice"
# Training against the JAX package's float32 run on a CPU: the loss is a
# mean over 4.3e6 entries and each gradient a sum over as many paths, in
# another order on the card; Adam then amplifies rounding where a gradient
# is near zero, so the later losses get a wider bound.
TRAIN_LOSS_RTOL = 2e-5
TRAIN_GRAD_TOL = 2e-4
TRAIN_TRAJ_RTOL = 1e-4
TRAIN_LR = 1e-3
TRAIN_WARMUP, TRAIN_ITERS = 2, 10  # bench.py:31
# The captured step replays the kernels of the eager step on the same
# values: its losses agree with the eager step's to float32 rounding
GRAPH_LOSS_RTOL = 1e-6
# Each kernel's entry point in its CUDA source: one launch of it per
# launch of its wrapper. A graph's replays do not call the wrappers, so a
# graph's kernel nodes, whose names are mangled
# ("...16gather_rows_vec4EPK6float4..."), count their launches by these.
# The variants of K1-K4, K7 and K8 are template instantiations of one entry
# point, told apart by their mangled template arguments: the element type
# of K1 (f, 13__nv_bfloat16), K2's input word (Bf16x4, __nv_bfloat16 for
# bf16 rows), K3's <mode, bf16 operands, bf16 pre, stream type>, K4's main
# kernel's <mode, pre: 0 float32 | 1 bf16 | 2 recomputed, stream type>
# (fused_edge_bwd_main_bf with bf16 operands), K7's <mode, bf16 operands,
# stream type>, K8's main kernel's <batched, bf16 operands, stream type>
# (its BF instantiations run K4's BF chain inside K8's own kernel, so the
# names stay apart) and the node-MLP
# route's node update and node backward <bf16 operands, stream type>. K4's
# receiver slice, launched by every K4 entry, counts whatever its row type.
BF16_T = "13__nv_bfloat16"
END = "(?![a-z0-9_])"  # the name ends here
KERNEL_SYMBOLS = {
    name: re.compile(rf"(?<![A-Za-z_]){pattern}")
    for name, pattern in (
        ("K1 sender_gather", "gather_rows_(?:vec4|scalar)IfE"),
        ("K3 fused_edge_phase", r"fused_edge_fwdILi\dELb0ELb0EfE"),
        ("K2 sender_scatter", r"scatter_rowsI(?!\w*(?:Bf16x4|__nv_bfloat16))"),
        ("K4 fused_edge_phase backward", r"fused_edge_bwd_mainILi\dELi0EfE"),
        ("K5 segment_sum", f"segment_sum_rows{END}"),
        ("K6 receiver_expand", f"expand_rows{END}"),
        ("K7 fused_edge_phase_v2", r"fused_edge_v2_fwdILi\dELb0E"),
        ("K8 fused_edge_phase_v2 backward", r"fused_edge_v2_bwd_mainILb\dELb0E"),
        ("K1 sender_gather bf16", f"gather_rows_(?:vec4|scalar)I{BF16_T}E"),
        ("K2 sender_scatter bf16", r"scatter_rowsI\w*(?:Bf16x4|__nv_bfloat16)"),
        ("K3 fused_edge_phase bf16", rf"fused_edge_fwdILi\dELb1ELb0E{BF16_T}E"),
        ("K3 fused_edge_phase bf16 operands", r"fused_edge_fwdILi\dELb1ELb0EfE"),
        ("K4 fused_edge_phase backward bf16", rf"fused_edge_bwd_main_bfILi\dELi0E{BF16_T}E"),
        ("K4 fused_edge_phase backward bf16 operands", r"fused_edge_bwd_main_bfILi\dELi0EfE"),
        ("K7 fused_edge_phase_v2 bf16", rf"fused_edge_v2_fwdILi\dELb1E{BF16_T}E"),
        ("K7 fused_edge_phase_v2 bf16 operands", r"fused_edge_v2_fwdILi\dELb1EfE"),
        ("K8 fused_edge_phase_v2 backward bf16",
         rf"fused_edge_v2_bwd_mainILb\dELb1E{BF16_T}E"),
        ("K8 fused_edge_phase_v2 backward bf16 operands",
         r"fused_edge_v2_bwd_mainILb\dELb1EfE"),
        ("K3 fused_edge_phase bf16 pre", r"fused_edge_fwdILi\dELb\dELb1E"),
        ("K4 fused_edge_phase backward bf16 pre", r"fused_edge_bwd_main(?:_bf)?ILi\dELi1E"),
        ("K4 fused_edge_phase backward recompute", r"fused_edge_bwd_main(?:_bf)?ILi\dELi2E"),
        ("K3 node update", r"fused_node_fwdILb0EfE"),
        ("K3 node update bf16", rf"fused_node_fwdILb1E{BF16_T}E"),
        ("K3 node update bf16 operands", r"fused_node_fwdILb1EfE"),
        ("K4 node backward", r"fused_node_bwdILb0EfE"),
        ("K4 node backward bf16", rf"fused_node_bwdILb1E{BF16_T}E"),
        ("K4 node backward bf16 operands", r"fused_node_bwdILb1EfE"),
        (K4_RECEIVER_SLICE, r"fused_edge_bwd_receiverI"),
    )
}
# fit's store: 32 training samples at ar_steps 1 (len = n_timesteps - 3)
FIT_TIMESTEPS = 8 * BATCH + 3
# K6 is a copy: bit-identical. K5 sums up to ~40 O(1) edge rows per
# receiver in slot order where index_add_ adds with atomics in any order:
# rounding only, relative to the largest sum.
K6_TOL = 0.0
K5_TOL = 1e-5
# K7 and K8 differ from their plain versions in summation order only, as K3
# and K4 do, and are held to the same tolerances; so is the whole v2 phase
# against the v1 route (K1 + K3, K4 + K2), which sums sp[sender] formed once
# per node where v1 forms x_send . W1s per edge.

# The npy phase's MEPS npy-files store: 18 stored state features, one of
# them removed by the datastore; 2 ensemble members; analysis times for
# train, val and test; forecasts of 2 initial states, 19 AR steps and the
# one step of future forcing the last needs (WeatherDataset.__len__); the
# border frame of the boundary mask
NPY_STATE_STORED, NPY_REMOVED, NPY_MEMBERS = 18, (15,), 2
NPY_SPLITS = (2, 1, 1)
NPY_TIMESTEPS = 2 + AR_STEPS + 1
NPY_BORDER = 10
# compute_standardization_stats against the float64 recomputation: each
# array within this share of its largest entry (the sums are float64, the
# standardized differences float32, and diff_mean sits near 0)
NPY_STATS_TOL = 1e-5

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

# The bf16 variants of K1-K4 against their plain versions at the same
# dtypes: both multiply the same bf16 operands exactly and sum in float32
# in other orders, and a bf16 output rounds two nearly equal values, which
# can land one bf16 ulp (2^-8) apart. Every output and gradient within
# BF16_TOL of its largest entry (about two bf16 ulps), its mean error
# within BF16_MEAN_TOL of it; K1 is a copy, bit for bit.
BF16_TOL, BF16_MEAN_TOL = 8e-3, 1e-3
# Mixed-precision training against the exact-f32 JAX fixture: the first
# loss within 2e-2 relative, every gradient within 5e-2 of its largest
# entry (the JAX package's bf16 bound, tests/test_pallas_fused.py:287)
BF16_LOSS_RTOL, BF16_GRAD_TOL = 2e-2, 5e-2
# scripts/accuracy_probe.py's thresholds for the bf16 rollout (:38-40)
BF16_ROLLOUT_MEAN_REL, BF16_ROLLOUT_MAX_REL = 0.02, 0.8
# the variables of the reduced precisions, set around whole phases
MATMUL_PRECISION = "NEURAL_LAM_TPU_MATMUL_PRECISION"
BF16_KERNELS = "NEURAL_LAM_TPU_BF16_KERNELS"
# NEURAL_LAM_TPU_CACHE_PRE, set around whole phases; K4 recomputing pre
# against K4 from K3's float32 pre: the recompute's products are K3's up to
# the tensor-core instruction (mma.sync where K3 uses wgmma), so each
# gradient within 1e-6 of its largest entry
CACHE_PRE_ENV = "NEURAL_LAM_TPU_CACHE_PRE"
CACHE_PRE_RECOMPUTE_TOL = 1e-6
# NEURAL_LAM_TPU_FUSED_AGGR, set around whole phases: the node update after
# K3 and the node backward before K4. Held to their plain versions as K3 and
# K4 are (K3_RTOL/K3_ATOL, K4_TOL; in bf16 bf16_check).
FUSED_AGGR = "NEURAL_LAM_TPU_FUSED_AGGR"
# dp: two gloo ranks share the card, each with its own deadline; the merged
# evaluate sums the same per-sample float32 values in float64 in another
# grouping
DP_RANKS = 2
DP_RANK_TIMEOUT_S = 240
DP_EVAL_RTOL = 1e-6
# spatial partitioning: gloo ranks on the one card as S = 2, and their deadline
SPATIAL_RANKS = 2
SPATIAL_RANK_TIMEOUT_S = 300
STENCIL = "NEURAL_LAM_TPU_STENCIL"


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def env_set(name: str, value: Optional[str]):
    """``name=value`` (unset for None) for a whole phase, restored after:
    the route and the precision are read at every call, so a phase never
    changes them midway."""
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def fused_v2(mode: str):
    """``NEURAL_LAM_TPU_FUSED_V2=mode`` for a whole phase."""
    return env_set(FUSED_V2, mode)


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


# The library getters of the wrappers of K1 and K2
# (ops/segment_kernels.py), K3, K4, K7 and K8 (ops/fused_kernels.py) and
# the source each one loads: a parent build stands in for them through the
# current C interface, which the parent must share (parent_kernels). The
# node-MLP route's kernels are not among them: the parent's node-MLP route
# is timed by its own script (parent_aggr_run), as it was when the parent
# (34b9653) ran the node update inside K3.
PARENT_ROW_SOURCES = {"_gather_lib": "sender_gather", "_scatter_lib": "sender_scatter"}
PARENT_SOURCES = {
    "_fwd_lib": "fused_edge", "_fwd_bf16_lib": "fused_edge",
    "_bwd_lib": "fused_edge_bwd", "_bwd_bf16_lib": "fused_edge_bwd",
    "_bwd_recompute_lib": "fused_edge_bwd_recompute",
    "_v2_fwd_lib": "fused_edge_v2", "_v2_fwd_bf16_lib": "fused_edge_v2",
    "_v2_bwd_lib": "fused_edge_v2_bwd", "_v2_bwd_bf16_lib": "fused_edge_v2_bwd",
}


# K4's pieces by kernel name (the first pattern that matches): its main
# kernel, the edge input's share (edge pass or rows pass), the receiver
# slice, the workspace reduces, and where the receiver slice was torch
# (the parent commit), its cuBLAS products and casts
K4_PIECES = (
    ("main kernel", re.compile(r"fused_edge_bwd_main")),
    ("edge pass", re.compile(r"fused_edge_bwd_edge")),
    ("rows pass", re.compile(r"fused_edge_bwd_rows")),
    ("receiver slice", re.compile(r"fused_edge_bwd_receiver")),
    ("reduces", re.compile(r"reduce_workspace")),
    ("cuBLAS products", re.compile(r"gemm|gemv|cutlass|sm90_xmma|ampere", re.I)),
    ("casts and copies", re.compile(r"elementwise|copy|cast", re.I)),
)
# the tail: the pieces after the main kernel but the rows pass
K4_TAIL = ("edge pass", "receiver slice", "reduces", "cuBLAS products", "casts and copies",
           "other")


def kernel_events(torch, fn, reps: int) -> list:
    """The device records of the kernels that ``reps`` calls of ``fn``
    launch, under ``torch.profiler`` after 3 warm-up calls. In a long
    process the profiler now and then loses a kernel's record: a profile in
    which some kernel has not a multiple of ``reps`` records, or that has
    no record, is taken again, up to three times in all."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [evt for evt in prof.events()
                  if evt.device_type == torch.autograd.DeviceType.CUDA and "#" not in evt.name
                  and evt.device_time_total > 0]
        if events and all(n % reps == 0
                          for n in Counter(evt.name for evt in events).values()):
            break
    return events


def device_ms(torch, fn, reps: int = 20) -> float:
    """The device time in ms of one call of ``fn``, which launches each of
    its kernels once: each kernel's mean duration over its records from
    ``reps`` calls (:func:`kernel_events`), summed. Where the profiler lost
    some of a kernel's records the mean is over those it kept, and the loss
    is logged; no record at all, or more records than calls, raises. Unlike
    :func:`cuda_ms`'s events around back-to-back calls, it leaves out the
    time the device waits for the host to launch."""
    from collections import Counter

    events = kernel_events(torch, fn, reps)
    if not events:
        raise AssertionError("device_ms: the profiler kept no kernel record")
    counts = Counter(evt.name for evt in events)
    total = dict.fromkeys(counts, 0.0)
    for evt in events:
        total[evt.name] += evt.device_time_total
    for name, n in counts.items():
        if n > reps:
            raise AssertionError(f"device_ms: {name} has {n} records from {reps} calls; "
                               f"a call must launch each kernel once")
        if n < reps:
            log(f"device_ms: the profiler kept {n} of {reps} records of {name}; "
                f"its time is their mean")
    return sum(total[name] / counts[name] for name in counts) / 1e3


# the H100's L2 cache (the on-chip-measurement guide: 50 MB): calls whose
# bytes fit in it can run back to back out of it, faster than the HBM bound
L2_BYTES = 50 * 2**20
# how far under its HBM bound a device time may read before it counts as a
# faulty timing, where the call's bytes do not fit in the L2
UNDER_BOUND_TOL = 0.05


def check_device_time(what: str, ms: float, b_ms: float, moved: int) -> None:
    """Raise if the device time ``ms`` of a call that moves ``moved`` bytes
    reads more than ``UNDER_BOUND_TOL`` under its HBM bound ``b_ms`` though
    the bytes do not fit in the L2: the card cannot move them that fast, so
    the timing is at fault."""
    if moved > L2_BYTES and ms < (1 - UNDER_BOUND_TOL) * b_ms:
        raise AssertionError(f"{what}: device time {ms:.4f} ms is under the bound "
                             f"{b_ms:.4f} ms for {moved / 1e6:.1f} MB, more than the L2")


def k4_pieces(torch, fn, reps: int = 10) -> tuple[dict[str, float], float]:
    """Device ms per call of ``fn`` (a K4 call) by piece (:data:`K4_PIECES`,
    the rest ``other``) and its kernels per call, from ``reps`` calls under
    ``torch.profiler`` (:func:`kernel_events`); the kernels per call show a
    lost record that stayed (not a whole number, or 0)."""
    events = kernel_events(torch, fn, reps)
    sums = {name: 0.0 for name, _ in K4_PIECES}
    sums["other"] = 0.0
    for evt in events:
        piece = next((n for n, pat in K4_PIECES if pat.search(evt.name)), "other")
        sums[piece] += evt.device_time_total / 1e3 / reps
    return sums, len(events) / reps


def k4_tail_bounds(torch, es, n_rec: int, batch: int, raw: bool, edge_in, d_new, io,
                   flop_rate_bf16: bool) -> dict[str, tuple[float, str]]:
    """Least time (ms) and what sets it of K4's tail pieces at one call's
    shapes: the edge pass or rows pass (the edge input's share), the
    receiver slice (float32 products, 3xTF32 in every precision) and the
    reduces (their workspaces read once, the sums written once); products at
    3xTF32 or, with ``flop_rate_bf16``, at the bf16 rate."""
    from neural_lam_tpu_torch.ops import fused_kernels as fk

    d, n_e = HIDDEN, es.num_edges
    size = torch.tensor([], dtype=io).element_size()
    prod = bf16_bound if flop_rate_bf16 else (lambda b, f: bound(b, f, tensor=True))
    dne = 0 if d_new is None else d_new.numel() * size
    if raw or edge_in.dim() == 2:  # the edge pass over s (E, D)
        feat = edge_in.shape[1] if raw else 0
        moved = n_e * d * 4 + edge_in.numel() * size + dne + (0 if raw else n_e * d * size)
        flops = n_e * 2 * d * d * 2 + (n_e * (2 * d * d * 3 + 2 * feat * d * 2) if raw else 0)
        share = ("edge pass", prod(moved, flops))
        ws_edge = fk._edge_blocks(es.rowptr.device, n_e) * fk._EDGE_GROUPS * fk._WS_EDGE
    else:  # the rows pass over d_pre (E, B, D)
        rows = n_e * batch
        moved = rows * d * 4 + 2 * rows * d * size + dne
        share = ("rows pass", prod(moved, rows * 2 * d * d * 2))
        ws_edge = fk._rows_blocks(es.rowptr.device, rows) * fk._ROW_GROUPS * fk._MAT
    rec_rows = n_rec * batch
    receiver = bound(rec_rows * d * (4 + size + 4), rec_rows * 2 * d * d * 2, tensor=True)
    main_blocks = fk._bwd_grid(es.rowptr.device, n_rec, n_e, batch, False,
                               fk._CHUNK_ROWS_K4, fk._GROUPS)[0]
    ws = (main_blocks * fk._GROUPS * fk._WS_MAIN + ws_edge
          + fk._rows_blocks(es.rowptr.device, rec_rows) * fk._ROW_GROUPS * fk._MAT)
    reduces = bound(4 * (ws + fk._WS_MAIN + fk._WS_EDGE + fk._MAT), 0.0)
    return {share[0]: share[1], "receiver slice": receiver, "reduces": reduces}


def log_k4_split(torch, what: str, run_k4, parent, calls: int, bounds: dict,
                 acc: dict) -> None:
    """One K4 call split by piece (:func:`k4_pieces`), beside the parent
    commit's K4 on the same inputs where ``parent`` is given; adds ``calls``
    times each piece's ms (and the parent's) into ``acc``."""
    got, kernels = k4_pieces(torch, run_k4)
    old, old_kernels = ({}, 0.0)
    if parent is not None:
        with parent["use"]():
            old, old_kernels = k4_pieces(torch, run_k4)
    parts = []
    for name in ("main kernel", "edge pass", "rows pass", "receiver slice", "reduces",
                 "cuBLAS products", "casts and copies", "other"):
        ms, old_ms = got.get(name, 0.0), old.get(name, 0.0)
        if ms <= 0.0 and old_ms <= 0.0:
            continue
        text = f"{name} {ms:.4f}"
        if parent is not None:
            text += f" (parent {old_ms:.4f})"
        if name in bounds and ms > 0:
            b_ms, b_by = bounds[name]
            text += f" bound {b_ms:.4f} ({b_by}, {100 * b_ms / ms:.1f} % of it)"
        parts.append(text)
        acc[name] = acc.get(name, 0.0) + calls * ms
        acc[f"parent {name}"] = acc.get(f"parent {name}", 0.0) + calls * old_ms
        if name in bounds:
            acc[f"bound {name}"] = acc.get(f"bound {name}", 0.0) + calls * bounds[name][0]
    tail = sum(got.get(n, 0.0) for n in K4_TAIL)
    old_tail = sum(old.get(n, 0.0) for n in K4_TAIL)
    acc["tail"] = acc.get("tail", 0.0) + calls * tail
    acc["parent tail"] = acc.get("parent tail", 0.0) + calls * old_tail
    acc["kernels"] = acc.get("kernels", 0.0) + calls * kernels
    acc["parent kernels"] = acc.get("parent kernels", 0.0) + calls * old_kernels
    log(f"{what} split (torch.profiler, ms a call): " + ", ".join(parts)
        + f"; tail {tail:.4f}" + (f" (parent {old_tail:.4f})" if parent else "")
        + f"; {kernels:g} kernels a call, one launch of each piece"
        + (f" (parent {old_kernels:g})" if parent else ""))


def log_k4_tail(what: str, acc: dict, parent) -> None:
    """The per-training-step sums of :func:`log_k4_split`."""
    names = [n for n in ("main kernel", "edge pass", "rows pass", "receiver slice",
                         "reduces", "cuBLAS products", "casts and copies", "other")
             if acc.get(n, 0.0) > 0 or acc.get(f"parent {n}", 0.0) > 0]
    text = ", ".join(
        f"{n} {acc.get(n, 0.0):.4f}"
        + (f" (parent {acc.get(f'parent {n}', 0.0):.4f})" if parent else "")
        + (f" bound {acc[f'bound {n}']:.4f}" if f"bound {n}" in acc else "")
        for n in names)
    ratio = (f", {acc['parent tail'] / acc['tail']:.3f} x the parent's"
             if parent and acc.get("tail") else "")
    log(f"{what} per training step by piece (ms): {text}; tail (edge pass, receiver "
        f"slice, reduces) {acc.get('tail', 0.0):.4f}"
        + (f" against the parent's {acc.get('parent tail', 0.0):.4f}{ratio}" if parent else "")
        + f"; {acc.get('kernels', 0.0):.0f} kernels"
        + (f" (parent {acc.get('parent kernels', 0.0):.0f})" if parent else ""))


def same_k4_as_parent(parent, run_k4, per_edge: bool, what: str) -> tuple[int, float]:
    """K4's outputs against the parent commit's on the same inputs: its
    main kernel's (d_send, dW2, dW1s, db1, db2, dgamma, dbeta; and the rows
    pass's d_edge and dW1e for a batched edge input) the same bits, else
    AssertionError; the outputs that now come from other arithmetic (the
    edge pass's d_edge, dW1e and embedder gradients, and the receiver
    slice's d_rec and dW1r) within ``K4_TOL`` of each one's largest entry.
    Returns how many tensors matched bit for bit and the largest relative
    difference of the others (0 without a parent)."""
    if parent is None:
        return 0, 0.0
    d = HIDDEN

    def split(out):
        d_edge, d_send, d_rec, grads = out
        dw1 = grads[0]
        same = [d_send, dw1[:, d:2 * d], *[g for g in grads[1:6] if g is not None]]
        moved = [d_rec, dw1[:, 2 * d:], *[g for g in grads[6:] if g is not None]]
        share = [dw1[:, :d]] + ([] if d_edge is None else [d_edge])
        return (same, moved + share) if per_edge else (same + share, moved)

    got = split(run_k4())
    with parent["use"]():
        old = split(run_k4())
    import torch

    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got[0], old[0])):
        raise AssertionError(f"{what}: the main kernel's outputs are not the parent's bits")
    worst = 0.0
    for x, y in zip(got[1], old[1]):
        scale = max(y.float().abs().max().item(), 1e-30)
        worst = max(worst, (x.float() - y.float()).abs().max().item() / scale)
    if worst > K4_TOL:
        raise AssertionError(f"{what}: {worst:.3g} of the parent's largest entry off "
                             f"(tol {K4_TOL})")
    return len(got[0]), worst


def same_as_parent(parent, fn, what: str) -> int:
    """``fn()``'s outputs through the current kernels against the parent
    commit's (:func:`parent_kernels`) on the same inputs: every tensor of
    them the same bits, else AssertionError. Returns how many tensors were
    compared (0 without a parent)."""
    import torch

    if parent is None:
        return 0

    def flat(out):
        if isinstance(out, (tuple, list)):
            return [t for o in out for t in flat(o)]
        return [] if out is None else [out]

    got = flat(fn())
    with parent["use"]():
        old = flat(fn())
    torch.cuda.synchronize()
    if len(got) != len(old) or not all(torch.equal(x, y) for x, y in zip(got, old)):
        raise AssertionError(f"{what}: not the parent's bits")
    return len(got)


def start_parent_build(parent: Path) -> list:
    """Start ``nvcc`` on the parent checkout's sources of K1, K2, K3, K4,
    K7 and K8 (one process each, beside the current build);
    :func:`parent_kernels` waits for them."""
    from neural_lam_tpu_torch.ops import kernel_build

    csrc = parent / "neural_lam_tpu_torch" / "csrc"
    newest = max(f.stat().st_mtime for f in csrc.iterdir())
    procs = []
    for name in sorted(set(PARENT_SOURCES.values()) | set(PARENT_ROW_SOURCES.values())):
        out = kernel_build.BUILD_DIR / f"parent-{name}.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        if out.exists() and out.stat().st_mtime > newest:
            procs.append((name, out, None))  # built from these sources by an earlier run
            continue
        cmd = [kernel_build._nvcc(), *kernel_build.NVCC_FLAGS, "-o", str(out),
               str(csrc / f"{name}.cu")]
        procs.append((name, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return procs


def parent_kernels(torch, procs: list, parent_dir: Path) -> dict:
    """K1, K2, K3, K4, K7 and K8 of the parent commit of this change
    (34eca30, in the checkout ``parent_dir``), built by
    :func:`start_parent_build`, for a same-call comparison: a dict of six
    callables, each called like the current wrapper with the same inputs
    (``segment_kernels.sender_gather``, ``sender_scatter``,
    ``fused_kernels.fused_edge_fwd``, ``fused_edge_bwd``,
    ``fused_edge_v2_fwd``, ``fused_edge_v2_bwd``) and doing the same work;
    ``"use"``, a context manager under which every wrapper of the six
    (every precision and ``pre`` type) launches the parent's kernels: each
    library getter of :data:`PARENT_ROW_SOURCES` and :data:`PARENT_SOURCES`
    returns the parent library's entry of the same name as the current
    build's, with the current entry's argument types (the parent must have
    the current C interface); and ``"dir"``, the checkout, whose own script
    times its node-MLP route (:func:`parent_aggr_run`)."""
    import contextlib
    import ctypes
    import functools

    from neural_lam_tpu_torch.ops import fused_kernels as fk
    from neural_lam_tpu_torch.ops import segment_kernels as sk

    libs = {}
    for name, out, proc in procs:
        if proc is not None:
            text, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"parent {name}.cu did not build:\n{text}")
        libs[name] = ctypes.CDLL(str(out))

    def stand_in(current_getter, lib):
        @functools.cache
        def getter(*args):
            current = current_getter(*args)  # the current build's entry: name and interface
            fn = getattr(lib, current.__name__)
            fn.argtypes, fn.restype = current.argtypes, ctypes.c_int
            return fn

        return getter

    swaps = [(module, getter, stand_in(getattr(module, getter), libs[source]))
             for module, sources in ((sk, PARENT_ROW_SOURCES), (fk, PARENT_SOURCES))
             for getter, source in sources.items()]

    @contextlib.contextmanager
    def use():
        saved = [(module, getter, getattr(module, getter)) for module, getter, _ in swaps]
        for module, getter, fn in swaps:
            setattr(module, getter, fn)
        try:
            yield
        finally:
            for module, getter, fn in saved:
                setattr(module, getter, fn)

    def through(wrapper):
        def run(*args, **kw):
            with use():
                return wrapper(*args, **kw)

        return run

    return {
        "K1": through(sk.sender_gather),
        "K2": through(sk.sender_scatter),
        "K3": through(fk.fused_edge_fwd),
        "K4": through(fk.fused_edge_bwd),
        "K7": through(fk.fused_edge_v2_fwd),
        "K8": through(fk.fused_edge_v2_bwd),
        "use": use,
        "dir": parent_dir,
    }


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


def write_zarr_array(root: Path, name: str, values, dims, attrs=None, chunks=None) -> None:
    """One zarr v2 array under ``root/name`` as xarray writes it: JSON
    ``.zarray`` and ``.zattrs`` (``_ARRAY_DIMENSIONS``), C-order chunks,
    each zlib-compressed; partial edge chunks are padded to the chunk
    shape."""
    values = np.ascontiguousarray(values)
    adir = root / name
    adir.mkdir(parents=True)
    chunks = list(chunks or values.shape) if values.shape else [1]
    meta = {
        "zarr_format": 2, "shape": list(values.shape), "chunks": chunks,
        "dtype": values.dtype.str,
        "compressor": {"id": "zlib", "level": 1},
        "fill_value": None, "filters": None, "order": "C",
    }
    (adir / ".zarray").write_text(json.dumps(meta), encoding="utf-8")
    (adir / ".zattrs").write_text(
        json.dumps({"_ARRAY_DIMENSIONS": list(dims), **(attrs or {})}), encoding="utf-8"
    )
    n_chunks = [-(-s // c) for s, c in zip(values.shape, chunks)] or [1]
    for idx in np.ndindex(*n_chunks):
        if values.shape:
            chunk = values[tuple(slice(i * c, (i + 1) * c) for i, c in zip(idx, chunks))]
            chunk = np.pad(chunk, [(0, c - s) for c, s in zip(chunks, chunk.shape)])
            key = ".".join(str(i) for i in idx)
        else:
            chunk, key = values, "0"
        (adir / key).write_bytes(zlib.compress(chunk.tobytes(), 1))


def write_mdp_store(root: Path, nx: int, ny: int, splits=(35, 13, 25),
                    n_state: int = N_STATE, n_forcing: int = N_FORCING,
                    n_static: int = N_STATIC, seed: int = 0,
                    x_major: bool = False) -> Path:
    """An mllam-data-prep zarr store at ``root/mdp.datastore.zarr``, its
    datastore config ``mdp.datastore.yaml`` and a main ``config.yaml``
    selecting it (kind ``mdp``); returns the main config's path.

    ``nx`` x ``ny`` grid points 2.5 km apart, stacked y-major
    (``grid_index = y * nx + x``, mllam-data-prep's order) or x-major;
    ``n_state``, ``n_forcing`` and ``n_static`` features drawn from
    ``seed`` as smooth fields with noise; 3-hourly time steps in
    consecutive train/val/test splits of ``splits`` steps; state and
    forcing chunked by time step, so that a reader decompresses one step
    at a time; the statistics over the train split. The configs are
    JSON, which is YAML too. The datastore frames the grid with its
    default boundary of 30 points, so a grid needs more than 60 on a side
    to have an interior."""
    store = root / "mdp.datastore.zarr"
    store.mkdir(parents=True)
    (store / ".zgroup").write_text('{"zarr_format": 2}')
    rng = np.random.default_rng(seed)
    n_grid, n_time = nx * ny, sum(splits)
    if x_major:
        xs, ys = np.repeat(np.arange(nx), ny), np.tile(np.arange(ny), nx)
    else:
        xs, ys = np.tile(np.arange(nx), ny), np.repeat(np.arange(ny), nx)
    hours = 3 * np.arange(n_time, dtype=np.int64)

    def fields(n_feat, n_steps):
        # per feature a plane wave drifting in time, plus noise
        t = np.arange(n_steps, dtype=np.float32)[:, None, None]
        k = rng.uniform(0.5, 2.0, size=(2, n_feat)).astype(np.float32)
        phase = (k[0] * xs[:, None] / nx + k[1] * ys[:, None] / ny).astype(np.float32)
        out = np.sin(2 * np.pi * phase[None] + 0.3 * t)
        out += 0.1 * rng.standard_normal(out.shape, dtype=np.float32)
        return (out * rng.uniform(1, 10, n_feat) + rng.uniform(-5, 5, n_feat)).astype(
            np.float32)

    state, forcing = fields(n_state, n_time), fields(n_forcing, n_time)
    static = fields(n_static, 1)[0]
    tu = {"units": "hours since 1990-09-01 00:00:00"}
    write_zarr_array(store, "time", hours, ["time"], attrs=tu)
    write_zarr_array(store, "x", 2500.0 * xs, ["grid_index"])
    write_zarr_array(store, "y", 2500.0 * ys, ["grid_index"])
    write_zarr_array(store, "state", state, ["time", "grid_index", "state_feature"],
                     chunks=[1, n_grid, n_state])
    write_zarr_array(store, "forcing", forcing, ["time", "grid_index", "forcing_feature"],
                     chunks=[1, n_grid, n_forcing])
    write_zarr_array(store, "static", static, ["grid_index", "static_feature"])
    for cat, n in (("state", n_state), ("forcing", n_forcing), ("static", n_static)):
        write_zarr_array(store, f"{cat}_feature",
                         np.array([f"{cat}{i}" for i in range(n)], dtype="<U16"),
                         [f"{cat}_feature"])
        write_zarr_array(store, f"{cat}_feature_units", np.array(["unit"] * n, dtype="<U8"),
                         [f"{cat}_feature"])
        write_zarr_array(store, f"{cat}_feature_long_name",
                         np.array([f"{cat} variable {i}" for i in range(n)], dtype="<U24"),
                         [f"{cat}_feature"])
    ends = np.cumsum(splits)
    write_zarr_array(store, "splits", np.stack([hours[ends - splits], hours[ends - 1]], 1),
                     ["split_name", "split_part"], attrs=tu)
    write_zarr_array(store, "splits_split_name", np.array(["train", "val", "test"],
                     dtype="<U5"), ["split_name"])
    write_zarr_array(store, "splits_split_part", np.array(["start", "end"], dtype="<U5"),
                     ["split_part"])
    train = splits[0]
    for cat, vals in (("state", state[:train]), ("forcing", forcing[:train]),
                      ("static", static[None])):
        flat = vals.reshape(-1, vals.shape[-1]).astype(np.float64)
        write_zarr_array(store, f"{cat}__train__mean", flat.mean(0).astype(np.float32),
                         [f"{cat}_feature"])
        write_zarr_array(store, f"{cat}__train__std", flat.std(0).astype(np.float32),
                         [f"{cat}_feature"])
    diffs = np.diff(state[:train], axis=0).reshape(-1, n_state).astype(np.float64)
    write_zarr_array(store, "state__train__diff_mean", diffs.mean(0).astype(np.float32),
                     ["state_feature"])
    write_zarr_array(store, "state__train__diff_std", diffs.std(0).astype(np.float32),
                     ["state_feature"])
    (root / "mdp.datastore.yaml").write_text(
        json.dumps({"schema_version": "v0.5.0"}),
        encoding="utf-8")
    config = root / "config.yaml"
    config.write_text(json.dumps(
        {"datastore": {"kind": "mdp", "config_path": "mdp.datastore.yaml"}}),
        encoding="utf-8")
    return config


def write_npy_store(root: Path, nx: int, ny: int, splits=NPY_SPLITS,
                    members: int = NPY_MEMBERS, n_stored: int = NPY_STATE_STORED,
                    removed=NPY_REMOVED, timesteps: int = NPY_TIMESTEPS,
                    border: int = NPY_BORDER, seed: int = 0) -> Path:
    """A MEPS npy-files store (the layout ``neural_lam_tpu_torch.datastore.
    npyfilesmeps`` reads, the reference's: reference:
    neural_lam/datastore/npyfilesmeps/store.py:63-844) under ``root``, its
    ``data_config.yaml`` and a main ``config.yaml`` selecting it (kind
    ``npyfilesmeps``); returns the main config's path.

    ``grid_shape_state`` is ``[ny, nx]``, points 2.5 km apart. Per split,
    ``splits`` analysis times 12 hours apart, each with ``members``
    forecasts ``samples/<split>/nwp_<YYYYMMDDHH>_mbr<000>.npy`` of shape
    ``(timesteps, ny, nx, n_stored)`` float32, and its forcing files: the
    top-of-atmosphere flux ``(timesteps, ny, nx)`` and the open-water
    fraction ``(ny, nx)``. The state features ``removed`` are dropped by
    the datastore (``remove_state_features_with_index``). Each stored
    feature has its own magnitude (from 1 to 1e5, as MEPS's pressures,
    temperatures, winds and fluxes differ), mean and scale on a plane wave that
    drifts in time, a trend over the forecast and noise, a member offset
    and noise of its own per member. ``static/`` holds ``nwp_xy.npy``,
    ``surface_geopotential.npy`` and a ``border_mask.npy`` frame
    ``border`` points wide, and no statistics:
    ``compute_standardization_stats`` writes them."""
    rng = np.random.default_rng(seed)
    n_kept = n_stored - len(removed)
    yy, xx = np.meshgrid(np.arange(ny, dtype=np.float32), np.arange(nx, dtype=np.float32),
                         indexing="ij")
    k = rng.uniform(0.5, 2.0, size=(2, n_stored)).astype(np.float32)
    phase = 2 * np.pi * (k[0] * xx[..., None] / nx + k[1] * yy[..., None] / ny)
    sin_a, cos_a = np.sin(phase), np.cos(phase)  # (ny, nx, n_stored)
    magnitude = 10.0 ** rng.integers(0, 6, n_stored)
    mean = (rng.uniform(-1, 1, n_stored) * magnitude).astype(np.float32)
    scale = (rng.uniform(0.01, 0.3, n_stored) * magnitude).astype(np.float32)
    trend = rng.uniform(-0.2, 0.2, n_stored).astype(np.float32)
    t = np.arange(timesteps, dtype=np.float32)
    c, s_ = np.cos(0.3 * t), np.sin(0.3 * t)
    base = datetime.datetime(2022, 4, 1)
    for split, n_times in zip(("train", "val", "test"), splits):
        samples = root / "samples" / split
        samples.mkdir(parents=True)
        for i in range(n_times):
            atime = base + datetime.timedelta(hours=12 * i + 240 * ("train", "val",
                                                                    "test").index(split))
            tstr = atime.strftime("%Y%m%d%H")
            for member in range(members):
                out = rng.standard_normal((timesteps, ny, nx, n_stored), dtype=np.float32)
                out *= 0.3
                out += sin_a[None] * c[:, None, None, None]
                out += cos_a[None] * s_[:, None, None, None]
                out += (trend[None] * t[:, None] + 0.1 * member)[:, None, None, :]
                out *= scale
                out += mean
                np.save(samples / f"nwp_{tstr}_mbr{member:03d}.npy", out)
            flux = 400 * (1 + np.sin(0.26 * t[:, None, None] + 2 * np.pi * xx / nx))
            np.save(samples / f"nwp_toa_downwelling_shortwave_flux_{tstr}.npy",
                    flux.astype(np.float32))
            np.save(samples / f"wtr_{tstr}.npy",
                    rng.uniform(0, 1, size=(ny, nx)).astype(np.float32))
    static = root / "static"
    static.mkdir()
    np.save(static / "nwp_xy.npy", 2500.0 * np.stack([xx, yy]).astype(np.float32))
    np.save(static / "surface_geopotential.npy",
            (1e4 * (1 + np.sin(2 * np.pi * yy / ny))).astype(np.float32))
    frame = np.ones((ny, nx), np.float32)
    frame[border:-border, border:-border] = 0
    np.save(static / "border_mask.npy", frame)
    data_config = {
        "dataset": {
            "name": "meps_smoke",
            "var_names": [f"var{i}" for i in range(n_kept)],
            "var_units": ["unit"] * n_kept,
            "var_longnames": [f"variable {i}" for i in range(n_kept)],
            "num_forcing_features": 1,
            "num_timesteps": timesteps,
            "step_length": 3,
            "num_ensemble_members": members,
            "remove_state_features_with_index": list(removed),
        },
        "grid_shape_state": [ny, nx],
        "projection": {"class_name": "LambertConformal",
                       "kwargs": {"central_longitude": 15.0}},
    }
    (root / "data_config.yaml").write_text(json.dumps(data_config), encoding="utf-8")
    config = root / "config.yaml"
    config.write_text(json.dumps(
        {"datastore": {"kind": "npyfilesmeps", "config_path": "data_config.yaml"}}),
        encoding="utf-8")
    return config


def npy_stats_float64(root: Path, removed=NPY_REMOVED) -> dict[str, np.ndarray]:
    """The train split's statistics of a store written by
    :func:`write_npy_store`, recomputed from the files in float64 without
    the datastore: what ``compute_standardization_stats`` must write."""
    files = sorted((root / "samples" / "train").glob("nwp_??????????_mbr???.npy"))
    state = [np.load(f).astype(np.float64) for f in files]
    keep = [i for i in range(state[0].shape[-1]) if i not in removed]
    state = [a[..., keep] for a in state]
    flat = np.concatenate([a.reshape(-1, len(keep)) for a in state])
    mean, std = flat.mean(0), flat.std(0)
    diffs = np.concatenate([np.diff((a - mean) / std, axis=0).reshape(-1, len(keep))
                            for a in state])
    flux = np.concatenate([np.load(f).astype(np.float64).ravel() for f in sorted(
        (root / "samples" / "train").glob("nwp_toa_downwelling_shortwave_flux_*.npy"))])
    return {"parameter_mean": mean, "parameter_std": std, "diff_mean": diffs.mean(0),
            "diff_std": diffs.std(0), "flux_stats": np.array([flux.mean(), flux.std()])}


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
    launches K1 and K3 (K2 and K4 backward, and K4's receiver slice), or
    under ``NEURAL_LAM_TPU_FUSED_V2=on`` K7 alone (K8 and K2 backward); on
    the unfused route K1, K6 and K5 (backward K2, and K5 and K6 once more as
    each other's VJP). Under ``NEURAL_LAM_TPU_FUSED_AGGR=on`` the node update
    runs after K3 (the node backward before K4) at every application of
    GraphLAM and HiLAM: all of theirs are interaction-wired with sum
    aggregation (HiLAMParallel's sections never take it)."""
    from neural_lam_tpu_torch.ops.fused_kernels import fused_aggr_enabled

    n = gnn_applications(model)
    fused = model.hidden_layers == 1
    want = dict.fromkeys(kernel_counters(), 0)
    if fused and on_v2():
        want["K7 fused_edge_phase_v2"] = n
        if training:
            want["K8 fused_edge_phase_v2 backward"] = want["K2 sender_scatter"] = n
        return want
    node = fused and fused_aggr_enabled()
    if node and type(model).__name__ not in ("GraphLAM", "HiLAM"):
        raise AssertionError(f"expected_launches: {type(model).__name__} under "
                             f"{FUSED_AGGR}=on is not counted here")
    want["K1 sender_gather"] = n
    if node:
        want["K3 node update"] = n
        if training:
            want["K4 node backward"] = n
    if fused:
        want["K3 fused_edge_phase"] = n
    else:
        want["K5 segment_sum"] = want["K6 receiver_expand"] = n
    if training:
        want["K2 sender_scatter"] = n
        if fused:
            want["K4 fused_edge_phase backward"] = want[K4_RECEIVER_SLICE] = n
        else:
            want["K5 segment_sum"] = want["K6 receiver_expand"] = 2 * n
    return want


def phase_kernels(torch, model, parent=None) -> list[dict]:
    """Each kernel against its plain version at the shapes of the six
    GNN calls; returns the per-kernel report, times summed over the calls
    of one AR step (K1, K3) or one training step (K2, K4). With
    ``parent`` (:func:`parent_kernels`), K3 and K4 of the parent commit
    are timed on the same inputs in the same call."""
    from neural_lam_tpu_torch.ops import fused_kernels as fk
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
              bytes_ms=0.0, simt_ms=0.0, old_ms=0.0, old_pre_ms=0.0, same=0)
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
        old = "parent not measured"
        if parent is not None:
            old_ms = cuda_ms(lambda: parent["K3"](
                edge_in, x_send, rec, es, wts, mode == "raw", update, False))
            old_pre_ms = cuda_ms(lambda: parent["K3"](
                edge_in, x_send, rec, es, wts, mode == "raw", update, False,
                save_pre=True))
            k3["old_ms"] += calls * old_ms
            k3["old_pre_ms"] += calls * old_pre_ms
            k3["same"] += same_as_parent(parent, lambda: fused_edge_fwd(
                edge_in, x_send, rec, es, wts, mode == "raw", update, False,
                save_pre=True), f"K3 {site}")
            old = (f"parent {old_ms:.4f} ms, with pre {old_pre_ms:.4f} ms; its "
                   "outputs the same bits")
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
        f"training step runs it) {k3['pre_ms']:.4f} ms; parent (same "
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
              simt_ms=0.0, old_ms=0.0, same=0, moved=0.0)
    tail: dict[str, float] = {}
    rs = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0)  # the receiver slice alone
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
        old = "parent not measured"
        if parent is not None:
            old_ms = cuda_ms(lambda: parent["K4"](
                d_aggr, d_new, pre, edge_in, x_send, rec, es, wts, raw, False))
            k4["old_ms"] += calls * old_ms
            same, moved_rel = same_k4_as_parent(parent, run_k4, mode != "batched",
                                                f"K4 {site}")
            k4["same"] += same
            k4["moved"] = max(k4["moved"], moved_rel)
            old = (f"parent {old_ms:.4f} ms, its main kernel's outputs the same bits, "
                   f"the tail's within {moved_rel:.3g} of the parent's (tol {K4_TOL})")
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
        log_k4_split(torch, f"K4 {site}", run_k4, parent, calls, k4_tail_bounds(
            torch, es, n_rec, b, raw, edge_in, d_new, torch.float32, False), tail)
        # the receiver slice alone at this call's shapes, against the two
        # torch products it replaces
        d_recproj = randn(n_rec, b, d)
        w1 = wts[0]
        got_rs = fk.fused_edge_bwd_receiver_slice(d_recproj, rec, w1)
        want_rs = fk._plain_receiver_slice(d_recproj, rec, w1)
        torch.cuda.synchronize()
        for name, o, w in zip(("d_rec", "dW1r"), got_rs, want_rs):
            a_err, r_err = errors(o, w)
            if r_err > RECEIVER_TOL:
                raise AssertionError(f"K4 receiver slice {site} {name}: {r_err:.3g} of the "
                                     f"largest value off (tol {RECEIVER_TOL})")
            rs["err"] = max(rs["err"], a_err)
        rs_ms = cuda_ms(lambda: fk.fused_edge_bwd_receiver_slice(d_recproj, rec, w1))
        rs_plain = cuda_ms(lambda: fk._plain_receiver_slice(d_recproj, rec, w1))
        rs_bound = k4_tail_bounds(torch, es, n_rec, b, raw, edge_in, d_new, torch.float32,
                                  False)["receiver slice"]
        log(f"K4 receiver slice {site} alone (and its reduce): d_recproj {tuple(d_recproj.shape)}, "
            f"within {RECEIVER_TOL} of the two torch products; kernel {rs_ms:.4f} ms, the "
            f"torch products {rs_plain:.4f} ms, bound {rs_bound[0]:.4f} ms ({rs_bound[1]})")
        rs["ms"] += calls * rs_ms
        rs["plain_ms"] += calls * rs_plain
        rs["bound_ms"] += calls * rs_bound[0]
        del d_recproj, got_rs, want_rs
        del x_send, rec, edge_in, d_aggr, d_new, pre, outs, want, got, again, leaves
        del d_edge, d_send, d_rec, w_grads, aggr_p, new_p
        torch.cuda.empty_cache()
    log(
        f"per training step: K2 {k2['ms']:.4f} ms (bound {k2['bound_ms']:.4f}, "
        f"index_add_ {k2['library_ms']:.4f}), K4 {k4['ms']:.4f} ms (parent "
        f"(same call) {k4['old_ms']:.4f} ms, 0 = not measured; bound "
        f"{k4['bound_ms']:.4f} ms (3xTF32), {100 * k4['bound_ms'] / k4['ms']:.1f} % "
        f"of it; SIMT bound {k4['simt_ms']:.4f} ms; plain {k4['plain_ms']:.4f})"
    )
    log_k4_tail("K4 float32", tail, parent)
    log(f"K4 receiver slice per training step, alone: {rs['ms']:.4f} ms against the torch "
        f"products' {rs['plain_ms']:.4f} ms (bound {rs['bound_ms']:.4f} ms)")
    log_tail_occupancy("K4 float32", bf16_ops=False)
    if parent is not None:
        log(f"float32 K3 and K4 against the parent's kernels on the same inputs at "
            f"{len(k4_sites)} sites: {k3['same']} outputs of K3 (with its pre) and "
            f"{k4['same']} of K4's main kernel and rows pass, every one the same bits; "
            f"K4's edge pass and receiver slice within {k4['moved']:.3g} of the parent's "
            f"(tol {K4_TOL})")

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
        dict(
            name=K4_RECEIVER_SLICE,
            route="cuda",
            source="neural_lam_tpu_torch/csrc/fused_edge_bwd_common.cuh",
            replaces="neural_lam_tpu/ops/pallas_fused.py:1624",
            launches=0,
            max_abs_err=rs["err"],
            ms=rs["ms"],
            plain_ms=rs["plain_ms"],
            bound_ms=rs["bound_ms"],
            bound_by="bytes",
            library_ms=rs["plain_ms"],
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
    for kernel in ("K3", "K4", "K7", "K8"):
        for mode, occ in kernel_occupancy(kernel).items():
            main = " main" if kernel in ("K4", "K8") else ""
            log(
                f"probe {kernel}{main} {mode}: {occ['blocks']} block(s) of {occ['threads']} "
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
        runs = [("K4", fused_edge_bwd)] + ([("parent", parent["K4"])] if parent else [])
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


def phase_level_sets(torch, model, sites=None, mlp=None,
                     label: str = "level set") -> dict[str, float]:
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
    absolute error. ``sites`` (``(name, GraphEdges)`` pairs) and ``mlp``
    (an edge MLP) replace the level sets and the mesh init GNN's MLP."""
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

    if sites is None:
        sites = [
            (f"{kind}[{i}]", ge)
            for kind, sets in (("m2m", g.m2m), ("up", g.up), ("down", g.down))
            for i, ge in enumerate(sets)
        ]
    # (edge input, update_edges, propagation, sender rows)
    modes = [("shared", True, False, "batched"), ("shared", True, True, "batched"),
             ("batched", True, False, "batched"), ("batched", False, False, "batched"),
             ("shared", True, False, "unbatched")]
    mlp = model.mesh_init_gnns[0].edge_mlp if mlp is None else mlp
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
            f"K1/K2 {label} {site}: {shape}; K1 max abs err {err1:.3g} (tol "
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
                f"K3/K4 {label} {site}: {shape}, edge input {mode}, sender rows "
                f"{senders}, update_edges {update}, propagation {prop}: outputs "
                f"within rtol/atol {K3_RTOL}, gradients within {worst_rel:.3g} of "
                f"their largest value (tol {K4_TOL})"
            )
    for w in params:
        w.grad = None
    torch.cuda.empty_cache()
    return worst


def phase_v2_kernels(torch, model, parent=None) -> list[dict]:
    """K7 and K8 against their plain versions at the shapes of the six
    GraphLAM GNN calls, at batch 4, and K2 on K8's ``d_pre``. K7's
    aggregate, updated edges and ``pre``, and K8's ``d_pre``,
    ``d_recproj``, ``d_edge`` or the embedder's gradients and every weight
    gradient, each repeatable to the bit; each kernel timed beside its
    bound on the tensor cores (3xTF32) and on the SIMT units and, with
    ``parent`` (:func:`parent_kernels`), beside the parent commit's kernel
    on the same inputs. Then, per site, the two routes of the phase on the
    same inputs: v1 (K1 + K3 forward; K4 + K2 backward) against v2 (the
    node projections + K7 forward; K8 + K2 + the projections' backward),
    and the whole v2 phase against the v1 route's outputs and gradients.
    Returns the report of K7 (times summed over one AR step) and K8 (one
    training step)."""
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
    both = ("ms", "plain_ms", "bound_ms", "ops_ms", "bytes_ms", "simt_ms", "parent_ms",
            "err")
    k7 = dict.fromkeys(both + ("pre_ms", "parent_pre_ms", "proj_ms", "v1_ms", "v1_pre_ms"),
                       0.0)
    k8 = dict.fromkeys(both + ("k2_ms", "k2_bound_ms", "proj_bwd_ms", "v1_bwd_ms"), 0.0)

    def shares(ms, bound_ms, simt_ms):
        return (f"{100 * bound_ms / ms:.1f} % of the 3xTF32 bound, "
                f"{100 * simt_ms / ms:.1f} % of the SIMT bound")

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
        same = same_as_parent(parent, lambda: run7(True), f"K7 {site}")
        abs7 = max(errors(o, w)[0] for o, w in outs)
        got7 = dict(ms=cuda_ms(run7), pre_ms=cuda_ms(lambda: run7(True)))
        got7["plain_ms"] = cuda_ms(lambda: fk._plain_v2(
            edge_in, sp, rp, es.senders, es.receivers, wts, raw, update))
        if parent is not None:
            got7["parent_ms"] = cuda_ms(lambda: parent["K7"](
                edge_in, sp, rp, es, wts, raw, update))
            got7["parent_pre_ms"] = cuda_ms(lambda: parent["K7"](
                edge_in, sp, rp, es, wts, raw, update, True))
        # what the indexed sp loads cost: the same call with every sender 0,
        # so that sp is read from one row in cache
        one_row = dataclasses.replace(es, senders=torch.zeros_like(es.senders))
        one_row_ms = cuda_ms(lambda: fk.fused_edge_v2_fwd(
            edge_in, sp, rp, one_row, wts, raw, update))
        got7["proj_ms"] = cuda_ms(lambda: (send @ w1s.T, rec @ w1r.T))
        x_send = sender_gather(send, es.senders)
        k1_ms = cuda_ms(lambda: sender_gather(send, es.senders))
        k3_ms = cuda_ms(lambda: fk.fused_edge_fwd(
            edge_in, x_send, rec, es, wts, raw, update, False))
        k3_pre_ms = cuda_ms(lambda: fk.fused_edge_fwd(
            edge_in, x_send, rec, es, wts, raw, update, False, save_pre=True))
        got7["v1_ms"], got7["v1_pre_ms"] = k1_ms + k3_ms, k1_ms + k3_pre_ms
        moved7 = nbytes(edge_in, sp, rp, es.rowptr, es.senders, *params, aggr, new_edge)
        # multiply-adds (2 ops each) of the second layer per (edge, b) row,
        # of edge . W1e per row (batched) or per edge, with the embedder's
        # products per edge, and the receiver sums
        flops7 = 2 * rows * d * d + rows * d
        if raw:
            flops7 += n_e * (2 * edge_in.shape[1] * d + 2 * d * d * 2)
        else:
            flops7 += 2 * rows * d * d
        got7["bound_ms"], by7 = bound(moved7, flops7, tensor=True)
        got7["simt_ms"], _ = bound(moved7, flops7)
        got7["ops_ms" if by7 == "operations" else "bytes_ms"] = got7["bound_ms"]
        parent7 = (f"parent {got7['parent_ms']:.4f} ms (with pre "
                   f"{got7['parent_pre_ms']:.4f})" if parent else "parent not measured")
        log(
            f"K7 fused_edge_phase_v2 {site}: E {n_e}, senders {n_send}, receivers "
            f"{n_rec}, edge input {mode}, update_edges {update}; max abs err "
            f"{abs7:.3g} (aggregate, pre{', new_edge' if update else ''}; rtol/atol "
            f"{K3_RTOL}), repeatable; kernel {got7['ms']:.4f} ms, with the pre output "
            f"{got7['pre_ms']:.4f} ms, {parent7}, every sp row from one cached row "
            f"{one_row_ms:.4f} ms; plain {got7['plain_ms']:.4f} ms; "
            f"bound {got7['bound_ms']:.4f} ms ({by7}, 3xTF32: {moved7 / 1e6:.1f} MB, "
            f"{flops7 / 1e9:.2f} GFLOP), SIMT bound {got7['simt_ms']:.4f} ms; "
            f"{shares(got7['ms'], got7['bound_ms'], got7['simt_ms'])}; {calls} call(s) "
            "per AR step"
        )
        for key, val in got7.items():
            k7[key] += calls * val
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
        same += same_as_parent(parent, lambda: flat(run8()), f"K8 {site}")
        d_pre, d_rp = got[1], got[2]
        sums = sender_scatter(d_pre, es, n_send)
        _, rel2 = errors(sums, sender_scatter_plain(d_pre, es.senders, n_send))
        if rel2 > K2_TOL:
            raise AssertionError(f"K2 {site} on d_pre: max rel err {rel2} > {K2_TOL}")

        def proj_bwd():  # the node projections' backward: node rows and W1s, W1r
            return (sums @ w1s, torch.einsum("nbc,nbk->ck", sums, send),
                    d_rp @ w1r, torch.einsum("nbc,nbk->ck", d_rp, rec))

        got8 = dict(ms=cuda_ms(run8), plain_ms=cuda_ms(plain8))
        if parent is not None:
            got8["parent_ms"] = cuda_ms(lambda: parent["K8"](
                d_aggr, d_new, pre, edge_in, es, wts, raw))
        got8["k2_ms"] = cuda_ms(lambda: sender_scatter(d_pre, es, n_send))
        got8["k2_bound_ms"], _ = bound(
            nbytes(d_pre, es.send_perm, es.send_rowptr, sums), d_pre.numel())
        got8["proj_bwd_ms"] = cuda_ms(proj_bwd)
        _, _, pre1 = fk.fused_edge_fwd(edge_in, x_send, rec, es, wts, raw, update, False,
                                       save_pre=True)
        k4_ms = cuda_ms(lambda: fk.fused_edge_bwd(
            d_aggr, d_new, pre1, edge_in, x_send, rec, es, wts, raw, False))
        got8["v1_bwd_ms"] = k4_ms + got8["k2_ms"]  # K2 on d_send: the same edges and rows
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
        got8["bound_ms"], by8 = bound(moved8, flops8, tensor=True)
        got8["simt_ms"], _ = bound(moved8, flops8)
        got8["ops_ms" if by8 == "operations" else "bytes_ms"] = got8["bound_ms"]
        parent8 = (f"parent {got8['parent_ms']:.4f} ms; K7 and K8 give the parent's bits "
                   f"({same} tensors)" if parent else "parent not measured")
        log(
            f"K8 fused_edge_phase_v2 backward {site}: d_new_edge "
            f"{'given' if has_dne else 'none'}; max abs err {abs8:.3g}, at most "
            f"{rel8:.3g} of a gradient's largest value (tol {K4_TOL}), repeatable; "
            f"kernel {got8['ms']:.4f} ms, {parent8}; plain (autograd) "
            f"{got8['plain_ms']:.4f} ms; bound {got8['bound_ms']:.4f} ms ({by8}, "
            f"3xTF32: {moved8 / 1e6:.1f} MB, {flops8 / 1e9:.2f} GFLOP), SIMT bound "
            f"{got8['simt_ms']:.4f} ms; {shares(got8['ms'], got8['bound_ms'], got8['simt_ms'])}; "
            f"K2 on d_pre {got8['k2_ms']:.4f} ms (max rel err {rel2:.3g}, bound "
            f"{got8['k2_bound_ms']:.4f} ms, bytes); {calls} call(s) per training step"
        )
        for key, val in got8.items():
            k8[key] += calls * val
        k8["err"] = max(k8["err"], abs8)
        v1_fwd, v2_fwd = got7["v1_ms"], got7["proj_ms"] + got7["ms"]
        v1_train = got7["v1_pre_ms"] + got8["v1_bwd_ms"]
        v2_train = got7["proj_ms"] + got7["pre_ms"] + got8["ms"] + got8["k2_ms"] + got8[
            "proj_bwd_ms"]
        log(
            f"route {site}: {n_e / (n_send + n_rec):.2f} edges per hoisted row "
            f"(E {n_e} / ({n_send} senders + {n_rec} receivers)); forward v1 (K1 "
            f"{k1_ms:.4f} + K3 {k3_ms:.4f}) {v1_fwd:.4f} ms, v2 (projections "
            f"{got7['proj_ms']:.4f} + K7 {got7['ms']:.4f}) {v2_fwd:.4f} ms, v2/v1 "
            f"{v2_fwd / v1_fwd:.3f}; forward and backward v1 (K1 + K3 with pre "
            f"{got7['v1_pre_ms']:.4f}, K4 {k4_ms:.4f} + K2 {got8['k2_ms']:.4f}) "
            f"{v1_train:.4f} ms, v2 (projections + K7 with pre "
            f"{got7['proj_ms'] + got7['pre_ms']:.4f}, K8 {got8['ms']:.4f} + K2 "
            f"{got8['k2_ms']:.4f} + the projections' backward {got8['proj_bwd_ms']:.4f}) "
            f"{v2_train:.4f} ms, v2/v1 {v2_train / v1_train:.3f}"
        )
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
    v2_train = k7["proj_ms"] + k7["pre_ms"] + k8["ms"] + k8["k2_ms"] + k8["proj_bwd_ms"]
    v1_train = k7["v1_pre_ms"] + k8["v1_bwd_ms"]
    log(
        f"K7 per AR step: {k7['ms']:.4f} ms (with the pre output {k7['pre_ms']:.4f}); "
        f"parent (same call) {k7['parent_ms']:.4f} / {k7['parent_pre_ms']:.4f} ms (0 = "
        f"not measured); bound {k7['bound_ms']:.4f} ms (3xTF32), SIMT bound "
        f"{k7['simt_ms']:.4f} ms: {shares(k7['ms'], k7['bound_ms'], k7['simt_ms'])}; "
        f"plain {k7['plain_ms']:.4f} ms. K8 per training step: {k8['ms']:.4f} ms; parent "
        f"(same call) {k8['parent_ms']:.4f} ms; bound {k8['bound_ms']:.4f} ms (3xTF32), "
        f"SIMT bound {k8['simt_ms']:.4f} ms: {shares(k8['ms'], k8['bound_ms'], k8['simt_ms'])}; "
        f"plain {k8['plain_ms']:.4f} ms"
    )
    log(
        f"route per AR step: v1 (K1 + K3) {k7['v1_ms']:.4f} ms, v2 (projections "
        f"{k7['proj_ms']:.4f} + K7 {k7['ms']:.4f}) {k7['proj_ms'] + k7['ms']:.4f} ms; per "
        f"training step (forward with pre and backward): v1 (K1 + K3, K4 + K2) "
        f"{v1_train:.4f} ms, v2 (projections + K7, K8 + K2 + the projections' "
        f"backward {k8['proj_bwd_ms']:.4f}) {v2_train:.4f} ms"
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
    hierarchical graph (from 51,520 edges into 6,561 receivers down to 40
    edges into 9; in-degree 9 on the up sets and 1 on the down sets), in
    every edge mode: through ``interaction.fused_edge_phase`` as
    HiLAMParallel calls it, with a shared edge input and the edge update,
    a batched one with and without it, unbatched sender rows beside
    batched receiver rows, and an edge MLP without LayerNorm; and through
    ``fused_kernels.fused_edge_phase_v2`` with the in-kernel embedder on
    the set's raw features. Outputs and every gradient against the plain
    version and against the v1 route, and a second run to the bit;
    returns the largest absolute errors of K7 (outputs) and K8
    (gradients)."""
    from neural_lam_tpu_torch.ops import fused_kernels as fk
    from neural_lam_tpu_torch.ops import interaction
    from neural_lam_tpu_torch.ops.fused_kernels import (
        fused_edge_phase_v2,
        fused_edge_phase_v2_plain,
    )
    from neural_lam_tpu_torch.ops.mlp import make_mlp
    from neural_lam_tpu_torch.ops.segment import gather_senders
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
             ("batched", True, "batched", False), ("raw", True, "batched", True)]
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
            emb = feats = None
            if mode == "raw":  # the in-kernel embedder on the set's features
                edge, feats = None, ge.features
                emb = make_mlp([feats.shape[1], d, d],
                               generator=torch.Generator().manual_seed(GATE_SEED)).to(dev)
            w_aggr, w_edge = randn(n_rec, b, d), randn(n_e, b, d)
            leaves = [t.requires_grad_(True) for t in (send, rec, edge) if t is not None]
            leaves += params + (list(emb.parameters()) if emb else [])

            def loss(out):
                total = (out[0] * w_aggr).sum()
                return total + (out[1] * w_edge).sum() if update else total

            def run(route):
                with fused_v2(route):
                    if mode != "raw":
                        out = interaction.fused_edge_phase(mlp, es, send, rec, edge,
                                                           update_edges=update)
                    elif route == "on":
                        out = fused_edge_phase_v2(mlp, None, send, rec, es, embedder=emb,
                                                  edge_feats=feats, update_edges=update)
                    else:
                        out = fk.fused_edge_phase(mlp, None, gather_senders(es, send), rec,
                                                  es, embedder=emb, edge_feats=feats,
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
                es.senders, es.receivers, emb, feats, update_edges=update,
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


def phase_v2_bf16_level_sets(torch, model) -> dict[str, float]:
    """K7's and K8's bf16-operand instantiations (bf16 streams, and float32
    streams as under ``high-kernels``) at every edge set of the
    hierarchical graph, through their launchers, in each edge mode (the
    set's raw features through the in-kernel embedder, a shared edge input,
    a batched one with and without the edge update and LayerNorm) against
    their plain versions on the same inputs: K7's aggregate, updated edges
    and pre, K8's every gradient, each within the bf16 bounds
    (:func:`bf16_check`), and a second run to the bit. Returns the largest
    absolute errors of each instantiation."""
    from neural_lam_tpu_torch.ops import fused_kernels as fk
    from neural_lam_tpu_torch.ops.mlp import make_mlp

    g, dev, d, b = model.graph, model.device, HIDDEN, BATCH
    gen = torch.Generator(device=dev).manual_seed(11)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    sites = [(f"{kind}[{i}]", ge) for kind, sets in (("m2m", g.m2m), ("up", g.up),
                                                      ("down", g.down))
             for i, ge in enumerate(sets)]
    # (edge input, update_edges, LayerNorm)
    modes = [("raw", False, True), ("shared", True, True), ("batched", True, True),
             ("batched", False, False)]
    wgen = torch.Generator().manual_seed(GATE_SEED)
    mlps = {ln: make_mlp([3 * d, d, d], layer_norm=ln, generator=wgen) for ln in (True, False)}
    worst = {}
    for label, io in (("bf16", bf16), ("bf16 operands", torch.float32)):
        worst[label] = 0.0
        for site, ge in sites:
            es = ge.edges
            n_e, n_rec, n_send = es.num_edges, es.num_rec, es.num_send
            for mode, update, ln in modes:
                raw = mode == "raw"
                emb = make_mlp([ge.features.shape[1], d, d], generator=wgen) if raw else None
                wts = [None if w is None else w.detach().to(bf16).float().to(dev)
                       for w in fk._weights(mlps[ln], emb)]
                sp, rp = randn(n_send, b, d, dtype=io), randn(n_rec, b, d, dtype=io)
                edge_in = (ge.features.to(io) if raw else randn(n_e, d, dtype=io)
                           if mode == "shared" else randn(n_e, b, d, dtype=io))
                d_aggr = randn(n_rec, b, d, dtype=io)
                d_new = randn(n_e, b, d, dtype=io) if update else None

                def run():
                    aggr, new_edge, pre = fk.fused_edge_v2_fwd(
                        edge_in, sp, rp, es, wts, raw, update, save_pre=True, bf16_ops=True)
                    d_edge, d_pre, d_rec, grads = fk.fused_edge_v2_bwd(
                        d_aggr, d_new, pre, edge_in, es, wts, raw, bf16_ops=True)
                    return ([aggr] + ([new_edge] if update else []) + [pre],
                            [d_pre, d_rec] + ([] if raw else [d_edge])
                            + [x for x in grads if x is not None])

                (outs, grads), (outs2, grads2) = run(), run()
                e32, sp32, rp32 = edge_in.float(), sp.float(), rp.float()
                want = fk._plain_v2(e32, sp32, rp32, es.senders, es.receivers, wts, raw,
                                    update, bf16_ops=True)
                want_o = [want[0]] + ([want[1]] if update else []) + [want[2]]
                d_edge, d_pre, d_rec, w_grads = fk._plain_v2_bwd(
                    d_aggr.float(), None if d_new is None else d_new.float(), e32, sp32, rp32,
                    es, wts, raw, update, bf16_ops=True)
                want_g = [d_pre, d_rec] + ([] if raw else [d_edge]) + [
                    x for x in w_grads if x is not None]
                torch.cuda.synchronize()
                what = f"K7/K8 {label} level set {site} {mode}"
                err = 0.0
                for i, (o, w) in enumerate([*zip(outs, want_o), *zip(grads, want_g)]):
                    err = max(err, bf16_check(o, w.to(o.dtype), f"{what} output {i}"))
                if not all(torch.equal(x, y) for x, y in zip(outs + grads, outs2 + grads2)):
                    raise AssertionError(f"{what}: two runs differ")
                worst[label] = max(worst[label], err)
                log(f"{what}: E {n_e}, senders {n_send}, receivers {n_rec}, update_edges "
                    f"{update}, LayerNorm {ln}: outputs and gradients within {BF16_TOL} "
                    f"(max) and {BF16_MEAN_TOL} (mean) of each one's largest entry, max abs "
                    f"err {err:.3g}, repeatable")
                del outs, grads, outs2, grads2, want, want_o, want_g
    torch.cuda.empty_cache()
    return worst


def phase_gate(torch, ds, forecaster) -> list[dict]:
    """19-step rollout against the committed exact-f32 JAX fixture
    (scripts/accuracy_probe.py: inputs :80-88, metrics :104-117), through
    the captured forecast: ``ARForecaster.forward`` as a CUDA graph
    (``utils.cuda_graph.CapturedFunction``), captured and replayed once."""
    from neural_lam_tpu_torch.utils.cuda_graph import CapturedFunction

    init, forcing, boundary = gate_inputs(ds)
    captured = CapturedFunction(forecaster, forecaster, DEVICE)
    pred, _ = captured(
        *(torch.from_numpy(a).to(DEVICE) for a in (init, forcing, boundary))
    )
    (entry,) = captured.graphs.values()
    if entry.replays != 1:
        raise AssertionError(f"gate: {entry.replays} replays of the forecast's graph")
    del captured, entry
    return gate_check(pred.cpu().numpy(), "captured forecast")


def gate_inputs(ds):
    """The accuracy gate's rollout inputs ``(init, forcing, boundary)``
    (scripts/accuracy_probe.py:80-88)."""
    fx = np.load(FIXTURES / "rollout19_f32.npz")
    steps, n = int(fx["steps"]), ds.num_grid_points
    rng = np.random.default_rng(0)
    init = rng.normal(size=(1, 2, n, N_STATE)).astype(np.float32)
    forcing = rng.normal(size=(1, steps, n, N_FORCING * 3)).astype(np.float32)
    boundary = rng.normal(size=(1, steps, n, N_STATE)).astype(np.float32)
    return init, forcing, boundary


def gate_check(pred, label: str) -> list[dict]:
    """The accuracy gate's metrics of a 19-step rollout ``pred`` against
    ``rollout19_f32.npz`` (scripts/accuracy_probe.py:104-117), logged and
    held to the probe's thresholds."""
    fx = np.load(FIXTURES / "rollout19_f32.npz")
    steps, sub = int(fx["steps"]), int(fx["subsample"])
    if pred.shape[:2] != (1, steps) or pred.shape[-1] != N_STATE or not np.isfinite(pred).all():
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
        f"gate ({label}): worst mean_rel {worst_mean:.3e} (limit {GATE_MEAN_REL}), "
        f"worst max_rel {worst_max:.3e} (limit {GATE_MAX_REL}), abs_mean "
        f"drift {drift:.3e} (limit {GATE_MEAN_REL})"
    )
    if worst_mean > GATE_FAULT_MEAN_REL:
        log(f"gate: mean_rel above {GATE_FAULT_MEAN_REL}: a fault in exact f32")
    if worst_mean > GATE_MEAN_REL or worst_max > GATE_MAX_REL or drift > GATE_MEAN_REL:
        raise AssertionError("accuracy gate: thresholds exceeded")
    return rows


@contextlib.contextmanager
def recorded_captures():
    """Every ``CapturedFunction`` (the port's captured inference: the
    forecast, the eval step, the test evaluation's batch) made inside the
    block, in a list, so that its graphs can be profiled after."""
    from neural_lam_tpu_torch.utils.cuda_graph import CapturedFunction

    made: list = []
    init = CapturedFunction.__init__

    def record(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    CapturedFunction.__init__ = record
    try:
        yield made
    finally:
        CapturedFunction.__init__ = init


def keep_cuda_graphs(torch) -> None:
    """Every CUDA graph the run captures keeps its ``cudaGraph_t``
    (``keep_graph=True``; a replay instantiates it), so that
    :func:`graph_kernels` can read its nodes. The graphs run as before."""
    plain = torch.cuda.CUDAGraph

    class Kept(plain):
        def __init__(self, keep_graph: bool = True) -> None:
            super().__init__(keep_graph=True)

    torch.cuda.CUDAGraph = Kept


def graph_kernels(torch, graph) -> dict[str, int]:
    """The launches of each of K1-K8 that one replay of ``graph`` makes:
    its kernel nodes, named through libcuda (``cuGraphGetNodes``,
    ``cuGraphKernelNodeGetParams``, ``cuFuncGetName``) and counted by
    ``KERNEL_SYMBOLS``; the graph must be kept (:func:`keep_cuda_graphs`).
    A profile of the replay is not used for this: in a long run the
    profiler lost a record now and then (911 of the 912 K1 launches of
    HiLAMParallel's request graph), which a count must not."""
    counts = dict.fromkeys(KERNEL_SYMBOLS, 0)
    for name in graph_kernel_names(torch, graph):
        for kernel, symbol in KERNEL_SYMBOLS.items():
            if symbol.search(name):
                counts[kernel] += 1
    return counts


def graph_kernel_names(torch, graph) -> list[str]:
    """The (mangled) name of every kernel node of the kept ``graph``: one
    replay's kernel launches, every library's included."""
    import ctypes

    ptr, out = ctypes.c_void_p, ctypes.POINTER
    cuda = ctypes.CDLL("libcuda.so.1")
    for fn, args in (
        ("cuGraphGetNodes", [ptr, ptr, out(ctypes.c_size_t)]),
        ("cuGraphNodeGetType", [ptr, out(ctypes.c_int)]),
        ("cuGraphKernelNodeGetParams_v2", [ptr, ptr]),
        ("cuFuncGetName", [out(ctypes.c_char_p), ptr]),
        ("cuKernelGetName", [out(ctypes.c_char_p), ptr]),
    ):
        getattr(cuda, fn).argtypes = args
        getattr(cuda, fn).restype = ctypes.c_int  # CUresult

    def check(err: int, what: str) -> None:
        if err != 0:
            raise RuntimeError(f"{what}: CUresult {err}")

    handle = ptr(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ptr * n.value)()
    check(cuda.cuGraphGetNodes(handle, ctypes.cast(nodes, ptr), ctypes.byref(n)),
          "cuGraphGetNodes")
    names = []
    for node in nodes:
        kind = ctypes.c_int()
        check(cuda.cuGraphNodeGetType(ptr(node), ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2, with room: func at [0], kern (CUkernel) at [7]
        params = (ptr * 16)()
        check(cuda.cuGraphKernelNodeGetParams_v2(ptr(node), ctypes.cast(params, ptr)),
              "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if params[0]:
            check(cuda.cuFuncGetName(ctypes.byref(name), ptr(params[0])), "cuFuncGetName")
        else:
            check(cuda.cuKernelGetName(ctypes.byref(name), ptr(params[7])), "cuKernelGetName")
        names.append(name.value.decode())
    return names


def replayed_launches(torch, made, label: str) -> dict[str, int]:
    """The launches of K1-K8 that the replays of the captured inference
    ``made`` ran, beyond what the wrappers counted: each graph's capture
    counted one replay's launches, which :func:`graph_kernels` reads from
    the graph, so each graph adds (its replays - 1) of those. Every graph
    must hold a kernel of K1-K8."""
    extra = dict.fromkeys(KERNEL_SYMBOLS, 0)
    for fn in made:
        for entry in fn.graphs.values():
            replay = graph_kernels(torch, entry.graph)
            if not any(replay.values()):
                raise AssertionError(f"{label}: a graph ran none of K1-K8")
            for name, count in replay.items():
                extra[name] += (entry.replays - 1) * count
            log(f"{label}: graph of {entry.inputs[0].shape[0]} x "
                f"{tuple(entry.inputs[1].shape[1:])} replayed {entry.replays} times; "
                f"one replay: {', '.join(f'{k} {v}' for k, v in replay.items() if v)}")
    return extra


def same_outputs(torch, got, want, label: str, rtol: float = GRAPH_LOSS_RTOL) -> str:
    """``got`` against ``want`` (tensors, or tuples and dicts of them):
    each within ``rtol`` of its largest entry; returns how many entries
    are the same bits."""
    from neural_lam_tpu_torch.utils.cuda_graph import map_tensors

    pairs: list = []
    map_tensors(lambda t: pairs.append(t), (got, want))
    half = len(pairs) // 2
    same = total = 0
    worst = 0.0
    for g, w in zip(pairs[:half], pairs[half:]):
        if g.shape != w.shape:
            raise AssertionError(f"{label}: shape {tuple(g.shape)} against {tuple(w.shape)}")
        scale = max(w.abs().max().item(), 1e-30)
        worst = max(worst, (g - w).abs().max().item() / scale)
        same += int((g == w).sum().item())
        total += w.numel()
    if not worst <= rtol:
        raise AssertionError(f"{label}: captured against eager {worst:.3e} (tol {rtol})")
    return f"max rel {worst:.3e} (tol {rtol}), {same} of {total} entries the same bits"


def phase_serve(torch, ds, model, card: str, ar_steps: int = 0) -> dict[str, int]:
    """One forecast request through run_forecasts (``AR_STEPS`` steps
    unless ``ar_steps`` says otherwise), whose forecast is a CUDA graph
    (``predict.make_forecast``): its first call runs one eager warm-up
    forecast, captures one and replays it. The wrappers count the warm-up
    and the capture, ``expected_launches(model)`` per AR step each, and
    nothing in a replay; the graph holds ``expected_launches`` per AR step
    (:func:`graph_kernels`). Then, on the request's batch and the same weights,
    the eager forecast against the captured one (the same bits are
    expected) and both timed, beside the device time of a replay's
    kernels. Returns each kernel's launches on the device in the request:
    the warm-up's and the replay's."""
    ar_steps = ar_steps or AR_STEPS
    from neural_lam_tpu_torch.dataset import WeatherDataset
    from neural_lam_tpu_torch.models import ARForecaster
    from neural_lam_tpu_torch.predict import run_forecasts

    label = model_label(model)
    fc = ARForecaster(model, ds)
    out_dir = CACHE / "forecasts"
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    with recorded_captures() as made:
        t0 = time.perf_counter()
        written = run_forecasts(
            fc, ds, split="test", ar_steps=ar_steps, batch_size=BATCH,
            n_samples=SERVE_BATCHES * BATCH, out_dir=out_dir, device=DEVICE,
        )
        wall = time.perf_counter() - t0
    ticks = {name: fn.launches for name, fn in counters.items()}
    (forecast,) = made
    (entry,) = forecast.graphs.values()
    batches = entry.replays
    if written != SERVE_BATCHES * BATCH or batches != SERVE_BATCHES:
        raise AssertionError(f"served {written} forecasts in {batches} replays")
    expected = expected_launches(model, training=False)
    replay = graph_kernels(torch, entry.graph)
    launches = {}
    for name, per_step in expected.items():
        want = per_step * ar_steps
        launches[name] = ticks[name] + (batches - 1) * replay[name]
        log(
            f"serve {label}: {name} launches {ticks[name]} counted by the wrapper "
            f"(warm-up and capture, want 2 x {per_step} x {ar_steps} = {2 * want}), "
            f"{replay[name]} in the graph, one replay's (want {want}): {launches[name]} "
            f"in the request"
        )
        if ticks[name] != 2 * want or replay[name] != want:
            raise AssertionError(f"serve {label}: {name} launches off")
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

    # the request's batch, eager against captured, on the same weights
    dataset = WeatherDataset(ds, split="test", ar_steps=ar_steps)
    batch = [
        torch.from_numpy(np.stack(a)).to(DEVICE)
        for a in list(zip(*(dataset[i] for i in range(BATCH))))[:3]
    ]

    def eager():
        with torch.no_grad():
            return forecast.fn(*batch)

    bits = same_outputs(torch, forecast(*batch), eager(), f"serve {label}")
    eager_ms = cuda_ms(eager, reps=3, warmup=1) / ar_steps
    graph_ms = cuda_ms(lambda: forecast(*batch), reps=3, warmup=1) / ar_steps
    # the same kernels on the same values: one busy time for both
    busy, kernels = device_kernels(torch, lambda: forecast(*batch))
    busy /= ar_steps
    gps = BATCH * ds.num_grid_points / (graph_ms / 1e3)
    log(
        f"serve {label} on {card}: {written} forecasts of {ar_steps} steps in "
        f"{batches} request of {BATCH}; wall per request {wall / batches:.3f} s "
        f"(warm-up, capture, replay, copy back and npz writes); per AR step: device "
        f"busy {busy:.3f} ms; eager {eager_ms:.3f} ms (idle {1 - busy / eager_ms:.1%}), "
        f"captured {graph_ms:.3f} ms (idle {1 - busy / graph_ms:.1%}), "
        f"{eager_ms / graph_ms:.2f}x; {kernels} kernels a replay; captured against "
        f"eager: {bits}; "
        f"{gps:,.0f} grid-points/s captured; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )
    del forecast, entry, made
    release(torch)
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


def load_gate_params(model) -> None:
    """The GraphLAM fixture's parameters into ``model``, afresh."""
    from neural_lam_tpu_torch.convert_checkpoint import (
        load_jax_params_npz,
        params_from_jax,
    )

    model.load_state_dict(
        params_from_jax(load_jax_params_npz(FIXTURES / "graph_lam_meps_params_seed0.npz")),
        strict=True,
    )


def make_trainer(model, ds, reload: bool = True, precision: str = "32",
                 spatial_shards: Optional[int] = None, **train_args):
    """The ``bench.build_trainer`` trainer around ``model`` with a new
    optimizer; ``reload`` loads the GraphLAM fixture's parameters afresh;
    ``precision="bf16"`` trains on bf16 copies of them; ``spatial_shards``
    runs it through the sharded executor; ``train_args`` go to
    ``TrainingArgs`` (``flat_opt``, ``shard_opt_state``)."""
    from neural_lam_tpu_torch.config import DatastoreSelection, NeuralLAMConfig
    from neural_lam_tpu_torch.models import ARForecaster
    from neural_lam_tpu_torch.trainer import Trainer, TrainingArgs

    if reload:
        load_gate_params(model)
    config = NeuralLAMConfig(
        datastore=DatastoreSelection(kind="dummydata", config_path="")
    )
    args = TrainingArgs(batch_size=BATCH, ar_steps_train=1, lr=TRAIN_LR,
                        precision=precision, **train_args)
    return Trainer(ARForecaster(model, ds), config, ds, args, device=model.device,
                   spatial_shards=spatial_shards)


def train_gate_run(torch, trainer, batch: int, n_losses: int, captured: bool = False,
                   block: Optional[slice] = None):
    """The training gate's run: from a fresh optimizer, the loss and the
    gradients of the bench batch, then ``n_losses - 1`` further AdamW
    steps on it. Returns the losses and the first step's gradients by
    state-dict name. With ``captured`` every step is a replay of the
    captured step (``Trainer.make_train_step``), and the gradients are
    those its first replay left in the parameters' ``.grad``. ``block``
    takes a data-parallel rank's rows of the batch."""
    from neural_lam_tpu_torch.convert_checkpoint import grads_to_numpy

    data = [
        torch.from_numpy(a[block or slice(None)]).to(trainer.device)
        for a in bench_batch(trainer.datastore, batch)
    ]
    trainer.optimizer = trainer.init_state()
    if captured:
        step = trainer.make_train_step()
        losses = [step(*data).item()]
        grads = grads_to_numpy(trainer.forecaster.predictor)
        losses += [step(*data).item() for _ in range(n_losses - 1)]
    else:
        # the step leaves each parameter's gradient in its .grad (over a
        # process group, the mean over the ranks)
        losses = [trainer.train_step(*data).item()]
        grads = grads_to_numpy(trainer.forecaster.predictor)
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


def phase_train_gate(torch, trainer, fixture_path, captured: bool = False,
                     block: Optional[slice] = None) -> dict:
    """Loss and gradients of the bench batch, then the losses of further
    AdamW steps, against the JAX package's fixture (made by
    ``tests/test_torch_train.py``), through the eager step or, with
    ``captured``, the captured one. The trainer's model must hold the
    ``PRNGKey(0)`` parameters; they are updated in place."""
    with np.load(fixture_path) as fx:
        want_losses = fx["losses"].astype(np.float64)
        grid, batch, lr = fx["grid"], int(fx["batch"]), float(fx["lr"])
        want_grads = {k[len("grad/"):]: fx[k] for k in fx.files if k.startswith("grad/")}
    check_gate_fixture(trainer, grid, lr)
    losses, got_grads = train_gate_run(
        torch, trainer, batch, len(want_losses), captured, block
    )

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
        f"train gate{' (captured step)' if captured else ''}: loss {losses[0]:.8g} vs {want_losses[0]:.8g} (rel "
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


def phase_model_gate(torch, name: str, model, ds, fixture_path,
                     captured: bool = False, spatial_shards: Optional[int] = None) -> dict:
    """One of ``GATE_MODELS`` against the JAX package's fixture (made by
    ``tests/test_torch_hier.py``): the states after the first and the
    last step of a short rollout at every ``GATE_NODE_STRIDE``-th grid
    node, then the training loss, each gradient's largest entry and
    sampled entries, and the losses of further AdamW steps. ``model``
    must hold the seeded parameters; they are updated in place. With
    ``captured`` the training steps are replays of the captured step.
    With ``spatial_shards`` (every rank of the spatial group calls it) the
    trainer and the rollout run sharded, the rollout gathered to the
    grid."""
    from neural_lam_tpu_torch.models import ARForecaster

    with np.load(fixture_path) as fx:
        want_states = fx["states"]
        want_losses = fx["losses"].astype(np.float64)
        grid, batch, lr = fx["grid"], int(fx["batch"]), float(fx["lr"])
        names = [str(n) for n in fx["grad_names"]]
        want_max, want_samples = fx["grad_max"], fx["grad_samples"]
        stride, steps = int(fx["node_stride"]), int(fx["rollout_steps"])
    trainer = make_trainer(model, ds, reload=False, spatial_shards=spatial_shards)
    check_gate_fixture(trainer, grid, lr)

    inputs = gate_rollout_inputs(ds, batch, steps)
    sp = trainer.spatial
    with torch.inference_mode():
        if sp is None:
            pred, _ = ARForecaster(model, ds)(
                *(torch.from_numpy(a).to(model.device) for a in inputs)
            )
        else:
            pred, _ = trainer._local_fc(
                *(torch.from_numpy(sp.grid_slab(a)).to(model.device) for a in inputs))
            pred = sp.gather_grid(pred)
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

    losses, got_grads = train_gate_run(
        torch, trainer, batch, len(want_losses), captured
    )
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
        f"{name} gate{' (captured step)' if captured else ''}: loss {losses[0]:.8g} vs {want_losses[0]:.8g} (rel "
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
    from neural_lam_tpu_torch.ops import launch_counters

    return launch_counters()


def phase_train(torch, trainer, card: str) -> tuple[dict[str, int], dict]:
    """Training steps through ``Trainer.train_step`` on the bench batch;
    returns each kernel's launches in this run, which must be
    ``expected_launches(model, training=True)`` per step, and the losses
    and the step time (``phase_train_graph`` holds the captured step to
    them)."""
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
    return launches, dict(losses=losses, step_ms=step_ms)


def phase_train_graph(torch, trainer, card: str, eager: dict) -> dict[str, int]:
    """The captured step, ``Trainer.make_train_step()``, on the bench batch
    from the weights ``phase_train`` started from: 2 warm-up and 10 timed
    calls as there (the first call warms up, captures and replays), each
    a replay of one CUDA graph. The 12 losses against the eager step's
    (``eager``, from ``phase_train``), the step time against the eager
    step's and against the device time of the replay's kernels, and the
    launches: the wrappers count the first call's ``GRAPH_WARMUP_STEPS``
    eager steps and the capture of one, ``expected_launches`` each, and
    nothing in the calls after it; the graph's kernel nodes hold
    ``expected_launches`` (:func:`graph_kernels`). Returns each kernel's launches
    on the device in this run: the warm-up steps' and 12 replays'."""
    from neural_lam_tpu_torch.trainer import GRAPH_WARMUP_STEPS

    ds = trainer.datastore
    model = trainer.forecaster.predictor
    label = model_label(model)
    data = [torch.from_numpy(a).to(trainer.device) for a in bench_batch(ds)]
    counters = kernel_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    step = trainer.make_train_step()
    t0 = time.perf_counter()
    losses = [step(*data).item()]
    capture_s = time.perf_counter() - t0
    first = {name: fn.launches for name, fn in counters.items()}
    losses += [step(*data).item() for _ in range(TRAIN_WARMUP - 1)]
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_ITERS + 1)]
    timed = []
    marks[0].record()
    for mark in marks[1:]:
        timed.append(step(*data))
        mark.record()
    torch.cuda.synchronize()
    losses += [loss.item() for loss in timed]
    times = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    peak = torch.cuda.max_memory_allocated()
    later = {name: fn.launches - first[name] for name, fn in counters.items()}
    if len(trainer.graphs) != 1:
        raise AssertionError(f"train graph {label}: {len(trainer.graphs)} graphs, want 1")
    step_ms = marks[0].elapsed_time(marks[-1]) / TRAIN_ITERS
    busy, kernels = device_kernels(torch, lambda: step(*data))
    replay = graph_kernels(torch, next(iter(trainer.graphs.values())).graph)
    launches = {}
    steps = TRAIN_WARMUP + TRAIN_ITERS
    for name, per_step in expected_launches(model, training=True).items():
        # the capture records one replay's launches
        warm = first[name] - replay[name]
        launches[name] = warm + replay[name] * steps
        log(
            f"train graph {label}: {name} launches: {first[name]} counted in the "
            f"first call ({GRAPH_WARMUP_STEPS} eager warm-up steps and the capture, "
            f"want {per_step} x {GRAPH_WARMUP_STEPS + 1}), {later[name]} in the "
            f"{steps - 1} calls after it (want 0), {replay[name]} in the graph, one "
            f"replay (want {per_step}): {warm} + {replay[name]} x {steps} replays "
            f"= {launches[name]}"
        )
        if (first[name] != per_step * (GRAPH_WARMUP_STEPS + 1) or later[name]
                or replay[name] != per_step):
            raise AssertionError(f"train graph {label}: {name} launches off")
    rel = np.abs(np.array(losses) - eager["losses"]) / np.abs(eager["losses"])
    same = int(np.sum(np.array(losses) == np.array(eager["losses"])))
    log(
        f"train graph {label}: loss per step " + ", ".join(f"{x:.6f}" for x in losses)
        + f"; against the eager step's max rel {rel.max():.3e} (tol {GRAPH_LOSS_RTOL}), "
        f"{same} of {steps} the same bits"
    )
    if not np.isfinite(losses).all() or rel.max() > GRAPH_LOSS_RTOL:
        raise AssertionError(f"train graph {label}: losses differ from the eager step's")
    # one call on an idle device: queued replays can fill the device's
    # launch queue and then wait for it
    host = host_ms(torch, lambda: step(*data), calls=1)
    gps = BATCH * ds.num_grid_points / (step_ms / 1e3)
    log(
        f"train graph {label} on {card}: first call (2 eager warm-up steps, capture, "
        f"replay) {capture_s:.2f} s; step time {step_ms:.3f} ms (the last {TRAIN_ITERS} "
        f"replays queued back to back: {', '.join(f'{t:.2f}' for t in times)}) against "
        f"the eager step's {eager['step_ms']:.3f} ms; device busy {busy:.3f} ms per "
        f"replay in {kernels} kernels ({1e3 * (step_ms - busy) / kernels:.2f} us of idle "
        f"time a kernel); host until one replay is enqueued {host:.3f} ms; {gps:,.0f} "
        f"training grid-points/s; peak device memory {peak / 2**30:.2f} GiB"
    )
    return launches


def phase_fit(torch, card: str) -> dict[str, int]:
    """One epoch of ``Trainer.fit`` on a MEPS-size dummy store: GraphLAM
    with the fixture's parameters, 8 training batches of 4 at ``ar_steps``
    1 through the captured step (prefetched on a side stream), then
    validation on 2 batches at ``ar_steps_eval`` 3, with a watched metric.
    Prints the history record; returns each kernel's launches on the
    device: the wrappers count the eager ones (the captures' warm-up calls)
    and the captures, the graphs' kernel nodes those of one replay
    (:func:`graph_kernels`): the training graph's, replayed once per
    training batch, and validation's, once per validation batch."""
    from torch.utils.data import Subset

    from neural_lam_tpu_torch.config import DatastoreSelection, NeuralLAMConfig
    from neural_lam_tpu_torch.convert_checkpoint import load_jax_params_npz, params_from_jax
    from neural_lam_tpu_torch.dataset import WeatherDataset
    from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
    from neural_lam_tpu_torch.loader import DataLoader
    from neural_lam_tpu_torch.models import ARForecaster, GraphLAM
    from neural_lam_tpu_torch.trainer import Trainer, TrainingArgs

    t0 = time.perf_counter()
    ds = DummyDatastore(
        n_grid_x=GRID_X, n_grid_y=GRID_Y, n_state_features=N_STATE,
        n_forcing_features=N_FORCING, n_static_features=N_STATIC,
        n_timesteps=FIT_TIMESTEPS, root_path=CACHE / "meps",
    )
    model = GraphLAM(ds, hidden_dim=HIDDEN, processor_layers=PROC_LAYERS, device=DEVICE)
    model.load_state_dict(params_from_jax(
        load_jax_params_npz(FIXTURES / "graph_lam_meps_params_seed0.npz")))
    args = TrainingArgs(
        batch_size=BATCH, ar_steps_train=1, ar_steps_eval=3, lr=TRAIN_LR,
        val_steps_to_log=(1, 2, 3), metrics_watch=("val_rmse",),
        var_leads_metrics_watch={ds.get_vars_names("state")[0]: [1, 3]},
    )
    config = NeuralLAMConfig(datastore=DatastoreSelection(kind="dummydata", config_path=""))
    trainer = Trainer(ARForecaster(model, ds), config, ds, args)
    train = DataLoader(WeatherDataset(ds, "train", ar_steps=1), BATCH, shuffle=True)
    val = WeatherDataset(ds, "val", ar_steps=args.ar_steps_eval)
    val = DataLoader(Subset(val, range(2 * BATCH)), BATCH)
    log(f"fit set-up: {len(train)} training batches, {len(val)} validation batches "
        f"({time.perf_counter() - t0:.1f} s)")
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    with recorded_captures() as captured:
        (record,) = trainer.fit(train, val, epochs=1)
    torch.cuda.synchronize()
    ticks = {name: fn.launches for name, fn in counters.items()}
    # validation replays its eval step's graph once per batch
    val_replays = replayed_launches(torch, captured, "fit validation")
    del captured[:]
    # one more replay of the epoch's graph after it, which the wrappers
    # must not count; the graph's kernel nodes give a replay's launches
    data, _ = trainer.device_put_batch(next(iter(train)))
    trainer.make_train_step()(*data)
    replay = graph_kernels(torch, next(iter(trainer.graphs.values())).graph)
    if len(trainer.graphs) != 1 or any(
            fn.launches != ticks[name] for name, fn in counters.items()):
        raise AssertionError("fit: the epoch's graph was not replayed after it")
    launches = {}
    for name, per_step in expected_launches(model, training=True).items():
        if replay[name] != per_step:
            raise AssertionError(f"fit: {name}: {replay[name]} launches a replay, "
                                 f"want {per_step}")
    for name, count in ticks.items():
        # the capture recorded one replay's launches, not run
        launches[name] = count - replay[name] + replay[name] * len(train) + val_replays[name]
    log(f"fit GraphLAM on {card}: one epoch: {json.dumps(record)}")
    if not all(np.isfinite(record[k]) for k in ("train_loss", "val_loss", "val_loss_unroll3")):
        raise AssertionError("fit: non-finite losses")
    del trainer, model
    release(torch)
    return launches


def release(torch) -> None:
    """Free what a finished phase left on the card: a trainer sits in
    reference cycles (its captured step's closure), which only the
    collector frees, so later phases' peak memory would count it."""
    gc.collect()
    torch.cuda.empty_cache()


class CliCalls:
    """The port's entry points called in-process, as a user's workflow
    calls them: each call with the counters at 0 just before it and its
    stdout in ``<root>/cli.log``, and its launches on the device added to
    ``launches``. The CLIs' trainers are kept in ``trainers`` (inside
    :meth:`recording_trainers`) so that their graphs can be profiled."""

    def __init__(self, torch, root: Path, label: str) -> None:
        from neural_lam_tpu_torch.trainer import Trainer

        self.torch, self.root, self.label = torch, root, label
        self.counters = kernel_counters()
        self.launches: dict[str, int] = dict.fromkeys(self.counters, 0)
        self.trainers: list = []
        made = self.trainers

        class Recorded(Trainer):
            """The CLI's trainer, kept so that its graph can be profiled."""

            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                made.append(self)

        self._recorded = Recorded

    @contextlib.contextmanager
    def recording_trainers(self):
        from neural_lam_tpu_torch import train_model

        plain = train_model.Trainer
        train_model.Trainer = self._recorded
        try:
            yield
        finally:
            train_model.Trainer = plain

    def __call__(self, entry, argv) -> tuple[dict[str, int], float]:
        """One CLI call; returns the wrappers' ticks, with the launches of
        the captured inference's replays added (:func:`replayed_launches`),
        and the call's seconds. The ticks join ``launches``; a training
        run's graph replays join them by :meth:`training_run`."""
        torch = self.torch
        for fn in self.counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with open(self.root / "cli.log", "a", encoding="utf-8") as out, \
                contextlib.redirect_stdout(out), recorded_captures() as captured:
            entry(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        ticks = {n: fn.launches for n, fn in self.counters.items()}
        for name, count in replayed_launches(torch, captured, self.label).items():
            ticks[name] += count
        del captured[:]
        for name, count in ticks.items():
            self.launches[name] += count
        return ticks, seconds

    def training_run(self, ticks, replays: int, batch, label: str) -> None:
        """The launches of the last training run's graph, which its epochs
        replayed ``replays`` times: the capture, counted in ``ticks``,
        recorded one replay's launches and did not run them."""
        torch = self.torch
        trainer = self.trainers[-1]
        if next(trainer.forecaster.parameters()).device.type != DEVICE:
            raise AssertionError(f"{self.label} {label}: the model is not on the card")
        if len(trainer.graphs) != 1:
            raise AssertionError(f"{self.label} {label}: {len(trainer.graphs)} graphs, want 1")
        data, _ = trainer.device_put_batch(batch)
        trainer.make_train_step()(*data)  # replays: the graph is the epochs'
        if len(trainer.graphs) != 1:
            raise AssertionError(f"{self.label} {label}: a second graph was captured")
        replay = graph_kernels(torch, next(iter(trainer.graphs.values())).graph)
        for name in ticks:
            self.launches[name] += replay[name] * (replays - 1)
        log(f"{self.label} {label}: wrappers' ticks {ticks}; one replay {replay}; "
            f"{replays} replays")

    def check_launches(self, card: str) -> dict[str, int]:
        for name in ("K1 sender_gather", "K2 sender_scatter", "K3 fused_edge_phase",
                     "K4 fused_edge_phase backward"):
            if self.launches[name] <= 0:
                raise AssertionError(f"{self.label}: {name} was not launched")
        log(f"{self.label} on {card}: launches {self.launches}")
        return self.launches


def hold_to_cpu_rollout(torch, run: Path, ds, path: Path, label: str) -> None:
    """The forecast of test sample 0 in ``path``, first
    ``GATE_ROLLOUT_STEPS`` steps, against a rollout of the same
    ``min_val_loss`` checkpoint on the CPU (the kernels' plain versions),
    within ``GATE_STATE_MEAN_REL`` and ``GATE_STATE_MAX_REL`` of the mean
    absolute state."""
    from neural_lam_tpu_torch.checkpoint import load_forecaster_from_checkpoint
    from neural_lam_tpu_torch.dataset import WeatherDataset
    from neural_lam_tpu_torch.trainer import standardization_stats, standardize_batch

    t0 = time.perf_counter()
    fc, _ = load_forecaster_from_checkpoint(run, ds, name="min_val_loss", device="cpu")
    init, target, forcing, _ = WeatherDataset(ds, "test", ar_steps=GATE_ROLLOUT_STEPS)[0]
    stats = standardization_stats(ds)
    with torch.inference_mode():
        init_s, target_s, forcing_s = standardize_batch(
            *(torch.from_numpy(a[None]) for a in (init, target, forcing)), stats)
        want = fc(init_s, forcing_s, target_s)[0][0].numpy()
    want = want * stats["state_std"] + stats["state_mean"]
    got = np.load(path)["prediction"][:GATE_ROLLOUT_STEPS]
    scale = np.abs(want).mean()
    mean_rel = float(np.abs(got - want).mean() / scale)
    max_rel = float(np.abs(got - want).max() / scale)
    log(f"{label}: forecast of test sample 0, steps 1-{GATE_ROLLOUT_STEPS}, against the "
        f"min_val_loss checkpoint on the CPU: mean rel {mean_rel:.3e} (tol "
        f"{GATE_STATE_MEAN_REL}), max rel {max_rel:.3e} (tol {GATE_STATE_MAX_REL}) "
        f"({time.perf_counter() - t0:.1f} s)")
    if not (np.isfinite(got).all() and mean_rel <= GATE_STATE_MEAN_REL
            and max_rel <= GATE_STATE_MAX_REL):
        raise AssertionError(f"{label}: the forecast differs from the CPU rollout")


def phase_cli(torch, card: str) -> dict[str, int]:
    """The user's workflow through the port's entry points, at full width
    (GraphLAM, hidden 64, 4 processor layers, batch 4) on a MEPS-size
    ``mdp`` store written by :func:`write_mdp_store` (268 x 238, 17 state,
    6 forcing and 4 static features; splits of 35, 13 and 25 steps):
    ``create_graph``; ``train_model`` for 2 epochs (8 batches each,
    validation on 2 batches at 3 AR steps); a resume with ``--load
    --restore_opt --epochs 3``, which must log epoch 2 only and keep the
    best validation loss of the three in ``best.json``; ``--eval test`` at
    19 AR steps; ``predict`` of 4 samples at 19 AR steps from the
    ``min_val_loss`` checkpoint, whose first forecast
    :func:`hold_to_cpu_rollout` holds to the CPU.

    Returns each kernel's launches on the device in the phase
    (:class:`CliCalls`): the wrappers count the eager ones (the captures'
    warm-up calls) and each capture, which records one call's launches;
    each graph's kernel nodes (:func:`graph_kernels`) give one replay's,
    by which the replays are counted: each training run's graph, which its
    epochs replayed once per batch, and the captured inference's graphs
    (validation, evaluation, the forecasts)."""
    from neural_lam_tpu_torch import create_graph, predict, train_model
    from neural_lam_tpu_torch.checkpoint import CheckpointManager
    from neural_lam_tpu_torch.config import load_config_and_datastore
    from neural_lam_tpu_torch.dataset import WeatherDataset

    root = CACHE / "cli"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    config = write_mdp_store(root / "store", GRID_X, GRID_Y, splits=(35, 13, 25))
    stages = {"store build s": time.perf_counter() - t0}
    log(f"cli: mdp store {GRID_X}x{GRID_Y}, {N_STATE} state, {N_FORCING} forcing, "
        f"{N_STATIC} static features, 35/13/25 steps, zlib by time step: "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    create_graph.main(["--config_path", str(config), "--name", "multiscale"])
    stages["create_graph s"] = time.perf_counter() - t0
    log(f"cli: create_graph multiscale {stages['create_graph s']:.1f} s")

    runs, run = root / "runs", root / "runs" / "run"
    common = [
        "--config_path", str(config), "--batch_size", str(BATCH), "--ar_steps_eval", "3",
        "--val_steps_to_log", "1", "3", "--hidden_dim", str(HIDDEN),
        "--processor_layers", str(PROC_LAYERS), "--runs_root", str(runs), "--seed", "0",
    ]
    cli = CliCalls(torch, root, "cli")
    _, ds = load_config_and_datastore(config)
    train_set = WeatherDataset(ds, "train", ar_steps=1)
    train_batch = tuple(np.stack(a) for a in zip(*(train_set[i] for i in range(BATCH))))

    def train(argv):
        train_model.main(argv, device=DEVICE)

    # -- train 2 epochs, then resume for a third
    with cli.recording_trainers():
        ticks, seconds = cli(train, common + [
            "--epochs", "2", "--logger_run_name", "run"])
        cli.training_run(ticks, 2 * (len(train_set) // BATCH), train_batch, "train")
        trainer = cli.trainers[-1]
        stages["train_model 2 epochs s"] = seconds
        log(f"cli: train_model 2 epochs {seconds:.1f} s")
        # checkpoint save and load of the trained run, on the card
        scratch = CheckpointManager(root / "ckpt_timing")
        model, opt = trainer.forecaster.predictor, trainer.optimizer
        save_ms = host_ms(torch, lambda: scratch.save("latest", model, opt, 0), calls=3)
        load_ms = host_ms(torch, lambda: scratch.restore("latest", model, opt), calls=3)
        restore_only_ms = host_ms(
            torch, lambda: scratch.restore_params_only("latest", model), calls=3)
        stages.update({"checkpoint save ms": save_ms, "checkpoint restore ms": load_ms,
                       "parameters-only restore ms": restore_only_ms})
        size = (root / "ckpt_timing" / "checkpoints" / "latest" / "state.pt").stat().st_size
        log(f"cli: checkpoint of {size / 2**20:.1f} MiB (parameters and AdamW state): save "
            f"{save_ms:.1f} ms, restore {load_ms:.1f} ms, parameters only "
            f"{restore_only_ms:.1f} ms")
        del trainer, model, opt, cli.trainers[:]
        ticks, seconds = cli(train, common + [
            "--epochs", "3", "--logger_run_name", "run", "--load", str(run),
            "--restore_opt"])
        cli.training_run(ticks, len(train_set) // BATCH, train_batch, "resume")
        del cli.trainers[:]
    history = [json.loads(x) for x in (run / "history.jsonl").read_text().splitlines()]
    stages["resume 1 epoch s"] = seconds
    log(f"cli: resume --restore_opt to 3 epochs {seconds:.1f} s")
    for rec in history:
        log(f"cli epoch {rec['epoch']} on {card}: epoch_seconds {rec['epoch_seconds']:.3f}, "
            f"grid_points_per_s {rec['grid_points_per_s']:,.0f}, input_wait_seconds "
            f"{rec['input_wait_seconds']}, train_loss {rec['train_loss']:.6f}, val_loss "
            f"{rec['val_loss']:.6f}")
    if [r["epoch"] for r in history] != [0, 1, 2]:
        raise AssertionError(f"cli: epochs {[r['epoch'] for r in history]}, want 0, 1, 2")
    best = json.loads((run / "checkpoints" / "best.json").read_text())
    if best["val_loss"] != min(r["val_loss"] for r in history):
        raise AssertionError(f"cli: best.json {best}, not the least val_loss")
    if not all(np.isfinite([r["train_loss"], r["val_loss"]]).all() for r in history):
        raise AssertionError("cli: non-finite losses")

    # -- evaluate the test split at 19 steps, then export 4 forecasts
    _, seconds = cli(train, common + [
        "--eval", "test", "--load", str(run), "--ar_steps_eval", str(AR_STEPS),
        "--logger_run_name", "eval"])
    stages["eval test s"] = seconds
    metrics = json.loads((runs / "eval" / "test_metrics.json").read_text())
    log(f"cli: --eval test at {AR_STEPS} steps {seconds:.1f} s: test_loss "
        f"{metrics['test_loss']:.6f}, test_loss_unroll1 {metrics['test_loss_unroll1']:.6f}; "
        f"files {sorted(p.name for p in (runs / 'eval').iterdir())}")
    if not np.isfinite(list(metrics.values())).all():
        raise AssertionError("cli: non-finite test metrics")
    out = root / "forecasts"
    _, seconds = cli(lambda a: predict.main(a, device=DEVICE), [
        "--config_path", str(config), "--load", str(run / "checkpoints" / "min_val_loss"),
        "--ar_steps", str(AR_STEPS), "--n_samples", str(BATCH), "--out", str(out)])
    stages["predict s"] = seconds
    files = sorted(out.glob("forecast_test_*.npz"))
    log(f"cli: predict {len(files)} forecasts at {AR_STEPS} steps {seconds:.1f} s")
    if len(files) != BATCH:
        raise AssertionError(f"cli: {len(files)} forecast files, want {BATCH}")
    hold_to_cpu_rollout(torch, run, ds, files[0], "cli")
    stages.update({f"epoch {r['epoch']} {k}": r[k] for r in history
                   for k in ("epoch_seconds", "grid_points_per_s")})
    log(f"cli stages on {card}: {json.dumps(stages)}")
    launches = cli.check_launches(card)
    release(torch)
    return launches


def phase_npy_workflow(torch, card: str) -> dict[str, int]:
    """A user's MEPS workflow through the port's entry points, on one card,
    over a MEPS npy-files store written by :func:`write_npy_store` at full
    width (``grid_shape_state`` [268, 238]; 18 stored state features, 17
    kept; the npy-files forcing set; 2 members; 2, 1 and 1 analysis times
    for train, val and test; ``NPY_TIMESTEPS`` steps a forecast):

    1. ``compute_standardization_stats`` over the train split, held to
       :func:`npy_stats_float64` within ``NPY_STATS_TOL`` of each array's
       largest entry;
    2. ``create_graph``, then ``validate_graph`` (exit 0);
    3. ``train_model`` for 2 epochs (GraphLAM, hidden 64, 4 processor
       layers, batch 4; validation at 3 AR steps through the captured eval
       step);
    4. ``--eval test`` at 19 AR steps through the captured ``eval_batch``;
    5. ``predict`` of the test split (2 forecasts, one padded batch of 4)
       through the captured forecast; forecast 0 against the checkpoint on
       the CPU (:func:`hold_to_cpu_rollout`);
    6. one validation pass and one test-evaluation batch, eager against
       captured, within ``GRAPH_LOSS_RTOL`` of each output's largest entry.

    Returns each kernel's launches on the device in steps 1-5, counted as
    :class:`CliCalls` counts them."""
    from neural_lam_tpu_torch import create_graph, predict, train_model, validate_graph
    from neural_lam_tpu_torch.config import load_config_and_datastore
    from neural_lam_tpu_torch.dataset import WeatherDataset
    from neural_lam_tpu_torch.datastore.npyfilesmeps import compute_standardization_stats
    from neural_lam_tpu_torch.evaluation import make_eval_batch
    from neural_lam_tpu_torch.loader import DataLoader

    root = CACHE / "npy"
    shutil.rmtree(root, ignore_errors=True)
    store = root / "store"
    t0 = time.perf_counter()
    config = write_npy_store(store, GRID_Y, GRID_X)
    stages = {"store build s": time.perf_counter() - t0}
    size = sum(f.stat().st_size for f in store.rglob("*.npy"))
    log(f"npy: MEPS npy-files store, grid_shape_state [{GRID_X}, {GRID_Y}], "
        f"{NPY_STATE_STORED} stored state features ({NPY_STATE_STORED - len(NPY_REMOVED)} "
        f"kept), {NPY_MEMBERS} members, analysis times {NPY_SPLITS} (train, val, test), "
        f"{NPY_TIMESTEPS} steps a forecast: {size / 2**30:.2f} GiB of .npy files in "
        f"{stages['store build s']:.1f} s")

    # -- 1. the standardization statistics
    t0 = time.perf_counter()
    with open(root / "cli.log", "a", encoding="utf-8") as out, \
            contextlib.redirect_stdout(out):
        compute_standardization_stats.main(
            ["--datastore_config_path", str(store / "data_config.yaml")])
    stages["compute_standardization_stats s"] = time.perf_counter() - t0
    want = npy_stats_float64(store)
    worst = {}
    for name, ref in want.items():
        got = np.load(store / "static" / f"{name}.npy")
        err = float(np.abs(got - ref).max() / np.abs(ref).max())
        worst[name] = err
        if got.shape != ref.shape or not err <= NPY_STATS_TOL:
            raise AssertionError(f"npy stats: {name} off by {err:.3e} of its largest entry")
    log(f"npy: compute_standardization_stats {stages['compute_standardization_stats s']:.1f} "
        f"s; against float64 (share of each array's largest entry, tol {NPY_STATS_TOL}): "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))

    # -- 2. the graph
    t0 = time.perf_counter()
    create_graph.main(["--config_path", str(config), "--name", "multiscale"])
    stages["create_graph s"] = time.perf_counter() - t0
    _, ds = load_config_and_datastore(config)
    t0 = time.perf_counter()
    with open(root / "cli.log", "a", encoding="utf-8") as out, \
            contextlib.redirect_stdout(out):
        code = validate_graph.main([str(store / "graph" / "multiscale"),
                                    "--num_grid_nodes", str(ds.num_grid_points)])
    stages["validate_graph s"] = time.perf_counter() - t0
    log(f"npy: create_graph multiscale {stages['create_graph s']:.1f} s, validate_graph "
        f"exit {code} ({stages['validate_graph s']:.1f} s)")
    if code != 0:
        raise AssertionError(f"npy: validate_graph exit {code}")

    # -- 3. train with validation, 4. evaluate the test split, 5. predict
    runs, run = root / "runs", root / "runs" / "run"
    common = [
        "--config_path", str(config), "--batch_size", str(BATCH), "--ar_steps_eval", "3",
        "--val_steps_to_log", "1", "3", "--hidden_dim", str(HIDDEN),
        "--processor_layers", str(PROC_LAYERS), "--runs_root", str(runs), "--seed", "0",
    ]
    cli = CliCalls(torch, root, "npy")
    train_set = WeatherDataset(ds, "train", ar_steps=1)
    train_batch = tuple(np.stack(a) for a in zip(*(train_set[i] for i in range(BATCH))))

    def train(argv):
        train_model.main(argv, device=DEVICE)

    with cli.recording_trainers():
        ticks, seconds = cli(train, common + ["--epochs", "2", "--logger_run_name", "run"])
        cli.training_run(ticks, 2 * -(-len(train_set) // BATCH), train_batch, "train")
        trainer = cli.trainers[-1]
    del cli.trainers[:]
    stages["train_model 2 epochs s"] = seconds
    history = [json.loads(x) for x in (run / "history.jsonl").read_text().splitlines()]
    for rec in history:
        log(f"npy epoch {rec['epoch']} on {card}: epoch_seconds {rec['epoch_seconds']:.3f}, "
            f"train_loss {rec['train_loss']:.6f}, val_loss {rec['val_loss']:.6f}")
    if [r["epoch"] for r in history] != [0, 1] or not all(
            np.isfinite([r["train_loss"], r["val_loss"]]).all() for r in history):
        raise AssertionError(f"npy: history {history}")
    _, seconds = cli(train, common + [
        "--eval", "test", "--load", str(run), "--ar_steps_eval", str(AR_STEPS),
        "--logger_run_name", "eval"])
    stages["eval test s"] = seconds
    metrics = json.loads((runs / "eval" / "test_metrics.json").read_text())
    log(f"npy: --eval test at {AR_STEPS} steps {seconds:.1f} s: test_loss "
        f"{metrics['test_loss']:.6f}, test_loss_unroll1 {metrics['test_loss_unroll1']:.6f}")
    if not np.isfinite(list(metrics.values())).all():
        raise AssertionError("npy: non-finite test metrics")
    out = root / "forecasts"
    n_test = len(WeatherDataset(ds, "test", ar_steps=AR_STEPS))
    _, seconds = cli(lambda a: predict.main(a, device=DEVICE), [
        "--config_path", str(config), "--load", str(run / "checkpoints" / "min_val_loss"),
        "--ar_steps", str(AR_STEPS), "--batch_size", str(BATCH), "--out", str(out)])
    stages["predict s"] = seconds
    files = sorted(out.glob("forecast_test_*.npz"))
    log(f"npy: predict {len(files)} forecasts (the test split, one batch padded from "
        f"{n_test} to {BATCH}) at {AR_STEPS} steps {seconds:.1f} s")
    if len(files) != n_test:
        raise AssertionError(f"npy: {len(files)} forecast files, want {n_test}")
    hold_to_cpu_rollout(torch, run, ds, files[0], "npy")
    launches = cli.check_launches(card)

    # -- 6. eager against captured: a validation pass, a test-evaluation batch
    val = DataLoader(WeatherDataset(ds, "val", ar_steps=3), BATCH)
    step = trainer.eval_steps[3]
    for i, batch in enumerate(val):
        data, _ = trainer.device_put_batch(batch)
        with torch.no_grad():
            want = step.fn(*data)
        bits = same_outputs(torch, step(*data), want, "npy validation")
        log(f"npy: validation batch {i}, captured eval step against eager: {bits}")
    test = DataLoader(WeatherDataset(ds, "test", ar_steps=AR_STEPS), BATCH)
    data, _ = trainer.device_put_batch(next(iter(test)))
    eval_batch = make_eval_batch(trainer)
    got = eval_batch(*data)
    with torch.no_grad():
        want = eval_batch.fn(*data)
    log(f"npy: test-evaluation batch at {AR_STEPS} steps, captured against eager: "
        f"{same_outputs(torch, got, want, 'npy test evaluation')}")
    log(f"npy stages on {card}: {json.dumps(stages)}")
    del trainer, step, eval_batch, got, want
    shutil.rmtree(store / "samples")
    release(torch)
    return launches


def device_busy_ms(torch, fn) -> float:
    """The device time of the kernels one call of ``fn()`` launches, from
    ``torch.profiler`` (copies and fills left out)."""
    return device_kernels(torch, fn)[0]


def device_kernels(torch, fn) -> tuple[float, int]:
    """:func:`device_busy_ms` and the number of kernels it sums. (Launches
    are counted from a graph's nodes, :func:`graph_kernels`: the profiler
    can drop a record.) In a long process the profiler now and then keeps
    no device record of a call at all: such a profile is taken again, up to
    three times in all, as :func:`k4_pieces` does."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        busy, kernels = 0.0, 0
        for evt in prof.events():
            if evt.device_type != torch.autograd.DeviceType.CUDA or "#" in evt.name:
                continue
            if evt.name.startswith(("Memcpy", "Memset")):
                continue
            busy += evt.device_time_total / 1e3
            kernels += 1
        if busy > 0:
            return busy, kernels
    raise AssertionError("the profiler saw no kernel on the device in three profiles")


def host_ms(torch, fn, calls: int = TRAIN_ITERS) -> float:
    """Host time per call of ``fn()`` until enqueued: ``calls`` calls
    back to back, waited for once after the clock stops."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return 1e3 * host


def phase_route_steps(torch, model, ds, card: str) -> None:
    """GraphLAM's served AR step (one ``step`` of batch 4 under inference
    mode, as each step of a forecast runs it) and its training step
    (``Trainer.train_step`` on the bench batch) on the v1 route (K1 + K3;
    K4 + K2) and on the v2 route (projections + K7; K8 + K2), each as the
    device time of its kernels beside the host's time to enqueue it."""
    n, d = ds.num_grid_points, ds.get_num_data_vars("state")
    f = 3 * ds.get_num_data_vars("forcing")
    rng = np.random.default_rng(2)
    inputs = [torch.from_numpy(rng.normal(size=(n, BATCH, w)).astype(np.float32)).to(DEVICE)
              for w in (d, d, f)]
    data = [torch.from_numpy(a).to(DEVICE) for a in bench_batch(ds)]
    for route, label in (("off", "v1"), ("on", "v2")):
        with fused_v2(route):
            def serve():
                with torch.inference_mode():
                    model.step(*inputs)

            trainer = make_trainer(model, ds)

            def train():
                trainer.train_step(*data)

            got = [device_busy_ms(torch, serve), host_ms(torch, serve),
                   device_busy_ms(torch, train), host_ms(torch, train)]
        log(
            f"route {label} per step on {card}: served AR step: device {got[0]:.3f} ms, "
            f"host until enqueued {got[1]:.3f} ms; training step: device {got[2]:.3f} "
            f"ms, host until enqueued {got[3]:.3f} ms"
        )
        del trainer
    torch.cuda.empty_cache()


def phase_unfused_shapes(torch, ds) -> None:
    """Shapes the fused kernels do not take go the unfused route before
    any launch (``fused_kernels.kernels_take``), on the card as the JAX
    package routes them: ``GraphLAM(hidden_dim=32)`` on the MEPS datastore
    serves two AR steps (``ARForecaster``, batch 2) and takes a training
    step (the loss and gradients of the bench batch, then one
    ``Trainer.train_step``), and ``apply_interaction_net`` runs forward and
    backward at batch 33 on the m2m set. Each against the same call on the
    CPU, with the launches of the route taken: K1, K5 and K6 (K2 backward),
    no K3 or K7."""
    from neural_lam_tpu_torch.models import ARForecaster, GraphLAM
    from neural_lam_tpu_torch.ops.interaction import InteractionNet, apply_interaction_net

    counters = kernel_counters()
    fused = ("K3 fused_edge_phase", "K7 fused_edge_phase_v2")

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {name: c.launches for name, c in counters.items()}
        if any(got[k] for k in fused) or not all(
                got[k] for k in ("K1 sender_gather", "K5 segment_sum", "K6 receiver_expand")):
            raise AssertionError(f"unfused route not taken: {got}")
        return out, got

    torch.manual_seed(GATE_SEED)
    models = {"cpu": GraphLAM(ds, hidden_dim=32, processor_layers=PROC_LAYERS, device="cpu")}
    models[DEVICE] = GraphLAM(ds, hidden_dim=32, processor_layers=PROC_LAYERS, device=DEVICE)
    models[DEVICE].load_state_dict(models["cpu"].state_dict())
    inputs = gate_rollout_inputs(ds, 2, 2)

    def forecast(device):
        with torch.inference_mode():
            pred, _ = ARForecaster(models[device], ds)(
                *(torch.from_numpy(a).to(device) for a in inputs))
        return pred.cpu().numpy()

    def train(device):
        return train_gate_run(torch, make_trainer(models[device], ds, reload=False), 2, 2)

    got_pred, launches = counted(lambda: forecast(DEVICE))
    want_pred = forecast("cpu")
    scale = np.abs(want_pred).mean()
    mean_rel = float(np.abs(got_pred - want_pred).mean() / scale)
    max_rel = float(np.abs(got_pred - want_pred).max() / scale)
    if not np.isfinite(got_pred).all() or mean_rel > GATE_STATE_MEAN_REL or (
            max_rel > GATE_STATE_MAX_REL):
        raise AssertionError(f"GraphLAM(hidden_dim=32) forecast: mean_rel {mean_rel}, "
                             f"max_rel {max_rel}")
    log(f"unfused shapes: GraphLAM(hidden_dim=32) serves 2 AR steps of batch 2 on the "
        f"card: against the CPU mean_rel {mean_rel:.3e}, max_rel {max_rel:.3e} (limits "
        f"{GATE_STATE_MEAN_REL}, {GATE_STATE_MAX_REL}); launches {launches}")
    (got_losses, got_grads), launches = counted(lambda: train(DEVICE))
    want_losses, want_grads = train("cpu")
    rels = np.abs(np.array(got_losses) - want_losses) / np.abs(want_losses)
    grad_rel = max(float(np.abs(got_grads[k] - w).max() / max(np.abs(w).max(), 1e-30))
                   for k, w in want_grads.items())
    if rels[0] > TRAIN_LOSS_RTOL or rels[1] > TRAIN_TRAJ_RTOL or grad_rel > TRAIN_GRAD_TOL:
        raise AssertionError(f"GraphLAM(hidden_dim=32) training: loss rel {rels}, "
                             f"gradients {grad_rel}")
    log(f"unfused shapes: GraphLAM(hidden_dim=32) training step of batch 2 on the card: "
        f"loss rel {rels[0]:.3e} (tol {TRAIN_LOSS_RTOL}), worst gradient {grad_rel:.3e} of "
        f"its largest value (tol {TRAIN_GRAD_TOL}), loss after one AdamW step rel "
        f"{rels[1]:.3e} (tol {TRAIN_TRAJ_RTOL}); launches {launches}")

    es = models[DEVICE].graph.m2m[0].edges
    n_mesh, b, h = es.num_rec, 33, HIDDEN
    rng = np.random.default_rng(33)
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((n_mesh, b, h), (n_mesh, b, h), (es.num_edges, h), (n_mesh, b, h))]
    net = InteractionNet(h, generator=torch.Generator().manual_seed(GATE_SEED))

    def step(device):
        net.to(device).zero_grad(set_to_none=True)
        t = [torch.from_numpy(a).to(device) for a in arrays]
        leaves = [x.requires_grad_(True) for x in t[:3]]
        new_rec, new_edge = apply_interaction_net(net, es.to(device), *leaves)
        ((new_rec * t[3]).sum() + new_edge.sum()).backward()
        grads = [x.grad for x in leaves] + [p.grad for p in net.parameters()]
        return [x.detach().cpu() for x in (new_rec, new_edge, *grads)]

    got, launches = counted(lambda: step(DEVICE))
    want = step("cpu")
    out_err = max(errors(g, w)[0] for g, w in zip(got[:2], want[:2]))
    grad_rel = max(errors(g, w)[1] for g, w in zip(got[2:], want[2:]))
    if out_err > K3_ATOL or grad_rel > K4_TOL:
        raise AssertionError(f"batch 33: outputs off by {out_err}, gradients by {grad_rel}")
    log(f"unfused shapes: apply_interaction_net at batch 33 on the m2m set (E "
        f"{es.num_edges}): outputs within {out_err:.3g} of the CPU's (tol {K3_ATOL}), "
        f"gradients within {grad_rel:.3g} of their largest value (tol {K4_TOL}); "
        f"launches {launches}")
    del models, net
    torch.cuda.empty_cache()


# -- the reduced-precision path: bf16 variants of K1-K4, bf16 training ----------


def bf16_bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time in ms for ``nbytes`` moved and ``flops`` done as bf16
    products on the tensor cores (the dense bf16 rate), and which of the
    two sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def bf16_check(got, want, what: str) -> float:
    """``got`` against ``want`` (same dtype): the max error within
    ``BF16_TOL`` of the largest entry and the mean within
    ``BF16_MEAN_TOL`` of it; returns the max abs error."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} against "
                             f"{want.dtype} {tuple(want.shape)}")
    err = (got.float() - want.float()).abs()
    scale = max(want.float().abs().max().item(), 1e-30)
    worst, mean = err.max().item(), err.mean().item()
    if not (worst <= BF16_TOL * scale and mean <= BF16_MEAN_TOL * scale):
        raise AssertionError(
            f"{what}: max err {worst / scale:.3e} (tol {BF16_TOL}), mean "
            f"{mean / scale:.3e} (tol {BF16_MEAN_TOL}) of the largest entry"
        )
    return worst


def bf16_entry(name: str, source: str, replaces: str, acc: dict, library) -> dict:
    return dict(
        name=name, route="cuda", source=f"neural_lam_tpu_torch/csrc/{source}",
        replaces=replaces, launches=0, max_abs_err=acc["err"], ms=acc["ms"],
        plain_ms=acc["plain_ms"], bound_ms=acc["bound_ms"],
        bound_by="operations" if acc["ops_ms"] > acc["bytes_ms"] else "bytes",
        library_ms=library,
    )


def parent_ms(parent, fn):
    """``fn``'s time through the parent commit's kernels (:func:`parent_kernels`),
    or None without a parent."""
    if parent is None:
        return None
    with parent["use"]():
        return cuda_ms(fn)


def ptxas_report(source: str) -> dict[str, tuple[int, int, int]]:
    """Each kernel entry of ``csrc/<source>.cu``'s build: registers, spill
    stores and spill loads in bytes, from the compiler's ``-Xptxas -v``
    report."""
    from neural_lam_tpu_torch.ops import kernel_build

    out, entry, spills = {}, None, (-1, -1)
    for line in kernel_build.build_log(source).splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1]
        elif "spill stores" in line:
            found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            spills = (int(found.group(1)), int(found.group(2)))
        elif "Used" in line and entry is not None:
            out[entry] = (int(re.search(r"Used (\d+) registers", line).group(1)), *spills)
            entry, spills = None, (-1, -1)
    return out


def mangled_args(row: dict) -> str:
    """The template arguments of an instantiation of K3, K7 or of K4's or
    K8's main kernel (a row of ``fused_kernels.instantiation_occupancy``)
    as they appear in its mangled name."""
    ti = "13__nv_bfloat16" if row["io_bf16"] else "f"
    if row["kernel"] == "K3":
        return (f"fused_edge_fwdILi{row['mode']}ELb{row['bf16_ops']}ELb"
                f"{int(row['pre'] == 'bf16')}E{ti}E")
    if row["kernel"] == "K7":
        return f"fused_edge_v2_fwdILi{row['mode']}ELb{row['bf16_ops']}E{ti}E"
    if row["kernel"] == "K8":
        return f"fused_edge_v2_bwd_mainILb{int(row['mode'] == 2)}ELb{row['bf16_ops']}E{ti}E"
    pre = {"float32": 0, "bf16": 1, "recompute": 2}[row["pre"]]
    # the saved-pre kernels serve the raw mode with the shared one
    mode = 1 if row["mode"] == 0 and pre != 2 else row["mode"]
    if row["bf16_ops"]:
        return f"fused_edge_bwd_main_bfILi{mode}ELi{pre}E{ti}E"
    return f"fused_edge_bwd_mainILi{mode}ELi{pre}E{ti}E"


def log_occupancy(what: str, keep) -> None:
    """Blocks, warps, registers, shared and local memory per instantiation
    of K3 and of K4's main kernel with bf16 operands for which ``keep(row)``
    holds (the CUDA runtime's), and its spill stores and loads (the
    compiler's report: AssertionError unless exactly one of its entries is
    the instantiation, with its spills)."""
    from neural_lam_tpu_torch.ops import fused_kernels as fk

    reports = {}
    for row in fk.instantiation_occupancy(bf16_ops=True):
        if not keep(row):
            continue
        if row["source"] not in reports:
            reports[row["source"]] = ptxas_report(row["source"])
        args = mangled_args(row)
        found = [v for k, v in reports[row["source"]].items() if args in k]
        if len(found) != 1 or found[0][1] < 0:
            raise AssertionError(f"{what} occupancy {row['name']}: {len(found)} entries of "
                                 f"the {row['source']}.cu build's report match {args}, or "
                                 "its spills are missing")
        _, stores, loads = found[0]
        log(f"{what} occupancy {row['name']}: {row['blocks']} block(s) of {row['threads']} "
            f"threads = {row['warps']} warps per SM, {row['regs']} registers a thread, "
            f"{row['smem']} bytes of shared memory a block, {row['local']} bytes of local "
            f"memory a thread; spill stores {stores} bytes, spill loads {loads} bytes")


def log_node_occupancy(what: str) -> None:
    """Blocks, warps, registers, shared and local memory of every
    instantiation of the node-MLP route's node update and node backward
    (``fused_kernels.node_occupancy``: float32 and both bf16-operand forms),
    and its spill stores and loads from the compiler's report of its build
    (AssertionError unless exactly one entry of it is the instantiation)."""
    from neural_lam_tpu_torch.ops import fused_kernels as fk

    reports = {src: ptxas_report(src) for src in ("fused_node", "fused_node_bwd")}
    for row in fk.node_occupancy():
        ti = "13__nv_bfloat16" if row["io_bf16"] else "f"
        fwd = row["name"].startswith("K3")
        args = f"fused_node_{'fwd' if fwd else 'bwd'}ILb{row['bf16_ops']}E{ti}E"
        found = [v for k, v in reports["fused_node" if fwd else "fused_node_bwd"].items()
                 if args in k]
        if len(found) != 1 or found[0][1] < 0:
            raise AssertionError(f"{what} occupancy {row['name']}: {len(found)} entries of "
                                 f"the build's report match {args}, or its spills are missing")
        _, stores, loads = found[0]
        log(f"{what} occupancy {row['name']}: {row['blocks']} block(s) of {row['threads']} "
            f"threads = {row['warps']} warps per SM, {row['regs']} registers a thread, "
            f"{row['smem']} bytes of shared memory a block, {row['local']} bytes of local "
            f"memory a thread; spill stores {stores} bytes, spill loads {loads} bytes")


def log_tail_occupancy(what: str, bf16_ops: bool) -> None:
    """Blocks, warps, registers, shared and local memory of each piece of
    K4's tail (``fused_kernels.tail_occupancy``) with or without bf16
    operands, and its spill stores and loads from the compiler's report of
    the fused_edge_bwd.cu build (AssertionError unless exactly one entry of
    it is the instantiation)."""
    from neural_lam_tpu_torch.ops import fused_kernels as fk

    report = ptxas_report("fused_edge_bwd")
    for row in fk.tail_occupancy(bf16_ops=bf16_ops):
        ti = "13__nv_bfloat16" if "bf16 streams" in row["name"] else "f"
        bf = int(bf16_ops)
        if "edge pass" in row["name"]:
            args = f"fused_edge_bwd_edgeILb{int('raw' in row['name'])}ELb{bf}E{ti}E"
        elif "rows pass" in row["name"]:
            args = f"fused_edge_bwd_rowsILb{bf}E{ti}E"
        else:
            args = f"fused_edge_bwd_receiverI{ti}E"
        found = [v for k, v in report.items() if args in k]
        if len(found) != 1 or found[0][1] < 0:
            raise AssertionError(f"{what} occupancy {row['name']}: {len(found)} entries of the "
                                 f"fused_edge_bwd.cu build's report match {args}")
        _, stores, loads = found[0]
        log(f"{what} tail occupancy {row['name']}: {row['blocks']} block(s) of "
            f"{row['threads']} threads = {row['warps']} warps per SM, {row['regs']} registers "
            f"a thread, {row['smem']} bytes of shared memory a block, {row['local']} bytes of "
            f"local memory a thread; spill stores {stores} bytes, spill loads {loads} bytes")


def bf16_row_kernels(torch, g, parent, randn) -> tuple[dict, dict]:
    """K1 and K2 on bf16 rows at the sites of GraphLAM's graph ``g`` (g2m,
    m2m four times a step, m2g) at batch 4, on rows drawn by ``randn``: K1
    against the plain version's bits, K2 within the bf16 bounds and
    ``K2_TOL`` of its plain version and the same bits run after run. Each
    timed by device time (:func:`device_ms`) and by CUDA events around
    back-to-back calls (:func:`cuda_ms`), beside its bound and the float32
    kernel on the same rows, and with ``parent`` (:func:`parent_kernels`)
    the parent commit's kernels the same way, in turns (parent, current,
    current, parent: each time the mean of the two); with ``parent`` the
    float32 K1 and K2 are held to the parent's bits. Returns the per-step
    sums of K1 (an AR step) and K2 (a training step), with the keys of
    :func:`phase_bf16_kernels`' accumulators and ``dev_ms``,
    ``parent_dev_ms``, ``parent_ms``, ``f32_dev_ms``, ``parent_f32_dev_ms``,
    ``parent_f32_ms``, ``f32_bound_ms``."""
    from neural_lam_tpu_torch.ops.segment_kernels import (
        sender_gather,
        sender_gather_plain,
        sender_scatter,
        sender_scatter_plain,
    )

    bf16 = torch.bfloat16
    sites = [("g2m", g.g2m, g.num_grid_nodes, 1),
             ("m2m", g.m2m[0], g.num_mesh_nodes, PROC_LAYERS),
             ("m2g", g.m2g, g.num_mesh_nodes, 1)]
    keys = ("ms", "dev_ms", "parent_ms", "parent_dev_ms", "f32_ms", "f32_dev_ms",
            "parent_f32_ms", "parent_f32_dev_ms", "plain_ms", "library_ms", "bound_ms",
            "f32_bound_ms", "ops_ms", "bytes_ms", "err")

    def timed(fn) -> dict:
        """Device and event ms of ``fn`` and, with a parent, the parent's,
        in turns."""
        if parent is None:
            return dict(dev=device_ms(torch, fn), ev=cuda_ms(fn))
        got = {}
        for turn in ("parent", "this", "this", "parent"):
            ctx = parent["use"]() if turn == "parent" else contextlib.nullcontext()
            with ctx:
                got.setdefault(turn, []).append((device_ms(torch, fn), cuda_ms(fn)))
        (d0, e0), (d1, e1) = got["this"]
        (p0, q0), (p1, q1) = got["parent"]
        return dict(dev=(d0 + d1) / 2, ev=(e0 + e1) / 2, parent_dev=(p0 + p1) / 2,
                    parent_ev=(q0 + q1) / 2)

    def share(b_ms, ms):
        return f"{100 * b_ms / ms:.1f} %"

    def line(what, t, t32, b_ms, b32_ms, moved, moved32):
        """The site's line; every device time held to its bound where the
        bytes do not fit in the L2 (:func:`check_device_time`)."""
        for key, turn in (("dev", "this commit's"), ("parent_dev", "the parent's")):
            if key in t:
                check_device_time(f"{what}: {turn} bf16 kernel", t[key], b_ms, moved)
                check_device_time(f"{what}: {turn} float32 kernel", t32[key], b32_ms,
                                  moved32)
        text = (f"{what}: device {t['dev']:.4f} ms, events {t['ev']:.4f} ms, bound "
                f"{b_ms:.4f} ms ({share(b_ms, t['dev'])} of it by device time"
                + (f"; {moved / 1e6:.1f} MB fit in the L2" if moved <= L2_BYTES else "")
                + ")")
        if parent is not None:
            text += (f"; the parent's device {t['parent_dev']:.4f} ms "
                     f"({share(b_ms, t['parent_dev'])}), events {t['parent_ev']:.4f} ms, "
                     f"{t['parent_dev'] / t['dev']:.3f} x by device time")
        text += (f"; float32 kernel device {t32['dev']:.4f} ms, events {t32['ev']:.4f} ms, "
                 f"bound {b32_ms:.4f} ms ({share(b32_ms, t32['dev'])})")
        if parent is not None:
            text += (f", the parent's device {t32['parent_dev']:.4f} ms, events "
                     f"{t32['parent_ev']:.4f} ms")
        return text

    def add(a, calls, t, t32, plain_ms, lib_ms, b_ms, b32_ms, err):
        for key, val in (("ms", t["ev"]), ("dev_ms", t["dev"]),
                         ("parent_ms", t.get("parent_ev", 0.0)),
                         ("parent_dev_ms", t.get("parent_dev", 0.0)),
                         ("f32_ms", t32["ev"]), ("f32_dev_ms", t32["dev"]),
                         ("parent_f32_ms", t32.get("parent_ev", 0.0)),
                         ("parent_f32_dev_ms", t32.get("parent_dev", 0.0)),
                         ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("bound_ms", b_ms), ("bytes_ms", b_ms), ("f32_bound_ms", b32_ms)):
            a[key] += calls * val
        a["err"] = max(a["err"], err)

    k1 = dict.fromkeys(keys, 0.0)
    same32 = 0
    for site, ge, n_send, calls in sites:
        x32 = randn(n_send, BATCH, HIDDEN)
        x = x32.to(bf16)
        idx = ge.edges.senders
        got = sender_gather(x, idx)
        torch.cuda.synchronize()
        if got.dtype != bf16 or not torch.equal(got, sender_gather_plain(x, idx)):
            raise AssertionError(f"K1 bf16 {site}: not the plain version's bits")
        same32 += same_as_parent(parent, lambda: sender_gather(x32, idx), f"K1 {site}")
        t = timed(lambda: sender_gather(x, idx))
        t32 = timed(lambda: sender_gather(x32, idx))
        plain_ms = cuda_ms(lambda: sender_gather_plain(x, idx))
        lib_ms = cuda_ms(lambda: torch.index_select(x, 0, idx.long()))
        moved, moved32 = nbytes(x, idx, got), nbytes(x32, idx) + 4 * got.numel()
        b_ms, _ = bf16_bound(moved, 0.0)
        b32_ms, _ = bound(moved32, 0.0)
        log(line(f"K1 sender_gather bf16 {site}: x {tuple(x.shape)} bf16, the plain "
                 f"version's bits", t, t32, b_ms, b32_ms, moved, moved32)
            + f"; plain {plain_ms:.4f} ms, index_select {lib_ms:.4f} ms; {calls} call(s) "
            f"per AR step")
        add(k1, calls, t, t32, plain_ms, lib_ms, b_ms, b32_ms, 0.0)
        del x, x32, got

    k2 = dict.fromkeys(keys, 0.0)
    for site, ge, n_send, calls in sites:
        es = ge.edges
        g32 = randn(es.num_edges, BATCH, HIDDEN)
        grad = g32.to(bf16)
        got = sender_scatter(grad, es, n_send)
        want = sender_scatter_plain(grad, es.senders, n_send)
        torch.cuda.synchronize()
        err = bf16_check(got, want, f"K2 bf16 {site}")
        rel = errors(got, want)[1]
        if rel > K2_TOL:
            raise AssertionError(f"K2 bf16 {site}: {rel:.3g} of the largest sum off the "
                                 f"plain version (tol {K2_TOL})")
        if not torch.equal(got, sender_scatter(grad, es, n_send)):
            raise AssertionError(f"K2 bf16 {site}: two runs differ")
        same = ""
        if parent is not None:
            same32 += same_as_parent(parent, lambda: sender_scatter(g32, es, n_send),
                                     f"K2 {site}")
            old = parent["K2"](grad, es, n_send)
            same = ", the parent's bits" if torch.equal(got, old) else (
                f", {errors(got, old)[1]:.3g} of the largest sum off the parent's")
        idx_long = es.senders.long()
        t = timed(lambda: sender_scatter(grad, es, n_send))
        t32 = timed(lambda: sender_scatter(g32, es, n_send))
        plain_ms = cuda_ms(lambda: sender_scatter_plain(grad, es.senders, n_send))
        # index_add_ takes one dtype: the widening copy is part of the call
        lib_ms = cuda_ms(lambda: torch.zeros_like(got).index_add_(0, idx_long, grad.float()))
        moved = nbytes(grad, es.send_perm, es.send_rowptr, got)
        moved32 = nbytes(g32, es.send_perm, es.send_rowptr, got)
        b_ms, _ = bf16_bound(moved, grad.numel())
        b32_ms, _ = bound(moved32, g32.numel())
        log(line(f"K2 sender_scatter bf16 {site}: g {tuple(grad.shape)} bf16 -> float32 "
                 f"sums, max abs err {err:.3g} (tol {BF16_TOL} of the largest sum; "
                 f"{rel:.3g} of it, tol {K2_TOL}), repeatable{same}", t, t32, b_ms, b32_ms,
                 moved, moved32)
            + f"; plain {plain_ms:.4f} ms, index_add_ into float32 {lib_ms:.4f} ms; "
            f"{calls} call(s) per training step")
        add(k2, calls, t, t32, plain_ms, lib_ms, b_ms, b32_ms, err)
        del grad, g32, got, want

    for name, a, step in (("K1", k1, "AR step"), ("K2", k2, "training step")):
        text = (f"{name} bf16 per {step}: device {a['dev_ms']:.4f} ms, events "
                f"{a['ms']:.4f} ms, bound {a['bound_ms']:.4f} ms "
                f"({share(a['bound_ms'], a['dev_ms'])} of it by device time)")
        if parent is not None:
            text += (f"; the parent's device {a['parent_dev_ms']:.4f} ms "
                     f"({share(a['bound_ms'], a['parent_dev_ms'])}), events "
                     f"{a['parent_ms']:.4f} ms, {a['parent_dev_ms'] / a['dev_ms']:.3f} x "
                     f"by device time, same call")
        text += (f"; float32 {name} device {a['f32_dev_ms']:.4f} ms, events "
                 f"{a['f32_ms']:.4f} ms, bound {a['f32_bound_ms']:.4f} ms "
                 f"({share(a['f32_bound_ms'], a['f32_dev_ms'])})")
        if parent is not None:
            text += (f", the parent's device {a['parent_f32_dev_ms']:.4f} ms, events "
                     f"{a['parent_f32_ms']:.4f} ms")
        log(text)
    if parent is not None:
        log(f"float32 K1 and K2 against the parent's kernels on the same inputs at "
            f"{len(sites)} site shapes: {same32} outputs, every one the same bits")
    return k1, k2


def phase_bf16_kernels(torch, model, parent=None) -> list[dict]:
    """The bf16 variants of K1-K4, K7 and K8 against their plain versions
    at the shapes of the six GraphLAM calls at batch 4, in each
    instantiation: K1 and K2 on bf16 rows; K3, K4, K7 and K8 with bf16
    operands on bf16 streams (mixed precision, bf16 out; also ``high``'s
    float32 out, checked) and on float32 streams (``high-kernels``). Each
    beside the float32 kernel's time on the same shapes in the same call,
    its plain version's and, for K1 and K2, ``index_select`` and
    ``index_add_``; times summed over the calls of one AR step (K1, K3,
    K7) or one training step (K2, K4, K8). K1 and K2 by
    :func:`bf16_row_kernels`. K3, K4, K7 and K8 are also timed through the
    ``parent`` commit's kernels where one is given (:func:`parent_kernels`),
    and each of their bf16 instantiations' occupancy, registers and spills
    is printed."""
    from neural_lam_tpu_torch.ops import fused_kernels as fk

    bf16 = torch.bfloat16
    g, dev, d, b = model.graph, model.device, HIDDEN, BATCH
    gen = torch.Generator(device=dev).manual_seed(10)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def acc():
        return dict(ms=0.0, f32_ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                    ops_ms=0.0, bytes_ms=0.0, err=0.0, parent_ms=0.0)

    def add(a, calls, ms, f32_ms, plain_ms, b_ms, b_by, err, lib_ms=0.0, old_ms=None):
        a["ms"] += calls * ms
        a["parent_ms"] += calls * (old_ms or 0.0)
        a["f32_ms"] += calls * f32_ms
        a["plain_ms"] += calls * plain_ms
        a["library_ms"] += calls * lib_ms
        a["bound_ms"] += calls * b_ms
        a["ops_ms" if b_by == "operations" else "bytes_ms"] += calls * b_ms
        a["err"] = max(a["err"], err)

    n_grid, n_mesh = g.num_grid_nodes, g.num_mesh_nodes
    m2m = g.m2m[0]
    proc = list(model.processor.values())
    k1, k2 = bf16_row_kernels(torch, g, parent, randn)

    k3_sites = [
        ("g2m", model.g2m_gnn, g.g2m, model.g2m_embedder, "raw", False, 1, n_mesh),
        ("m2m layer 0", proc[0], m2m, model.m2m_embedder, "raw", True, 1, n_mesh),
        ("m2m layers 1-3", proc[1], m2m, None, "batched", True, PROC_LAYERS - 1, n_mesh),
        ("m2g", model.m2g_gnn, g.m2g, model.m2g_embedder, "raw", False, 1, n_grid),
    ]
    n_mid = PROC_LAYERS - 2
    k4_sites = [
        ("g2m", model.g2m_gnn, g.g2m, model.g2m_embedder, "raw", False, False, 1, n_mesh),
        ("m2m layer 0", proc[0], m2m, model.m2m_embedder, "raw", True, True, 1, n_mesh),
        (f"m2m layers 1-{n_mid}", proc[1], m2m, None, "batched", True, True, n_mid, n_mesh),
        (f"m2m layer {PROC_LAYERS - 1}", proc[-1], m2m, None, "batched", True, False, 1,
         n_mesh),
        ("m2g", model.m2g_gnn, g.m2g, model.m2g_embedder, "raw", False, False, 1, n_grid),
    ]

    # K7 and K8: (site, net, edges, embedder, edge input, update_edges,
    # d_new_edge given, calls, senders, receivers), as phase_v2_kernels
    v2_sites = [(*site[:-1], n_send, site[-1]) for site, n_send in zip(
        k4_sites, (n_grid, n_mesh, n_mesh, n_mesh, n_mesh))]

    def k3_flops(mode, n_e, n_rec, feat):
        rows = n_e * b
        flops = 2 * n_rec * b * d * d + 2 * rows * d * d * 2 + rows * d
        if mode == "raw":
            return flops + n_e * (2 * feat * d + 4 * d * d)
        return flops + 2 * rows * d * d

    def k4_flops(mode, n_e, n_rec, feat):
        rows = n_e * b
        flops = 2 * rows * d * d * 5 + 2 * n_rec * b * d * d * 2 + rows * d
        if mode == "raw":
            return flops + n_e * (2 * d * d * 5 + 2 * feat * d * 2)
        return flops + 2 * rows * d * d * 2

    report = []
    tails = {"bf16": {}, "bf16 operands": {}}
    # (instantiation, stream dtype, weights as bf16 copies)
    for label, io, copies in (("bf16", bf16, True), ("bf16 operands", torch.float32, False)):
        k3, k4 = acc(), acc()
        for site, net, ge, emb, mode, update, calls, n_rec in k3_sites:
            es, raw = ge.edges, mode == "raw"
            n_e = es.num_edges
            wts = [None if w is None else (w.to(bf16).float() if copies else w.float())
                   for w in fk._weights(net.edge_mlp, emb)]
            x_send, rec = randn(n_e, b, d, dtype=io), randn(n_rec, b, d, dtype=io)
            edge_in = ge.features.to(io) if raw else randn(n_e, b, d, dtype=io)

            def run(out=io, pre=False):
                return fk.fused_edge_fwd(edge_in, x_send, rec, es, wts, raw, update, False,
                                         save_pre=pre, bf16_ops=True, out_dtype=out)

            def plain():
                return fk._plain(edge_in.float(), x_send.float(), rec.float(), es.receivers,
                                 wts, raw, update, False, bf16_ops=True)

            outs = [io] if io == torch.float32 else [bf16, torch.float32]  # mixed, high
            err = 0.0
            for out in outs:
                got, want = run(out)[:2], plain()
                torch.cuda.synchronize()
                err = max(err, bf16_check(got[0], want[0].to(out), f"K3 {label} {site} aggr"))
                if update:
                    err = max(err, bf16_check(got[1], want[1].to(out),
                                              f"K3 {label} {site} new_edge"))
            x32, r32 = x_send.float(), rec.float()
            e32 = edge_in.float()
            ms = cuda_ms(run)
            pre_ms = cuda_ms(lambda: run(pre=True))
            old_ms, old_pre_ms = parent_ms(parent, run), parent_ms(parent, lambda: run(pre=True))
            f32_ms = cuda_ms(lambda: fk.fused_edge_fwd(e32, x32, r32, es, wts, raw, update,
                                                       False))
            plain_ms = cuda_ms(plain)
            got = run()
            moved = nbytes(x_send, rec, edge_in, es.rowptr, *[w for w in wts if w is not None],
                           got[0], got[1])
            b_ms, b_by = bf16_bound(moved, k3_flops(mode, n_e, n_rec, edge_in.shape[-1]))
            log(f"K3 fused_edge_phase {label} {site}: E {n_e}, receivers {n_rec}, edge input "
                f"{mode}, streams {str(io)[6:]}, update_edges {update}; max abs err "
                f"{err:.3g} (tol {BF16_TOL} of the largest entry{', bf16 and float32 out' if len(outs) == 2 else ''}); "
                f"kernel {ms:.4f} ms, with the pre output {pre_ms:.4f} ms (float32 kernel "
                f"{f32_ms:.4f} ms; parent {old_ms or 0.0:.4f} ms, with pre "
                f"{old_pre_ms or 0.0:.4f} ms, 0 = not measured); plain {plain_ms:.4f} ms; "
                f"bound {b_ms:.4f} ms ({b_by}, "
                f"{moved / 1e6:.1f} MB, bf16 tensor cores; {100 * b_ms / ms:.1f} % of it); "
                f"{calls} call(s) per AR step")
            add(k3, calls, ms, f32_ms, plain_ms, b_ms, b_by, err, old_ms=old_ms)
            del x_send, rec, edge_in, got, want, x32, r32, e32

        for site, net, ge, emb, mode, update, has_dne, calls, n_rec in k4_sites:
            es, raw = ge.edges, mode == "raw"
            n_e = es.num_edges
            wts = [None if w is None else (w.to(bf16).float() if copies else w.float())
                   for w in fk._weights(net.edge_mlp, emb)]
            x_send, rec = randn(n_e, b, d, dtype=io), randn(n_rec, b, d, dtype=io)
            edge_in = ge.features.to(io) if raw else randn(n_e, b, d, dtype=io)
            d_aggr = randn(n_rec, b, d, dtype=io)
            d_new = randn(n_e, b, d, dtype=io) if has_dne else None
            _, _, pre = fk.fused_edge_fwd(edge_in, x_send, rec, es, wts, raw, update, False,
                                          save_pre=True, bf16_ops=True)

            def run_k4():
                return fk.fused_edge_bwd(d_aggr, d_new, pre, edge_in, x_send, rec, es, wts,
                                         raw, False, bf16_ops=True)

            d_edge, d_send, d_rec, w_grads = run_k4()
            leaves = [t.float().requires_grad_(True) for t in
                      ([x_send, rec] + ([] if raw else [edge_in]))]
            params = [w.detach().requires_grad_(True) for w in wts if w is not None]
            p_iter = iter(params)
            p_wts = [None if w is None else next(p_iter) for w in wts]
            with torch.enable_grad():
                aggr_p, new_p = fk._plain(
                    edge_in.float() if raw else leaves[2], leaves[0], leaves[1],
                    es.receivers, p_wts, raw, update, False, bf16_ops=True,
                )
                outs, seeds = [aggr_p], [d_aggr.float()]
                if has_dne:
                    outs.append(new_p)
                    seeds.append(d_new.float())

            def run_plain():
                with torch.enable_grad():
                    return torch.autograd.grad(outs, leaves + params, seeds, retain_graph=True)

            want = run_plain()
            torch.cuda.synchronize()
            # the streams' gradients in their dtype, the rest float32
            got = [d_send, d_rec] + ([] if raw else [d_edge])
            got += [w for w in w_grads if w is not None]
            want = [w.to(o.dtype) for o, w in zip(got, want)]
            err = max(bf16_check(o, w, f"K4 {label} {site} gradient {i}")
                      for i, (o, w) in enumerate(zip(got, want)))
            again = run_k4()
            if not all(torch.equal(x, y) for x, y in zip(
                    [d_send, d_rec, *[w for w in w_grads if w is not None]],
                    [again[1], again[2], *[w for w in again[3] if w is not None]])):
                raise AssertionError(f"K4 {label} {site}: two runs differ")
            x32, r32, e32 = x_send.float(), rec.float(), edge_in.float()
            da32 = d_aggr.float()
            dn32 = None if d_new is None else d_new.float()
            ms = cuda_ms(run_k4)
            old_ms = parent_ms(parent, run_k4)
            f32_ms = cuda_ms(lambda: fk.fused_edge_bwd(da32, dn32, pre, e32, x32, r32, es, wts,
                                                       raw, False))
            plain_ms = cuda_ms(run_plain)
            moved = nbytes(pre, x_send, rec, edge_in, d_aggr, d_new, es.rowptr, *params, *got)
            b_ms, b_by = bf16_bound(moved, k4_flops(mode, n_e, n_rec, edge_in.shape[-1]))
            log(f"K4 fused_edge_phase backward {label} {site}: E {n_e}, receivers {n_rec}, "
                f"edge input {mode}, streams {str(io)[6:]}, d_new_edge "
                f"{'given' if has_dne else 'none'}; max abs err {err:.3g} (tol {BF16_TOL} of "
                f"each gradient's largest entry), repeatable; kernel {ms:.4f} ms (float32 "
                f"kernel {f32_ms:.4f} ms; parent {old_ms or 0.0:.4f} ms, 0 = not measured); "
                f"plain (autograd) {plain_ms:.4f} ms; bound "
                f"{b_ms:.4f} ms ({b_by}, {moved / 1e6:.1f} MB; {100 * b_ms / ms:.1f} % of "
                f"it); {calls} call(s) per training step")
            add(k4, calls, ms, f32_ms, plain_ms, b_ms, b_by, err, old_ms=old_ms)
            log_k4_split(torch, f"K4 {label} {site}", run_k4, parent, calls, k4_tail_bounds(
                torch, es, n_rec, b, raw, edge_in, d_new, io, True), tails[label])
            del x_send, rec, edge_in, d_aggr, d_new, pre, outs, want, got, again, leaves
            del d_edge, d_send, d_rec, w_grads, aggr_p, new_p, params, p_wts
            torch.cuda.empty_cache()
        log(f"K3 {label} per AR step {k3['ms']:.4f} ms against the float32 kernel's "
            f"{k3['f32_ms']:.4f} ms (bound {k3['bound_ms']:.4f}); K4 {label} per training "
            f"step {k4['ms']:.4f} ms against {k4['f32_ms']:.4f} ms (bound "
            f"{k4['bound_ms']:.4f})")
        log_k4_tail(f"K4 {label}", tails[label], parent)
        if parent is not None:
            log(f"K3 {label} per AR step {k3['ms']:.4f} ms against the parent's "
                f"{k3['parent_ms']:.4f} ms ({k3['parent_ms'] / k3['ms']:.3f} x); K4 {label} "
                f"per training step {k4['ms']:.4f} ms against the parent's "
                f"{k4['parent_ms']:.4f} ms ({k4['parent_ms'] / k4['ms']:.3f} x), same call")
        report.append(bf16_entry(f"K3 fused_edge_phase {label}", "fused_edge.cu",
                                 "neural_lam_tpu/ops/pallas_fused.py:879", k3, None))
        report.append(bf16_entry(f"K4 fused_edge_phase backward {label}", "fused_edge_bwd.cu",
                                 "neural_lam_tpu/ops/pallas_fused.py:1052", k4, None))
        k7, k8 = acc(), acc()
        for site, net, ge, emb, mode, update, has_dne, calls, n_send, n_rec in v2_sites:
            es, raw = ge.edges, mode == "raw"
            n_e, rows = es.num_edges, es.num_edges * b
            wts = [None if w is None else (w.to(bf16).float() if copies else w.float())
                   for w in fk._weights(net.edge_mlp, emb)]
            params = [w for w in wts if w is not None]
            sp, rp = randn(n_send, b, d, dtype=io), randn(n_rec, b, d, dtype=io)
            edge_in = ge.features.to(io) if raw else randn(n_e, b, d, dtype=io)
            sp32, rp32, e32 = sp.float(), rp.float(), edge_in.float()

            def run7(out=io, pre=False):
                return fk.fused_edge_v2_fwd(edge_in, sp, rp, es, wts, raw, update,
                                            save_pre=pre, bf16_ops=True, out_dtype=out)

            def plain7():
                return fk._plain_v2(e32, sp32, rp32, es.senders, es.receivers, wts, raw,
                                    update, bf16_ops=True)

            outs = [io] if io == torch.float32 else [bf16, torch.float32]  # mixed, high
            err = 0.0
            for out in outs:
                got, want = run7(out, pre=True), plain7()
                torch.cuda.synchronize()
                err = max(err, bf16_check(got[0], want[0].to(out), f"K7 {label} {site} aggr"))
                if update:
                    err = max(err, bf16_check(got[1], want[1].to(out),
                                              f"K7 {label} {site} new_edge"))
                err = max(err, bf16_check(got[2], want[2], f"K7 {label} {site} pre"))
            pre = got[2]
            ms, pre_ms = cuda_ms(run7), cuda_ms(lambda: run7(pre=True))
            old_ms, old_pre_ms = parent_ms(parent, run7), parent_ms(parent,
                                                                    lambda: run7(pre=True))
            f32_ms = cuda_ms(lambda: fk.fused_edge_v2_fwd(e32, sp32, rp32, es, wts, raw,
                                                          update))
            plain_ms = cuda_ms(plain7)
            got = run7()
            moved = nbytes(edge_in, sp, rp, es.rowptr, es.senders, *params, got[0], got[1])
            flops7 = 2 * rows * d * d + rows * d
            if raw:
                flops7 += n_e * (2 * edge_in.shape[1] * d + 2 * d * d * 2)
            else:
                flops7 += 2 * rows * d * d
            b_ms, b_by = bf16_bound(moved, flops7)
            log(f"K7 fused_edge_phase_v2 {label} {site}: E {n_e}, senders {n_send}, "
                f"receivers {n_rec}, edge input {mode}, streams {str(io)[6:]}, update_edges "
                f"{update}; max abs err {err:.3g} (tol {BF16_TOL} of the largest entry"
                f"{', bf16 and float32 out' if len(outs) == 2 else ''}; pre float32); kernel "
                f"{ms:.4f} ms, with the pre output {pre_ms:.4f} ms (float32 kernel "
                f"{f32_ms:.4f} ms; parent {old_ms or 0.0:.4f} ms, with pre "
                f"{old_pre_ms or 0.0:.4f} ms, 0 = not measured); plain {plain_ms:.4f} ms; "
                f"bound {b_ms:.4f} ms ({b_by}, {moved / 1e6:.1f} MB, bf16 tensor cores; "
                f"{100 * b_ms / ms:.1f} % of it); {calls} call(s) per AR step")
            add(k7, calls, ms, f32_ms, plain_ms, b_ms, b_by, err, old_ms=old_ms)

            d_aggr = randn(n_rec, b, d, dtype=io)
            d_new = randn(n_e, b, d, dtype=io) if has_dne else None
            da32, dn32 = d_aggr.float(), None if d_new is None else d_new.float()

            def run8():
                return fk.fused_edge_v2_bwd(d_aggr, d_new, pre, edge_in, es, wts, raw,
                                            bf16_ops=True)

            def plain8():
                return fk._plain_v2_bwd(da32, dn32, e32, sp32, rp32, es, wts, raw, update,
                                        bf16_ops=True)

            def flat8(out):
                d_edge, d_pre, d_recproj, grads = out
                return [d_pre, d_recproj] + ([] if raw else [d_edge]) + [
                    x for x in grads if x is not None]

            got, want, again = flat8(run8()), flat8(plain8()), flat8(run8())
            torch.cuda.synchronize()
            err = max(bf16_check(o, w.to(o.dtype), f"K8 {label} {site} gradient {i}")
                      for i, (o, w) in enumerate(zip(got, want)))
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"K8 {label} {site}: two runs differ")
            ms = cuda_ms(run8)
            old_ms = parent_ms(parent, run8)
            f32_ms = cuda_ms(lambda: fk.fused_edge_v2_bwd(da32, dn32, pre, e32, es, wts, raw))
            plain_ms = cuda_ms(plain8)
            moved = nbytes(pre, edge_in, d_aggr, d_new, es.rowptr, *params, *got)
            flops8 = 2 * rows * d * d * 3 + rows * d
            if raw:
                flops8 += n_e * (2 * d * d * 5 + 2 * edge_in.shape[1] * d * 2)
            elif mode == "batched":
                flops8 += 2 * rows * d * d * 2
            else:
                flops8 += 2 * n_e * d * d * 2
            b_ms, b_by = bf16_bound(moved, flops8)
            log(f"K8 fused_edge_phase_v2 backward {label} {site}: streams {str(io)[6:]}, "
                f"d_new_edge {'given' if has_dne else 'none'}; max abs err {err:.3g} (tol "
                f"{BF16_TOL} of each gradient's largest entry), repeatable; kernel {ms:.4f} ms "
                f"(float32 kernel {f32_ms:.4f} ms; parent {old_ms or 0.0:.4f} ms, 0 = not "
                f"measured); plain (autograd) {plain_ms:.4f} ms; bound "
                f"{b_ms:.4f} ms ({b_by}, {moved / 1e6:.1f} MB; {100 * b_ms / ms:.1f} % of "
                f"it); {calls} call(s) per training step")
            add(k8, calls, ms, f32_ms, plain_ms, b_ms, b_by, err, old_ms=old_ms)
            del sp, rp, edge_in, sp32, rp32, e32, got, want, again, pre, d_aggr, d_new
            torch.cuda.empty_cache()
        log(f"K7 {label} per AR step {k7['ms']:.4f} ms against the float32 kernel's "
            f"{k7['f32_ms']:.4f} ms and K3 {label}'s {k3['ms']:.4f} ms (bound "
            f"{k7['bound_ms']:.4f}, {100 * k7['bound_ms'] / k7['ms']:.1f} % of it); K8 "
            f"{label} per training step {k8['ms']:.4f} ms against {k8['f32_ms']:.4f} ms and "
            f"K4 {label}'s {k4['ms']:.4f} ms (bound {k8['bound_ms']:.4f}, "
            f"{100 * k8['bound_ms'] / k8['ms']:.1f} % of it)")
        if parent is not None:
            log(f"K7 {label} per AR step {k7['ms']:.4f} ms against the parent's "
                f"{k7['parent_ms']:.4f} ms ({k7['parent_ms'] / k7['ms']:.3f} x); K8 {label} "
                f"per training step {k8['ms']:.4f} ms against the parent's "
                f"{k8['parent_ms']:.4f} ms ({k8['parent_ms'] / k8['ms']:.3f} x), same call")
        report.append(bf16_entry(f"K7 fused_edge_phase_v2 {label}", "fused_edge_v2.cu",
                                 "neural_lam_tpu/ops/pallas_fused.py:2143", k7, None))
        report.append(bf16_entry(f"K8 fused_edge_phase_v2 backward {label}",
                                 "fused_edge_v2_bwd.cu",
                                 "neural_lam_tpu/ops/pallas_fused.py:2293", k8, None))
    log_occupancy("bf16", lambda row: row["pre"] == "float32")
    log_tail_occupancy("K4 bf16", bf16_ops=True)
    torch.cuda.empty_cache()
    return [
        bf16_entry("K1 sender_gather bf16", "sender_gather.cu",
                   "neural_lam_tpu/ops/pallas_segment.py:821", k1, k1["library_ms"]),
        bf16_entry("K2 sender_scatter bf16", "sender_scatter.cu",
                   "neural_lam_tpu/ops/pallas_segment.py:766", k2, k2["library_ms"]),
    ] + report


def bf16_graph_lam(torch, ds):
    """GraphLAM at MEPS width with ``compute_dtype`` bf16 and the gate's
    parameters (``make_trainer`` loads them)."""
    from neural_lam_tpu_torch.models import GraphLAM

    return GraphLAM(ds, hidden_dim=HIDDEN, processor_layers=PROC_LAYERS, device=DEVICE,
                    compute_dtype=torch.bfloat16)


def bf16_expected(model) -> dict[str, int]:
    """Launches per mixed-precision training step: the bf16 variants in
    place of K1-K4, K7 and K8; K4's receiver slice (float32 in every
    precision) and, on the unfused route, K5 and K6 in float32 (the JAX
    package casts around them)."""
    f32 = expected_launches(model, training=True)
    out = dict.fromkeys(f32, 0)
    for name in ("K1 sender_gather", "K2 sender_scatter", "K3 fused_edge_phase",
                 "K4 fused_edge_phase backward", "K7 fused_edge_phase_v2",
                 "K8 fused_edge_phase_v2 backward", "K3 node update", "K4 node backward"):
        out[f"{name} bf16"] = f32[name]
    for name in ("K5 segment_sum", "K6 receiver_expand", K4_RECEIVER_SLICE):
        out[name] = f32[name]
    return out


def timed_steps(torch, step, data) -> dict:
    """``TRAIN_WARMUP`` then ``TRAIN_ITERS`` calls of ``step`` queued back
    to back, timed with CUDA events: losses, ms per step, peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [step(*data).item() for _ in range(TRAIN_WARMUP)]
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_ITERS + 1)]
    timed = []
    marks[0].record()
    for mark in marks[1:]:
        timed.append(step(*data))
        mark.record()
    torch.cuda.synchronize()
    losses += [loss.item() for loss in timed]
    return dict(losses=losses, step_ms=marks[0].elapsed_time(marks[-1]) / TRAIN_ITERS,
                peak=torch.cuda.max_memory_allocated())


def phase_bf16_train(torch, model, ds, card: str, others: bool = True) -> dict[str, int]:
    """Mixed-precision training of GraphLAM at MEPS width, batch 4,
    ``ar_steps`` 1 (``TrainingArgs(precision="bf16")``, a model built with
    ``compute_dtype`` bf16), from the float32 training gate's weights on
    its bench batch: the first loss and every gradient against the exact
    float32 fixture; 12 eager steps and 12 through the captured step, the
    same bits; the master parameters and AdamW's state float32; the step's
    training grid-points/s, device busy time and peak memory beside the
    float32 captured step's (``model``, in the same call). Then 2 steps of
    ``GraphLAM(hidden_layers=2)`` (the unfused route), of HiLAM and under
    ``NEURAL_LAM_TPU_BF16_KERNELS=off``, and 1 step each of the float32
    model under ``high`` and ``high-kernels``, at full width; without
    ``others`` only the last three (a second run of the phase, on the v2
    route, keeps to the paths that route takes). Returns each kernel's
    launches on the device in this phase."""
    from neural_lam_tpu_torch.trainer import GRAPH_WARMUP_STEPS

    total: dict[str, int] = {}
    counters = kernel_counters()
    data = [torch.from_numpy(a).to(DEVICE) for a in bench_batch(ds)]
    route = "v2" if on_v2() else "v1"

    def zero():
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0

    def ticks():
        return {name: fn.launches for name, fn in counters.items()}

    bf_model = bf16_graph_lam(torch, ds)
    with np.load(TRAIN_FIXTURE) as fx:
        want_loss, grid = float(fx["losses"][0]), fx["grid"]
        want_grads = {k[len("grad/"):]: fx[k] for k in fx.files if k.startswith("grad/")}
    trainer = make_trainer(bf_model, ds, precision="bf16")
    check_gate_fixture(trainer, grid, TRAIN_LR)
    losses, grads = train_gate_run(torch, trainer, BATCH, 1)
    rel = abs(losses[0] - want_loss) / abs(want_loss)
    worst, worst_key = 0.0, ""
    for key, want in want_grads.items():
        got = grads[key]
        if not np.isfinite(got).all():
            raise AssertionError(f"bf16 train: gradient {key} is not finite")
        r = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
        if r > worst:
            worst, worst_key = r, key
    log(f"bf16 train gate ({route} route): loss {losses[0]:.8g} against the float32 fixture's "
        f"{want_loss:.8g} (rel {rel:.3e}, tol {BF16_LOSS_RTOL}); {len(want_grads)} "
        f"gradients, worst {worst:.3e} of its largest entry at {worst_key} (tol "
        f"{BF16_GRAD_TOL})")
    if rel > BF16_LOSS_RTOL or worst > BF16_GRAD_TOL:
        raise AssertionError("bf16 train gate: outside its tolerances")
    expected = bf16_expected(bf_model)

    # eager, then captured, from the same weights on the same batch
    trainer = make_trainer(bf_model, ds, precision="bf16")
    zero()
    eager = timed_steps(torch, trainer.train_step, data)
    got = ticks()
    steps = TRAIN_WARMUP + TRAIN_ITERS
    for name, per_step in expected.items():
        if got[name] != per_step * steps:
            raise AssertionError(f"bf16 train eager: {name} {got[name]} launches, want "
                                 f"{per_step} x {steps}")
    add_launches(total, got, "bf16 train eager")
    trainer = make_trainer(bf_model, ds, precision="bf16")
    zero()
    step = trainer.make_train_step()
    captured = timed_steps(torch, step, data)
    first = ticks()
    if len(trainer.graphs) != 1:
        raise AssertionError(f"bf16 train graph: {len(trainer.graphs)} graphs, want 1")
    replay = graph_kernels(torch, next(iter(trainer.graphs.values())).graph)
    launches = {}
    for name, per_step in expected.items():
        if first[name] != per_step * (GRAPH_WARMUP_STEPS + 1) or replay[name] != per_step:
            raise AssertionError(f"bf16 train graph: {name}: {first[name]} counted, "
                                 f"{replay[name]} in the graph, want {per_step} a step")
        launches[name] = first[name] - replay[name] + replay[name] * steps
    add_launches(total, launches, "bf16 train graph")
    same = captured["losses"] == eager["losses"]
    log("bf16 train: losses per step (eager) "
        + ", ".join(f"{x:.6f}" for x in eager["losses"])
        + f"; captured the same bits: {same}")
    if not same or not np.isfinite(eager["losses"]).all():
        raise AssertionError("bf16 train: captured losses differ from eager, or not finite")
    master = [p.dtype for p in bf_model.parameters()]
    moments = [t.dtype for s in trainer.optimizer.state.values() for t in s.values()
               if torch.is_tensor(t)]
    if set(master) != {torch.float32} or set(moments) != {torch.float32}:
        raise AssertionError(f"bf16 train: parameters {set(master)}, AdamW state {set(moments)}")
    busy, kernels = device_kernels(torch, lambda: step(*data))
    del trainer, step
    release(torch)

    f32 = make_trainer(model, ds)
    f32_step = f32.make_train_step()
    f32_run = timed_steps(torch, f32_step, data)
    f32_busy, f32_kernels = device_kernels(torch, lambda: f32_step(*data))
    del f32, f32_step
    release(torch)
    gps = {k: BATCH * ds.num_grid_points / (r["step_ms"] / 1e3)
           for k, r in (("bf16", captured), ("f32", f32_run))}
    log(f"bf16 train ({route} route) on {card}: captured step {captured['step_ms']:.3f} ms (eager "
        f"{eager['step_ms']:.3f} ms), device busy {busy:.3f} ms in {kernels} kernels, "
        f"{gps['bf16']:,.0f} training grid-points/s, peak device memory "
        f"{captured['peak'] / 2**30:.2f} GiB; float32 captured step (same call) "
        f"{f32_run['step_ms']:.3f} ms, device busy {f32_busy:.3f} ms in {f32_kernels} "
        f"kernels, {gps['f32']:,.0f} training grid-points/s, peak "
        f"{f32_run['peak'] / 2**30:.2f} GiB; bf16 / float32 grid-points/s "
        f"{gps['bf16'] / gps['f32']:.3f}")

    # the other paths: 2 steps (1 under high, high-kernels), finite losses
    runs = [
        ("GraphLAM(hidden_layers=2) bf16",
         lambda: build_model(torch, "graph_lam_h2", ds, compute_dtype=torch.bfloat16),
         "bf16", {}, 2),
        ("HiLAM bf16", lambda: build_model(torch, "hi_lam", ds, compute_dtype=torch.bfloat16),
         "bf16", {}, 2),
        (f"GraphLAM bf16, {BF16_KERNELS}=off", lambda: bf_model, "bf16",
         {BF16_KERNELS: "off"}, 2),
        (f"GraphLAM, {MATMUL_PRECISION}=high", lambda: model, "32",
         {MATMUL_PRECISION: "high"}, 1),
        (f"GraphLAM, {MATMUL_PRECISION}=high-kernels", lambda: model, "32",
         {MATMUL_PRECISION: "high-kernels"}, 1),
    ]
    if not others:
        runs = runs[2:]
    for label, make, precision, env, n_steps in runs:
        run_model = make()
        with contextlib.ExitStack() as stack:
            for name, value in env.items():
                stack.enter_context(env_set(name, value))
            # GraphLAM takes the gate's weights; the others keep their seeded ones
            fixture = not run_model.hierarchical and run_model.hidden_layers == 1
            trainer = make_trainer(run_model, ds, reload=fixture, precision=precision)
            zero()
            t0 = time.perf_counter()
            step_losses = [trainer.train_step(*data).item() for _ in range(n_steps)]
            seconds = time.perf_counter() - t0
        got = {k: v for k, v in ticks().items() if v}
        log(f"bf16 train {label} ({route} route): losses {', '.join(f'{x:.6f}' for x in step_losses)} "
            f"({seconds:.2f} s); launches {got}")
        if not np.isfinite(step_losses).all() or not got:
            raise AssertionError(f"bf16 train {label}: non-finite loss or no launch")
        add_launches(total, ticks(), f"bf16 train {label}")
        del trainer, run_model
        release(torch)
    del bf_model
    release(torch)
    return total


def phase_bf16_rollout(torch, ds) -> dict[str, int]:
    """``scripts/accuracy_probe.py --precision bf16 --check``: the 19-step
    MEPS rollout of the gate (its inputs, :80-88) with bf16 compute copies
    of the gate's weights (:90-97), through the captured forecast, against
    the exact-f32 fixture, per step ``mean_rel`` and ``max_rel`` (:104-117)
    within the probe's bf16 thresholds, and the full field's mean
    magnitude within the ``mean_rel`` one. Returns the launches."""
    from neural_lam_tpu_torch.models import ARForecaster
    from neural_lam_tpu_torch.utils.cuda_graph import CapturedFunction

    model = bf16_graph_lam(torch, ds)
    make_trainer(model, ds)  # loads the gate's weights
    forecaster = ARForecaster(model, ds)
    copies = {k: p.detach().to(torch.bfloat16) for k, p in model.named_parameters()}
    fx = np.load(FIXTURES / "rollout19_f32.npz")
    steps, sub = int(fx["steps"]), int(fx["subsample"])
    n = ds.num_grid_points
    rng = np.random.default_rng(0)
    init = rng.normal(size=(1, 2, n, N_STATE)).astype(np.float32)
    forcing = rng.normal(size=(1, steps, n, N_FORCING * 3)).astype(np.float32)
    boundary = rng.normal(size=(1, steps, n, N_STATE)).astype(np.float32)
    counters = kernel_counters()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    captured = CapturedFunction(
        lambda i, f, b: forecaster(i, f, b, params=copies)[0], forecaster, DEVICE
    )
    pred = captured(*(torch.from_numpy(a).to(DEVICE) for a in (init, forcing, boundary)))
    (entry,) = captured.graphs.values()
    launches = {k: fn.launches + graph_kernels(torch, entry.graph)[k]
                for k, fn in counters.items()}
    pred = pred.cpu().numpy()
    if pred.shape != (1, steps, n, N_STATE) or not np.isfinite(pred).all():
        raise AssertionError(f"bf16 rollout: shape {pred.shape} or non-finite")
    want, got = fx["prediction_sub"], pred[:, :, ::sub, :]
    scale = np.abs(want).mean()
    worst_mean = worst_max = 0.0
    for t in range(steps):
        diff = np.abs(got[:, t] - want[:, t])
        mean_rel, max_rel = float(diff.mean() / scale), float(diff.max() / scale)
        worst_mean, worst_max = max(worst_mean, mean_rel), max(worst_max, max_rel)
        log(f"bf16 rollout step {t + 1:2d}: mean_rel {mean_rel:.3e} max_rel {max_rel:.3e}")
    drift = abs(np.abs(pred).mean() - float(fx["abs_mean"])) / float(fx["abs_mean"])
    log(f"bf16 rollout (captured forecast, bf16 compute copies): worst mean_rel "
        f"{worst_mean:.3e} (limit {BF16_ROLLOUT_MEAN_REL}), worst max_rel {worst_max:.3e} "
        f"(limit {BF16_ROLLOUT_MAX_REL}), abs_mean drift {drift:.3e} (limit "
        f"{BF16_ROLLOUT_MEAN_REL})")
    if (worst_mean > BF16_ROLLOUT_MEAN_REL or worst_max > BF16_ROLLOUT_MAX_REL
            or drift > BF16_ROLLOUT_MEAN_REL):
        raise AssertionError("bf16 rollout: thresholds exceeded")
    del captured, entry, forecaster, model, copies
    release(torch)
    return launches


def cache_pre_expected(model, mode: str) -> dict[str, int]:
    """Launches per float32 training step on the v1 route under
    ``NEURAL_LAM_TPU_CACHE_PRE=mode``: ``bf16`` runs K3 writing a bf16
    ``pre`` and K4 reading it, ``off`` K3 writing none and K4 recomputing
    it, in place of K3 and K4."""
    out = expected_launches(model, training=True)
    k3, k4 = "K3 fused_edge_phase", "K4 fused_edge_phase backward"
    if mode == "bf16":
        out[f"{k3} bf16 pre"], out[k3] = out[k3], 0
        out[f"{k4} bf16 pre"], out[k4] = out[k4], 0
    elif mode == "off":
        out[f"{k4} recompute"], out[k4] = out[k4], 0
    return out


def phase_cache_pre_kernels(torch, model, parent=None) -> list[dict]:
    """``NEURAL_LAM_TPU_CACHE_PRE``'s kernels at the six GraphLAM calls
    of a training step (batch 4, float32): K3 writing a bf16 ``pre``
    (against the float32-``pre`` K3: the same outputs bit for bit and its
    ``pre`` rounded to nearest even; against the plain version), K4
    reading it (against the plain backward from the same bf16 values) and
    K4 recomputing ``pre`` (against the plain backward that recomputes it,
    and against K4 from K3's float32 ``pre``: within
    ``CACHE_PRE_RECOMPUTE_TOL`` of each gradient's largest entry, and how
    many entries are the same bits), each timed beside the kernel it
    stands in for, its plain version and its bound (3xTF32). Then the same
    three with bf16 operands on bf16 streams (mixed precision) against their
    plain versions, timed beside the ``parent`` commit's kernels where one is
    given, and their occupancy, registers and spills. Returns the three
    kernels' report entries (float32), times summed over a training step."""
    from neural_lam_tpu_torch.ops import fused_kernels as fk

    bf16 = torch.bfloat16
    g, dev, d, b = model.graph, model.device, HIDDEN, BATCH
    gen = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    n_grid, n_mesh = g.num_grid_nodes, g.num_mesh_nodes
    m2m, proc, n_mid = g.m2m[0], list(model.processor.values()), PROC_LAYERS - 2
    sites = [  # (site, net, edges, embedder, edge input, update_edges, d_new_edge, calls, receivers)
        ("g2m", model.g2m_gnn, g.g2m, model.g2m_embedder, "raw", False, False, 1, n_mesh),
        ("m2m layer 0", proc[0], m2m, model.m2m_embedder, "raw", True, True, 1, n_mesh),
        (f"m2m layers 1-{n_mid}", proc[1], m2m, None, "batched", True, True, n_mid, n_mesh),
        (f"m2m layer {PROC_LAYERS - 1}", proc[-1], m2m, None, "batched", True, False, 1,
         n_mesh),
        ("m2g", model.m2g_gnn, g.m2g, model.m2g_embedder, "raw", False, False, 1, n_grid),
    ]
    names = ("K3 fused_edge_phase bf16 pre", "K4 fused_edge_phase backward bf16 pre",
             "K4 fused_edge_phase backward recompute")
    accs = {k: dict(ms=0.0, plain_ms=0.0, base_ms=0.0, bound_ms=0.0, ops_ms=0.0,
                    bytes_ms=0.0, err=0.0) for k in names}
    same_bits = total_entries = same = 0
    tails = {"bf16 pre": {}, "recompute": {}}  # K4's pieces per training step, float32
    # with bf16 operands on bf16 streams: kernel, parent, plain and bound ms
    bf_ms = {k: dict(ms=0.0, parent_ms=0.0, plain_ms=0.0, bound_ms=0.0) for k in names}

    def add(name, calls, ms, plain_ms, base_ms, moved, flops, err):
        b_ms, b_by = bound(moved, flops, tensor=True)
        a = accs[name]
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("base_ms", base_ms),
                         ("bound_ms", b_ms), ("ops_ms" if b_by == "operations" else
                                              "bytes_ms", b_ms)):
            a[key] += calls * val
        a["err"] = max(a["err"], err)
        return b_ms, b_by

    def flat(out):
        d_edge, d_send, d_rec, grads = out
        return [d_send, d_rec] + ([] if d_edge is None else [d_edge]) + [
            w for w in grads if w is not None]

    for site, net, ge, emb, mode, update, has_dne, calls, n_rec in sites:
        es, raw = ge.edges, mode == "raw"
        n_e, rows = es.num_edges, es.num_edges * b
        wts = fk._weights(net.edge_mlp, emb)
        params = [w for w in wts if w is not None]
        x_send, rec = randn(n_e, b, d), randn(n_rec, b, d)
        edge_in = ge.features if raw else randn(n_e, b, d)
        args = (edge_in, x_send, rec, es, wts, raw, update, False)

        # ---- K3 writing a bf16 pre -----------------------------------------
        def k3(pre_dtype=torch.float32):
            return fk.fused_edge_fwd(*args, save_pre=True, pre_dtype=pre_dtype)

        got16, got32 = k3(bf16), k3()
        want = fk._plain(edge_in, x_send, rec, es.receivers, wts, raw, update, False,
                         return_pre=True)
        torch.cuda.synchronize()
        if not (torch.equal(got16[0], got32[0])
                and (not update or torch.equal(got16[1], got32[1]))
                and torch.equal(got16[2], got32[2].to(bf16))):
            raise AssertionError(f"K3 bf16 pre {site}: not the float32-pre K3's outputs "
                                 "and its pre rounded")
        err = max(errors(got16[0], want[0])[0], bf16_check(got16[2], want[2].to(bf16),
                                                             f"K3 bf16 pre {site} pre"))
        torch.testing.assert_close(got16[0], want[0], rtol=K3_RTOL, atol=K3_ATOL)
        ms, base_ms = cuda_ms(lambda: k3(bf16)), cuda_ms(k3)
        plain_ms = cuda_ms(lambda: fk._plain(edge_in, x_send, rec, es.receivers, wts, raw,
                                             update, False, return_pre=True))
        same += same_as_parent(parent, lambda: k3(bf16), f"K3 bf16 pre {site}")
        moved = nbytes(x_send, rec, edge_in, es.rowptr, *params, *got16)
        flops = 2 * n_rec * b * d * d + 2 * rows * d * d * 2 + rows * d
        if raw:
            flops += n_e * (2 * edge_in.shape[1] * d + 4 * d * d)
        else:
            flops += 2 * rows * d * d
        flops_of = {names[0]: flops}  # kept for the bf16-operand kernels' bounds
        b_ms, b_by = add(names[0], calls, ms, plain_ms, base_ms, moved, flops, err)
        log(f"K3 fused_edge_phase bf16 pre {site}: E {n_e}, receivers {n_rec}, edge input "
            f"{mode}; outputs the float32-pre K3's bits and its pre rounded to nearest "
            f"even ({got16[2].nbytes / 1e6:.1f} MB where float32 takes "
            f"{got32[2].nbytes / 1e6:.1f}); max abs err {err:.3g} against the plain "
            f"version; kernel {ms:.4f} ms (float32 pre {base_ms:.4f} ms); plain "
            f"{plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}, 3xTF32: {moved / 1e6:.1f} MB; "
            f"{100 * b_ms / ms:.1f} % of it); {calls} call(s) per training step")
        pre16, pre32 = got16[2], got32[2]
        del got16, got32, want

        # ---- K4 reading it, and K4 recomputing pre ----------------------------
        d_aggr = randn(n_rec, b, d)
        d_new = randn(n_e, b, d) if has_dne else None

        def k4(pre):
            return fk.fused_edge_bwd(d_aggr, d_new, pre, edge_in, x_send, rec, es, wts, raw,
                                     False)

        def plain4(pre):
            return fk._plain_bwd(d_aggr, d_new, edge_in, x_send, rec, es, wts, raw, update,
                                 False, pre=pre)

        got, want, again = flat(k4(pre16)), flat(plain4(pre16)), flat(k4(pre16))
        torch.cuda.synchronize()
        err = 0.0
        for i, (o, w) in enumerate(zip(got, want)):
            a_err, r_err = errors(o, w)
            err = max(err, a_err)
            if r_err > K4_TOL:
                raise AssertionError(f"K4 bf16 pre {site} gradient {i}: {r_err:.3g} of its "
                                     f"largest value off the plain backward (tol {K4_TOL})")
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"K4 bf16 pre {site}: two runs differ")
        ms, base_ms = cuda_ms(lambda: k4(pre16)), cuda_ms(lambda: k4(pre32))
        plain_ms = cuda_ms(lambda: plain4(pre16))
        same += same_k4_as_parent(parent, lambda: k4(pre16), mode != "batched",
                                  f"K4 bf16 pre {site}")[0]
        tail_bounds = k4_tail_bounds(torch, es, n_rec, b, raw, edge_in, d_new, torch.float32,
                                     False)
        log_k4_split(torch, f"K4 bf16 pre {site}", lambda: k4(pre16), parent, calls,
                     tail_bounds, tails["bf16 pre"])
        moved = nbytes(pre16, x_send, rec, edge_in, d_aggr, d_new, es.rowptr, *params, *got)
        flops = 2 * rows * d * d * 5 + 2 * n_rec * b * d * d * 2 + rows * d
        if raw:
            flops += n_e * (2 * d * d * 5 + 2 * edge_in.shape[1] * d * 2)
        else:
            flops += 2 * rows * d * d * 2
        flops_of[names[1]] = flops
        b_ms, b_by = add(names[1], calls, ms, plain_ms, base_ms, moved, flops, err)
        log(f"K4 fused_edge_phase backward bf16 pre {site}: d_new_edge "
            f"{'given' if has_dne else 'none'}; max abs err {err:.3g} against the plain "
            f"backward from the same bf16 pre (tol {K4_TOL} of each gradient's largest "
            f"entry), repeatable; kernel {ms:.4f} ms (float32 pre {base_ms:.4f} ms); plain "
            f"{plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}, {moved / 1e6:.1f} MB; "
            f"{100 * b_ms / ms:.1f} % of it); {calls} call(s) per training step")

        saved = flat(k4(pre32))
        got, again, want = flat(k4(None)), flat(k4(None)), flat(plain4(None))
        torch.cuda.synchronize()
        worst = err = 0.0
        for i, (o, w, p) in enumerate(zip(got, saved, want)):
            worst = max(worst, errors(o, w)[1])
            same_bits += int((o == w).sum())
            total_entries += o.numel()
            a_err, r_err = errors(o, p)
            err = max(err, a_err)
            if r_err > K4_TOL:
                raise AssertionError(f"K4 recompute {site} gradient {i}: {r_err:.3g} of its "
                                     f"largest value off the plain backward (tol {K4_TOL})")
        if worst > CACHE_PRE_RECOMPUTE_TOL:
            raise AssertionError(f"K4 recompute {site}: a gradient is {worst:.3g} of its "
                                 f"largest value off K4 from the saved pre (tol "
                                 f"{CACHE_PRE_RECOMPUTE_TOL})")
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"K4 recompute {site}: two runs differ")
        ms = cuda_ms(lambda: k4(None))
        base_ms = cuda_ms(lambda: k4(pre32))
        plain_ms = cuda_ms(lambda: plain4(None))
        same += same_k4_as_parent(parent, lambda: k4(None), mode != "batched",
                                  f"K4 recompute {site}")[0]
        log_k4_split(torch, f"K4 recompute {site}", lambda: k4(None), parent, calls,
                     tail_bounds, tails["recompute"])
        moved = nbytes(x_send, rec, edge_in, d_aggr, d_new, es.rowptr, *params, *got)
        # K4's products, and the recompute's: send . W1s per row, edge .
        # W1e per row (batched) or the embedder and edge_val . W1e per edge,
        # rec . W1r per (receiver, b)
        flops += 2 * rows * d * d + 2 * n_rec * b * d * d
        flops += n_e * (2 * edge_in.shape[1] * d + 4 * d * d) if raw else 2 * rows * d * d
        flops_of[names[2]] = flops
        b_ms, b_by = add(names[2], calls, ms, plain_ms, base_ms, moved, flops, err)
        log(f"K4 fused_edge_phase backward recompute {site}: max abs err {err:.3g} against "
            f"the plain backward recomputing pre (tol {K4_TOL} of each gradient's largest "
            f"entry); every gradient within {worst:.3g} of its largest value of K4 from "
            f"K3's float32 pre (tol {CACHE_PRE_RECOMPUTE_TOL}), repeatable; kernel "
            f"{ms:.4f} ms (from the saved "
            f"pre {base_ms:.4f} ms); plain (recomputing) {plain_ms:.4f} ms; bound "
            f"{b_ms:.4f} ms ({b_by}, {moved / 1e6:.1f} MB; {100 * b_ms / ms:.1f} % of it); "
            f"{calls} call(s) per training step")
        del pre16, pre32, got, want, again, saved

        # ---- the three with bf16 operands on bf16 streams ---------------------
        w16 = [None if w is None else w.to(bf16).float() for w in wts]
        x16, r16, e16, da16 = x_send.to(bf16), rec.to(bf16), edge_in.to(bf16), d_aggr.to(bf16)
        dn16 = None if d_new is None else d_new.to(bf16)
        args16 = (e16, x16, r16, es, w16, raw, update, False)

        def k3b():
            return fk.fused_edge_fwd(*args16, save_pre=True, bf16_ops=True, pre_dtype=bf16)

        def k4b(pre):
            return fk.fused_edge_bwd(da16, dn16, pre, e16, x16, r16, es, w16, raw, False, True)

        def plain3b():
            return fk._plain(e16.float(), x16.float(), r16.float(), es.receivers, w16, raw,
                             update, False, bf16_ops=True, return_pre=True)

        def plain4b(pre):
            return fk._plain_bwd(da16.float(), None if dn16 is None else dn16.float(),
                                 e16.float(), x16.float(), r16.float(), es, w16, raw, update,
                                 False, True, pre=pre)

        w16_params = [w for w in w16 if w is not None]
        got, want = k3b(), plain3b()
        torch.cuda.synchronize()
        bf16_check(got[0], want[0].to(bf16), f"K3 bf16 pre, bf16 operands, {site}")
        bf16_check(got[2], want[2].to(bf16), f"K3 bf16 pre, bf16 operands, {site} pre")
        pre_b = got[2]
        # (name, kernel, plain version, bytes moved)
        times = [(names[0], k3b, plain3b,
                  nbytes(x16, r16, e16, es.rowptr, *w16_params, *got))]
        for name, pre in ((names[1], pre_b), (names[2], None)):
            got, again, want = flat(k4b(pre)), flat(k4b(pre)), flat(plain4b(pre))
            torch.cuda.synchronize()
            for i, (o, w) in enumerate(zip(got, want)):
                bf16_check(o, w.to(o.dtype), f"{name}, bf16 operands, {site} gradient {i}")
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"{name}, bf16 operands, {site}: two runs differ")
            moved = nbytes(pre, x16, r16, e16, da16, dn16, es.rowptr, *w16_params, *got)
            times.append((name, lambda pre=pre: k4b(pre), lambda pre=pre: plain4b(pre), moved))
        row = []
        for name, fn, plain_fn, moved in times:
            ms, old_ms, plain_ms = cuda_ms(fn), parent_ms(parent, fn), cuda_ms(plain_fn)
            b_ms, b_by = bf16_bound(moved, flops_of[name])
            a = bf_ms[name]
            for key, val in (("ms", ms), ("parent_ms", old_ms or 0.0),
                             ("plain_ms", plain_ms), ("bound_ms", b_ms)):
                a[key] += calls * val
            row.append(f"{name} {ms:.4f} ms (parent {old_ms or 0.0:.4f}; plain "
                       f"{plain_ms:.4f}; bound {b_ms:.4f}, {b_by}, {moved / 1e6:.1f} MB, "
                       f"bf16 tensor cores)")
        log(f"bf16 operands, bf16 streams, {site}: within the bf16 bounds of the plain "
            f"versions, repeatable; {'; '.join(row)}; 0 = not measured")
        del x_send, rec, edge_in, d_aggr, d_new, x16, r16, e16, da16, dn16, pre_b, got, want
        del again
        torch.cuda.empty_cache()
    for label, acc in tails.items():
        log_k4_tail(f"K4 {label}", acc, parent)
    log(f"K4 recompute against K4 from the saved pre: {same_bits} of {total_entries} "
        f"gradient entries the same bits")
    for name, a in bf_ms.items():
        log(f"{name}, bf16 operands and streams, per training step: {a['ms']:.4f} ms against "
            f"the parent's {a['parent_ms']:.4f} ms (0 = not measured); plain "
            f"{a['plain_ms']:.4f} ms; bound {a['bound_ms']:.4f} ms")
    if parent is not None:
        log(f"float32 K3 bf16 pre, K4 bf16 pre and K4 recompute against the parent's "
            f"kernels on the same inputs at {len(sites)} sites: {same} outputs and "
            f"gradients, every one the same bits")
    log_occupancy("cache pre", lambda row: row["pre"] != "float32")
    for name in names:
        a = accs[name]
        log(f"{name} per training step: {a['ms']:.4f} ms against {a['base_ms']:.4f} ms "
            f"with a float32 pre (bound {a['bound_ms']:.4f} ms)")
    return [
        bf16_entry(names[0], "fused_edge.cu", "neural_lam_tpu/ops/pallas_fused.py:879",
                   accs[names[0]], None),
        bf16_entry(names[1], "fused_edge_bwd.cu", "neural_lam_tpu/ops/pallas_fused.py:1052",
                   accs[names[1]], None),
        bf16_entry(names[2], "fused_edge_bwd_recompute.cu",
                   "neural_lam_tpu/ops/pallas_fused.py:1052", accs[names[2]], None),
    ]


def phase_cache_pre_train(torch, model, ds, card: str) -> dict[str, int]:
    """The captured training step of GraphLAM under
    ``NEURAL_LAM_TPU_CACHE_PRE`` ``on``, ``bf16`` and ``off``
    (:func:`compare_train_modes`): ``on`` and ``off`` at the float32 gate's
    bounds, ``bf16`` at the bf16 ones."""
    tols = {mode: (BF16_LOSS_RTOL, BF16_GRAD_TOL) if mode == "bf16"
            else (TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL) for mode in ("on", "bf16", "off")}
    return compare_train_modes(torch, model, ds, card, "cache pre", CACHE_PRE_ENV, tols,
                               cache_pre_expected)


def compare_train_modes(torch, model, ds, card: str, what: str, env: str, tols: dict,
                        expected) -> dict[str, int]:
    """The captured training step of GraphLAM (float32, batch 4) under
    ``env`` set to each mode of ``tols`` in turn (in one call, the first
    mode the base), from the training gate's weights on its batch: the
    first loss and every gradient against the exact-f32 fixture (within
    ``tols[mode]``), the memory an eager forward holds for its backward,
    12 captured steps' time, peak device memory and the launches, by the
    counters (at 0 just before each mode) and the graph's kernel nodes,
    ``expected(model, mode)`` a step. Returns the launches."""
    from neural_lam_tpu_torch.trainer import GRAPH_WARMUP_STEPS

    with np.load(TRAIN_FIXTURE) as fx:
        want_loss = float(fx["losses"][0])
        want_grads = {k[len("grad/"):]: fx[k] for k in fx.files if k.startswith("grad/")}
    counters = kernel_counters()
    data = [torch.from_numpy(a).to(DEVICE) for a in bench_batch(ds)]
    total: dict[str, int] = {}
    runs = {}
    for mode, (loss_tol, grad_tol) in tols.items():
        with env_set(env, mode):
            losses, grads = train_gate_run(torch, make_trainer(model, ds), BATCH, 1,
                                           captured=True)
            rel = abs(losses[0] - want_loss) / abs(want_loss)
            worst = max(float(np.abs(grads[k] - w).max() / max(np.abs(w).max(), 1e-30))
                        for k, w in want_grads.items())
            if rel > loss_tol or worst > grad_tol:
                raise AssertionError(f"{what} {mode}: loss rel {rel:.3e} (tol {loss_tol}), "
                                     f"worst gradient {worst:.3e} (tol {grad_tol})")
            release(torch)  # the gate's trainer and its graph, before the peak is read
            trainer = make_trainer(model, ds)
            # what an eager forward holds for its backward
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            loss = trainer._loss(*data)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated() - base
            loss.backward()
            del loss
            trainer.optimizer.zero_grad(set_to_none=True)
            release(torch)
            torch.cuda.synchronize()
            for fn in counters.values():
                fn.launches = 0
            step = trainer.make_train_step()
            run = timed_steps(torch, step, data)
            first = {name: fn.launches for name, fn in counters.items()}
            (entry,) = trainer.graphs.values()
            replay = graph_kernels(torch, entry.graph)
            busy, kernels = device_kernels(torch, lambda: step(*data))
            want = expected(model, mode)
        steps = TRAIN_WARMUP + TRAIN_ITERS + 2  # and the two profiled replays
        launches = {}
        for name, per_step in want.items():
            if first[name] != per_step * (GRAPH_WARMUP_STEPS + 1) or replay[name] != per_step:
                raise AssertionError(f"{what} {mode} graph: {name}: {first[name]} counted, "
                                     f"{replay[name]} in the graph, want {per_step} a step")
            launches[name] = first[name] - replay[name] + replay[name] * steps
        add_launches(total, launches, f"{what} {mode} train graph")
        if not np.isfinite(run["losses"]).all():
            raise AssertionError(f"{what} {mode}: non-finite loss")
        runs[mode] = dict(run, held=held, busy=busy, kernels=kernels)
        log(f"{what} {mode} on {card}: gate loss rel {rel:.3e} (tol {loss_tol}), worst "
            f"gradient {worst:.3e} of its largest entry (tol {grad_tol}); the eager forward "
            f"holds {held / 2**30:.3f} GiB for its backward; captured step "
            f"{run['step_ms']:.3f} ms (device busy {busy:.3f} ms, {kernels} kernels a "
            f"replay), {BATCH * ds.num_grid_points / (run['step_ms'] / 1e3):,.0f} training "
            f"grid-points/s, peak device memory {run['peak'] / 2**30:.3f} GiB")
        del trainer, step, entry
        release(torch)
    base_mode, *others = tols
    base = runs[base_mode]
    for mode in others:
        log(f"{what} {mode} against {base_mode} (same call): step "
            f"{runs[mode]['step_ms'] / base['step_ms']:.3f} x "
            f"({runs[mode]['step_ms'] - base['step_ms']:+.3f} ms), device busy "
            f"{runs[mode]['busy'] - base['busy']:+.3f} ms, kernels a replay "
            f"{runs[mode]['kernels'] - base['kernels']:+d}, peak memory "
            f"{(runs[mode]['peak'] - base['peak']) / 2**30:+.3f} GiB, held for the backward "
            f"{(runs[mode]['held'] - base['held']) / 2**30:+.3f} GiB")
    return total


# -- NEURAL_LAM_TPU_FUSED_AGGR: the node update after K3, the node backward -------


# the per-step lines of the parent commit's (34b9653's) fused aggr kernel
# lines: its K3 with the node-MLP epilogue, per AR step, and its node
# backward, per training step, with the device time of its kernel and reduce
PARENT_AGGR_STEP = re.compile(
    r"^(K3 node update|K4 node backward)( bf16(?: operands)?)? per (?:AR|training) step: "
    r"([0-9.]+) ms (?:\(device .*?K3 \+ node update ([0-9.]+) ms \(device [0-9.]+ ms\) "
    r"against ([0-9.]+) ms with the node tail in torch|against [0-9.]+ ms unfused"
    r".*?device time \(torch\.profiler\) ([0-9.]+) ms)")


def parent_aggr_run(parent_dir: Path, label: str) -> dict[str, dict[str, float]]:
    """The parent commit's node-MLP route timed by its own script, in this
    process's card, one run: ``python3 profile_forecast.py --aggr-kernels``
    in its checkout (it builds its kernels there). Returns, by precision
    suffix ("", " bf16", " bf16 operands"), ``k3_node_ms`` (its K3 + node
    update per AR step, CUDA events), ``k3_tail_ms`` (its K3 plus the node
    tail with torch), ``bwd_ms`` and ``bwd_dev_ms`` (its node backward per
    training step: CUDA events, and the device time of the kernel and its
    reduce), read from the per-step lines this script prints too. Its whole
    output goes to ``chiprun_out/parent_aggr_<label>.log``."""
    proc = subprocess.run([sys.executable, "profile_forecast.py", "--aggr-kernels"],
                          cwd=parent_dir, capture_output=True, text=True, timeout=1500)
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"parent_aggr_{label}.log").write_text(proc.stdout + proc.stderr,
                                                       encoding="utf-8")
    if proc.returncode != 0:
        raise RuntimeError(f"the parent's profile_forecast.py --aggr-kernels failed "
                           f"(rc {proc.returncode}):\n{proc.stderr[-4000:]}")
    found: dict[str, dict[str, float]] = {}
    for line in proc.stdout.splitlines():
        m = PARENT_AGGR_STEP.match(line.strip())
        if not m:
            continue
        kernel, sfx, ms, k3_node, base, dev = m.groups()
        row = found.setdefault(sfx or "", {})
        if kernel.startswith("K3"):
            row.update(k3_node_ms=float(k3_node), k3_tail_ms=float(base))
        else:
            row.update(bwd_ms=float(ms), bwd_dev_ms=float(dev))
    if sorted(found) != ["", " bf16", " bf16 operands"] or any(len(v) != 4 for v in found.values()):
        raise AssertionError(f"the parent's run gave no per-step line of each kernel: {found}")
    return found


def phase_fused_aggr_kernels(torch, model, hi_lam, parent=None) -> list[dict]:
    """``NEURAL_LAM_TPU_FUSED_AGGR``'s kernels at the six GraphLAM calls of
    a step (batch 4), in each precision: float32 (3xTF32), bf16 streams and
    operands (mixed precision) and bf16 operands on float32 streams
    (``high-kernels``). K3 as the route runs it (its aggregate in float32,
    no ``pre`` as served), then the node update on that aggregate: the node
    update and K3's updated edges against the plain version (``_plain`` then
    ``_plain_node``), repeatable to the bit, K3's float32 aggregate the bits
    of K3's own float32 output; each timed (CUDA events) alone, and K3 plus
    the node update beside K3 plus the port's unfused node tail on the same
    inputs (the node MLP with ``torch`` on K3's aggregate), the plain
    version and the bounds; the node update's device time (torch.profiler).
    The node backward from that aggregate: ``d_aggr``, the receiver's
    gradient and the node weights' seven gradients against
    ``_plain_node_bwd``, repeatable, timed beside the unfused tail's
    forward and backward with ``torch``, its plain version and its bound,
    and split into the kernel and its workspace reduce. Then both in
    float32 at HiLAM's ten level sets, the whole phase and every gradient
    against the plain version. With a ``parent`` (:func:`parent_kernels`),
    the parent commit's own script times its node-MLP route on this card
    before and after (:func:`parent_aggr_run`), and float32 K3 is held to
    the parent's K3 bits. Prints the occupancy, registers and spills of
    every instantiation of both kernels. Returns the six kernels' report
    entries, times summed over an AR step (the node update) or a training
    step (the node backward)."""
    import copy

    from neural_lam_tpu_torch.ops import fused_kernels as fk
    from neural_lam_tpu_torch.ops.mlp import apply_mlp_split_first

    parent_runs = []
    if parent is not None:
        parent_runs.append(parent_aggr_run(parent["dir"], "before"))
    bf16 = torch.bfloat16
    g, dev, d, b = model.graph, model.device, HIDDEN, BATCH
    gen = torch.Generator(device=dev).manual_seed(12)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    n_grid, n_mesh = g.num_grid_nodes, g.num_mesh_nodes
    m2m, proc, n_mid = g.m2m[0], list(model.processor.values()), PROC_LAYERS - 2
    sites = [  # (site, net, edges, embedder, edge input, update_edges, calls, receivers)
        ("g2m", model.g2m_gnn, g.g2m, model.g2m_embedder, "raw", False, 1, n_mesh),
        ("m2m layer 0", proc[0], m2m, model.m2m_embedder, "raw", True, 1, n_mesh),
        (f"m2m layers 1-{n_mid}", proc[1], m2m, None, "batched", True, n_mid, n_mesh),
        (f"m2m layer {PROC_LAYERS - 1}", proc[-1], m2m, None, "batched", True, 1, n_mesh),
        ("m2g", model.m2g_gnn, g.m2g, model.m2g_embedder, "raw", False, 1, n_grid),
    ]
    # precision -> (bf16 operands, streams, outputs, counter suffix)
    precisions = {"float32": (False, torch.float32, torch.float32, ""),
                  "bf16": (True, bf16, bf16, " bf16"),
                  "bf16 operands": (True, torch.float32, torch.float32, " bf16 operands")}
    nfw, nbw = "K3 node update", "K4 node backward"
    accs = {f"{k}{sfx}": dict(ms=0.0, plain_ms=0.0, base_ms=0.0, bound_ms=0.0, ops_ms=0.0,
                              bytes_ms=0.0, err=0.0, dev_ms=0.0, k3_ms=0.0, k3_node_ms=0.0,
                              k3_node_dev_ms=0.0)
            for k in (nfw, nbw) for *_, sfx in precisions.values()}
    same = 0  # float32 K3 outputs compared with the parent's

    def add(name, calls, ms, plain_ms, base_ms, moved, flops, err, bf16_ops, **more):
        b_ms, b_by = bf16_bound(moved, flops) if bf16_ops else bound(moved, flops, tensor=True)
        a = accs[name]
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("base_ms", base_ms),
                         ("bound_ms", b_ms), ("ops_ms" if b_by == "operations" else
                                              "bytes_ms", b_ms), *more.items()):
            a[key] += calls * val
        a["err"] = max(a["err"], err)
        return b_ms, b_by

    def check(got, want, what, bf16_ops, tol=None) -> float:
        """Within the bf16 kernels' bounds, or in float32 K3's (outputs) or
        ``tol`` of the largest entry (gradients); the max abs error."""
        if bf16_ops:
            return bf16_check(got, want.to(got.dtype), what)
        a_err, r_err = errors(got, want)
        if tol is None:
            torch.testing.assert_close(got, want, rtol=K3_RTOL, atol=K3_ATOL, msg=what)
        elif r_err > tol:
            raise AssertionError(f"{what}: {r_err:.3g} of its largest value off (tol {tol})")
        return a_err

    with torch.no_grad():  # the launchers record no autograd graph
        for site, net, ge, emb, mode, update, calls, n_rec in sites:
            es, raw = ge.edges, mode == "raw"
            n_e, rows = es.num_edges, es.num_edges * b
            wts = fk._weights(net.edge_mlp, emb)
            nw = [w if w is None else w.float() for w in fk._node_weights(net.aggr_mlp)]
            params = [w for w in wts if w is not None]
            node_params = [w for w in nw if w is not None]
            x32, r32 = randn(n_e, b, d), randn(n_rec, b, d)
            e32 = ge.features.float() if raw else randn(n_e, b, d)
            for label, (bf16_ops, io, out, sfx) in precisions.items():
                x_send, rec, edge_in = x32.to(io), r32.to(io), e32.to(io)
                out_kw = dict(bf16_ops=bf16_ops, out_dtype=out if bf16_ops else None)
                args = (edge_in, x_send, rec, es, wts, raw, update, False)
                tail_mlp = copy.deepcopy(net.aggr_mlp).to(io)

                # ---- K3 on the route, then the node update ------------------------
                def k3():
                    return fk.fused_edge_fwd(*args, aggr_dtype=torch.float32, **out_kw)

                aggr, new_edge, _ = k3()

                def nu():
                    return fk.fused_node_fwd(rec, aggr, nw, bf16_ops, out)

                def k3_node():
                    return fk.fused_node_fwd(rec, k3()[0], nw, bf16_ops, out)

                def k3_and_tail():
                    aggr_t = fk.fused_edge_fwd(*args, **out_kw)[0]
                    return rec + apply_mlp_split_first(tail_mlp, (rec, aggr_t.to(io)))

                def plain3():
                    aggr_p, new_edge_p = fk._plain(edge_in.float(), x_send.float(), rec.float(),
                                                   es.receivers, wts, raw, update, False,
                                                   bf16_ops)
                    return fk._plain_node(rec.float(), aggr_p, nw, bf16_ops), new_edge_p

                def plain_nu():
                    return fk._plain_node(rec.float(), aggr, nw, bf16_ops)

                node, again = nu(), k3_node()
                aggr_k3 = fk.fused_edge_fwd(*args, bf16_ops=bf16_ops,
                                            out_dtype=torch.float32 if bf16_ops else None)[0]
                want_node, want_edge = plain3()
                torch.cuda.synchronize()
                if not (torch.equal(node, again) and torch.equal(aggr, aggr_k3)):
                    raise AssertionError(f"{nfw}{sfx} {site}: not repeatable, or K3's float32 "
                                         "aggregate is not K3's own")
                err = check(node, want_node.to(out), f"{nfw}{sfx} {site}", bf16_ops)
                if update:
                    err = max(err, check(new_edge, want_edge.to(out), f"K3{sfx} {site} new "
                                         "edges", bf16_ops))
                ms, plain_ms = cuda_ms(nu), cuda_ms(plain_nu)
                k3_ms, both_ms, base_ms = cuda_ms(k3), cuda_ms(k3_node), cuda_ms(k3_and_tail)
                dev_ms = k4_pieces(torch, nu)[0]["other"]
                both_dev = k4_pieces(torch, k3_node)[0]["other"]
                if not bf16_ops:
                    same += same_as_parent(parent, lambda: fk.fused_edge_fwd(
                        *args, aggr_dtype=torch.float32, save_pre=True), f"K3 {site}")
                moved = nbytes(rec, aggr, *node_params, node)
                flops = 3 * 2 * n_rec * b * d * d
                b_ms, b_by = add(f"{nfw}{sfx}", calls, ms, plain_ms, base_ms, moved, flops, err,
                                 bf16_ops, dev_ms=dev_ms, k3_ms=k3_ms, k3_node_ms=both_ms,
                                 k3_node_dev_ms=both_dev)
                log(f"{nfw}{sfx} {site}: E {n_e}, receivers {n_rec}, edge input {mode}; max abs "
                    f"err {err:.3g} against the plain version, repeatable, K3's float32 "
                    f"aggregate K3's own bits; node update {ms:.4f} ms (device "
                    f"{dev_ms:.4f} ms), K3 {k3_ms:.4f} ms, K3 + node update {both_ms:.4f} ms "
                    f"(device {both_dev:.4f} ms) against K3 plus the node tail with torch "
                    f"{base_ms:.4f} ms ({base_ms / both_ms:.2f} x); plain {plain_ms:.4f} ms; "
                    f"bound {b_ms:.4f} ms ({b_by}, {moved / 1e6:.1f} MB; {100 * b_ms / ms:.1f} "
                    f"% of it); {calls} call(s) per AR step")

                # ---- the node backward -------------------------------------------
                d_node = randn(n_rec, b, d).to(io)

                def nb():
                    return fk.fused_node_bwd(d_node, rec, aggr, nw, bf16_ops)

                def plain_nb():
                    return fk._plain_node_bwd(d_node.float(), rec.float(), aggr, nw, bf16_ops)

                leaves = [rec.detach().clone().requires_grad_(True),
                          aggr.detach().to(io, copy=True).requires_grad_(True),
                          *tail_mlp.parameters()]

                def tail_fwd_bwd():
                    with torch.enable_grad():
                        out_t = leaves[0] + apply_mlp_split_first(tail_mlp, tuple(leaves[:2]))
                        return torch.autograd.grad(out_t, leaves, d_node)

                got, again, want = nb(), nb(), plain_nb()
                torch.cuda.synchronize()
                flat_got = [got[0], got[1], *(t for t in got[2] if t is not None)]
                flat_again = [again[0], again[1], *(t for t in again[2] if t is not None)]
                flat_want = [want[0].to(io), want[1], *(t for t in want[2] if t is not None)]
                if not all(torch.equal(x, y) for x, y in zip(flat_got, flat_again)):
                    raise AssertionError(f"{nbw}{sfx} {site}: two runs differ")
                err = 0.0
                for i, (o, w) in enumerate(zip(flat_got, flat_want)):
                    err = max(err, check(o, w, f"{nbw}{sfx} {site} gradient {i}", bf16_ops,
                                         tol=K4_TOL))
                ms, plain_ms = cuda_ms(nb), cuda_ms(plain_nb)
                base_ms = cuda_ms(tail_fwd_bwd)
                moved = nbytes(rec, aggr, d_node, *node_params, *flat_got)
                flops = 9 * 2 * n_rec * b * d * d
                pieces, _ = k4_pieces(torch, nb)
                b_ms, b_by = add(f"{nbw}{sfx}", calls, ms, plain_ms, base_ms, moved, flops, err,
                                 bf16_ops, dev_ms=pieces["other"] + pieces["reduces"])
                blocks = fk._node_bwd_blocks(rec.device, n_rec * b)
                reduce_bound = bound(4 * (fk._WS_NODE * blocks + fk._WS_NODE), 0.0)[0]
                log(f"{nbw}{sfx} {site}: rows {n_rec * b}; max abs err {err:.3g} against the "
                    f"plain version (tol {K4_TOL} of each gradient's largest entry, or the bf16 "
                    f"bounds), repeatable; kernel {ms:.4f} ms against the node tail's forward "
                    f"and backward with torch {base_ms:.4f} ms; plain {plain_ms:.4f} ms; bound "
                    f"{b_ms:.4f} ms ({b_by}, {moved / 1e6:.1f} MB; {100 * b_ms / ms:.1f} % of "
                    f"it); {calls} call(s) per training step; split (torch.profiler, ms a "
                    f"call): the node backward {pieces['other']:.4f} ({blocks} blocks), its "
                    f"workspace reduce {pieces['reduces']:.4f} (bound {reduce_bound:.4f}, "
                    "bytes), one launch of each")
                del node, new_edge, again, aggr, aggr_k3, got, want, leaves, tail_mlp
            del x32, r32, e32
            torch.cuda.empty_cache()
    if parent is not None:
        parent_runs.append(parent_aggr_run(parent["dir"], "after"))
    for name, a in accs.items():
        sfx = name[len(nfw):] if name.startswith(nfw) else name[len(nbw):]
        old = [run[sfx] for run in parent_runs]
        if name.startswith(nfw):
            text = (f"{name} per AR step: {a['ms']:.4f} ms (device {a['dev_ms']:.4f} ms; bound "
                    f"{a['bound_ms']:.4f} ms, plain {a['plain_ms']:.4f} ms); K3 {a['k3_ms']:.4f} "
                    f"ms, K3 + node update {a['k3_node_ms']:.4f} ms (device "
                    f"{a['k3_node_dev_ms']:.4f} ms) against {a['base_ms']:.4f} ms with the node "
                    "tail in torch")
            if old:
                text += ("; the parent's K3 + node update "
                         + ", ".join(f"{r['k3_node_ms']:.4f}" for r in old)
                         + f" ms (its own script, before and after), "
                         f"{sum(r['k3_node_ms'] for r in old) / len(old) / a['k3_node_ms']:.3f} "
                         "x this K3 + node update's, same call")
        else:
            text = (f"{name} per training step: {a['ms']:.4f} ms against {a['base_ms']:.4f} ms "
                    f"unfused (bound {a['bound_ms']:.4f} ms, plain {a['plain_ms']:.4f} ms; "
                    f"device time (torch.profiler) {a['dev_ms']:.4f} ms, "
                    f"{100 * a['bound_ms'] / max(a['dev_ms'], 1e-9):.1f} % of the bound)")
            if old:
                text += ("; the parent's " + ", ".join(f"{r['bwd_ms']:.4f}" for r in old)
                         + " ms, device " + ", ".join(f"{r['bwd_dev_ms']:.4f}" for r in old)
                         + f" ms (its own script, before and after), "
                         f"{sum(r['bwd_dev_ms'] for r in old) / len(old) / a['dev_ms']:.3f} x "
                         "this one's device time, same call")
        log(text)
    if parent is not None:
        log(f"float32 K3 on the node-MLP route against the parent's K3 on the same inputs: "
            f"{same} outputs, every one the same bits")
    log_node_occupancy("fused aggr")

    # ---- HiLAM's ten level sets, float32, the phase through autograd -----------
    hg = hi_lam.graph
    net = hi_lam.mesh_init_gnns[0]
    mlp, amlp = net.edge_mlp, net.aggr_mlp
    params = list(mlp.parameters()) + list(amlp.parameters())
    for kind, sets in (("m2m", hg.m2m), ("up", hg.up), ("down", hg.down)):
        for i, ge in enumerate(sets):
            es = ge.edges
            x_send = randn(es.num_edges, b, d).requires_grad_(True)
            rec = randn(es.num_rec, b, d).requires_grad_(True)
            edge = randn(es.num_edges, b, d).requires_grad_(True)
            w_node, w_edge = randn(es.num_rec, b, d), randn(es.num_edges, b, d)
            leaves = [x_send, rec, edge] + params
            got = fk.fused_edge_phase(mlp, edge, x_send, rec, es, update_edges=True,
                                      aggr_mlp=amlp)
            want = fk.fused_edge_phase_plain(mlp, edge, x_send, rec, es.receivers,
                                             update_edges=True, aggr_mlp=amlp)
            got_g = torch.autograd.grad((got[0] * w_node).sum() + (got[1] * w_edge).sum(),
                                        leaves)
            want_g = torch.autograd.grad((want[0] * w_node).sum() + (want[1] * w_edge).sum(),
                                         leaves)
            torch.cuda.synchronize()
            err = max(check(o.detach(), w.detach(), f"{nfw} {kind}[{i}]", False)
                      for o, w in zip(got, want))
            accs[nfw]["err"] = max(accs[nfw]["err"], err)
            g_err = 0.0
            for j, (o, w) in enumerate(zip(got_g, want_g)):
                g_err = max(g_err, check(o, w, f"{nbw} {kind}[{i}] gradient {j}", False,
                                         tol=K4_TOL))
            accs[nbw]["err"] = max(accs[nbw]["err"], g_err)
            log(f"{nfw} level set {kind}[{i}]: E {es.num_edges}, receivers {es.num_rec}; "
                f"outputs max abs err {err:.3g}, every gradient (node backward, then K4) "
                f"max abs err {g_err:.3g} against the plain version")
    torch.cuda.empty_cache()
    source = {nfw: "fused_node.cu", nbw: "fused_node_bwd.cu"}
    replaces = {nfw: "neural_lam_tpu/ops/pallas_fused.py:335",
                nbw: "neural_lam_tpu/ops/pallas_fused.py:509"}
    return [bf16_entry(name, source[name.split(" bf16")[0]],
                       replaces[name.split(" bf16")[0]], a, None)
            for name, a in accs.items()]


def fused_aggr_expected(model, mode: str) -> dict[str, int]:
    """Launches per float32 training step under ``NEURAL_LAM_TPU_FUSED_AGGR=mode``."""
    with env_set(FUSED_AGGR, mode):
        return expected_launches(model, training=True)


def phase_fused_aggr(torch, model, forecaster, gate_ds, serve_ds, card: str) -> dict[str, int]:
    """The main paths under ``NEURAL_LAM_TPU_FUSED_AGGR=on``: the accuracy
    gate through the captured forecast; GraphLAM's served request (eager
    against captured, the same bits expected) and training step (12 eager
    steps, 12 captured, the same losses), the training gate eagerly and
    captured; mixed-precision training (``others=False``: also
    ``--bf16_kernels off``, ``high`` and ``high-kernels``) and the bf16
    rollout; HiLAM's model gate, served request and captured step
    (:func:`drive_gate_model`), each at its existing bounds. Then the
    captured float32 step under ``off`` and ``on`` in one call
    (:func:`compare_train_modes`). Returns the launches."""
    total: dict[str, int] = {}
    with env_set(FUSED_AGGR, "on"):
        log(f"fused aggr: the main paths with {FUSED_AGGR}=on")
        load_gate_params(model)  # earlier phases trained the gate's weights in place
        phase_gate(torch, gate_ds, forecaster)
        add_launches(total, phase_serve(torch, serve_ds, model, card), "fused aggr serve")
        phase_train_gate(torch, make_trainer(model, gate_ds), TRAIN_FIXTURE)
        launches, eager = phase_train(torch, make_trainer(model, gate_ds), card)
        add_launches(total, launches, "fused aggr train")
        add_launches(
            total, phase_train_graph(torch, make_trainer(model, gate_ds), card, eager),
            "fused aggr train graph",
        )
        phase_train_gate(torch, make_trainer(model, gate_ds), TRAIN_FIXTURE, captured=True)
        add_launches(total, phase_bf16_train(torch, model, gate_ds, card, others=False),
                     "fused aggr bf16 train")
        add_launches(total, phase_bf16_rollout(torch, gate_ds), "fused aggr bf16 rollout")
        drive_gate_model(torch, "hi_lam", gate_ds, serve_ds, card, total)
    tols = {mode: (TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL) for mode in ("off", "on")}
    add_launches(total, compare_train_modes(torch, model, gate_ds, card, "fused aggr",
                                            FUSED_AGGR, tols, fused_aggr_expected),
                 "fused aggr off/on")
    return total


# -- dp: data-parallel training over torch.distributed ---------------------


@contextlib.contextmanager
def launch_env(world: int, rank: int, port: int):
    """``torchrun``'s environment for rank ``rank`` of ``world`` on one
    node, restored after."""
    values = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                  RANK=str(rank), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    with contextlib.ExitStack() as stack:
        for name, value in values.items():
            stack.enter_context(env_set(name, value))
        yield


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_eval_loader(ds, layout=None):
    """The gates' validation split (5 samples at ``ar_steps`` 1) in node
    batches of ``BATCH``, a tail of 1; with ``layout``, the rank's blocks."""
    from neural_lam_tpu_torch.dataset import WeatherDataset
    from neural_lam_tpu_torch.loader import DataLoader

    blocks = {} if layout is None else dict(block_index=layout.local_rank,
                                            num_blocks=layout.local_world)
    return DataLoader(WeatherDataset(ds, "val", ar_steps=1), BATCH, prefetch=0, **blocks)


def dp_captured(torch, trainer, data, label: str, card: str) -> dict:
    """``TRAIN_WARMUP + TRAIN_ITERS`` replays of ``trainer``'s captured step
    (the counters at 0 just before), two more under the profiler: step
    time, device busy, kernels a replay, peak memory and the launches,
    ``expected_launches`` a step by the counters (the warm-up steps and the
    capture) and by the graph's kernel nodes."""
    from neural_lam_tpu_torch.trainer import GRAPH_WARMUP_STEPS

    model = trainer.forecaster.predictor
    counters = kernel_counters()
    # the gradients an earlier trainer's graph left in the parameters would
    # hold its memory pool through the peak read here
    trainer.optimizer.zero_grad(set_to_none=True)
    release(torch)
    held = torch.cuda.memory_allocated()
    for fn in counters.values():
        fn.launches = 0
    step = trainer.make_train_step()
    run = timed_steps(torch, step, data)
    first = {name: fn.launches for name, fn in counters.items()}
    (entry,) = trainer.graphs.values()
    replay = graph_kernels(torch, entry.graph)
    nodes = graph_kernel_names(torch, entry.graph)
    busy, kernels = device_kernels(torch, lambda: step(*data))
    steps = TRAIN_WARMUP + TRAIN_ITERS + 2
    launches = {}
    for name, per_step in expected_launches(model, training=True).items():
        if first[name] != per_step * (GRAPH_WARMUP_STEPS + 1) or replay[name] != per_step:
            raise AssertionError(f"dp {label}: {name}: {first[name]} counted, {replay[name]} "
                                 f"in the graph, want {per_step} a step")
        launches[name] = first[name] - replay[name] + replay[name] * steps
    if not np.isfinite(run["losses"]).all():
        raise AssertionError(f"dp {label}: non-finite loss")
    nccl = sum("nccl" in n.lower() for n in nodes)
    log(f"dp {label} on {card}: captured step {run['step_ms']:.3f} ms (device busy "
        f"{busy:.3f} ms, {kernels} kernels a replay in the profile; the graph's "
        f"{len(nodes)} kernel nodes, {nccl} of them NCCL's), "
        f"{BATCH * trainer.datastore.num_grid_points / (run['step_ms'] / 1e3):,.0f} training "
        f"grid-points/s, peak device memory {run['peak'] / 2**30:.3f} GiB, of it "
        f"{(run['peak'] - held) / 2**30:.3f} GiB above what was held before the first call")
    return dict(run, busy=busy, kernels=kernels, nodes=len(nodes), launches=launches,
                step_peak=run["peak"] - held)


def dp_eager_against_captured(torch, model, ds, label: str, **train_args) -> None:
    """``TRAIN_WARMUP + TRAIN_ITERS`` eager steps and as many replays of
    the captured step, each from the gate's weights on the bench batch:
    the losses and the weights after, bit for bit."""
    from neural_lam_tpu_torch.convert_checkpoint import params_to_numpy

    data = [torch.from_numpy(a).to(DEVICE) for a in bench_batch(ds)]
    runs = []
    for captured in (False, True):
        trainer = make_trainer(model, ds, **train_args)
        step = trainer.make_train_step() if captured else trainer.train_step
        losses = [step(*data) for _ in range(TRAIN_WARMUP + TRAIN_ITERS)]
        runs.append((torch.stack(losses).cpu().numpy(), params_to_numpy(model)))
        del trainer, step
        release(torch)
    (eager, w_eager), (graph, w_graph) = runs
    same = sum(int(np.sum(w_eager[k] == w_graph[k])) for k in w_eager)
    total = sum(w.size for w in w_eager.values())
    log(f"dp {label}: captured against eager over {len(eager)} steps: losses "
        f"{int(np.sum(eager == graph))} of {len(eager)} the same bits, weights after "
        f"{same} of {total} entries the same bits")
    if not (np.array_equal(eager, graph) and same == total):
        raise AssertionError(f"dp {label}: the captured step differs from the eager step")


def phase_dp(torch, model, ds, card: str) -> dict[str, int]:
    """Data-parallel training (``torch.distributed``), GraphLAM at the
    bench configuration:

    1. the captured step without a process group (``torch.optim.AdamW``),
       the one-rank eager run of the training gate and one process's
       ``evaluate``: the references;
    2. an NCCL group of one rank in this process: under ZeRO-1
       (``shard_opt_state``, ``FlatAdamW`` sharded over the group, its
       all-reduce and all-gather inside the graph) and under ``flat_opt``,
       the training gate through the captured step, captured against eager
       bit for bit, and step time, device busy, kernels a replay and peak
       memory beside step 1's;
    3. two gloo ranks on this card (:func:`dp_rank_main`, each its own
       process with a deadline), each on 2 of the bench batch's 4 samples:
       eager steps launching K1-K4 on the card, their losses and the mean
       gradients against step 1's one-rank run at the gate's bounds, and
       the merged ``evaluate`` (a tail of one sample, below the rank count)
       against one process's at 1e-6.

    Returns each kernel's launches in this phase (the ranks' included)."""
    from neural_lam_tpu_torch.optim import FlatAdamW
    from neural_lam_tpu_torch.utils import distributed

    t0 = time.perf_counter()
    total: dict[str, int] = {}
    data = [torch.from_numpy(a).to(DEVICE) for a in bench_batch(ds)]
    base = dp_captured(torch, make_trainer(model, ds), data, "no process group", card)
    add_launches(total, base["launches"], "dp no group train graph")
    ref_losses, ref_grads = train_gate_run(torch, make_trainer(model, ds), BATCH, 4)
    ref_eval = make_trainer(model, ds).evaluate(dp_eval_loader(ds))
    release(torch)

    with launch_env(1, 0, free_port()):
        distributed.init_from_env("nccl")
    try:
        for label, args in (("ZeRO-1", dict(shard_opt_state=True)),
                            ("flat_opt", dict(flat_opt=True))):
            trainer = make_trainer(model, ds, **args)
            if not isinstance(trainer.optimizer, FlatAdamW):
                raise AssertionError(f"dp {label}: the optimizer is not FlatAdamW")
            log(f"dp NCCL world 1, {label}: training gate through the captured step:")
            phase_train_gate(torch, trainer, TRAIN_FIXTURE, captured=True)
            del trainer
            dp_eager_against_captured(torch, model, ds, f"NCCL world 1, {label}", **args)
            run = dp_captured(torch, make_trainer(model, ds, **args), data,
                              f"NCCL world 1, {label}", card)
            add_launches(total, run["launches"], f"dp {label} train graph")
            log(f"dp {label} against no process group (same call, {card}): step "
                f"{run['step_ms'] / base['step_ms']:.3f} x "
                f"({run['step_ms'] - base['step_ms']:+.3f} ms), device busy "
                f"{run['busy'] - base['busy']:+.3f} ms, kernel nodes a replay "
                f"{run['nodes'] - base['nodes']:+d}, peak above what was held before "
                f"{(run['step_peak'] - base['step_peak']) / 2**30:+.3f} GiB")
            release(torch)
    finally:
        distributed.destroy()

    out = CACHE / "dp"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    port = free_port()
    procs = []
    t0 = time.perf_counter()
    for rank in range(DP_RANKS):
        with launch_env(DP_RANKS, rank, port):
            procs.append(subprocess.Popen(
                [sys.executable, str(REPO / "chip_smoke.py"), "--dp-rank", str(out)],
                env=dict(os.environ), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ))
    try:
        logs = [p.communicate(timeout=DP_RANK_TIMEOUT_S)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for rank, p in enumerate(procs):  # what each rank had done
            for line in (p.communicate()[0] or "").splitlines()[-30:]:
                log(f"  rank {rank} (stopped): {line}")
        raise AssertionError(f"dp gloo ranks: not done in {DP_RANK_TIMEOUT_S} s")
    log(f"dp gloo ranks: done in {time.perf_counter() - t0:.1f} s (limit {DP_RANK_TIMEOUT_S} s)")
    for rank, (p, text) in enumerate(zip(procs, logs)):
        for line in text.splitlines():
            log(f"  rank {rank}: {line}")
        if p.returncode != 0:
            raise AssertionError(f"dp gloo rank {rank} failed (exit {p.returncode})")
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(DP_RANKS)]
    losses = [r["losses"] for r in ranks]
    if not all(np.array_equal(losses[0], l) for l in losses[1:]):
        raise AssertionError("dp gloo ranks: the ranks' losses differ")
    rels = np.abs(losses[0] - ref_losses) / np.abs(ref_losses)
    grad_rel = max(float(np.abs(ranks[0][f"grad/{k}"] - w).max() / max(np.abs(w).max(), 1e-30))
                   for k, w in ref_grads.items())
    for r in ranks[1:]:
        if any(not np.array_equal(r[f"grad/{k}"], ranks[0][f"grad/{k}"]) for k in ref_grads):
            raise AssertionError("dp gloo ranks: the ranks' gradients differ")
    log(f"dp {DP_RANKS} gloo ranks on {card}, 2 samples each: losses "
        f"{', '.join(f'{x:.8g}' for x in losses[0])} on every rank, against the one-rank "
        f"run's {', '.join(f'{x:.8g}' for x in ref_losses)} (rel {rels[0]:.3e}, tol "
        f"{TRAIN_LOSS_RTOL}; then up to {rels[1:].max():.3e}, tol {TRAIN_TRAJ_RTOL}); "
        f"{len(ref_grads)} mean gradients, worst {grad_rel:.3e} of its largest entry "
        f"(tol {TRAIN_GRAD_TOL})")
    if rels[0] > TRAIN_LOSS_RTOL or rels[1:].max() > TRAIN_TRAJ_RTOL or grad_rel > TRAIN_GRAD_TOL:
        raise AssertionError("dp gloo ranks: outside the training gate's bounds")
    keys = sorted(ref_eval)
    for r in ranks:
        got = {k: float(r[f"eval/{k}"]) for k in keys}
        worst = max(abs(got[k] - ref_eval[k]) / max(abs(ref_eval[k]), 1e-30) for k in keys)
        if worst > DP_EVAL_RTOL:
            raise AssertionError(f"dp gloo ranks: merged evaluate off by {worst:.3e}")
    log(f"dp {DP_RANKS} gloo ranks: merged evaluate {json.dumps(got)} against one "
        f"process's {json.dumps(ref_eval)} (max rel {worst:.3e}, tol {DP_EVAL_RTOL})")
    for r in ranks:
        add_launches(total, {k[len("launches/"):]: int(v) for k, v in r.items()
                             if k.startswith("launches/")}, "dp gloo rank")
    log(f"dp phase: {time.perf_counter() - t0:.1f} s on {card}")
    return total


def dp_rank_main(out: Path) -> int:
    """One gloo rank of :func:`phase_dp`, in its own process on the card:
    GraphLAM with the gate's weights, ``evaluate`` through its blocks, then
    ``TRAIN_WARMUP + 2`` eager steps on its 2 samples of the bench batch
    (the counters at 0 just before; each must read ``expected_launches``
    a step after) and the mean gradients of the first; written to
    ``out/rank<r>.npz``."""
    t0 = time.perf_counter()
    import torch

    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from neural_lam_tpu_torch.convert_checkpoint import grads_to_numpy
    from neural_lam_tpu_torch.models import GraphLAM
    from neural_lam_tpu_torch.utils import distributed

    def stage(what):  # progress, read by phase_dp if the rank overruns its time
        print(f"{time.perf_counter() - t0:.1f} s: {what}", flush=True)

    distributed.init_from_env("gloo")
    lay = distributed.layout()
    stage(f"rank {lay.rank} joined the group")
    ds = meps_datastores()[0]
    model = GraphLAM(ds, hidden_dim=HIDDEN, processor_layers=PROC_LAYERS, device=DEVICE)
    trainer = make_trainer(model, ds)
    stage("model built")
    per = BATCH // lay.world
    data = [torch.from_numpy(a[lay.rank * per:(lay.rank + 1) * per]).to(DEVICE)
            for a in bench_batch(ds)]
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    # evaluate from the gate's weights, then train
    result = trainer.evaluate(dp_eval_loader(ds, lay))
    torch.cuda.synchronize()
    stage("evaluated")
    evaluated = {name: fn.launches for name, fn in counters.items()}
    for fn in counters.values():
        fn.launches = 0
    losses = [trainer.train_step(*data).item()]
    grads = grads_to_numpy(model)
    losses += [trainer.train_step(*data).item() for _ in range(3)]
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    for name, per_step in expected_launches(model, training=True).items():
        if launches[name] != 4 * per_step:
            raise AssertionError(f"rank {lay.rank}: {name} {launches[name]} launches, want "
                                 f"{4 * per_step}")
        launches[name] += evaluated[name]
    np.savez(out / f"rank{lay.rank}.npz", losses=np.array(losses),
             **{f"grad/{k}": v for k, v in grads.items()},
             **{f"eval/{k}": v for k, v in result.items()},
             **{f"launches/{k}": v for k, v in launches.items()})
    print(f"rank {lay.rank} of {lay.world} ({torch.cuda.get_device_name(0)}): losses "
          f"{', '.join(f'{x:.8g}' for x in losses)}; launches "
          f"{', '.join(f'{k} {v}' for k, v in launches.items() if v)}", flush=True)
    distributed.destroy()
    return 0


def dp_cards_main() -> int:
    """GraphLAM's captured data-parallel step at the bench configuration
    over every card of a machine, one rank each, NCCL between them:
    ``python -m torch.distributed.run --nproc_per_node=N chip_smoke.py
    --dp-cards``. Each rank takes ``BATCH / N`` of the bench batch; under
    ZeRO-1, replicated moments and ``flat_opt``: the training gate through
    the captured step (the loss, the mean gradients and 3 further losses
    against the fixture at its bounds, the same losses on every rank), 12
    captured steps against 12 eager ones (losses and weights, every bit),
    the step time, the global training grid-points/s and the graph's
    kernel nodes, NCCL's among them. Rank 0 prints."""
    import torch

    from neural_lam_tpu_torch.convert_checkpoint import grads_to_numpy, params_to_numpy
    from neural_lam_tpu_torch.ops import kernel_build
    from neural_lam_tpu_torch.utils import distributed

    global DEVICE
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launch = distributed.launch_layout()
    torch.cuda.set_device(launch.local_rank)
    DEVICE = f"cuda:{launch.local_rank}"
    keep_cuda_graphs(torch)
    distributed.init_from_env("nccl")
    lay = distributed.layout()
    say = log if lay.rank == 0 else (lambda msg: None)
    card = card_line()
    t0 = time.perf_counter()
    if lay.local_rank == 0:
        kernel_build.build()
    distributed.barrier()
    say(f"dp cards: {lay.world} ranks on {card}; kernel build {time.perf_counter() - t0:.1f} s")
    CACHE.mkdir(exist_ok=True)
    if lay.rank == 0:  # the graph is built once, on disk
        gate_ds, _, model, _ = build_meps(torch)
    distributed.barrier()
    if lay.rank != 0:
        gate_ds, _, model, _ = build_meps(torch)
    with np.load(TRAIN_FIXTURE) as fx:
        want = fx["losses"].astype(np.float64)
        want_grads = {k[len("grad/"):]: fx[k] for k in fx.files if k.startswith("grad/")}
    per = BATCH // lay.world
    data = [torch.from_numpy(a[lay.rank * per:(lay.rank + 1) * per]).to(DEVICE)
            for a in bench_batch(gate_ds)]
    for label, args in (("ZeRO-1", {}), ("replicated", dict(shard_opt_state=False)),
                        ("flat_opt", dict(flat_opt=True))):
        trainer = make_trainer(model, gate_ds, **args)
        step = trainer.make_train_step()
        losses = [step(*data).item()]
        grads = grads_to_numpy(model)
        losses += [step(*data).item() for _ in range(len(want) - 1)]
        rels = np.abs(np.array(losses) - want) / np.abs(want)
        worst = max(float(np.abs(grads[k] - w).max() / max(np.abs(w).max(), 1e-30))
                    for k, w in want_grads.items())
        gathered = distributed.allgather_sums(np.array(losses))
        same_ranks = bool((gathered == gathered[0]).all())
        del trainer, step
        runs = []
        for captured in (False, True):
            trainer = make_trainer(model, gate_ds, **args)
            step = trainer.make_train_step() if captured else trainer.train_step
            run_losses = torch.stack([step(*data) for _ in range(TRAIN_WARMUP + TRAIN_ITERS)])
            runs.append((run_losses.cpu().numpy(), params_to_numpy(model)))
            del trainer, step
            release(torch)
        (eager, w_eager), (graph, w_graph) = runs
        bits = np.array_equal(eager, graph) and all(
            np.array_equal(w_eager[k], w_graph[k]) for k in w_eager)
        trainer = make_trainer(model, gate_ds, **args)
        step = trainer.make_train_step()
        run = timed_steps(torch, step, data)
        (entry,) = trainer.graphs.values()
        nodes = graph_kernel_names(torch, entry.graph)
        nccl = sum("nccl" in n.lower() for n in nodes)
        say(f"dp {lay.world} cards NCCL, {label} on {card}: gate loss rel {rels[0]:.3e} (tol "
            f"{TRAIN_LOSS_RTOL}), worst mean gradient {worst:.3e} of its largest entry (tol "
            f"{TRAIN_GRAD_TOL}), {len(want) - 1} further losses up to {rels[1:].max():.3e} (tol "
            f"{TRAIN_TRAJ_RTOL}), the same losses on every rank: {same_ranks}; captured "
            f"against eager over {len(eager)} steps, losses and weights every bit: {bits}; "
            f"captured step {run['step_ms']:.3f} ms at {per} sample(s) a rank, "
            f"{BATCH * gate_ds.num_grid_points / (run['step_ms'] / 1e3):,.0f} global training "
            f"grid-points/s; {len(nodes)} kernel nodes a replay, {nccl} of them NCCL's; peak "
            f"device memory {run['peak'] / 2**30:.3f} GiB")
        if (rels[0] > TRAIN_LOSS_RTOL or worst > TRAIN_GRAD_TOL
                or rels[1:].max() > TRAIN_TRAJ_RTOL or not same_ranks):
            raise AssertionError(f"dp cards {label}: outside the training gate's bounds")
        del trainer, step, entry
        release(torch)
    distributed.destroy()
    return 0


def spatial_sets(sharded) -> list:
    """A shard's edge sets, ``(name, GraphEdges)``, by the metas' names."""
    g = sharded.graph
    return ([("g2m", g.g2m), ("m2g", g.m2g)]
            + [(f"m2m{i}", ge) for i, ge in enumerate(g.m2m)]
            + [(f"up{i}", ge) for i, ge in enumerate(g.up)]
            + [(f"down{i}", ge) for i, ge in enumerate(g.down)])


def spatial_rounds(model) -> dict[str, int]:
    """Forward exchanges of each edge set in one GraphLAM step: the m2m set
    once per processor layer, the others once."""
    return {"m2m0": model.processor_layers}


def pack_launches(sharded, rounds: dict[str, int]) -> int:
    """K1 launches (and K2's, backward) that a training step adds on this
    shard: one halo payload pack per exchange that sends rows."""
    return sum(rounds.get(name, 1) for name, ge in spatial_sets(sharded)
               if ge.exchange.pack is not None)


def exchange_summary(sharded, records, steps: int) -> dict:
    """Per edge set on this shard: strategy, offsets, halo rows received
    and sent per exchange, and the bytes received per training step (the
    records of ``steps`` steps)."""
    from neural_lam_tpu_torch.parallel.collective_budget import recorded_bytes

    got = recorded_bytes(records)
    out = {}
    for name, meta in sharded.metas.items():
        sent = (meta.n_send_local * (meta.n_shards - 1) if meta.strategy == "all_gather"
                else sum(meta.send_plan(sharded.shard)[1]))
        out[name] = dict(strategy=meta.strategy, offsets=list(meta.offsets),
                         recv_rows=meta.recv_rows(sharded.shard), sent_rows=sent,
                         bytes_per_step=got.get(name, 0) // steps)
    return out


def check_exchange_bytes(summaries: list[dict], metas: dict, rounds: dict, batch_local: int,
                         label: str) -> None:
    """The bytes the ranks of one spatial group received per step, per edge
    set, against ``analytic_budget``'s ``bytes_per_step_shards`` (every byte
    equal), logged beside the strategy and the halo rows."""
    from neural_lam_tpu_torch.parallel.collective_budget import analytic_budget

    budget = {a["edge_set"]: a for a in analytic_budget(metas, batch_local, HIDDEN,
                                                          rounds=rounds)}
    for name, a in budget.items():
        got = sum(s[name]["bytes_per_step"] for s in summaries)
        log(f"{label} {name}: {a['strategy']}, offsets {a['offsets']}, halo rows received "
            f"per exchange by shard {[s[name]['recv_rows'] for s in summaries]}, sent "
            f"{[s[name]['sent_rows'] for s in summaries]}; {a['exchanges_per_step']} exchanges "
            f"a step; bytes received a step {[s[name]['bytes_per_step'] for s in summaries]}, "
            f"sum {got:,} against analytic_budget's {a['bytes_per_step_shards']:,}")
        if got != a["bytes_per_step_shards"]:
            raise AssertionError(f"{label} {name}: {got} bytes a step, the budget says "
                                 f"{a['bytes_per_step_shards']}")


def phase_spatial(torch, model, ds, card: str) -> tuple[dict[str, int], dict]:
    """Spatial partitioning (``parallel/spatial.py``), GraphLAM at the bench
    configuration:

    (a) the executor at ``S = 1`` in an NCCL group of one rank in this
        process: the training gate through the captured step, captured
        against eager bit for bit over 12 steps, and the captured step's
        time beside the replicated step's in the same group (both ZeRO-1);
    (c) K1-K4 at shard 0's shapes of the six sites at ``S = 2`` (its g2m,
        m2m and m2g edge sets over the extended sender rows) against their
        plain versions (``phase_level_sets``);
    (b) two gloo ranks on this card as ``S = 2`` (:func:`spatial_rank_main`,
        each its own process with a deadline), eager: the accuracy gate of
        the sharded 19-step forecast, the training gate, each edge set's
        strategy, halo rows and bytes a step beside ``analytic_budget``,
        and HiLAM's model gate (its coarse levels on ``all_gather``).

    Returns each kernel's launches in this phase (the ranks' included) and
    each of K1-K4's largest error in (c)."""
    t0 = time.perf_counter()
    total = spatial_one_shard(torch, model, ds, card)
    shard0, errs = spatial_shard_kernels(torch, model, ds)
    add_launches(total, spatial_gloo_ranks(torch, model, shard0, card), "spatial gloo ranks")
    log(f"spatial phase: {time.perf_counter() - t0:.1f} s on {card}")
    return total, errs


def spatial_one_shard(torch, model, ds, card: str) -> dict[str, int]:
    """:func:`phase_spatial`'s (a); returns the launches of its captured
    steps."""
    from neural_lam_tpu_torch.utils import distributed

    total: dict[str, int] = {}
    data = [torch.from_numpy(a).to(DEVICE) for a in bench_batch(ds)]
    with launch_env(1, 0, free_port()):
        distributed.init_from_env("nccl")
    try:
        trainer = make_trainer(model, ds, spatial_shards=1)
        log("spatial S=1, NCCL world 1: training gate through the captured step:")
        phase_train_gate(torch, trainer, TRAIN_FIXTURE, captured=True)
        del trainer
        dp_eager_against_captured(torch, model, ds, "spatial S=1, NCCL world 1",
                                  spatial_shards=1)
        base = dp_captured(torch, make_trainer(model, ds), data,
                           "spatial: replicated step, NCCL world 1", card)
        add_launches(total, base["launches"], "spatial replicated train graph")
        release(torch)
        run = dp_captured(torch, make_trainer(model, ds, spatial_shards=1), data,
                          "spatial S=1, NCCL world 1", card)
        add_launches(total, run["launches"], "spatial S=1 train graph")
        log(f"spatial S=1 against the replicated step (same call, same group, {card}): "
            f"step {run['step_ms'] / base['step_ms']:.4f} x ({run['step_ms'] - base['step_ms']:+.3f}"
            f" ms), device busy {run['busy'] - base['busy']:+.3f} ms, kernel nodes a replay "
            f"{run['nodes'] - base['nodes']:+d}, peak above what was held before "
            f"{(run['step_peak'] - base['step_peak']) / 2**30:+.3f} GiB")
        release(torch)
    finally:
        distributed.destroy()
    return total


def spatial_shard_kernels(torch, model, ds):
    """:func:`phase_spatial`'s (c): shard 0 of ``SPATIAL_RANKS`` (its tables,
    built without a process group) and K1-K4 on its g2m, m2m and m2g edge
    sets; returns the shard and K1-K4's largest errors."""
    from neural_lam_tpu_torch.parallel.spatial import ShardedModel

    shard0 = ShardedModel(model, ds, SPATIAL_RANKS, shard=0)
    g = shard0.graph
    errs = phase_level_sets(
        torch, model, sites=[("g2m", g.g2m), ("m2m", g.m2m[0]), ("m2g", g.m2g)],
        mlp=model.processor["module_0"].edge_mlp, label=f"shard 0 of {SPATIAL_RANKS}")
    for name, ge in spatial_sets(shard0):
        meta = shard0.metas[name]
        log(f"spatial shard 0 of {SPATIAL_RANKS} {name}: {ge.edges.num_edges} edges into "
            f"{meta.n_rec_local} receivers, {ge.edges.num_send} sender rows ({meta.n_send_local} "
            f"own, {meta.recv_rows(0)} halo), {meta.strategy}, offsets {list(meta.offsets)}")
    return shard0, errs


def spatial_gloo_ranks(torch, model, shard0, card: str) -> dict[str, int]:
    """:func:`phase_spatial`'s (b): the ranks' processes, their results
    checked here; returns their launches."""
    total: dict[str, int] = {}
    out = CACHE / "spatial"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    port = free_port()
    procs = []
    for rank in range(SPATIAL_RANKS):
        with launch_env(SPATIAL_RANKS, rank, port):
            procs.append(subprocess.Popen(
                [sys.executable, str(REPO / "chip_smoke.py"), "--spatial-rank", str(out)],
                env=dict(os.environ), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ))
    try:
        logs = [p.communicate(timeout=SPATIAL_RANK_TIMEOUT_S)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"spatial gloo ranks: not done in {SPATIAL_RANK_TIMEOUT_S} s")
    for rank, (p, text) in enumerate(zip(procs, logs)):
        for line in text.splitlines():
            log(f"  rank {rank}: {line}")
        if p.returncode != 0:
            raise AssertionError(f"spatial gloo rank {rank} failed (exit {p.returncode})")
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(SPATIAL_RANKS)]
    losses = [r["losses"] for r in ranks]
    if not all(np.array_equal(losses[0], l) for l in losses[1:]):
        raise AssertionError("spatial gloo ranks: the ranks' losses differ")
    check_exchange_bytes([json.loads(str(r["exchange"])) for r in ranks], shard0.metas,
                         spatial_rounds(model), BATCH,
                         f"spatial S={SPATIAL_RANKS} gloo ranks, {card}:")
    for r in ranks:
        add_launches(total, {k[len("launches/"):]: int(v) for k, v in r.items()
                             if k.startswith("launches/")}, "spatial gloo rank")
    return total


def spatial_rank_main(out: Path) -> int:
    """One gloo rank of :func:`phase_spatial`'s ``S = 2`` on the card, in its
    own process: GraphLAM with the gate's weights, the sharded 19-step
    forecast against the accuracy gate, then the training gate's four eager
    steps with the collectives recorded (the counters at 0 just before;
    each kernel must read ``expected_launches`` a step after, K1 and K2 the
    halo packs besides), then HiLAM's model gate sharded; written to
    ``out/rank<r>.npz``."""
    import torch

    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from neural_lam_tpu_torch.models import GraphLAM
    from neural_lam_tpu_torch.parallel.spatial import record_collectives
    from neural_lam_tpu_torch.utils import distributed

    distributed.init_from_env("gloo")
    lay = distributed.layout()
    t0 = time.perf_counter()
    ds = meps_datastores()[0]
    model = GraphLAM(ds, hidden_dim=HIDDEN, processor_layers=PROC_LAYERS, device=DEVICE)
    trainer = make_trainer(model, ds, spatial_shards=lay.world)
    sp = trainer.spatial
    with torch.no_grad():
        pred, _ = trainer._local_fc(
            *(torch.from_numpy(sp.grid_slab(a)).to(DEVICE) for a in gate_inputs(ds)))
        pred = sp.gather_grid(pred).cpu().numpy()
    gate_check(pred, f"sharded forecast, S={lay.world}, gloo, eager")
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    steps = 4
    with record_collectives() as records:
        gate = phase_train_gate(torch, trainer, TRAIN_FIXTURE)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    packs = pack_launches(sp, spatial_rounds(model))
    for name, per_step in expected_launches(model, training=True).items():
        want = steps * (per_step + (packs if name in ("K1 sender_gather",
                                                       "K2 sender_scatter") else 0))
        if launches[name] != want:
            raise AssertionError(f"rank {lay.rank}: {name} {launches[name]} launches, want "
                                 f"{want}")
    losses = np.array(gate["losses"])
    exchange = exchange_summary(sp, records, steps)
    del trainer, model
    torch.cuda.empty_cache()
    hi_lam = build_model(torch, "hi_lam", ds)
    for fn in counters.values():
        fn.launches = 0
    phase_model_gate(torch, "hi_lam", hi_lam, ds, gate_fixture("hi_lam"),
                     spatial_shards=lay.world)
    torch.cuda.synchronize()
    for name, fn in counters.items():
        launches[name] += fn.launches
    np.savez(out / f"rank{lay.rank}.npz", losses=losses, exchange=json.dumps(exchange),
             **{f"launches/{k}": v for k, v in launches.items()})
    print(f"rank {lay.rank} of {lay.world} ({torch.cuda.get_device_name(0)}): "
          f"{time.perf_counter() - t0:.1f} s; launches "
          f"{', '.join(f'{k} {v}' for k, v in launches.items() if v)}", flush=True)
    distributed.destroy()
    return 0


def spatial_cards_main() -> int:
    """GraphLAM's captured step under spatial partitioning over every card of
    a machine, one rank each, NCCL between them: ``python -m
    torch.distributed.run --nproc_per_node=N chip_smoke.py --spatial-cards``.
    At ``S x D`` = N x 1 and, for an even N above 2, N/2 x 2, each spatial
    group on its data block of the bench batch: the training gate through
    the captured step (the same losses on every rank), 12 captured steps
    against 12 eager ones (losses and weights, every bit), the step time and
    the global training grid-points/s, the graph's kernel nodes (NCCL's
    among them), and the exchange bytes of an eager step against
    ``analytic_budget``. Rank 0 prints."""
    import torch

    from neural_lam_tpu_torch.convert_checkpoint import params_to_numpy
    from neural_lam_tpu_torch.ops import kernel_build
    from neural_lam_tpu_torch.parallel.spatial import record_collectives
    from neural_lam_tpu_torch.utils import distributed

    global DEVICE
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launch = distributed.launch_layout()
    torch.cuda.set_device(launch.local_rank)
    DEVICE = f"cuda:{launch.local_rank}"
    keep_cuda_graphs(torch)
    distributed.init_from_env("nccl")
    lay = distributed.layout()
    if lay.rank != 0:  # rank 0 prints, every rank checks
        global log
        log = lambda msg: None  # noqa: E731
    say = log
    card = card_line()
    t0 = time.perf_counter()
    if lay.local_rank == 0:
        kernel_build.build()
    distributed.barrier()
    say(f"spatial cards: {lay.world} ranks on {card}; kernel build "
        f"{time.perf_counter() - t0:.1f} s")
    CACHE.mkdir(exist_ok=True)
    if lay.rank == 0:  # the graph is built once, on disk
        gate_ds, _, model, _ = build_meps(torch)
    distributed.barrier()
    if lay.rank != 0:
        gate_ds, _, model, _ = build_meps(torch)
    layouts = [lay.world] + ([lay.world // 2] if lay.world > 2 and lay.world % 2 == 0 else [])
    for shards in layouts:
        groups = lay.world // shards
        per = BATCH // groups
        d = lay.rank // shards
        batch = [a[d * per:(d + 1) * per] for a in bench_batch(gate_ds)]
        data = [torch.from_numpy(a).to(DEVICE) for a in batch]
        label = f"spatial {shards} x {groups} cards NCCL"
        # each data group on its block: their mean is the bench batch's gate
        say(f"{label}: training gate through the captured step:")
        phase_train_gate(torch, make_trainer(model, gate_ds, spatial_shards=shards),
                         TRAIN_FIXTURE, captured=True, block=slice(d * per, (d + 1) * per))
        runs = []
        for captured in (False, True):
            trainer = make_trainer(model, gate_ds, spatial_shards=shards)
            step = trainer.make_train_step() if captured else trainer.train_step
            run_losses = torch.stack([step(*data) for _ in range(TRAIN_WARMUP + TRAIN_ITERS)])
            runs.append((run_losses.cpu().numpy(), params_to_numpy(model)))
            del trainer, step
            release(torch)
        (eager, w_eager), (graph, w_graph) = runs
        bits = np.array_equal(eager, graph) and all(
            np.array_equal(w_eager[k], w_graph[k]) for k in w_eager)
        gathered = distributed.allgather_sums(graph.astype(np.float64))
        same_ranks = bool((gathered == gathered[0]).all())
        trainer = make_trainer(model, gate_ds, spatial_shards=shards)
        with record_collectives() as records:
            trainer.train_step(*data)
        summary = exchange_summary(trainer.spatial, records, 1)
        names = sorted(summary)
        fields = ("bytes_per_step", "recv_rows", "sent_rows")
        rows = distributed.allgather_sums(  # (world, names x fields)
            np.array([summary[k][f] for k in names for f in fields], np.float64))
        step = trainer.make_train_step()
        run = timed_steps(torch, step, data)
        (entry,) = trainer.graphs.values()
        nodes = graph_kernel_names(torch, entry.graph)
        nccl = sum("nccl" in n.lower() for n in nodes)
        say(f"{label} on {card}: captured against eager over {len(eager)} steps, losses and "
            f"weights every bit: {bits}; the same losses on every rank: {same_ranks}; "
            f"captured step {run['step_ms']:.3f} ms at {per} sample(s) a spatial group, "
            f"{BATCH * gate_ds.num_grid_points / (run['step_ms'] / 1e3):,.0f} global training "
            f"grid-points/s; {len(nodes)} kernel nodes a replay, {nccl} of them NCCL's; peak "
            f"device memory {run['peak'] / 2**30:.3f} GiB")
        if lay.rank == 0:
            group0 = [{n: dict(summary[n], **{f: int(rows[r][i * len(fields) + j])
                                              for j, f in enumerate(fields)})
                       for i, n in enumerate(names)} for r in range(shards)]
            check_exchange_bytes(group0, trainer.spatial.metas, spatial_rounds(model), per,
                                 f"{label}, data group 0:")
        if not (bits and same_ranks):
            raise AssertionError(f"{label}: captured differs from eager, or ranks differ")
        del trainer, step, entry
        release(torch)
    distributed.destroy()
    return 0


def phase_stencil(torch, model, forecaster, ds, card: str) -> None:
    """GraphLAM under ``NEURAL_LAM_TPU_STENCIL=on`` (``ops/stencil.py``, the
    m2m processor as shifted dense MLPs, plain ``torch``) against the
    edge-list route in the same call: the accuracy gate through the
    captured forecast and the training gate through the captured step on
    the stencil route; the captured forecast's ms per AR step (the gate's
    19-step rollout) and the captured training step's ms, each route,
    in turns (edge list, stencil, stencil, edge list)."""
    from neural_lam_tpu_torch.utils.cuda_graph import CapturedFunction

    t0 = time.perf_counter()
    inputs = [torch.from_numpy(a).to(DEVICE) for a in gate_inputs(ds)]
    data = [torch.from_numpy(a).to(DEVICE) for a in bench_batch(ds)]
    # earlier phases train the weights in place: the gates start from the
    # fixture's
    load_gate_params(model)
    with env_set(STENCIL, "on"):
        st = model._m2m_stencil()
        if st is None:
            raise AssertionError("stencil: the MEPS multiscale mesh is not detected")
        log(f"stencil: {len(st.layout.groups)} stride groups "
            f"{[(g.stride, len(g.offsets), g.dims) for g in st.layout.groups]}, "
            f"{st.layout.num_edges} edges, lattice {st.layout.dims}")
        phase_gate(torch, ds, forecaster)
        phase_train_gate(torch, make_trainer(model, ds), TRAIN_FIXTURE, captured=True)
    times = {}
    for mode in ("off", "on", "on", "off"):
        with env_set(STENCIL, mode):
            load_gate_params(model)
            captured = CapturedFunction(forecaster, forecaster, DEVICE)
            serve = cuda_ms(lambda: captured(*inputs), reps=5, warmup=2) / inputs[1].shape[1]
            run = timed_steps(torch, make_trainer(model, ds).make_train_step(), data)
            times.setdefault(mode, []).append((serve, run["step_ms"]))
            del captured
            release(torch)
    for mode, label in (("off", "edge list"), ("on", "stencil")):
        log(f"stencil phase, {label} route on {card}: captured forecast "
            f"{', '.join(f'{s:.3f}' for s, _ in times[mode])} ms per AR step (batch 1), "
            f"captured training step {', '.join(f'{t:.3f}' for _, t in times[mode])} ms "
            f"(batch {BATCH})")
    log(f"stencil phase: {time.perf_counter() - t0:.1f} s")


def add_launches(total: dict[str, int], launches: dict[str, int], what: str) -> None:
    for name, count in launches.items():
        total[name] = total.get(name, 0) + count
    log(f"launches {what}: " + ", ".join(f"{k} {v}" for k, v in launches.items())
        + f" ({time.perf_counter() - STARTED:.0f} s into the script)")


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
    launches, eager = phase_train(torch, make_trainer(model, gate_ds, reload=False), card)
    add_launches(total, launches, f"{name} train")
    load_seeded(torch, model)
    add_launches(
        total,
        phase_train_graph(torch, make_trainer(model, gate_ds, reload=False), card, eager),
        f"{name} train graph",
    )
    load_seeded(torch, model)
    phase_model_gate(torch, name, model, gate_ds, gate_fixture(name), captured=True)
    del model
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
        used = [line.split(":", 1)[1].strip() for line in ptxas if "Used" in line]
        spills = [line.strip() for line in ptxas if "spill stores" in line]
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
    if len(sys.argv) > 2 and sys.argv[1] == "--dp-rank":
        return dp_rank_main(Path(sys.argv[2]))
    if len(sys.argv) > 1 and sys.argv[1] == "--dp-cards":
        return dp_cards_main()
    if len(sys.argv) > 2 and sys.argv[1] == "--spatial-rank":
        return spatial_rank_main(Path(sys.argv[2]))
    if len(sys.argv) > 1 and sys.argv[1] == "--spatial-cards":
        return spatial_cards_main()
    sys.path.insert(0, str(REPO))
    keep_cuda_graphs(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; "
        "TF32 off (matmul and cuDNN)"
    )

    parent_build = None
    if len(sys.argv) > 2 and sys.argv[1] == "--parent":
        parent_build = start_parent_build(Path(sys.argv[2]).resolve())
    build_kernels()

    parent = None
    if parent_build is not None:
        parent = parent_kernels(torch, parent_build, Path(sys.argv[2]).resolve())
        log(f"parent kernels (K1, K2, K3, K4, K7, K8) built from {sys.argv[2]}")

    CACHE.mkdir(exist_ok=True)
    gate_ds, serve_ds, model, forecaster = build_meps(torch)
    hi_lam = build_model(torch, "hi_lam", gate_ds)
    with torch.no_grad():
        report = phase_kernels(torch, model, parent)
        phase_probe(torch, model)
        report += phase_v2_kernels(torch, model, parent)
        report += phase_segment_kernels(torch, model.graph, hi_lam.graph)
    with torch.no_grad():
        phase_host_cost(torch, hi_lam, parent)
    level_errs = phase_level_sets(torch, hi_lam)
    for key, err in phase_v2_level_sets(torch, hi_lam).items():
        level_errs[key] = max(level_errs.get(key, 0.0), err)
    with torch.no_grad():
        bf16_level_errs = phase_v2_bf16_level_sets(torch, hi_lam)
    # NEURAL_LAM_TPU_FUSED_AGGR: the node update after K3 and the node
    # backward at the six MEPS sites (every precision) and the level sets
    aggr_report = phase_fused_aggr_kernels(torch, model, hi_lam, parent)
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
    launches, eager = phase_train(torch, make_trainer(model, gate_ds), card)
    add_launches(total, launches, "graph_lam train")
    with fused_v2("on"):
        launches, eager_v2 = phase_train(torch, make_trainer(model, gate_ds), card)
        add_launches(total, launches, "graph_lam v2 train")
    # the captured step: the same 12 steps from the same weights, then the
    # training gate through it
    add_launches(
        total, phase_train_graph(torch, make_trainer(model, gate_ds), card, eager),
        "graph_lam train graph",
    )
    with fused_v2("on"):
        add_launches(
            total, phase_train_graph(torch, make_trainer(model, gate_ds), card, eager_v2),
            "graph_lam v2 train graph",
        )
    phase_train_gate(torch, make_trainer(model, gate_ds), TRAIN_FIXTURE, captured=True)
    with fused_v2("on"):
        log(f"training gate through the captured step on the v2 route ({FUSED_V2}=on):")
        phase_train_gate(torch, make_trainer(model, gate_ds), TRAIN_FIXTURE, captured=True)
    phase_route_steps(torch, model, gate_ds, card)
    # the reduced-precision path: the bf16 variants of K1-K4 at the MEPS
    # sites, mixed-precision training, and the bf16 rollout check
    with torch.no_grad():
        bf16_report = phase_bf16_kernels(torch, model, parent)
    add_launches(total, phase_bf16_train(torch, model, gate_ds, card), "bf16 train")
    add_launches(total, phase_bf16_rollout(torch, gate_ds), "bf16 rollout")
    with fused_v2("on"):
        log(f"bf16 training and rollout on the v2 route ({FUSED_V2}=on):")
        add_launches(total, phase_bf16_train(torch, model, gate_ds, card, others=False),
                     "bf16 train v2")
        add_launches(total, phase_bf16_rollout(torch, gate_ds), "bf16 rollout v2")
    for entry in bf16_report:  # K7's and K8's BF forms at the level sets too
        if entry["name"][:2] in ("K7", "K8"):
            label = "bf16 operands" if entry["name"].endswith("operands") else "bf16"
            entry["max_abs_err"] = max(entry["max_abs_err"], bf16_level_errs[label])
    report += bf16_report
    # NEURAL_LAM_TPU_CACHE_PRE: K3 writing a bf16 pre, K4 reading it or
    # recomputing pre, and the captured training step under each value
    with torch.no_grad():
        report += phase_cache_pre_kernels(torch, model, parent)
    add_launches(total, phase_cache_pre_train(torch, model, gate_ds, card), "cache pre")
    # NEURAL_LAM_TPU_FUSED_AGGR=on: the gates, GraphLAM's and HiLAM's main
    # paths, bf16 training and rollout, and the step under off and on
    add_launches(total, phase_fused_aggr(torch, model, forecaster, gate_ds, serve_ds, card),
                 "fused aggr")
    report += aggr_report
    # data parallelism: an NCCL group of one in this process (ZeRO-1 and
    # flat_opt, captured), two gloo ranks on the card (eager)
    add_launches(total, phase_dp(torch, model, gate_ds, card), "dp")
    # spatial partitioning: the executor at S = 1 in an NCCL group of one
    # (captured), K1-K4 at shard 0's shapes, two gloo ranks as S = 2
    spatial, spatial_errs = phase_spatial(torch, model, gate_ds, card)
    add_launches(total, spatial, "spatial")
    for entry in report:
        err = spatial_errs.get(entry["name"][:2], 0.0)
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
    # the stencil m2m processor against the edge-list route
    phase_stencil(torch, model, forecaster, gate_ds, card)
    del model, forecaster
    torch.cuda.empty_cache()
    phase_unfused_shapes(torch, gate_ds)
    add_launches(total, phase_fit(torch, card), "graph_lam fit")
    add_launches(total, phase_cli(torch, card), "graph_lam cli")
    add_launches(total, phase_npy_workflow(torch, card), "graph_lam npy")
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
