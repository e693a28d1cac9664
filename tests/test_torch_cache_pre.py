"""``NEURAL_LAM_TPU_CACHE_PRE`` and the v2 route under a reduced precision:
the port against the JAX package on the CPU.

Same scheme as ``tests/test_torch_bf16.py``, whose edge set and phase
helpers this file uses: the same numpy inputs and the JAX init's weights
(carried over with ``params_from_jax``) go through the JAX function, its
Pallas kernels in interpret mode, and through the port, whose wrappers run
their kernels' plain versions on CPU tensors.

- ``NEURAL_LAM_TPU_CACHE_PRE=bf16``: K3 saves its first layer's
  pre-activation rounded to bf16 and K4 recomputes SiLU, the second layer
  and the LayerNorm from the rounded value (pallas_fused.py:1490-1492,
  :292-295). In float32 the gradients then differ from those of a float32
  ``pre`` by up to 1.6e-3 of their largest entry (the measure of a port that
  ignored the variable), so the float32 cases are held to 1e-4, beside the
  JAX VJP's summation order; the bf16 modes keep ``test_torch_bf16.py``'s
  bounds (2e-2 outputs, 5e-2 gradients).
- ``NEURAL_LAM_TPU_CACHE_PRE=off``: no ``pre`` is saved and K4 recomputes
  it; the gradients equal the JAX ``off`` VJP's within 1e-4.
- The v2 route (K7, K8, K2) under bf16 inputs, ``high``, ``high-kernels``
  and ``NEURAL_LAM_TPU_BF16_KERNELS=off`` against
  ``make_fused_interaction_v2`` in the same mode, within the bf16 bounds.

Each test's docstring states the worst error measured when it was written.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_bf16 as tb

from neural_lam_tpu.ops.mlp import init_mlp
from neural_lam_tpu.ops.pallas_fused import make_fused_interaction_v2
from neural_lam_tpu_torch.convert_checkpoint import params_from_jax
from neural_lam_tpu_torch.ops import fused_kernels
from neural_lam_tpu_torch.ops.mlp import make_mlp

F32_TOL = 1e-4  # float32 outputs and gradients, of their largest entry
CACHE_PRE = "NEURAL_LAM_TPU_CACHE_PRE"
# mode -> (NEURAL_LAM_TPU_MATMUL_PRECISION, bf16 inputs and weights,
# NEURAL_LAM_TPU_BF16_KERNELS)
MODES = {
    "float32": (None, False, None),
    "bf16": (None, True, None),
    "high": ("high", False, None),
    "high-kernels": ("high-kernels", False, None),
    "bf16 kernels off": (None, True, "off"),
}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("NEURAL_LAM_TPU_PALLAS", "interpret")
    monkeypatch.setenv("NEURAL_LAM_TPU_FUSED", "auto")
    for name in ("NEURAL_LAM_TPU_MATMUL_PRECISION", "NEURAL_LAM_TPU_BF16_KERNELS",
                 "NEURAL_LAM_TPU_FUSED_V2", CACHE_PRE):
        monkeypatch.delenv(name, raising=False)
    # test_torch_bf16's phase helper takes its modes by name
    monkeypatch.setitem(tb.MODES, "float32", (None, False))


def _check(r, f32: bool) -> tuple[float, float]:
    """``test_torch_bf16``'s checks of a phase (dtypes, the receiver
    without edges, the bf16 bounds), and the float32 bound in float32."""
    out_err, grad_err = tb._check_phase(r)
    if f32:
        assert out_err <= F32_TOL and grad_err <= F32_TOL, (out_err, grad_err)
    return out_err, grad_err


# -- K3 and K4: the saved pre-activation -------------------------------------------


@pytest.mark.parametrize("mode", ["float32", "bf16", "high", "high-kernels"])
@pytest.mark.parametrize("edge_mode,update,b", tb.PHASE_CASES)
def test_bf16_pre_matches_jax(monkeypatch, mode, edge_mode, update, b):
    """``FusedEdgePhase`` (K3's and K4's plain versions) under
    ``NEURAL_LAM_TPU_CACHE_PRE=bf16`` against ``jax.vjp`` of
    ``make_fused_interaction`` under the same variable: raw, shared and
    batched edge inputs, ``update_edges``, batch 1, 2 and 32, dead slots on
    the JAX side and a receiver without edges. Measured worst: float32
    outputs 2.6e-7 and gradients 1.5e-6 of their largest entry (1.6e-3
    with a float32 pre); bf16 inputs 5.4e-3 and 8.3e-3, ``high`` 2.3e-3 and
    9.2e-3, ``high-kernels`` 2.3e-3 and 7.8e-3."""
    monkeypatch.setenv(CACHE_PRE, "bf16")
    _check(tb._phase(monkeypatch, mode, edge_mode, update, b), mode == "float32")


@pytest.mark.parametrize("edge_mode,update,b", tb.PHASE_CASES)
def test_no_saved_pre_matches_jax(monkeypatch, edge_mode, update, b):
    """``NEURAL_LAM_TPU_CACHE_PRE=off`` in float32: the port saves no
    ``pre`` (K4 recomputes it) and the v2 route is off, and its outputs
    and gradients equal the JAX ``off`` VJP's within 1e-4 of their largest
    entry. Measured worst: outputs 2.6e-7, gradients 1.4e-6."""
    monkeypatch.setenv(CACHE_PRE, "off")
    assert fused_kernels.cache_pre() == "off" and not fused_kernels.fused_v2_enabled()
    _check(tb._phase(monkeypatch, "float32", edge_mode, update, b), True)


@pytest.mark.parametrize("value,want", [(None, "on"), ("on", "on"), ("bf16", "bf16"),
                                        ("off", "off"), ("yes", "on")])
def test_cache_pre_reads_the_variable_as_jax(monkeypatch, value, want):
    """Only ``off`` saves nothing and only ``bf16`` rounds; any other
    value saves a float32 ``pre``, as the JAX package reads it
    (pallas_fused.py:1490-1492); only ``off`` turns v2 off."""
    if value is not None:
        monkeypatch.setenv(CACHE_PRE, value)
    assert fused_kernels.cache_pre() == want
    assert fused_kernels.fused_v2_enabled() == (want != "off")


def _saved_pre(monkeypatch, mode: str, bf16_ops: bool):
    """Run one batched phase forward and backward under
    ``NEURAL_LAM_TPU_CACHE_PRE=mode`` and return the tensors that
    autograd kept for the backward of the fused phase, and the gradient of
    ``x_send``."""
    monkeypatch.setenv(CACHE_PRE, mode)
    if bf16_ops:
        monkeypatch.setenv("NEURAL_LAM_TPU_MATMUL_PRECISION", "high-kernels")
    _, tes, _ = tb._graph()
    mlp = make_mlp([24, 8, 8], generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    edge, send = (torch.from_numpy(rng.normal(size=(tb.N_EDGES, 2, 8)).astype(np.float32))
                  for _ in range(2))
    rec = torch.from_numpy(rng.normal(size=(tb.N_REC, 2, 8)).astype(np.float32))
    send.requires_grad_(True)
    saved = []
    apply = fused_kernels.FusedEdgePhase.apply

    def spy(*args):
        with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t,
                                                      lambda t: t):
            return apply(*args)

    monkeypatch.setattr(fused_kernels.FusedEdgePhase, "apply", spy)
    aggr, new_edge = fused_kernels.fused_edge_phase(mlp, edge, send, rec, tes,
                                                    update_edges=True)
    (aggr.sin().sum() + new_edge.sin().sum()).backward()
    return saved, send.grad


@pytest.mark.parametrize("bf16_ops", [False, True])
def test_saved_pre_follows_the_variable(monkeypatch, bf16_ops):
    """What the fused phase keeps for its backward, by
    ``saved_tensors_hooks``: under ``on`` a float32 ``pre`` beside its
    inputs, under ``bf16`` the same ``pre`` rounded to bf16, under ``off``
    none (K4 recomputes it); in float32 and with bf16 operands. ``on``
    and ``off`` give the same gradients within 1e-6 of their largest entry;
    ``bf16``'s differ from them, by the rounding of ``pre`` (a bf16 ulp is
    2^-8 of a value), within 1e-2. Measured: 0 and 2.0e-3 (float32)."""
    runs = {}
    for mode in ("on", "bf16", "off"):
        with monkeypatch.context() as m:
            runs[mode] = _saved_pre(m, mode, bf16_ops)
    shape = (tb.N_EDGES, 2, 8)
    on, rounded, off = (runs[k][0] for k in ("on", "bf16", "off"))
    pre = [t for t in on if tuple(t.shape) == shape and t.dtype == torch.float32]
    # x_send and the batched edge input, and pre
    assert len(pre) == 3 and len(on) == len(off) + 1 == len(rounded)
    assert not any(t.dtype == torch.bfloat16 for t in on + off)
    (bf,) = [t for t in rounded if t.dtype == torch.bfloat16]
    assert tuple(bf.shape) == shape and bf.nbytes * 2 == pre[-1].nbytes
    assert any(torch.equal(bf, p.to(torch.bfloat16)) for p in pre)
    grads = {k: v[1] for k, v in runs.items()}
    scale = grads["on"].abs().max()
    assert (grads["off"] - grads["on"]).abs().max() <= 1e-6 * scale
    diff = (grads["bf16"] - grads["on"]).abs().max()
    assert 0 < diff <= 1e-2 * scale, diff / scale


# -- K7 and K8: the v2 route under a reduced precision ----------------------------

V2_CASES = [
    # (edge input, update_edges): the MEPS sites' wirings
    ("raw", False),  # g2m, m2g
    ("raw", True),  # m2m layer 0
    ("batched", True),  # later m2m layers
    ("shared", True),  # HiLAMParallel's per-section entry
]


def _v2_phase(monkeypatch, mode, edge_mode, update):
    """One v2 phase on both sides in ``mode`` at batch 2: the JAX outputs
    and VJP gradients of ``make_fused_interaction_v2``, and the port's
    ``fused_edge_phase_v2`` outputs and its leaves' gradients, with a count
    of the port's ``FusedEdgePhaseV2`` applications."""
    env, bf16, kernels = MODES[mode]
    if env is not None:
        monkeypatch.setenv("NEURAL_LAM_TPU_MATMUL_PRECISION", env)
    if kernels is not None:
        monkeypatch.setenv("NEURAL_LAM_TPU_BF16_KERNELS", kernels)
    monkeypatch.setenv("NEURAL_LAM_TPU_FUSED_V2", "on")
    jes, tes, live = tb._graph()
    rng = np.random.default_rng(8)
    d, f, b = 8, 3, 2
    k1, k2 = jax.random.split(jax.random.PRNGKey(2))
    mlp, emb = init_mlp(k1, [3 * d, d, d]), init_mlp(k2, [f, d, d])
    t_mlp, t_emb = make_mlp([3 * d, d, d]), make_mlp([f, d, d])
    t_mlp.load_state_dict({k[2:]: v for k, v in params_from_jax({"m": mlp}).items()})
    t_emb.load_state_dict({k[2:]: v for k, v in params_from_jax({"m": emb}).items()})
    j_dt, t_dt = (jnp.bfloat16, tb.BF16) if bf16 else (jnp.float32, torch.float32)
    if bf16:
        mlp, emb = tb._to_bf16(mlp), tb._to_bf16(emb)
        t_mlp, t_emb = t_mlp.to(tb.BF16), t_emb.to(tb.BF16)
    send = rng.normal(size=(tb.N_SEND, b, d)).astype(np.float32)
    rec = rng.normal(size=(tb.N_REC, b, d)).astype(np.float32)
    edge = {
        "raw": rng.normal(size=(tb.N_EDGES, f)),
        "shared": rng.normal(size=(tb.N_EDGES, d)),
        "batched": rng.normal(size=(tb.N_EDGES, b, d)),
    }[edge_mode].astype(np.float32)
    d_aggr = rng.normal(size=(tb.N_REC, b, d)).astype(np.float32)
    d_new = rng.normal(size=(tb.N_EDGES, b, d)).astype(np.float32)

    run = make_fused_interaction_v2(jes.layout, jes.banded, update_edges=update,
                                    interpret=True)
    raw = edge_mode == "raw"
    j_edge = jnp.asarray(tb._slots(edge, live, jes), j_dt)
    args = [mlp, emb if raw else j_edge, jnp.asarray(send, j_dt), jnp.asarray(rec, j_dt)]
    if raw:
        fn = lambda m, e, s, r: run(m, None, s, r, emb_params=e, edge_feats=j_edge)  # noqa: E731
    else:
        fn = lambda m, e, s, r: run(m, e, s, r)  # noqa: E731
    j_out, vjp = jax.vjp(fn, *args)
    seeds = (jnp.asarray(d_aggr, j_out[0].dtype),
             jnp.asarray(tb._slots(d_new, live, jes), j_out[0].dtype) if update else None)
    j_grads = vjp(seeds)

    calls = []
    apply = fused_kernels.FusedEdgePhaseV2.apply
    monkeypatch.setattr(fused_kernels.FusedEdgePhaseV2, "apply",
                        lambda *a: calls.append(a[-2]) or apply(*a))
    t_send = torch.from_numpy(send).to(t_dt).requires_grad_(True)
    t_rec = torch.from_numpy(rec).to(t_dt).requires_grad_(True)
    t_edge = torch.from_numpy(edge).to(t_dt).requires_grad_(not raw)
    got = fused_kernels.fused_edge_phase_v2(
        t_mlp, None if raw else t_edge, t_send, t_rec, tes,
        embedder=t_emb if raw else None, edge_feats=t_edge if raw else None,
        update_edges=update,
    )
    outs, grads = [got[0]], [torch.from_numpy(d_aggr).to(got[0].dtype)]
    if update:
        outs.append(got[1])
        grads.append(torch.from_numpy(d_new).to(got[1].dtype))
    torch.autograd.backward(outs, grads)
    return dict(j_out=j_out, j_grads=j_grads, live=live, got=got, t_send=t_send,
                t_rec=t_rec, t_edge=t_edge, t_mlp=t_mlp, t_emb=t_emb, raw=raw,
                tes=tes, update=update), calls


@pytest.mark.parametrize("mode", ["bf16", "high", "high-kernels", "bf16 kernels off"])
@pytest.mark.parametrize("edge_mode,update", V2_CASES)
def test_v2_phase_in_reduced_precision_matches_jax(monkeypatch, mode, edge_mode, update):
    """``fused_edge_phase_v2`` (the node projections, K7's, K8's and K2's
    plain versions) against ``jax.vjp`` of ``make_fused_interaction_v2``
    (interpret) in the same precision: the aggregate, the updated edges,
    the sender, receiver and edge gradients and every weight gradient, each
    in the JAX dtype, within 2e-2 (outputs) and 5e-2 (gradients) of the
    largest entry. The phase runs with bf16 operands except under
    ``NEURAL_LAM_TPU_BF16_KERNELS=off`` (the float32 kernels, cast at the
    boundary). Measured worst: 7.8e-3 of the largest entry over the
    outputs and gradients of the bf16-operand modes; the same bits as the
    JAX package under ``NEURAL_LAM_TPU_BF16_KERNELS=off``."""
    r, calls = _v2_phase(monkeypatch, mode, edge_mode, update)
    assert calls == [mode != "bf16 kernels off"]  # bf16_ops of the one application
    _check_v2(r)


def _check_v2(r) -> tuple[float, float]:
    """``test_torch_bf16``'s checks of a phase for the v2 route, whose
    sender gradient is per node: outputs and gradients within the bf16
    bounds, each in the JAX dtype; returns the worst relative errors."""
    live, got, j_out, j_grads = r["live"], r["got"], r["j_out"], r["j_grads"]
    tb._same_dtype(got[0], j_out[0])
    out_err = tb._rel(got[0], j_out[0])
    assert not tb._np(got[0])[-1].any()  # the receiver without edges
    if r["update"]:
        tb._same_dtype(got[1], j_out[1])
        out_err = max(out_err, tb._rel(got[1], np.asarray(j_out[1], np.float32)[live]))
    pairs = [(r["t_send"].grad, tb._np(j_grads[2])), (r["t_rec"].grad, tb._np(j_grads[3]))]
    if not r["raw"]:
        pairs.append((r["t_edge"].grad, tb._np(j_grads[1])[live]))
    want = params_from_jax({"m": jax.device_get(j_grads[0])})
    named = [(p, want["m." + n]) for n, p in r["t_mlp"].named_parameters()]
    if r["raw"]:
        want_e = params_from_jax({"e": jax.device_get(j_grads[1])})
        named += [(p, want_e["e." + n]) for n, p in r["t_emb"].named_parameters()]
    grad_err = 0.0
    for t, j in pairs:
        assert t.dtype == r["t_rec"].dtype
        grad_err = max(grad_err, tb._rel(t, j))
    for p, w in named:
        assert p.grad.dtype == p.dtype
        grad_err = max(grad_err, tb._rel(p.grad, w))
    assert out_err <= tb.OUT_TOL and grad_err <= tb.GRAD_TOL, (out_err, grad_err)
    return out_err, grad_err
