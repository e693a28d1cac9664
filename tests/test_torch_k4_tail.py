"""K4's tail on the CPU: the plain versions of its edge pass, its receiver
slice and the workspace reduce (``ops/fused_kernels.py``), which the card
tests and ``chip_smoke.py`` hold the kernels to.

- The plain edge pass (``_plain_edge_pass``: from ``s``, the sum over the
  batch of the first layer's ``d_pre``, the edge input's gradient, ``dW1e``
  and the embedder's six weight gradients) against ``jax.vjp`` of the same
  function built from the JAX package's embedder (``apply_mlp``) and the
  ``W1e`` slice of its first layer, within 1e-5 of each gradient's largest
  entry (float32 in another summation order); and against the edge share of
  K4's whole plain backward (``_plain_bwd``), within 1e-5 in float32 and
  1e-2 with bf16 operands (one ulp of bf16 where the two orders round a
  value on different sides).
- The plain receiver slice (``_plain_receiver_slice``: ``d_rec`` and
  ``dW1r``) against ``jax.vjp`` of ``rec . W1r``, with float32 and with
  bf16 receiver rows, within 1e-5.
- The plain reduce sums the parts in part order from zero, the same bits
  as a float32 loop.
- Off the card the standalone wrappers run these plain versions.

Inputs are made from a seed with numpy; the weights are the JAX init's,
carried over with ``params_from_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_lam_tpu.ops.mlp import apply_mlp, init_mlp
from neural_lam_tpu_torch.convert_checkpoint import params_from_jax
from neural_lam_tpu_torch.ops import fused_kernels as fk
from neural_lam_tpu_torch.ops.interaction import make_edge_set
from neural_lam_tpu_torch.ops.mlp import make_mlp

TOL = 1e-5  # float32, of each gradient's largest entry
BF16_TOL = 1e-2
D, F = 8, 3


@pytest.fixture(autouse=True)
def _setup():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _close(got, want, name, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{name}: {err:.3g} of the largest entry (tol {tol})"


def _module(jax_params, module):
    sd = {k[2:]: v for k, v in params_from_jax({"m": jax_params}).items()}
    module.load_state_dict(sd, strict=True)
    return module


def _nets(seed):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    mlp = init_mlp(k1, [3 * D, D, D])
    emb = init_mlp(k2, [F, D, D])
    t_mlp = _module(mlp, make_mlp([3 * D, D, D]))
    t_emb = _module(emb, make_mlp([F, D, D]))
    return mlp, emb, t_mlp, t_emb


@pytest.mark.parametrize("n_edges", [1, 63, 64, 65, 150])
@pytest.mark.parametrize("b,new_edge", [(1, False), (3, True), (4, False)])
@pytest.mark.parametrize("raw", [True, False], ids=["raw", "shared"])
def test_plain_edge_pass_matches_jax_vjp(raw, b, new_edge, n_edges):
    """``_plain_edge_pass`` against ``jax.vjp`` of ``edge_val . W1e``
    (and of ``edge_val`` broadcast over the batch, the updated edges'
    residual) with the cotangents ``s`` and ``d_new_edge``: the shared edge
    input's gradient, ``dW1e``, and for raw features the embedder's
    gradients. Measured: at most 3e-7 of the largest entry."""
    rng = np.random.default_rng(21 + n_edges + 7 * b)
    mlp, emb, t_mlp, t_emb = _nets(4)
    edge = rng.normal(size=(n_edges, F if raw else D)).astype(np.float32)
    s = rng.normal(size=(n_edges, D)).astype(np.float32)
    d_new = rng.normal(size=(n_edges, b, D)).astype(np.float32) if new_edge else None

    def fn(e_params, w1e, edge_in):
        ev = apply_mlp(e_params, edge_in) if raw else edge_in
        return ev @ w1e, jnp.broadcast_to(ev[:, None], (n_edges, b, D))

    w1e = mlp["layers"][0]["w"][:D]  # (in, out): the edge rows of W1
    _, vjp = jax.vjp(fn, emb, w1e, jnp.asarray(edge))
    seed_new = jnp.asarray(d_new) if new_edge else jnp.zeros((n_edges, b, D))
    j_emb, j_w1e, j_edge = vjp((jnp.asarray(s), seed_new))

    weights = fk._weights(t_mlp, t_emb if raw else None)
    with torch.no_grad():
        d_edge, dw1e, grads = fk._plain_edge_pass(
            _t(s), _t(edge), None if d_new is None else _t(d_new), weights, raw)
    _close(dw1e.numpy(), np.asarray(j_w1e).T, "dW1e")
    if raw:
        assert d_edge is None
        want = params_from_jax({"m": jax.device_get(j_emb)})
        names = [n for n, _ in t_emb.named_parameters()]
        assert len(names) == len(grads) == len(want) == 6
        for name, g in zip(names, grads):
            _close(g.numpy(), want[f"m.{name}"].numpy(), name)
    else:
        assert grads == [None] * 6
        _close(d_edge.numpy(), np.asarray(j_edge), "d_edge")


def _graph(n_send, n_rec, n_edges, seed):
    rng = np.random.default_rng(seed)
    snd = rng.integers(0, n_send, n_edges)
    rcv = rng.integers(0, n_rec, n_edges)
    return make_edge_set(snd, rcv, num_rec=n_rec, num_send=n_send)[0]


@pytest.mark.parametrize("bf16_ops", [False, True], ids=["float32", "bf16"])
@pytest.mark.parametrize("raw", [True, False], ids=["raw", "shared"])
def test_plain_edge_pass_is_k4s_edge_share(raw, bf16_ops):
    """The plain edge pass, from ``s`` formed from the plain forward's
    ``d_pre`` (rounded to bf16 before the batch sum with ``bf16_ops``, as
    K4's main kernel writes it), gives the edge input's gradient, ``dW1e``
    and the embedder's gradients of K4's whole plain backward
    (``_plain_bwd``, autograd through the plain phase) on the same inputs.
    Measured: 2e-7 in float32, 4e-3 with bf16 operands."""
    rng = np.random.default_rng(8)
    n_send, n_rec, n_edges, b = 30, 17, 140, 3
    es = _graph(n_send, n_rec, n_edges, 9)
    _, _, t_mlp, t_emb = _nets(6)
    weights = [None if w is None else w.detach()
               for w in fk._weights(t_mlp, t_emb if raw else None)]
    edge = _t(rng.normal(size=(n_edges, F if raw else D)))
    send = _t(rng.normal(size=(n_edges, b, D)))
    rec = _t(rng.normal(size=(n_rec, b, D)))
    d_aggr = _t(rng.normal(size=(n_rec, b, D)))
    d_new = _t(rng.normal(size=(n_edges, b, D)))

    d_edge, _, _, grads = fk._plain_bwd(
        d_aggr, d_new, edge, send, rec, es, weights, raw, True, False, bf16_ops)
    with torch.enable_grad():
        leaves = [None if w is None else w.requires_grad_(True) for w in weights]
        aggr, new_edge, pre = fk._plain(
            edge, send, rec, es.receivers, leaves, raw, True, False, bf16_ops,
            return_pre=True)
        d_pre, = torch.autograd.grad([aggr, new_edge], [pre], [d_aggr, d_new])
    s = (fk._bf16(d_pre) if bf16_ops else d_pre).sum(1)
    with torch.no_grad():
        got_edge, dw1e, emb_grads = fk._plain_edge_pass(
            s, edge, d_new, [None if w is None else w.detach() for w in weights], raw,
            bf16_ops)
    tol = BF16_TOL if bf16_ops else TOL
    _close(dw1e.numpy(), grads[0][:, :D].numpy(), "dW1e", tol)
    if raw:
        for i, (g, w) in enumerate(zip(emb_grads, grads[6:])):
            _close(g.numpy(), w.numpy(), f"embedder grad {i}", tol)
    else:
        _close(got_edge.numpy(), d_edge.numpy(), "d_edge", tol)


@pytest.mark.parametrize("rows_dtype", ["float32", "bf16"])
@pytest.mark.parametrize("n_rec,b", [(1, 1), (23, 4), (40, 32)])
def test_plain_receiver_slice_matches_jax_vjp(n_rec, b, rows_dtype):
    """``_plain_receiver_slice`` against ``jax.vjp`` of ``rec . W1r`` with
    the cotangent ``d_recproj``: ``d_rec`` and ``dW1r`` in float32, the
    receiver rows bf16-valued in the bf16 case (the JAX package's einsums
    promote them to float32). Measured: at most 2e-7 of the largest
    entry."""
    rng = np.random.default_rng(31 + n_rec)
    mlp, _, t_mlp, _ = _nets(7)
    rec = _t(rng.normal(size=(n_rec, b, D)))
    if rows_dtype == "bf16":
        rec = rec.to(torch.bfloat16)
    d_recproj = _t(rng.normal(size=(n_rec, b, D)))
    w1r = mlp["layers"][0]["w"][2 * D:]  # (in, out)
    _, vjp = jax.vjp(lambda r, w: r @ w, jnp.asarray(rec.float().numpy()), w1r)
    j_rec, j_w1r = vjp(jnp.asarray(d_recproj.numpy()))
    w1 = fk._weights(t_mlp, None)[0].detach()
    d_rec, dw1r = fk._plain_receiver_slice(d_recproj, rec, w1)
    assert d_rec.dtype == dw1r.dtype == torch.float32
    _close(d_rec.numpy(), np.asarray(j_rec), "d_rec")
    _close(dw1r.numpy(), np.asarray(j_w1r).T, "dW1r")


@pytest.mark.parametrize("parts,stride", [(1, 5), (17, 33), (396, 64)])
def test_plain_reduce_sums_in_part_order(parts, stride):
    """The plain reduce is a float32 sum over the parts in part order from
    zero: the same bits as the loop the kernel runs."""
    ws = np.random.default_rng(parts).normal(size=(parts, stride)).astype(np.float32)
    want = np.zeros(stride, np.float32)
    for part in ws:
        want = (want + part).astype(np.float32)
    got = fk.reduce_workspace_plain(torch.from_numpy(ws)).numpy()
    np.testing.assert_array_equal(got, want)


def test_standalone_wrappers_run_the_plain_versions_on_the_cpu():
    """On CPU tensors the edge pass's, the receiver slice's and the reduce's
    wrappers return their plain versions' results and launch nothing."""
    rng = np.random.default_rng(3)
    _, _, t_mlp, t_emb = _nets(2)
    weights = [None if w is None else w.detach() for w in fk._weights(t_mlp, t_emb)]
    s, feats = _t(rng.normal(size=(70, D))), _t(rng.normal(size=(70, F)))
    before = (fk.fused_edge_bwd_edge_pass.launches,
              fk.fused_edge_bwd_receiver_slice.launches, fk.reduce_workspace.launches)
    got = fk.fused_edge_bwd_edge_pass(s, feats, None, weights, True)
    want = fk._plain_edge_pass(s, feats, None, weights, True)
    assert got[0] is None and torch.equal(got[1], want[1])
    assert all(torch.equal(g, w) for g, w in zip(got[2], want[2]))
    d_recproj, rec = _t(rng.normal(size=(9, 2, D))), _t(rng.normal(size=(9, 2, D)))
    got = fk.fused_edge_bwd_receiver_slice(d_recproj, rec, weights[0])
    want = fk._plain_receiver_slice(d_recproj, rec, weights[0])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    ws = _t(rng.normal(size=(5, 12)))
    assert torch.equal(fk.reduce_workspace(ws), fk.reduce_workspace_plain(ws))
    assert before == (fk.fused_edge_bwd_edge_pass.launches,
                      fk.fused_edge_bwd_receiver_slice.launches,
                      fk.reduce_workspace.launches)
