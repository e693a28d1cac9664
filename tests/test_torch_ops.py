"""The port's message-passing ops against the JAX package on the CPU.

Same numpy inputs and the same weights (JAX init, carried over with
``params_from_jax``) go through the JAX function and its counterpart in
``neural_lam_tpu_torch``. The JAX side runs its Pallas kernels in
interpret mode (``NEURAL_LAM_TPU_PALLAS=interpret``,
``NEURAL_LAM_TPU_FUSED=auto``), as ``tests/test_pallas_fused.py`` does;
the port runs the plain PyTorch versions of its kernels, which is what
its wrappers do on CPU tensors.

JAX keeps dead padding slots in its blocked edge layout and the port
keeps none, so edge arrays are compared on the JAX slots whose ``perm``
is valid; both sort edges stably by receiver, so those slots are in the
port's order.

Tolerances: both sides compute in exact float32 on the CPU, and differ
only in summation order (block-diagonal and one-hot matmuls on the JAX
side, plain matmuls and ``index_add_`` here), so 2e-5 (absolute and
relative) on O(1) values is the stated bound; the sender gather is a
copy on both sides and must match exactly. Gradients (K2, K4 and the
model's backward) are compared at 5e-5 of each gradient's largest value:
a weight gradient sums a term per edge and batch member, so its entries
vary over orders of magnitude and a per-entry relative bound would
measure cancellation, not the implementation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_lam_tpu.ops.interaction import (
    apply_interaction_net as jax_apply_interaction_net,
)
from neural_lam_tpu.ops.interaction import init_interaction_net
from neural_lam_tpu.ops.interaction import make_edge_set as jax_make_edge_set
from neural_lam_tpu.ops.mlp import init_mlp
from neural_lam_tpu.ops.pallas_fused import make_fused_interaction
from neural_lam_tpu.ops.pallas_segment import banded_expand_nondiff
from neural_lam_tpu.ops.segment import gather_senders as jax_gather_senders
from neural_lam_tpu_torch.convert_checkpoint import params_from_jax
from neural_lam_tpu_torch.ops import segment
from neural_lam_tpu_torch.ops.fused_kernels import (
    embedder_fusable,
    fusable,
    fused_edge_phase,
    fused_edge_phase_plain,
)
from neural_lam_tpu_torch.ops.interaction import (
    InteractionNet,
    apply_interaction_net,
    make_edge_set,
    place_edge_features,
)
from neural_lam_tpu_torch.ops.mlp import apply_mlp_split_first, make_mlp
from neural_lam_tpu_torch.ops.segment_kernels import (
    sender_gather,
    sender_gather_plain,
    sender_scatter,
    sender_scatter_plain,
)

TOL = dict(rtol=2e-5, atol=2e-5)
N_SEND, N_REC, N_EDGES = 37, 23, 180


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("NEURAL_LAM_TPU_PALLAS", "interpret")
    monkeypatch.setenv("NEURAL_LAM_TPU_FUSED", "auto")


def _graph(seed=3):
    """Random edges; receiver N_REC - 1 gets none (it must aggregate to
    zero). Returns both packages' edge sets and the JAX live slots."""
    rng = np.random.default_rng(seed)
    snd = rng.integers(0, N_SEND, N_EDGES)
    rcv = rng.integers(0, N_REC - 1, N_EDGES)
    jes, jperm = jax_make_edge_set(snd, rcv, num_rec=N_REC, num_send=N_SEND)
    tes, tperm = make_edge_set(snd, rcv, num_rec=N_REC, num_send=N_SEND)
    live = jperm >= 0
    np.testing.assert_array_equal(jperm[live], tperm)
    return jes, tes, live, snd, rcv


def _torch_module(jax_params, module):
    """Load JAX parameters into a port module of the same shape."""
    sd = {k[2:]: v for k, v in params_from_jax({"m": jax_params}).items()}
    module.load_state_dict(sd, strict=True)
    return module


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _slots(arr, live, jes):
    """Port-order edge array -> JAX slot order (dead slots zero)."""
    out = np.zeros((jes.num_padded,) + arr.shape[1:], np.float32)
    out[live] = arr
    return out


def test_make_edge_set_csr():
    _, tes, _, snd, rcv = _graph()
    assert tes.num_edges == N_EDGES
    np.testing.assert_array_equal(
        np.diff(tes.rowptr.numpy()), np.bincount(rcv, minlength=N_REC)
    )
    assert tes.recv_counts[-1] == 0
    assert np.all(np.diff(tes.receivers.numpy()) >= 0)
    feats = np.arange(N_EDGES, dtype=np.float32)[:, None]
    perm_feats = place_edge_features(feats, make_edge_set(snd, rcv, N_REC)[1])
    np.testing.assert_array_equal(snd[perm_feats[:, 0].astype(int)], tes.senders)
    with pytest.raises(ValueError, match="sender index"):
        make_edge_set(snd, rcv, N_REC, num_send=3)


@pytest.mark.parametrize("batched", [False, True])
def test_sender_gather_matches_banded_expand(batched):
    """K1's plain version vs the JAX ``banded_expand_nondiff``."""
    jes, tes, live, _, _ = _graph()
    assert jes.banded is not None
    rng = np.random.default_rng(4)
    shape = (N_SEND, 2, 8) if batched else (N_SEND, 8)
    x = rng.normal(size=shape).astype(np.float32)
    x2d = x.reshape(N_SEND, -1)
    want = np.asarray(banded_expand_nondiff(jnp.asarray(x2d), jes.banded, True))
    got = sender_gather(_t(x), tes.senders)  # CPU tensor: the plain version
    np.testing.assert_array_equal(got.numpy().reshape(N_EDGES, -1), want[live])
    np.testing.assert_array_equal(
        got.numpy(), sender_gather_plain(_t(x), tes.senders).numpy()
    )
    assert not np.any(want[~live])  # JAX dead slots read zero


# K3's flag combinations on the forecast path, plus propagation and a
# LayerNorm-free edge MLP: (edge input, update_edges, propagation, ln)
K3_FLAGS = [
    ("raw", False, False, True),  # g2m, m2g: in-kernel embedder
    ("raw", True, False, True),  # m2m layer 0
    ("batched", True, False, True),  # m2m layers 1-3
    ("shared", True, False, True),
    ("raw", False, True, True),
    ("batched", True, False, False),
]


@pytest.mark.parametrize("mode,update,prop,ln", K3_FLAGS)
def test_fused_edge_phase_matches_jax(mode, update, prop, ln):
    """K3's plain version vs ``make_fused_interaction`` (interpret)."""
    jes, tes, live, _, _ = _graph()
    rng = np.random.default_rng(5)
    d, b, f = 8, 2, 3
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    mlp = init_mlp(k1, [3 * d, d, d], layer_norm=ln)
    emb = init_mlp(k2, [f, d, d])
    t_mlp = _torch_module(mlp, make_mlp([3 * d, d, d], layer_norm=ln))
    t_emb = _torch_module(emb, make_mlp([f, d, d]))
    assert fusable(t_mlp) and embedder_fusable(t_emb, d)

    send = rng.normal(size=(N_EDGES, b, d)).astype(np.float32)
    rec = rng.normal(size=(N_REC, b, d)).astype(np.float32)
    edge = {
        "raw": rng.normal(size=(N_EDGES, f)),
        "shared": rng.normal(size=(N_EDGES, d)),
        "batched": rng.normal(size=(N_EDGES, b, d)),
    }[mode].astype(np.float32)

    run = make_fused_interaction(
        jes.layout, update_edges=update, propagation=prop, interpret=True
    )
    j_edge = jnp.asarray(_slots(edge, live, jes))
    if mode == "raw":
        j_out = run(
            mlp, None, jnp.asarray(_slots(send, live, jes)),
            jnp.asarray(rec), emb_params=emb, edge_feats=j_edge,
        )
    else:
        j_out = run(
            mlp, j_edge, jnp.asarray(_slots(send, live, jes)), jnp.asarray(rec)
        )
    with torch.no_grad():
        got = fused_edge_phase(
            t_mlp,
            None if mode == "raw" else _t(edge),
            _t(send),
            _t(rec),
            tes,
            embedder=t_emb if mode == "raw" else None,
            edge_feats=_t(edge) if mode == "raw" else None,
            update_edges=update,
            propagation=prop,
        )
        plain = fused_edge_phase_plain(
            t_mlp,
            None if mode == "raw" else _t(edge),
            _t(send), _t(rec), tes.receivers,
            t_emb if mode == "raw" else None,
            _t(edge) if mode == "raw" else None,
            update, prop,
        )
    np.testing.assert_array_equal(got[0].numpy(), plain[0].numpy())
    np.testing.assert_allclose(got[0].numpy(), np.asarray(j_out[0]), **TOL)
    assert not np.any(got[0].numpy()[-1])  # receiver without edges
    if update:
        np.testing.assert_allclose(
            got[1].numpy(), np.asarray(j_out[1])[live], **TOL
        )
    else:
        assert got[1] is None and j_out[1] is None


def _jax_net(hidden_layers, d):
    return init_interaction_net(jax.random.PRNGKey(7), d, hidden_layers=hidden_layers)


# (edge input, aggr, update_edges, propagation, hidden_layers, batched):
# hidden_layers=2 is not fusable, so both packages take the unfused route
NET_CASES = [
    ("embed", "sum", False, False, 1, True),  # g2m / m2g wiring
    ("embed", "sum", True, False, 1, True),  # m2m layer 0
    ("batched", "sum", True, False, 1, True),  # m2m layers 1-3
    ("batched", "mean", True, False, 1, True),
    ("embed", "sum", False, True, 1, True),  # PropagationNet
    ("shared", "sum", True, False, 1, False),  # unbatched call
    ("batched", "sum", True, False, 2, True),  # unfused route
    ("embed", "mean", False, True, 2, True),  # unfused, propagation
]


@pytest.mark.parametrize("edge_in,aggr,update,prop,hl,batched", NET_CASES)
def test_apply_interaction_net_matches_jax(edge_in, aggr, update, prop, hl, batched):
    jes, tes, live, _, _ = _graph(seed=11)
    rng = np.random.default_rng(6)
    d, b, f = 8, 2, 3
    jp = _jax_net(hl, d)
    net = _torch_module(jp, InteractionNet(d, hidden_layers=hl))
    emb = init_mlp(jax.random.PRNGKey(8), [f, d, d])
    t_emb = _torch_module(emb, make_mlp([f, d, d]))
    lead = (b,) if batched else ()
    send = rng.normal(size=(N_SEND, *lead, d)).astype(np.float32)
    rec = rng.normal(size=(N_REC, d)).astype(np.float32)  # shared mesh rep
    feats = rng.normal(size=(N_EDGES, f)).astype(np.float32)
    edge = None
    if edge_in == "batched":
        edge = rng.normal(size=(N_EDGES, b, d)).astype(np.float32)
    elif edge_in == "shared":
        edge = rng.normal(size=(N_EDGES, d)).astype(np.float32)

    kw = dict(aggr=aggr, update_edges=update, propagation=prop)
    j_kw = dict(kw)
    t_kw = dict(kw)
    if edge_in == "embed":
        j_kw.update(
            edge_embedder=emb,
            edge_features=jnp.asarray(_slots(feats, live, jes)),
        )
        t_kw.update(edge_embedder=t_emb, edge_features=_t(feats))
    want = jax_apply_interaction_net(
        jp, jes, jnp.asarray(send), jnp.asarray(rec),
        None if edge is None else jnp.asarray(_slots(edge, live, jes)), **j_kw
    )
    with torch.no_grad():
        got = apply_interaction_net(
            net, tes, _t(send), _t(rec), None if edge is None else _t(edge), **t_kw
        )
    if update:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
        np.testing.assert_allclose(
            got[1].numpy(), np.asarray(want[1])[live], **TOL
        )
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_apply_interaction_net_rejects_bad_aggr():
    _, tes, _, _, _ = _graph()
    net = InteractionNet(4)
    x = torch.zeros(N_SEND, 4)
    with pytest.raises(ValueError, match="Unknown aggregation"):
        apply_interaction_net(net, tes, x, torch.zeros(N_REC, 4), None, aggr="max")


def test_split_first_matches_concat():
    gen = torch.Generator().manual_seed(0)
    mlp = make_mlp([12, 5, 5], generator=gen)
    parts = [torch.randn(7, 4, generator=gen) for _ in range(3)]
    with torch.no_grad():
        torch.testing.assert_close(
            apply_mlp_split_first(mlp, parts), mlp(torch.cat(parts, -1)),
            rtol=1e-6, atol=1e-6,  # f32 summation order
        )


def test_unfused_ops_raise_off_cpu():
    """The unfused route's ops (K6, K5) run a kernel on CUDA tensors and
    the plain version on CPU tensors: any other device is refused, no
    library op runs in the kernel's place."""
    _, tes, _, _, _ = _graph()
    meta = torch.zeros((N_REC, 4), device="meta")
    with pytest.raises(RuntimeError, match="receiver_expand: unsupported device"):
        segment.gather_receivers(tes, meta)
    with pytest.raises(RuntimeError, match="segment_sum: unsupported device"):
        segment.aggregate_sum(tes, torch.zeros((N_EDGES, 4), device="meta"))
    assert not hasattr(segment, "_require_cpu")


def test_wrappers_refuse_other_devices():
    _, tes, _, _, _ = _graph()
    with pytest.raises(RuntimeError, match="unsupported device"):
        sender_gather(torch.zeros((N_SEND, 4), device="meta"), tes.senders)


def _assert_grad_close(got, want, name="", tol=5e-5):
    """``got`` within ``tol`` of ``want``'s largest absolute value."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=name)


def test_make_edge_set_sender_tables():
    """The sender-sorted tables K2 walks, against a numpy argsort."""
    _, tes, _, _, _ = _graph()
    senders = tes.senders.numpy()
    perm = tes.send_perm.numpy()
    np.testing.assert_array_equal(perm, np.argsort(senders, kind="stable"))
    rowptr = tes.send_rowptr.numpy()
    assert rowptr.shape == (N_SEND + 1,) and rowptr[-1] == N_EDGES
    np.testing.assert_array_equal(
        np.diff(rowptr), np.bincount(senders, minlength=N_SEND)
    )
    for s in (0, N_SEND // 2, N_SEND - 1):
        slots = perm[rowptr[s] : rowptr[s + 1]]
        assert np.all(senders[slots] == s) and np.all(np.diff(slots) > 0)
    # without num_send the table ends at the largest sender
    es, _ = make_edge_set(np.array([4, 1, 4]), np.array([0, 1, 1]), num_rec=2)
    np.testing.assert_array_equal(es.send_rowptr.numpy(), [0, 0, 1, 1, 1, 3])
    moved = tes.to(torch.device("cpu"))
    assert torch.equal(moved.send_perm, tes.send_perm)


@pytest.mark.parametrize("batched", [False, True])
def test_sender_scatter_matches_jax_vjp(batched):
    """K2's plain version, as the backward of ``gather_senders``, vs the
    VJP of the JAX ``gather_senders`` (``banded_scatter_nondiff``)."""
    rng = np.random.default_rng(13)
    snd = rng.integers(0, N_SEND, N_EDGES)
    snd[snd == 5] = 6  # sender 5 gets no slot
    snd[:60] = 3  # a high-degree sender
    rcv = rng.integers(0, N_REC - 1, N_EDGES)
    jes, jperm = jax_make_edge_set(snd, rcv, num_rec=N_REC, num_send=N_SEND)
    tes, tperm = make_edge_set(snd, rcv, num_rec=N_REC, num_send=N_SEND)
    live = jperm >= 0
    assert jes.banded is not None
    shape = (N_SEND, 2, 8) if batched else (N_SEND, 8)
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=(N_EDGES,) + shape[1:]).astype(np.float32)

    out, vjp = jax.vjp(lambda a: jax_gather_senders(jes, a), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(_slots(g, live, jes)).astype(out.dtype))
    tx = _t(x).requires_grad_(True)
    segment.gather_senders(tes, tx).backward(_t(g))
    _assert_grad_close(tx.grad.numpy(), np.asarray(want)[:N_SEND])
    assert not np.any(tx.grad.numpy()[5])
    np.testing.assert_array_equal(
        tx.grad.numpy(), sender_scatter(_t(g), tes, N_SEND).numpy()
    )
    np.testing.assert_array_equal(
        tx.grad.numpy(), sender_scatter_plain(_t(g), tes.senders, N_SEND).numpy()
    )
    # the gather's input may have more rows than the edge set knows of
    more = sender_scatter(_t(g), tes, N_SEND + 3).numpy()
    np.testing.assert_array_equal(more[:N_SEND], tx.grad.numpy())
    assert not np.any(more[N_SEND:])
    with pytest.raises(ValueError, match="rows for an edge set"):
        sender_scatter(_t(g), tes, N_SEND - 1)


# K4's configurations: the four sites of the training step, batch 1, a
# LayerNorm-free MLP, propagation, a shared edge input, and an updated
# edge output that the loss does not use (d_new_edge arrives as None):
# (edge input, update_edges, propagation, ln, batch, use_new_edge)
K4_CASES = [
    ("raw", False, False, True, 4, True),  # g2m, m2g
    ("raw", True, False, True, 4, True),  # m2m layer 0
    ("batched", True, False, True, 4, True),  # m2m layers 1-2
    ("batched", True, False, True, 4, False),  # last m2m layer
    ("raw", False, False, True, 1, True),
    ("raw", True, False, True, 1, True),
    ("batched", True, False, True, 1, True),
    ("batched", True, False, True, 1, False),
    ("shared", True, False, True, 4, True),
    ("batched", True, False, False, 4, True),
    ("raw", False, False, False, 4, True),
    ("raw", False, True, True, 4, True),
    ("batched", True, True, True, 4, True),
]


@pytest.mark.parametrize("mode,update,prop,ln,b,use_new_edge", K4_CASES)
def test_fused_edge_phase_backward_matches_jax(mode, update, prop, ln, b, use_new_edge):
    """K4's plain version (``FusedEdgePhase`` on CPU tensors) vs
    ``jax.vjp`` of ``make_fused_interaction`` (interpret): d_send,
    d_rec, d_edge and every weight gradient."""
    jes, tes, live, _, _ = _graph()
    rng = np.random.default_rng(15)
    d, f = 8, 3
    k1, k2 = jax.random.split(jax.random.PRNGKey(2))
    mlp = init_mlp(k1, [3 * d, d, d], layer_norm=ln)
    emb = init_mlp(k2, [f, d, d])
    t_mlp = _torch_module(mlp, make_mlp([3 * d, d, d], layer_norm=ln))
    t_emb = _torch_module(emb, make_mlp([f, d, d]))

    send = rng.normal(size=(N_EDGES, b, d)).astype(np.float32)
    rec = rng.normal(size=(N_REC, b, d)).astype(np.float32)
    edge = {
        "raw": rng.normal(size=(N_EDGES, f)),
        "shared": rng.normal(size=(N_EDGES, d)),
        "batched": rng.normal(size=(N_EDGES, b, d)),
    }[mode].astype(np.float32)
    d_aggr = rng.normal(size=(N_REC, b, d)).astype(np.float32)
    d_new = rng.normal(size=(N_EDGES, b, d)).astype(np.float32)

    run = make_fused_interaction(
        jes.layout, update_edges=update, propagation=prop, interpret=True
    )
    j_edge = jnp.asarray(_slots(edge, live, jes))
    j_send = jnp.asarray(_slots(send, live, jes))
    if mode == "raw":
        fn = lambda m, e, s, r: run(m, None, s, r, emb_params=e, edge_feats=j_edge)  # noqa: E731
        j_out, vjp = jax.vjp(fn, mlp, emb, j_send, jnp.asarray(rec))
    else:
        fn = lambda m, e, s, r: run(m, e, s, r)  # noqa: E731
        j_out, vjp = jax.vjp(fn, mlp, j_edge, j_send, jnp.asarray(rec))
    seed_new = None
    if update:
        seed_new = jnp.asarray(_slots(d_new, live, jes)) if use_new_edge else jnp.zeros_like(j_out[1])
    j_mlp, j_e, j_send_g, j_rec_g = vjp((jnp.asarray(d_aggr), seed_new))

    t_send, t_rec = _t(send).requires_grad_(True), _t(rec).requires_grad_(True)
    t_edge = _t(edge)
    if mode != "raw":
        t_edge.requires_grad_(True)
    got = fused_edge_phase(
        t_mlp,
        None if mode == "raw" else t_edge,
        t_send, t_rec, tes,
        embedder=t_emb if mode == "raw" else None,
        edge_feats=t_edge if mode == "raw" else None,
        update_edges=update, propagation=prop,
    )
    total = (got[0] * _t(d_aggr)).sum()
    if update and use_new_edge:
        total = total + (got[1] * _t(d_new)).sum()
    total.backward()

    _assert_grad_close(t_send.grad.numpy(), np.asarray(j_send_g)[live], "d_send")
    _assert_grad_close(t_rec.grad.numpy(), np.asarray(j_rec_g), "d_rec")
    want = params_from_jax({"m": jax.device_get(j_mlp)})
    modules = {"m": t_mlp}
    if mode == "raw":
        want.update(params_from_jax({"e": jax.device_get(j_e)}))
        modules["e"] = t_emb
    else:
        _assert_grad_close(t_edge.grad.numpy(), np.asarray(j_e)[live], "d_edge")
    checked = 0
    for prefix, module in modules.items():
        for name, p in module.named_parameters():
            key = f"{prefix}.{name}"
            _assert_grad_close(p.grad.numpy(), want[key].numpy(), key)
            checked += 1
    assert checked == len(want)
