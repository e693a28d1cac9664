"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where no GPU is present (decided in a
fixture, at run time). Run them on a machine with an H100 with
``python -m pytest -m cuda tests/test_torch_cuda.py``.

Parity is in exact float32 (TF32 off for matmuls and convolutions, so
the plain versions' products are exact too). The tolerances cover
summation order only: the kernels sum the 64-term dot products and each
receiver's messages in another order than PyTorch's CPU and CUDA
matmuls and ``index_add_``; every value is O(1) after LayerNorm and the
aggregates sum O(10) of them, so 1e-4 absolute is far above the
rounding and far below any real error.
"""

import numpy as np
import pytest
import torch

from neural_lam_tpu_torch.ops.fused_kernels import (
    fused_edge_phase,
    fused_edge_phase_plain,
)
from neural_lam_tpu_torch.ops.interaction import make_edge_set
from neural_lam_tpu_torch.ops.mlp import make_mlp
from neural_lam_tpu_torch.ops.segment_kernels import (
    sender_gather,
    sender_gather_plain,
)

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _edge_set(rng, n_send, n_rec, n_edges, device, empty_rec=0):
    """Random edges; the last ``empty_rec`` receivers get none."""
    snd = rng.integers(0, n_send, n_edges)
    rcv = rng.integers(0, n_rec - empty_rec, n_edges)
    es, perm = make_edge_set(snd, rcv, num_rec=n_rec, num_send=n_send)
    return es.to(device), perm


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 64), (3, 5)])
def test_sender_gather_matches_plain(cuda, shape):
    rng = np.random.default_rng(0)
    es, _ = _edge_set(rng, 300, 200, 5000, cuda)
    x = torch.tensor(rng.normal(size=(300,) + shape), dtype=torch.float32, device=cuda)
    before = sender_gather.launches
    out = sender_gather(x, es.senders)
    torch.cuda.synchronize()
    assert sender_gather.launches == before + 1
    # a copy: bit-identical
    torch.testing.assert_close(out, sender_gather_plain(x, es.senders), rtol=0, atol=0)


FLAGS = [
    # (edge mode, update_edges, propagation, layer_norm)
    ("raw", False, False, True),  # g2m / m2g
    ("raw", True, False, True),  # m2m layer 0
    ("batched", True, False, True),  # m2m layers 1-3
    ("shared", True, False, True),
    ("raw", False, True, True),  # PropagationNet
    ("batched", False, False, False),  # no LayerNorm
]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,update,prop,ln", FLAGS)
@pytest.mark.parametrize("batch", [4, 3, 1])  # 16, 21, 64 edges a tile
def test_fused_edge_phase_matches_plain(cuda, mode, update, prop, ln, batch):
    rng = np.random.default_rng(1)
    d, n_send, n_rec = 64, 70, 50
    es, _ = _edge_set(rng, n_send, n_rec, 900, cuda, empty_rec=5)
    gen = torch.Generator().manual_seed(0)
    edge_mlp = make_mlp([3 * d, d, d], layer_norm=ln, generator=gen).to(cuda)
    embedder = make_mlp([3, d, d], generator=gen).to(cuda)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32, device=cuda)

    send, rec = t(n_send, batch, d), t(n_rec, batch, d)
    x_send = sender_gather_plain(send, es.senders)
    kw = dict(update_edges=update, propagation=prop)
    edge_rep, feats, emb = None, None, None
    if mode == "raw":
        feats, emb = t(es.num_edges, 3), embedder
    elif mode == "shared":
        edge_rep = t(es.num_edges, d)
    else:
        edge_rep = t(es.num_edges, batch, d)
    with torch.no_grad():
        before = fused_edge_phase.launches
        got = fused_edge_phase(
            edge_mlp, edge_rep, x_send, rec, es, embedder=emb, edge_feats=feats, **kw
        )
        torch.cuda.synchronize()
        assert fused_edge_phase.launches == before + 1
        want = fused_edge_phase_plain(
            edge_mlp, edge_rep, x_send, rec, es.receivers, emb, feats, **kw
        )
    torch.testing.assert_close(got[0], want[0], **TOL)
    assert torch.all(got[0][-5:] == 0)  # receivers without edges
    if update:
        torch.testing.assert_close(got[1], want[1], **TOL)
    else:
        assert got[1] is None


@pytest.mark.cuda
def test_kernels_are_forward_only(cuda):
    rng = np.random.default_rng(2)
    es, _ = _edge_set(rng, 10, 10, 40, cuda)
    x = torch.zeros((10, 64), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="training slice"):
        sender_gather(x, es.senders)
