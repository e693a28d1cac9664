"""Routing by shape before any launch: the fused edge phase's CUDA kernels
(K3/K4, K7/K8) are built for hidden 64 and batch 1 to 32, and a call they
do not take goes the unfused route, as the JAX package's
``fused_edge_phase_supported`` sends a shape its kernel cannot stripe
(``stripe_fits``) to its unfused path.

All on the CPU: ``fused_kernels.kernels_take`` takes the device as an
argument, so it is asked about a CUDA device without one, and the
predicates that call it are checked with it answering as it would on
CUDA tensors (the plain versions then run both routes here).
"""

import numpy as np
import pytest
import torch

from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.graphs import create_graph_from_datastore
from neural_lam_tpu_torch.models import HiLAMParallel, hi_lam_parallel
from neural_lam_tpu_torch.ops import fused_kernels, interaction
from neural_lam_tpu_torch.ops.mlp import make_mlp


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("batch", [1, 32, 33])
@pytest.mark.parametrize("hidden", [32, 64])
def test_kernels_take(hidden, batch, device):
    """On CUDA only hidden 64 at batch 1-32; on the CPU every shape (the
    plain versions take any width)."""
    want = device == "cpu" or (hidden == 64 and batch <= 32)
    assert fused_kernels.kernels_take(hidden, batch, torch.device(device)) is want
    assert fused_kernels.kernels_take(hidden, batch, device) is want


@pytest.fixture
def as_on_cuda(monkeypatch):
    """``kernels_take`` answering as for CUDA tensors, recording what it
    was asked: ``(hidden, batch, device type)`` per call."""
    real = fused_kernels.kernels_take
    calls = []

    def ask(hidden, batch, device):
        calls.append((hidden, batch, torch.device(device).type))
        return real(hidden, batch, "cuda")

    monkeypatch.setattr(fused_kernels, "kernels_take", ask)
    return calls


def _routes(monkeypatch):
    """Record which route each edge phase of ``apply_interaction_net``
    takes."""
    taken = []
    for name in ("_fused_phase", "_unfused_phase"):
        inner = getattr(interaction, name)

        def spy(*args, _inner=inner, _name=name, **kw):
            taken.append(_name)
            return _inner(*args, **kw)

        monkeypatch.setattr(interaction, name, spy)
    return taken


@pytest.mark.parametrize(
    "hidden,batch,embed",
    [(64, 4, False), (64, 4, True), (32, 4, False), (32, 4, True), (64, 33, False),
     (64, 32, True), (64, None, False)],
)
def test_interaction_net_routes_by_kernels_take(monkeypatch, as_on_cuda, hidden, batch, embed):
    """``fused_edge_phase_supported`` asks ``kernels_take`` with the width
    and the batch of the call (1 when nothing is batched), and
    ``apply_interaction_net`` takes the fused route exactly when it says
    yes; the unfused route computes the same step."""
    rng = np.random.default_rng(0)
    n_send, n_rec, n_edges = 30, 20, 120
    es, _ = interaction.make_edge_set(
        rng.integers(0, n_send, n_edges), rng.integers(0, n_rec, n_edges), num_rec=n_rec
    )
    net = interaction.InteractionNet(hidden, generator=torch.Generator().manual_seed(1))
    emb = make_mlp([3, hidden, hidden], generator=torch.Generator().manual_seed(2))
    lead = () if batch is None else (batch,)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32)

    send, rec = t(n_send, *lead, hidden), t(n_rec, *lead, hidden)
    kw = dict(update_edges=True)
    if embed:
        kw.update(edge_embedder=emb, edge_features=t(n_edges, 3))
        edge = None
    else:
        edge = t(n_edges, hidden)  # shared across the batch
    taken = _routes(monkeypatch)
    with torch.no_grad():
        got = interaction.apply_interaction_net(net, es, send, rec, edge, **kw)
    fused = hidden == 64 and (batch or 1) <= 32
    assert as_on_cuda and set(as_on_cuda) == {(hidden, batch or 1, "cpu")}
    assert taken == ["_fused_phase" if fused else "_unfused_phase"]
    monkeypatch.setattr(fused_kernels, "kernels_take", lambda *a: True)
    with torch.no_grad():
        want = interaction.apply_interaction_net(net, es, send, rec, edge, **kw)
    assert taken[-1] == "_fused_phase"
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5)


def test_section_entry_routes_by_kernels_take(as_on_cuda):
    """``fused_edge_phase_supported``, which HiLAMParallel asks per
    section, says no at batch 33 or hidden 32 on CUDA and yes at hidden 64
    and batch 32, for a shared and an unbatched edge input alike."""
    es, _ = interaction.make_edge_set(np.arange(6) % 3, np.arange(6) % 2, num_rec=2)
    cases = [((3, 33, 64), (2, 33, 64), (6, 64), False),
             ((3, 32, 64), (2, 32, 64), (6, 32, 64), True),
             ((3, 64), (2, 4, 64), (6, 64), True),
             ((3, 64), (2, 64), None, True),
             ((3, 4, 32), (2, 4, 32), (6, 32), False)]
    for send, rec, edge, want in cases:
        h = send[-1]
        mlp = make_mlp([3 * h, h, h])
        got = interaction.fused_edge_phase_supported(
            mlp, es, torch.zeros(send), torch.zeros(rec),
            None if edge is None else torch.zeros(edge),
        )
        assert got is want
    assert [c[1] for c in as_on_cuda] == [33, 32, 4, 1, 4]


@pytest.fixture(scope="module")
def hi_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("routing_hier")
    ds = DummyDatastore(root_path=root, n_grid_x=27, n_grid_y=27, n_timesteps=12)
    create_graph_from_datastore(ds, root / "graph" / "hierarchical", hierarchical=True)
    return root


@pytest.mark.parametrize("hidden,batch,fused", [(64, 2, True), (32, 2, False), (64, 33, False)])
def test_hi_lam_parallel_routes_by_kernels_take(monkeypatch, as_on_cuda, hi_root, hidden, batch,
                                                fused):
    """``HiLAMParallel.hi_processor_step`` takes the per-section fused
    phases where ``kernels_take`` says yes for every section and the
    unfused ones where it says no (hidden 32, batch 33)."""
    ds = DummyDatastore(root_path=hi_root, n_grid_x=27, n_grid_y=27, n_timesteps=12)
    torch.manual_seed(0)
    model = HiLAMParallel(ds, hidden_dim=hidden, processor_layers=1, device="cpu")
    taken = []
    for name in ("fused_edge_phase", "unfused_edge_phase"):
        inner = getattr(hi_lam_parallel, name)

        def spy(*args, _inner=inner, _name=name, **kw):
            taken.append(_name)
            return _inner(*args, **kw)

        monkeypatch.setattr(hi_lam_parallel, name, spy)
    rng = np.random.default_rng(3)
    n, d, f = ds.num_grid_points, ds.get_num_data_vars("state"), ds.get_num_data_vars("forcing")
    inputs = [torch.tensor(rng.normal(size=(n, batch, w)), dtype=torch.float32)
              for w in (d, d, 3 * f)]
    with torch.no_grad():
        out, _ = model.step(*inputs)
    assert torch.isfinite(out).all()
    sections = len(model._sections)
    assert taken == [("fused_edge_phase" if fused else "unfused_edge_phase")] * sections
    assert {(h, b) for h, b, _ in as_on_cuda} == {(hidden, batch)}
