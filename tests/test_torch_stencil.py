"""The stencil m2m processor of the port (``ops/stencil.py``) against its
edge-list route and against the JAX package's stencil, on the CPU.

The seven cases of ``tests/test_stencil.py``: detection on the multiscale
mesh (the classes equal JAX ``detect_stencil``'s), the irregular, the
non-constant-feature and the multi-edge graphs falling back, the
stencil route against the edge-list route and against JAX's
``apply_stencil_processor`` (GraphLAM's step, sum and mean aggregation:
outputs within 1e-5; a two-step rollout's loss gradients within 2e-4 of
each gradient's largest entry), and ``NEURAL_LAM_TPU_STENCIL=off`` (and
``auto``, which is off in the port) honoured. The JAX side runs with
Pallas off, its plain reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_lam_tpu.convert_checkpoint import export_state_dict
from neural_lam_tpu.datastore.dummy import DummyDatastore as JaxDummyDatastore
from neural_lam_tpu.models import ARForecaster as JaxARForecaster
from neural_lam_tpu.models import GraphLAM as JaxGraphLAM
from neural_lam_tpu.ops.stencil import detect_stencil as jax_detect_stencil
from neural_lam_tpu_torch.convert_checkpoint import grads_to_numpy, params_from_jax
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.graphs import create_graph_from_datastore
from neural_lam_tpu_torch.models import ARForecaster, GraphLAM
from neural_lam_tpu_torch.ops.stencil import STENCIL_ENV, detect_stencil, stencil_enabled

DS_KW = dict(n_grid_x=27, n_grid_y=27, n_timesteps=10)
HIDDEN, LAYERS = 8, 3
OUT_TOL, GRAD_TOL = 1e-5, 2e-4


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("NEURAL_LAM_TPU_PALLAS", "off")
    monkeypatch.setenv(STENCIL_ENV, "on")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_stencil")
    ds = DummyDatastore(root_path=root, **DS_KW)
    create_graph_from_datastore(ds, root / "graph" / "ms", hierarchical=False)
    return root


def _port(root, mesh_aggr="sum", params=None):
    ds = DummyDatastore(root_path=root, **DS_KW)
    model = GraphLAM(ds, graph_name="ms", hidden_dim=HIDDEN, processor_layers=LAYERS,
                     mesh_aggr=mesh_aggr, device="cpu")
    if params is not None:
        model.load_state_dict(params_from_jax(params), strict=True)
    return model, ds


def _jax(root, mesh_aggr="sum"):
    jds = JaxDummyDatastore(root_path=root, **DS_KW)
    model = JaxGraphLAM(jds, graph_name="ms", hidden_dim=HIDDEN, processor_layers=LAYERS,
                        mesh_aggr=mesh_aggr)
    return model, jds, jax.device_get(model.init_params(jax.random.PRNGKey(0)))


def _lattice(nx=4, ny=4):
    xy = np.stack(np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij"), -1)
    idx = np.arange(nx * ny).reshape(nx, ny)
    return xy.reshape(-1, 2).astype(float), idx[:-1, :].ravel(), idx[1:, :].ravel()


def test_multiscale_mesh_detects_the_jax_classes(root, monkeypatch):
    """Every class of the multiscale mesh, with its stride, origin, offsets,
    constant features, masks and the in-degrees, as JAX detects them from
    its own graph buffers; the edges are covered exactly."""
    model, _ = _port(root)
    st = model._m2m_stencil()
    assert st is not None
    layout = st.layout
    assert layout.num_edges == model.graph.m2m[0].edges.num_edges
    jmodel, _, _ = _jax(root)
    pe = jmodel.graph.m2m[0]
    valid = np.asarray(pe.edges.receivers) != pe.edges.num_rec
    want = jax_detect_stencil(
        np.asarray(pe.edges.senders)[valid], np.asarray(pe.edges.receivers)[valid],
        np.asarray(pe.features)[valid], np.asarray(jmodel.graph.mesh_static_features[0]),
    )
    assert layout.dims == want.dims and len(layout.groups) == len(want.groups)
    for g, w in zip(layout.groups, want.groups):
        assert (g.stride, g.origin, g.dims, g.offsets) == (w.stride, w.origin, w.dims, w.offsets)
        assert sorted(g.offsets) == sorted(
            (dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1) if (dx, dy) != (0, 0))
        np.testing.assert_allclose(g.feats, w.feats, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(g.masks, w.masks)
    np.testing.assert_array_equal(layout.counts, want.counts)
    assert (layout.perm is None) == (want.perm is None)
    if layout.perm is not None:
        np.testing.assert_array_equal(layout.perm, want.perm)


def test_irregular_graph_falls_back():
    rng = np.random.default_rng(0)
    n = 25
    xy = rng.normal(size=(n, 2))  # not a lattice
    senders = rng.integers(0, n, size=60)
    receivers = rng.integers(0, n, size=60)
    feats = rng.normal(size=(60, 3))
    assert detect_stencil(senders, receivers, feats, xy) is None
    assert jax_detect_stencil(senders, receivers, feats, xy) is None


def test_nonconstant_features_fall_back():
    """A perfect lattice whose per-edge features vary within a class; with
    constant features it is a stencil."""
    xy, senders, receivers = _lattice()
    feats = np.random.default_rng(1).normal(size=(senders.size, 3))
    assert detect_stencil(senders, receivers, feats, xy) is None
    st = detect_stencil(senders, receivers, np.ones((senders.size, 3)), xy)
    assert st is not None and st.num_edges == senders.size


def _step_inputs(ds, seed):
    rng = np.random.default_rng(seed)
    n = ds.num_grid_points
    return [rng.normal(size=(2, n, k)).astype(np.float32) for k in (3, 3, 6)]


@pytest.mark.parametrize("mesh_aggr", ["sum", "mean"])
def test_stencil_matches_the_edge_list_and_jax(root, monkeypatch, mesh_aggr):
    """GraphLAM's step on the stencil route against the port's edge-list
    route and the JAX stencil step, the same weights."""
    jmodel, _, params = _jax(root, mesh_aggr)
    assert jmodel._m2m_stencil() is not None
    model, ds = _port(root, mesh_aggr, params)
    prev, prev_prev, forcing = _step_inputs(ds, 2)
    want = np.asarray(jax.vmap(lambda a, b, c: jmodel.step(params, a, b, c)[0])(
        prev, prev_prev, forcing))
    node_major = [torch.from_numpy(a).permute(1, 0, 2) for a in (prev, prev_prev, forcing)]
    with torch.no_grad():
        assert model._m2m_stencil() is not None
        got = model.step(*node_major)[0].permute(1, 0, 2).numpy()
        monkeypatch.setenv(STENCIL_ENV, "off")
        assert model._m2m_stencil() is None
        edge_list = model.step(*node_major)[0].permute(1, 0, 2).numpy()
    scale = max(np.abs(want).max(), 1.0)
    assert np.abs(got - want).max() <= OUT_TOL * scale
    assert np.abs(got - edge_list).max() <= OUT_TOL * scale


def test_stencil_gradients_match_the_edge_list_and_jax(root, monkeypatch):
    """The loss of a two-step rollout: every parameter's gradient on the
    stencil route against the edge-list route's and JAX's stencil ones."""
    jmodel, jds, params = _jax(root)
    rng = np.random.default_rng(3)
    n = jds.num_grid_points
    init = rng.normal(size=(2, 2, n, 3)).astype(np.float32)
    forcing = rng.normal(size=(2, 2, n, 6)).astype(np.float32)
    target = rng.normal(size=(2, 2, n, 3)).astype(np.float32)
    jfc = JaxARForecaster(jmodel, jds)

    def loss(p):
        pred, _ = jfc.forward(p, jnp.asarray(init), jnp.asarray(forcing), jnp.asarray(target))
        return jnp.mean((pred - target) ** 2)

    want = export_state_dict(jax.device_get(jax.grad(loss)(params)))

    def port_grads():
        model, ds = _port(root, params=params)
        pred, _ = ARForecaster(model, ds)(*(torch.from_numpy(a) for a in (init, forcing, target)))
        torch.mean((pred - torch.from_numpy(target)) ** 2).backward()
        return grads_to_numpy(model)

    got = port_grads()
    monkeypatch.setenv(STENCIL_ENV, "off")
    edge_list = port_grads()
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(got[key] - w).max() <= GRAD_TOL * scale, key
        assert np.abs(got[key] - edge_list[key]).max() <= GRAD_TOL * scale, key


@pytest.mark.parametrize("mode", ["off", "auto"])
def test_stencil_env_off_and_auto(root, monkeypatch, mode):
    """``off``, and ``auto`` (off in the port until a benchmark cell on the
    card measures the routes), keep the edge-list route."""
    monkeypatch.setenv(STENCIL_ENV, mode)
    assert not stencil_enabled()
    model, _ = _port(root)
    assert model._m2m_stencil() is None
    monkeypatch.setenv(STENCIL_ENV, "on")
    assert model._m2m_stencil() is not None


def test_multi_edge_falls_back():
    """A duplicated edge within an offset class disables the stencil."""
    xy, senders, receivers = _lattice()
    const = np.ones((senders.size, 3))
    assert detect_stencil(senders, receivers, const, xy) is not None
    dup_s = np.concatenate([senders, senders[:1]])
    dup_r = np.concatenate([receivers, receivers[:1]])
    assert detect_stencil(dup_s, dup_r, np.ones((dup_s.size, 3)), xy) is None
