"""The port's training step against the JAX package on the CPU.

Same scheme as ``tests/test_torch_graph_lam.py``: both packages get the
same seeded ``DummyDatastore``, the same graph on disk and the same
weights (the JAX init carried over with ``params_from_jax``); inputs come
from numpy seeds. The JAX side runs its Pallas kernels in interpret mode
(``NEURAL_LAM_TPU_PALLAS=interpret``, ``NEURAL_LAM_TPU_FUSED=auto``); the
port runs its kernels' plain versions, which is what its wrappers do on
CPU tensors, with the backward going through ``SenderGather`` and
``FusedEdgePhase`` as it does on the card.

Tolerances: exact float32 on both sides, different summation order only.
Metric values: 2e-5 relative. Gradients: 5e-5 (1e-4 through the whole
model and loss) of each gradient's largest absolute value, since a
weight gradient sums a term per node and batch member and its small
entries are differences of large ones. Losses along an AdamW trajectory:
1e-4 relative. Parameters after ``k`` AdamW steps: Adam divides the
gradient by its running magnitude, so a weight whose true gradient is
near zero can move by up to ``lr`` per step in either direction on
rounding noise alone; the bound is therefore absolute and scales with
``k * lr``.

The training fixture ``tests/fixtures/accuracy/train_step_meps_seed0.npz``
holds, for the ``bench.py`` configuration (MEPS grid, hidden 64, 4
processor layers, batch 4, ``ar_steps`` 1, ``PRNGKey(0)`` weights, the
``default_rng(0)`` batch of ``bench.make_bench_batch``): the loss, every
parameter gradient under its state-dict name, and the losses of three
further AdamW steps at ``lr`` 1e-3, computed by the JAX package on the
CPU in exact float32 with Pallas off. ``chip_smoke.py`` holds the port
to it on the GPU. Regenerate it with
``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_train.py``;
:func:`test_train_fixture_path_small_grid` runs the same generator and
the same gate at a small grid.
"""

import dataclasses
import importlib.util
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neural_lam_tpu import config as jax_config
from neural_lam_tpu import loss_weighting as jax_loss_weighting
from neural_lam_tpu import metrics as jax_metrics
from neural_lam_tpu.convert_checkpoint import export_state_dict
from neural_lam_tpu.datastore.dummy import DummyDatastore as JaxDummyDatastore
from neural_lam_tpu.models import ARForecaster as JaxARForecaster
from neural_lam_tpu.models import GraphLAM as JaxGraphLAM
from neural_lam_tpu.trainer import Trainer as JaxTrainer
from neural_lam_tpu.trainer import TrainingArgs as JaxTrainingArgs
from neural_lam_tpu_torch import config, loss_weighting, metrics
from neural_lam_tpu_torch.convert_checkpoint import (
    grads_to_numpy,
    load_jax_params_npz,
    params_from_jax,
    params_to_numpy,
)
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.graphs import create_graph_from_datastore
from neural_lam_tpu_torch.models import ARForecaster, GraphLAM
from neural_lam_tpu_torch.trainer import Trainer, TrainingArgs, make_optimizer

REPO = Path(__file__).resolve().parent.parent
TRAIN_FIXTURE = REPO / "tests/fixtures/accuracy/train_step_meps_seed0.npz"
PARAMS_FIXTURE = REPO / "tests/fixtures/accuracy/graph_lam_meps_params_seed0.npz"
DS_KW = dict(n_grid_x=9, n_grid_y=9, n_timesteps=12, computed_stats=True)
MEPS_FEATURES = dict(n_state_features=17, n_forcing_features=6, n_static_features=4)
METRIC_NAMES = ["mse", "mae", "wmse", "wmae", "nll", "crps_gauss"]
FIXTURE_LR = 1e-3
FIXTURE_EXTRA_STEPS = 3


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("NEURAL_LAM_TPU_PALLAS", "interpret")
    monkeypatch.setenv("NEURAL_LAM_TPU_FUSED", "auto")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """One graph on disk, built by the port, read by both packages."""
    root = tmp_path_factory.mktemp("torch_train")
    ds = DummyDatastore(root_path=root, **DS_KW)
    create_graph_from_datastore(ds, root / "graph" / "multiscale")
    return root


def _assert_grad_close(got, want, name="", tol=5e-5):
    """``got`` within ``tol`` of ``want``'s largest absolute value."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=name)


def _assert_grad_dicts_close(got: dict, want: dict, tol=5e-5):
    assert sorted(got) == sorted(want)
    for key in want:
        _assert_grad_close(got[key], want[key], key, tol)


# -- metrics ----------------------------------------------------------------


def _metric_inputs(seed=0, node_std=False):
    rng = np.random.default_rng(seed)
    b, t, n, d = 2, 3, 11, 4
    pred = rng.normal(size=(b, t, n, d)).astype(np.float32)
    target = rng.normal(size=(b, t, n, d)).astype(np.float32)
    std_shape = (b, t, n, d) if node_std else (d,)
    std = rng.uniform(0.5, 2.0, size=std_shape).astype(np.float32)
    mask = rng.random(n) > 0.3
    return pred, target, std, mask


@pytest.mark.parametrize("name", METRIC_NAMES)
@pytest.mark.parametrize("average_grid", [True, False])
@pytest.mark.parametrize("sum_vars", [True, False])
@pytest.mark.parametrize("masked", [True, False])
def test_metric_matches_jax(name, average_grid, sum_vars, masked):
    pred, target, std, mask = _metric_inputs()
    kw = dict(
        mask=mask if masked else None, average_grid=average_grid, sum_vars=sum_vars
    )
    want = jax_metrics.get_metric(name)(
        jnp.asarray(pred), jnp.asarray(target), jnp.asarray(std), **kw
    )
    got = metrics.get_metric(name)(
        torch.from_numpy(pred), torch.from_numpy(target), torch.from_numpy(std), **kw
    )
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-6)
    if masked:  # a mask already a tensor, as the trainer passes it
        again = metrics.get_metric(name)(
            torch.from_numpy(pred), torch.from_numpy(target), torch.from_numpy(std),
            **dict(kw, mask=torch.from_numpy(mask)),
        )
        assert torch.equal(got, again)
    entry = metrics.get_metric_entry(name)(
        torch.from_numpy(pred), torch.from_numpy(target), torch.from_numpy(std)
    )
    want_entry = jax_metrics.get_metric_entry(name)(
        jnp.asarray(pred), jnp.asarray(target), jnp.asarray(std)
    )
    np.testing.assert_allclose(
        entry.numpy(), np.asarray(want_entry), rtol=2e-5, atol=2e-6
    )


@pytest.mark.parametrize("name", METRIC_NAMES)
@pytest.mark.parametrize("node_std", [False, True])
def test_metric_gradients_finite_with_nan_at_masked_nodes(name, node_std):
    """NaN targets (and a NaN std head) at masked-out nodes must not
    reach any gradient: the inputs are neutralised before the entry is
    computed, not only dropped from the sum."""
    pred, target, std, mask = _metric_inputs(seed=1, node_std=node_std)
    target[:, :, ~mask] = np.nan
    if node_std:
        std[:, :, ~mask] = np.nan
    w = torch.ones(4, 4, requires_grad=True)
    t_std = torch.from_numpy(std).requires_grad_(node_std)
    loss = metrics.get_metric(name)(
        torch.from_numpy(pred) @ w, torch.from_numpy(target), t_std, mask=mask
    ).mean()
    assert torch.isfinite(loss)
    loss.backward()
    assert torch.isfinite(w.grad).all()
    if t_std.grad is not None:  # mse and mae ignore the std
        assert torch.isfinite(t_std.grad).all()
        assert not t_std.grad[:, :, ~mask].any()
    want = jax_metrics.get_metric(name)(
        jnp.asarray(pred) @ jnp.ones((4, 4)), jnp.asarray(target),
        jnp.asarray(std), mask=mask,
    ).mean()
    np.testing.assert_allclose(loss.item(), float(want), rtol=2e-5)


def test_metric_lookup_errors():
    with pytest.raises(ValueError, match="Unknown metric"):
        metrics.get_metric("rmse")
    with pytest.raises(ValueError, match="Unknown metric"):
        metrics.get_metric_entry("rmse")
    assert metrics.get_metric("WMSE") is metrics.wmse


# -- config and loss weighting ------------------------------------------------


def _configs(weighting_dict=None):
    data = {"datastore": {"kind": "dummydata", "config_path": "ds.yaml"}}
    if weighting_dict is not None:
        data["training"] = {"state_feature_weighting": weighting_dict}
    return jax_config.config_from_dict(data), config.config_from_dict(data)


@pytest.mark.parametrize(
    "weighting",
    [
        None,
        {"__config_class__": "UniformFeatureWeighting"},
        {"weights": {"state_var_0": 2.0, "state_var_1": 0.5, "state_var_2": 1.0}},
    ],
)
def test_state_feature_weighting_matches_jax(root, weighting):
    jcfg, tcfg = _configs(weighting)
    assert config.config_to_dict(tcfg) == jax_config.config_to_dict(jcfg)
    want = jax_loss_weighting.get_state_feature_weighting(
        jcfg, JaxDummyDatastore(root_path=root, **DS_KW)
    )
    got = loss_weighting.get_state_feature_weighting(
        tcfg, DummyDatastore(root_path=root, **DS_KW)
    )
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_manual_weighting_must_cover_every_variable(root):
    _, tcfg = _configs({"weights": {"state_var_0": 2.0, "bogus": 1.0}})
    with pytest.raises(ValueError, match="no weight given for") as err:
        loss_weighting.get_state_feature_weighting(
            tcfg, DummyDatastore(root_path=root, **DS_KW)
        )
    assert "unknown variables ['bogus']" in str(err.value)


def test_config_errors_and_yaml_round_trip(tmp_path):
    with pytest.raises(config.InvalidConfigError, match="datastore"):
        config.config_from_dict({})
    with pytest.raises(config.InvalidConfigError, match="Unknown keys"):
        config.config_from_dict(
            {"datastore": {"kind": "k", "config_path": "p"}, "training": {"x": 1}}
        )
    with pytest.raises(config.InvalidConfigError, match="Unknown state_feature"):
        config.config_from_dict(
            {
                "datastore": {"kind": "k", "config_path": "p"},
                "training": {"state_feature_weighting": {"__config_class__": "Nope"}},
            }
        )
    yaml = pytest.importorskip("yaml")
    _, tcfg = _configs({"weights": {"a": 1.0}})
    tcfg.training.output_clamping.lower["a"] = 0.0
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(config.config_to_dict(tcfg)))
    assert config.load_config(path) == tcfg
    assert jax_config.config_to_dict(jax_config.load_config(path)) == (
        config.config_to_dict(tcfg)
    )


# -- model gradients -----------------------------------------------------------


def _models(root, hidden, ds_kw=DS_KW, **model_kw):
    jds = JaxDummyDatastore(root_path=root, **ds_kw)
    tds = DummyDatastore(root_path=root, **ds_kw)
    jm = JaxGraphLAM(jds, hidden_dim=hidden, processor_layers=2, **model_kw)
    params = jm.init_params(jax.random.PRNGKey(0))
    tm = GraphLAM(tds, hidden_dim=hidden, processor_layers=2, device="cpu", **model_kw)
    tm.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    return jds, tds, jm, params, tm


def _batch(ds, batch, steps, seed=2):
    """A batch in the order of ``bench.make_bench_batch``: init, target,
    forcing."""
    rng = np.random.default_rng(seed)
    n = ds.num_grid_points
    d = ds.get_num_data_vars("state")
    f = ds.get_num_data_vars("forcing") * 3
    return (
        rng.normal(size=(batch, 2, n, d)).astype(np.float32),
        rng.normal(size=(batch, steps, n, d)).astype(np.float32),
        rng.normal(size=(batch, steps, n, f)).astype(np.float32),
    )


CLAMP = dict(
    output_clamping_lower={"state_var_0": -0.5, "state_var_2": -1.0},
    output_clamping_upper={"state_var_1": 0.5, "state_var_2": 1.0},
)


@pytest.mark.parametrize("hidden", [8, 64])
def test_graph_lam_step_grads_match_jax(root, hidden):
    """Parameter and input gradients of ``GraphLAM.step`` (a weighted sum
    of the new state) against ``jax.grad``; hidden 64 is the kernels'
    width, 8 a narrower one."""
    _, tds, jm, params, tm = _models(root, hidden, **CLAMP)
    rng = np.random.default_rng(3)
    n, b = tds.num_grid_points, 2
    d = tds.get_num_data_vars("state")
    f = tds.get_num_data_vars("forcing") * 3
    prev, prev_prev = (rng.normal(size=(n, b, d)).astype(np.float32) for _ in range(2))
    forcing = rng.normal(size=(n, b, f)).astype(np.float32)
    w = rng.normal(size=(n, b, d)).astype(np.float32)

    def jax_loss(p, x):
        out, _ = jm.step(p, x, jnp.asarray(prev_prev), jnp.asarray(forcing))
        return jnp.sum(out[:n] * w)

    want_p, want_x = jax.grad(jax_loss, argnums=(0, 1))(params, jnp.asarray(prev))
    t_prev = torch.from_numpy(prev).requires_grad_(True)
    out, _ = tm.step(t_prev, torch.from_numpy(prev_prev), torch.from_numpy(forcing))
    (out * torch.from_numpy(w)).sum().backward()
    _assert_grad_dicts_close(
        grads_to_numpy(tm), export_state_dict(jax.device_get(want_p)), tol=1e-4
    )
    _assert_grad_close(t_prev.grad.numpy(), np.asarray(want_x), "prev_state", 1e-4)


def _trainers(root, hidden=64, batch_size=2, lr=1e-3, loss="wmse", ds_kw=DS_KW,
              weighting=None):
    jds, tds, jm, params, tm = _models(root, hidden, ds_kw=ds_kw)
    jcfg, tcfg = _configs(weighting)
    jt = JaxTrainer(
        JaxARForecaster(jm, jds), jcfg, jds,
        JaxTrainingArgs(batch_size=batch_size, lr=lr, loss=loss),
    )
    tt = Trainer(
        ARForecaster(tm, tds), tcfg, tds,
        TrainingArgs(batch_size=batch_size, lr=lr, loss=loss), device="cpu",
    )
    return jt, params, tt, tm, tds


@pytest.mark.parametrize("loss,steps", [("wmse", 1), ("mae", 2)])
def test_trainer_loss_and_grads_match_jax(root, loss, steps):
    """``Trainer._loss`` and every parameter gradient for one batch,
    with a manual feature weighting."""
    weighting = {"weights": {"state_var_0": 2.0, "state_var_1": 0.5, "state_var_2": 1.0}}
    jt, params, tt, tm, tds = _trainers(root, loss=loss, weighting=weighting)
    np.testing.assert_allclose(
        tt.per_var_std.numpy(), np.asarray(jt.per_var_std), rtol=1e-6
    )
    np.testing.assert_array_equal(tt.interior_mask_bool, jt.interior_mask_bool)
    batch = _batch(tds, 2, steps)
    want_loss, want_grads = jax.value_and_grad(jt._loss)(params, *batch)
    got_loss = tt._loss(*batch)
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=2e-5)
    _assert_grad_dicts_close(
        grads_to_numpy(tm), export_state_dict(jax.device_get(want_grads)), tol=1e-4
    )


def test_train_steps_match_jax_trajectory(root):
    """Five AdamW steps from one init on identical batches: the losses
    and the final parameters against the JAX ``make_train_step``."""
    steps, lr = 5, 1e-3
    jt, params, tt, tm, tds = _trainers(root, lr=lr)
    batches = [_batch(tds, 2, 1, seed=10 + k) for k in range(steps)]
    step = jt.make_train_step()
    # the jitted step donates its arguments: hand it copies
    j_params, opt_state = jt.place_state(
        jax.tree_util.tree_map(jnp.array, params), jt.optimizer.init(params)
    )
    want_losses = []
    for batch in batches:
        j_params, opt_state, loss = step(j_params, opt_state, *batch)
        want_losses.append(float(loss))
    got_losses = [tt.train_step(*batch).item() for batch in batches]
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    assert got_losses[-1] != got_losses[0]
    want = export_state_dict(jax.device_get(j_params))
    got = params_to_numpy(tm)
    assert sorted(got) == sorted(want)
    before = export_state_dict(jax.device_get(params))
    worst, moved = 0.0, 0.0
    for key in want:
        worst = max(worst, float(np.abs(got[key] - want[key]).max()))
        moved = max(moved, float(np.abs(want[key] - before[key]).max()))
    # every weight moved by up to steps * lr; the two trajectories stay
    # within a twentieth of that of each other, and on average far closer
    assert moved > 0.5 * steps * lr
    assert worst <= 0.05 * steps * lr, worst
    mean = np.mean([np.abs(got[k] - want[k]).mean() for k in want])
    assert mean <= 1e-3 * steps * lr, mean


def test_make_optimizer_is_the_reference_adamw():
    p = torch.nn.Parameter(torch.ones(3))
    opt = make_optimizer([p], lr=2e-3)
    group = opt.param_groups[0]
    assert isinstance(opt, torch.optim.AdamW)
    assert (group["lr"], group["betas"], group["eps"], group["weight_decay"]) == (
        2e-3, (0.9, 0.95), 1e-8, 0.01,
    )
    # one step against optax.adamw on the same gradient
    g = np.array([0.5, -2.0, 0.0], np.float32)
    p.grad = torch.from_numpy(g)
    opt.step()
    tx = optax.adamw(2e-3, b1=0.9, b2=0.95, weight_decay=0.01)
    ones = jnp.ones(3)
    updates, _ = tx.update(jnp.asarray(g), tx.init(ones), ones)
    np.testing.assert_allclose(
        p.detach().numpy(), np.asarray(ones + updates), rtol=1e-6
    )


def test_remat_matches_no_remat(root):
    """Per-step rematerialisation at 3 AR steps: the same loss, the same
    gradients within 1e-6; off by default only for a single step."""
    _, tds, _, _, tm = _models(root, 8)
    batch = _batch(tds, 2, 3)
    results = []
    for remat in (True, False, None):
        tt = Trainer(
            ARForecaster(tm, tds, remat_steps=remat),
            _configs()[1], tds, TrainingArgs(batch_size=2), device="cpu",
        )
        tt.optimizer.zero_grad(set_to_none=True)
        loss = tt._loss(*batch)
        loss.backward()
        results.append((loss.item(), grads_to_numpy(tm)))
    (loss_on, grads_on), (loss_off, grads_off), (loss_auto, _) = results
    assert loss_on == loss_off == loss_auto
    _assert_grad_dicts_close(grads_on, grads_off, tol=1e-6)


def test_trainer_refuses_what_is_not_ported(root):
    tds = DummyDatastore(root_path=root, **DS_KW)
    fc = ARForecaster(GraphLAM(tds, hidden_dim=8, processor_layers=1, device="cpu"), tds)
    cfg = _configs()[1]
    with pytest.raises(ValueError, match="precision '16'"):
        Trainer(fc, cfg, tds, TrainingArgs(precision="16"), device="cpu")
    with pytest.raises(ValueError, match="Unknown metric"):
        Trainer(fc, cfg, tds, TrainingArgs(loss="rmse"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(fc, cfg, tds, TrainingArgs())
    fields = {f.name for f in dataclasses.fields(TrainingArgs)}
    assert fields <= {f.name for f in dataclasses.fields(JaxTrainingArgs)}


# -- the training fixture ---------------------------------------------------------


def _write_train_fixture(trainer: JaxTrainer, ds, path: Path) -> None:
    """Loss, gradients and the losses of further AdamW steps for the
    ``bench.make_bench_batch`` batch and ``PRNGKey(0)`` weights of a JAX
    trainer (see the module docstring for the file's layout)."""
    n = ds.num_grid_points
    rng = np.random.default_rng(0)
    d = ds.get_num_data_vars("state")
    f = ds.get_num_data_vars("forcing") * 3
    b = trainer.args.batch_size
    batch = (
        rng.normal(size=(b, 2, n, d)).astype(np.float32),
        rng.normal(size=(b, 1, n, d)).astype(np.float32),
        rng.normal(size=(b, 1, n, f)).astype(np.float32),
    )
    params = trainer.forecaster.init_params(jax.random.PRNGKey(0))
    value_and_grad = jax.jit(jax.value_and_grad(trainer._loss))
    tx = optax.adamw(FIXTURE_LR, b1=0.9, b2=0.95, weight_decay=0.01)
    opt_state = tx.init(params)
    losses, first_grads = [], None
    for _ in range(1 + FIXTURE_EXTRA_STEPS):
        loss, grads = value_and_grad(params, *batch)
        losses.append(float(loss))
        if first_grads is None:
            first_grads = export_state_dict(jax.device_get(grads))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    grid = np.array([ds.grid_shape_state.x, ds.grid_shape_state.y], np.int64)
    np.savez_compressed(
        path,
        losses=np.array(losses, np.float64),
        lr=np.float64(FIXTURE_LR),
        batch=np.int64(b),
        grid=grid,
        **{f"grad/{k}": np.asarray(v, np.float32) for k, v in first_grads.items()},
    )


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_train_fixture_path_small_grid(tmp_path):
    """The fixture's generator and ``chip_smoke.py``'s training gate, end
    to end at a 12x10 grid with the MEPS feature counts and widths."""
    kw = dict(n_grid_x=12, n_grid_y=10, n_timesteps=8, **MEPS_FEATURES)
    tds = DummyDatastore(root_path=tmp_path, **kw)
    create_graph_from_datastore(tds, tmp_path / "graph" / "multiscale")
    jds = JaxDummyDatastore(root_path=tmp_path, **kw)
    jt = JaxTrainer(
        JaxARForecaster(JaxGraphLAM(jds, hidden_dim=64, processor_layers=4), jds),
        _configs()[0], jds, JaxTrainingArgs(batch_size=4),
    )
    path = tmp_path / "train_fixture.npz"
    _write_train_fixture(jt, jds, path)

    smoke = _load_chip_smoke()
    tm = GraphLAM(tds, hidden_dim=64, processor_layers=4, device="cpu")
    # the committed PRNGKey(0) weights: their shapes do not depend on the grid
    tm.load_state_dict(params_from_jax(load_jax_params_npz(PARAMS_FIXTURE)), strict=True)
    trainer = Trainer(
        ARForecaster(tm, tds), _configs()[1], tds,
        TrainingArgs(batch_size=4, lr=FIXTURE_LR), device="cpu",
    )
    lines = []
    smoke.log = lines.append
    report = smoke.phase_train_gate(torch, trainer, path)
    assert report["loss_rel"] <= smoke.TRAIN_LOSS_RTOL
    assert report["grad_rel"] <= smoke.TRAIN_GRAD_TOL
    assert len(report["losses"]) == 1 + FIXTURE_EXTRA_STEPS
    assert any("train gate" in line for line in lines)
    # a wrong gradient fails the gate
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    data["grad/output_map.2.bias"] = data["grad/output_map.2.bias"] * 1.01
    np.savez_compressed(tmp_path / "bad.npz", **data)
    # the gate trained the model in place: start again from the same weights
    tm.load_state_dict(params_from_jax(load_jax_params_npz(PARAMS_FIXTURE)), strict=True)
    with pytest.raises(AssertionError, match="output_map.2.bias"):
        smoke.phase_train_gate(torch, trainer, tmp_path / "bad.npz")


def test_committed_train_fixture_layout():
    """The committed fixture names every parameter of the MEPS model and
    records its own configuration."""
    params = params_from_jax(load_jax_params_npz(PARAMS_FIXTURE))
    with np.load(TRAIN_FIXTURE) as f:
        grads = {k[len("grad/"):]: f[k] for k in f.files if k.startswith("grad/")}
        assert f["losses"].shape == (1 + FIXTURE_EXTRA_STEPS,)
        assert np.isfinite(f["losses"]).all() and f["losses"][-1] < f["losses"][0]
        assert float(f["lr"]) == FIXTURE_LR and int(f["batch"]) == 4
    assert sorted(grads) == sorted(params)
    for key, g in grads.items():
        assert g.shape == tuple(params[key].shape), key
        assert np.isfinite(g).all() and np.any(g), key


def _export_train_fixture(path=TRAIN_FIXTURE):
    """Write the fixture from ``bench.build_trainer()`` (Pallas off)."""
    os.environ["NEURAL_LAM_TPU_PALLAS"] = "off"
    os.environ["NEURAL_LAM_TPU_STENCIL"] = "off"
    sys.path.insert(0, str(REPO))
    import bench

    trainer, ds = bench.build_trainer()
    _write_train_fixture(trainer, ds, path)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    _export_train_fixture()
