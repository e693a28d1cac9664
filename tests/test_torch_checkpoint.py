"""The port's checkpoints and checkpoint conversion, against the JAX package.

- ``CheckpointManager``: save and restore are exact (parameters, AdamW
  state, step), the best/latest policy and ``best.json`` hold across a
  resume, ``restore_params_only`` refuses another architecture with the
  JAX package's message and never touches the optimizer.
- ``hparams.json``: the port's CLI records the same keys and values as the
  JAX CLI for the same argv, and the port rebuilds the architecture from
  an ``hparams.json`` the JAX package wrote.
- ``convert_state_dict`` / ``export_state_dict`` agree with the JAX
  package's on a state dict made here, with the Lightning prefix and the
  legacy ``g2m_gnn.grid_mlp`` rename; ``convert_checkpoint.main`` turns
  such a ``.ckpt`` file into a checkpoint the port loads.
- The optimizer state crosses over: two AdamW steps in JAX, then the
  parameters (``params_from_jax``) and the moments and step count
  (``opt_state_from_jax``) into the port, and three more steps in both,
  whose losses agree within 1e-5 relative (float32 on both sides, another
  summation order only).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from neural_lam_tpu import train_model as jax_train_model
from neural_lam_tpu.checkpoint import build_forecaster_from_hparams as jax_build
from neural_lam_tpu.config import config_from_dict as jax_config_from_dict
from neural_lam_tpu.convert_checkpoint import convert_state_dict as jax_convert
from neural_lam_tpu.convert_checkpoint import export_state_dict as jax_export
from neural_lam_tpu.datastore.dummy import DummyDatastore as JaxDummyDatastore
from neural_lam_tpu.models import ARForecaster as JaxARForecaster
from neural_lam_tpu.models import GraphLAM as JaxGraphLAM
from neural_lam_tpu.trainer import Trainer as JaxTrainer
from neural_lam_tpu.trainer import TrainingArgs as JaxTrainingArgs
from neural_lam_tpu_torch import convert_checkpoint, train_model
from neural_lam_tpu_torch.checkpoint import (
    CheckpointManager,
    build_forecaster_from_hparams,
    load_forecaster_from_checkpoint,
    load_optimizer_state,
    resolve_load,
)
from neural_lam_tpu_torch.config import config_from_dict
from neural_lam_tpu_torch.convert_checkpoint import (
    convert_state_dict,
    export_state_dict,
    opt_state_from_jax,
    params_from_jax,
    params_to_numpy,
)
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.graphs import create_graph_from_datastore
from neural_lam_tpu_torch.models import ARForecaster, GraphLAM
from neural_lam_tpu_torch.trainer import Trainer, TrainingArgs, make_optimizer

DS_KW = dict(n_grid_x=9, n_grid_y=9, n_timesteps=12, seed=7)
CONFIG = {"datastore": {"kind": "dummydata", "config_path": "ds.yaml"}}
HIDDEN = 8


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("NEURAL_LAM_TPU_PALLAS", "off")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A dummy datastore config and its graph, read by both packages."""
    root = tmp_path_factory.mktemp("torch_ckpt")
    (root / "ds.yaml").write_text(yaml.safe_dump(DS_KW), encoding="utf-8")
    (root / "config.yaml").write_text(yaml.safe_dump(CONFIG), encoding="utf-8")
    ds = DummyDatastore(root_path=root, **DS_KW)
    create_graph_from_datastore(ds, root / "graph" / "multiscale")
    return root


def _model(root, seed=0, **kw):
    ds = DummyDatastore(root_path=root, **DS_KW)
    return GraphLAM(ds, hidden_dim=HIDDEN, processor_layers=2, seed=seed, device="cpu", **kw)


def _trained_optimizer(model, steps=2):
    """An AdamW over ``model`` with ``steps`` steps of state."""
    opt = make_optimizer(model.parameters(), lr=1e-3)
    for k in range(steps):
        opt.zero_grad()
        sum((p * (k + 1)).square().sum() for p in model.parameters()).backward()
        opt.step()
    return opt


def test_save_and_restore_are_exact(root, tmp_path):
    model = _model(root)
    opt = _trained_optimizer(model)
    mgr = CheckpointManager(tmp_path / "run")
    mgr.save("latest", model, opt, step=3, hparams={"model": "graph_lam"})
    assert (tmp_path / "run" / "checkpoints" / "latest" / "state.pt").exists()
    assert mgr.load_hparams("latest") == {"model": "graph_lam"}

    other = _model(root, seed=1)
    other_opt = make_optimizer(other.parameters(), lr=1e-3)
    assert CheckpointManager(tmp_path / "run").restore("latest", other, other_opt) == 3
    for (name, p), q in zip(model.named_parameters(), other.parameters()):
        assert torch.equal(p, q), name
    want, got = opt.state_dict(), other_opt.state_dict()
    assert want["param_groups"] == got["param_groups"]
    for i, st in want["state"].items():
        for key, t in st.items():
            assert torch.equal(t, got["state"][i][key]), (i, key)
    assert got["state"][0]["step"].dtype == torch.float32


def test_best_and_latest_policy(root, tmp_path):
    model = _model(root)
    opt = make_optimizer(model.parameters(), lr=1e-3)
    mgr = CheckpointManager(tmp_path)
    assert mgr.maybe_save_best(2.0, model, opt, 0)
    assert not mgr.maybe_save_best(3.0, model, opt, 1)
    assert mgr.maybe_save_best(1.5, model, opt, 2)
    best = json.loads((tmp_path / "checkpoints" / "best.json").read_text())
    assert best == {"val_loss": 1.5, "step": 2}
    # a resumed manager keeps the historical best
    again = CheckpointManager(tmp_path)
    assert again.best_val_loss == 1.5
    assert not again.maybe_save_best(1.7, model, opt, 3)
    mgr.save_latest(model, opt, 3)
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == [
        "best.json", "latest", "min_val_loss"]
    with pytest.raises(FileNotFoundError):
        mgr.restore("nosuch", model, opt)


def test_restore_params_only_checks_keys_and_leaves_the_optimizer(root, tmp_path):
    model = _model(root)
    opt = _trained_optimizer(model)
    CheckpointManager(tmp_path).save("latest", model, opt, 1)
    fresh = _model(root, seed=5)
    fresh_opt = make_optimizer(fresh.parameters(), lr=1e-3)
    CheckpointManager(tmp_path).restore_params_only("latest", fresh)
    for p, q in zip(model.parameters(), fresh.parameters()):
        assert torch.equal(p, q)
    assert not fresh_opt.state
    # another architecture: the JAX package's message shape
    deeper = GraphLAM(DummyDatastore(root_path=root, **DS_KW), hidden_dim=HIDDEN,
                      processor_layers=3, device="cpu")
    with pytest.raises(ValueError, match=r"Checkpoint params mismatch: missing "
                       r"\['processor\.module_2\.") as err:
        CheckpointManager(tmp_path).restore_params_only("latest", deeper)
    assert "unexpected []" in str(err.value)


def test_resolve_load_forms(tmp_path):
    run = tmp_path / "run"
    assert resolve_load(run) == (run, "latest")
    assert resolve_load(run / "checkpoints") == (run, "latest")
    assert resolve_load(run / "checkpoints" / "min_val_loss") == (run, "min_val_loss")
    (tmp_path / "latest" / "checkpoints").mkdir(parents=True)
    assert resolve_load(tmp_path / "latest") == (tmp_path / "latest", "latest")


def test_load_optimizer_state_keeps_capturable(root):
    """A state saved by a capturable optimizer, loaded into one that is
    not (and back): each keeps its own setting, the step a float32 tensor
    on the CPU where the optimizer is not capturable."""
    model = _model(root)
    opt = _trained_optimizer(model)
    sd = opt.state_dict()
    for group in sd["param_groups"]:
        group["capturable"] = True
    target = make_optimizer(model.parameters(), lr=1e-3)
    load_optimizer_state(target, sd)
    assert all(not g["capturable"] for g in target.param_groups)
    steps = [st["step"] for st in target.state.values()]
    assert all(s.dtype == torch.float32 and s.device.type == "cpu" for s in steps)
    assert all(float(s) == 2.0 for s in steps)


def _cli_hparams(package, config, runs):
    argv = ["--config_path", str(config), "--epochs", "0", "--hidden_dim", str(HIDDEN),
            "--processor_layers", "2", "--runs_root", str(runs), "--logger_run_name", "h",
            "--val_steps_to_log", "1", "2", "--metrics_watch", "val_rmse",
            "--ar_steps_eval", "2"]
    if package is jax_train_model:
        package.main(argv)
    else:
        package.main(argv, device="cpu")
    return json.loads((runs / "h" / "hparams.json").read_text())


def test_hparams_match_the_jax_cli(root, tmp_path):
    """For the same argv both CLIs record the same ``hparams.json``
    (the logger writes it before the first epoch), and the port rebuilds
    the architecture from the JAX package's."""
    want = _cli_hparams(jax_train_model, root / "config.yaml", tmp_path / "jax")
    got = _cli_hparams(train_model, root / "config.yaml", tmp_path / "torch")
    assert sorted(got) == sorted(want)
    for key in want:
        if key != "runs_root":
            assert got[key] == want[key], key

    ds = DummyDatastore(root_path=root, **DS_KW)
    fc = build_forecaster_from_hparams(want, ds, device="cpu")
    assert isinstance(fc, ARForecaster) and isinstance(fc.predictor, GraphLAM)
    jds = JaxDummyDatastore(root_path=root, **DS_KW)
    jfc = jax_build(want, jds)
    jparams = jfc.init_params(jax.random.PRNGKey(0))
    shapes = {k: tuple(v.shape) for k, v in jax_export(jax.device_get(jparams)).items()}
    assert {k: tuple(v.shape) for k, v in params_to_numpy(fc).items()} == {
        f"predictor.{k}": s for k, s in shapes.items()}


def _lightning_state_dict(root, legacy: bool, numbered: bool):
    """A reference-style state dict made from JAX parameters: Lightning's
    ``forecaster.predictor.`` prefix, optionally the legacy
    ``g2m_gnn.grid_mlp`` name and ``processor.<i>`` numbering."""
    jds = JaxDummyDatastore(root_path=root, **DS_KW)
    jm = JaxGraphLAM(jds, hidden_dim=HIDDEN, processor_layers=2)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(4)))
    sd = {}
    for key, value in jax_export(params).items():
        if legacy and key.startswith("encoding_grid_mlp."):
            key = "g2m_gnn.grid_mlp." + key[len("encoding_grid_mlp."):]
        if numbered and key.startswith("processor.module_"):
            key = "processor." + key[len("processor.module_"):]
        sd["forecaster.predictor." + key] = torch.tensor(np.asarray(value))
    return jm, params, sd


@pytest.mark.parametrize("legacy,numbered", [(False, False), (True, False), (True, True)])
def test_convert_and_export_agree_with_jax(root, legacy, numbered):
    jm, params, sd = _lightning_state_dict(root, legacy, numbered)
    want = jax_export(jax.device_get(jax_convert(sd, jm.init_params(jax.random.PRNGKey(9)))))
    model = _model(root, seed=3)
    converted = convert_state_dict(sd, model.state_dict())
    assert sorted(converted) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(converted[key].numpy(), want[key])
    model.load_state_dict(converted, strict=True)
    got = export_state_dict(model)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_convert_refuses_bad_state_dicts(root):
    _, _, sd = _lightning_state_dict(root, False, False)
    template = _model(root).state_dict()
    bad = dict(sd, **{"forecaster.predictor.grid_embedder.0.weight": torch.zeros(7, 7)})
    with pytest.raises(ValueError, match="Shape mismatch"):
        convert_state_dict(bad, template)
    del sd["forecaster.predictor.output_map.0.weight"]
    with pytest.raises(KeyError):
        convert_state_dict(sd, template)
    kept = convert_state_dict(sd, template, strict=False)
    assert torch.equal(kept["output_map.0.weight"], template["output_map.0.weight"])


def test_convert_checkpoint_main(root, tmp_path):
    """A Lightning ``.ckpt`` file through ``convert_checkpoint.main`` into
    a checkpoint directory that ``load_forecaster_from_checkpoint`` loads
    with the same weights."""
    _, params, sd = _lightning_state_dict(root, True, False)
    ckpt = tmp_path / "ref.ckpt"
    torch.save({"state_dict": sd, "hyper_parameters": {"args": {}}}, ckpt)
    out = tmp_path / "converted"
    convert_checkpoint.main([
        "--ckpt", str(ckpt), "--config_path", str(root / "config.yaml"),
        "--hidden_dim", str(HIDDEN), "--processor_layers", "2", "--out", str(out),
    ], device="cpu")
    ds = DummyDatastore(root_path=root, **DS_KW)
    fc, hparams = load_forecaster_from_checkpoint(out, ds, device="cpu")
    assert hparams["model"] == "graph_lam" and hparams["hidden_dim"] == HIDDEN
    want = jax_export(params)
    got = export_state_dict(fc.predictor)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    # --flat_opt: the optimizer state in one vector, the setting recorded
    flat = tmp_path / "converted_flat"
    convert_checkpoint.main([
        "--ckpt", str(ckpt), "--config_path", str(root / "config.yaml"),
        "--hidden_dim", str(HIDDEN), "--processor_layers", "2", "--out", str(flat),
        "--flat_opt",
    ], device="cpu")
    fc, hparams = load_forecaster_from_checkpoint(flat, ds, device="cpu")
    assert hparams["flat_opt"] is True
    got = export_state_dict(fc.predictor)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    saved = torch.load(flat / "checkpoints" / "latest" / "state.pt", weights_only=True)
    assert saved["optimizer"]["param_groups"][0]["params"] == [0]


def test_optimizer_state_crosses_over(root):
    """Two AdamW steps in JAX, then parameters, moments and step count
    into the port, and three more steps in each: the losses within 1e-5
    relative, the step counts equal."""
    lr = 1e-3
    jds = JaxDummyDatastore(root_path=root, **DS_KW)
    jm = JaxGraphLAM(jds, hidden_dim=HIDDEN, processor_layers=2)
    jt = JaxTrainer(JaxARForecaster(jm, jds), jax_config_from_dict(CONFIG), jds,
                    JaxTrainingArgs(batch_size=2, lr=lr))
    rng = np.random.default_rng(11)
    n, d, f = jds.num_grid_points, 3, 3 * jds.get_num_data_vars("forcing")
    batches = [tuple(rng.normal(size=s).astype(np.float32)
                     for s in ((2, 2, n, d), (2, 1, n, d), (2, 1, n, f)))
               for _ in range(5)]
    step = jt.make_train_step()
    params = jm.init_params(jax.random.PRNGKey(0))
    j_params, opt_state = jt.place_state(
        jax.tree_util.tree_map(jnp.array, params), jt.optimizer.init(params))
    want = []
    for k, batch in enumerate(batches):
        if k == 2:  # carry the state across after two steps
            adam = jax.device_get(opt_state[0])
            carried = jax.device_get(j_params)
        j_params, opt_state, loss = step(j_params, opt_state, *batch)
        want.append(float(loss))

    tds = DummyDatastore(root_path=root, **DS_KW)
    tm = GraphLAM(tds, hidden_dim=HIDDEN, processor_layers=2, device="cpu")
    tm.load_state_dict(params_from_jax(carried), strict=True)
    tt = Trainer(ARForecaster(tm, tds), config_from_dict(CONFIG), tds,
                 TrainingArgs(batch_size=2, lr=lr), device="cpu")
    opt_state_from_jax(adam.mu, adam.nu, adam.count, tt.optimizer, tm)
    assert all(float(st["step"]) == 2.0 for st in tt.optimizer.state.values())
    got = [tt.train_step(*batch).item() for batch in batches[2:]]
    np.testing.assert_allclose(got, want[2:], rtol=1e-5)
    assert all(float(st["step"]) == 5.0 for st in tt.optimizer.state.values())
    # moments after the three steps, against optax's
    adam_end = jax.device_get(opt_state[0])
    names = {id(p): name for name, p in tm.named_parameters()}
    want_mu = params_from_jax(adam_end.mu)
    worst = max(
        float((tt.optimizer.state[p]["exp_avg"] - want_mu[names[id(p)]]).abs().max()
              / max(want_mu[names[id(p)]].abs().max(), 1e-12))
        for p in tm.parameters()
    )
    assert worst < 1e-3, worst
