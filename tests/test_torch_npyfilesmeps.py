"""The port's MEPS npy-file datastore against the JAX package's.

``tests/test_npyfilesmeps.py`` on ``neural_lam_tpu_torch``: the same
synthetic store (the same files, written once from a numpy seed) read by
both packages' ``NpyFilesDatastoreMEPS``. Each test makes the JAX test's
assertions on the port and requires the two packages' arrays to be equal:
both read the same float32 files with the same numpy operations, so the
tolerance is exact equality (``assert_array_equal``) throughout, the
statistics included (float64 sums of the same values in the same order).
"""

from datetime import datetime, timedelta

import numpy as np
import pytest
import yaml

from neural_lam_tpu.dataset import WeatherDataset as JaxWeatherDataset
from neural_lam_tpu.datastore.npyfilesmeps import NpyFilesDatastoreMEPS as JaxStore
from neural_lam_tpu.datastore.npyfilesmeps.compute_standardization_stats import (
    compute_stats as jax_compute_stats,
)
from neural_lam_tpu.datastore.npyfilesmeps.config import (
    NpyDatastoreConfig as JaxConfig,
)
from neural_lam_tpu_torch.dataset import WeatherDataset
from neural_lam_tpu_torch.datastore import DATASTORES, init_datastore
from neural_lam_tpu_torch.datastore.npyfilesmeps import NpyFilesDatastoreMEPS
from neural_lam_tpu_torch.datastore.npyfilesmeps.compute_standardization_stats import (
    _RunningMoments,
    compute_stats,
    main as stats_main,
    merge_moments,
    save_stats,
)
from neural_lam_tpu_torch.datastore.npyfilesmeps.config import NpyDatastoreConfig

NY, NX = 5, 4  # grid_shape_state is [ny, nx]
N_GRID = NX * NY
T = 7  # forecast steps per analysis time
N_STATE_TOTAL = 4  # before feature removal
DROP_IDX = [1]
N_STATE = N_STATE_TOTAL - len(DROP_IDX)
N_MEMBERS = 2
ANALYSIS_TIMES = [
    datetime(2022, 4, 1, 0),
    datetime(2022, 4, 1, 12),
    datetime(2022, 4, 2, 0),
]


def write_meps_store(root, seed: int = 0, analysis_times=ANALYSIS_TIMES, t=T):
    """The JAX test's miniature MEPS store under ``root`` (its
    ``meps_root`` fixture, from the same seed)."""
    rng = np.random.default_rng(seed)
    for split in ("train", "val", "test"):
        samples = root / "samples" / split
        samples.mkdir(parents=True)
        for at in analysis_times:
            tstr = at.strftime("%Y%m%d%H")
            for member in range(N_MEMBERS):
                np.save(
                    samples / f"nwp_{tstr}_mbr{member:03d}.npy",
                    rng.normal(size=(t, NY, NX, N_STATE_TOTAL)).astype(np.float32),
                )
            np.save(
                samples / f"nwp_toa_downwelling_shortwave_flux_{tstr}.npy",
                rng.uniform(0, 500, size=(t, NY, NX)).astype(np.float32),
            )
            np.save(samples / f"wtr_{tstr}.npy",
                    rng.uniform(0, 1, size=(NY, NX)).astype(np.float32))
    static = root / "static"
    static.mkdir()
    x = np.arange(NX, dtype=np.float32) * 1000
    y = np.arange(NY, dtype=np.float32) * 1000
    np.save(static / "nwp_xy.npy", np.stack(np.meshgrid(x, y, indexing="xy"), axis=0))
    np.save(static / "surface_geopotential.npy", rng.normal(size=(NY, NX)).astype(np.float32))
    border = np.zeros((NY, NX), dtype=np.float32)
    border[0, :] = border[-1, :] = border[:, 0] = border[:, -1] = 1
    np.save(static / "border_mask.npy", border)
    np.save(static / "parameter_mean.npy", np.zeros(N_STATE, np.float32))
    np.save(static / "parameter_std.npy", np.ones(N_STATE, np.float32))
    np.save(static / "diff_mean.npy", np.zeros(N_STATE, np.float32))
    np.save(static / "diff_std.npy", np.ones(N_STATE, np.float32))
    np.save(static / "flux_stats.npy", np.array([250.0, 100.0], np.float32))
    config = {
        "dataset": {
            "name": "meps_tiny",
            "var_names": [f"var{i}" for i in range(N_STATE)],
            "var_units": ["unit"] * N_STATE,
            "var_longnames": [f"variable {i}" for i in range(N_STATE)],
            "num_forcing_features": 1,
            "num_timesteps": t,
            "step_length": 3,
            "num_ensemble_members": N_MEMBERS,
            "remove_state_features_with_index": DROP_IDX,
        },
        "grid_shape_state": [NY, NX],
        "projection": {"class_name": "LambertConformal",
                       "kwargs": {"central_longitude": 15.0}},
    }
    (root / "data_config.yaml").write_text(yaml.safe_dump(config), encoding="utf-8")
    return root


@pytest.fixture(scope="module")
def meps_root(tmp_path_factory):
    return write_meps_store(tmp_path_factory.mktemp("torch_meps"))


@pytest.fixture(scope="module")
def stores(meps_root):
    """The port's store and the JAX package's, over the same files."""
    cfg = meps_root / "data_config.yaml"
    return NpyFilesDatastoreMEPS(config_path=cfg), JaxStore(config_path=cfg)


def test_metadata(stores):
    store, jax_store = stores
    assert DATASTORES["npyfilesmeps"] is NpyFilesDatastoreMEPS
    assert store.is_forecast and store.is_ensemble
    assert store.num_grid_points == N_GRID
    assert store.get_num_data_vars("state") == N_STATE
    assert store.get_num_data_vars("forcing") == 6
    assert store.get_num_data_vars("static") == 4
    assert store.step_length == timedelta(hours=3)
    for cat in ("state", "forcing", "static"):
        assert store.get_vars_names(cat) == jax_store.get_vars_names(cat)
        assert store.get_vars_units(cat) == jax_store.get_vars_units(cat)
    shape, jax_shape = store.grid_shape_state, jax_store.grid_shape_state
    assert (shape.x, shape.y) == (jax_shape.x, jax_shape.y) == (NX, NY)


def test_state_dataarray_lazy_and_masked(stores):
    store, jax_store = stores
    da = store.get_dataarray(category="state", split="train")
    assert da.dims == (
        "analysis_time", "elapsed_forecast_duration", "ensemble_member",
        "grid_index", "state_feature",
    )
    assert da.shape == (len(ANALYSIS_TIMES), T, N_MEMBERS, N_GRID, N_STATE)
    item = da.data[1]
    tstr = ANALYSIS_TIMES[1].strftime("%Y%m%d%H")
    raw = np.load(store.root_path / "samples" / "train" / f"nwp_{tstr}_mbr000.npy")
    keep = [i for i in range(N_STATE_TOTAL) if i not in DROP_IDX]
    expected = raw[..., keep].transpose(0, 2, 1, 3).reshape(T, N_GRID, N_STATE)
    np.testing.assert_array_equal(item[:, 0], expected)
    want = jax_store.get_dataarray(category="state", split="train")
    np.testing.assert_array_equal(np.asarray(da.data), np.asarray(want.data))
    for dim in da.dims:
        np.testing.assert_array_equal(da.get_coord(dim), want.get_coord(dim))


def test_forcing_features(stores):
    store, jax_store = stores
    da = store.get_dataarray(category="forcing", split="val")
    assert da.shape == (len(ANALYSIS_TIMES), T, N_GRID, 6)
    item = np.asarray(da.data[0])
    assert item[..., 2:].min() >= 0 and item[..., 2:].max() <= 1
    assert np.allclose(item[:, 0, 2:], item[:, -1, 2:])
    np.testing.assert_allclose(item[0, 0, 2], 0.5, atol=1e-6)
    np.testing.assert_allclose(item[0, :, 1], item[-1, :, 1])
    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(
            np.asarray(store.get_dataarray("forcing", split).data),
            np.asarray(jax_store.get_dataarray("forcing", split).data),
        )


def test_static_and_boundary(stores):
    store, jax_store = stores
    da = store.get_dataarray(category="static", split=None)
    assert da.shape == (N_GRID, 4)
    mask = store.boundary_mask
    assert mask.data.shape == (N_GRID,)
    assert mask.data.sum() == 2 * NX + 2 * NY - 4
    xy = store.get_xy("state", stacked=True)
    assert xy.shape == (N_GRID, 2)
    assert np.allclose(xy[:NY, 0], xy[0, 0])
    np.testing.assert_array_equal(
        np.asarray(da.data), np.asarray(jax_store.get_dataarray("static", None).data))
    np.testing.assert_array_equal(mask.data, jax_store.boundary_mask.data)
    np.testing.assert_array_equal(xy, jax_store.get_xy("state", stacked=True))
    assert store.get_xy_extent("state") == jax_store.get_xy_extent("state")


def test_stats_roundtrip(stores):
    store, jax_store = stores
    for cat in ("state", "forcing", "static"):
        got = store.get_standardization_dataarray(cat)
        want = jax_store.get_standardization_dataarray(cat)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    stats = store.get_standardization_dataarray("state")
    assert stats["state_mean"].shape == (N_STATE,)
    f_stats = store.get_standardization_dataarray("forcing")
    np.testing.assert_allclose(f_stats["forcing_mean"][0], 250.0)
    np.testing.assert_allclose(f_stats["forcing_std"][1:], 1.0)


def test_legacy_pt_stats_are_read(tmp_path):
    """Stats saved under the legacy ``.pt`` names (torch tensors) are read
    as the ``.npy`` ones are, in both packages."""
    import torch

    root = write_meps_store(tmp_path / "store", analysis_times=ANALYSIS_TIMES[:1])
    for stem in ("parameter_mean", "parameter_std", "diff_mean", "diff_std", "flux_stats"):
        path = root / "static" / f"{stem}.npy"
        torch.save(torch.from_numpy(np.load(path) + 0.5), root / "static" / f"{stem}.pt")
        path.unlink()
    cfg = root / "data_config.yaml"
    got = NpyFilesDatastoreMEPS(cfg).get_standardization_dataarray("state")
    want = JaxStore(cfg).get_standardization_dataarray("state")
    np.testing.assert_array_equal(got["state_mean"], np.full(N_STATE, 0.5, np.float32))
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_weather_dataset_on_meps(stores):
    store, jax_store = stores
    dataset = WeatherDataset(store, split="train", ar_steps=2)
    jax_dataset = JaxWeatherDataset(jax_store, split="train", ar_steps=2)
    assert len(dataset) == len(jax_dataset) == len(ANALYSIS_TIMES) * N_MEMBERS
    init, target, forcing, times = dataset[1]
    assert init.shape == (2, N_GRID, N_STATE)
    assert target.shape == (2, N_GRID, N_STATE)
    assert forcing.shape == (2, N_GRID, 6 * 3)
    assert times.shape == (2,)
    # ensemble index mapping: idx 1 -> analysis 0, member 1
    da = store.get_dataarray("state", split="train")
    np.testing.assert_array_equal(target, np.asarray(da.data[0])[2:4, 1])
    for i in range(len(dataset)):
        for got, want in zip(dataset[i], jax_dataset[i]):
            np.testing.assert_array_equal(got, want)


def test_compute_standardization_stats(meps_root, tmp_path):
    cfg = meps_root / "data_config.yaml"
    store = NpyFilesDatastoreMEPS(config_path=cfg)
    stats = compute_stats(store, num_workers=2)
    want = jax_compute_stats(JaxStore(config_path=cfg))
    assert sorted(stats) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(stats[key], want[key])
    assert stats["parameter_mean"].shape == (N_STATE,)
    assert np.all(np.abs(stats["parameter_mean"]) < 0.1)
    assert np.all(np.abs(stats["parameter_std"] - 1.0) < 0.1)
    # saved into a copy of the store, and read back through it
    copy = write_meps_store(tmp_path / "copy")
    save_stats(copy / "static", stats)
    reloaded = NpyFilesDatastoreMEPS(copy / "data_config.yaml")
    np.testing.assert_array_equal(
        reloaded.get_standardization_dataarray("state")["state_mean"], stats["parameter_mean"])
    # the CLI writes the same files; --multihost waits for data parallelism
    stats_main(["--datastore_config_path", str(copy / "data_config.yaml")])
    for key in want:
        np.testing.assert_array_equal(np.load(copy / "static" / f"{key}.npy"), want[key])
    with pytest.raises(SystemExit, match="§1 item 8"):
        stats_main(["--datastore_config_path", str(copy / "data_config.yaml"),
                    "--multihost"])


def test_sharded_stats_merge_exact(stores):
    """Strided analysis-time shards merged with ``merge_moments`` give the
    single pass's statistics (float64 sums: equal within float64
    rounding of a reordered sum, 1e-12 relative); each shard equals the
    JAX package's shard exactly."""
    store, jax_store = stores
    full = compute_stats(store)
    da = store.get_dataarray(category="state", split="train")
    parts = []
    for shard in range(2):
        part = _RunningMoments(N_STATE)
        for i in range(shard, da.shape[0], 2):
            part.update(np.asarray(da.data[i]))
        parts.append(part)
    mean, std = merge_moments(parts).finalize()
    np.testing.assert_allclose(mean, full["parameter_mean"], rtol=1e-6)
    np.testing.assert_allclose(std, full["parameter_std"], rtol=1e-6)
    single = _RunningMoments(N_STATE)
    for i in range(da.shape[0]):
        single.update(np.asarray(da.data[i]))
    merged = merge_moments(parts)
    assert merged.count == single.count
    np.testing.assert_allclose(merged.sum, single.sum, rtol=1e-12)
    np.testing.assert_allclose(merged.sumsq, single.sumsq, rtol=1e-12)
    for shard in range(2):
        got = compute_stats(store, shard_index=shard, num_shards=2)
        want = jax_compute_stats(jax_store, shard_index=shard, num_shards=2)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


def test_lazy_member_selection(stores):
    """isel(ensemble_member=m) reads only that member's file."""
    store, _ = stores
    da = store.get_dataarray(category="state", split="train")
    eager = np.asarray(store.get_dataarray(category="state", split="train").data)
    calls = []
    orig = store._load_state_file

    def counting(split, atime, member, t_key=slice(None)):
        calls.append(member)
        return orig(split, atime, member, t_key=t_key)

    store._load_state_file = counting
    try:
        sub = da.isel(ensemble_member=1)
        assert calls == []  # still lazy
        one = sub.isel(analysis_time=2, elapsed_forecast_duration=slice(0, 3))
        vals = np.asarray(one.data)
        assert vals.shape == (3, N_GRID, N_STATE)
        assert calls == [1]
        np.testing.assert_array_equal(vals, eager[2, :3, 1])
    finally:
        store._load_state_file = orig


def test_step_length_iso8601_parsing(meps_root, tmp_path):
    base = yaml.safe_load((meps_root / "data_config.yaml").read_text(encoding="utf-8"))

    def parse(step_length, cls):
        cfg = dict(base)
        cfg["dataset"] = dict(base["dataset"], step_length=step_length)
        p = tmp_path / "cfg.yaml"
        p.write_text(yaml.safe_dump(cfg), encoding="utf-8")
        return cls.from_yaml_file(p).dataset.step_length

    for value, want in ((3, timedelta(hours=3)), ("PT3H", timedelta(hours=3)),
                        ("PT30M", timedelta(minutes=30)),
                        ("PT1H30M", timedelta(hours=1, minutes=30)),
                        ("P1DT6H", timedelta(days=1, hours=6))):
        assert parse(value, NpyDatastoreConfig) == parse(value, JaxConfig) == want
    for bad in ("PTXH", "P"):
        with pytest.raises(ValueError):
            parse(bad, NpyDatastoreConfig)


def test_ensemble_pushdown_indexer_semantics(stores):
    """Member pushdown follows numpy: boolean masks by position, negative
    ints from the end, out-of-range ints raise; as in the JAX package."""
    store, jax_store = stores
    da = store.get_dataarray(category="state", split="train")
    jda = jax_store.get_dataarray(category="state", split="train")
    eager = np.asarray(da.data)
    m = eager.shape[2]
    mask = np.zeros(m, bool)
    mask[m - 1] = True
    got = np.asarray(da.isel(ensemble_member=mask).isel(analysis_time=1).data)
    np.testing.assert_array_equal(got, eager[1][:, [m - 1]])
    np.testing.assert_array_equal(
        got, np.asarray(jda.isel(ensemble_member=mask).isel(analysis_time=1).data))
    got = np.asarray(da.isel(ensemble_member=-1, analysis_time=0).data)
    np.testing.assert_array_equal(got, eager[0][:, m - 1])
    with pytest.raises(IndexError):
        np.asarray(da.isel(ensemble_member=m, analysis_time=0).data)


def test_time_pushdown_slices_before_copy(stores):
    """The forecast-step window reaches ``_load_state_file`` as ``t_key``
    (the memmap sliced before the grid reshape copies)."""
    store, _ = stores
    da = store.get_dataarray(category="state", split="train")
    eager = np.asarray(da.data)
    seen = []
    orig = store._load_state_file

    def spy(split, atime, member, t_key=slice(None)):
        seen.append(t_key)
        return orig(split, atime, member, t_key=t_key)

    store._load_state_file = spy
    try:
        got = np.asarray(da.isel(analysis_time=0, elapsed_forecast_duration=slice(1, 4),
                                 ensemble_member=0).data)
    finally:
        store._load_state_file = orig
    np.testing.assert_array_equal(got, eager[0, 1:4, 0])
    assert seen and seen[-1] == slice(1, 4)


def test_init_datastore_builds_the_npyfilesmeps_store(meps_root):
    store = init_datastore("npyfilesmeps", meps_root / "data_config.yaml")
    assert isinstance(store, NpyFilesDatastoreMEPS)
    assert store.num_grid_points == N_GRID
