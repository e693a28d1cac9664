"""The port's MDP zarr datastore and zarr reader against the JAX package's.

Both packages read the same small mllam-data-prep store, written in
``tmp_path`` by ``chip_smoke.write_mdp_store`` (the writer the smoke uses
at MEPS size): every array must be EQUAL, since the port's reader is a
copy of the JAX package's and does no arithmetic of its own. The codecs
are held the same way, on chunks made here: zlib, raw, blosc with lz4
(with and without shuffle, and c-blosc1's raw-block marker), and CF times
with a time zone. The port's arrays are read-only.
"""

import importlib.util
import json
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest

from neural_lam_tpu import native as jax_native
from neural_lam_tpu.dataset import WeatherDataset as JaxWeatherDataset
from neural_lam_tpu.datastore.mdp import MDPDatastore as JaxMDPDatastore
from neural_lam_tpu.utils import minizarr as jax_minizarr
from neural_lam_tpu_torch import native
from neural_lam_tpu_torch.config import load_config_and_datastore
from neural_lam_tpu_torch.dataset import WeatherDataset
from neural_lam_tpu_torch.datastore import DATASTORES
from neural_lam_tpu_torch.datastore.mdp import MDPDatastore
from neural_lam_tpu_torch.utils import minizarr

REPO = Path(__file__).resolve().parent.parent
NX, NY = 9, 8
SPLITS = (10, 6, 6)
N_STATE, N_FORCING, N_STATIC = 3, 2, 2


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def smoke():
    return _load_chip_smoke()


@pytest.fixture(scope="module", params=["y_major", "x_major"])
def stores(request, tmp_path_factory, smoke):
    """The same store read by both packages, stacked each way."""
    root = tmp_path_factory.mktemp(f"mdp_{request.param}")
    smoke.write_mdp_store(
        root, NX, NY, splits=SPLITS, n_state=N_STATE, n_forcing=N_FORCING,
        n_static=N_STATIC, seed=3, x_major=request.param == "x_major",
    )
    cfg = root / "mdp.datastore.yaml"
    return (
        JaxMDPDatastore(cfg, n_boundary_points=2),
        MDPDatastore(cfg, n_boundary_points=2),
    )


def test_metadata_is_equal(stores):
    jds, tds = stores
    assert tds.SHORT_NAME == "mdp" and DATASTORES["mdp"] is MDPDatastore
    assert (tds.is_forecast, tds.is_ensemble) == (jds.is_forecast, jds.is_ensemble)
    assert tds.num_grid_points == jds.num_grid_points == NX * NY
    assert (tds.grid_shape_state.x, tds.grid_shape_state.y) == (NX, NY)
    assert (jds.grid_shape_state.x, jds.grid_shape_state.y) == (NX, NY)
    assert tds._x_major == jds._x_major
    assert tds.step_length == jds.step_length
    for cat in ("state", "forcing", "static"):
        assert tds.get_vars_names(cat) == jds.get_vars_names(cat)
        assert tds.get_vars_units(cat) == jds.get_vars_units(cat)
        assert tds.get_vars_long_names(cat) == jds.get_vars_long_names(cat)
        assert tds.get_num_data_vars(cat) == jds.get_num_data_vars(cat)


@pytest.mark.parametrize("category", ["state", "forcing", "static"])
@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_dataarrays_are_equal_and_read_only(stores, category, split):
    jds, tds = stores
    split = None if category == "static" else split
    for standardize in (False, True):
        want = jds.get_dataarray(category, split=split, standardize=standardize)
        got = tds.get_dataarray(category, split=split, standardize=standardize)
        assert got.dims == want.dims
        np.testing.assert_array_equal(got.data, want.data)
        for name in want.coords:
            np.testing.assert_array_equal(got.get_coord(name), want.get_coord(name))
    raw = tds.get_dataarray(category, split=split)
    assert not raw.data.flags.writeable
    with pytest.raises(ValueError):
        raw.data[...] = 0


def test_standardization_mask_and_xy_are_equal(stores):
    jds, tds = stores
    for cat in ("state", "forcing", "static"):
        want = jds.get_standardization_dataarray(cat)
        got = tds.get_standardization_dataarray(cat)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(tds.boundary_mask.data, jds.boundary_mask.data)
    assert int((tds.boundary_mask.data == 0).sum()) == (NX - 4) * (NY - 4)
    for stacked in (True, False):
        np.testing.assert_array_equal(
            tds.get_xy("state", stacked=stacked), jds.get_xy("state", stacked=stacked)
        )
    field = np.arange(NX * NY, dtype=np.float32)
    np.testing.assert_array_equal(
        tds.unstack_grid_coords(field), jds.unstack_grid_coords(field)
    )
    np.testing.assert_array_equal(
        tds.stack_grid_coords(tds.unstack_grid_coords(field)), field
    )
    np.testing.assert_array_equal(tds.get_xy_extent("state"), jds.get_xy_extent("state"))
    assert all(not tds._read(n).flags.writeable for n in ("state", "x", "time"))


def test_weather_dataset_samples_are_equal(stores):
    """The samples both packages' datasets cut from the store; the port's
    are its own, writable copies."""
    jds, tds = stores
    want = JaxWeatherDataset(jds, split="train", ar_steps=2)
    got = WeatherDataset(tds, split="train", ar_steps=2)
    assert len(got) == len(want) == SPLITS[0] - 4
    for i in (0, len(got) - 1):
        for g, w in zip(got[i], want[i]):
            np.testing.assert_array_equal(g, w)
        assert all(a.flags.writeable for a in got[i])


def test_config_selects_the_mdp_datastore(tmp_path, smoke):
    """``config.yaml`` written as JSON (a YAML document too) selects
    ``mdp`` through the registry, at the datastore's default boundary."""
    cfg = smoke.write_mdp_store(tmp_path, 64, 62, splits=(6, 5, 5), n_state=2,
                                n_forcing=1, n_static=1)
    config, ds = load_config_and_datastore(cfg)
    assert config.datastore.kind == "mdp" and isinstance(ds, MDPDatastore)
    mask = np.asarray(ds.boundary_mask.data)
    assert int((mask == 0).sum()) == (64 - 60) * (62 - 60)


def test_missing_zarr_without_mdp_package(tmp_path):
    cfg = tmp_path / "absent.datastore.yaml"
    cfg.write_text("schema_version: v0.5.0\n", encoding="utf-8")
    with pytest.raises(FileNotFoundError, match="mllam-data-prep"):
        MDPDatastore(cfg)


# -- codecs ---------------------------------------------------------------------


def _lz4_literals(data: bytes) -> bytes:
    """A valid LZ4 block of one all-literal sequence."""
    out = bytearray([min(len(data), 15) << 4])
    if len(data) >= 15:
        rest = len(data) - 15
        while rest >= 255:
            out.append(255)
            rest -= 255
        out.append(rest)
    return bytes(out + data)


def _lz4_with_match(data: bytes) -> bytes:
    """``data`` twice over: literals, then one back-reference to them."""
    n = len(data)
    assert 4 <= n < 15 + 255
    token = (min(n, 15) << 4) | min(n - 4, 15)
    out = bytearray([token])
    if n >= 15:
        out.append(n - 15)
    out += data + struct.pack("<H", n)
    if n - 4 >= 15:
        out.append(n - 4 - 15)
    return bytes(out + bytes([0x00]))  # an empty last literal run


def _blosc_lz4_frame(data: bytes, typesize: int, shuffle: bool, raw_marker: bool) -> bytes:
    """A one-block blosc1 frame, lz4 inner codec (id 1); with ``shuffle``
    the block is byte-shuffled and split into ``typesize`` streams, each
    stored raw with ``csize == neblock`` when ``raw_marker``."""
    flags = (0x1 if shuffle else 0) | (1 << 5)
    block = data
    if shuffle:
        n = len(data) // typesize
        block = np.frombuffer(data, np.uint8).reshape(n, typesize).T.tobytes()
        sub = len(block) // typesize
        streams = b""
        for k in range(typesize):
            part = block[k * sub:(k + 1) * sub]
            comp = part if raw_marker else _lz4_literals(part)
            streams += struct.pack("<i", len(comp)) + comp
    else:
        comp = data if raw_marker else _lz4_literals(data)
        streams = struct.pack("<i", len(comp)) + comp
    header = struct.pack("<BBBBIII", 2, 1, flags, typesize, len(data), len(data),
                         20 + len(streams))
    return header + struct.pack("<i", 20) + streams


def _write_chunked(root: Path, name: str, values: np.ndarray, compressor, encode) -> None:
    adir = root / name
    adir.mkdir(parents=True)
    meta = {"zarr_format": 2, "shape": list(values.shape), "chunks": list(values.shape),
            "dtype": values.dtype.str, "compressor": compressor, "fill_value": None,
            "filters": None, "order": "C"}
    (adir / ".zarray").write_text(json.dumps(meta))
    (adir / ".zattrs").write_text(json.dumps({"_ARRAY_DIMENSIONS": ["a", "b"]}))
    (adir / ".".join("0" * values.ndim)).write_bytes(encode(values.tobytes()))


BLOSC = {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1}
CODECS = {
    "zlib": ({"id": "zlib", "level": 1}, lambda b: zlib.compress(b, 1)),
    "raw": (None, lambda b: b),
    "blosc_lz4": (BLOSC, lambda b: _blosc_lz4_frame(b, 4, False, False)),
    "blosc_lz4_shuffle": (BLOSC, lambda b: _blosc_lz4_frame(b, 4, True, False)),
    "blosc_raw_marker": (BLOSC, lambda b: _blosc_lz4_frame(b, 4, False, True)),
    "blosc_shuffle_raw_marker": (BLOSC, lambda b: _blosc_lz4_frame(b, 4, True, True)),
}


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_codecs_read_equal(tmp_path, codec):
    values = np.random.default_rng(5).normal(size=(6, 10)).astype(np.float32)
    compressor, encode = CODECS[codec]
    _write_chunked(tmp_path, "a", values, compressor, encode)
    got = minizarr.ZarrGroup(tmp_path)["a"].read()
    want = jax_minizarr.ZarrGroup(tmp_path)["a"].read()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, values)
    assert not got.flags.writeable


def test_lz4_decoders_are_equal():
    data = bytes(range(7, 19))
    for src, want in ((_lz4_literals(data * 30), data * 30),
                      (_lz4_with_match(data), data * 2)):
        assert minizarr._lz4_decompress_block_py(src, len(want)) == want
        assert jax_minizarr._lz4_decompress_block_py(src, len(want)) == want


@pytest.mark.parametrize("units", [
    "hours since 1990-09-01 00:00:00 UTC",
    "hours since 1990-09-01T00:00:00Z",
    "minutes since 1990-09-01 06:00:00 +02:00",
    "days since 1990-09-01 00:00:00 -0130",
])
@pytest.mark.parametrize("dtype", ["int64", "float64"])
def test_cf_times_with_time_zones_are_equal(units, dtype):
    values = np.array([0, 3, 6.5 if dtype == "float64" else 9, np.nan if dtype == "float64"
                       else 12], dtype=dtype)
    got = minizarr._decode_cf_time(values, units)
    want = jax_minizarr._decode_cf_time(values, units)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.dtype("datetime64[ns]")


def _fresh_fastcodec(module):
    module._tried = False
    module._cached_mod = None
    return module.get_fastcodec()


def test_native_codec_matches_the_jax_package():
    """The port's C codec (built here when it is not) against the JAX
    package's: its C codec where that is built, else its pure-Python
    decoders, which the JAX package falls back to the same way."""
    import sysconfig

    ours = native.get_fastcodec()
    if ours is None:
        if not Path(sysconfig.get_paths()["include"], "Python.h").exists():
            pytest.skip("no Python.h: the port's native codec cannot be built here")
        from neural_lam_tpu_torch.native.build import build

        build()
        ours = _fresh_fastcodec(native)
    theirs = jax_native.get_fastcodec()
    if theirs is None:
        lz4 = jax_minizarr._lz4_decompress_block_py

        def unshuffle(block, typesize):
            n = len(block) // typesize
            return np.frombuffer(block, np.uint8).reshape(typesize, n).T.tobytes()
    else:
        lz4, unshuffle = theirs.lz4_decompress, theirs.byte_unshuffle
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    for src, n in ((_lz4_literals(data), len(data)),
                   (_lz4_with_match(data[:40]), 80)):
        assert ours.lz4_decompress(src, n) == lz4(src, n)
        assert ours.lz4_decompress(src, n) == minizarr._lz4_decompress_block_py(src, n)
    for typesize in (2, 4, 8):
        block = rng.integers(0, 256, 64 * typesize, dtype=np.uint8).tobytes()
        assert ours.byte_unshuffle(block, typesize) == unshuffle(block, typesize)
    with pytest.raises(ValueError):
        ours.lz4_decompress(bytes([0x10]), 4)
