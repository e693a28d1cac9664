"""The port's graph tools against the JAX package's: ``validate_graph``,
``convert_graph``, ``plot_graph`` and ``datastore/plot_example``.

``tests/test_validate_graph.py``, ``tests/test_convert_graph.py`` and the
``plot_graph`` / ``plot_example`` cases of ``tests/test_plotting.py`` on
``neural_lam_tpu_torch``, each tool's output held to the JAX tool's on the
same input: the same list of violations, the same converted arrays and
``metainfo.yaml``, the same plotted points and segments. All are numpy on
the host, so every comparison is exact equality.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from neural_lam_tpu.convert_graph import convert_reference_graph as jax_convert
from neural_lam_tpu.datastore.dummy import DummyDatastore as JaxDummy
from neural_lam_tpu.graphs import create_graph_from_datastore as jax_create_graph
from neural_lam_tpu.datastore.plot_example import (
    plot_example_from_datastore as jax_plot_example,
)
from neural_lam_tpu.plot_graph import plot_graph as jax_plot_graph
from neural_lam_tpu.validate_graph import validate_graph_directory as jax_validate
from neural_lam_tpu_torch import plot_graph as plot_graph_module
from neural_lam_tpu_torch.convert_graph import convert_reference_graph
from neural_lam_tpu_torch.convert_graph import main as convert_main
from neural_lam_tpu_torch.datastore import plot_example
from neural_lam_tpu_torch.datastore.dummy import DummyDatastore
from neural_lam_tpu_torch.graphs import create_graph_from_datastore
from neural_lam_tpu_torch.graphs.load import load_graph
from neural_lam_tpu_torch.models import GraphLAM, HiLAM
from neural_lam_tpu_torch.validate_graph import main, validate_graph_directory
from test_convert_graph import _raw_graph, _write_reference_dir

# -- validate_graph (tests/test_validate_graph.py) -----------------------------------


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_vg")
    ds = DummyDatastore(n_grid_x=30, n_grid_y=30, root_path=root)
    dirs = {}
    for name, hier in (("multiscale", False), ("hierarchical", True)):
        dirs[name] = ds.root_path / "graph" / name
        create_graph_from_datastore(ds, dirs[name], hierarchical=hier)
    return ds, dirs


def _same_errors(graph_dir, num_grid_nodes=None) -> list[str]:
    errors = validate_graph_directory(graph_dir, num_grid_nodes=num_grid_nodes)
    assert errors == jax_validate(graph_dir, num_grid_nodes=num_grid_nodes)
    return errors


@pytest.mark.parametrize("name", ["multiscale", "hierarchical"])
def test_valid_graphs_pass(graphs, name, capsys):
    ds, dirs = graphs
    assert _same_errors(dirs[name], ds.num_grid_points) == []
    assert main([str(dirs[name]), "--num_grid_nodes", "900"]) == 0
    assert capsys.readouterr().out.startswith("OK: ")


def _copy_graph(src, dst):
    dst.mkdir(parents=True)
    for f in src.iterdir():
        (dst / f.name).write_bytes(f.read_bytes())


def _rewrite_npz(graph_dir, mutate):
    with np.load(graph_dir / "graph.npz") as data:
        arrays = {k: data[k] for k in data.files}
    mutate(arrays)
    np.savez_compressed(graph_dir / "graph.npz", **arrays)


def test_detects_out_of_range_indices(graphs, tmp_path):
    _, dirs = graphs
    bad = tmp_path / "bad1"
    _copy_graph(dirs["multiscale"], bad)

    def mutate(arrays):
        arrays["g2m_receivers"] = arrays["g2m_receivers"].copy()
        arrays["g2m_receivers"][0] = 10**6

    _rewrite_npz(bad, mutate)
    assert any("out of range" in e for e in _same_errors(bad, 900))


def test_detects_wrong_dtype_and_length_column(graphs, tmp_path):
    _, dirs = graphs
    bad = tmp_path / "bad2"
    _copy_graph(dirs["multiscale"], bad)

    def mutate(arrays):
        arrays["m2g_senders"] = arrays["m2g_senders"].astype(np.int64)
        feats = arrays["g2m_features"].copy()
        feats[:, 0] = 1e9
        arrays["g2m_features"] = feats

    _rewrite_npz(bad, mutate)
    errors = _same_errors(bad, 900)
    assert any("dtype" in e for e in errors)
    assert any("edge length" in e for e in errors)


def test_detects_broken_mirror_and_bad_meta(graphs, tmp_path):
    _, dirs = graphs
    bad = tmp_path / "bad3"
    _copy_graph(dirs["hierarchical"], bad)

    def mutate(arrays):
        arrays["mesh_down__0_senders"] = arrays["mesh_down__0_senders"][::-1].copy()

    _rewrite_npz(bad, mutate)
    assert any("mirror" in e for e in _same_errors(bad))
    meta = yaml.safe_load((bad / "metainfo.yaml").read_text())
    meta["spec_version"] = "bogus"
    (bad / "metainfo.yaml").write_text(yaml.safe_dump(meta))
    assert any("spec_version" in e for e in _same_errors(bad))


def test_detects_missing_files(tmp_path, capsys):
    empty = tmp_path / "empty"
    empty.mkdir()
    assert len(_same_errors(empty)) == 2
    assert main([str(empty)]) == 1
    assert capsys.readouterr().out.count("INVALID: ") == 2


# -- convert_graph (tests/test_convert_graph.py) -------------------------------------


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    store = DummyDatastore(n_grid_x=27, n_grid_y=27, n_timesteps=10,
                           root_path=tmp_path_factory.mktemp("torch_convgraph_ds"))
    for name in ("multiscale", "hierarchical"):
        create_graph_from_datastore(store, store.root_path / "graph" / name,
                                    hierarchical=name == "hierarchical")
    return store


def _convert_both(ref_dir: Path, tmp_path: Path) -> Path:
    """Convert with both packages; the same ``graph.npz`` arrays and
    ``metainfo.yaml``. Returns the port's output directory."""
    out, jax_out = tmp_path / "converted", tmp_path / "converted_jax"
    convert_reference_graph(ref_dir, out)
    jax_convert(ref_dir, jax_out)
    with np.load(out / "graph.npz") as got, np.load(jax_out / "graph.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key])
    assert (yaml.safe_load((out / "metainfo.yaml").read_text())
            == yaml.safe_load((jax_out / "metainfo.yaml").read_text()))
    return out


@pytest.mark.parametrize("graph_name", ["multiscale", "hierarchical"])
def test_convert_spec_graph_identical(ds, graph_name, tmp_path):
    """spec-0.1.0 conversion is a lossless round trip."""
    arrays, meta = _raw_graph(ds, graph_name)
    ref_dir = tmp_path / "ref"
    _write_reference_dir(ref_dir, arrays, meta["n_levels"], "0.1.0", mesh_first=True)
    out_dir = _convert_both(ref_dir, tmp_path)
    hier_a, ga = load_graph(ds.root_path / "graph" / graph_name, mesh_node_features_scaling=3.0)
    hier_b, gb = load_graph(out_dir, mesh_node_features_scaling=3.0)
    assert hier_a == hier_b
    for key in ga:
        a, b = ga[key], gb[key]
        for x, y in zip(a, b) if isinstance(a, list) else [(a, b)]:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("mesh_first", [True, False])
def test_convert_legacy_offsets(ds, mesh_first, tmp_path, capsys):
    """Legacy combined-offset directories convert with the reference's
    zero-index fix-ups, through the CLI too; the loader skips normalizing
    the pre-normalized mesh coordinates."""
    arrays, meta = _raw_graph(ds, "hierarchical")
    ref_dir = tmp_path / "ref_legacy"
    _write_reference_dir(ref_dir, arrays, meta["n_levels"], "legacy", mesh_first=mesh_first)
    out_dir = _convert_both(ref_dir, tmp_path)
    meta_out = yaml.safe_load((out_dir / "metainfo.yaml").read_text(encoding="utf-8"))
    assert meta_out["mesh_features_prenormalized"] is True
    _, ga = load_graph(ds.root_path / "graph" / "hierarchical", mesh_node_features_scaling=1.0)
    _, gb = load_graph(out_dir, mesh_node_features_scaling=1.0)
    for key in ("g2m_edge_index", "m2g_edge_index"):
        np.testing.assert_array_equal(ga[key], gb[key])
    for a, b in zip(ga["m2m_edge_index"], gb["m2m_edge_index"]):
        np.testing.assert_array_equal(a, b)
    convert_main([str(ref_dir), str(tmp_path / "by_cli")])
    assert f"converted hierarchical graph ({meta['n_levels']} levels)" in capsys.readouterr().out
    with np.load(tmp_path / "by_cli" / "graph.npz") as a, np.load(out_dir / "graph.npz") as b:
        for key in b.files:
            np.testing.assert_array_equal(a[key], b[key])


def test_converted_graph_drives_models(ds, tmp_path):
    """A converted reference graph drives the port's models, which step
    exactly as on the graph it was written from."""
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    n = ds.num_grid_points
    state = torch.from_numpy(rng.normal(size=(n, 1, 3)).astype(np.float32))
    forcing = torch.from_numpy(rng.normal(size=(n, 1, 6)).astype(np.float32))
    for graph_name, cls in (("multiscale", GraphLAM), ("hierarchical", HiLAM)):
        arrays, meta = _raw_graph(ds, graph_name)
        ref_dir = tmp_path / f"ref_{graph_name}"
        _write_reference_dir(ref_dir, arrays, meta["n_levels"], "0.1.0", mesh_first=True)
        convert_reference_graph(ref_dir, ds.root_path / "graph" / f"{graph_name}_converted")
        kw = dict(hidden_dim=8, processor_layers=1, device="cpu")
        model = cls(ds, graph_name=f"{graph_name}_converted", **kw)
        original = cls(ds, graph_name=graph_name, **kw)
        original.load_state_dict(model.state_dict())
        with torch.no_grad():
            out, _ = model.step(state, state, forcing)
            want, _ = original.step(state, state, forcing)
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out, want, rtol=0, atol=0)


# -- plot_graph and plot_example (tests/test_plotting.py) ------------------------------


def _figure_data(fig) -> list[np.ndarray]:
    """What a figure plots: every collection's offsets and segments."""
    out = []
    for ax in fig.axes:
        for col in ax.collections:
            if hasattr(col, "_offsets3d"):
                out += [np.asarray(a, np.float64) for a in col._offsets3d]
            if hasattr(col, "_segments3d"):
                out.append(np.asarray(col._segments3d, np.float64))
            if hasattr(col, "get_array") and col.get_array() is not None:
                out.append(np.asarray(col.get_array(), np.float64))
    return out


@pytest.mark.parametrize("hierarchical", [False, True])
def test_plot_graph(tmp_path, hierarchical):
    pytest.importorskip("matplotlib")
    ds = DummyDatastore(n_grid_x=30, n_grid_y=30, root_path=tmp_path / "torch")
    jax_ds = JaxDummy(n_grid_x=30, n_grid_y=30, root_path=tmp_path / "jax")
    name = "hier" if hierarchical else "flat"
    create_graph_from_datastore(ds, ds.root_path / "graph" / name, hierarchical=hierarchical)
    jax_create_graph(jax_ds, jax_ds.root_path / "graph" / name, hierarchical=hierarchical)
    fig = plot_graph_module.plot_graph(ds, name, show_grid_edges=True)
    fig.savefig(tmp_path / "graph.png", dpi=50)
    assert (tmp_path / "graph.png").exists()
    want = jax_plot_graph(jax_ds, name, show_grid_edges=True)
    got, expected = _figure_data(fig), _figure_data(want)
    assert len(got) == len(expected) > 0
    for a, b in zip(got, expected):
        np.testing.assert_array_equal(a, b)
    import matplotlib.pyplot as plt

    plt.close(fig)
    plt.close(want)


def test_plot_example_from_datastore(tmp_path):
    pytest.importorskip("matplotlib")
    ds = DummyDatastore(n_grid_x=12, n_grid_y=12, root_path=tmp_path / "torch")
    jax_ds = JaxDummy(n_grid_x=12, n_grid_y=12, root_path=tmp_path / "jax")
    fig = plot_example.plot_example_from_datastore("state", ds, n_examples=2)
    want = jax_plot_example("state", jax_ds, n_examples=2)
    got, expected = _figure_data(fig), _figure_data(want)
    assert len(fig.axes) == len(want.axes) and len(got) == len(expected) > 0
    for a, b in zip(got, expected):
        np.testing.assert_array_equal(a, b)
    import matplotlib.pyplot as plt

    plt.close(fig)
    plt.close(want)


@pytest.mark.parametrize("tool", ["plot_graph", "plot_example"])
def test_plot_tools_stop_without_matplotlib(tmp_path, monkeypatch, tool):
    """Where matplotlib is not installed, each tool's ``main`` stops with
    one message naming it, before reading anything."""
    import builtins

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError("No module named 'matplotlib'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    entry = plot_graph_module.main if tool == "plot_graph" else plot_example.main
    with pytest.raises(SystemExit, match=f"{tool} draws with matplotlib"):
        entry(["--config_path", str(tmp_path / "absent.yaml")])
