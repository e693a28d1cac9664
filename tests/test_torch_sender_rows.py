"""K1's and K2's wrappers and the smoke's view of them, on the CPU.

On CPU tensors the wrappers are the plain versions and launch nothing;
a CUDA graph's K1 and K2 nodes are counted by ``chip_smoke.KERNEL_SYMBOLS``
under their own precision; and under ``chip_smoke.py --parent`` each
library getter of the port's wrappers hands out the parent build's entry
of the same name, with the current entry's argument types. The libraries
are stubbed, so these tests need no card and no compiler.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from neural_lam_tpu_torch.ops import fused_kernels as fk
from neural_lam_tpu_torch.ops import kernel_build
from neural_lam_tpu_torch.ops import segment_kernels as sk
from neural_lam_tpu_torch.ops.interaction import make_edge_set

REPO = Path(__file__).resolve().parent.parent
HIDDEN = 64


def _edges(n_send=300, n_edges=5_000):
    rng = np.random.default_rng(0)
    es, _ = make_edge_set(rng.integers(0, n_send, n_edges), rng.integers(0, 200, n_edges),
                          num_rec=200, num_send=n_send)
    return es


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_on_cpu_tensors_launch_nothing(monkeypatch, dtype):
    """On CPU tensors the wrappers are the plain versions; no library is
    loaded."""
    def refuse(*args):
        raise AssertionError("a kernel library was reached on CPU tensors")

    monkeypatch.setattr(sk, "_gather_lib", refuse)
    monkeypatch.setattr(sk, "_scatter_lib", refuse)
    es = _edges()
    x = torch.randn(300, 4, HIDDEN).to(dtype)
    assert torch.equal(sk.sender_gather(x, es.senders), x[es.senders.long()])
    g = torch.randn(5_000, 4, HIDDEN).to(dtype)
    want = torch.zeros(300, 4, HIDDEN).index_add_(0, es.senders.long(), g.float())
    assert torch.equal(sk.sender_scatter(g, es, 300), want)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# each instantiation's kernel, by its mangled name's identifier and
# template arguments, and its counter in chip_smoke.KERNEL_SYMBOLS
K1_K2_SYMBOLS = [
    ("gather_rows_vec4", "IfE", "K1 sender_gather"),
    ("gather_rows_scalar", "IfE", "K1 sender_gather"),
    ("gather_rows_vec4", "I13__nv_bfloat16E", "K1 sender_gather bf16"),
    ("gather_rows_scalar", "I13__nv_bfloat16E", "K1 sender_gather bf16"),
    ("scatter_rows", "I6float4S1_E", "K2 sender_scatter"),
    ("scatter_rows", "IffE", "K2 sender_scatter"),
    ("scatter_rows", "INS_6Bf16x4E6float4E", "K2 sender_scatter bf16"),
    ("scatter_rows", "I13__nv_bfloat16fE", "K2 sender_scatter bf16"),
]


@pytest.mark.parametrize("ident, args, name", K1_K2_SYMBOLS)
def test_kernel_symbols_name_each_k1_and_k2_instantiation(smoke, ident, args, name):
    """A CUDA graph's K1 and K2 nodes count under exactly one of
    ``chip_smoke.KERNEL_SYMBOLS``, their own precision's."""
    symbol = f"_ZN12_GLOBAL__N_1{len(ident)}{ident}{args}EvPKiS3_"
    found = [n for n, pattern in smoke.KERNEL_SYMBOLS.items() if pattern.search(symbol)]
    assert found == [name]


class _Entry:
    """A stand-in for a C entry point of a loaded library."""

    def __init__(self, name, lib):
        self.__name__ = name
        self.lib = lib


class _Lib:
    """A stand-in for a loaded library: any entry point, one object a name."""

    def __init__(self, name):
        self.name = name

    def __getattr__(self, symbol):
        if symbol.startswith("__"):
            raise AttributeError(symbol)
        entry = _Entry(symbol, self.name)
        setattr(self, symbol, entry)
        return entry


# every library getter the parent stands in for, with its arguments
GETTERS = [(sk, "_gather_lib", ("nl_sender_gather",)),
           (sk, "_gather_lib", ("nl_sender_gather_bf16",)),
           (sk, "_scatter_lib", ("nl_sender_scatter",)),
           (sk, "_scatter_lib", ("nl_sender_scatter_bf16",))] + [
    (fk, getter, ()) for getter in (
        "_fwd_lib", "_fwd_bf16_lib", "_bwd_lib", "_bwd_bf16_lib", "_bwd_recompute_lib",
        "_v2_fwd_lib", "_v2_fwd_bf16_lib", "_v2_bwd_lib", "_v2_bwd_bf16_lib")]


@pytest.fixture
def stubbed_libs(monkeypatch):
    """The current build's libraries and the parent's, stubbed: the getters'
    caches are emptied before and after, so no stub outlives the test."""
    current = {}
    monkeypatch.setattr(kernel_build, "load",
                        lambda name: current.setdefault(name, _Lib(f"current {name}")))
    getters = {getattr(module, name) for module, name, _ in GETTERS}
    for getter in getters:
        getter.cache_clear()
    yield
    for getter in getters:
        getter.cache_clear()


@pytest.mark.parametrize("module, getter, args", GETTERS,
                         ids=[f"{g}{a}" for _, g, a in GETTERS])
def test_parent_stands_in_through_the_current_entries(smoke, monkeypatch, stubbed_libs,
                                                       module, getter, args):
    """Under ``parent["use"]()`` a getter returns the parent library's
    entry of the current entry's name, with the current entry's argument
    types; the current entry again after it."""
    import ctypes

    monkeypatch.setattr(ctypes, "CDLL", lambda path: _Lib(f"parent {Path(path).stem}"))
    sources = {**smoke.PARENT_ROW_SOURCES, **smoke.PARENT_SOURCES}
    procs = [(name, Path(f"parent-{name}.so"), None) for name in sorted(set(sources.values()))]
    parent = smoke.parent_kernels(torch, procs, Path("parent"))
    current = getattr(module, getter)(*args)
    assert current.lib == f"current {sources[getter]}"
    with parent["use"]():
        fn = getattr(module, getter)(*args)
        assert fn.lib == f"parent parent-{sources[getter]}"
        assert fn.__name__ == current.__name__
        assert fn.argtypes == current.argtypes and fn.restype is ctypes.c_int
    assert getattr(module, getter)(*args) is current
