"""How the wrappers of K3, K4, K7 and K8 size their launches and report
their launch resources, on the CPU.

K4's main kernel and the edge pass run 3 groups of warps per block, K8's
main kernel 3 (4 with bf16 operands), the rows pass and K4's receiver
slice 4, and the wrappers size the grids and the workspaces to the work.
K3's, K4's, K7's and K8's libraries report the launch resources of each
instantiation through one C entry each. These tests stub the SM count and
the libraries' C entry points, so they need no card and no compiler; the
wrappers' group counts must mirror the constants of the CUDA sources,
which they read.
"""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from neural_lam_tpu_torch.ops import fused_kernels as fk
from neural_lam_tpu_torch.ops import kernel_build

CSRC = Path(fk.__file__).resolve().parent.parent / "csrc"

SMS = 132
SIZES = [
    (6_561, 100_656, 4),  # g2m
    (63_784, 255_136, 4),  # m2g
    (6_561, 57_616, 1),
    (9, 40, 32),  # the top level of a hierarchy
    (1, 1, 3),
]


@pytest.fixture
def sms(monkeypatch):
    monkeypatch.setattr(fk, "_sm_count", lambda index: SMS)
    return torch.device("cuda", 0)  # a device object only: nothing runs on it


def _constant(source: str, name: str) -> int:
    text = (CSRC / source).read_text(encoding="utf-8")
    found = re.search(rf"constexpr int {name} = (\d+);", text)
    assert found, f"{name} not in csrc/{source}"
    return int(found.group(1))


def test_group_counts_mirror_the_cuda_sources():
    """K4's main kernel runs ``kGroups`` groups a block in every precision
    (``csrc/fused_edge_bwd_main.cuh``); K8's main kernel the same without
    bf16 operands and ``kGroupsBf`` with them (``csrc/fused_edge_v2_bwd.cu``),
    as does K7 (``csrc/fused_edge_v2.cu``, whose grid the C side sizes)."""
    k4 = _constant("fused_edge_bwd_main.cuh", "kGroups")
    assert fk._GROUPS == k4 == 3
    assert fk._V2_BWD_GROUPS == {False: k4,
                                 True: _constant("fused_edge_v2_bwd.cu", "kGroupsBf")}
    assert _constant("fused_edge_v2.cu", "kGroups") == 3
    assert _constant("fused_edge_v2.cu", "kGroupsBf") == fk._V2_BWD_GROUPS[True] == 4
    text = (CSRC / "fused_edge_v2_bwd.cu").read_text(encoding="utf-8")
    assert "main_blocks * v2_groups(BF), kV2Stride" in text


@pytest.mark.parametrize("chunk_rows,groups", [(fk._CHUNK_ROWS_K4, 3), (fk._CHUNK_ROWS_K8, 3),
                                               (fk._CHUNK_ROWS_K8, 4)],
                         ids=["K4", "K8", "K8 bf16"])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("num_rec,n_edges,batch", SIZES)
def test_bwd_grid_sizes_the_grids_to_the_work(sms, chunk_rows, groups, batched, num_rec,
                                              n_edges, batch):
    """The main kernel takes one group per chunk of ``chunk_rows / B``
    receivers (at least one), ``groups`` groups a block, up to one block
    per SM; the rows pass 4 groups a block over tiles of 64 (edge, b) rows
    (batched), or the edge pass 3 groups a block over tiles of 64 edges,
    and the workspace holds one stride per group."""
    main, edge, ws_edge = fk._bwd_grid(sms, num_rec, n_edges, batch, batched, chunk_rows,
                                       groups)
    chunks = -(-num_rec // max(1, chunk_rows // batch))
    assert main == min(SMS, -(-chunks // groups))
    assert main * groups >= chunks or main == SMS
    assert (main - 1) * groups < chunks  # no block without a chunk
    if batched:
        tiles = -(-n_edges * batch // 64)
        assert edge == min(SMS, -(-tiles // 4))
        assert ws_edge == edge * 4 * 64 * 64
    else:
        tiles = -(-n_edges // 64)
        assert edge == min(SMS, -(-tiles // 3))
        assert edge * 3 >= tiles or edge == SMS
        assert ws_edge == edge * 3 * fk._WS_EDGE
    assert 1 <= main <= SMS and 1 <= edge <= SMS


@pytest.mark.parametrize("bf16_ops", [False, True])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("num_rec,n_edges,batch", SIZES)
def test_v2_bwd_plan_sizes_k8s_scratch(sms, bf16_ops, batched, num_rec, n_edges, batch):
    """K8's wrapper sizes its main kernel's grid for 3 groups a block, 4
    with bf16 operands, over chunks of 16 (receiver, b) rows; its
    workspace holds one stride (dW2 and four column sums) per group of that
    grid, the edge input's share as ``_bwd_grid`` sizes it, and a row of s
    per edge for a per-edge input; every part a multiple of 4 floats."""
    groups = 4 if bf16_ops else 3
    main, edge, (ws_main, ws_edge, s) = fk._v2_bwd_plan(sms, num_rec, n_edges, batch, batched,
                                                        bf16_ops)
    assert (main, edge, ws_edge) == fk._bwd_grid(sms, num_rec, n_edges, batch, batched, 16,
                                                 groups)
    assert ws_main == main * groups * (64 * 64 + 4 * 64)
    assert s == (0 if batched else n_edges * 64)
    assert all(n % 4 == 0 for n in (ws_main, ws_edge, s))
    chunks = -(-num_rec // max(1, 16 // batch))
    assert main * groups >= chunks or main == SMS  # every chunk has a group


@pytest.mark.parametrize("num_rec,n_edges,batch", SIZES)
def test_rows_and_edge_blocks_size_to_the_work(sms, num_rec, n_edges, batch):
    """The receiver slice takes 4 groups a block over tiles of 64
    (receiver, b) rows and the edge pass 3 over tiles of 64 edges, each up
    to one block per SM and never a block without a tile."""
    rows = num_rec * batch
    tiles = -(-rows // 64)
    rec = fk._rows_blocks(sms, rows)
    assert rec == min(SMS, -(-tiles // 4)) and (rec - 1) * 4 < tiles
    edge_tiles = -(-n_edges // 64)
    edge = fk._edge_blocks(sms, n_edges)
    assert edge == min(SMS, -(-edge_tiles // 3)) and (edge - 1) * 3 < edge_tiles


class _Lib:
    """A stand-in for a kernel library: each C entry a Python callable."""

    def __init__(self, source, calls, **entries):
        self.source, self.calls = source, calls
        for name, fn in entries.items():
            setattr(self, name, self._record(name, fn))

    def _record(self, name, fn):
        def entry(*args):
            self.calls.append((self.source, name, args))
            return fn(*args)

        return entry


ENTRIES = ("nl_fused_edge_fwd_occupancy", "nl_fused_edge_bwd_occupancy",
           "nl_fused_edge_bwd_recompute_occupancy", "nl_fused_edge_v2_fwd_occupancy",
           "nl_fused_edge_v2_bwd_occupancy")
# the entries that take (bf16_ops, io_bf16, edge mode, out)
SHORT_ENTRIES = ("nl_fused_edge_bwd_recompute_occupancy", "nl_fused_edge_v2_fwd_occupancy",
                 "nl_fused_edge_v2_bwd_occupancy")


def _stub_libraries(monkeypatch, calls):
    """Every occupancy entry writes 2 blocks of 384 threads, registers that
    tell the flags it got apart (100 + the flags' sum + 10 * the edge
    mode), 180,000 bytes of shared memory and 8 of local memory."""

    def entry(*args):
        *flags, addr = args
        regs = 100 + sum(flags[:-1]) + 10 * flags[-1]
        (ctypes.c_int * 5).from_address(addr)[:] = [2, 384, regs, 180_000, 8]
        return 0

    def load(source):
        return _Lib(source, calls, **{name: entry for name in ENTRIES})

    monkeypatch.setattr(kernel_build, "load", load)


@pytest.mark.parametrize("bf16_ops", [True, False])
def test_instantiation_occupancy_names_every_instantiation(monkeypatch, bf16_ops):
    """One row per instantiation of K3 (with and without a bf16 pre, in
    each edge mode), of K4's main kernel (the saved-pre kernels in their
    two instantiated modes, the recompute in three), of K7 (three modes)
    and of K8's main kernel (two), in each stream type with bf16 operands
    or in float32; each row carries what the C entry wrote."""
    calls = []
    _stub_libraries(monkeypatch, calls)
    rows = fk.instantiation_occupancy(bf16_ops)
    precisions = 2 if bf16_ops else 1
    assert len(rows) == precisions * (2 * 3 + 2 * 2 + 3 + 3 + 2)
    assert len({r["name"] for r in rows}) == len(rows)
    assert all(r["warps"] == 2 * 384 // 32 and r["local"] == 8 for r in rows)
    k4_saved = [r["name"] for r in rows
                if r["name"].startswith("K4 main,") and "recompute" not in r["name"]]
    assert len(k4_saved) == precisions * 2 * 2
    assert not any(name.endswith(", raw") for name in k4_saved)
    recompute = [r["name"] for r in rows if "recompute" in r["name"]]
    assert sorted(n.rsplit(", ", 1)[1] for n in recompute) == sorted(
        ["raw", "shared", "batched"] * precisions)
    k7 = [r for r in rows if r["kernel"] == "K7"]
    k8 = [r for r in rows if r["kernel"] == "K8"]
    assert sorted(r["mode"] for r in k7) == sorted([0, 1, 2] * precisions)
    assert sorted(r["mode"] for r in k8) == sorted([1, 2] * precisions)
    assert all(r["pre"] == "float32" for r in k7 + k8)
    assert all(r["name"].startswith("K8 main, ") for r in k8)
    # the flags each entry got: (bf16_ops, io_bf16[, pre_bf16], edge mode)
    ops = {args[0] for _, _, args in calls}
    assert ops == ({1} if bf16_ops else {0})
    assert {len(args) for _, name, args in calls if name in SHORT_ENTRIES} == {4}
    assert {len(args) for _, name, args in calls if name not in SHORT_ENTRIES} == {5}
    assert {name for _, name, _ in calls} == set(ENTRIES)


@pytest.mark.parametrize("kernel", ["K3", "K4", "K7", "K8"])
def test_kernel_occupancy_serves_k3_and_k4_from_the_float32_instantiations(monkeypatch,
                                                                           kernel):
    """``kernel_occupancy`` reads K3, K7 and K4's and K8's main kernels
    through the per-instantiation entries: the float32 kernel (K3 and K4
    from a float32 pre), in each edge mode (K4's saved-pre kernel and K8's
    per-edge kernel serve the raw mode with their shared one)."""
    calls = []
    _stub_libraries(monkeypatch, calls)
    occ = fk.kernel_occupancy(kernel)
    assert list(occ) == ["raw", "shared", "batched"]
    for name, mode in (("raw", 0), ("shared", 1), ("batched", 2)):
        served = 1 if kernel in ("K4", "K8") and mode == 0 else mode
        assert occ[name] == dict(blocks=2, warps=24, threads=384, regs=100 + 10 * served,
                                 smem=180_000)
    assert {args[0] for _, _, args in calls} == {0}  # float32 only


# each instantiation's kernel name in chip_smoke.KERNEL_SYMBOLS, by
# (kernel, bf16_ops, io_bf16)
V2_SYMBOL_NAMES = {
    ("K7", 0, 0): "K7 fused_edge_phase_v2",
    ("K7", 1, 1): "K7 fused_edge_phase_v2 bf16",
    ("K7", 1, 0): "K7 fused_edge_phase_v2 bf16 operands",
    ("K8", 0, 0): "K8 fused_edge_phase_v2 backward",
    ("K8", 1, 1): "K8 fused_edge_phase_v2 backward bf16",
    ("K8", 1, 0): "K8 fused_edge_phase_v2 backward bf16 operands",
}


@pytest.mark.parametrize("bf16_ops", [False, True])
def test_kernel_symbols_name_each_k7_and_k8_instantiation(monkeypatch, bf16_ops):
    """Each instantiation of K7 and of K8's main kernel, by its mangled name
    (``chip_smoke.mangled_args`` in a symbol of the anonymous namespace),
    counts under exactly one of ``chip_smoke.KERNEL_SYMBOLS``, its own
    precision's: a CUDA graph's launches are counted by these."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _stub_libraries(monkeypatch, [])
    rows = [r for r in fk.instantiation_occupancy(bf16_ops) if r["kernel"] in ("K7", "K8")]
    assert len(rows) == (2 if bf16_ops else 1) * 5
    for row in rows:
        args = smoke.mangled_args(row)
        ident = args.split("I", 1)[0]
        symbol = f"_ZN12_GLOBAL__N_1{len(ident)}{args}EvT_"
        found = [name for name, pattern in smoke.KERNEL_SYMBOLS.items()
                 if pattern.search(symbol)]
        assert found == [V2_SYMBOL_NAMES[row["kernel"], row["bf16_ops"], row["io_bf16"]]], (
            row["name"], found)
