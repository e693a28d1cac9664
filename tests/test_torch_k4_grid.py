"""How the wrappers of K3 and K4 size their launches and report their
launch resources, on the CPU.

K4's and K8's main kernels and their edge pass run 3 groups of warps per
block, their rows pass and K4's receiver slice 4, and the wrapper sizes
the grids and the workspaces to the work. K3's and K4's
libraries report the launch resources of each instantiation through one
C entry each. These tests stub the SM count and the libraries' C entry
points, so they need no card and no compiler.
"""

import ctypes

import pytest
import torch

from neural_lam_tpu_torch.ops import fused_kernels as fk
from neural_lam_tpu_torch.ops import kernel_build

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


@pytest.mark.parametrize("chunk_rows", [fk._CHUNK_ROWS_K4, fk._CHUNK_ROWS_K8], ids=["K4", "K8"])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("num_rec,n_edges,batch", SIZES)
def test_bwd_grid_sizes_the_grids_to_the_work(sms, chunk_rows, batched, num_rec, n_edges,
                                              batch):
    """The main kernel takes one group per chunk of ``chunk_rows / B``
    receivers (at least one), 3 groups a block, up to one block per SM;
    the rows pass 4 groups a block over tiles of 64 (edge, b) rows
    (batched), or the edge pass 3 groups a block over tiles of 64 edges,
    and the workspace holds one stride per group."""
    main, edge, ws_edge = fk._bwd_grid(sms, num_rec, n_edges, batch, batched, chunk_rows)
    chunks = -(-num_rec // max(1, chunk_rows // batch))
    assert main == min(SMS, -(-chunks // 3))
    assert main * 3 >= chunks or main == SMS
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
           "nl_fused_edge_bwd_recompute_occupancy")


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
    each edge mode) and of K4's main kernel (the saved-pre
    kernels in their two instantiated modes, the recompute in three), in
    each stream type with bf16 operands or in float32; each row carries
    what the C entry wrote."""
    calls = []
    _stub_libraries(monkeypatch, calls)
    rows = fk.instantiation_occupancy(bf16_ops)
    precisions = 2 if bf16_ops else 1
    assert len(rows) == precisions * (2 * 3 + 2 * 2 + 3)
    assert len({r["name"] for r in rows}) == len(rows)
    assert all(r["warps"] == 2 * 384 // 32 and r["local"] == 8 for r in rows)
    k4_saved = [r["name"] for r in rows
                if r["name"].startswith("K4 main,") and "recompute" not in r["name"]]
    assert len(k4_saved) == precisions * 2 * 2
    assert not any(name.endswith(", raw") for name in k4_saved)
    recompute = [r["name"] for r in rows if "recompute" in r["name"]]
    assert sorted(n.rsplit(", ", 1)[1] for n in recompute) == sorted(
        ["raw", "shared", "batched"] * precisions)
    # the flags each entry got: (bf16_ops, io_bf16[, pre_bf16], edge mode)
    ops = {args[0] for _, _, args in calls}
    assert ops == ({1} if bf16_ops else {0})
    assert {len(args) for _, name, args in calls if "recompute" in name} == {4}
    assert {len(args) for _, name, args in calls if "recompute" not in name} == {5}


@pytest.mark.parametrize("kernel", ["K3", "K4"])
def test_kernel_occupancy_serves_k3_and_k4_from_the_float32_instantiations(monkeypatch,
                                                                           kernel):
    """``kernel_occupancy`` reads K3 and K4's main kernel through the
    per-instantiation entries: the float32 kernel from a float32 pre, in
    each edge mode (K4's saved-pre kernel serves the raw mode with its
    shared one)."""
    calls = []
    _stub_libraries(monkeypatch, calls)
    occ = fk.kernel_occupancy(kernel)
    assert list(occ) == ["raw", "shared", "batched"]
    for name, mode in (("raw", 0), ("shared", 1), ("batched", 2)):
        served = 1 if kernel == "K4" and mode == 0 else mode
        assert occ[name] == dict(blocks=2, warps=24, threads=384, regs=100 + 10 * served,
                                 smem=180_000)
    assert {args[0] for _, _, args in calls} == {0}  # float32 only
