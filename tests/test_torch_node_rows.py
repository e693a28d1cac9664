"""How the node-MLP route's row kernels size their launches and report their
launch resources, and their plain versions, on the CPU.

Under ``NEURAL_LAM_TPU_FUSED_AGGR=on`` the node update runs after K3 and the
node backward before K4 (``csrc/fused_node.cu``, ``csrc/fused_node_bwd.cu``):
persistent blocks of warpgroups walking 64-row tiles of the (receiver, b)
rows. The node update runs 3 warpgroups a block (4 with bf16 operands), the
node backward one block an SM, each block writing one part of the weight
gradients' workspace. These tests stub the SM count and the libraries' C
entry points, so they need no card and no compiler; the wrappers' sizing
must mirror the constants of the CUDA sources, which they read.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from neural_lam_tpu_torch.ops import fused_kernels as fk
from neural_lam_tpu_torch.ops import kernel_build
from neural_lam_tpu_torch.ops.mlp import make_mlp

SMS = 132
CSRC = Path(fk.__file__).resolve().parent.parent / "csrc"
# (receiver, b) rows: one row, a tile and a row either side, the MEPS sites
# at batch 4 (a mesh level, the grid), more tiles than either grid has
# blocks or warpgroups, and the last tile of a block's share
ROWS = [1, 63, 64, 65, 26_244, 255_136, 64 * SMS * 3, 64 * SMS * 3 + 1, 1_000_003]


def _cdiv(a, b):
    return -(-a // b)


@pytest.fixture
def sms(monkeypatch):
    monkeypatch.setattr(fk, "_sm_count", lambda index: SMS)
    return torch.device("cuda", 0)  # a device object only: nothing runs on it


def _constant(source: str, name: str) -> int:
    text = (CSRC / source).read_text(encoding="utf-8")
    found = re.search(rf"constexpr int {name} = (\d+);", text)
    assert found, f"{name} not in csrc/{source}"
    return int(found.group(1))


def test_sizing_mirrors_the_cuda_sources():
    """The wrappers' warpgroups a block, blocks per SM and workspace stride
    are those of ``csrc/fused_node.cu`` and ``csrc/fused_node_bwd.cu``."""
    assert fk._NODE_FWD_GROUPS == {False: _constant("fused_node.cu", "kGroups"),
                                   True: _constant("fused_node.cu", "kGroupsBf")}
    assert fk._NODE_BWD_BLOCKS_PER_SM == 1
    text = (CSRC / "fused_node_bwd.cu").read_text(encoding="utf-8")
    assert "constexpr int kStride = 3 * kMat + 4 * D;" in text
    assert fk._WS_NODE == 3 * 64 * 64 + 4 * 64
    assert "__launch_bounds__(block_threads(BF), 1)" in text


@pytest.mark.parametrize("bf16_ops", [False, True])
@pytest.mark.parametrize("rows", ROWS)
def test_node_update_blocks_size_to_the_work(sms, rows, bf16_ops):
    """The node update takes up to one block an SM of 3 warpgroups (4 with
    bf16 operands), never a block without a tile; each warpgroup walks its
    tiles ``gridDim.x * groups`` apart, at most ``tiles per warpgroup``."""
    groups = 4 if bf16_ops else 3
    tiles = _cdiv(rows, 64)
    blocks = fk._node_fwd_blocks(sms, rows, bf16_ops)
    assert blocks == min(SMS, _cdiv(tiles, groups))
    assert 1 <= blocks <= SMS and (blocks - 1) * groups < tiles
    per_group = _cdiv(tiles, blocks * groups)
    assert per_group == (1 if tiles <= SMS * groups else _cdiv(tiles, SMS * groups))
    # every tile has a warpgroup: group g of block b takes b * groups + g + k * step
    step = blocks * groups
    taken = sorted(b * groups + g + k * step for b in range(blocks) for g in range(groups)
                   for k in range(per_group) if b * groups + g + k * step < tiles)
    assert taken == list(range(tiles))


@pytest.mark.parametrize("rows", ROWS)
def test_node_backward_blocks_and_workspace_size_to_the_work(sms, rows):
    """The node backward takes one block an SM and at most one a tile; block
    b takes tiles b, b + blocks, ..., and the workspace holds one part of
    3 D^2 + 4 D floats a block (so at most 132 parts, where the two blocks
    an SM of the earlier kernel wrote up to 264)."""
    tiles = _cdiv(rows, 64)
    blocks = fk._node_bwd_blocks(sms, rows)
    assert blocks == min(SMS, tiles)
    assert sorted(b + k * blocks for b in range(blocks) for k in range(_cdiv(tiles, blocks))
                  if b + k * blocks < tiles) == list(range(tiles))
    ws = blocks * fk._WS_NODE
    assert ws <= SMS * (3 * 64 * 64 + 4 * 64)
    assert _cdiv(tiles, blocks) == (1 if tiles <= SMS else _cdiv(tiles, SMS))


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


def test_node_occupancy_names_every_instantiation(monkeypatch):
    """One row per instantiation of each kernel (float32; bf16 operands on
    bf16 and on float32 streams), from its own library's entry, carrying
    what the entry wrote."""
    calls = []

    def entry(ops, io, addr):
        (ctypes.c_int * 5).from_address(addr)[:] = [1, 256 + 128 * ops, 100 + 10 * ops + io,
                                                    200_000, 4 * io]
        return 0

    monkeypatch.setattr(kernel_build, "load", lambda source: _Lib(
        source, calls, nl_fused_node_fwd_occupancy=entry, nl_fused_node_bwd_occupancy=entry))
    rows = fk.node_occupancy()
    assert [r["name"] for r in rows] == [
        f"{k}, {p}" for k in ("K3 node update", "K4 node backward")
        for p in ("float32", "bf16 streams", "float32 streams")]
    assert {(src, name) for src, name, _ in calls} == {
        ("fused_node", "nl_fused_node_fwd_occupancy"),
        ("fused_node_bwd", "nl_fused_node_bwd_occupancy")}
    for r in rows:
        assert r["regs"] == 100 + 10 * r["bf16_ops"] + r["io_bf16"]
        assert r["warps"] == r["threads"] // 32 and r["local"] == 4 * r["io_bf16"]


def _node_inputs(n_rec, batch, ln, seed=0):
    rng = np.random.default_rng(seed)
    d = 64
    rec, aggr, d_node = (torch.tensor(rng.normal(size=(n_rec, batch, d)), dtype=torch.float32)
                         for _ in range(3))
    mlp = make_mlp([2 * d, d, d], layer_norm=ln, generator=torch.Generator().manual_seed(seed))
    return rec, aggr, d_node, [None if w is None else w.detach().float()
                               for w in fk._node_weights(mlp)], mlp


@pytest.mark.parametrize("ln", [True, False])
@pytest.mark.parametrize("n_rec,batch", [(0, 4), (1, 1), (65, 1), (3, 32)])
def test_node_wrappers_on_cpu_tensors_are_the_plain_versions(n_rec, batch, ln):
    """On CPU tensors the node update is ``rec + aggr_mlp([rec, aggr])``
    (the unfused tail, within float32 summation order) and the node backward
    its autograd: ``d_aggr``, ``d_rec`` (the residual included) and the
    weight gradients, None where the weight is."""
    rec, aggr, d_node, nw, mlp = _node_inputs(n_rec, batch, ln)
    node = fk.fused_node_fwd(rec, aggr, nw)
    want = rec + mlp(torch.cat([rec, aggr], dim=-1))
    torch.testing.assert_close(node, want, rtol=0, atol=1e-5)
    d_aggr, d_rec, grads = fk.fused_node_bwd(d_node, rec, aggr, nw)
    leaves = [rec.clone().requires_grad_(True), aggr.clone().requires_grad_(True),
              *mlp.parameters()]
    out = leaves[0] + mlp(torch.cat(leaves[:2], dim=-1))
    g = torch.autograd.grad(out, leaves, d_node, allow_unused=True)
    torch.testing.assert_close(d_aggr, g[1], rtol=0, atol=1e-5)
    torch.testing.assert_close(d_rec, g[0], rtol=0, atol=1e-5)
    assert [t is None for t in grads] == [w is None for w in nw]
    for got, want_g in zip((t for t in grads if t is not None), g[2:]):
        torch.testing.assert_close(got.reshape(want_g.shape), want_g, rtol=0, atol=1e-4)


def test_node_wrappers_keep_the_stream_and_output_dtypes():
    """bf16 streams: the update in ``out_dtype`` (the streams' by default),
    ``d_aggr`` in the streams' dtype, ``d_rec`` float32; the plain version
    rounds each product's operands to bf16."""
    rec, aggr, d_node, nw, _ = _node_inputs(5, 4, True)
    rec16, d16 = rec.bfloat16(), d_node.bfloat16()
    assert fk.fused_node_fwd(rec16, aggr, nw, True).dtype == torch.bfloat16
    node32 = fk.fused_node_fwd(rec16, aggr, nw, True, torch.float32)
    assert node32.dtype == torch.float32
    torch.testing.assert_close(node32, fk._plain_node(rec16.float(), aggr, nw, True))
    d_aggr, d_rec, _ = fk.fused_node_bwd(d16, rec16, aggr, nw, True)
    assert d_aggr.dtype == torch.bfloat16 and d_rec.dtype == torch.float32


def test_launchers_refuse_autograd_inputs():
    """The row kernels' launchers record no autograd graph."""
    rec, aggr, d_node, nw, _ = _node_inputs(3, 2, True)
    with pytest.raises(RuntimeError, match="outside autograd"):
        fk.fused_node_fwd(rec.requires_grad_(True), aggr, nw)
    with pytest.raises(RuntimeError, match="outside autograd"):
        fk.fused_node_bwd(d_node, rec, aggr, nw)
