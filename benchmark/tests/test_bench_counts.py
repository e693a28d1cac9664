"""The operation and byte counts against counts worked by hand on a tiny
graph, and against chip_smoke.py's bounds at MEPS size."""

from __future__ import annotations

import pytest

from benchmark.models import counts, graph_lam

APP = counts.app("g2m", 10, 5, 4, "raw", False)  # 10 edges, 5 senders, 4 receivers


def test_the_kernel_counts_of_one_application():
    b, d, f = 2, 8, 3
    # K1: 5x2x8 sender floats in, 10x2x8 rows out, 10 indices
    assert counts.k1(APP, b, d) == (4 * (80 + 160 + 10), 0.0)
    # K2: 160 gradient floats in, 80 sums out, 10 order entries, 6 offsets
    assert counts.k2(APP, b, d) == (4 * 256, 160.0)
    # K3, raw features, no update, no pre: 160 + 64 + 30 + 5 in, 408
    # weight floats (edge MLP 288, embedder 120), 64 out; the receiver
    # product 1024, sender and second layer 5120, sums 160, embedder 3040
    assert counts.k3(APP, b, d, f, save_pre=False) == (4 * 731, 9344.0)
    # with the pre-activation saved for the backward: 160 floats more
    assert counts.k3(APP, b, d, f, save_pre=True)[0] == 4 * 891


def test_the_model_flops_of_a_tiny_graph_lam():
    cfg = dict(grid_x=4, grid_y=5, hidden_dim=8, hidden_layers=1, processor_layers=2,
               state_vars=3, static_vars=1, forcing_vars=2, forcing_window=3)
    sizes = dict(levels=1, mesh=[9], g2m=20, m2g=40, m2m=[30], up=[], down=[],
                 edge_features=3, mesh_features=2)
    assert counts.mlp_macs([13, 8, 8]) == 168
    # once a step: edge embedders (20 + 40 + 30) x 88, mesh embedder 9 x 80;
    # a sample: grid 20 x (168 + 128 + 88), g2m 6848, m2m 2 x 9408, m2g 14080
    assert graph_lam.step_flops(cfg, sizes, 2) == 2.0 * (8640 + 2 * (7680 + 39744))
    apps = graph_lam.applications(cfg, sizes)
    assert [a["d_new"] for a in apps] == [False, True, False, False]
    assert [a["edge"] for a in apps] == ["raw", "raw", "batched", "raw"]


def test_the_bounds_at_meps_size_are_chip_smokes():
    """chip_smoke.py (feda1b7) printed these bounds for GraphLAM at batch 4:
    K1 0.2094, K2 0.2095, K3 0.4021 (forward) and K4 0.8661 ms a step."""
    cfg = dict(grid_x=268, grid_y=238, hidden_dim=64, hidden_layers=1, processor_layers=4)
    sizes = dict(levels=1, mesh=[6561], g2m=100656, m2g=255136, m2m=[57616], up=[], down=[],
                 edge_features=3, mesh_features=2)
    apps = graph_lam.applications(cfg, sizes)
    train = counts.kernel_bounds(apps, 4, 64, 3, training=True)
    serve = counts.kernel_bounds(apps, 4, 64, 3, training=False)
    for got, want in ((train["K1 sender_gather"], 0.2094), (train["K2 sender_scatter"], 0.2095),
                      (serve["K3 fused_edge_phase"], 0.4021),
                      (train["K4 fused_edge_phase backward"], 0.8661)):
        assert 1e3 * got == pytest.approx(want, abs=1e-4)
