"""Operations and bytes of the graph models, from the configuration's
shapes alone.

Model FLOPs (``mfu``) count the multiply-adds of every matrix product the
plain model computes, two operations each: the grid, mesh and edge
embedders, every GNN application's edge MLP (its first layer over
``[edge, sender, receiver]``) at its edge count and node MLP at its
receiver count, the grid encoder MLP and the output map. Static
embeddings are computed once a step, everything else once a sample.
SiLU, LayerNorm and the sums into the receivers are left out. A training
step counts the forward three times; recomputation is not counted.

The kernels' least time (``kernel_roofline``) follows ``chip_smoke.py``'s
counts (commit feda1b7) for the float32 kernels of the v1 fused route:
K1 gathers the senders' rows, K3 is the edge phase (the embedder in the
kernel on raw features), K2 and K4 their backwards. Each input and output
is counted once, four bytes a float; operations as in ``chip_smoke.py``
(the products and the receiver sums), so the bound is a lower bound.
"""

from __future__ import annotations

F32 = 4


def mlp_macs(blueprint: list[int]) -> int:
    return sum(a * b for a, b in zip(blueprint[:-1], blueprint[1:]))


def app(name: str, edges: int, n_send: int, n_rec: int, edge: str, update: bool) -> dict:
    """One GNN application: its edge set's size, the sender and receiver
    node counts, how the edge input comes (``raw`` features embedded in the
    kernel, a ``shared`` unbatched representation, or a ``batched`` one) and
    whether it updates the edges."""
    return dict(name=name, E=edges, n_send=n_send, n_rec=n_rec, edge=edge, update=update,
                d_new=False)


def mark_used_edges(apps: list[dict], key=lambda a: a["name"].split(" ")[0]) -> list[dict]:
    """Set ``d_new`` on each edge-updating application whose new edge
    representation a later application of the same edge set reads: in
    training, its backward then gets that gradient."""
    for i, a in enumerate(apps):
        a["d_new"] = a["update"] and any(key(b) == key(a) for b in apps[i + 1:])
    return apps


def app_macs(a: dict, d: int, hidden_layers: int) -> int:
    """Multiply-adds a sample of one application's edge and node MLPs."""
    tail = [d] * (hidden_layers + 1)
    return a["E"] * mlp_macs([3 * d] + tail) + a["n_rec"] * mlp_macs([2 * d] + tail)


def step_flops(apps: list[dict], once_macs: int, sample_macs: int, batch: int, d: int,
               hidden_layers: int) -> float:
    """Forward FLOPs of one model step at ``batch`` samples."""
    per_sample = sample_macs + sum(app_macs(a, d, hidden_layers) for a in apps)
    return 2.0 * (once_macs + batch * per_sample)


def _edge_weights(d: int, raw: bool, f: int) -> int:
    """Floats of an edge MLP's parameters, with its embedder where the
    kernel runs it (raw features)."""
    n = 3 * d * d + d + d * d + d + 2 * d
    if raw:
        n += f * d + d + d * d + d + 2 * d
    return n


def k1(a: dict, b: int, d: int) -> tuple[float, float]:
    """K1: the sender rows in, one row per edge out, the index."""
    return F32 * (a["n_send"] * b * d + a["E"] * b * d + a["E"]), 0.0


def k2(a: dict, b: int, d: int) -> tuple[float, float]:
    """K2: one gradient row per edge in, the senders' sums out, the
    sender-sorted order and offsets."""
    nbytes = F32 * (a["E"] * b * d + a["n_send"] * b * d + a["E"] + a["n_send"] + 1)
    return nbytes, float(a["E"] * b * d)


def _edge_in(a: dict, b: int, d: int, f: int) -> int:
    return {"raw": a["E"] * f, "shared": a["E"] * d, "batched": a["E"] * b * d}[a["edge"]]


def k3(a: dict, b: int, d: int, f: int, save_pre: bool) -> tuple[float, float]:
    """K3: gathered senders, receivers, the edge input, the offsets and
    weights in; the receiver sums, the new edges (if updated) and, when
    the step will be differentiated, the saved pre-activation out."""
    rows, e = a["E"] * b, a["E"]
    floats = (rows * d + a["n_rec"] * b * d + _edge_in(a, b, d, f) + a["n_rec"] + 1
              + _edge_weights(d, a["edge"] == "raw", f) + a["n_rec"] * b * d)
    floats += rows * d * (int(a["update"]) + int(save_pre))
    flops = 2 * a["n_rec"] * b * d * d + 2 * rows * d * d * 2 + rows * d
    if a["edge"] == "raw":
        flops += e * (2 * f * d + 2 * d * d + 2 * d * d)
    elif a["edge"] == "shared":
        flops += 2 * e * d * d
    else:
        flops += 2 * rows * d * d
    return F32 * floats, float(flops)


def k4(a: dict, b: int, d: int, f: int) -> tuple[float, float]:
    """K4 with its tail: the saved pre-activation, senders, receivers, the
    edge input, the incoming gradients, offsets and weights in; the
    senders', receivers' and (unless raw) edge input's gradients and the
    weights' gradients out."""
    rows, e = a["E"] * b, a["E"]
    raw = a["edge"] == "raw"
    weights = _edge_weights(d, raw, f)
    edge_in = _edge_in(a, b, d, f)
    floats = (rows * d * 2 + a["n_rec"] * b * d * 2 + edge_in + a["n_rec"] + 1 + weights
              + rows * d * int(a["d_new"]))
    floats += rows * d + a["n_rec"] * b * d + (0 if raw else edge_in) + weights
    flops = 2 * rows * d * d * 5 + 2 * a["n_rec"] * b * d * d * 2 + rows * d
    if raw:
        flops += e * (2 * d * d * 5 + 2 * f * d * 2)
    elif a["edge"] == "shared":
        flops += 2 * e * d * d * 2
    else:
        flops += 2 * rows * d * d * 2
    return F32 * floats, float(flops)


def kernel_bounds(apps: list[dict], b: int, d: int, f: int, training: bool) -> dict[str, float]:
    """Least device seconds of one step's launches of each kernel group of
    ``kernels.json``'s ``roofline`` table (3xTF32 for the products)."""
    from ..yardstick import bound

    out = {"K1 sender_gather": 0.0, "K3 fused_edge_phase": 0.0}
    if training:
        out.update({"K2 sender_scatter": 0.0, "K4 fused_edge_phase backward": 0.0})
    for a in apps:
        out["K1 sender_gather"] += bound(*k1(a, b, d))[0] / 1e3
        out["K3 fused_edge_phase"] += bound(*k3(a, b, d, f, training), tensor=True)[0] / 1e3
        if training:
            out["K2 sender_scatter"] += bound(*k2(a, b, d))[0] / 1e3
            out["K4 fused_edge_phase backward"] += bound(*k4(a, b, d, f), tensor=True)[0] / 1e3
    return out
