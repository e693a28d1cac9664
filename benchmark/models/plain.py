"""The plain reference's shared pieces: float32 PyTorch with TF32 off, no
kernels, no caches, no batching tricks.

It follows the published model (neural-lam, Oskarsson, Landelius &
Lindsten 2023, arXiv:2309.17370; mllam/neural-lam ``gnn_layers.py``,
``utils.make_mlp``, ``models/step_predictors/graph/base.py``,
``forecasters/autoregressive.py``, ``metrics.py``, ``module.py``) and
imports nothing of the program. Arrays are batch-major ``(B, N, D)``;
every edge representation is broadcast over the batch where it is
first used, which is what sharing it is. The graph is read from the raw
``graph.npz`` the benchmark wrote, and normalised here as the reference
loader does (``utils.py:404-463``).
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-5


def tf32(on: bool) -> None:
    """TF32 in cuBLAS and cuDNN on or off (off is the reference's float32;
    on is the control's lower precision)."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


# -- parameters, named as the reference's state dict -------------------------

def mlp_spec(prefix: str, blueprint: list[int], layer_norm: bool = True) -> list:
    """``(name, shape, kind)`` of ``utils.make_mlp(blueprint, layer_norm)``:
    ``Linear`` at even indices with ``SiLU`` between, ``LayerNorm`` last."""
    out = []
    n_linear = len(blueprint) - 1
    for k, (din, dout) in enumerate(zip(blueprint[:-1], blueprint[1:])):
        out.append((f"{prefix}.{2 * k}.weight", (dout, din), "weight"))
        out.append((f"{prefix}.{2 * k}.bias", (dout,), "bias"))
    if layer_norm:
        i = 2 * n_linear - 1
        out.append((f"{prefix}.{i}.weight", (blueprint[-1],), "ln_weight"))
        out.append((f"{prefix}.{i}.bias", (blueprint[-1],), "ln_bias"))
    return out


def gnn_spec(prefix: str, d: int, hidden_layers: int) -> list:
    """An InteractionNet's edge and node MLPs (``gnn_layers.py:90-107``)."""
    tail = [d] * (hidden_layers + 1)
    return (mlp_spec(f"{prefix}.edge_mlp", [3 * d] + tail)
            + mlp_spec(f"{prefix}.aggr_mlp", [2 * d] + tail))


def make_weights(specs: list, seed: int, device) -> dict[str, torch.Tensor]:
    """Float32 parameters for ``specs`` from ``seed``, drawn on ``device`` in
    one call: a ``Linear``'s weight and bias uniform in ``+-1/sqrt(fan_in)``
    (``nn.Linear``'s default range), a ``LayerNorm``'s scale ``1 +- 0.1``
    and bias ``+-0.1`` (away from the trivial 1 and 0, so that the check
    sees them)."""
    total = sum(math.prod(shape) for _, shape, _ in specs)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32) * 2 - 1
    out, at, fan_in = {}, 0, 1
    for name, shape, kind in specs:
        n = math.prod(shape)
        u = flat[at:at + n].view(shape)
        at += n
        if kind == "weight":
            fan_in = shape[1]
        if kind in ("weight", "bias"):
            out[name] = u / math.sqrt(fan_in)
        elif kind == "ln_weight":
            out[name] = 1 + 0.1 * u
        else:
            out[name] = 0.1 * u
    return out


# -- the graph ----------------------------------------------------------------

def load_graph(graph_dir: Path, xy_span: float, device) -> dict:
    """The raw graph as index and feature tensors on ``device``: mesh
    positions divided by the grid's larger span, every edge feature by the
    longest m2m edge. Edge sets are ``(senders, receivers, features)``."""
    graph_dir = Path(graph_dir)
    meta = json.loads((graph_dir / "metainfo.yaml").read_text(encoding="utf-8"))
    with np.load(graph_dir / "graph.npz") as data:
        arrays = {k: data[k] for k in data.files}
    levels = int(meta["n_levels"])
    longest = max(float(arrays[f"m2m__{lv}_features"][:, 0].max()) for lv in range(levels))

    def edges(name: str):
        return (torch.from_numpy(arrays[f"{name}_senders"].astype(np.int64)).to(device),
                torch.from_numpy(arrays[f"{name}_receivers"].astype(np.int64)).to(device),
                torch.from_numpy(arrays[f"{name}_features"] / np.float32(longest)).to(device))

    mesh = []
    for lv in range(levels):
        m = arrays[f"mesh_features__{lv}"].astype(np.float32).copy()
        m[:, :2] /= np.float32(xy_span)
        mesh.append(torch.from_numpy(m).to(device))
    return {
        "levels": levels,
        "mesh": mesh,
        "g2m": edges("g2m"),
        "m2g": edges("m2g"),
        "m2m": [edges(f"m2m__{lv}") for lv in range(levels)],
        "up": [edges(f"mesh_up__{lv}") for lv in range(levels - 1)],
        "down": [edges(f"mesh_down__{lv}") for lv in range(levels - 1)],
    }


def graph_sizes(graph_dir: Path) -> dict:
    """Node and edge counts of a stored graph, for the operation counts."""
    graph_dir = Path(graph_dir)
    meta = json.loads((graph_dir / "metainfo.yaml").read_text(encoding="utf-8"))
    levels = int(meta["n_levels"])
    with np.load(graph_dir / "graph.npz") as data:
        def n(name):
            return int(data[f"{name}_senders"].shape[0])

        return {
            "levels": levels,
            "mesh": [int(data[f"mesh_features__{lv}"].shape[0]) for lv in range(levels)],
            "g2m": n("g2m"), "m2g": n("m2g"),
            "m2m": [n(f"m2m__{lv}") for lv in range(levels)],
            "up": [n(f"mesh_up__{lv}") for lv in range(levels - 1)],
            "down": [n(f"mesh_down__{lv}") for lv in range(levels - 1)],
            "edge_features": int(data["g2m_features"].shape[1]),
            "mesh_features": int(data["mesh_features__0"].shape[1]),
        }


# -- layers -------------------------------------------------------------------

def mlp(p: dict, prefix: str, x: torch.Tensor) -> torch.Tensor:
    """``utils.make_mlp``'s MLP: ``Linear``, ``SiLU``, ..., ``Linear``, and
    ``LayerNorm`` when the parameters hold one."""
    k = 0
    while f"{prefix}.{2 * k}.weight" in p:
        if k:
            x = F.silu(x)
        x = x @ p[f"{prefix}.{2 * k}.weight"].T + p[f"{prefix}.{2 * k}.bias"]
        k += 1
    ln = f"{prefix}.{2 * k - 1}.weight"
    if ln in p:
        x = F.layer_norm(x, (x.shape[-1],), p[ln], p[f"{prefix}.{2 * k - 1}.bias"], LN_EPS)
    return x


def batched(x: torch.Tensor, batch: int) -> torch.Tensor:
    """``(N, D)`` shared over the batch as ``(B, N, D)``."""
    return x.expand(batch, *x.shape) if x.dim() == 2 else x


def interaction(p: dict, prefix: str, edge_set, send, rec, edge, aggr: str = "sum"):
    """``InteractionNet.forward`` (``gnn_layers.py:109-160``): messages
    ``edge_mlp([edge, sender, receiver])`` summed (or averaged) into the
    receivers, the receivers updated by ``rec + aggr_mlp([rec, aggr])``.
    Returns ``(new_rec, edge + messages)``."""
    senders, receivers, _ = edge_set
    b = next(t.shape[0] for t in (send, rec, edge) if t.dim() == 3)
    send, rec, edge = batched(send, b), batched(rec, b), batched(edge, b)
    x_send = send.index_select(1, senders)
    x_rec = rec.index_select(1, receivers)
    msg = mlp(p, f"{prefix}.edge_mlp", torch.cat((edge, x_send, x_rec), dim=-1))
    agg = torch.zeros(b, rec.shape[1], msg.shape[-1], dtype=msg.dtype, device=msg.device)
    agg = agg.index_add(1, receivers, msg)
    if aggr == "mean":
        counts = torch.bincount(receivers, minlength=rec.shape[1]).clamp(min=1)
        agg = agg / counts.to(agg.dtype)[None, :, None]
    new_rec = rec + mlp(p, f"{prefix}.aggr_mlp", torch.cat((rec, agg), dim=-1))
    return new_rec, edge + msg


def encode_decode(p: dict, g: dict, stats: dict, prev, prev_prev, forcing, mesh_embedder: str,
                  process):
    """One step of ``BaseGraphModel``: embed the grid inputs, g2m, the
    family's ``process(mesh_rep) -> mesh_rep`` (the bottom mesh level
    embedded by ``mesh_embedder``), m2g, the output map, the
    one-step difference rescaling and the residual add
    (``graph/base.py:228-344``; no clamping is configured)."""
    b = prev.shape[0]
    static = stats["static"].expand(b, *stats["static"].shape)
    grid_emb = mlp(p, "grid_embedder", torch.cat((prev, prev_prev, forcing, static), dim=-1))
    mesh_emb = mlp(p, mesh_embedder, g["mesh"][0])
    g2m_edge = mlp(p, "g2m_embedder", g["g2m"][2])
    mesh_rep, _ = interaction(p, "g2m_gnn", g["g2m"], grid_emb, mesh_emb, g2m_edge)
    grid_rep = grid_emb + mlp(p, "encoding_grid_mlp", grid_emb)
    mesh_rep = process(mesh_rep)
    m2g_edge = mlp(p, "m2g_embedder", g["m2g"][2])
    grid_rep, _ = interaction(p, "m2g_gnn", g["m2g"], mesh_rep, grid_rep, m2g_edge)
    delta = mlp(p, "output_map", grid_rep)
    return prev + delta * stats["diff_std"] + stats["diff_mean"]


def rollout(step, init, forcing, boundary, interior):
    """``ARForecaster.forward`` (``forecasters/autoregressive.py:116-136``):
    ``step(prev, prev_prev, forcing_t)`` over the window, the boundary
    nodes overwritten by the given states after each step. Inputs are
    standardized, ``(B, 2, N, d)``, ``(B, T, N, f)``, ``(B, T, N, d)``;
    ``interior`` is ``(N, 1)`` with 1 inside."""
    prev_prev, prev = init[:, 0], init[:, 1]
    out = []
    for t in range(forcing.shape[1]):
        new = step(prev, prev_prev, forcing[:, t])
        new = (1 - interior) * boundary[:, t] + interior * new
        out.append(new)
        prev_prev, prev = prev, new
    return torch.stack(out, dim=1)


def standardize(x: torch.Tensor, mean, std) -> torch.Tensor:
    return (x - mean) / std


def wmse_loss(pred, target, per_var_std, interior_bool) -> torch.Tensor:
    """The training loss (``module.py:361-386`` with ``metrics.wmse``): the
    squared error over ``per_var_std**2``, averaged over the interior
    nodes, summed over the variables, averaged over samples and steps."""
    entry = (pred - target) ** 2 / per_var_std**2
    return entry[:, :, interior_bool].mean(dim=2).sum(dim=-1).mean()


def adamw_(params: dict, grads: dict, state: dict, step: int, lr: float,
           betas=(0.9, 0.95), eps: float = 1e-8, weight_decay: float = 0.01) -> None:
    """One AdamW update in place (``torch.optim.AdamW``'s arithmetic, the
    reference's optimizer, ``module.py:284-287``)."""
    b1, b2 = betas
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    for name, p in params.items():
        g = grads[name]
        m, v = state.setdefault(name, (torch.zeros_like(p), torch.zeros_like(p)))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        p.mul_(1 - lr * weight_decay)
        p.addcdiv_(m, v.sqrt() / math.sqrt(bc2) + eps, value=-lr / bc1)
