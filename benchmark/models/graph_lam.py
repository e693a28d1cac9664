"""GraphLAM (Keisler 2022, as in neural-lam, Oskarsson et al. 2023): the
flat processor on a multiscale mesh. Its parameters by the reference's
state-dict names, its GNN applications and their operation counts, and
its plain one-step reference (``graph/graph_lam.py:16-183``)."""

from __future__ import annotations

from . import counts
from .plain import encode_decode, gnn_spec, interaction, mlp, mlp_spec

PORT_CLASS = "GraphLAM"


def grid_input_dim(cfg: dict) -> int:
    return (2 * cfg["state_vars"] + cfg["static_vars"]
            + cfg["forcing_vars"] * cfg["forcing_window"])


def base_spec(cfg: dict, sizes: dict) -> list:
    """The encoder and decoder every graph model shares
    (``graph/base.py:142-175``)."""
    d, hl = cfg["hidden_dim"], cfg["hidden_layers"]
    end = [d] * (hl + 1)
    f = sizes["edge_features"]
    return (mlp_spec("grid_embedder", [grid_input_dim(cfg)] + end)
            + mlp_spec("g2m_embedder", [f] + end)
            + mlp_spec("m2g_embedder", [f] + end)
            + gnn_spec("g2m_gnn", d, hl)
            + mlp_spec("encoding_grid_mlp", [d] + end)
            + gnn_spec("m2g_gnn", d, hl)
            + mlp_spec("output_map", end + [cfg["state_vars"]], layer_norm=False))


def param_specs(cfg: dict, sizes: dict) -> list:
    d, hl = cfg["hidden_dim"], cfg["hidden_layers"]
    end = [d] * (hl + 1)
    out = base_spec(cfg, sizes)
    out += mlp_spec("mesh_embedder", [sizes["mesh_features"]] + end)
    out += mlp_spec("m2m_embedder", [sizes["edge_features"]] + end)
    for i in range(cfg["processor_layers"]):
        out += gnn_spec(f"processor.module_{i}", d, hl)
    return out


def applications(cfg: dict, sizes: dict) -> list[dict]:
    """The GNN applications of one step, in order."""
    n_grid, m = cfg["grid_x"] * cfg["grid_y"], sizes["mesh"][0]
    apps = [counts.app("g2m", sizes["g2m"], n_grid, m, "raw", False)]
    for i in range(cfg["processor_layers"]):
        apps.append(counts.app(f"m2m layer {i}", sizes["m2m"][0], m, m,
                               "raw" if i == 0 else "batched", True))
    apps.append(counts.app("m2g", sizes["m2g"], m, n_grid, "raw", False))
    return counts.mark_used_edges(apps)


def base_macs(cfg: dict, sizes: dict) -> tuple[int, int]:
    """``(once a step, once a sample)`` multiply-adds of the shared encoder
    and decoder outside the GNN applications."""
    d, hl = cfg["hidden_dim"], cfg["hidden_layers"]
    end = [d] * (hl + 1)
    n_grid, f = cfg["grid_x"] * cfg["grid_y"], sizes["edge_features"]
    once = (sizes["g2m"] + sizes["m2g"]) * counts.mlp_macs([f] + end)
    sample = n_grid * (counts.mlp_macs([grid_input_dim(cfg)] + end)
                       + counts.mlp_macs([d] + end)
                       + counts.mlp_macs(end + [cfg["state_vars"]]))
    return once, sample


def step_flops(cfg: dict, sizes: dict, batch: int) -> float:
    d, hl = cfg["hidden_dim"], cfg["hidden_layers"]
    end = [d] * (hl + 1)
    once, sample = base_macs(cfg, sizes)
    once += sizes["mesh"][0] * counts.mlp_macs([sizes["mesh_features"]] + end)
    once += sizes["m2m"][0] * counts.mlp_macs([sizes["edge_features"]] + end)
    return counts.step_flops(applications(cfg, sizes), once, sample, batch, d, hl)


def make_step(p: dict, g: dict, stats: dict, cfg: dict):
    """The plain one-step predictor ``step(prev, prev_prev, forcing)``."""

    def process(mesh_rep):
        edge = mlp(p, "m2m_embedder", g["m2m"][0][2])
        for i in range(cfg["processor_layers"]):
            mesh_rep, edge = interaction(p, f"processor.module_{i}", g["m2m"][0], mesh_rep,
                                         mesh_rep, edge, cfg["mesh_aggr"])
        return mesh_rep

    def step(prev, prev_prev, forcing):
        return encode_decode(p, g, stats, prev, prev_prev, forcing, "mesh_embedder", process)

    return step
