"""Hi-LAM (Oskarsson, Landelius & Lindsten 2023): the sequential
hierarchical processor. Its parameters by the reference's state-dict
names, its GNN applications and their operation counts, and its plain
one-step reference (``graph/hierarchical.py:15-318``,
``graph/hi_lam.py:16-360``)."""

from __future__ import annotations

from . import counts
from .graph_lam import base_macs, base_spec
from .plain import batched, encode_decode, gnn_spec, interaction, mlp, mlp_spec

PORT_CLASS = "HiLAM"


def param_specs(cfg: dict, sizes: dict) -> list:
    d, hl, levels = cfg["hidden_dim"], cfg["hidden_layers"], sizes["levels"]
    end = [d] * (hl + 1)
    f, mf = sizes["edge_features"], sizes["mesh_features"]
    out = base_spec(cfg, sizes)
    for name, width, n in (("mesh_embedders", mf, levels), ("mesh_same_embedders", f, levels),
                           ("mesh_up_embedders", f, levels - 1),
                           ("mesh_down_embedders", f, levels - 1)):
        for i in range(n):
            out += mlp_spec(f"{name}.{i}", [width] + end)
    for name in ("mesh_init_gnns", "mesh_read_gnns"):
        for i in range(levels - 1):
            out += gnn_spec(f"{name}.{i}", d, hl)
    for layer in range(cfg["processor_layers"]):
        for name, n in (("mesh_down_gnns", levels - 1), ("mesh_down_same_gnns", levels),
                        ("mesh_up_gnns", levels - 1), ("mesh_up_same_gnns", levels)):
            for i in range(n):
                out += gnn_spec(f"{name}.{layer}.{i}", d, hl)
    return out


def applications(cfg: dict, sizes: dict) -> list[dict]:
    """The GNN applications of one step, in order: g2m, the upward init
    sweep, per processor layer a down and an up sweep, the downward
    read-out, m2g. An edge set's representation is shared over the batch
    until its first update."""
    n_grid, levels, mesh = cfg["grid_x"] * cfg["grid_y"], sizes["levels"], sizes["mesh"]
    mode: dict[str, str] = {}
    apps = [counts.app("g2m", sizes["g2m"], n_grid, mesh[0], "raw", False)]

    def use(kind: str, lv: int, send: int, rec: int, update: bool = True) -> None:
        key = f"{kind}{lv}"
        edges = sizes[kind][lv]
        apps.append(counts.app(f"{key} {len(apps)}", edges, mesh[send], mesh[rec],
                               mode.get(key, "shared"), update))
        if update:
            mode[key] = "batched"

    for lv in range(1, levels):
        use("up", lv - 1, lv - 1, lv)
    for _ in range(cfg["processor_layers"]):
        use("m2m", levels - 1, levels - 1, levels - 1)
        for lv in range(levels - 2, -1, -1):
            use("down", lv, lv + 1, lv)
            use("m2m", lv, lv, lv)
        use("m2m", 0, 0, 0)
        for lv in range(1, levels):
            use("up", lv - 1, lv - 1, lv)
            use("m2m", lv, lv, lv)
    for lv in range(levels - 2, -1, -1):
        use("down", lv, lv + 1, lv, update=False)
    apps.append(counts.app("m2g", sizes["m2g"], mesh[0], n_grid, "raw", False))
    return counts.mark_used_edges(apps)


def step_flops(cfg: dict, sizes: dict, batch: int) -> float:
    d, hl, levels = cfg["hidden_dim"], cfg["hidden_layers"], sizes["levels"]
    end = [d] * (hl + 1)
    once, sample = base_macs(cfg, sizes)
    emb = counts.mlp_macs([sizes["edge_features"]] + end)
    once += sum(sizes["mesh"]) * counts.mlp_macs([sizes["mesh_features"]] + end)
    once += (sum(sizes["m2m"]) + sum(sizes["up"]) + sum(sizes["down"])) * emb
    return counts.step_flops(applications(cfg, sizes), once, sample, batch, d, hl)


def make_step(p: dict, g: dict, stats: dict, cfg: dict):
    """The plain one-step predictor ``step(prev, prev_prev, forcing)``."""
    levels = g["levels"]

    def process(mesh_rep):
        b = mesh_rep.shape[0]
        reps = [mesh_rep] + [batched(mlp(p, f"mesh_embedders.{lv}", g["mesh"][lv]), b)
                             for lv in range(1, levels)]
        same = [mlp(p, f"mesh_same_embedders.{lv}", g["m2m"][lv][2]) for lv in range(levels)]
        up = [mlp(p, f"mesh_up_embedders.{lv}", g["up"][lv][2]) for lv in range(levels - 1)]
        down = [mlp(p, f"mesh_down_embedders.{lv}", g["down"][lv][2])
                for lv in range(levels - 1)]

        def same_level(prefix, lv, rep):
            reps[lv], same[lv] = interaction(p, prefix, g["m2m"][lv], rep, rep, same[lv])

        for lv in range(1, levels):
            reps[lv], up[lv - 1] = interaction(p, f"mesh_init_gnns.{lv - 1}", g["up"][lv - 1],
                                               reps[lv - 1], reps[lv], up[lv - 1])
        for k in range(cfg["processor_layers"]):
            top = levels - 1
            same_level(f"mesh_down_same_gnns.{k}.{top}", top, reps[top])
            for lv in range(levels - 2, -1, -1):
                new, down[lv] = interaction(p, f"mesh_down_gnns.{k}.{lv}", g["down"][lv],
                                            reps[lv + 1], reps[lv], down[lv])
                same_level(f"mesh_down_same_gnns.{k}.{lv}", lv, new)
            same_level(f"mesh_up_same_gnns.{k}.0", 0, reps[0])
            for lv in range(1, levels):
                new, up[lv - 1] = interaction(p, f"mesh_up_gnns.{k}.{lv - 1}", g["up"][lv - 1],
                                              reps[lv - 1], reps[lv], up[lv - 1])
                same_level(f"mesh_up_same_gnns.{k}.{lv}", lv, new)
        for lv in range(levels - 2, -1, -1):
            reps[lv], _ = interaction(p, f"mesh_read_gnns.{lv}", g["down"][lv], reps[lv + 1],
                                      reps[lv], down[lv])
        return reps[0]

    def step(prev, prev_prev, forcing):
        return encode_decode(p, g, stats, prev, prev_prev, forcing, "mesh_embedders.0", process)

    return step
