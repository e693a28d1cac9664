"""Weights from the JAX package's parameter pytrees.

The JAX package keeps parameters as pytrees of MLPs,
``{"layers": [{"w": (in, out), "b": (out,)}, ...], "ln": {"scale", "bias"}
| None}``, nested under the model's submodule names: a list for the
processor, lists per level for the hierarchical embedders and init and
read-out GNNs, lists of lists (layer, then level) for HiLAM's sweep GNNs,
and under each GNN a list of MLPs per role, one MLP or one per chunk.
:func:`params_from_jax` maps such a pytree, with numpy leaves, onto the
reference's state-dict names in PyTorch's ``(out, in)`` layout, which are
the port's module names: ``g2m_gnn.edge_mlp.0.weight``,
``processor.module_0.aggr_mlp.3.bias``, ``mesh_embedders.1.0.weight``,
``mesh_init_gnns.0.edge_mlp.2.bias``, the nested
``mesh_down_gnns.<layer>.<level>.aggr_mlp.0.weight`` and, for
HiLAMParallel's per-chunk MLPs,
``processor.module_0.edge_mlp.mlps.<k>.0.weight``.
The mapping is the inverse of ``neural_lam_tpu.convert_checkpoint``'s
``convert_state_dict``, written here without importing that package.
:func:`params_to_numpy` and :func:`grads_to_numpy` are the view back: a
module's parameters, or their gradients, under the same names and in the
same layout as the JAX package's ``export_state_dict`` emits, so a test
compares the two dictionaries directly.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Iterator

import numpy as np
import torch


def _mlp_items(prefix: str, mlp: dict) -> Iterator[tuple[str, np.ndarray]]:
    layers = mlp["layers"]
    for i, layer in enumerate(layers):
        yield f"{prefix}.{2 * i}.weight", np.asarray(layer["w"]).T
        yield f"{prefix}.{2 * i}.bias", np.asarray(layer["b"])
    if mlp.get("ln") is not None:
        ln_idx = 2 * len(layers) - 1
        yield f"{prefix}.{ln_idx}.weight", np.asarray(mlp["ln"]["scale"])
        yield f"{prefix}.{ln_idx}.bias", np.asarray(mlp["ln"]["bias"])


def _gnn_items(prefix: str, gnn: dict) -> Iterator[tuple[str, np.ndarray]]:
    for role, name in (("edge", "edge_mlp"), ("aggr", "aggr_mlp")):
        mlps = gnn[role]
        if len(mlps) == 1:
            yield from _mlp_items(f"{prefix}.{name}", mlps[0])
        else:  # SplitMLPs: the chunk MLPs under ``.mlps.<k>``
            for k, mlp in enumerate(mlps):
                yield from _mlp_items(f"{prefix}.{name}.mlps.{k}", mlp)


def _items(name: str, sub: Any) -> Iterator[tuple[str, np.ndarray]]:
    if isinstance(sub, dict) and "layers" in sub:
        yield from _mlp_items(name, sub)
    elif isinstance(sub, dict) and "edge" in sub:
        yield from _gnn_items(name, sub)
    elif isinstance(sub, list) and name == "processor":
        for i, net in enumerate(sub):
            yield from _gnn_items(f"processor.module_{i}", net)
    elif isinstance(sub, list):
        for i, item in enumerate(sub):
            yield from _items(f"{name}.{i}", item)
    else:
        raise ValueError(f"Unrecognised parameter subtree {name!r}")


def params_from_jax(params_np: dict) -> dict[str, torch.Tensor]:
    """State dict (reference key names, ``(out, in)`` weights, float32)
    for a JAX-package parameter pytree with numpy leaves."""
    return {
        key: torch.from_numpy(np.array(arr, dtype=np.float32))
        for name, sub in params_np.items()
        for key, arr in _items(name, sub)
    }


def params_to_numpy(module: torch.nn.Module) -> dict[str, np.ndarray]:
    """The module's parameters as numpy arrays under their state-dict
    names (``(out, in)`` weights)."""
    return {
        name: p.detach().cpu().numpy().copy()
        for name, p in module.named_parameters()
    }


def grads_to_numpy(module: torch.nn.Module) -> dict[str, np.ndarray]:
    """The ``.grad`` of every parameter, named and laid out as in
    :func:`params_to_numpy`. A parameter without a gradient raises: after
    a backward through the whole model every parameter has one."""
    out = {}
    for name, p in module.named_parameters():
        if p.grad is None:
            raise ValueError(f"parameter {name} has no gradient")
        out[name] = p.grad.detach().cpu().numpy().copy()
    return out


def load_jax_params_npz(path: str | Path) -> dict:
    """Parameter pytree from an ``.npz`` whose keys are the pytree paths
    joined by ``/`` (``g2m_gnn/edge/0/layers/1/w``); integer path
    elements index lists, and an MLP stored without ``ln`` entries has
    no LayerNorm."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            *path_parts, leaf = key.split("/")
            node = tree
            for part in path_parts:
                node = node.setdefault(part, {})
            node[leaf] = data[key]
    return _restore_lists(tree)


def _restore_lists(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    node = {k: _restore_lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    if "layers" in node:
        node.setdefault("ln", None)
    return node
