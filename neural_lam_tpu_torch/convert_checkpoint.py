"""Checkpoint conversion: reference checkpoints, and weights and optimizer
state from the JAX package's pytrees.

The port's module names are the reference's state-dict names, so a
reference (Lightning) checkpoint converts nearly as it is:
:func:`convert_state_dict` strips the Lightning prefixes and applies the
legacy ``g2m_gnn.grid_mlp`` rename (reference: module.py:974-1010), and
:func:`main` turns a ``.ckpt`` file into a port checkpoint directory::

    python -m neural_lam_tpu_torch.convert_checkpoint \
        --ckpt path/to/min_val_loss.ckpt --config_path config.yaml \
        --model graph_lam --graph multiscale --out runs/converted

:func:`export_state_dict` is the way back, the reference's names with
numpy values. :func:`opt_state_from_jax` carries the JAX package's AdamW
moments and step count into the port's optimizer, also from the one flat
vector of ``--flat_opt`` (``optax.flatten``), whose order is
``ravel_pytree``'s and not the port's (:func:`unravel_like`).

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

import argparse
from pathlib import Path
from typing import Any, Iterator

import numpy as np
import torch
from torch import nn


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


def unravel_like(template: Any, flat) -> Any:
    """``flat``, a vector in ``ravel_pytree(template)``'s order (each leaf
    raveled, leaves in ``jax.tree_util`` order), as a pytree shaped like
    ``template``: the inverse of the flattening of ``optax.flatten``."""
    flat = np.asarray(flat)
    offset = 0

    def build(node):
        nonlocal offset
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(item) for item in node]
        shape = np.shape(node)
        size = int(np.prod(shape))
        out = flat[offset:offset + size].reshape(shape)
        offset += size
        return out

    tree = build(template)
    if offset != flat.size:
        raise ValueError(f"flat vector of {flat.size} values for a pytree of {offset}")
    return tree


def opt_state_from_jax(
    mu, nu, count, optimizer, model: nn.Module, template: Any = None
) -> None:
    """Load the JAX package's AdamW state into ``optimizer``, in place:
    optax's first and second moments ``mu`` and ``nu`` (numpy pytrees
    shaped like the parameters) become each parameter's ``exp_avg`` and
    ``exp_avg_sq``, and its step ``count`` the ``step``. ``model`` names
    the optimizer's parameters (its ``named_parameters``). Under
    ``--flat_opt`` (``optax.flatten``) ``mu`` and ``nu`` are flat vectors
    in ``ravel_pytree``'s order: ``template``, the JAX parameter pytree
    (numpy leaves), gives their layout. optax's ``adamw`` and torch's
    ``AdamW`` keep the same moments and bias corrections, so the next
    steps go on as the JAX package's would. ``optimizer`` is a
    ``torch.optim.AdamW`` over the model's parameters or an
    ``optim.FlatAdamW`` (either layout)."""
    from .checkpoint import load_optimizer_state

    if not isinstance(mu, dict):
        if template is None:
            raise ValueError("flat AdamW moments need the parameter pytree as template")
        mu, nu = unravel_like(template, mu), unravel_like(template, nu)
    names = {id(p): name for name, p in model.named_parameters()}
    # the per-parameter layout, in the optimizer's order of the parameters
    params = getattr(optimizer, "params", None) or [
        p for group in optimizer.param_groups for p in group["params"]]
    exp_avg, exp_avg_sq = params_from_jax(mu), params_from_jax(nu)
    state = {}
    for index, p in enumerate(params):
        name = names[id(p)]
        state[index] = {
            "step": torch.tensor(float(np.asarray(count)), dtype=torch.float32),
            "exp_avg": exp_avg[name].to(p.device),
            "exp_avg_sq": exp_avg_sq[name].to(p.device),
        }
    (group,) = optimizer.param_groups
    group = {k: v for k, v in group.items() if k != "params"}
    group["params"] = list(range(len(params)))
    load_optimizer_state(optimizer, {"state": state, "param_groups": [group]})


def convert_state_dict(
    state_dict: dict, template: dict, strict: bool = True
) -> dict[str, torch.Tensor]:
    """A reference ``state_dict`` as the port's: Lightning prefixes
    stripped, the legacy ``g2m_gnn.grid_mlp`` keys renamed to
    ``encoding_grid_mlp``, ``processor.<i>`` to ``processor.module_<i>``,
    float32 tensors. ``template`` (a model's ``state_dict()``) gives the
    keys and shapes: a shape that differs raises ``ValueError``, a missing
    key ``KeyError`` (with ``strict=False`` the template's value stays)."""
    cleaned = {}
    for key, tensor in state_dict.items():
        for prefix in ("forecaster.predictor.", "predictor.", "model."):
            if key.startswith(prefix):
                key = key[len(prefix):]
                break
        if key.startswith("g2m_gnn.grid_mlp."):
            key = "encoding_grid_mlp." + key[len("g2m_gnn.grid_mlp."):]
        parts = key.split(".")
        if parts[0] == "processor" and parts[1].isdigit():
            key = ".".join(["processor", f"module_{parts[1]}", *parts[2:]])
        cleaned[key] = torch.as_tensor(
            tensor.detach().cpu() if hasattr(tensor, "detach") else np.asarray(tensor),
            dtype=torch.float32,
        )
    out, missing = {}, []
    for key, want in template.items():
        if key not in cleaned:
            missing.append(key)
            out[key] = want
            continue
        if tuple(cleaned[key].shape) != tuple(want.shape):
            raise ValueError(
                f"Shape mismatch for {key}: checkpoint "
                f"{tuple(cleaned[key].shape)} vs model {tuple(want.shape)}"
            )
        out[key] = cleaned[key]
    if missing and strict:
        raise KeyError(f"Missing {len(missing)} keys in checkpoint, e.g. {missing[:5]}")
    return out


def export_state_dict(model: nn.Module) -> dict[str, np.ndarray]:
    """The model's parameters as a reference-style ``state_dict`` of numpy
    arrays (``(out, in)`` weights), as the JAX package's
    ``export_state_dict`` gives them: for round trips and for moving
    weights back to the reference."""
    return params_to_numpy(model)


def main(argv=None, device: str | torch.device = "cuda") -> None:
    """Convert a reference Lightning checkpoint into a port checkpoint
    directory (``<out>/checkpoints/latest``), building the model on
    ``device``."""
    from .checkpoint import CheckpointManager, build_forecaster_from_hparams
    from .config import load_config_and_datastore
    from .trainer import make_optimizer
    from .utils.device import resolve_device

    parser = argparse.ArgumentParser(
        description="Convert a reference Lightning checkpoint"
    )
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--model", type=str, default="graph_lam")
    parser.add_argument("--graph", type=str, default="multiscale")
    parser.add_argument("--hidden_dim", type=int, default=64)
    parser.add_argument("--hidden_layers", type=int, default=1)
    parser.add_argument("--processor_layers", type=int, default=4)
    # The optimizer the checkpoint is saved with: fresh, with the
    # trainer's settings (reference optimizer: models/module.py:284-287)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--weight_decay", type=float, default=0.01)
    parser.add_argument("--flat_opt", action="store_true")
    parser.add_argument("--out", type=str, required=True)
    args = parser.parse_args(argv)
    device = resolve_device(device)

    # a Lightning file pickles more than tensors (its hyper_parameters)
    ckpt = torch.load(args.ckpt, map_location="cpu", weights_only=False)
    state_dict = ckpt.get("state_dict", ckpt)

    _, datastore = load_config_and_datastore(args.config_path)
    hparams = vars(args) | {"mesh_aggr": "sum", "output_std": False}
    forecaster = build_forecaster_from_hparams(hparams, datastore, device)
    model = forecaster.predictor
    model.load_state_dict(convert_state_dict(state_dict, model.state_dict()), strict=True)
    # the state's layout follows --flat_opt, which hparams records
    optimizer = make_optimizer(model.parameters(), args.lr, args.weight_decay,
                               flat_opt=args.flat_opt)
    CheckpointManager(args.out).save_latest(model, optimizer, step=0, hparams=hparams)
    print(f"Converted checkpoint written to {args.out}/checkpoints/latest")


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


if __name__ == "__main__":
    main()
