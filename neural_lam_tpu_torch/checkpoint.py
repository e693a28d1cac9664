"""Checkpointing: best-val + latest-rescue, self-describing.

Counterpart of ``neural_lam_tpu/checkpoint.py``. A checkpoint is a
directory ``run_dir/checkpoints/<name>/`` holding

- ``state.pt``: ``torch.save`` of ``{"model": state_dict, "optimizer":
  optimizer.state_dict(), "step": int}``, where ``state_dict`` is the step
  predictor's parameters under the reference's names (the names
  ``convert_checkpoint`` reads and writes),
- ``hparams.json``: the CLI namespace with the clamping bounds, the same
  keys as the JAX package writes, so that either package's
  ``build_forecaster_from_hparams`` rebuilds the architecture from it
  (reference: neural_lam/train_model.py:41-72),

and ``best.json`` beside the checkpoints records the best validation
loss. Graph buffers and normalization stats stay out of checkpoints and
are reloaded from the datastore and the graph directory, as the
reference's ``persistent=False`` buffers are
(reference: models/step_predictors/graph/base.py:114-119).

The dual-checkpoint policy mirrors the reference's two callbacks
(reference: train_model.py:500-516): ``min_val_loss`` tracks the best
validation loss, ``latest`` is written every epoch as a crash rescue.

Over a process group (data parallelism) every rank calls ``save``, which
gathers the optimizer's full moments (``optim.FlatAdamW.state_dict``, the
counterpart of ``checkpoint._to_host``, ``neural_lam_tpu/checkpoint.py:29-46``);
rank 0 writes the files and every rank waits at a barrier after, so that
none reads a checkpoint half written (``:95-125``). The file is the one a
single process writes, and restores at any rank count: each rank reads it
and keeps its part of the moments.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional

import torch
from torch import nn

from .utils import distributed
from .utils.device import resolve_device

CHECKPOINT_NAMES = ("latest", "min_val_loss")


def resolve_load(path: str | Path) -> tuple[Path, str]:
    """``(run_dir, name)`` for a ``--load`` argument: a run directory, its
    ``checkpoints/`` directory, or one checkpoint
    (``.../checkpoints/{latest,min_val_loss}``). A run directory that is
    itself named ``latest`` holds its own ``checkpoints/``."""
    load_dir = Path(path)
    if load_dir.name in CHECKPOINT_NAMES and not (load_dir / "checkpoints").exists():
        name, root = load_dir.name, load_dir.parent
    else:
        name, root = "latest", load_dir
    if root.name == "checkpoints":
        root = root.parent
    return root, name


def load_optimizer_state(optimizer: torch.optim.Optimizer, state_dict: dict) -> None:
    """``optimizer.load_state_dict(state_dict)``, keeping the optimizer's
    own ``capturable`` setting: a state saved on the CPU and loaded into
    an optimizer over CUDA parameters would otherwise turn capture off
    and leave the step count on the host. The step count of a capturable
    optimizer ends up a float32 tensor beside its parameter. The state's
    tensors are replaced, so a captured training step captures again."""
    capturable = [g.get("capturable", False) for g in optimizer.param_groups]
    optimizer.load_state_dict(state_dict)
    for group, cap in zip(optimizer.param_groups, capturable):
        group["capturable"] = cap
        for p in group["params"]:
            state = optimizer.state.get(p, {})
            if "step" in state:
                device = p.device if cap else torch.device("cpu")
                state["step"] = state["step"].to(device=device, dtype=torch.float32)


class CheckpointManager:
    """Save and restore a model and its optimizer under
    ``run_dir/checkpoints``."""

    def __init__(self, run_dir: str | Path) -> None:
        self.ckpt_dir = Path(run_dir) / "checkpoints"
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        # Resuming into an existing run dir must not clobber a better
        # historical min_val_loss checkpoint (Lightning restores
        # best_model_score across resume; it is kept in best.json).
        self.best_val_loss = float("inf")
        best_path = self.ckpt_dir / "best.json"
        if best_path.exists():
            try:
                self.best_val_loss = float(
                    json.loads(best_path.read_text(encoding="utf-8"))["val_loss"]
                )
            except (ValueError, KeyError, TypeError, json.JSONDecodeError):
                pass

    def _path(self, name: str) -> Path:
        return self.ckpt_dir / name

    def save(
        self,
        name: str,
        model: nn.Module,
        optimizer: torch.optim.Optimizer,
        step: int,
        hparams: Optional[dict] = None,
    ) -> None:
        """Write one named checkpoint, replacing an earlier one of that
        name; ``state.pt`` is written to a temporary file first and
        renamed, so a reader never sees half of it. Over a process group
        every rank calls it (the optimizer's state is gathered), rank 0
        writes, and all wait for the write."""
        state = {
            # a parameter that is a view of the optimizer's flat buffer is
            # saved as a tensor of its own, as without the buffer
            "model": {k: _own_storage(v) for k, v in model.state_dict().items()},
            "optimizer": optimizer.state_dict(),
            "step": int(step),
        }
        if distributed.rank() == 0:
            path = self._path(name)
            path.mkdir(parents=True, exist_ok=True)
            tmp = path / "state.pt.tmp"
            torch.save(state, tmp)
            os.replace(tmp, path / "state.pt")
            if hparams is not None:
                (path / "hparams.json").write_text(
                    json.dumps(hparams, indent=2, default=str), encoding="utf-8"
                )
        distributed.barrier()

    def save_latest(self, model, optimizer, step, hparams=None) -> None:
        self.save("latest", model, optimizer, step, hparams)

    def maybe_save_best(
        self, val_loss: float, model, optimizer, step, hparams=None
    ) -> bool:
        """Save as ``min_val_loss`` iff this is the best validation loss
        (the same on every rank: ``evaluate`` merges the ranks' sums)."""
        if val_loss < self.best_val_loss:
            self.best_val_loss = val_loss
            self.save("min_val_loss", model, optimizer, step, hparams)
            if distributed.rank() == 0:
                (self.ckpt_dir / "best.json").write_text(
                    json.dumps({"val_loss": val_loss, "step": step}), encoding="utf-8"
                )
            return True
        return False

    def _state_file(self, name: str) -> Path:
        path = self._path(name) / "state.pt"
        if not path.exists():
            raise FileNotFoundError(f"No checkpoint at {self._path(name)}")
        return path

    def restore(
        self, name: str, model: nn.Module, optimizer: torch.optim.Optimizer
    ) -> int:
        """Load parameters into ``model`` and the optimizer's state into
        ``optimizer``, both in place, on the device they live on; returns
        the saved step."""
        device = next(model.parameters()).device
        state = torch.load(
            self._state_file(name), map_location=device, weights_only=True
        )
        _check_keys(model, state["model"])
        model.load_state_dict(state["model"], strict=True)
        load_optimizer_state(optimizer, state["optimizer"])
        return int(state["step"])

    def restore_params_only(self, name: str, model: nn.Module) -> None:
        """Load only the parameters into ``model``, in place (a fresh
        optimizer: the reference's default unless ``--restore_opt``,
        reference: module.py:1012-1014). The file is memory-mapped and
        only ``"model"`` is read: the optimizer's moments (twice the
        parameters) are never deserialised."""
        state = torch.load(
            self._state_file(name), map_location="cpu", weights_only=True, mmap=True
        )
        _check_keys(model, state["model"])
        model.load_state_dict(state["model"], strict=True)

    def load_hparams(self, name: str) -> Optional[dict]:
        path = self._path(name) / "hparams.json"
        if not path.exists():
            return None
        return json.loads(path.read_text(encoding="utf-8"))


def _own_storage(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when it views a larger storage."""
    if t.untyped_storage().nbytes() > t.numel() * t.element_size():
        return t.clone()
    return t


def _check_keys(model: nn.Module, state_dict: dict) -> None:
    """A readable error when the checkpoint's parameters are not the
    model's, before ``load_state_dict`` would raise its own."""
    want, have = set(model.state_dict()), set(state_dict)
    if want != have:
        raise ValueError(
            f"Checkpoint params mismatch: missing {sorted(want - have)}, "
            f"unexpected {sorted(have - want)}"
        )


_ARCH_KEYS = (
    "graph",
    "hidden_dim",
    "hidden_layers",
    "processor_layers",
    "mesh_aggr",
    "num_past_forcing_steps",
    "num_future_forcing_steps",
    "output_std",
    "g2m_gnn_type",
    "m2g_gnn_type",
    "mesh_up_gnn_type",
    "mesh_down_gnn_type",
    # from the YAML config (train_model records them into hparams):
    # omitting them would rebuild an UNCLAMPED model from a clamped
    # checkpoint (reference applies clamping in every forward,
    # step_predictors/base.py:168-383)
    "output_clamping_lower",
    "output_clamping_upper",
)


def build_forecaster_from_hparams(
    hparams: dict, datastore, device: str | torch.device = "cuda"
):
    """The forecaster architecture that ``hparams`` describes, on
    ``device``, with freshly drawn parameters (``hparams["seed"]`` when
    present). Only the datastore is re-injected — the same contract as the
    reference (reference: neural_lam/train_model.py:41-72,
    models/module.py:119-124)."""
    from .models import MODELS, ARForecaster

    model_name = hparams["model"]
    kwargs = {}
    for key in _ARCH_KEYS:
        if key in hparams:
            kwargs["graph_name" if key == "graph" else key] = hparams[key]
    if model_name == "graph_lam":
        kwargs.pop("mesh_up_gnn_type", None)
        kwargs.pop("mesh_down_gnn_type", None)
    predictor = MODELS[model_name](
        datastore, seed=int(hparams.get("seed", 0)), device=resolve_device(device),
        **kwargs,
    )
    return ARForecaster(predictor, datastore)


def load_forecaster_from_checkpoint(
    run_dir: str | Path,
    datastore,
    name: str = "latest",
    device: str | torch.device = "cuda",
):
    """Rebuild the forecaster from a run directory alone, its parameters
    loaded from checkpoint ``name``; returns ``(forecaster, hparams)``."""
    mgr = CheckpointManager(run_dir)
    hparams = mgr.load_hparams(name)
    if hparams is None:
        raise FileNotFoundError(
            f"No hparams.json in checkpoint {name!r} under {run_dir}; "
            "cannot reconstruct the architecture"
        )
    forecaster = build_forecaster_from_hparams(hparams, datastore, device)
    mgr.restore_params_only(name, forecaster.predictor)
    return forecaster, hparams
