"""AdamW over one flat parameter buffer, with its moments sharded over
the ranks of a process group (ZeRO-1).

:class:`FlatAdamW` is the optimizer of data-parallel training
(``TrainingArgs.shard_opt_state``, ``neural_lam_tpu/trainer.py:69-72``,
``:606-639``) and of ``--flat_opt`` (the counterpart of
``optax.flatten``, ``neural_lam_tpu/trainer.py:73-82``, ``:123-137``):

- every parameter becomes a view of one float32 buffer, ``flat``, at an
  offset aligned to ``ALIGN`` values (the kernels take 16-byte aligned
  weights), the buffer padded to a multiple of the rank count; a step
  copies the gradients into a buffer of the same layout,
  ``grad_buffer``, whose last entry carries the loss;
- over a process group one all-reduce sums that buffer, which is then
  divided by the rank count: the gradient of the mean over the global
  batch, and the loss every rank reports (XLA inserts the same
  all-reduce into the JAX package's step); after it each parameter's
  ``.grad`` is its view of the buffer, the same on every rank;
- ``torch.optim.AdamW`` updates ``shard``: the whole buffer, or with
  ``shard=True`` this rank's contiguous ``1/P`` of it, whose moments are
  all this rank keeps; an all-gather then brings every rank's updated
  part into ``flat``.

Every step is a fixed sequence of kernels and NCCL collectives on fixed
buffers, so it is captured in the trainer's CUDA graph with the rest of
the step. AdamW is elementwise: the flat and the sharded updates are
those of the per-tensor AdamW.

``state_dict`` gathers the full moments (a collective: every rank calls
it) and gives them per parameter, as ``torch.optim.AdamW`` over the
parameters does, or with ``flat_layout`` as one vector in the parameters'
order (back to back, without the alignment gaps); ``load_state_dict``
takes either and keeps this rank's part. A checkpoint is therefore the
same file at any rank count and restores at any other.
"""

from __future__ import annotations

from typing import Iterable

import torch

from .utils import distributed

# each parameter's offset in the flat buffer, in values: 256 bytes
ALIGN = 64


class FlatAdamW:
    """``torch.optim.AdamW(betas=(0.9, 0.95), eps=1e-8)`` over ``params``
    held in one flat buffer; see the module docstring. Over a process
    group the buffer is broadcast from rank 0 when the optimizer is made
    (as ``DistributedDataParallel`` does at construction), so every rank
    must make it."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 weight_decay: float = 0.01, flat_layout: bool = False,
                 shard: bool = False) -> None:
        self.params = list(params)
        lay = distributed.layout()
        self.world, self.rank = lay.world, lay.rank
        self.flat_layout = flat_layout
        self.sharded = shard and distributed.active()
        first = self.params[0]
        self.numel = sum(p.numel() for p in self.params)
        self.offsets, end = [], 0
        for p in self.params:
            self.offsets.append(end)
            end = -(-(end + p.numel()) // ALIGN) * ALIGN
        parts = self.world if self.sharded else 1
        self.padded = -(-end // parts) * parts
        kw = dict(dtype=first.dtype, device=first.device)
        self.flat = torch.zeros(self.padded, **kw)
        self.grad_buffer = torch.zeros(self.padded + 1, **kw)
        self._grad_views = []
        with torch.no_grad():
            for p, o in zip(self.params, self.offsets):
                view = self.flat[o:o + p.numel()].view_as(p)
                view.copy_(p)
                p.data = view
                self._grad_views.append(self.grad_buffer[o:o + p.numel()].view_as(p))
        distributed.broadcast_(self.flat)
        size = self.padded // parts
        lo = self.rank * size if self.sharded else 0
        self.shard = self.flat[lo:lo + size]
        self.shard.grad = self.grad_buffer[lo:lo + size]
        self._lo = lo
        self._send = torch.empty(size, **kw) if self.sharded else None
        self.inner = torch.optim.AdamW(
            [self.shard], lr=lr, betas=(0.9, 0.95), eps=1e-8, weight_decay=weight_decay,
            capturable=first.device.type == "cuda",
        )

    @property
    def param_groups(self) -> list[dict]:
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    def reduce_gradients(self, loss: torch.Tensor) -> torch.Tensor:
        """After ``loss.backward()``: the parameters' gradients into
        ``grad_buffer`` and, over a process group, their mean over the
        ranks (one all-reduce, the loss with them); each parameter's
        ``.grad`` is then its view of the buffer. Returns the loss, the
        mean over the ranks."""
        torch._foreach_copy_(
            self._grad_views,
            [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params],
        )
        if distributed.active():
            self.grad_buffer[-1:].copy_(loss.detach().reshape(1))
            distributed.all_reduce_(self.grad_buffer)
            self.grad_buffer.div_(self.world)
            loss = self.grad_buffer[-1].clone()
        for p, g in zip(self.params, self._grad_views):
            p.grad = g
        return loss

    def step(self) -> None:
        """AdamW on ``shard`` from its part of ``grad_buffer``; sharded,
        then every rank's part gathered into ``flat``."""
        self.inner.step()
        if self.sharded:
            self._send.copy_(self.shard)
            distributed.all_gather_into_(self.flat, self._send)

    # -- checkpoints ---------------------------------------------------------
    def _full(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Each parameter's part of a state tensor of ``shard``'s layout
        (gathered from every rank when sharded), shaped as the parameter."""
        if self.sharded:
            t = distributed.all_gather_into_(
                torch.empty(self.padded, dtype=t.dtype, device=t.device), t)
        return [t[o:o + p.numel()].view_as(p) for p, o in zip(self.params, self.offsets)]

    def state_dict(self) -> dict:
        """The full state (a collective when sharded): per parameter, as
        ``torch.optim.AdamW(params).state_dict()`` gives it, or with
        ``flat_layout`` one entry of ``numel`` values."""
        group = dict(self.inner.state_dict()["param_groups"][0])
        st = self.inner.state.get(self.shard)
        if self.flat_layout:
            group["params"] = [0]
        else:
            group["params"] = list(range(len(self.params)))
        if not st:
            return {"state": {}, "param_groups": [group]}
        moments = {k: self._full(st[k]) for k in ("exp_avg", "exp_avg_sq")}
        if self.flat_layout:
            state = {0: {"step": st["step"].clone(), **{
                k: torch.cat([t.reshape(-1) for t in m]) for k, m in moments.items()}}}
        else:
            state = {i: {"step": st["step"].clone(),
                         **{k: m[i].clone() for k, m in moments.items()}}
                     for i in range(len(self.params))}
        return {"state": state, "param_groups": [group]}

    def load_state_dict(self, state_dict: dict) -> None:
        """Load a full state in either layout (per parameter, or one flat
        entry) and keep this rank's part; the hyperparameters are the
        saved ones, as ``torch.optim.Optimizer.load_state_dict`` takes
        them."""
        from .checkpoint import load_optimizer_state

        (group,) = state_dict["param_groups"]
        ids, state = list(group["params"]), state_dict["state"]
        if len(ids) not in (1, len(self.params)):
            raise ValueError(f"optimizer state of {len(ids)} tensors for "
                             f"{len(self.params)} parameters")
        inner_state = {}
        if state:
            entries = [state[i] for i in ids]
            moments = {}
            for key in ("exp_avg", "exp_avg_sq"):
                full = torch.cat([e[key].reshape(-1).to(self.flat) for e in entries])
                if full.numel() != self.numel:
                    raise ValueError(f"optimizer state of {full.numel()} values for "
                                     f"{self.numel} parameters")
                padded, start = torch.zeros_like(self.flat), 0
                for p, o in zip(self.params, self.offsets):
                    padded[o:o + p.numel()] = full[start:start + p.numel()]
                    start += p.numel()
                moments[key] = padded[self._lo:self._lo + self.shard.numel()].clone()
            inner_state[0] = {"step": torch.as_tensor(entries[0]["step"]).clone(), **moments}
        load_optimizer_state(self.inner, {"state": inner_state,
                                          "param_groups": [dict(group, params=[0])]})
