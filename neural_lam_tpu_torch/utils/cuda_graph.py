"""Inference as CUDA graphs: the port's counterpart of ``jax.jit`` on
the forecast (``neural_lam_tpu/predict.py:118-126``), the validation
step (``neural_lam_tpu/trainer.py:532-583``) and the test evaluation's
batch (``neural_lam_tpu/evaluation.py:84-121``).

:class:`CapturedFunction` wraps a function of tensors that reads an
``nn.Module`` and updates nothing. On CUDA the first call for a set of
input shapes and a route (``fused_kernels.route_env``) runs the function
once eagerly on a side stream (kernel builds, launch attributes, the
libraries' workspaces: all that happens only on a first call) and then
captures it as one CUDA graph over static input buffers. Every call, the
first included, copies its inputs into those buffers, replays the graph
and returns clones of its outputs, so that what the caller holds is
never overwritten by a later replay. The graphs are dropped and captured
again when a parameter or buffer of the module is replaced rather than
updated in place (``load_state_dict`` copies in place and keeps them).
A capture that fails raises: there is no eager fallback.

This is the mechanism of ``Trainer.make_train_step`` without its
optimizer: the same side stream, ``capture_error_mode="thread_local"``
(a prefetch thread may pin and copy while this thread captures) and a
memory pool of the wrapper's own. The function runs under
``torch.no_grad()``, on CPU tensors as well, where it is called eagerly.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable

import torch
from torch import nn

from ..ops.fused_kernels import route_env
from .device import resolve_device


def map_tensors(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``fn`` applied to every tensor of a tree of tuples, lists and
    dicts; anything else (``None``, numbers) is kept as it is."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tensors(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    return tree


@dataclasses.dataclass
class CapturedCall:
    """One captured call: the graph, the static inputs it reads, the
    outputs it writes and how often it was replayed."""

    graph: "torch.cuda.CUDAGraph"
    inputs: tuple[torch.Tensor, ...]
    outputs: Any
    replays: int = 0


class CapturedFunction:
    """``fn(*inputs)`` as one CUDA graph per input shapes and route; see
    the module's docstring. ``graphs`` holds the captured calls by
    ``(route, shapes and dtypes)``. With ``eager`` it calls ``fn`` under
    ``no_grad`` on the card too (a function whose collectives go through
    gloo, which a graph cannot hold)."""

    def __init__(
        self,
        fn: Callable[..., Any],
        module: nn.Module,
        device: str | torch.device = "cuda",
        eager: bool = False,
    ) -> None:
        self.fn = fn
        self.module = module
        self.device = resolve_device(device)
        self.eager = eager
        self.graphs: dict[tuple, CapturedCall] = {}
        self._state: tuple = ()
        self._pool = None
        self._stream = None

    def _fingerprint(self) -> tuple:
        return tuple(
            t.data_ptr()
            for t in itertools.chain(self.module.parameters(), self.module.buffers())
        )

    def __call__(self, *inputs: torch.Tensor) -> Any:
        if self.device.type != "cuda" or self.eager:
            with torch.no_grad():
                return self.fn(*inputs)
        if self._fingerprint() != self._state:
            self.graphs.clear()
        key = (route_env(), tuple((tuple(a.shape), a.dtype) for a in inputs))
        entry = self.graphs.get(key)
        if entry is None:
            entry = self.graphs[key] = self._capture(inputs)
            self._state = self._fingerprint()
        for static, a in zip(entry.inputs, inputs):
            static.copy_(a)
        entry.graph.replay()
        entry.replays += 1
        return map_tensors(torch.clone, entry.outputs)

    def _capture(self, inputs: tuple[torch.Tensor, ...]) -> CapturedCall:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        stream = self._stream
        current = torch.cuda.current_stream(self.device)
        static = tuple(a.to(self.device).clone() for a in inputs)
        stream.wait_stream(current)
        # the outer context restores the caller's stream even when the
        # capture raises (torch.cuda.graph then skips its own restore)
        with torch.cuda.stream(stream), torch.no_grad():
            self.fn(*static)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(
                graph, pool=self._pool, stream=stream,
                capture_error_mode="thread_local",
            ):
                outputs = self.fn(*static)
        current.wait_stream(stream)
        return CapturedCall(graph, static, outputs)
