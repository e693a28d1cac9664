"""Interaction/Propagation network message passing.

Counterpart of ``neural_lam_tpu/ops/interaction.py``. Behavioural spec
from the reference ``InteractionNet`` / ``PropagationNet``
(reference: neural_lam/gnn_layers.py:15-250):

- message  = edge_mlp(concat(edge_attr, x_sender, x_receiver))
             (+ x_sender residual for the propagation variant)
- aggregate to the receiver node set, sum or mean
- node update = aggr_mlp(concat(rec_rep, aggregated))
- receiver residual: rec_rep (interaction) or aggregated (propagation)
- optional edge residual update: edge_rep + message

Edge sets are receiver-sorted CSR (``rowptr``) with no padding or dead
slots. Node arrays are node-major, ``(N, B, D)`` batched or ``(N, D)``.

The edge phase (gather, edge MLP, sum into the receivers, optional edge
residual) has two routes. The fused route is one kernel, K3 (K4
backward), behind K1, and serves the two-layer edge MLP of
``hidden_layers=1``. Where ``fused_kernels.fused_v2_routed`` says so
(``NEURAL_LAM_TPU_FUSED_V2``; at MEPS only with ``on``), an
interaction-wired fused phase takes its v2 form instead: the first
layer's sender and receiver products once per node, then K7 with the
sender gather inside (K8 and K2 backward), and no K1. The unfused route
serves every other edge MLP: K1 and K6 gather the sender and receiver
rows, the MLP runs as plain ``torch`` matmuls (the JAX package computes
it outside any Pallas kernel too) and K5 sums the messages.
``NEURAL_LAM_TPU_FUSED=off`` sends every phase to the unfused route, as in
the JAX package.

The node update after the edge phase runs with ``torch`` on the
aggregate, or, under ``NEURAL_LAM_TPU_FUSED_AGGR=on`` on the fused (not
v2) route of an interaction-wired step with sum aggregation and one
two-layer node MLP, inside K3 as its epilogue (the node MLP's backward
before K4), where the JAX package runs it inside its kernel
(neural_lam_tpu/ops/interaction.py:654-679).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from . import fused_kernels
from .fused_kernels import aggr_fusable, embedder_fusable, fusable
from .mlp import SplitMLPs, apply_mlp_split_first, linear_layers, make_mlps
from .segment import (
    aggregate_sum,
    gather_receivers,
    gather_senders,
    mean_divisor,
)


@dataclasses.dataclass(frozen=True)
class EdgeSet:
    """Receiver-sorted edge connectivity (CSR).

    Edge ``e`` of the sorted order runs from ``senders[e]`` to
    ``receivers[e]``; the edges into receiver ``r`` are
    ``rowptr[r]:rowptr[r + 1]``. ``send_perm`` and ``send_rowptr`` are
    the sender-sorted view of the same edges, which the sender scatter
    (K2, the backward of the sender gather) walks: ``send_perm`` lists
    the edge positions ordered by sender (stable, so ascending within a
    sender) and the edges out of sender ``s`` are
    ``send_perm[send_rowptr[s]:send_rowptr[s + 1]]``. The table covers
    ``num_send`` senders, or ``senders.max() + 1`` when that is unknown.
    """

    senders: torch.Tensor  # (E,) int32
    receivers: torch.Tensor  # (E,) int64, non-decreasing
    rowptr: torch.Tensor  # (num_rec + 1,) int32
    recv_counts: torch.Tensor  # (num_rec,) int64
    send_perm: torch.Tensor  # (E,) int32
    send_rowptr: torch.Tensor  # (senders in the table + 1,) int32
    num_rec: int
    num_send: Optional[int] = None

    @property
    def num_edges(self) -> int:
        return int(self.senders.shape[0])

    def to(self, device: torch.device) -> "EdgeSet":
        move = lambda t: t.to(device)  # noqa: E731
        return dataclasses.replace(
            self,
            senders=move(self.senders),
            receivers=move(self.receivers),
            rowptr=move(self.rowptr),
            recv_counts=move(self.recv_counts),
            send_perm=move(self.send_perm),
            send_rowptr=move(self.send_rowptr),
        )


def make_edge_set(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_rec: Optional[int] = None,
    num_send: Optional[int] = None,
) -> tuple[EdgeSet, np.ndarray]:
    """Build a receiver-sorted :class:`EdgeSet` from raw edge indices.

    Returns the edge set and ``perm``, the ``(E,)`` map from sorted
    position to original edge index (apply it to per-edge features with
    :func:`place_edge_features`). The sort is stable, so edges into one
    receiver keep their original order. ``num_rec`` defaults to
    ``receivers.max() + 1`` (reference: neural_lam/gnn_layers.py:74).
    """
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    if senders.shape != receivers.shape or senders.ndim != 1:
        raise ValueError("senders and receivers must be equal-length vectors")
    if num_rec is None:
        num_rec = int(receivers.max()) + 1 if receivers.size else 0
    if receivers.size and (receivers.min() < 0 or receivers.max() >= num_rec):
        raise ValueError(f"receiver index outside [0, {num_rec})")
    if senders.size and senders.min() < 0:
        raise ValueError("negative sender index")
    if num_send is not None and senders.size and senders.max() >= num_send:
        raise ValueError(f"sender index outside [0, {num_send})")
    perm = np.argsort(receivers, kind="stable")
    counts = np.bincount(receivers, minlength=num_rec)
    rowptr = np.concatenate([[0], np.cumsum(counts)])
    if rowptr[-1] >= 2**31:
        raise ValueError("edge set too large for int32 offsets")
    sorted_senders = senders[perm]
    n_tab = num_send
    if n_tab is None:
        n_tab = int(senders.max()) + 1 if senders.size else 0
    send_rowptr = np.concatenate(
        [[0], np.cumsum(np.bincount(sorted_senders, minlength=n_tab))]
    )
    es = EdgeSet(
        senders=torch.from_numpy(sorted_senders.astype(np.int32)),
        receivers=torch.from_numpy(receivers[perm]),
        rowptr=torch.from_numpy(rowptr.astype(np.int32)),
        recv_counts=torch.from_numpy(counts.astype(np.int64)),
        send_perm=torch.from_numpy(
            np.argsort(sorted_senders, kind="stable").astype(np.int32)
        ),
        send_rowptr=torch.from_numpy(send_rowptr.astype(np.int32)),
        num_rec=int(num_rec),
        num_send=num_send,
    )
    return es, perm


def place_edge_features(features: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Original-order per-edge features in the edge set's sorted order."""
    return np.asarray(features)[perm]


class InteractionNet(nn.Module):
    """Parameters of one GNN step: ``edge_mlp`` over ``3 * input_dim``
    (edge, sender, receiver) and ``aggr_mlp`` over ``2 * input_dim``
    (receiver, aggregated) (reference: neural_lam/gnn_layers.py:90-107).
    With ``num_edge_chunks`` / ``num_aggr_chunks`` above 1 the MLP is a
    :class:`~neural_lam_tpu_torch.ops.mlp.SplitMLPs` with one MLP per
    chunk of the edge / receiver axis under ``edge_mlp.mlps.<k>`` /
    ``aggr_mlp.mlps.<k>`` (HiLAMParallel's per-section edge MLPs and
    per-level node MLPs). Applied with :func:`apply_interaction_net`."""

    def __init__(
        self,
        input_dim: int,
        hidden_layers: int = 1,
        hidden_dim: Optional[int] = None,
        num_edge_chunks: int = 1,
        num_aggr_chunks: int = 1,
        generator: Optional[torch.Generator] = None,
        device: Optional[torch.device] = None,
    ) -> None:
        super().__init__()
        hidden_dim = hidden_dim or input_dim
        tail = [hidden_dim] * (hidden_layers + 1)
        self.edge_mlp = make_mlps(
            [3 * input_dim] + tail, num_edge_chunks, generator=generator,
            device=device,
        )
        self.aggr_mlp = make_mlps(
            [2 * input_dim] + tail, num_aggr_chunks, generator=generator,
            device=device,
        )


def chunk_mlps(mlp: "nn.Sequential | SplitMLPs") -> list[nn.Sequential]:
    """The per-chunk MLPs of an ``edge_mlp`` / ``aggr_mlp`` (one for an
    unchunked MLP)."""
    return list(mlp.mlps) if isinstance(mlp, SplitMLPs) else [mlp]


def _apply_chunked(
    mlp: "nn.Sequential | SplitMLPs",
    parts: Sequence[torch.Tensor],
    chunk_sizes: Optional[Sequence[int]],
) -> torch.Tensor:
    """``mlp`` on the concatenation of ``parts`` along the feature axis:
    one MLP with its first layer split by part (no concatenated
    activation), or per-chunk MLPs along the leading axis."""
    if not isinstance(mlp, SplitMLPs):
        return apply_mlp_split_first(mlp, parts)
    if chunk_sizes is None:
        raise ValueError("per-chunk MLPs need chunk sizes")
    shape = torch.broadcast_shapes(*(p.shape[:-1] for p in parts))
    return mlp(
        torch.cat([p.expand(*shape, p.shape[-1]) for p in parts], dim=-1),
        chunk_sizes,
    )


def fused_edge_phase_supported(
    mlp, edge_set: EdgeSet, send_rep, rec_rep, edge_rep
) -> bool:
    """Can ONE edge MLP over this edge set ride the fused kernel, K3 (or
    K7)? It takes a two-layer edge MLP with every input at the hidden
    width, and on CUDA tensors only the widths and batches the kernels
    are built for (``fused_kernels.kernels_take``, asked with the batch
    that :func:`_batch_nodes` gives the call); anything else takes the
    unfused route, and so does every phase under
    ``NEURAL_LAM_TPU_FUSED=off`` (read at every call, as the JAX package's
    ``fused_edge_phase_supported`` reads it)."""
    if fused_kernels.fused_disabled():
        return False
    if isinstance(mlp, SplitMLPs) or not fusable(mlp):
        return False
    h = linear_layers(mlp)[-1].out_features
    return (
        send_rep.shape[-1] == h
        and rec_rep.shape[-1] == h
        and (edge_rep is None or edge_rep.shape[-1] == h)
        and fused_kernels.kernels_take(
            h, _batch_size(send_rep, rec_rep, edge_rep) or 1, rec_rep.device
        )
    )


def _use_fused(net: InteractionNet, edge_set, send_rep, rec_rep, edge_rep) -> bool:
    """Route a whole interaction step through K3 when the configuration
    is the one it implements (single edge and node MLPs)."""
    if isinstance(net.edge_mlp, SplitMLPs) or isinstance(net.aggr_mlp, SplitMLPs):
        return False
    return fused_edge_phase_supported(
        net.edge_mlp, edge_set, send_rep, rec_rep, edge_rep
    )


def _batch_size(send_rep, rec_rep, edge_rep) -> Optional[int]:
    """The batch of the first batched ``(N, B, D)`` input, None if no
    input is batched."""
    for a in (send_rep, rec_rep, edge_rep):
        if a is not None and a.dim() == 3:
            return a.shape[1]
    return None


def _batch_nodes(send_rep, rec_rep, edge_rep):
    """The node arrays in the common batched ``(N, B, D)`` layout,
    contiguous: an unbatched one is shared across the batch of whichever
    input is batched. Returns ``(send_rep, rec_rep, squeeze)``;
    ``squeeze`` says that no input was batched, so the call runs as one
    batch member and its outputs drop the batch axis again. An unbatched
    edge array stays ``(E, D)``."""
    batch = _batch_size(send_rep, rec_rep, edge_rep)
    if batch is None:
        return send_rep.unsqueeze(1).contiguous(), rec_rep.unsqueeze(1).contiguous(), True

    def bcast(a: torch.Tensor) -> torch.Tensor:
        if a.dim() == 2:
            a = a.unsqueeze(1).expand(a.shape[0], batch, a.shape[1])
        return a.contiguous()

    return bcast(send_rep), bcast(rec_rep), False


def _squeeze(out: tuple, squeeze: bool) -> tuple:
    if not squeeze:
        return out
    return tuple(None if a is None else a.squeeze(1) for a in out)


def _fused_phase(mlp, edge_set, send_rep, rec_rep, edge_rep, update_edges,
                 propagation, embedder=None, edge_features=None, aggr_mlp=None):
    """K1 then K3 on batched node arrays, or K7 where the phase routes to
    v2 (interaction wiring only: a PropagationNet's sender residual needs
    the per-edge sender rows, as in the JAX package, interaction.py:486
    and :603). The route is read at every call. Returns ``(aggregated_sum
    or node update, new_edge | None, node_done)``: with ``aggr_mlp`` the v1
    route runs it as K3's epilogue and returns the node update
    (``node_done``); the v2 route, which the JAX package checks first
    (:603-611), has no epilogue and returns the sum."""
    if not propagation and fused_kernels.fused_v2_routed(
        edge_set.num_edges, send_rep.shape[0] + edge_set.num_rec
    ):
        return (*fused_kernels.fused_edge_phase_v2(
            mlp, edge_rep, send_rep, rec_rep, edge_set,
            embedder=embedder, edge_feats=edge_features,
            update_edges=update_edges,
        ), False)
    x_send = gather_senders(edge_set, send_rep)  # (E, B, D)
    return (*fused_kernels.fused_edge_phase(
        mlp, edge_rep, x_send, rec_rep, edge_set,
        embedder=embedder, edge_feats=edge_features,
        update_edges=update_edges, propagation=propagation, aggr_mlp=aggr_mlp,
    ), aggr_mlp is not None)


def _unfused_phase(mlp, edge_set, send_rep, rec_rep, edge_rep, update_edges,
                   propagation, chunk_sizes=None):
    """K1, K6, the edge MLP and K5 on batched node arrays. An ``(E, D)``
    edge array is shared across the batch: its first-layer product is
    formed once per edge."""
    if edge_rep.dim() == 2:
        edge_rep = edge_rep.unsqueeze(1)
    x_send = gather_senders(edge_set, send_rep)  # (E, B, D)
    x_rec = gather_receivers(edge_set, rec_rep)
    messages = _apply_chunked(mlp, (edge_rep, x_send, x_rec), chunk_sizes)
    if propagation:
        messages = x_send + messages
    aggregated = aggregate_sum(edge_set, messages)
    return aggregated, (edge_rep + messages) if update_edges else None


def fused_edge_phase(
    mlp: nn.Sequential,
    edge_set: EdgeSet,
    send_rep: torch.Tensor,
    rec_rep: torch.Tensor,
    edge_rep: torch.Tensor,
    update_edges: bool = True,
    propagation: bool = False,
):
    """The fused gather, edge MLP and sum for ONE edge MLP (K1, then K3;
    K4 and K2 backward; or K7, with K8 and K2 backward, on the v2 route
    of :func:`_fused_phase`), for callers that compose a step from
    per-section phases (HiLAMParallel): the per-level aggregates are
    summed across sections before one node update, so the node MLP and
    the residual stay with the caller, and so does the mean division.
    Returns ``(aggregated_sum, new_edge | None)``. Node arrays broadcast
    to the common batched layout; an unbatched ``edge_rep`` stays
    ``(E, D)``, the kernels' shared-edge mode."""
    send_rep, rec_rep, squeeze = _batch_nodes(send_rep, rec_rep, edge_rep)
    out = _fused_phase(
        mlp, edge_set, send_rep, rec_rep, edge_rep, update_edges, propagation
    )
    return _squeeze(out[:2], squeeze)


def unfused_edge_phase(
    mlp: nn.Sequential,
    edge_set: EdgeSet,
    send_rep: torch.Tensor,
    rec_rep: torch.Tensor,
    edge_rep: torch.Tensor,
    update_edges: bool = True,
    propagation: bool = False,
):
    """The same phase as :func:`fused_edge_phase` for an edge MLP of any
    depth, by separate operations: K1, K6, the MLP, K5."""
    send_rep, rec_rep, squeeze = _batch_nodes(send_rep, rec_rep, edge_rep)
    out = _unfused_phase(
        mlp, edge_set, send_rep, rec_rep, edge_rep, update_edges, propagation
    )
    return _squeeze(out, squeeze)


def apply_interaction_net(
    net: InteractionNet,
    edge_set: EdgeSet,
    send_rep: torch.Tensor,
    rec_rep: torch.Tensor,
    edge_rep: Optional[torch.Tensor],
    aggr: str = "sum",
    update_edges: bool = True,
    propagation: bool = False,
    edge_chunk_sizes: Optional[Sequence[int]] = None,
    aggr_chunk_sizes: Optional[Sequence[int]] = None,
    edge_embedder: Optional[nn.Sequential] = None,
    edge_features: Optional[torch.Tensor] = None,
):
    """One message-passing step on node-major representations.

    ``edge_embedder`` + ``edge_features`` (instead of ``edge_rep``)
    delegate the static edge embedding to this op: the fused route runs
    the embedder inside K3 on the raw features, the unfused route
    computes it up front; the math is the same.

    Node arrays are ``(N, B, D)`` or unbatched ``(N, D)``; an unbatched
    node or edge array in a batched call is shared across the batch.
    ``edge_chunk_sizes`` / ``aggr_chunk_sizes`` split the edges (in the
    edge set's sorted order) and the receivers among the MLPs of a net
    built with ``num_edge_chunks`` / ``num_aggr_chunks``. Returns
    ``(new_rec_rep, new_edge_rep)`` if ``update_edges`` else
    ``new_rec_rep``.
    """
    if aggr not in ("sum", "mean"):
        raise ValueError(f"Unknown aggregation method: {aggr}")
    if propagation:
        aggr = "mean"  # reference: neural_lam/gnn_layers.py:221-230

    embed_in_kernel = False
    if edge_embedder is not None:
        if edge_rep is not None or edge_features is None:
            raise ValueError(
                "edge_embedder needs edge_features and no edge_rep"
            )
        embed_in_kernel = _use_fused(
            net, edge_set, send_rep, rec_rep, None
        ) and embedder_fusable(edge_embedder, send_rep.shape[-1])
        if not embed_in_kernel:
            edge_rep = edge_embedder(edge_features)

    send_rep, rec_rep, squeeze = _batch_nodes(send_rep, rec_rep, edge_rep)
    if embed_in_kernel or _use_fused(net, edge_set, send_rep, rec_rep, edge_rep):
        # the node-MLP epilogue, where the JAX package takes it
        # (neural_lam_tpu/ops/interaction.py:654-679): nothing between the
        # sum and the node update, and one node MLP of the fusable shape
        node_ep = (
            not propagation
            and aggr == "sum"
            and aggr_fusable(net.aggr_mlp)
            and fused_kernels.fused_aggr_enabled()
        )
        aggregated, new_edge, node_done = _fused_phase(
            net.edge_mlp, edge_set, send_rep, rec_rep,
            None if embed_in_kernel else edge_rep, update_edges, propagation,
            embedder=edge_embedder if embed_in_kernel else None,
            edge_features=edge_features if embed_in_kernel else None,
            aggr_mlp=net.aggr_mlp if node_ep else None,
        )
        if node_done:
            new_rec, new_edge = _squeeze((aggregated, new_edge), squeeze)
            return (new_rec, new_edge) if update_edges else new_rec
    else:
        aggregated, new_edge = _unfused_phase(
            net.edge_mlp, edge_set, send_rep, rec_rep, edge_rep, update_edges,
            propagation, edge_chunk_sizes,
        )
    if aggr == "mean":
        aggregated = aggregated / mean_divisor(edge_set, aggregated)
    rec_diff = _apply_chunked(net.aggr_mlp, (rec_rep, aggregated), aggr_chunk_sizes)
    new_rec = (aggregated if propagation else rec_rep) + rec_diff
    new_rec, new_edge = _squeeze((new_rec, new_edge), squeeze)
    return (new_rec, new_edge) if update_edges else new_rec
