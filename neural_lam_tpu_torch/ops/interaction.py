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
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from .fused_kernels import embedder_fusable, fusable, fused_edge_phase
from .mlp import apply_mlp_split_first, linear_layers, make_mlp
from .segment import (
    aggregate_mean,
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
    Applied with :func:`apply_interaction_net`. The per-chunk MLPs of the
    JAX package's ``num_edge_chunks``/``num_aggr_chunks`` serve
    HiLAMParallel and come with the hierarchical slice."""

    def __init__(
        self,
        input_dim: int,
        hidden_layers: int = 1,
        hidden_dim: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
        device: Optional[torch.device] = None,
    ) -> None:
        super().__init__()
        hidden_dim = hidden_dim or input_dim
        tail = [hidden_dim] * (hidden_layers + 1)
        self.edge_mlp = make_mlp(
            [3 * input_dim] + tail, generator=generator, device=device
        )
        self.aggr_mlp = make_mlp(
            [2 * input_dim] + tail, generator=generator, device=device
        )


def _fused_route(net: InteractionNet, send_rep, rec_rep, edge_rep) -> bool:
    """Route the edge phase through K3 when the configuration is the one
    it implements: a two-layer edge MLP and every input at the hidden
    width."""
    if not fusable(net.edge_mlp):
        return False
    h = linear_layers(net.edge_mlp)[-1].out_features
    return (
        send_rep.shape[-1] == h
        and rec_rep.shape[-1] == h
        and (edge_rep is None or edge_rep.shape[-1] == h)
    )


def apply_interaction_net(
    net: InteractionNet,
    edge_set: EdgeSet,
    send_rep: torch.Tensor,
    rec_rep: torch.Tensor,
    edge_rep: Optional[torch.Tensor],
    aggr: str = "sum",
    update_edges: bool = True,
    propagation: bool = False,
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
    Returns ``(new_rec_rep, new_edge_rep)`` if ``update_edges`` else
    ``new_rec_rep``.
    """
    if aggr not in ("sum", "mean"):
        raise ValueError(f"Unknown aggregation method: {aggr}")
    if propagation:
        aggr = "mean"  # reference: neural_lam/gnn_layers.py:221-230

    batched = [
        a for a in (send_rep, rec_rep, edge_rep) if a is not None and a.dim() == 3
    ]
    if not batched:
        # one batch member; an (E, D) edge array is shared by it
        out = apply_interaction_net(
            net, edge_set, send_rep.unsqueeze(1), rec_rep.unsqueeze(1),
            edge_rep, aggr, update_edges, propagation, edge_embedder,
            edge_features,
        )
        if update_edges:
            return out[0].squeeze(1), out[1].squeeze(1)
        return out.squeeze(1)

    batch = batched[0].shape[1]

    def bcast(a: torch.Tensor) -> torch.Tensor:
        if a.dim() == 2:
            a = a.unsqueeze(1).expand(a.shape[0], batch, a.shape[1])
        return a.contiguous()

    send_rep, rec_rep = bcast(send_rep), bcast(rec_rep)

    embed_in_kernel = False
    if edge_embedder is not None:
        if edge_rep is not None or edge_features is None:
            raise ValueError(
                "edge_embedder needs edge_features and no edge_rep"
            )
        embed_in_kernel = _fused_route(
            net, send_rep, rec_rep, None
        ) and embedder_fusable(edge_embedder, send_rep.shape[-1])
        if not embed_in_kernel:
            edge_rep = edge_embedder(edge_features)

    x_send = gather_senders(edge_set, send_rep)  # (E, B, D)
    if embed_in_kernel or _fused_route(net, send_rep, rec_rep, edge_rep):
        aggregated, new_edge = fused_edge_phase(
            net.edge_mlp,
            None if embed_in_kernel else edge_rep,
            x_send,
            rec_rep,
            edge_set,
            embedder=edge_embedder if embed_in_kernel else None,
            edge_feats=edge_features if embed_in_kernel else None,
            update_edges=update_edges,
            propagation=propagation,
        )
        if aggr == "mean":
            aggregated = aggregated / mean_divisor(edge_set, aggregated)
        rec_diff = apply_mlp_split_first(net.aggr_mlp, (rec_rep, aggregated))
        new_rec = (aggregated if propagation else rec_rep) + rec_diff
        return (new_rec, new_edge) if update_edges else new_rec

    if edge_rep.dim() == 2:
        edge_rep = bcast(edge_rep)
    x_rec = gather_receivers(edge_set, rec_rep)
    messages = apply_mlp_split_first(net.edge_mlp, (edge_rep, x_send, x_rec))
    if propagation:
        messages = x_send + messages
    if aggr == "sum":
        aggregated = aggregate_sum(edge_set, messages)
    else:
        aggregated = aggregate_mean(edge_set, messages)
    rec_diff = apply_mlp_split_first(net.aggr_mlp, (rec_rep, aggregated))
    new_rec = (aggregated if propagation else rec_rep) + rec_diff
    if update_edges:
        return new_rec, edge_rep + messages
    return new_rec
