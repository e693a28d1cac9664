"""Message-passing operations and the CUDA kernels they dispatch to."""


def launch_counters() -> dict:
    """Each CUDA kernel's launch count by the kernel's name: K1-K8, each
    a wrapper, and the bf16 variants of K1-K4, K7 and K8, the
    ``NEURAL_LAM_TPU_CACHE_PRE`` variants of K3 and K4, K4's receiver
    slice, and the node-MLP route's node update after K3 and node backward
    before K4 (``NEURAL_LAM_TPU_FUSED_AGGR``), in each precision, whose counts the
    same wrappers keep in objects of their own. A wrapper adds one to a
    ``launches`` where it launches that kernel, and nowhere else. Under
    CUDA graph capture that launch goes into the graph, and is counted
    once: the graph's replays do not call the wrapper."""
    from .fused_kernels import (
        FUSED_EDGE_BF16,
        FUSED_EDGE_BF16_OPS,
        FUSED_EDGE_BF16_PRE,
        FUSED_EDGE_BWD_BF16,
        FUSED_EDGE_BWD_BF16_OPS,
        FUSED_EDGE_BWD_BF16_PRE,
        FUSED_EDGE_BWD_RECEIVER,
        FUSED_EDGE_BWD_RECOMPUTE,
        FUSED_EDGE_V2_BF16,
        FUSED_EDGE_V2_BF16_OPS,
        FUSED_EDGE_V2_BWD_BF16,
        FUSED_EDGE_V2_BWD_BF16_OPS,
        FUSED_NODE_BWD,
        FUSED_NODE_BWD_BF16,
        FUSED_NODE_BWD_BF16_OPS,
        FUSED_NODE_FWD,
        FUSED_NODE_FWD_BF16,
        FUSED_NODE_FWD_BF16_OPS,
        fused_edge_bwd,
        fused_edge_phase,
        fused_edge_phase_v2,
        fused_edge_v2_bwd,
    )
    from .segment_kernels import (
        SENDER_GATHER_BF16,
        SENDER_SCATTER_BF16,
        receiver_expand,
        segment_sum,
        sender_gather,
        sender_scatter,
    )

    counters = {
        "K1 sender_gather": sender_gather,
        "K3 fused_edge_phase": fused_edge_phase,
        "K2 sender_scatter": sender_scatter,
        "K4 fused_edge_phase backward": fused_edge_bwd,
        "K5 segment_sum": segment_sum,
        "K6 receiver_expand": receiver_expand,
        "K7 fused_edge_phase_v2": fused_edge_phase_v2,
        "K8 fused_edge_phase_v2 backward": fused_edge_v2_bwd,
    }
    for count in (SENDER_GATHER_BF16, SENDER_SCATTER_BF16, FUSED_EDGE_BF16,
                  FUSED_EDGE_BF16_OPS, FUSED_EDGE_BWD_BF16, FUSED_EDGE_BWD_BF16_OPS,
                  FUSED_EDGE_V2_BF16, FUSED_EDGE_V2_BF16_OPS, FUSED_EDGE_V2_BWD_BF16,
                  FUSED_EDGE_V2_BWD_BF16_OPS, FUSED_EDGE_BF16_PRE, FUSED_EDGE_BWD_BF16_PRE,
                  FUSED_EDGE_BWD_RECOMPUTE, FUSED_EDGE_BWD_RECEIVER, FUSED_NODE_FWD,
                  FUSED_NODE_FWD_BF16, FUSED_NODE_FWD_BF16_OPS, FUSED_NODE_BWD,
                  FUSED_NODE_BWD_BF16, FUSED_NODE_BWD_BF16_OPS):
        counters[count.name] = count
    return counters
