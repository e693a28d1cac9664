"""Message-passing operations and the CUDA kernels they dispatch to."""


def launch_counters() -> dict:
    """Each CUDA kernel's wrapper by the kernel's name, K1-K8. A wrapper
    adds one to its ``launches`` where it launches its kernel, and
    nowhere else. Under CUDA graph capture that launch goes into the
    graph, and is counted once: the graph's replays do not call the
    wrapper."""
    from .fused_kernels import (
        fused_edge_bwd,
        fused_edge_phase,
        fused_edge_phase_v2,
        fused_edge_v2_bwd,
    )
    from .segment_kernels import (
        receiver_expand,
        segment_sum,
        sender_gather,
        sender_scatter,
    )

    return {
        "K1 sender_gather": sender_gather,
        "K3 fused_edge_phase": fused_edge_phase,
        "K2 sender_scatter": sender_scatter,
        "K4 fused_edge_phase backward": fused_edge_bwd,
        "K5 segment_sum": segment_sum,
        "K6 receiver_expand": receiver_expand,
        "K7 fused_edge_phase_v2": fused_edge_phase_v2,
        "K8 fused_edge_phase_v2 backward": fused_edge_v2_bwd,
    }
