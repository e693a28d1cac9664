"""Kernel nodes of the captured training step's CUDA graph, counted by
the program at capture (``cuGraphGetNodes``): the kernels one replay
launches."""

from benchmark.spans import graph_kernels


def read(obs: dict, snapshot=None):
    return graph_kernels(obs, "train", "train_step", snapshot)
