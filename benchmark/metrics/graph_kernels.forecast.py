"""Kernel nodes of the captured forecast's CUDA graph, counted by the
program at capture (``cuGraphGetNodes``): the kernels one replay
launches."""

from benchmark.spans import graph_kernels


def read(obs: dict, snapshot=None):
    return graph_kernels(obs, "forecast", "forecast", snapshot)
