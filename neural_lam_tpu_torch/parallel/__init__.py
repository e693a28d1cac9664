"""Spatial partitioning of the graph over the ranks of a process group.

Counterpart of ``neural_lam_tpu/parallel/``: :mod:`.spatial` (the
sharded executor: slabs, per-shard edge sets, the halo exchange) and
:mod:`.collective_budget` (the bytes each exchange moves). Data
parallelism is ``utils/distributed.py`` and the trainer's flat
all-reduce.
"""

from .spatial import EdgeMeta, ShardedModel  # noqa: F401
