"""Graph construction, storage and loading (numpy/scipy).

Same geometry and storage as ``neural_lam_tpu.graphs``.
"""

from .build import create_graph, create_graph_from_datastore  # noqa: F401
from .load import load_graph  # noqa: F401
