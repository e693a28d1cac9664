"""Model families: the graph step predictors and the AR forecaster
(reference registry: neural_lam/models/__init__.py:14-18)."""

from .forecaster import ARForecaster  # noqa: F401
from .graph_lam import GraphLAM  # noqa: F401
from .hi_lam import HiLAM  # noqa: F401
from .hi_lam_parallel import HiLAMParallel  # noqa: F401

MODELS = {
    "graph_lam": GraphLAM,
    "hi_lam": HiLAM,
    "hi_lam_parallel": HiLAMParallel,
}
