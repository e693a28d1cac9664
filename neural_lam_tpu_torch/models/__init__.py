"""Model families (this slice: GraphLAM and the AR forecaster)."""

from .forecaster import ARForecaster  # noqa: F401
from .graph_lam import GraphLAM  # noqa: F401

MODELS = {"graph_lam": GraphLAM}
