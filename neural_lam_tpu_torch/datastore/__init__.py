"""Datastores: access to state/forcing/static weather data (numpy)."""

from .base import (  # noqa: F401
    BaseDatastore,
    BaseRegularGridDatastore,
    CartesianGridShape,
)
from .dummy import DummyDatastore  # noqa: F401
