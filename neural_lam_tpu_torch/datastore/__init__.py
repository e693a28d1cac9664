"""Datastores: access to state/forcing/static weather data (numpy).

Counterpart of ``neural_lam_tpu/datastore/__init__.py``: the registry
and the ``init_datastore`` factory over the datastores ported so far.
"""

from .base import (  # noqa: F401
    BaseDatastore,
    BaseRegularGridDatastore,
    CartesianGridShape,
)
from .dummy import DummyDatastore
from .mdp import MDPDatastore
from .npyfilesmeps import NpyFilesDatastoreMEPS

DATASTORES: dict[str, type] = {
    "dummydata": DummyDatastore,
    "npyfilesmeps": NpyFilesDatastoreMEPS,
    "mdp": MDPDatastore,
}


def init_datastore(datastore_kind: str, config_path) -> BaseDatastore:
    """Instantiate the datastore of the given kind from its config file."""
    if datastore_kind not in DATASTORES:
        raise NotImplementedError(
            f"Datastore kind {datastore_kind!r} is not implemented "
            f"(available: {sorted(DATASTORES)})"
        )
    return DATASTORES[datastore_kind](config_path=config_path)
