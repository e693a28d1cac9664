"""MEPS .npy-file datastore (reference: neural_lam/datastore/npyfilesmeps)."""

from .store import NpyFilesDatastoreMEPS  # noqa: F401
