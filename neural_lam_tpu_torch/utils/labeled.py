"""A minimal labeled N-d array (xarray-lite).

The reference datastore contract is expressed in xarray DataArrays
(reference: neural_lam/datastore/base.py:19-58). This environment has no
xarray, and the training path only ever needs dimension-name bookkeeping,
integer/slice selection and coordinate lookup — so we provide exactly that
on top of numpy. Data can be lazily-backed (numpy memmap) and only
materialises on ``.values`` access.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence, Union

import numpy as np

Index = Union[int, slice, Sequence[int], np.ndarray]


@dataclasses.dataclass
class FieldArray:
    """N-d array with named dims and per-dim 1-d coordinate arrays."""

    data: Any  # numpy array or memmap-like supporting numpy indexing
    dims: tuple[str, ...]
    coords: dict[str, np.ndarray]  # keyed by dim name (1-d, len == dim size)
    name: Optional[str] = None
    attrs: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.dims = tuple(self.dims)
        assert len(self.dims) == self.data.ndim, (
            f"dims {self.dims} do not match data ndim {self.data.ndim}"
        )
        for dim, coord in self.coords.items():
            if dim in self.dims:
                size = self.data.shape[self.dims.index(dim)]
                assert len(coord) == size, (
                    f"coord {dim} has length {len(coord)}, dim size {size}"
                )

    # -- basic introspection -------------------------------------------------
    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def sizes(self) -> dict[str, int]:
        return dict(zip(self.dims, self.data.shape))

    @property
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def values(self) -> np.ndarray:
        return np.asarray(self.data)

    def get_coord(self, dim: str) -> np.ndarray:
        if dim not in self.coords:
            raise KeyError(f"No coordinate for dim {dim!r}")
        return self.coords[dim]

    def __getattr__(self, name: str):
        # Allow da.time style coordinate access like xarray.
        coords = object.__getattribute__(self, "coords")
        if name in coords:
            return coords[name]
        raise AttributeError(name)

    # -- selection -----------------------------------------------------------
    def isel(self, **indexers: Index) -> "FieldArray":
        """Integer/slice/fancy selection by dimension name.

        Semantics are xarray's (outer indexing): multiple array
        indexers select the cross product, never numpy's pointwise
        broadcast pairing.
        """
        for dim in indexers:
            if dim not in self.dims:
                raise KeyError(f"Unknown dim {dim!r}; have {self.dims}")

        def _is_array(idx):
            return not isinstance(
                idx, (int, np.integer, slice)
            )

        n_array = sum(
            1 for idx in indexers.values() if _is_array(idx)
        )
        index: list[Any] = []
        new_dims: list[str] = []
        for dim in self.dims:
            idx = indexers.get(dim, slice(None))
            index.append(idx)
            if not isinstance(idx, (int, np.integer)):
                new_dims.append(dim)
        if n_array <= 1:
            # Single advanced index: numpy semantics coincide with
            # outer indexing, and passing the whole tuple through keeps
            # lazy backends (LazyTimeSeries pushdown) lazy.
            data = self.data[tuple(index)]
        else:
            # Outer indexing: apply one indexer per axis sequentially.
            data = np.asarray(self.data)
            axis = 0
            for idx in index:
                if isinstance(idx, (int, np.integer)):
                    data = np.take(data, int(idx), axis=axis)
                    continue  # axis dropped
                if isinstance(idx, slice):
                    sl = [slice(None)] * data.ndim
                    sl[axis] = idx
                    data = data[tuple(sl)]
                else:
                    arr = np.asarray(idx)
                    if arr.dtype == bool:
                        arr = np.nonzero(arr)[0]
                    data = np.take(data, arr, axis=axis)
                axis += 1
        new_coords = {}
        for dim, coord in self.coords.items():
            if dim not in self.dims:
                new_coords[dim] = coord
                continue
            idx = indexers.get(dim, slice(None))
            if isinstance(idx, (int, np.integer)):
                continue  # dim dropped
            new_coords[dim] = np.asarray(coord)[idx]
        return FieldArray(
            data=data,
            dims=tuple(new_dims),
            coords=new_coords,
            name=self.name,
            attrs=dict(self.attrs),
        )

    def transpose(self, *dims: str) -> "FieldArray":
        assert set(dims) == set(self.dims), (dims, self.dims)
        order = [self.dims.index(d) for d in dims]
        return FieldArray(
            data=np.transpose(np.asarray(self.data), order),
            dims=tuple(dims),
            coords=dict(self.coords),
            name=self.name,
            attrs=dict(self.attrs),
        )

    def rename(self, mapping: Mapping[str, str]) -> "FieldArray":
        new_dims = tuple(mapping.get(d, d) for d in self.dims)
        new_coords = {mapping.get(k, k): v for k, v in self.coords.items()}
        return FieldArray(
            data=self.data,
            dims=new_dims,
            coords=new_coords,
            name=self.name,
            attrs=dict(self.attrs),
        )

    def load(self) -> "FieldArray":
        """Materialise lazily-backed data into memory."""
        self.data = np.asarray(self.data)
        return self

    def copy(self) -> "FieldArray":
        return FieldArray(
            data=np.array(self.data),
            dims=self.dims,
            coords={k: np.array(v) for k, v in self.coords.items()},
            name=self.name,
            attrs=dict(self.attrs),
        )
