"""Lazy per-timestep array loading (the dask.delayed replacement).

The reference MEPS datastore wraps every ``.npy`` file in
``dask.delayed`` so nothing is read until sliced
(reference: neural_lam/datastore/npyfilesmeps/store.py:506-538). Here
the same laziness comes from a small virtual array: items along axis 0
(analysis times) are produced on demand by a loader callback, and the
hot path — integer selection of one analysis time — reads exactly one
file (via ``np.load(..., mmap_mode="r")`` inside the loader).

The port's own copy of ``neural_lam_tpu/utils/lazy.py``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np

Index = Union[int, slice, Sequence[int], np.ndarray]


class LazyTimeSeries:
    """Array-like of shape ``(A, *item_shape)``; axis 0 loads lazily.

    Supports the numpy-style indexing used by
    :class:`~neural_lam_tpu_torch.utils.labeled.FieldArray`: an index tuple
    whose first element selects analysis times and whose remainder is
    forwarded to the loaded item(s). Anything that touches more than one
    analysis time materialises those items eagerly.
    """

    def __init__(
        self,
        loader: Callable[[int], np.ndarray],
        num_items: int,
        item_shape: tuple[int, ...],
        dtype=np.float32,
        cache_size: int = 2,
        pushdown: Optional[Callable[[int, tuple], np.ndarray]] = None,
    ) -> None:
        self._loader = loader
        self._num_items = num_items
        self._item_shape = tuple(item_shape)
        self.dtype = np.dtype(dtype)
        # Optional selection pushdown: ``pushdown(i, rest)`` returns the
        # item ``i`` already indexed by ``rest`` — lets backends that store
        # one file per sub-axis element (e.g. per ensemble member) read
        # only the files the selection touches.
        self._pushdown = pushdown
        # Tiny LRU so the common access pattern (same analysis time sliced
        # repeatedly while windowing) reads each file once.
        self._cache: dict[int, np.ndarray] = {}
        self._cache_size = cache_size

    @property
    def shape(self) -> tuple[int, ...]:
        return (self._num_items,) + self._item_shape

    @property
    def ndim(self) -> int:
        return 1 + len(self._item_shape)

    def __len__(self) -> int:
        return self._num_items

    def _item(self, i: int) -> np.ndarray:
        i = int(i)
        if i < 0:
            i += self._num_items
        if not 0 <= i < self._num_items:
            raise IndexError(
                f"index {i} out of range for axis 0 of size "
                f"{self._num_items}"
            )
        if i in self._cache:
            return self._cache[i]
        arr = np.asarray(self._loader(i), dtype=self.dtype)
        if arr.shape != self._item_shape:
            raise ValueError(
                f"Loader returned shape {arr.shape} for item {i}, "
                f"expected {self._item_shape}"
            )
        if len(self._cache) >= self._cache_size:
            self._cache.pop(next(iter(self._cache)))
        self._cache[i] = arr
        return arr

    def __getitem__(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        first = key[0] if key else slice(None)
        rest = key[1:]

        if isinstance(first, (int, np.integer)):
            if rest and self._pushdown is not None:
                i = int(first)
                if i < 0:
                    i += self._num_items
                return np.asarray(
                    self._pushdown(i, rest), dtype=self.dtype
                )
            item = self._item(first)
            return item[rest] if rest else item

        if isinstance(first, slice):
            indices = list(range(*first.indices(self._num_items)))
        else:
            arr = np.asarray(first).reshape(-1)
            if arr.dtype == bool:
                # numpy-style boolean mask selection along the first axis
                if arr.size != self._num_items:
                    raise IndexError(
                        f"boolean index of length {arr.size} does not "
                        f"match series length {self._num_items}"
                    )
                arr = np.nonzero(arr)[0]
            indices = [int(i) for i in arr]

        # Multi-item selection stays LAZY: compose the per-item selection
        # into a new loader so e.g. ``isel(ensemble_member=m)`` over the
        # full analysis-time axis does not read every file.
        sub_shape = (
            np.empty(self._item_shape + (0,))[rest + (slice(None),)].shape[
                :-1
            ]
            if rest
            else self._item_shape
        )

        def sub_loader(j, _indices=indices, _rest=rest):
            if _rest and self._pushdown is not None:
                return self._pushdown(_indices[j], _rest)
            item = self._item(_indices[j])
            return item[_rest] if _rest else item

        return LazyTimeSeries(
            sub_loader,
            len(indices),
            sub_shape,
            dtype=self.dtype,
            cache_size=self._cache_size,
        )

    def __array__(self, dtype=None, copy=None):
        out = np.stack(
            [self._item(i) for i in range(self._num_items)], axis=0
        )
        return out.astype(dtype) if dtype is not None else out
