"""Host-side batch loader with background prefetch.

Replaces the reference's torch ``DataLoader`` workers + Lightning
``WeatherDataModule`` (reference: neural_lam/weather_dataset.py:641-772).
The input pipeline is a host thread that assembles numpy batches while
the device computes; the caller moves each batch to the device.

For multi-host SPMD each process constructs a loader with its
``(shard_index, num_shards)`` so every host reads a disjoint slice of each
(identically shuffled) epoch — the explicit per-host index scheme the
reference delegates to ``DistributedSampler``.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


class DataLoader:
    """Iterates minibatches of stacked-sample numpy tuples."""

    def __init__(
        self,
        dataset,
        batch_size: int = 4,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: Optional[bool] = None,
        prefetch: int = 2,
        shard_index: int = 0,
        num_shards: int = 1,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        # Training wants fixed batch shapes (no recompiles); eval wants all
        # samples. Default drop_last to the shuffle flag.
        self.drop_last = shuffle if drop_last is None else drop_last
        self.prefetch = prefetch
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            idxs = rng.permutation(n)
        else:
            idxs = np.arange(n)
        if self.num_shards > 1:
            # Equal-length shards: pad the epoch by wrapping from the
            # start so every host runs the SAME number of steps (the
            # lockstep requirement of multi-host SPMD; the duplicate-
            # sample eval caveat matches the reference's
            # DistributedSampler note, reference: README.md:528-530).
            pad = (-n) % self.num_shards
            if pad:
                # np.resize wraps as many times as needed — important when
                # the dataset is smaller than the shard count (pad > n).
                idxs = np.resize(idxs, n + pad)
        return idxs[self.shard_index :: self.num_shards]

    def __len__(self) -> int:
        n = len(self._epoch_indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self) -> Iterator[tuple]:
        idxs = self._epoch_indices()
        n = len(idxs)
        stop = (
            n - n % self.batch_size if self.drop_last else n
        )
        for start in range(0, stop, self.batch_size):
            batch_idx = idxs[start : start + self.batch_size]
            samples = [self.dataset[int(i)] for i in batch_idx]
            yield tuple(
                np.stack([s[j] for s in samples]) for j in range(len(samples[0]))
            )

    def __iter__(self) -> Iterator[tuple]:
        if self.prefetch <= 0:
            yield from self._batches()
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        # Bind the exception classes into this generator frame: the
        # cleanup `except` below can run at interpreter shutdown via
        # generator GC, after module globals are torn down.
        empty_exc, full_exc = queue.Empty, queue.Full
        sentinel = object()
        stop = threading.Event()
        err: list[BaseException] = []

        def producer():
            try:
                for batch in self._batches():
                    # Bounded put so an abandoned consumer (GeneratorExit
                    # mid-epoch) cannot strand this thread on a full queue
                    # holding assembled batches for the process lifetime.
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.1)
                            break
                        except full_exc:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # surface worker errors to consumer
                err.append(e)
            finally:
                # The sentinel must be delivered (the consumer blocks on it)
                # unless the consumer already abandoned iteration.
                while not stop.is_set():
                    try:
                        q.put(sentinel, timeout=0.1)
                        break
                    except full_exc:
                        continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            stop.set()
            try:  # unblock the producer if it is mid-put
                while True:
                    q.get_nowait()
            except empty_exc:
                pass
            t.join(timeout=5.0)
        if err:
            raise err[0]


class WeatherDataModule:
    """Train/val/test loader bundle, mirroring the reference DataModule
    API (reference: neural_lam/weather_dataset.py:641-772) without
    Lightning. Splits follow the reference: train unrolls
    ``ar_steps_train``; val/test unroll ``ar_steps_eval``."""

    def __init__(
        self,
        datastore,
        ar_steps_train: int = 1,
        ar_steps_eval: int = 10,
        batch_size: int = 4,
        num_past_forcing_steps: int = 1,
        num_future_forcing_steps: int = 1,
        load_single_member: bool = False,
        eval_split: str = "test",
        seed: int = 0,
        shard_index: int = 0,
        num_shards: int = 1,
    ) -> None:
        from .dataset import WeatherDataset

        self.batch_size = batch_size
        self._loader_kwargs = dict(
            batch_size=batch_size,
            seed=seed,
            shard_index=shard_index,
            num_shards=num_shards,
        )

        def make(split, ar_steps):
            return WeatherDataset(
                datastore,
                split=split,
                ar_steps=ar_steps,
                num_past_forcing_steps=num_past_forcing_steps,
                num_future_forcing_steps=num_future_forcing_steps,
                load_single_member=load_single_member,
            )

        self.train_dataset = make("train", ar_steps_train)
        self.val_dataset = make("val", ar_steps_eval)
        self.test_dataset = make(eval_split, ar_steps_eval)

    def train_dataloader(self) -> "DataLoader":
        return DataLoader(
            self.train_dataset, shuffle=True, **self._loader_kwargs
        )

    def val_dataloader(self) -> "DataLoader":
        return DataLoader(
            self.val_dataset, shuffle=False, **self._loader_kwargs
        )

    def test_dataloader(self) -> "DataLoader":
        return DataLoader(
            self.test_dataset, shuffle=False, **self._loader_kwargs
        )
