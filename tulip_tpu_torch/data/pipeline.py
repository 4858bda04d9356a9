"""Host-side input pipeline: sampler + multi-threaded prefetching loader
(the port's copy of tulip_tpu/data/pipeline.py, numpy only).

Stands in for torch DataLoader + DistributedSampler
(reference: tulip/main_lidar_upsampling.py:172-217).  Batches are numpy
arrays; the engines move them to the device.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np


class ShardedSampler:
    """Epoch-seeded shuffling sampler with DistributedSampler semantics
    (shuffle by seed+epoch, wrap-pad to a multiple of num_replicas, stride by
    rank).  With num_replicas=1 it degenerates to a plain shuffler."""

    def __init__(self, dataset_len: int, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = False):
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        if drop_last and dataset_len % num_replicas != 0:
            self.num_samples = dataset_len // num_replicas
        else:
            self.num_samples = -(-dataset_len // num_replicas)
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.num_samples

    def __iter__(self) -> Iterator[int]:
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            indices = rng.permutation(self.dataset_len).tolist()
        else:
            indices = list(range(self.dataset_len))
        if len(indices) < self.total_size:  # wrap-pad
            indices += indices[: self.total_size - len(indices)]
        else:
            indices = indices[: self.total_size]
        return iter(indices[self.rank:self.total_size:self.num_replicas])


def slice_w(batch, index: int, count: int):
    """W shard ``index`` of ``count`` of a collated batch: every
    'sample' array cut along its last axis (the range image's W), the rest
    as it is (W-axis sequence parallel feeds each seq rank its shard)."""
    if isinstance(batch, tuple):
        return tuple(slice_w(b, index, count) for b in batch)
    out = dict(batch)
    a = out["sample"]
    w = a.shape[-1] // count
    out["sample"] = np.ascontiguousarray(a[..., index * w:(index + 1) * w])
    return out


def _collate(items):
    """Stack a list of dataset items.  Items are tuples of dicts
    ({'sample','class','name'}, ...) as produced by PairDataset."""
    if isinstance(items[0], tuple):
        return tuple(_collate([it[i] for it in items]) for i in range(len(items[0])))
    if isinstance(items[0], dict):
        return {k: _collate([it[k] for it in items]) for k in items[0]}
    if isinstance(items[0], np.ndarray):
        return np.stack(items, axis=0)
    if isinstance(items[0], (int, float, np.integer, np.floating)):
        return np.asarray(items)
    return list(items)


class DataLoader:
    """Batched loader with background prefetch.

    Loads items via a thread pool (numpy file IO releases the GIL) and keeps
    up to ``prefetch`` collated batches in flight so the accelerator never
    waits on the host.  ``w_shard=(index, count)`` hands out W shard
    ``index`` of ``count`` of every batch (:func:`slice_w`).
    """

    def __init__(self, dataset, batch_size: int, sampler: Optional[ShardedSampler] = None,
                 shuffle: bool = False, drop_last: bool = False,
                 num_workers: int = 8, prefetch: int = 4, seed: int = 0,
                 w_shard: Optional[Tuple[int, int]] = None):
        self.dataset = dataset
        self.w_shard = w_shard
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.sampler = sampler if sampler is not None else ShardedSampler(
            len(dataset), shuffle=shuffle, seed=seed, drop_last=drop_last)

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches_of_indices(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def _load_batch(self, idxs):
        batch = _collate([self.dataset[i] for i in idxs])
        if self.w_shard is not None:
            batch = slice_w(batch, *self.w_shard)
        return batch

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    futures = []
                    for idxs in self._batches_of_indices():
                        futures.append(pool.submit(self._load_batch, idxs))
                        # bound the number of outstanding batches
                        while len(futures) >= self.prefetch:
                            q.put(futures.pop(0).result())
                    for fut in futures:
                        q.put(fut.result())
            except BaseException as e:  # surface worker errors to the consumer
                q.put(e)
                return
            q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
