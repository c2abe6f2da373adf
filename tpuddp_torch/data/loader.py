"""Batch loaders — the counterparts of ``tpuddp/data/loader.py``'s
``DataLoader`` and ``ShardedDataLoader``.

:class:`DataLoader` is the single-stream loader of the managed path: the
whole dataset, in order or shuffled by ``seed`` and the epoch. The managed
``Accelerator.prepare`` re-creates it as the rank's
:class:`ShardedDataLoader`; a loader left unprepared (the reference's test
loader) keeps its full stream on every process.

The reference gives each of N single-GPU processes its own
``DataLoader(sampler=DistributedSampler(...))`` (multi-GPU-training-torch.py:
72-101). So does the port: one :class:`DistributedSampler` for this rank. The
JAX loader, which drives every local replica from one process, concatenates
the replicas' slices; rank ``r``'s batch here is exactly the JAX batch's
``r``-th slice.

Every batch has a static shape: a final partial batch is padded by repeating
its first row, and the 0/1 weight vector ``w`` marks the real rows, which the
weighted loss and metrics consume. Batches are numpy ``(x uint8 NHWC, y, w)``.
Rows are gathered with numpy; the host C++ row-gather of the JAX package
(``tpuddp/data/_native/gather.cpp``) is not ported yet.
"""

from __future__ import annotations

import math
from typing import Iterator, Tuple

import numpy as np

from tpuddp_torch.parallel.sampler import DistributedSampler


def pad_batch(x: np.ndarray, y: np.ndarray, batch_size: int):
    """Pad ``(x, y)`` along axis 0 to ``batch_size``; return ``(x, y, w)``
    with the float32 0/1 weights ``w``. Padding repeats row 0 (a real sample)
    and labels it 0."""
    n = len(y)
    if n > batch_size:
        raise ValueError(f"batch of {n} rows cannot pad down to {batch_size}")
    w = np.ones(batch_size, np.float32)
    if n < batch_size:
        pad = batch_size - n
        x = np.concatenate([x, np.repeat(x[:1], pad, axis=0)])
        y = np.concatenate([y, np.zeros(pad, y.dtype)])
        w[n:] = 0.0
    return x, y, w


def _fetch(dataset, indices: np.ndarray):
    """Vectorized batch fetch when the dataset supports it."""
    if hasattr(dataset, "get_batch"):
        return dataset.get_batch(indices)
    xs, ys = zip(*(dataset[int(i)] for i in indices))
    return np.stack(xs), np.asarray(ys)


class DataLoader:
    """Single-stream loader yielding ``(x, y, w)`` numpy batches
    (``tpuddp/data/loader.py:92-166``): sequential, or with ``shuffle`` a
    permutation by ``PCG64(seed + epoch)`` that ``set_epoch`` re-keys. The
    last batch is padded with ``w = 0``."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return math.ceil(len(self.dataset) / self.batch_size)

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.Generator(np.random.PCG64(self.seed + self.epoch)).permutation(n)
        return np.arange(n)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        indices = self._indices()
        for s in range(len(self)):
            chunk = indices[s * self.batch_size : (s + 1) * self.batch_size]
            x, y = _fetch(self.dataset, chunk)
            yield pad_batch(x, y, self.batch_size)


class ShardedDataLoader:
    """DP loader for one process: yields this rank's ``(x, y, w)`` batches."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        rank: int,
        world_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size  # per replica
        self.rank = rank
        self.world_size = world_size
        self.drop_last = drop_last
        self.sampler = DistributedSampler(
            len(dataset), num_replicas=world_size, rank=rank,
            shuffle=shuffle, seed=seed,
        )

    def set_epoch(self, epoch: int) -> None:
        """Re-key the shuffle (reference multi-GPU-training-torch.py:175-178)."""
        self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        n = self.sampler.num_samples
        if self.drop_last:
            return n // self.batch_size
        return math.ceil(n / self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        indices = self.sampler.local_indices()
        for s in range(len(self)):
            chunk = indices[s * self.batch_size : (s + 1) * self.batch_size]
            x, y = _fetch(self.dataset, chunk)
            yield pad_batch(x, y, self.batch_size)

    def probe_fingerprint(self, x_local: np.ndarray) -> str:
        """Shard-disjointness probe: a few raw input values of this rank's
        first sample (the reference's multi-GPU-training-torch.py:112-115)."""
        flat = np.asarray(x_local[0]).reshape(-1)
        mid = flat.size // 2
        return (
            f"replica {self.rank}: "
            f"{np.array2string(flat[mid : mid + 4], precision=4)}"
        )
