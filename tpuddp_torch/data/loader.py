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
A dataset with ``.images`` and ``.labels`` arrays (CIFAR-10, the synthetic
stand-in) has its rows gathered by the host C++ row gather
(:mod:`tpuddp_torch.data._native`); other datasets, and an empty index list,
take numpy's path, as in ``tpuddp/data/loader.py:62-79``.

Both loaders expose ``make_batch_plan`` (this epoch's order frozen, and a
function that assembles batch ``s`` alone), which :class:`PrefetchLoader`'s
worker threads share out; ``__iter__`` is written through it, so the two
give the same batches.
"""

from __future__ import annotations

import math
import queue
import threading
from typing import Iterator, Tuple

import numpy as np

from tpuddp_torch.data import _native
from tpuddp_torch.parallel.sampler import DistributedSampler
from tpuddp_torch.utils import batching


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


def _fetch_padded(dataset, indices: np.ndarray, batch_size: int):
    """Fetch and pad in one step: through the native gather when the dataset
    has contiguous ``.images`` and ``.labels`` arrays and there is at least
    one index, else through :func:`_fetch` and :func:`pad_batch`. Both give
    the same batch."""
    images = getattr(dataset, "images", None)
    labels = getattr(dataset, "labels", None)
    n = len(indices)
    if (isinstance(images, np.ndarray) and images.flags["C_CONTIGUOUS"]
            and labels is not None and n > 0):
        x = _native.gather_rows(images, indices, pad_rows=batch_size)
        y = np.zeros(batch_size, labels.dtype)
        y[:n] = labels[np.asarray(indices)]
        w = np.ones(batch_size, np.float32)
        w[n:] = 0.0
        return x, y, w
    x, y = _fetch(dataset, indices)
    return pad_batch(x, y, batch_size)


def _per_sample_nbytes(dataset):
    """Input bytes of one sample (x only) when the dataset has an
    ``.images`` array, else None."""
    images = getattr(dataset, "images", None)
    if images is None or not hasattr(images, "itemsize"):
        return None
    return int(np.prod(images.shape[1:])) * images.itemsize


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

    @property
    def batch_nbytes(self):
        """Input bytes of one batch (x only), or None."""
        per_sample = _per_sample_nbytes(self.dataset)
        return None if per_sample is None else self.batch_size * per_sample

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.Generator(np.random.PCG64(self.seed + self.epoch)).permutation(n)
        return np.arange(n)

    def make_batch_plan(self):
        """``(n_batches, fetch)`` for this epoch: ``fetch(s)`` assembles
        batch ``s`` independently of any other batch."""
        indices = self._indices()
        batch_size, dataset = self.batch_size, self.dataset

        def fetch(s: int):
            return _fetch_padded(dataset, indices[s * batch_size : (s + 1) * batch_size], batch_size)

        return len(self), fetch

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        steps, fetch = self.make_batch_plan()
        for s in range(steps):
            yield fetch(s)


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

    @property
    def batch_nbytes(self):
        """Input bytes of one batch (x only), or None."""
        per_sample = _per_sample_nbytes(self.dataset)
        return None if per_sample is None else self.batch_size * per_sample

    def make_batch_plan(self):
        """``(n_batches, fetch)`` for this epoch (see
        :meth:`DataLoader.make_batch_plan`)."""
        indices = self.sampler.local_indices()
        batch_size, dataset = self.batch_size, self.dataset

        def fetch(s: int):
            return _fetch_padded(dataset, indices[s * batch_size : (s + 1) * batch_size], batch_size)

        return len(self), fetch

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        steps, fetch = self.make_batch_plan()
        for s in range(steps):
            yield fetch(s)

    def probe_fingerprint(self, x_local: np.ndarray) -> str:
        """Shard-disjointness probe: a few raw input values of this rank's
        first sample (the reference's multi-GPU-training-torch.py:112-115)."""
        flat = np.asarray(x_local[0]).reshape(-1)
        mid = flat.size // 2
        return (
            f"replica {self.rank}: "
            f"{np.array2string(flat[mid : mid + 4], precision=4)}"
        )


class PrefetchLoader:
    """Background assembly of ``loader``'s batches (``tpuddp/data/loader.py:
    351-526``, the reference's ``num_workers`` analog): the same batches in
    the same order, assembled while the device computes.

    ``workers > 1`` shares the batches of the inner loader's
    ``make_batch_plan`` out to a pool of threads (the native gather releases
    the interpreter lock) and re-emits them strictly in order; otherwise one
    producer thread drives the inner loader's own iterator. The queue holds
    at most ``depth`` batches, capped by the staging budget over the
    loader's ``batch_nbytes``. A worker's exception is raised in the
    consumer with its original traceback, and every thread is reaped when
    iteration ends, fails, or is abandoned part-way (the generator's
    ``close``)."""

    _SENTINEL = object()

    def __init__(self, loader, depth: int = 2, workers: int = 1):
        self.loader = loader
        self.depth = max(1, int(depth))
        self.workers = max(1, int(workers))

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def effective_depth(self) -> int:
        return batching.resolve_fuse(getattr(self.loader, "batch_nbytes", None), cap=self.depth)

    def __iter__(self):
        depth = self.effective_depth()
        if self.workers > 1 and hasattr(self.loader, "make_batch_plan"):
            return self._iter_pool(depth)
        return self._iter_serial(depth)

    def _iter_serial(self, depth: int):
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        stop = threading.Event()
        err = []

        def put(item) -> bool:
            # a put the consumer can always cancel, even with the queue full
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for batch in self.loader:
                    if not put(batch):
                        return
            except BaseException as e:  # handed to the consumer, which re-raises it
                err.append(e)
            finally:
                put(self._SENTINEL)

        thread = threading.Thread(target=produce, daemon=True, name="tpuddp-prefetch")
        thread.start()
        try:
            while True:
                item = q.get()
                if item is self._SENTINEL:
                    break
                yield item
            if err:
                raise err[0]  # carries the producer's traceback
        finally:
            stop.set()
            try:  # unblock a producer waiting on a full queue
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            thread.join(timeout=5)

    def _iter_pool(self, depth: int):
        steps, fetch = self.loader.make_batch_plan()
        lock = threading.Condition()
        results = {}  # batch index -> batch, at most `depth` ahead of the consumer
        cursor = {"claim": 0, "emit": 0}
        stop = threading.Event()
        err = []

        def work():
            while not stop.is_set():
                with lock:
                    while (not stop.is_set() and cursor["claim"] < steps
                           and cursor["claim"] - cursor["emit"] >= depth):
                        lock.wait(0.05)
                    if stop.is_set() or cursor["claim"] >= steps:
                        return
                    s = cursor["claim"]
                    cursor["claim"] += 1
                try:
                    batch = fetch(s)
                except BaseException as e:  # handed to the consumer, which re-raises it
                    with lock:
                        err.append(e)
                        stop.set()
                        lock.notify_all()
                    return
                with lock:
                    results[s] = batch
                    lock.notify_all()

        threads = [
            threading.Thread(target=work, daemon=True, name=f"tpuddp-prefetch-{i}")
            for i in range(min(self.workers, max(1, steps)))
        ]
        for t in threads:
            t.start()
        try:
            for s in range(steps):
                with lock:
                    while s not in results and not err:
                        lock.wait(0.05)
                    if err:
                        raise err[0]
                    batch = results.pop(s)
                    cursor["emit"] = s + 1
                    lock.notify_all()
                yield batch
        finally:
            stop.set()
            with lock:
                lock.notify_all()
            for t in threads:
                t.join(timeout=5)
