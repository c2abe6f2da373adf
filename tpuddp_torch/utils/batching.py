"""The staging budget and the depth policy that every queue of batches
ahead of the step is capped by, the power-of-two bucket ladder, the shape
key and the zero-weight padding of a batch — the port's copy of
``tpuddp/utils/batching.py`` (``PrefetchLoader``'s host queue, the staged
device queue of ``training/pipeline.py``, the transformers' prefill lengths,
the serving queue's keys and the scheduler's padded row buckets)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# Bound on one queue of staged batches, in input bytes.
STAGE_BYTES_BUDGET = 256 * 1024 * 1024


def shape_key(x) -> Tuple[Tuple[int, ...], str]:
    """Bucketing key of a batch: ``(shape, dtype string)``, from metadata
    alone (``x`` is never converted)."""
    return (tuple(np.shape(x)), str(getattr(x, "dtype", "untyped")))


def resolve_fuse(batch_nbytes: Optional[int], cap: int = 32) -> int:
    """Depth of a queue of batches: ``cap``, bounded by the staging budget
    over one batch's input bytes when they are known."""
    cap = max(1, int(cap))
    if batch_nbytes:
        cap = max(1, min(cap, STAGE_BYTES_BUDGET // int(batch_nbytes)))
    return cap


def bucket_sizes(max_batch: int):
    """The power-of-two ladder up to ``max_batch`` (inclusive; ``max_batch``
    itself is always the top rung even when it is not a power of two)."""
    max_batch = int(max_batch)
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    sizes = []
    b = 1
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return sizes


def pad_batch(x: np.ndarray, y: Optional[np.ndarray], batch_size: int):
    """Pad ``(x, y)`` along axis 0 to ``batch_size``; returns ``(x, y, w)``
    with ``w`` the 0/1 float32 weight of the real rows. Padding repeats row 0
    (a real sample: nothing non-finite reaches the forward) with label 0;
    ``y=None`` pads ``x`` alone."""
    n = len(x) if y is None else len(y)
    if n > batch_size:
        raise ValueError(f"batch of {n} rows cannot pad down to {batch_size}")
    w = np.ones(batch_size, np.float32)
    if n < batch_size:
        pad = batch_size - n
        x = np.concatenate([x, np.repeat(x[:1], pad, axis=0)])
        if y is not None:
            y = np.concatenate([y, np.zeros(pad, y.dtype)])
        w[n:] = 0.0
    return x, y, w


def bucket_for(n: int, max_batch: int) -> int:
    """The smallest rung of :func:`bucket_sizes` that holds ``n`` rows."""
    if n < 1:
        raise ValueError(f"cannot bucket {n} rows")
    if n > max_batch:
        raise ValueError(f"{n} rows exceed max_batch={max_batch}")
    return next(b for b in bucket_sizes(max_batch) if n <= b)
