"""The staging budget and the depth policy that every queue of batches
ahead of the step is capped by, and the power-of-two bucket ladder — the
port's copy of the parts of ``tpuddp/utils/batching.py`` it uses
(``PrefetchLoader``'s host queue, the staged device queue of
``training/pipeline.py``, the transformers' prefill lengths)."""

from __future__ import annotations

from typing import Optional

# Bound on one queue of staged batches, in input bytes.
STAGE_BYTES_BUDGET = 256 * 1024 * 1024


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
