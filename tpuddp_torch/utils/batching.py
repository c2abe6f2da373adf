"""The staging budget and the depth policy that every queue of batches
ahead of the step is capped by — the port's copy of the part of
``tpuddp/utils/batching.py`` it uses (``PrefetchLoader``'s host queue and the
staged device queue of ``training/pipeline.py``)."""

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
