"""Batch scheduler — the counterpart of ``tpuddp/serving/scheduler.py``:
coalesces queued requests into padded batches of a few fixed shapes.

Variable-size requests concatenate row-wise, then pad to the smallest
power-of-two bucket that holds them (:func:`tpuddp_torch.utils.batching.
bucket_for`): at most ``log2(max_batch_size) + 1`` batch shapes per sample
shape, each warmed once per replica at start (cuDNN and cuBLAS choose their
kernels per shape, so a new shape on the hot path would pay that choice in
a request's latency).

Padding rows ride with weight 0 (``batching.pad_batch``) and their logits
are never sliced back to any request; occupancy (real rows / bucket rows) is
the efficiency the SLO stats report.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from tpuddp_torch.serving.queue import Request, RequestQueue
from tpuddp_torch.utils import batching


class Batch:
    """One coalesced, padded, ready-to-dispatch batch."""

    __slots__ = ("requests", "slices", "x", "w", "rows", "bucket")

    def __init__(
        self,
        requests: List[Request],
        slices: List[Tuple[int, int]],
        x: np.ndarray,
        w: np.ndarray,
    ):
        self.requests = requests
        self.slices = slices  # request i's rows are x[slices[i][0]:slices[i][1]]
        self.x = x
        # 0/1 row mask from pad_batch (already allocated by the shared
        # padding path). The dispatch loop never consumes it — padded rows
        # are simply not sliced back to any request — but masked consumers
        # (a future loss/metric head) and the padding-contract tests read it.
        self.w = w
        self.rows = sum(r.rows for r in requests)
        self.bucket = int(x.shape[0])

    @property
    def occupancy(self) -> float:
        return self.rows / self.bucket


class BatchScheduler:
    """Pulls same-shape request groups off the queue and forms padded
    bucketed batches. One instance is shared by every replica's dispatch
    loop; the queue's lock serializes assembly, the (cheap) host-side
    concatenate + pad runs outside it."""

    def __init__(
        self,
        queue: RequestQueue,
        max_batch_size: int,
        batch_timeout_ms: float = 0.0,
    ):
        if max_batch_size < 1:
            raise ValueError(f"max_batch_size must be >= 1, got {max_batch_size}")
        self.queue = queue
        self.max_batch_size = int(max_batch_size)
        self.batch_timeout_s = max(0.0, float(batch_timeout_ms)) / 1e3
        # static property, computed once: the full ladder of batch shapes
        # this scheduler can ever emit
        self.buckets = batching.bucket_sizes(self.max_batch_size)

    def form(self, requests: List[Request]) -> Batch:
        """Concatenate + pad one same-key group into a dispatchable batch."""
        assert requests, "cannot form an empty batch"
        slices: List[Tuple[int, int]] = []
        at = 0
        for r in requests:
            slices.append((at, at + r.rows))
            at += r.rows
        x = (
            requests[0].x
            if len(requests) == 1
            else np.concatenate([r.x for r in requests], axis=0)
        )
        bucket = batching.bucket_for(at, self.max_batch_size)
        x, _, w = batching.pad_batch(x, None, bucket)
        return Batch(requests, slices, x, w)

    def next_batch(self) -> Optional[Batch]:
        """Block until a batch can be formed; ``None`` = queue closed and
        drained (the dispatch loop's exit signal)."""
        group = self.queue.take_group(
            self.max_batch_size, top_up_wait=self.batch_timeout_s
        )
        if group is None:
            return None
        return self.form(group)
