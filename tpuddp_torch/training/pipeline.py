"""Host-to-device staging — the counterpart of the part of
``tpuddp/training/pipeline.py`` that the default ``pipeline: None`` runs.

The ``training.pipeline`` block (:func:`resolve_pipeline`) sets how many
batches are staged on the device ahead of the step that consumes them
(``depth``), how many ``PrefetchLoader`` threads assemble host batches
(``host_workers``; the entry points wrap their loaders), and the synchronous
A/B mode (``sync_readback``: block on every step before the next batch is
staged). ``pipeline: false`` is that synchronous mode with no loader
threads.

:class:`StagedLoader` does the staging. Each host batch is copied into a
fresh pinned tensor (``Tensor.pin_memory()``, from PyTorch's caching host
allocator, which does not hand a block out again while a copy from it is in
flight) and sent with ``non_blocking=True``, so the host queues the copies
and the steps ``depth`` batches ahead of the device instead of waiting on a
pageable copy before every step. Batches, order and arithmetic are the
synchronous pass's, so the result is bitwise the same at every depth.
:class:`StallClock` sums the time the pass waits for host batches.

``device_augment: false`` and the telemetry and trace hooks of the JAX
``run_pass`` are not ported (ROADMAP.md Queue 1 item 8).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import asdict, dataclass
from typing import Callable, Optional

import numpy as np
import torch

from tpuddp_torch.utils import batching

PIPELINE_DEFAULTS = {
    "depth": 2,  # batches staged on the device ahead of the step
    "host_workers": 2,  # PrefetchLoader threads (0: loading inline)
    "device_augment": True,  # augment inside the step (the port's only mode)
    "sync_readback": False,  # synchronise after every step (the A/B baseline)
}

PIPELINE_ITEM = "Queue 1 item 8: async pipeline"


@dataclass(frozen=True)
class PipelineConfig:
    depth: int = 2
    host_workers: int = 2
    device_augment: bool = True
    sync_readback: bool = False

    def as_dict(self) -> dict:
        return asdict(self)


DEFAULT = PipelineConfig()
# ``pipeline: false``: no lookahead, no loader threads, one synchronise per step
SYNCHRONOUS = PipelineConfig(depth=1, host_workers=0, sync_readback=True)


def resolve_pipeline(block) -> PipelineConfig:
    """The ``training.pipeline`` knob: None or True -> :data:`DEFAULT`,
    False -> :data:`SYNCHRONOUS`, a mapping -> the defaults overridden, with
    unknown keys refused (``tpuddp/training/pipeline.py:86-117``)."""
    from tpuddp_torch.config import _merge_refusing_unknown, _not_ported

    if isinstance(block, PipelineConfig):
        cfg = block
    elif block is None or block is True:
        cfg = DEFAULT
    elif block is False:
        cfg = SYNCHRONOUS
    elif isinstance(block, dict):
        merged = _merge_refusing_unknown(PIPELINE_DEFAULTS, block, "training.pipeline")
        cfg = PipelineConfig(
            depth=int(merged["depth"]), host_workers=int(merged["host_workers"]),
            device_augment=bool(merged["device_augment"]),
            sync_readback=bool(merged["sync_readback"]),
        )
        if cfg.depth < 1:
            raise ValueError(f"training.pipeline.depth must be >= 1, got {cfg.depth}")
        if cfg.host_workers < 0:
            raise ValueError(
                f"training.pipeline.host_workers must be >= 0, got {cfg.host_workers}"
            )
    else:
        raise ValueError(f"training.pipeline must be true/false or a mapping, got {block!r}")
    if not cfg.device_augment:
        raise _not_ported("training.pipeline.device_augment=False", PIPELINE_ITEM)
    return cfg


def staging_depth_for(depth: int, batch_nbytes) -> int:
    """``depth`` staged batches, capped so that depth x batch bytes stays
    inside the staging budget."""
    return batching.resolve_fuse(batch_nbytes, cap=max(1, int(depth)))


class StallClock:
    """The time a pass spends waiting for host batches: with loader threads,
    the time their queue was empty; without, the host's batch assembly."""

    def __init__(self):
        self.total = 0.0

    def add(self, dt: float) -> None:
        self.total += dt


def stalled_iter(loader, stall: StallClock):
    it = iter(loader)
    while True:
        t0 = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            return
        stall.add(time.perf_counter() - t0)
        yield batch


def _on(t: torch.Tensor, device: torch.device) -> bool:
    return t.device.type == device.type and (
        device.index is None or t.device.index == device.index
    )


def to_device(a, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a`` (a host array or a tensor) on ``device``, in ``dtype`` if given.
    A tensor already there passes as it is. To a GPU, a host array is cast
    on the host, copied into a fresh pinned tensor and sent with
    ``non_blocking=True``: the call returns before the copy lands, and the
    copy is ordered before any later work on the current stream."""
    t = a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))
    if _on(t, device):
        return t if dtype is None else t.to(dtype)
    if dtype is not None:
        t = t.to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def stage_batch(batch, device: torch.device):
    """A host ``(x, y, w)`` batch on ``device``: x as it is, y int64, w
    float32."""
    x, y, w = batch
    return (
        to_device(x, device),
        to_device(y, device, torch.int64),
        to_device(w, device, torch.float32),
    )


class StagedLoader:
    """``loader``'s batches on ``device``, staged ``cfg.depth`` batches
    (byte-capped) ahead of the consumer; under ``cfg.sync_readback`` each
    batch is staged just before its step and the device is synchronised
    after every step. ``probe(index, host_batch)`` sees each host batch
    before it is staged; ``inject(host_batch)``, when set, returns the batch
    to stage in its place (the ``nan@step=N`` fault injection). ``stall`` is
    the last pass's :class:`StallClock`."""

    def __init__(self, loader, device, cfg: PipelineConfig = DEFAULT,
                 probe: Optional[Callable] = None, inject: Optional[Callable] = None):
        self.loader = loader
        self.device = torch.device(device)
        self.cfg = cfg
        self.probe = probe
        self.inject = inject
        self.stall = StallClock()

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def _fence(self) -> None:
        if self.cfg.sync_readback and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __iter__(self):
        self.stall = StallClock()
        depth = 0 if self.cfg.sync_readback else staging_depth_for(
            self.cfg.depth, getattr(self.loader, "batch_nbytes", None)
        )
        staged = deque()
        for i, host_batch in enumerate(stalled_iter(self.loader, self.stall)):
            if self.probe is not None:
                self.probe(i, host_batch)
            if self.inject is not None:
                host_batch = self.inject(host_batch)
            staged.append(stage_batch(host_batch, self.device))
            while len(staged) > depth:
                yield staged.popleft()
                self._fence()
        while staged:
            yield staged.popleft()
            self._fence()
