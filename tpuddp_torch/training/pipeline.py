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

``poll`` (the preemption flag) is checked at each batch boundary before
the batch is staged (``tpuddp/training/pipeline.py:240-249, :367-420``):
an interrupted pass stops after the last dispatch already issued, the
batches staged but not dispatched are dropped (the resumed run fetches
them again), and :attr:`StagedLoader.interrupted` says so; the epoch
loop's dispatch plan then drops its partial chunk too. A flag raised while
the last batches are dispatched marks the pass interrupted at its end.

``device_augment: false`` runs the managed path's augment as its own op on
each batch before the step (``train_accelerate.py``); the native step always
augments inside, as the JAX native step does, so there it changes nothing.

The trace hooks of the JAX ``run_pass`` (``tpuddp/training/pipeline.py:
291-364``): with a live tracer (:attr:`StagedLoader.tracer`) each unit of
:attr:`StagedLoader.stage_plan` (one dispatch's batches, :func:`stage_units`)
is one ``stage`` span under :attr:`StagedLoader.trace_parent`, from the
placement of its first batch to that of its last. The lookahead is in
batches, so at a depth over 0 the previous dispatch is issued in between:
the spans sit on a timeline row of their own (``tid`` ``stage``).
The epoch loops own the other spans and the telemetry hooks
(:mod:`tpuddp_torch.observability`). A consumer that fences its own
dispatches under ``sync_readback`` (the native loop, inside its dispatch
span) sets :attr:`StagedLoader.fence_in_consumer`.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import asdict, dataclass
from typing import Callable, Optional

import numpy as np
import torch

from tpuddp_torch.observability import trace as trace_lib
from tpuddp_torch.utils import batching

PIPELINE_DEFAULTS = {
    "depth": 2,  # batches staged on the device ahead of the step
    "host_workers": 2,  # PrefetchLoader threads (0: loading inline)
    "device_augment": True,  # managed: augment inside the step (false: its own op first)
    "sync_readback": False,  # synchronise after every step (the A/B baseline)
}

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
    from tpuddp_torch.config import _merge_refusing_unknown

    if isinstance(block, PipelineConfig):
        return block
    if block is None or block is True:
        return DEFAULT
    if block is False:
        return SYNCHRONOUS
    if not isinstance(block, dict):
        raise ValueError(f"training.pipeline must be true/false or a mapping, got {block!r}")
    merged = _merge_refusing_unknown(PIPELINE_DEFAULTS, block, "training.pipeline")
    cfg = PipelineConfig(
        depth=int(merged["depth"]), host_workers=int(merged["host_workers"]),
        device_augment=bool(merged["device_augment"]),
        sync_readback=bool(merged["sync_readback"]),
    )
    if cfg.depth < 1:
        raise ValueError(f"training.pipeline.depth must be >= 1, got {cfg.depth}")
    if cfg.host_workers < 0:
        raise ValueError(f"training.pipeline.host_workers must be >= 0, got {cfg.host_workers}")
    return cfg


def stage_units(n_batches: int, k: int, accum: int = 1):
    """The ``(batches, steps)`` of each dispatch of a pass of ``n_batches``
    at ``k`` batches a chunk (the dispatch plan of ``training.loop.
    dispatches``): full chunks of ``k``; then under ``accum > 1`` the tail
    as one dispatch, ``steps`` padded to whole cycles; else single steps."""
    if k <= 1 and accum <= 1:
        return [(1, 1)] * n_batches
    units = [(k, k)] * (n_batches // k)
    rem = n_batches % k
    if rem and accum > 1:
        return units + [(rem, rem + (-rem % accum))]
    return units + [(1, 1)] * rem


def staging_depth_for(depth: int, batch_nbytes) -> int:
    """``depth`` staged batches, capped so that depth x batch bytes stays
    inside the staging budget."""
    return batching.resolve_fuse(batch_nbytes, cap=max(1, int(depth)))


class StallClock:
    """The time a pass spends waiting for host batches: with loader threads,
    the time their queue was empty; without, the host's batch assembly."""

    def __init__(self):
        self.total = 0.0
        self._taken = 0.0

    def add(self, dt: float) -> None:
        self.total += dt

    def take(self) -> float:
        """The stall since the last ``take`` (a dispatch's occupancy
        sample, ``step_stats``' ``host_stall_ms``)."""
        dt, self._taken = self.total - self._taken, self.total
        return dt


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
    to stage in its place (the ``$TPUDDP_FAULT`` step hook); ``poll()``,
    when set, is checked after it: True stops the pass (module doc,
    :attr:`interrupted`). ``stall`` is
    the last pass's :class:`StallClock`; :meth:`take_rows` gives the real
    rows of the next batches consumed, from the host weights, and
    ``staged_depth`` the batches staged ahead when the last one was
    handed out (the telemetry's occupancy fields)."""

    def __init__(self, loader, device, cfg: PipelineConfig = DEFAULT,
                 probe: Optional[Callable] = None, inject: Optional[Callable] = None,
                 poll: Optional[Callable] = None):
        self.loader = loader
        self.device = torch.device(device)
        self.cfg = cfg
        self.probe = probe
        self.inject = inject
        self.poll = poll
        self.interrupted = False
        self.stall = StallClock()
        self._rows = deque()
        self.staged_depth = 0
        self.tracer = trace_lib.NULL_TRACER
        self.trace_parent = None
        self.stage_plan = None  # the pass's stage_units (traced)
        self.fence_in_consumer = False

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def fence(self) -> None:
        """Under ``sync_readback``, wait for the device (the synchronous
        A/B mode's one wait a step)."""
        if self.cfg.sync_readback and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _fence(self) -> None:
        if not self.fence_in_consumer:
            self.fence()

    def take_rows(self, n: int) -> float:
        """The real rows (the weights' sum) of the next ``n`` batches
        consumed."""
        return sum(self._rows.popleft() for _ in range(min(n, len(self._rows))))

    def _polled(self) -> bool:
        self.interrupted = self.interrupted or (self.poll is not None and bool(self.poll()))
        return self.interrupted

    def __iter__(self):
        self.stall = StallClock()
        self._rows.clear()
        self.interrupted = False
        depth = 0 if self.cfg.sync_readback else staging_depth_for(
            self.cfg.depth, getattr(self.loader, "batch_nbytes", None)
        )
        staged = deque()
        tracer = self.tracer
        plan = iter(self.stage_plan or ()) if tracer.enabled else None
        unit = {"left": 0, "span": None}
        try:
            for i, host_batch in enumerate(stalled_iter(self.loader, self.stall)):
                if self.probe is not None:
                    self.probe(i, host_batch)
                if self.inject is not None:
                    host_batch = self.inject(host_batch)
                if self._polled():
                    return  # what was staged is dropped: the resume fetches it again
                self._rows.append(float(np.asarray(host_batch[2], dtype=np.float64).sum()))
                if plan is not None and not unit["left"]:
                    n, steps = next(plan, (1, 1))
                    unit["left"] = n
                    unit["span"] = tracer.start_span(
                        "stage", trace_lib.KIND_STAGE, parent=self.trace_parent, tid="stage",
                        attrs={"steps": steps})
                staged.append(stage_batch(host_batch, self.device))
                if plan is not None:
                    unit["left"] -= 1
                    if not unit["left"]:
                        tracer.end_span(unit["span"])
                while len(staged) > depth:
                    self.staged_depth = len(staged) - 1
                    yield staged.popleft()
                    self._fence()
            if self._polled():
                return
            while staged:
                self.staged_depth = len(staged) - 1
                yield staged.popleft()
                self._fence()
            self._polled()  # a flag raised during the last dispatches ends the pass interrupted
        finally:
            tracer.end_span(unit["span"])  # a unit cut by the drain (a closed span: a no-op)
