"""RunTelemetry — the counterpart of ``tpuddp/observability/telemetry.py``:
the one object an epoch loop wires through its passes. It bundles the step
recorder and the three profiling triggers behind these calls::

    tel.start_epoch(epoch, clock)        # a StepClock per train pass
    tel.pre_dispatch(n_steps)            # before issuing a dispatch
    tel.post_dispatch(n_steps, n_samples, host_stall_s=..., ...)
    fields = tel.end_epoch(step_ms)      # the epoch row's fields
    tel.stop_epoch_trace()               # after the eval pass
    tel.finish()                         # the loop's ``finally``

Everything is host-side: no collective is added, and the only waits for
the device are the ``step_stats`` window's one and a trace's end. Each
trace that is written adds a ``profile`` event row naming its file (a
SIGUSR1 trace also the JAX package's ``profile_epoch`` row at its start).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from tpuddp_torch.observability import profiling, schema
from tpuddp_torch.observability.recorder import StepStatsRecorder, device_peak_flops


class RunTelemetry:
    def __init__(self, writer=None, save_dir: Optional[str] = None, step_stats_every: int = 0,
                 device: Optional[torch.device] = None,
                 flops_fn: Optional[Callable[[], Optional[float]]] = None):
        """``device`` is the run's (MFU uses its kind's peak: none on the
        CPU); ``flops_fn()`` gives the FLOPs of one update, called once, at
        the first epoch's end (None leaves MFU null)."""
        self.device = torch.device("cpu" if device is None else device)
        cuda = self.device.type == "cuda"
        self.device_kind = torch.cuda.get_device_name(self.device) if cuda else None
        self.recorder = StepStatsRecorder(writer, step_stats_every,
                                          peak_flops=device_peak_flops(self.device_kind))
        self.window_profiler = profiling.StepWindowProfiler(save_dir)
        self.writer = writer
        self.save_dir = save_dir
        self.flops_fn = flops_fn
        self._flops_probed = False
        self._first_epoch = True
        self._epoch_trace = None  # the trigger of a running epoch trace
        self._epoch = 0
        profiling.install_sigusr1_trigger()

    def _fence(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _event(self, name: str, **fields) -> None:
        if self.writer is not None:
            self.writer.write(schema.stamp("event", {"event": name, **fields}))

    def _written(self, path: Optional[str], trigger: str, **fields) -> None:
        if path is not None:
            self._event("profile", trigger=trigger, path=path, **fields)

    def start_epoch(self, epoch: int, clock) -> None:
        self._epoch = int(epoch)
        self.recorder.start_epoch(epoch, clock)
        if self._first_epoch:
            self._first_epoch = False
            if profiling.maybe_start_profiler(self.save_dir):
                self._epoch_trace = "first_epoch"
        if profiling.consume_sigusr1_request() and profiling.start_epoch_trace(self.save_dir,
                                                                               epoch):
            self._epoch_trace = "sigusr1"
            self._event("profile_epoch", epoch=epoch)

    def pre_dispatch(self, n_steps: int) -> None:
        self.window_profiler.before_dispatch(self.recorder.global_step, n_steps)

    def post_dispatch(self, n_steps: int, n_samples: float, *, host_stall_s: float = 0.0,
                      staging_depth: int = 0, inflight_depth: int = 0) -> None:
        self.recorder.record(n_steps, n_samples, host_stall_s=host_stall_s,
                             staging_depth=staging_depth, inflight_depth=inflight_depth)
        path = self.window_profiler.after_dispatch(self.recorder.global_step, self._fence)
        self._written(path, "steps", steps=list(self.window_profiler.window or ()))

    def end_epoch(self, step_ms) -> dict:
        """The epoch row's step-time and MFU fields from the pass's times
        per update; the FLOPs are counted here once, at the first epoch."""
        if not self._flops_probed and self.flops_fn is not None:
            self._flops_probed = True
            self.recorder.flops_per_step = self.flops_fn()
        return self.recorder.epoch_summary(step_ms)

    def stop_epoch_trace(self) -> None:
        """Write a running first-epoch or SIGUSR1 trace (after the eval pass,
        so the trace holds the whole epoch)."""
        if self._epoch_trace is not None:
            trigger, self._epoch_trace = self._epoch_trace, None
            self._written(profiling.stop_profiler(self._fence), trigger, epoch=self._epoch)

    def finish(self) -> None:
        """The loop's ``finally``: a step window that never reached its
        end writes its partial trace, and any epoch trace is written."""
        self._written(self.window_profiler.finish(self._fence), "steps",
                      steps=list(self.window_profiler.window or ()))
        self.stop_epoch_trace()
