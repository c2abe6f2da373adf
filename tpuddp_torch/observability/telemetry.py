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

The live plane attaches here too (``tpuddp/observability/telemetry.py:
103-305``): :meth:`RunTelemetry.attach_live` gives the exporter this run's
``training`` source (and process 0's ``pod`` source), arms this host's
telemetry shard in the heartbeat file and the pod aggregator, all pumped
at the ``step_stats`` window the recorder already waits for, so the plane
adds no wait, no read of the device and no collective.
:meth:`RunTelemetry.update_live` adds what the recorder cannot see (the
last epoch's losses, the guard's skips, the wire bytes).
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
                                          peak_flops=device_peak_flops(self.device_kind),
                                          on_window=self._on_window)
        self.window_profiler = profiling.StepWindowProfiler(save_dir)
        self.writer = writer
        self.save_dir = save_dir
        self.flops_fn = flops_fn
        self._flops_probed = False
        self._first_epoch = True
        self._epoch_trace = None  # the trigger of a running epoch trace
        self._epoch = 0
        # the live plane (attach_live): the exporter, the aggregator, the
        # shard's directory and host, and the loop's gauges
        self.exporter = None
        self.aggregator = None
        self._shard_dir = None
        self._shard_pid = 0
        self.live: dict = {}
        profiling.install_sigusr1_trigger()

    def attach_live(self, exporter=None, aggregator=None, shard_dir: Optional[str] = None,
                    process_id: int = 0) -> None:
        """Wire the live plane: ``exporter`` gets the ``training`` source
        (and ``pod`` with an ``aggregator``); ``shard_dir`` arms this host's
        shard (``process_id``), published at each window and carried by
        every heartbeat; ``aggregator`` (process 0) merges at each window."""
        self.exporter = exporter
        self.aggregator = aggregator
        self._shard_dir = shard_dir
        self._shard_pid = int(process_id)
        if exporter is not None:
            exporter.register_source("training", self.export_source())
            if aggregator is not None:
                exporter.register_source("pod", aggregator.export_source())
        if shard_dir is not None:
            from tpuddp_torch.resilience import watchdog as wd

            wd.set_heartbeat_payload(self._shard)

    def update_live(self, **fields) -> None:
        """The loop's gauges (``train_loss``, ``test_loss``,
        ``test_accuracy``, ``skipped_steps``, ``grad_comm_bytes_total``),
        in the ``training`` source and the shard."""
        self.live.update(fields)

    def _shard(self) -> dict:
        from tpuddp_torch.observability import aggregate

        return aggregate.make_shard(self.recorder.live_snapshot(),
                                    skipped_steps=self.live.get("skipped_steps") or 0)

    def _on_window(self) -> None:
        """After each window's row: publish this host's shard and merge the
        pod view (file writes and arithmetic)."""
        if self._shard_dir is not None:
            from tpuddp_torch.observability import aggregate

            aggregate.publish_shard(self._shard_dir, self._shard_pid, self._shard())
        if self.aggregator is not None:
            self.aggregator.update()

    def export_source(self):
        """The exporter's ``training`` source: running totals and the last
        window's percentiles (what ``history.jsonl`` holds)."""
        from tpuddp_torch.observability import exporter as exp

        def source():
            live = self.recorder.live_snapshot()
            series = {
                "train_steps_total": exp.counter(live.get("step"), "train steps since loop entry"),
                "train_samples_total": exp.counter(live.get("samples_total"),
                                                   "global samples dispatched"),
                "epoch": exp.gauge(live.get("epoch"), "current epoch"),
                "step_time_ms": exp.summary(
                    {"0.5": live.get("step_time_ms_p50"), "0.95": live.get("step_time_ms_p95"),
                     "0.99": live.get("step_time_ms_p99"), "1.0": live.get("step_time_ms_max")},
                    "last-window per-step wall time",
                ),
                "train_samples_per_sec": exp.gauge(live.get("samples_per_sec"),
                                                   "last-window throughput"),
                "mfu": exp.gauge(live.get("mfu_p50"), "last-window achieved MFU at p50"),
                "host_stall_ms_total": exp.counter(live.get("host_stall_ms_total"),
                                                   "cumulative host-blocked time"),
                "step_stats_windows_total": exp.counter(live.get("windows_emitted"),
                                                        "step_stats rows flushed"),
            }
            for key, help_text in (
                ("skipped_steps", "guard-skipped updates (total)"),
                ("grad_comm_bytes_total", "gradient bytes on the wire"),
                ("train_loss", "last completed epoch train loss"),
                ("test_loss", "last completed epoch test loss"),
                ("test_accuracy", "last completed epoch test accuracy (%)"),
            ):
                if key in self.live:
                    kind = (exp.counter if key in ("skipped_steps", "grad_comm_bytes_total")
                            else exp.gauge)
                    series[key] = kind(self.live[key], help_text)
            return series

        return source

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
        end writes its partial trace, any epoch trace is written, and the
        live plane lets go (a heartbeat must not carry a shard of a
        finished run; the exporter drops this run's sources)."""
        self._written(self.window_profiler.finish(self._fence), "steps",
                      steps=list(self.window_profiler.window or ()))
        self.stop_epoch_trace()
        if self._shard_dir is not None:
            from tpuddp_torch.resilience import watchdog as wd

            wd.set_heartbeat_payload(None)
            self._shard_dir = None
        if self.exporter is not None:
            self.exporter.unregister_source("training")
            self.exporter.unregister_source("pod")
            self.exporter = None
        self.aggregator = None
