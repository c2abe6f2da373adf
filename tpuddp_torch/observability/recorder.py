"""Step-level telemetry — the counterpart of
``tpuddp/observability/recorder.py``: step-time percentiles, ``step_stats``
windows and achieved MFU.

Step times are the epoch loop's CUDA-event times per update
(``training.loop.StepClock``: a mark before each dispatch, so a dispatch of
K updates gives each of them its time over K; on the CPU the host clock),
never host wall time around an asynchronous launch. The epoch row's
percentiles are taken over the pass's times, which the loop reads once
after the pass. With ``training.step_stats_every: N > 0`` the recorder also
writes one ``step_stats`` row per N updates: when a window's last dispatch
has been issued it records one more event, waits for it (the one wait of
the window; the JAX recorder fences per window likewise) and reads the
window's marks. With N = 0 it adds no wait and no device read.

MFU is measured against the dense bf16 tensor-core peak of the card's kind
(:data:`PEAK_FLOPS`, NVIDIA's spec sheets), the JAX convention of one
ceiling, the bf16 one, whatever the compute dtype
(``tpuddp/observability/recorder.py:36-47``); it is null for an unknown
kind, on the CPU, and where the FLOPs per step are unknown. The FLOPs per
step (:func:`count_step_flops`) are one forward and backward of the model
on one batch, counted by ``torch.utils.flop_counter.FlopCounterMode`` on a
copy of the model on the meta device: nothing runs on the real model, so a
run with telemetry on is bitwise the run with it off. A remat run counts
the model's FLOPs, not the recompute's.
"""

from __future__ import annotations

import copy
import time
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from tpuddp_torch.observability import schema

# Dense bf16 tensor-core peak FLOP/s by a substring of the card's name
# (NVIDIA data sheets; the sparsity figures halved), the first match wins.
PEAK_FLOPS = (
    ("H100 PCIe", 756e12),
    ("H100 NVL", 835e12),
    ("H200", 989e12),
    ("H100", 989e12),
    ("A100", 312e12),
)


def device_peak_flops(kind: Optional[str]) -> Optional[float]:
    """The bf16 peak of the card named ``kind``; None for an unknown card
    or no card (then MFU is null, never guessed)."""
    if not kind:
        return None
    for key, peak in PEAK_FLOPS:
        if key in kind:
            return peak
    return None


def percentiles(step_times_s, keys=(50, 95, 99)) -> dict:
    """``{"p50", "p95", "p99", "max"}`` in seconds over per-step times;
    all None for an empty sequence."""
    arr = np.asarray(list(step_times_s), dtype=np.float64)
    if arr.size == 0:
        return {f"p{k}": None for k in keys} | {"max": None}
    out = {f"p{k}": float(np.percentile(arr, k)) for k in keys}
    out["max"] = float(arr.max())
    return out


def step_time_fields(step_times_s, flops_per_step=None, peak_flops=None) -> dict:
    """The step-time percentiles in ms and MFU at the p50 and p95 step."""
    pct = percentiles(step_times_s)
    fields = {f"step_time_ms_{k}": (None if v is None else round(v * 1e3, 4))
              for k, v in pct.items()}

    def mfu(t):
        if t is None or not t or not flops_per_step or not peak_flops:
            return None
        return round(flops_per_step / t / peak_flops, 6)

    fields["mfu_p50"] = mfu(pct["p50"])
    fields["mfu_p95"] = mfu(pct["p95"])
    return fields


def meta_copy(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``model`` whose parameters and buffers are on the meta
    device (shapes and dtypes only, no memory) and whose BatchNorms do not
    synchronise (a meta tensor cannot take part in a collective)."""
    from tpuddp_torch.nn.norm import BatchNorm

    memo = {}
    for p in model.parameters():
        memo[id(p)] = torch.nn.Parameter(torch.empty_like(p, device="meta"),
                                         requires_grad=p.requires_grad)
    for b in model.buffers():
        memo[id(b)] = torch.empty_like(b, device="meta")
    twin = copy.deepcopy(model, memo)
    for m in twin.modules():
        if isinstance(m, BatchNorm):
            m.sync = False
    return twin


def count_step_flops(model: torch.nn.Module, input_shape: Sequence[int],
                     dtype: torch.dtype = torch.float32) -> Optional[float]:
    """FLOPs of one forward and backward of ``model`` on a batch of
    ``input_shape`` (the model's input, after the augment) in ``dtype``,
    counted on a meta copy; None when the count fails (MFU is then null)."""
    from torch.utils.flop_counter import FlopCounterMode

    try:
        twin = meta_copy(model)
        twin.train()
        x = torch.empty(tuple(input_shape), dtype=dtype, device="meta")
        with FlopCounterMode(display=False) as counter:
            twin(x).float().sum().backward()
        flops = float(counter.get_total_flops())
    except Exception:
        return None
    return flops if flops > 0 else None


class _Dispatch:
    __slots__ = ("mark", "steps", "samples")

    def __init__(self, mark, steps, samples):
        self.mark, self.steps, self.samples = mark, steps, samples


class StepStatsRecorder:
    """The ``step_stats`` windows of one run and the epoch row's fields.

    :meth:`record` is called once per dispatch, after it was issued, with
    the dispatch's updates, its real rows and the pipeline's occupancy
    sample; ``clock`` (a ``training.loop.StepClock``) holds the mark taken
    just before it. ``global_step`` counts updates since the loop's entry.

    The live plane (``tpuddp/observability/recorder.py:137-160, :285-323``):
    ``on_window`` is called after each window's row (the telemetry shard's
    publish and the pod merge ride the window's wait), and
    :meth:`live_snapshot` is the exporter's and the shard's view: running
    totals and the last window's row, or without windows percentiles over
    the newest host laps between dispatches (issue times, never a device
    read)."""

    # host laps kept for live_snapshot() without windows
    LAPS = 256

    def __init__(self, writer=None, window: int = 0, flops_per_step: Optional[float] = None,
                 peak_flops: Optional[float] = None, on_window: Optional[Callable] = None):
        self.writer = writer
        self.window = max(0, int(window or 0))
        self.flops_per_step = flops_per_step
        self.peak_flops = peak_flops
        self.on_window = on_window
        self.global_step = 0
        self.windows_emitted = 0
        self.last_window: Optional[dict] = None
        self.total_samples = 0.0
        self.total_stall_s = 0.0
        self._laps = deque(maxlen=self.LAPS)  # seconds per update between dispatches
        self._last_t: Optional[float] = None
        self._clock = None
        self._epoch = 0
        self._epoch_samples = 0.0
        self._epoch_stall = 0.0
        self._reset_window()

    def _reset_window(self) -> None:
        self._win = []
        self._win_start_step = self.global_step
        self._win_stall = 0.0
        self._win_staging_max = 0
        self._win_inflight_max = 0

    def start_epoch(self, epoch: int, clock) -> None:
        self._epoch = int(epoch)
        self._clock = clock
        self._epoch_samples = 0.0
        self._epoch_stall = 0.0
        self._laps.clear()
        self._last_t = time.perf_counter()
        self._reset_window()

    def record(self, n_steps: int, n_samples: float, *, host_stall_s: float = 0.0,
               staging_depth: int = 0, inflight_depth: int = 0) -> None:
        n_steps = max(1, int(n_steps))
        now = time.perf_counter()
        if self._last_t is not None:
            self._laps.extend([(now - self._last_t) / n_steps] * min(n_steps, self.LAPS))
        self._last_t = now
        self.global_step += n_steps
        self._epoch_samples += float(n_samples)
        self._epoch_stall += float(host_stall_s)
        self.total_samples += float(n_samples)
        self.total_stall_s += float(host_stall_s)
        if not self.window:
            return
        self._win.append(_Dispatch(self._clock.marks[-1], n_steps, float(n_samples)))
        self._win_stall += float(host_stall_s)
        self._win_staging_max = max(self._win_staging_max, int(staging_depth))
        self._win_inflight_max = max(self._win_inflight_max, int(inflight_depth))
        if self.global_step - self._win_start_step >= self.window:
            self._emit_window()

    def _emit_window(self) -> None:
        end = self._clock.fence()  # the window's one wait
        ends = [d.mark for d in self._win[1:]] + [end]
        times = []
        for d, stop in zip(self._win, ends):
            per_step = self._clock.seconds(d.mark, stop) / d.steps
            times += [per_step] * d.steps
        wall = self._clock.seconds(self._win[0].mark, end)
        samples = sum(d.samples for d in self._win)
        record = {
            "epoch": self._epoch,
            "step_start": self._win_start_step,
            "steps": self.global_step - self._win_start_step,
            **step_time_fields(times, self.flops_per_step, self.peak_flops),
            "samples_per_sec": round(samples / max(wall, 1e-9), 2),
            # the pipeline's occupancy (schema v3)
            "host_stall_ms": round(self._win_stall * 1e3, 3),
            "staging_queue_depth": int(self._win_staging_max),
            "inflight_depth": int(self._win_inflight_max),
        }
        if self.writer is not None:
            self.writer.write(schema.stamp("step_stats", record))
        self.last_window = record  # the live plane reads what the history got
        self.windows_emitted += 1
        self._reset_window()
        if self.on_window is not None:
            self.on_window()

    def live_snapshot(self) -> dict:
        """The live view (host values only): running totals and the last
        window's fields, or without windows the percentiles of the newest
        host laps of this epoch and no throughput."""
        snap = {
            "epoch": self._epoch,
            "step": self.global_step,
            "samples_total": self.total_samples,
            "host_stall_ms_total": round(self.total_stall_s * 1e3, 3),
            "windows_emitted": self.windows_emitted,
        }
        last = self.last_window
        if last is not None:
            for k in ("step_time_ms_p50", "step_time_ms_p95", "step_time_ms_p99",
                      "step_time_ms_max", "samples_per_sec", "mfu_p50", "host_stall_ms"):
                snap[k] = last.get(k)
            snap["window"] = {k: last.get(k) for k in ("epoch", "step_start", "steps")}
        else:
            snap.update(step_time_fields(list(self._laps), self.flops_per_step,
                                         self.peak_flops))
            snap["samples_per_sec"] = None
            snap["window"] = None
        return snap

    def epoch_summary(self, step_ms: Sequence[float]) -> dict:
        """The epoch row's fields from the pass's times per update
        (``StepClock.step_ms``): percentiles, MFU, the train pass's
        samples/s over those times and its host stall."""
        times = [t / 1e3 for t in step_ms]
        return {
            "train_steps": len(times),
            **step_time_fields(times, self.flops_per_step, self.peak_flops),
            "train_samples_per_sec": round(self._epoch_samples / max(sum(times), 1e-9), 2),
            "host_stall_ms": round(self._epoch_stall * 1e3, 3),
        }
