"""Cross-host telemetry shards and the straggler detector — the counterpart
of ``tpuddp/observability/aggregate.py``.

Each host's heartbeat file (``hb_<host>``, :mod:`tpuddp_torch.resilience.
watchdog`) carries a one-line JSON *shard* under its timestamp: the host's
last window's step-time p50, its host stall, its skipped updates, and a
wall/monotonic clock pair. Its local rank 0 rewrites it at each
``step_stats`` window (the window's one wait is already done there) and on
every heartbeat while the watchdog is armed: no collective and no device
read is added; the shared run directory carries the shards.

Process 0 runs a :class:`PodAggregator`: at each window and each epoch's
end it merges the shards into pod percentiles (the exporter's ``pod_*``
series) and finds stragglers: a host whose window p50 exceeds
``straggler_ratio`` x the pod median for ``straggler_windows``
consecutive fresh windows gets exactly one ``straggler`` event row, and
another only after it has recovered. A torn shard (a peer in mid-rewrite)
is skipped with a warning; it never stops the aggregator or the run.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Optional

from tpuddp_torch.observability import schema

logger = logging.getLogger("tpuddp")

# what a shard holds (make_shard); all optional but the window cursor
SHARD_FIELDS = ("window_index", "epoch", "step", "step_time_ms_p50", "host_stall_ms",
                "skipped_steps", "samples_per_sec")


def make_shard(live: dict, skipped_steps: int = 0, window_index: Optional[int] = None) -> dict:
    """One host's shard from a recorder's ``live_snapshot()``; ``clock``
    pairs the host's unix microseconds with the ``perf_counter_ns`` taken
    beside it (the cross-host skew of two trace artifacts)."""
    return {
        "window_index": (int(window_index) if window_index is not None
                         else int(live.get("windows_emitted") or 0)),
        "epoch": live.get("epoch"),
        "step": live.get("step"),
        "step_time_ms_p50": live.get("step_time_ms_p50"),
        "host_stall_ms": live.get("host_stall_ms_total"),
        "skipped_steps": int(skipped_steps or 0),
        "samples_per_sec": live.get("samples_per_sec"),
        "t": time.time(),
        "clock": {"unix_us": int(time.time() * 1e6), "perf_ns": time.perf_counter_ns()},
    }


def publish_shard(directory: str, process_id: int, shard: dict) -> None:
    """Rewrite this host's heartbeat file with ``shard`` (staged and
    renamed: a reader sees the old file or the new one; the timestamp rides
    along, so publishing is a beat too)."""
    from tpuddp_torch.resilience import watchdog as wd

    try:
        wd.write_heartbeat(directory, process_id, payload=shard)
    except OSError as e:  # a shared filesystem's hiccup: telemetry is best-effort
        logger.warning("telemetry shard publish failed: %s", e)


def read_shard(directory: str, process_id: int) -> Optional[dict]:
    """That host's shard, or None (no file, no payload yet, or a torn line,
    skipped with a warning)."""
    from tpuddp_torch.resilience import watchdog as wd

    return wd.read_heartbeat_payload(directory, process_id)


class PodAggregator:
    """Process 0's merge of the hosts' shards. :meth:`update` runs at the
    window cadence and at each epoch's end: file reads and arithmetic.
    ``writer`` (the run's ``MetricsWriter``) gets the ``straggler`` rows;
    None keeps them in memory."""

    def __init__(self, directory: str, num_processes: int, writer=None,
                 straggler_ratio: float = 1.5, straggler_windows: int = 3,
                 shard_reader: Optional[Callable[[int], Optional[dict]]] = None):
        if straggler_ratio <= 1.0:
            raise ValueError(
                f"straggler_ratio must be > 1.0, got {straggler_ratio} "
                "(a host at the pod median would be a 'straggler')"
            )
        if straggler_windows < 1:
            raise ValueError(f"straggler_windows must be >= 1, got {straggler_windows}")
        self.directory = directory
        self.num_processes = int(num_processes)
        self.writer = writer
        self.straggler_ratio = float(straggler_ratio)
        self.straggler_windows = int(straggler_windows)
        self._read = shard_reader or (lambda pid: read_shard(self.directory, pid))
        self._last_window: Dict[int, int] = {}  # host -> the window cursor last seen
        self._streak: Dict[int, int] = {}  # host -> consecutive slow fresh windows
        self._fired: set = set()  # hosts in an episode already reported
        self.straggler_events = 0
        self.last: Optional[dict] = None

    def collect(self) -> Dict[int, dict]:
        shards = {}
        for pid in range(self.num_processes):
            shard = self._read(pid)
            if shard is not None:
                shards[pid] = shard
        return shards

    def update(self) -> Optional[dict]:
        """Merge the current shards and record stragglers; the pod view
        (also ``self.last``), or None while no shard is readable."""
        import numpy as np

        shards = self.collect()
        p50s = {pid: s["step_time_ms_p50"] for pid, s in shards.items()
                if isinstance(s.get("step_time_ms_p50"), (int, float))}
        if not p50s:
            return None
        values = np.asarray(list(p50s.values()), np.float64)
        pod_median = float(np.median(values))
        merged = {
            "hosts_reporting": len(p50s),
            "pod_step_time_ms_p50": round(pod_median, 4),
            "pod_step_time_ms_max": round(float(values.max()), 4),
            "pod_step_time_ms_p95": round(float(np.percentile(values, 95)), 4),
            "pod_host_stall_ms": round(sum(float(s.get("host_stall_ms") or 0.0)
                                           for s in shards.values()), 3),
            "pod_skipped_steps": sum(int(s.get("skipped_steps") or 0) for s in shards.values()),
            "hosts": {
                str(pid): {k: shards[pid].get(k) for k in (
                    "window_index", "epoch", "step", "step_time_ms_p50", "host_stall_ms",
                    "skipped_steps", "clock")}
                for pid in sorted(shards)
            },
            "stragglers": [],
        }
        for pid, p50 in sorted(p50s.items()):
            win = int(shards[pid].get("window_index") or 0)
            # fresh = the cursor moved, either way (a resumed run counts its
            # windows again from 0 under a leftover shard)
            fresh = win != self._last_window.get(pid)
            self._last_window[pid] = win
            ratio = (p50 / pod_median) if pod_median > 0 else 1.0
            if ratio > self.straggler_ratio:
                if fresh:  # a stalled shard cannot convict a host on one window
                    self._streak[pid] = self._streak.get(pid, 0) + 1
            else:
                self._streak[pid] = 0
                self._fired.discard(pid)  # recovered: a relapse is reported again
            streak = self._streak.get(pid, 0)
            if streak >= self.straggler_windows:
                merged["stragglers"].append(pid)
                if pid not in self._fired:
                    self._fired.add(pid)
                    self.straggler_events += 1
                    event = {
                        "event": "straggler",
                        "host": pid,
                        "ratio": round(ratio, 3),
                        "windows": streak,
                        "window_p50_ms": round(float(p50), 4),
                        "pod_p50_ms": round(pod_median, 4),
                        "epoch": shards[pid].get("epoch"),
                        "step": shards[pid].get("step"),
                    }
                    logger.warning(
                        "straggler: host %d window p50 %.2f ms is %.2fx the pod median %.2f ms "
                        "for %d consecutive window(s)", pid, p50, ratio, pod_median, streak,
                    )
                    if self.writer is not None:
                        self.writer.write(schema.stamp("event", event))
        self.last = merged
        return merged

    def export_source(self) -> Callable[[], dict]:
        """The exporter's ``pod`` source: the last merge's gauges and the
        per-host series (a scrape never reads the shard files)."""
        from tpuddp_torch.observability import exporter as exp

        def source():
            merged = self.last
            if merged is None:
                return {}
            series = {
                "pod_hosts_reporting": exp.gauge(merged["hosts_reporting"],
                                                 "hosts with a readable shard"),
                "pod_step_time_ms": exp.summary(
                    {"0.5": merged["pod_step_time_ms_p50"],
                     "0.95": merged["pod_step_time_ms_p95"],
                     "1.0": merged["pod_step_time_ms_max"]},
                    "pod-level percentiles over per-host window p50s",
                ),
                "pod_stragglers": exp.gauge(len(merged["stragglers"]),
                                            "hosts currently past the straggler threshold"),
                "pod_straggler_events_total": exp.counter(self.straggler_events,
                                                          "straggler episodes reported"),
            }
            host_series = {"type": "gauge", "help": "per-host last-window step-time p50",
                           "values": []}
            for pid, h in merged["hosts"].items():
                host_series["values"].append(({"host": pid}, h.get("step_time_ms_p50")))
            series["host_step_time_ms_p50"] = host_series
            return series

        return source
