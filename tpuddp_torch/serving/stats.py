"""SLO metrics — the counterpart of ``tpuddp/serving/stats.py``, the request
engine's typed record stream.

Per-request latency decomposes against the three timestamps the engine
already takes (admission, dispatch, delivery):

- ``queue_ms``  — admission -> the request's batch dispatched (scheduling +
  coalescing wait; the overload-visible number);
- ``device_ms`` — dispatch -> logits delivered (the warm forward on the
  replica's device and the host fetch; shared by every request of a batch);
- ``e2e_ms``    — admission -> delivery (what the client experiences).

Every ``stats_window`` completed requests, one ``serving_stats`` row (schema
v2, :mod:`tpuddp_torch.observability.schema`) lands in ``history.jsonl``
with the window's percentiles, throughput, reject counts, and batch
occupancy — the same typed, validated stream training telemetry uses.

All bookkeeping is host-side and lock-guarded; nothing here ever touches a
device or the dispatch hot path beyond list appends.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from typing import Optional

from tpuddp_torch.observability import schema
from tpuddp_torch.observability.recorder import percentiles

# Bound the retained CUMULATIVE per-request latency lists: a long-lived
# server must not grow host memory per request. Only :meth:`summary` /
# :meth:`since` read these — past the cap their percentiles cover the first
# _MAX_SAMPLES requests (reported via ``latency_samples_dropped``). The
# per-WINDOW lists reset every window and are never capped, so the
# serving_stats record stream stays live for the whole run.
_MAX_SAMPLES = 200_000


def _pct_ms(values) -> dict:
    """p50/p95/p99/max of a millisecond series (None-safe on empty)."""
    out = percentiles(values)  # unit-agnostic: ms in, ms out
    return {k: (None if v is None else round(v, 3)) for k, v in out.items()}


class ServingStats:
    """Aggregates request/batch telemetry and emits ``serving_stats`` rows.

    ``writer`` is a ``MetricsWriter`` (or None for in-memory-only use, e.g.
    unit tests and load generators that read :meth:`summary` directly)."""

    def __init__(self, writer=None, window: int = 64):
        self.writer = writer
        self.window = max(0, int(window))
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        # cumulative
        self.submitted = 0
        self.completed = 0
        self.completed_rows = 0
        self.rejects = Counter()
        self.per_tenant_completed = Counter()
        self.batches = 0
        self.bucket_rows = 0
        # survivability accounting (serving/survive.py): queued
        # requests shed past their deadline (also counted in
        # rejects["deadline_exceeded"] — a shed IS a rejection) and
        # transient dispatch failures re-queued within the retry budget
        self.shed = 0
        self.retries = 0
        self._queue_ms: list = []
        self._device_ms: list = []
        self._e2e_ms: list = []
        self._lat_dropped = 0  # cumulative samples past _MAX_SAMPLES
        # window-local latency lists: reset at every emit, never capped —
        # the serving_stats stream must stay live on arbitrarily long runs
        self._win_queue_ms: list = []
        self._win_device_ms: list = []
        self._win_e2e_ms: list = []
        self._win_index = 0
        self._win_t0 = self._t0
        self._win_start = dict(
            completed=0, submitted=0, rejected=0, batches=0, rows=0,
            bucket_rows=0, shed=0, retries=0,
        )
        # live-plane state: the last emitted serving_stats record — what a
        # /metrics scrape serves, so live values can never disagree with the
        # flushed history beyond one window
        self.last_window: Optional[dict] = None

    # ------------------------------------------------------------ recording --
    def reset_clock(self) -> None:
        """Restart the run + window wall clocks. The engine calls this when
        it finishes warmup: window 0's throughput must measure serving, not
        the buckets' warm-up."""
        with self._lock:
            now = time.perf_counter()
            self._t0 = now
            self._win_t0 = now

    def record_submit(self) -> None:
        with self._lock:
            self.submitted += 1

    def record_reject(self, tenant: str, reason: str) -> None:
        with self._lock:
            self.rejects[reason] += 1

    def record_shed(self, tenant: str) -> None:
        """One queued request dropped past its deadline (load shedding) —
        a rejection with reason ``deadline_exceeded`` plus the dedicated
        shed counter the autoscaler's shed-rate rule scrapes."""
        with self._lock:
            self.rejects["deadline_exceeded"] += 1
            self.shed += 1

    def record_retry(self, tenant: str) -> None:
        """One transient dispatch failure re-queued within the per-tenant
        retry budget (the request did NOT fail through to its client)."""
        with self._lock:
            self.retries += 1

    def record_batch(self, batch, t_dispatch: float, t_done: float) -> None:
        """One dispatched batch delivered: fan its timing out to every
        request it carried, then maybe emit a window row."""
        device_ms = (t_done - t_dispatch) * 1e3
        with self._lock:
            self.batches += 1
            self.bucket_rows += batch.bucket
            self.completed_rows += batch.rows
            for r in batch.requests:
                self.completed += 1
                self.per_tenant_completed[r.tenant] += 1
                queue_ms = (t_dispatch - r.t_enqueue) * 1e3
                e2e_ms = (t_done - r.t_enqueue) * 1e3
                self._win_queue_ms.append(queue_ms)
                self._win_device_ms.append(device_ms)
                self._win_e2e_ms.append(e2e_ms)
                if len(self._e2e_ms) < _MAX_SAMPLES:
                    self._queue_ms.append(queue_ms)
                    self._device_ms.append(device_ms)
                    self._e2e_ms.append(e2e_ms)
                else:
                    self._lat_dropped += 1
            if (
                self.window
                and self.completed - self._win_start["completed"] >= self.window
            ):
                self._emit_window(final=False)

    # -------------------------------------------------------------- windows --
    def _emit_window(self, final: bool) -> Optional[dict]:
        """Build (and write) one serving_stats row for the current window.
        Caller holds the lock."""
        done = self.completed - self._win_start["completed"]
        if done == 0 and not final:
            return None
        now = time.perf_counter()
        wall = max(now - self._win_t0, 1e-9)
        rejected = sum(self.rejects.values()) - self._win_start["rejected"]
        bucket_rows = self.bucket_rows - self._win_start["bucket_rows"]
        rows = self.completed_rows - self._win_start["rows"]
        record = {
            "window": self._win_index,
            "requests": self.submitted - self._win_start["submitted"],
            "completed": done,
            "rejected": rejected,
            "batches": self.batches - self._win_start["batches"],
            "rows": rows,
            "queue_ms_p50": _pct_ms(self._win_queue_ms)["p50"],
            "device_ms_p50": _pct_ms(self._win_device_ms)["p50"],
            **{
                f"e2e_ms_{k}": v
                for k, v in _pct_ms(self._win_e2e_ms).items()
                if k in ("p50", "p95", "p99")
            },
            "throughput_rps": round(done / wall, 2),
            "rows_per_sec": round(rows / wall, 2),
            "batch_occupancy": (
                round(rows / bucket_rows, 4) if bucket_rows else None
            ),
            # survivability accounting (required at schema v7)
            "shed": self.shed - self._win_start["shed"],
            "retries": self.retries - self._win_start["retries"],
        }
        if self.writer is not None:
            self.writer.write(schema.stamp("serving_stats", record))
        self.last_window = record
        self._win_index += 1
        self._win_t0 = now
        self._win_queue_ms = []
        self._win_device_ms = []
        self._win_e2e_ms = []
        self._win_start = dict(
            completed=self.completed,
            submitted=self.submitted,
            rejected=sum(self.rejects.values()),
            batches=self.batches,
            rows=self.completed_rows,
            bucket_rows=self.bucket_rows,
            shed=self.shed,
            retries=self.retries,
        )
        return record

    def flush_window(self) -> Optional[dict]:
        """Emit whatever the current partial window holds (drain path) —
        the final row of a run must not vanish because it was short."""
        with self._lock:
            done = self.completed - self._win_start["completed"]
            rejected = sum(self.rejects.values()) - self._win_start["rejected"]
            requests = self.submitted - self._win_start["submitted"]
            retries = self.retries - self._win_start["retries"]
            if done == 0 and rejected == 0 and requests == 0 and retries == 0:
                return None
            return self._emit_window(final=True)

    # ------------------------------------------------------------ snapshots --
    def mark(self) -> dict:
        """Opaque cursor into the cumulative counters — pair with
        :meth:`since` to measure one phase (a load generator's per-offered-
        load delta) without resetting anything."""
        with self._lock:
            return dict(
                completed=self.completed,
                submitted=self.submitted,
                rows=self.completed_rows,
                bucket_rows=self.bucket_rows,
                batches=self.batches,
                rejected=sum(self.rejects.values()),
                samples=len(self._e2e_ms),
                dropped=self._lat_dropped,
                t=time.perf_counter(),
            )

    def since(self, mark: dict) -> dict:
        """Aggregate of everything recorded after ``mark`` (same fields as
        :meth:`summary`, minus per-tenant detail). Latency percentiles come
        from the capped cumulative lists: past _MAX_SAMPLES they go None
        while ``latency_samples_dropped`` goes nonzero — null-with-a-reason,
        never silently-frozen numbers."""
        with self._lock:
            sl = slice(mark["samples"], len(self._e2e_ms))
            rows = self.completed_rows - mark["rows"]
            bucket_rows = self.bucket_rows - mark["bucket_rows"]
            wall = max(time.perf_counter() - mark["t"], 1e-9)
            return {
                "completed": self.completed - mark["completed"],
                "submitted": self.submitted - mark["submitted"],
                "rejected": sum(self.rejects.values()) - mark["rejected"],
                "batches": self.batches - mark["batches"],
                "rows": rows,
                "batch_occupancy": (
                    round(rows / bucket_rows, 4) if bucket_rows else None
                ),
                "queue_ms": _pct_ms(self._queue_ms[sl]),
                "device_ms": _pct_ms(self._device_ms[sl]),
                "e2e_ms": _pct_ms(self._e2e_ms[sl]),
                "throughput_rps": round(
                    (self.completed - mark["completed"]) / wall, 2
                ),
                "rows_per_sec": round(rows / wall, 2),
                "wall_s": round(wall, 3),
                "latency_samples_dropped": (
                    self._lat_dropped - mark.get("dropped", 0)
                ),
            }

    # ----------------------------------------------------------- exporter --
    def export_source(self, engine=None):
        """The /metrics exporter's serving source: cumulative counters plus
        the LAST flushed window's latency/throughput/occupancy (exactly the
        serving_stats row history.jsonl holds). ``engine`` (optional) adds
        live queue depth, per-tenant lanes, and healthy-replica gauges. All
        lock-guarded host dict reads — the dispatch hot path is untouched."""
        from tpuddp_torch.observability import exporter as exp

        def source():
            with self._lock:
                completed = self.completed
                submitted = self.submitted
                rejected = sum(self.rejects.values())
                rows = self.completed_rows
                batches = self.batches
                shed = self.shed
                retries = self.retries
                per_tenant = dict(self.per_tenant_completed)
                win = dict(self.last_window) if self.last_window else None
            series = {
                "serving_requests_total": exp.counter(
                    submitted, "requests submitted"
                ),
                "serving_completed_total": exp.counter(
                    completed, "requests completed"
                ),
                "serving_rejected_total": exp.counter(
                    rejected, "requests rejected at admission"
                ),
                "serving_rows_total": exp.counter(rows, "sample rows served"),
                "serving_batches_total": exp.counter(
                    batches, "device batches dispatched"
                ),
                # survivability counters (serving/survive.py) — the
                # autoscaler's shed-rate rule scrapes serving_shed_total
                "serving_shed_total": exp.counter(
                    shed, "queued requests shed past their deadline"
                ),
                "serving_retries_total": exp.counter(
                    retries, "transient dispatch failures retried in-budget"
                ),
            }
            if per_tenant:
                series["serving_tenant_completed_total"] = {
                    "type": "counter",
                    "help": "completed requests by tenant",
                    "values": [
                        ({"tenant": t}, n) for t, n in sorted(per_tenant.items())
                    ],
                }
            if win is not None:
                series.update({
                    "serving_e2e_ms": exp.summary(
                        {
                            "0.5": win.get("e2e_ms_p50"),
                            "0.95": win.get("e2e_ms_p95"),
                            "0.99": win.get("e2e_ms_p99"),
                        },
                        "last-window end-to-end latency",
                        count=win.get("completed"),
                    ),
                    "serving_queue_ms": exp.summary(
                        {"0.5": win.get("queue_ms_p50")},
                        "last-window scheduling + coalescing wait",
                    ),
                    "serving_device_ms": exp.summary(
                        {"0.5": win.get("device_ms_p50")},
                        "last-window device + fetch time",
                    ),
                    "serving_throughput_rps": exp.gauge(
                        win.get("throughput_rps"), "last-window requests/sec"
                    ),
                    "serving_batch_occupancy": exp.gauge(
                        win.get("batch_occupancy"),
                        "last-window real rows / padded bucket rows",
                    ),
                })
            if engine is not None:
                series["serving_queue_depth"] = exp.gauge(
                    engine.queue.depth(), "requests queued right now"
                )
                tenant_depths = engine.queue.tenant_depths()
                if tenant_depths:
                    series["serving_tenant_queue_depth"] = {
                        "type": "gauge",
                        "help": "queued requests by tenant lane",
                        "values": [
                            ({"tenant": t}, n)
                            for t, n in sorted(tenant_depths.items())
                        ],
                    }
                series["serving_replicas_healthy"] = exp.gauge(
                    sum(1 for r in engine.pool.replicas if r.healthy),
                    "replicas still routed to",
                )
                series["serving_replica_recoveries_total"] = exp.counter(
                    sum(r.recoveries for r in engine.pool.replicas),
                    "probation episodes passed (replicas rejoined routing)",
                )
            return series

        return source

    # -------------------------------------------------------------- summary --
    def summary(self) -> dict:
        """Whole-run aggregate (host dict): totals, overall percentiles,
        throughput over the run wall clock, occupancy, rejects by reason."""
        with self._lock:
            wall = max(time.perf_counter() - self._t0, 1e-9)
            return {
                "submitted": self.submitted,
                "completed": self.completed,
                "completed_rows": self.completed_rows,
                "rejected": dict(self.rejects),
                "shed": self.shed,
                "retries": self.retries,
                "per_tenant_completed": dict(self.per_tenant_completed),
                "batches": self.batches,
                "batch_occupancy": (
                    round(self.completed_rows / self.bucket_rows, 4)
                    if self.bucket_rows
                    else None
                ),
                "queue_ms": _pct_ms(self._queue_ms),
                "device_ms": _pct_ms(self._device_ms),
                "e2e_ms": _pct_ms(self._e2e_ms),
                "throughput_rps": round(self.completed / wall, 2),
                "rows_per_sec": round(self.completed_rows / wall, 2),
                "wall_s": round(wall, 3),
                # whole-run percentiles cover the first _MAX_SAMPLES requests
                # only; a nonzero drop count says the tail is not in them
                "latency_samples_dropped": self._lat_dropped,
            }
