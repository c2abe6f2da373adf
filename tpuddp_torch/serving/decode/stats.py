"""Token-level SLO metrics — the counterpart of
``tpuddp/serving/decode/stats.py``, the decode engine's typed record stream.

Request-granularity latency percentiles say nothing useful about a token
stream; the three numbers token traffic lives by are:

- **TTFT** (time to first token) — submit -> the prefill's first sampled
  token delivered: what "the model started answering" feels like;
- **ITL** (inter-token latency) — the gap between consecutive streamed
  tokens of one sequence: what "the answer is flowing" feels like;
- **tokens/sec** — aggregate generation throughput across the running batch.

Every ``stats_window`` generated tokens, one ``decode_stats`` row (schema
v6, :mod:`tpuddp_torch.observability.schema`) lands in ``history.jsonl``
with the window's TTFT/ITL percentiles, throughput, reject counts, KV-pool
occupancy and active-sequence count — the same typed artifact stream every
other subsystem uses.

All bookkeeping is host-side; the decode loop calls in with plain floats.
Lock-guarded because the exporter scrapes from its own thread.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from typing import Callable, Optional

from tpuddp_torch.observability import schema
from tpuddp_torch.observability.recorder import percentiles

# Cap on the retained CUMULATIVE latency sample lists (the ServingStats
# convention): summaries past the cap report the first _MAX_SAMPLES with a
# nonzero dropped count, while the per-window lists reset every window and
# keep the record stream live forever.
_MAX_SAMPLES = 200_000


def _pct_ms(values) -> dict:
    out = percentiles(values)
    return {k: (None if v is None else round(v, 3)) for k, v in out.items()}


class DecodeStats:
    """Aggregates token telemetry and emits ``decode_stats`` rows.

    ``gauges`` is an optional zero-arg callable returning ``(kv_occupancy,
    active_sequences)`` sampled at window-flush time (the engine wires its
    replica pool in); without it those fields are null, never absent."""

    def __init__(
        self,
        writer=None,
        window: int = 64,
        gauges: Optional[Callable[[], tuple]] = None,
    ):
        self.writer = writer
        self.window = max(0, int(window))
        self.gauges = gauges
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        # cumulative
        self.submitted = 0
        self.completed = 0  # sequences finished
        self.tokens = 0  # tokens generated (delivered to clients)
        self.prompt_tokens = 0
        self.rejects = Counter()
        self.per_tenant_completed = Counter()
        # survivability accounting (serving/survive.py): queued
        # requests shed past their deadline, and live sessions migrated
        # off a dead replica (their streams continued bitwise elsewhere)
        self.shed = 0
        self.failovers = 0
        self._ttft_ms: list = []
        self._itl_ms: list = []
        self._lat_dropped = 0
        # window-local
        self._win_ttft: list = []
        self._win_itl: list = []
        self._win_index = 0
        self._win_t0 = self._t0
        self._win_start = dict(
            tokens=0, completed=0, submitted=0, rejected=0, shed=0,
            failovers=0,
        )
        self.last_window: Optional[dict] = None

    # ------------------------------------------------------------ recording --
    def reset_clock(self) -> None:
        """Restart the run + window wall clocks (post-warmup, so window 0's
        tokens/sec measures decoding, not the warm-up and the graph capture)."""
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

    def record_failover(self, tenant: str) -> None:
        """One live session migrated off a dead replica (its stream
        continues bitwise on the new one)."""
        with self._lock:
            self.failovers += 1

    def record_first_token(self, ttft_ms: float, prompt_tokens: int) -> None:
        """The prefill's sampled token delivered — TTFT's clock stops."""
        with self._lock:
            self.tokens += 1
            self.prompt_tokens += int(prompt_tokens)
            self._win_ttft.append(ttft_ms)
            if len(self._ttft_ms) < _MAX_SAMPLES:
                self._ttft_ms.append(ttft_ms)
            else:
                self._lat_dropped += 1
            self._maybe_emit()

    def record_token(self, itl_ms: float) -> None:
        """One decode-step token delivered to its stream."""
        with self._lock:
            self.tokens += 1
            self._win_itl.append(itl_ms)
            if len(self._itl_ms) < _MAX_SAMPLES:
                self._itl_ms.append(itl_ms)
            else:
                self._lat_dropped += 1
            self._maybe_emit()

    def record_finish(self, tenant: str) -> None:
        with self._lock:
            self.completed += 1
            self.per_tenant_completed[tenant] += 1

    # -------------------------------------------------------------- windows --
    def _maybe_emit(self) -> None:
        if self.window and self.tokens - self._win_start["tokens"] >= self.window:
            self._emit_window()

    def _emit_window(self) -> Optional[dict]:
        """Caller holds the lock."""
        done_tokens = self.tokens - self._win_start["tokens"]
        now = time.perf_counter()
        wall = max(now - self._win_t0, 1e-9)
        kv_occ, active = (None, None)
        if self.gauges is not None:
            try:
                kv_occ, active = self.gauges()
            except Exception:  # pragma: no cover — a dead gauge is null, not a crash
                kv_occ, active = (None, None)
        record = {
            "window": self._win_index,
            "tokens": done_tokens,
            "completed": self.completed - self._win_start["completed"],
            "requests": self.submitted - self._win_start["submitted"],
            "rejected": sum(self.rejects.values()) - self._win_start["rejected"],
            "tokens_per_sec": round(done_tokens / wall, 2),
            **{f"ttft_ms_{k}": v for k, v in _pct_ms(self._win_ttft).items()
               if k in ("p50", "p95", "p99")},
            **{f"itl_ms_{k}": v for k, v in _pct_ms(self._win_itl).items()
               if k in ("p50", "p95", "p99")},
            "kv_occupancy": None if kv_occ is None else round(kv_occ, 4),
            "active_sequences": active,
            # survivability accounting (required at schema v7)
            "shed": self.shed - self._win_start["shed"],
            "failovers": self.failovers - self._win_start["failovers"],
        }
        if self.writer is not None:
            self.writer.write(schema.stamp("decode_stats", record))
        self.last_window = record
        self._win_index += 1
        self._win_t0 = now
        self._win_ttft = []
        self._win_itl = []
        self._win_start = dict(
            tokens=self.tokens,
            completed=self.completed,
            submitted=self.submitted,
            rejected=sum(self.rejects.values()),
            shed=self.shed,
            failovers=self.failovers,
        )
        return record

    def flush_window(self) -> Optional[dict]:
        """Emit the current partial window (drain path)."""
        with self._lock:
            if (
                self.tokens == self._win_start["tokens"]
                and self.submitted == self._win_start["submitted"]
                and sum(self.rejects.values()) == self._win_start["rejected"]
                and self.failovers == self._win_start["failovers"]
            ):
                return None
            return self._emit_window()

    # ------------------------------------------------------------ snapshots --
    def mark(self) -> dict:
        """Cursor for :meth:`since` — the load generator's per-phase delta."""
        with self._lock:
            return dict(
                tokens=self.tokens,
                completed=self.completed,
                submitted=self.submitted,
                rejected=sum(self.rejects.values()),
                shed=self.shed,
                failovers=self.failovers,
                ttft_samples=len(self._ttft_ms),
                itl_samples=len(self._itl_ms),
                dropped=self._lat_dropped,
                t=time.perf_counter(),
            )

    def since(self, mark: dict) -> dict:
        with self._lock:
            wall = max(time.perf_counter() - mark["t"], 1e-9)
            tokens = self.tokens - mark["tokens"]
            return {
                "tokens": tokens,
                "completed": self.completed - mark["completed"],
                "submitted": self.submitted - mark["submitted"],
                "rejected": sum(self.rejects.values()) - mark["rejected"],
                "shed": self.shed - mark.get("shed", 0),
                "failovers": self.failovers - mark.get("failovers", 0),
                "tokens_per_sec": round(tokens / wall, 2),
                "ttft_ms": _pct_ms(self._ttft_ms[mark["ttft_samples"]:]),
                "itl_ms": _pct_ms(self._itl_ms[mark["itl_samples"]:]),
                "wall_s": round(wall, 3),
                "latency_samples_dropped": (
                    self._lat_dropped - mark.get("dropped", 0)
                ),
            }

    # ------------------------------------------------------------- exporter --
    def export_source(self, engine=None):
        """The /metrics decode source: cumulative token/sequence counters,
        the LAST flushed window's throughput + TTFT/ITL summaries, and —
        with ``engine`` — the live KV-occupancy / active-sequence / queue
        gauges. Host dict reads only; the decode loop is untouched."""
        from tpuddp_torch.observability import exporter as exp

        def source():
            with self._lock:
                tokens = self.tokens
                completed = self.completed
                submitted = self.submitted
                rejected = sum(self.rejects.values())
                shed = self.shed
                failovers = self.failovers
                win = dict(self.last_window) if self.last_window else None
            series = {
                "decode_tokens_total": exp.counter(
                    tokens, "tokens generated and streamed"
                ),
                "decode_sequences_completed_total": exp.counter(
                    completed, "sequences decoded to termination"
                ),
                "decode_requests_total": exp.counter(
                    submitted, "decode requests submitted"
                ),
                "decode_rejected_total": exp.counter(
                    rejected, "decode requests rejected at admission"
                ),
                # survivability counters (serving/survive.py) — the
                # autoscaler's shed-rate rule reads decode_shed_total on
                # decode jobs the way it reads serving_shed_total
                "decode_shed_total": exp.counter(
                    shed, "queued decode requests shed past their deadline"
                ),
                "decode_session_failovers_total": exp.counter(
                    failovers,
                    "live sessions migrated off a dead replica",
                ),
            }
            if win is not None:
                series.update({
                    "decode_tokens_per_sec": exp.gauge(
                        win.get("tokens_per_sec"),
                        "last-window generation throughput",
                    ),
                    "decode_ttft_ms": exp.summary(
                        {
                            "0.5": win.get("ttft_ms_p50"),
                            "0.95": win.get("ttft_ms_p95"),
                        },
                        "last-window time to first token",
                    ),
                    "decode_itl_ms": exp.summary(
                        {
                            "0.5": win.get("itl_ms_p50"),
                            "0.95": win.get("itl_ms_p95"),
                            "0.99": win.get("itl_ms_p99"),
                        },
                        "last-window inter-token latency",
                    ),
                })
            if engine is not None:
                series["decode_kv_occupancy"] = exp.gauge(
                    engine.kv_occupancy(),
                    "allocated fraction of the paged KV pool",
                )
                series["decode_active_sequences"] = exp.gauge(
                    engine.active_sequences(),
                    "sequences occupying decode slots right now",
                )
                series["decode_queue_depth"] = exp.gauge(
                    engine.queue.depth(), "decode requests queued right now"
                )
                series["decode_replicas_healthy"] = exp.gauge(
                    sum(1 for r in engine.replicas if r.healthy),
                    "decode replicas still routed to",
                )
                series["decode_replica_recoveries_total"] = exp.counter(
                    sum(r.recoveries for r in engine.replicas),
                    "probation episodes passed (replicas rejoined routing)",
                )
            return series

        return source

    # -------------------------------------------------------------- summary --
    def summary(self) -> dict:
        with self._lock:
            wall = max(time.perf_counter() - self._t0, 1e-9)
            return {
                "submitted": self.submitted,
                "completed": self.completed,
                "tokens": self.tokens,
                "prompt_tokens": self.prompt_tokens,
                "rejected": dict(self.rejects),
                "shed": self.shed,
                "failovers": self.failovers,
                "per_tenant_completed": dict(self.per_tenant_completed),
                "tokens_per_sec": round(self.tokens / wall, 2),
                "ttft_ms": _pct_ms(self._ttft_ms),
                "itl_ms": _pct_ms(self._itl_ms),
                "wall_s": round(wall, 3),
                "latency_samples_dropped": self._lat_dropped,
            }
