"""The causal tracing plane — the counterpart of
``tpuddp/observability/trace.py``: host-side span trees of a training run.

- A **span** is one timed host interval: ``trace_id`` (its tree),
  ``span_id``, ``parent_id`` (nesting), a typed ``kind``
  (:data:`SPAN_KINDS`), monotonic start and end (``perf_counter_ns``),
  free-form ``attrs`` and an optional ``follows_from`` link.
- A :class:`Tracer` holds a bounded ring of completed spans (the oldest
  dropped and counted), the open spans (a flight recording embeds them:
  the stage a process died in), per-kind counts and the slowest spans.
- :meth:`Tracer.export` writes ``trace_<role>.json``, Chrome trace events
  with a ``tpuddp`` provenance block (schema v9), which Perfetto loads as
  it is; :meth:`Tracer.endpoint_payload` is the exporter's ``/trace``.

The native loop traces one ``epoch`` span per epoch with ``stage`` (a
dispatch's batches placed on the device), ``dispatch`` (a step, chunk or
replay issued), ``readback`` (a pass's sums read) and, with a comm hook or
the segmented overlap, zero-length ``collective`` annotations inside each
train dispatch (the exchange runs inside the step: the spans carry the
bucket plan's wire bytes, host integers). A span brackets calls the loop
makes anyway: it reads no tensor, waits for nothing and launches nothing,
so a traced run is bitwise the untraced one. Off
(``observability.tracing: false``, the default) the loop holds
:data:`NULL`, whose methods do nothing.

One tracer per host, in its local rank 0 (the JAX package's one process
per host): ``trace_train.json`` on host 0, ``trace_train_p<host>.json``
past it. The timestamps map ``perf_counter_ns`` onto the unix axis through
one anchor taken when the tracer is made (``clock_sync``); a host's
telemetry shard carries the same pair of clocks
(:func:`tpuddp_torch.observability.aggregate.make_shard`).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from collections import Counter, deque
from typing import Dict, List, Optional

logger = logging.getLogger("tpuddp")

DEFAULT_CAPACITY = 4096
_SLOWEST_TABLE = 8  # spans kept in the slowest-span table
# /trace serves the last N completed spans: the payload is copied under the
# tracer's lock, which a whole 4096-span copy per scrape would hold too long
ENDPOINT_SPANS_DEFAULT = 256

KIND_EPOCH = "epoch"
KIND_STAGE = "stage"
KIND_DISPATCH = "dispatch"
KIND_COLLECTIVE = "collective"
KIND_READBACK = "readback"
KIND_REQUEST = "request"
KIND_ADMISSION = "admission"
KIND_QUEUE_WAIT = "queue_wait"
KIND_PREFILL = "prefill"
KIND_SERVE = "serve"
KIND_DECODE_STEP = "decode_step"
KIND_FAILOVER = "failover"
KIND_PROBATION = "probation"
KIND_JOB = "job"
KIND_ACTION = "action"

# the JAX table, serving and fleet kinds included, so that files validate alike
SPAN_KINDS = (
    KIND_EPOCH, KIND_STAGE, KIND_DISPATCH, KIND_COLLECTIVE, KIND_READBACK,
    KIND_REQUEST, KIND_ADMISSION, KIND_QUEUE_WAIT, KIND_PREFILL, KIND_SERVE,
    KIND_DECODE_STEP, KIND_FAILOVER, KIND_PROBATION, KIND_JOB, KIND_ACTION,
)


class Span:
    """One completed or open host interval; the owning tracer stamps its
    end (:meth:`Tracer.end_span`)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "kind", "t_start_ns", "t_end_ns",
                 "attrs", "follows_from", "tid")

    def __init__(self, trace_id: str, span_id: int, parent_id: Optional[int], name: str,
                 kind: str, t_start_ns: int, tid: str, attrs: Optional[dict] = None,
                 follows_from: Optional[int] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.kind = kind
        self.t_start_ns = t_start_ns
        self.t_end_ns: Optional[int] = None
        self.attrs = dict(attrs) if attrs else {}
        self.follows_from = follows_from
        self.tid = tid

    @property
    def duration_ms(self) -> Optional[float]:
        if self.t_end_ns is None:
            return None
        return (self.t_end_ns - self.t_start_ns) / 1e6

    def summary(self) -> dict:
        """The compact form (the flight recording, ``/trace``)."""
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "kind": self.kind,
            "t_start_ns": self.t_start_ns,
            "duration_ms": None if self.duration_ms is None else round(self.duration_ms, 4),
            "tid": self.tid,
            "follows_from": self.follows_from,
            "attrs": dict(self.attrs),
        }


class _NullSpan:
    """The span :data:`NULL` hands out: attributes land nowhere."""

    __slots__ = ()
    trace_id = None
    span_id = None
    parent_id = None
    kind = None
    follows_from = None
    duration_ms = None
    attrs: dict = {}

    def summary(self) -> dict:
        return {}


NULL_SPAN = _NullSpan()


class _NullTracer:
    """The tracer of a run with tracing off: every method does nothing and
    nothing is written."""

    enabled = False
    role = None

    def new_trace(self) -> None:
        return None

    def start_span(self, *a, **kw) -> _NullSpan:
        return NULL_SPAN

    def end_span(self, span, **attrs) -> None:
        pass

    def span(self, *a, **kw):
        return contextlib.nullcontext(NULL_SPAN)

    def open_span_summaries(self) -> list:
        return []

    def endpoint_payload(self, limit=None) -> dict:
        return {"enabled": False, "spans": [], "open": [], "dropped": 0}

    def summary_record(self) -> dict:
        return {}

    def describe(self) -> None:
        return None  # the run_meta ``tracing`` field: null = off

    def export(self, path: Optional[str] = None) -> None:
        return None


NULL = _NullTracer()
NULL_TRACER = NULL


def _host_index() -> int:
    from tpuddp_torch.parallel import backend

    return backend.host_index()


class Tracer:
    """The span recorder of one process and role (``train``); thread-safe.
    ``process_index`` is the host (default: this process's)."""

    enabled = True

    def __init__(self, role: str, capacity: int = DEFAULT_CAPACITY,
                 run_dir: Optional[str] = None, process_index: Optional[int] = None):
        self.role = str(role)
        self.capacity = max(1, int(capacity))
        self.run_dir = run_dir
        self.process_index = int(_host_index() if process_index is None else process_index)
        self._lock = threading.Lock()
        self._ring: deque = deque()  # completed spans, oldest first
        self._open: Dict[int, Span] = {}
        self._ids = 0
        self._traces = 0
        self.dropped = 0
        self.completed = 0
        self.kind_counts: Counter = Counter()
        self._slowest: List[dict] = []
        self._tids: Dict[str, int] = {}
        # the one wall <-> monotonic anchor, taken back to back
        self.clock_unix_us = int(time.time() * 1e6)
        self.clock_perf_ns = time.perf_counter_ns()

    def new_trace(self) -> str:
        """A trace id (one span tree), unique within this artifact."""
        with self._lock:
            self._traces += 1
            return f"{self.role}-p{self.process_index}-{self._traces:06d}"

    def start_span(self, name: str, kind: str, *, trace_id: Optional[str] = None, parent=None,
                   follows_from: Optional[int] = None, tid: Optional[str] = None,
                   attrs: Optional[dict] = None) -> Span:
        """Open a span. ``parent`` gives the trace, the nesting and the
        timeline row unless they are given; no parent and no trace id mint
        a trace."""
        if kind not in SPAN_KINDS:
            raise ValueError(f"unknown span kind {kind!r}; one of {SPAN_KINDS}")
        parent_id = None
        if parent is not None and getattr(parent, "span_id", None) is not None:
            parent_id = parent.span_id
            if trace_id is None:
                trace_id = parent.trace_id
            if tid is None:
                tid = parent.tid
        if trace_id is None:
            trace_id = self.new_trace()
        now = time.perf_counter_ns()
        with self._lock:
            self._ids += 1
            span = Span(trace_id, self._ids, parent_id, str(name), kind, now,
                        tid if tid is not None else self.role, attrs, follows_from=follows_from)
            self._open[span.span_id] = span
        return span

    def end_span(self, span, **attrs) -> None:
        """Close a span (idempotent; the null span is ignored): its end, its
        attrs and the counts change under the lock, so a scrape or a dump
        never sees one half-updated."""
        if not isinstance(span, Span):
            return
        now = time.perf_counter_ns()
        with self._lock:
            if span.t_end_ns is not None:
                return
            span.t_end_ns = now
            if attrs:
                span.attrs.update(attrs)
            self._open.pop(span.span_id, None)
            if len(self._ring) >= self.capacity:
                self._ring.popleft()
                self.dropped += 1
            self._ring.append(span)
            self.completed += 1
            self.kind_counts[span.kind] += 1
            dur = span.duration_ms or 0.0
            if len(self._slowest) < _SLOWEST_TABLE or dur > self._slowest[-1]["duration_ms"]:
                self._slowest.append({"name": span.name, "kind": span.kind,
                                      "duration_ms": round(dur, 4), "span_id": span.span_id})
                self._slowest.sort(key=lambda r: r["duration_ms"], reverse=True)
                del self._slowest[_SLOWEST_TABLE:]

    def span(self, name: str, kind: str, **kw):
        """A context manager over :meth:`start_span` and :meth:`end_span`."""

        @contextlib.contextmanager
        def _cm():
            s = self.start_span(name, kind, **kw)
            try:
                yield s
            finally:
                self.end_span(s)

        return _cm()

    def open_span_summaries(self) -> List[dict]:
        """The open spans, outermost first (a flight recording's
        ``notes.open_spans``)."""
        with self._lock:
            return [s.summary() for s in sorted(self._open.values(), key=lambda s: s.span_id)]

    def endpoint_payload(self, limit: Optional[int] = ENDPOINT_SPANS_DEFAULT) -> dict:
        """``/trace``'s JSON: the last ``limit`` completed spans (None or 0:
        the whole ring), the open ones and the drop count."""
        with self._lock:
            spans = list(self._ring)
            if limit is not None and limit > 0:
                spans = spans[-int(limit):]
            return {
                "enabled": True,
                "role": self.role,
                "process_index": self.process_index,
                "capacity": self.capacity,
                "completed": self.completed,
                "dropped": self.dropped,
                "spans": [s.summary() for s in spans],
                "open": [s.summary() for s in sorted(self._open.values(),
                                                     key=lambda s: s.span_id)],
            }

    def summary_record(self) -> dict:
        """The ``trace_summary`` history record's fields (schema v9)."""
        with self._lock:
            return {
                "role": self.role,
                "spans": self.completed,
                "dropped": self.dropped,
                "open_spans": len(self._open),
                "traces": self._traces,
                "by_kind": dict(self.kind_counts),
                "slowest": [dict(r) for r in self._slowest],
            }

    def describe(self) -> dict:
        """The run_meta ``tracing`` field (schema v9)."""
        return {"capacity": self.capacity, "artifact": self.artifact_name()}

    def artifact_name(self) -> str:
        if self.process_index == 0:
            return f"trace_{self.role}.json"
        return f"trace_{self.role}_p{self.process_index}.json"

    def _ts_us(self, t_ns: int) -> float:
        return self.clock_unix_us + (t_ns - self.clock_perf_ns) / 1e3

    def _tid_for(self, name: str) -> int:
        if name not in self._tids:
            self._tids[name] = len(self._tids)
        return self._tids[name]

    def chrome_payload(self) -> dict:
        """The artifact: completed spans as ``ph: "X"`` events, open ones as
        X events flagged ``open`` (their duration runs to now), ``s``/``f``
        flow pairs for the ``follows_from`` links whose predecessor is in
        the ring, and the process and thread name rows. Built under the
        lock."""
        from tpuddp_torch.observability import schema

        now_ns = time.perf_counter_ns()
        with self._lock:
            spans = list(self._ring) + sorted(self._open.values(), key=lambda s: s.span_id)
            meta = {
                "type": schema.TRACE_TYPE,
                "schema_version": schema.SCHEMA_VERSION,
                "role": self.role,
                "process_index": self.process_index,
                "capacity": self.capacity,
                "spans": self.completed,
                "dropped": self.dropped,
                "open_spans": len(self._open),
                "traces": self._traces,
                "by_kind": dict(self.kind_counts),
                "slowest": [dict(r) for r in self._slowest],
                "clock_sync": {"unix_us": self.clock_unix_us, "perf_ns": self.clock_perf_ns},
            }
            pid = self.process_index
            by_id = {s.span_id: s for s in spans}
            events = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                       "args": {"name": f"tpuddp {self.role} p{pid}"}}]
            for tname in sorted({s.tid for s in spans}):
                events.append({"ph": "M", "name": "thread_name", "pid": pid,
                               "tid": self._tid_for(tname), "args": {"name": tname}})
            flow = 0
            for s in spans:
                open_span = s.t_end_ns is None
                end_ns = now_ns if open_span else s.t_end_ns
                args = {"trace_id": s.trace_id, "span_id": s.span_id, "parent_id": s.parent_id,
                        **s.attrs}
                if s.follows_from is not None:
                    args["follows_from"] = s.follows_from
                if open_span:
                    args["open"] = True
                events.append({
                    "ph": "X", "name": s.name, "cat": s.kind, "pid": pid,
                    "tid": self._tid_for(s.tid), "ts": round(self._ts_us(s.t_start_ns), 3),
                    "dur": round(max(end_ns - s.t_start_ns, 0) / 1e3, 3), "args": args,
                })
                if s.follows_from is not None and s.follows_from in by_id:
                    pred = by_id[s.follows_from]
                    flow += 1
                    pred_end = pred.t_end_ns if pred.t_end_ns is not None else now_ns
                    events.append({"ph": "s", "id": flow, "name": "follows_from", "cat": "flow",
                                   "pid": pid, "tid": self._tid_for(pred.tid),
                                   "ts": round(self._ts_us(pred_end), 3)})
                    events.append({"ph": "f", "bp": "e", "id": flow, "name": "follows_from",
                                   "cat": "flow", "pid": pid, "tid": self._tid_for(s.tid),
                                   "ts": round(self._ts_us(s.t_start_ns), 3)})
        return {"traceEvents": events, "displayTimeUnit": "ms", "tpuddp": meta}

    def export(self, path: Optional[str] = None) -> Optional[str]:
        """Write the artifact (staged, fsync'd, renamed); its path, or None
        without a destination or after a failed write (logged)."""
        if path is None:
            if self.run_dir is None:
                return None
            path = os.path.join(self.run_dir, self.artifact_name())
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            from tpuddp_torch.observability.metrics import json_sanitize

            with open(tmp, "w") as f:
                json.dump(json_sanitize(self.chrome_payload()), f, allow_nan=False)
                f.write("\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except (OSError, ValueError) as e:
            logger.warning("trace export (%s) failed: %s", path, e)
            try:
                os.remove(tmp)
            except OSError:
                pass
            return None
        logger.info("trace: %d span(s) (%d dropped) -> %s", self.completed, self.dropped, path)
        return path


def tracer_from_config(obs_cfg, role: str, run_dir: Optional[str] = None):
    """The role's tracer from a resolved ``observability`` block:
    :data:`NULL` unless ``tracing`` is on."""
    if not obs_cfg or not obs_cfg.get("tracing"):
        return NULL
    return Tracer(role, capacity=int(obs_cfg.get("trace_capacity") or DEFAULT_CAPACITY),
                  run_dir=run_dir)
