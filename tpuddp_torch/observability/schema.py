"""Typed record schema of ``history.jsonl`` — the counterpart of
``tpuddp/observability/schema.py``, a copy of its tables, so that a port
run's history passes the JAX package's ``tools/tpuddp_inspect.py
--validate`` and this module's validators accept and reject what the JAX
package's do.

Every line is one JSON object carrying ``type`` and ``schema_version``. A
training run writes four of the record types:

- ``run_meta``: the header row, written at the loop's start, and again by a
  resumed run appending to an existing file;
- ``epoch``: one row per epoch, with the step-time percentiles and MFU of
  :mod:`tpuddp_torch.observability.recorder`;
- ``step_stats``: one row per ``training.step_stats_every`` updates inside
  an epoch;
- ``event``: rollback, desync, skipped updates, profiler captures, the
  drain's ``preempt``, an elastic restore's ``topology_change`` and
  ``comm_state_reset``, the watchdog's ``watchdog_stale``, the pod
  aggregator's ``straggler``;
- ``trace_summary``: the tracing plane's digest, written at the loop's end
  when ``observability.tracing`` is on.

Two sidecar artifacts have validators here too, copies of the JAX ones:
the flight recording ``flightrec_<reason>.json``
(:func:`validate_flight_file`) and the Chrome trace ``trace_<role>.json``
(:func:`validate_trace_file`). The serving engines
(:mod:`tpuddp_torch.serving`) write ``serving_stats`` and
``decode_stats`` rows, ``event`` rows of their own, and a header with the
v6 ``decode`` and v7 ``survivability`` blocks. Tune reports belong to a
plane the port has not ported; they stay in the tables so that validation
agrees with the JAX package's on every record. :func:`make_run_meta` builds
the header from the port's run: the keys that name JAX (``jax_version``)
are null, and ``torch_version``, ``cuda_version`` and ``device_kind``
(``torch.cuda.get_device_name``) say what ran; ``process_count`` and
``process_index`` mean hosts, ``world_size`` GPUs (processes); the planes
not ported yet hold their "off" values. Version history: the JAX module's
docstring.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Iterable, List, Optional, Tuple

SCHEMA_VERSION = 12

RECORD_TYPES = (
    "run_meta", "epoch", "step_stats", "event", "serving_stats",
    "decode_stats", "trace_summary", "tune_report",
)

# Required keys per record type (beyond the envelope's type/schema_version).
# Values may be null where a metric can legitimately blow up (strict-JSON
# post-mortem rows) or be unknowable (MFU without a known chip peak).
_REQUIRED = {
    "run_meta": (
        "jax_version",
        "tpuddp_version",
        "world_size",
        "process_count",
        "process_index",
        "mesh_shape",
        "comm_hook",
        "guard",
    ),
    "epoch": (
        "epoch",
        "train_loss",
        "test_loss",
        "test_accuracy",
        "train_samples",
        "test_samples",
        "epoch_time_s",
        "samples_per_sec",
        "step_time_ms_p50",
        "step_time_ms_p95",
        "step_time_ms_p99",
        "step_time_ms_max",
        "mfu_p50",
    ),
    "step_stats": (
        "epoch",
        "step_start",
        "steps",
        "step_time_ms_p50",
        "step_time_ms_p95",
        "step_time_ms_p99",
        "step_time_ms_max",
        "samples_per_sec",
    ),
    "event": ("event",),
    "serving_stats": (
        "window",
        "requests",
        "completed",
        "rejected",
        "queue_ms_p50",
        "device_ms_p50",
        "e2e_ms_p50",
        "e2e_ms_p95",
        "e2e_ms_p99",
        "throughput_rps",
        "batch_occupancy",
    ),
    # one row per decode-engine reporting window (tpuddp/serving/decode/):
    # token-granularity throughput + the two latencies token traffic lives
    # by (TTFT, ITL) + the KV-pool pressure gauge. Percentiles may be null
    # in a window that completed zero tokens of its kind (e.g. a drain
    # flush), never absent.
    "decode_stats": (
        "window",
        "tokens",
        "completed",
        "rejected",
        "tokens_per_sec",
        "ttft_ms_p50",
        "ttft_ms_p95",
        "itl_ms_p50",
        "itl_ms_p95",
        "itl_ms_p99",
        "kv_occupancy",
        "active_sequences",
    ),
    # the tracing plane's drain digest (schema v9, observability/trace.py):
    # one row per traced writer — completed-span count, ring drops (the
    # honesty field: a reader knows whether the artifact is the WHOLE run
    # or the newest window of it), still-open spans at drain, per-kind
    # counts, and the slowest-span table.
    "trace_summary": (
        "role",
        "spans",
        "dropped",
        "open_spans",
        "by_kind",
        "slowest",
    ),
    # the autotuner's A/B probe artifact (schema v12, tools/autotune.py +
    # tpuddp/tune/probe.py): ONE JSON object — baseline metrics plus one
    # row per advisor rule carrying the predicted delta it promised, the
    # measured delta the probe observed, and the endorsement verdict. The
    # measured field is the honesty contract: a rule whose measured delta
    # regresses MUST carry endorsed=false, so the fleet tuner never acts
    # on a prediction that failed its own A/B.
    "tune_report": (
        "device",
        "mode",
        "baseline_metrics",
        "results",
    ),
}

# Fields additionally required of records stamped at schema_version >= N:
# applied at the version a record CARRIES (older histories keep validating
# under newer readers). v3: the async pipeline's occupancy accounting.
# v4: the gradient-reduction topology knob in the header (comm compression
# v2 — a run_meta without it cannot say which wire its comm bytes crossed).
_REQUIRED_SINCE = {
    3: {
        "step_stats": (
            "host_stall_ms",
            "inflight_depth",
            "staging_queue_depth",
        ),
    },
    4: {
        "run_meta": ("comm_topology",),
    },
    # v5: the live telemetry plane's provenance. The value may be null (a
    # writer with the whole plane off) but the KEY must exist — absence is
    # drift, and downstream consumers need to distinguish "no straggler
    # events because all hosts were uniform" from "aggregation never ran".
    5: {
        "run_meta": ("observability",),
    },
    # v6: the decode engine's provenance. Null for every non-decode writer
    # (training, request-granularity serving), but the KEY must exist — a
    # reader needs to distinguish "no decode_stats windows because nothing
    # decoded" from "this header predates the decode subsystem".
    6: {
        "run_meta": ("decode",),
    },
    # v7: the serving survivability layer (tpuddp/serving/survive.py).
    # run_meta.survivability is null for non-serving writers but the KEY
    # must exist (a reader must tell "no sheds because the layer was off"
    # from "predates the layer"); serving/decode windows carry their shed
    # counts and decode windows their session-failover counts, so the
    # autoscaler's shed-rate rule and the chaos gate read typed records,
    # not log lines.
    7: {
        "run_meta": ("survivability",),
        "serving_stats": ("shed",),
        "decode_stats": ("shed", "failovers"),
    },
    # v8: the 2-D device-mesh provenance (tpuddp/parallel/mesh2d.py). The
    # value may be null (a writer with no mesh — serving headers) but the
    # KEY must exist: a reader needs to distinguish "pure DP" (model=1)
    # from "predates the 2-D mesh", and a model>1 block carries the
    # tp_rules_hash naming the rule table that sharded the run.
    8: {
        "run_meta": ("mesh",),
    },
    # v9: the causal tracing plane (observability/trace.py). Null for every
    # untraced writer (the default — tracing is opt-in) but the KEY must
    # exist: a reader needs to distinguish "no trace artifact because
    # tracing was off" from "this header predates the tracing plane"; an
    # armed block names the ring capacity and the artifact file.
    9: {
        "run_meta": ("tracing",),
    },
    # v10: the gradient-exchange execution provenance (``comm_overlap``,
    # training/step.py). Null for writers with no gradient exchange (serving
    # headers) but the KEY must exist: a reader needs to distinguish
    # "barrier step because overlap resolved off (and why)" from "this
    # header predates segmented-backward execution". An enabled block's
    # ``overlap.segments`` counts the bucket-aligned backward segments whose
    # collectives interleave with backward compute.
    10: {
        "run_meta": ("comm",),
    },
    # v11: the async step-checkpoint engine's provenance (``snapshot``,
    # training/snapshot.py). ``false`` for writers with the engine off (the
    # default — epoch-granular checkpoints only) but the KEY must exist: a
    # reader of a resumed history needs to distinguish "no step snapshots
    # because the engine was off" from "this header predates step-granular
    # checkpointing". An armed block names the cadence (every_steps), the
    # writer mode (async/inflight) and peer-redundancy placement.
    11: {
        "run_meta": ("snapshot",),
    },
    # v12: the autotuning plane's provenance (``tuning``, tpuddp/tune/).
    # Null for every untuned writer (the default — the advisor is read-only
    # until a human or the fleet tuner applies an overlay) but the KEY must
    # exist: a reader needs to distinguish "these knobs were human-chosen"
    # from "this header predates the autotuner". An armed block names the
    # overlay source (fleet/operator), the rule that proposed it, the
    # overlay generation counter, and the knob diff actually applied — so a
    # before/after pair of resumed headers is self-explaining.
    12: {
        "run_meta": ("tuning",),
    },
}

# the fields an event row of a kind must carry: the drain's ``preempt`` row
# (tpuddp/training/loop.py:684-692, train_accelerate.py:480-486) says which
# epoch, whether it was complete, the updates so far and, for a step
# snapshot, its step (``snapshot_step``, optional)
_EVENT_REQUIRED = {
    "preempt": ("epoch", "completed", "step"),
    # the elastic restore (tpuddp/training/checkpoint.py:692-741): what the
    # file was written on, what it was restored onto, which leaves were
    # refitted and what happened to the error-feedback residual
    "topology_change": ("from_world", "to_world", "from_model", "to_model", "checkpoint",
                        "checkpoint_epoch", "resharded_leaves", "residual"),
    "comm_state_reset": ("leaf", "from_world", "to_world", "reason"),
    # the watchdog's verdict (tpuddp/resilience/watchdog.py:400-412)
    "watchdog_stale": ("process", "timeout_s", "stale_peers", "max_observed_lag_s"),
    # the pod aggregator's verdict (tpuddp/observability/aggregate.py:219-228)
    "straggler": ("host", "ratio", "windows", "window_p50_ms", "pod_p50_ms"),
}


def stamp(record_type: str, record: dict) -> dict:
    """Return ``record`` wrapped in the schema envelope (type first, so the
    line is eyeball-able with ``head``)."""
    if record_type not in RECORD_TYPES:
        raise ValueError(
            f"unknown record type {record_type!r}; expected one of {RECORD_TYPES}"
        )
    return {"type": record_type, "schema_version": SCHEMA_VERSION, **record}


def config_hash(training: Optional[dict]) -> Optional[str]:
    """Stable short hash of a training-config mapping — the run_meta field
    that answers "were these two runs the same configuration?" without
    embedding the whole config in every history file."""
    if not training:
        return None
    canon = json.dumps(training, sort_keys=True, default=str)
    return hashlib.sha256(canon.encode()).hexdigest()[:16]


def make_run_meta(
    *,
    world_size: Optional[int],
    process_count: int = 1,
    process_index: int = 0,
    device_kind: Optional[str] = None,
    hierarchy: Optional[Tuple[int, int]] = None,
    comm_hook: Optional[str] = None,
    comm_topology: Optional[str] = None,
    guard=None,
    observability: Optional[dict] = None,
    tracing: Optional[dict] = None,
    comm: Optional[dict] = None,
    snapshot=False,
    extra: Optional[dict] = None,
    mesh: Optional[dict] = None,
    decode: Optional[dict] = None,
    survivability: Optional[dict] = None,
    tuning: Optional[dict] = None,
) -> dict:
    """The run_meta header row of a port run, with every key of the JAX
    package's ``make_run_meta`` (``tpuddp/observability/schema.py:325-433``).
    ``world_size`` None is a writer without a mesh (the watchdog's header:
    ``mesh_shape`` and ``mesh`` null). ``hierarchy`` is ``(hosts, local)`` under ``comm_topology:
    hierarchical`` (the mesh shape is then ``{"host", "local"}``, as the
    JAX package factors its mesh); ``guard`` a ``GuardConfig`` or dict;
    ``observability`` the live plane's block (schema v5: the exporter's
    bound endpoint or False, the aggregation and straggler knobs, the flight
    recorder's capacity or False; None for a writer without the plane, the
    watchdog's header); ``tracing`` the tracer's ``describe()`` (schema v9,
    None when off); ``comm`` the ``{"overlap": ...}`` block; ``snapshot`` the step-snapshot
    engine's ``describe()`` (native), the managed drain's block, or False
    when off (schema v11); ``extra`` the entry point's fields (config_hash,
    model, dataset, api, ...); ``mesh`` the DDP wrap's ``{"data", "model",
    "tp_rules_hash"}`` block (a tensor-parallel run's ``model`` over 1 and
    its rule table's hash; the mesh shape then ``{"data", "model"}``), else
    derived from ``world_size``; ``decode`` the decode engine's provenance
    (schema v6) and ``survivability`` a serving engine's policy (v7), null
    for every other writer; ``tuning`` the ``$TPUDDP_TUNE_OVERLAY``
    provenance (v12, ``config.tuning_provenance_from_env``), null without
    an overlay."""
    import torch

    import tpuddp_torch

    given, mesh_shape, mesh = mesh, None, None  # None: a writer without a mesh (the watchdog's)
    if world_size is not None:
        world_size = int(world_size)
        if hierarchy is not None:
            mesh_shape = {"host": int(hierarchy[0]), "local": int(hierarchy[1])}
        else:
            mesh_shape = {"data": world_size}
        mesh = dict(given or {"data": world_size, "model": 1, "tp_rules_hash": None})
        if mesh["model"] > 1:
            mesh_shape = {"data": mesh["data"], "model": mesh["model"]}
    if dataclasses.is_dataclass(guard):
        guard = dataclasses.asdict(guard)
    record = {
        "jax_version": None,
        "tpuddp_version": tpuddp_torch.__version__,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "world_size": world_size,
        "process_count": int(process_count),
        "process_index": int(process_index),
        "mesh_shape": mesh_shape,
        "mesh": mesh,
        "device_kind": device_kind,
        "comm_hook": comm_hook,
        "comm_topology": comm_topology,
        "guard": guard,
        "observability": observability,
        "decode": decode,
        "survivability": survivability,
        "tracing": tracing,
        "comm": comm,
        "snapshot": snapshot,
        "tuning": tuning,
    }
    if extra:
        record.update(extra)
    return stamp("run_meta", record)


# ------------------------------------------------------------- validation --


def validate_record(record, index: int = 0) -> List[str]:
    """Schema errors for one history record (empty list = valid)."""
    where = f"record {index}"
    if not isinstance(record, dict):
        return [f"{where}: not a JSON object"]
    errors = []
    rtype = record.get("type")
    if rtype not in RECORD_TYPES:
        return [f"{where}: unknown type {rtype!r} (expected one of {RECORD_TYPES})"]
    version = record.get("schema_version")
    if not isinstance(version, int) or version < 1:
        errors.append(f"{where}: schema_version {version!r} is not a positive int")
    elif version > SCHEMA_VERSION:
        errors.append(
            f"{where}: schema_version {version} is newer than this reader's "
            f"{SCHEMA_VERSION}"
        )
    required = list(_REQUIRED[rtype])
    if isinstance(version, int):
        for since, extra in _REQUIRED_SINCE.items():
            if version >= since:
                required += list(extra.get(rtype, ()))
    missing = [k for k in required if k not in record]
    if missing:
        errors.append(f"{where} ({rtype}): missing required field(s) {missing}")
    if rtype == "event" and not isinstance(record.get("event"), str):
        errors.append(f"{where} (event): 'event' must be a string")
    elif rtype == "event":
        missing = [k for k in _EVENT_REQUIRED.get(record["event"], ()) if k not in record]
        if missing:
            errors.append(f"{where} (event {record['event']}): missing field(s) {missing}")
    if rtype == "run_meta":
        shape = record.get("mesh_shape")
        if shape is not None and not isinstance(shape, dict):
            errors.append(f"{where} (run_meta): mesh_shape must be an object or null")
        if isinstance(version, int) and version >= 10 and "comm" in record:
            comm = record.get("comm")
            if comm is not None and (
                not isinstance(comm, dict) or "overlap" not in comm
            ):
                errors.append(
                    f"{where} (run_meta): comm must be null or an object "
                    "with an 'overlap' member"
                )
    return errors


def validate_history_records(records: Iterable[dict]) -> List[str]:
    """Schema errors for a whole history (empty list = valid).

    The FIRST record must be ``run_meta``; later ``run_meta`` rows are legal
    (a resumed run appends a fresh header before its epochs)."""
    errors: List[str] = []
    n = 0
    for i, record in enumerate(records):
        n += 1
        if i == 0 and (
            not isinstance(record, dict) or record.get("type") != "run_meta"
        ):
            errors.append(
                "record 0: history must start with a run_meta header row, got "
                f"type {record.get('type') if isinstance(record, dict) else record!r}"
            )
        errors.extend(validate_record(record, i))
    if n == 0:
        errors.append("empty history: no records")
    return errors


def validate_history_file(path: str) -> Tuple[List[str], int]:
    """Parse + validate a ``history.jsonl`` file. Returns (errors, n_records).
    Non-strict JSON (bare NaN/Infinity tokens) is itself a schema error."""

    def _reject(token):
        raise ValueError(f"non-strict JSON token {token}")

    errors: List[str] = []
    records = []
    try:
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                if not line.strip():
                    continue
                try:
                    records.append(json.loads(line, parse_constant=_reject))
                except ValueError as e:
                    errors.append(f"line {lineno}: invalid JSON ({e})")
    except OSError as e:
        return [f"cannot read {path}: {e}"], 0
    errors.extend(validate_history_records(records))
    return errors, len(records)


# ------------------------------------------------------ flight recordings --
# flightrec_<reason>.json (tpuddp/observability/schema.py:570-642): one JSON
# object, the envelope and per-kind rings of ordinary history records, each
# validated by the history's own per-record rules.
FLIGHT_TYPE = "flight_recording"
FLIGHT_REASONS = (
    "preempt",          # SIGTERM/SIGINT drain (exit 75)
    "preempt_forced",   # the drain blew the grace window; the failsafe forced exit 75
    "watchdog",         # a peer's heartbeat went stale (exit 76)
    "desync",           # the guard's auditor found a divergent replica (77)
    "exception",        # an unhandled exception in an epoch loop
    "serving_dispatch", # the serving engine lost its last healthy replica
)
_FLIGHT_REQUIRED = ("reason", "process_index", "capacity", "counts", "records")
_FLIGHT_RINGS = ("step_stats", "event", "epoch", "serving_stats", "decode_stats")


def _strict_json(path: str):
    """``path`` parsed as strict JSON (a bare NaN or Infinity raises)."""

    def _reject(token):
        raise ValueError(f"non-strict JSON token {token}")

    with open(path) as f:
        return json.load(f, parse_constant=_reject)


def validate_flight_payload(payload) -> List[str]:
    """Schema errors for a flight-recording payload (empty = valid)."""
    if not isinstance(payload, dict):
        return ["flight payload is not a JSON object"]
    errors = []
    if payload.get("type") != FLIGHT_TYPE:
        errors.append(f"'type' must be {FLIGHT_TYPE!r}, got {payload.get('type')!r}")
    version = payload.get("schema_version")
    if not isinstance(version, int) or version < 5:
        errors.append(f"schema_version {version!r} is not an int >= 5 (flight "
                      "recordings were introduced at v5)")
    elif version > SCHEMA_VERSION:
        errors.append(f"schema_version {version} is newer than this reader's {SCHEMA_VERSION}")
    errors += [f"missing field {k!r}" for k in _FLIGHT_REQUIRED if k not in payload]
    reason = payload.get("reason")
    if "reason" in payload and reason not in FLIGHT_REASONS:
        errors.append(f"unknown reason {reason!r}; expected one of {FLIGHT_REASONS}")
    records = payload.get("records")
    if records is not None:
        if not isinstance(records, dict):
            errors.append("'records' must be an object of ring -> [records]")
        else:
            for ring in _FLIGHT_RINGS:
                entries = records.get(ring, [])
                if not isinstance(entries, list):
                    errors.append(f"ring {ring!r} is not a list")
                    continue
                for i, rec in enumerate(entries):
                    for e in validate_record(rec, i):
                        errors.append(f"ring {ring!r}: {e}")
                    if isinstance(rec, dict) and rec.get("type") != ring:
                        errors.append(f"ring {ring!r} record {i}: type {rec.get('type')!r} "
                                      "does not belong in this ring")
    run_meta = payload.get("run_meta")
    if run_meta is not None:
        for e in validate_record(run_meta, 0):
            errors.append(f"run_meta: {e}")
    return errors


def validate_flight_file(path: str) -> Tuple[List[str], int]:
    """Parse and validate a flight recording: ``(errors, ring records)``;
    non-strict JSON is itself an error."""
    try:
        payload = _strict_json(path)
    except (OSError, ValueError) as e:
        return [f"cannot parse {path}: {e}"], 0
    errors = validate_flight_payload(payload)
    n = 0
    if isinstance(payload, dict) and isinstance(payload.get("records"), dict):
        n = sum(len(v) for v in payload["records"].values() if isinstance(v, list))
    return errors, n


# ---------------------------------------------------------- trace artifacts --
# trace_<role>.json (tpuddp/observability/schema.py:645-775): Chrome trace
# events (complete "X" spans, metadata and flow events) and a ``tpuddp``
# provenance block; Perfetto loads it as it is.
TRACE_TYPE = "trace"
_TRACE_META_REQUIRED = ("role", "process_index", "capacity", "spans", "dropped", "open_spans",
                        "by_kind", "slowest", "clock_sync")


def validate_trace_payload(payload) -> List[str]:
    """Schema errors for a trace artifact (empty = valid). Every X event's
    ``parent_id`` must name a span of the artifact while the ring dropped
    nothing (``tpuddp.dropped == 0``)."""
    if not isinstance(payload, dict):
        return ["trace payload is not a JSON object"]
    errors = []
    events = payload.get("traceEvents")
    if not isinstance(events, list):
        errors.append("'traceEvents' must be a list")
        events = []
    meta = payload.get("tpuddp")
    if not isinstance(meta, dict):
        return errors + ["missing 'tpuddp' provenance block"]
    if meta.get("type") != TRACE_TYPE:
        errors.append(f"tpuddp.type must be {TRACE_TYPE!r}, got {meta.get('type')!r}")
    version = meta.get("schema_version")
    if not isinstance(version, int) or version < 9:
        errors.append(f"tpuddp.schema_version {version!r} is not an int >= 9 (trace "
                      "artifacts were introduced at v9)")
    elif version > SCHEMA_VERSION:
        errors.append(f"tpuddp.schema_version {version} is newer than this reader's "
                      f"{SCHEMA_VERSION}")
    errors += [f"tpuddp block missing field {k!r}" for k in _TRACE_META_REQUIRED
               if k not in meta]
    clock = meta.get("clock_sync")
    if isinstance(clock, dict):
        for k in ("unix_us", "perf_ns"):
            if not isinstance(clock.get(k), (int, float)):
                errors.append(f"clock_sync.{k} is not a number")
    span_ids = set()
    x_events = []
    for i, e in enumerate(events):
        if not isinstance(e, dict) or "ph" not in e:
            errors.append(f"event {i}: not an object with a 'ph' field")
            continue
        if e["ph"] != "X":
            continue
        x_events.append((i, e))
        missing = [k for k in ("name", "ts", "dur", "pid", "tid") if k not in e]
        if missing:
            errors.append(f"event {i} (X): missing field(s) {missing}")
        args = e.get("args")
        if not isinstance(args, dict) or "span_id" not in args or "trace_id" not in args:
            errors.append(f"event {i} (X): args must carry span_id and trace_id")
            continue
        span_ids.add(args["span_id"])
    if meta.get("dropped") == 0:
        for i, e in x_events:
            parent = (e.get("args") or {}).get("parent_id")
            if parent is not None and parent not in span_ids:
                errors.append(f"event {i} (X): orphan parent_id {parent} — no such span in the "
                              "artifact (and the ring dropped nothing)")
    return errors


def validate_trace_file(path: str) -> Tuple[List[str], int]:
    """Parse and validate a trace artifact: ``(errors, X events)``;
    non-strict JSON is itself an error."""
    try:
        payload = _strict_json(path)
    except (OSError, ValueError) as e:
        return [f"cannot parse {path}: {e}"], 0
    errors = validate_trace_payload(payload)
    n = 0
    if isinstance(payload, dict) and isinstance(payload.get("traceEvents"), list):
        n = sum(1 for e in payload["traceEvents"] if isinstance(e, dict) and e.get("ph") == "X")
    return errors, n


# ----------------------------------------------------------- tune reports --
# TUNE_r*.json (tpuddp/observability/schema.py:760-868), the A/B probe's
# report (python -m tpuddp_torch.tune, tune/probe.py): one JSON object
# stamped ``type: tune_report``, its baseline metrics and one result row
# per advisor rule probed.
TUNE_MODES = ("train", "serving")
_TUNE_ROW_REQUIRED = ("rule", "rule_class", "knob", "diff", "metric", "predicted_delta_pct",
                      "measured_delta_pct", "endorsed", "evidence")
TUNE_RULE_CLASSES = ("pipeline", "comm", "snapshot", "serving")


def validate_tune_payload(payload) -> List[str]:
    """Schema errors for a ``TUNE_r*.json`` payload (empty = valid), the JAX
    package's texts. A row whose ``measured_delta_pct`` is negative (a
    regression on its own metric) must not carry ``endorsed: true``: the
    fleet never applies a knob the probe watched regress."""
    if not isinstance(payload, dict):
        return ["tune payload is not a JSON object"]
    errors = []
    if payload.get("type") != "tune_report":
        errors.append(f"'type' must be 'tune_report', got {payload.get('type')!r}")
    version = payload.get("schema_version")
    if not isinstance(version, int) or version < 12:
        errors.append(f"schema_version {version!r} is not an int >= 12 (tune reports "
                      "were introduced at v12)")
    elif version > SCHEMA_VERSION:
        errors.append(f"schema_version {version} is newer than this reader's {SCHEMA_VERSION}")
    errors += [f"missing field {k!r}" for k in _REQUIRED["tune_report"] if k not in payload]
    if "mode" in payload and payload.get("mode") not in TUNE_MODES:
        errors.append(f"unknown mode {payload.get('mode')!r}; expected one of {TUNE_MODES}")
    if "baseline_metrics" in payload and not isinstance(payload.get("baseline_metrics"), dict):
        errors.append("'baseline_metrics' must be an object of metric -> value")
    results = payload.get("results")
    if results is None:
        return errors
    if not isinstance(results, list):
        return errors + ["'results' must be a list of rule rows"]
    for i, row in enumerate(results):
        if not isinstance(row, dict):
            errors.append(f"result {i}: not an object")
            continue
        missing = [k for k in _TUNE_ROW_REQUIRED if k not in row]
        if missing:
            errors.append(f"result {i}: missing field(s) {missing}")
        rclass = row.get("rule_class")
        if "rule_class" in row and rclass not in TUNE_RULE_CLASSES:
            errors.append(f"result {i}: unknown rule_class {rclass!r}; expected one "
                          f"of {TUNE_RULE_CLASSES}")
        if "diff" in row and not isinstance(row.get("diff"), dict):
            errors.append(f"result {i}: 'diff' must be a config-diff object")
        if "evidence" in row and not isinstance(row.get("evidence"), list):
            errors.append(f"result {i}: 'evidence' must be a list of citations")
        measured = row.get("measured_delta_pct")
        if isinstance(measured, (int, float)) and measured < 0 and row.get("endorsed") is True:
            errors.append(f"result {i}: endorsed=true with a regressing measured "
                          f"delta ({measured:+.2f}%) — the probe must refuse")
    return errors


def validate_tune_file(path: str) -> Tuple[List[str], int]:
    """Parse and validate a ``TUNE_r*.json`` artifact: ``(errors, result
    rows)``; non-strict JSON is itself an error."""
    try:
        payload = _strict_json(path)
    except (OSError, ValueError) as e:
        return [f"cannot parse {path}: {e}"], 0
    errors = validate_tune_payload(payload)
    n = len(payload["results"]) if isinstance(payload, dict) and isinstance(
        payload.get("results"), list) else 0
    return errors, n
