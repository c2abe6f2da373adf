"""Trace/metric-driven autotuning advisor — the observability plane's
consumer; the counterpart of ``tpuddp/observability/advisor.py``, rule for
rule (the same thresholds, diffs, predictions and report shape).

The advisor is a read-only evidence engine over a finished (or live) run
directory's artifacts:

- ``history.jsonl``       — run_meta provenance + epoch/step_stats/serving/
                            decode windows (schema.py, v12 reader);
- ``trace_<role>.json``   — the causal span trees (dispatch/stage/readback/
                            collective time shares, overlap segment digests);
- ``*.writer.json``       — the async snapshot writer's sidecars (backlog,
                            write seconds, skipped-queue-full counts).

It distills them into typed **evidence features** (:func:`extract_evidence`)
and walks a **rule table** (:data:`RULES`) mapping evidence to knob
recommendations. Each recommendation is a typed config diff carrying its
evidence citations (source artifact + field + observed value) and a
predicted delta on a named metric — never a bare "try X". Rules that need
span evidence report ``insufficient_evidence`` on a trace-less run instead
of guessing (satellite contract: a v11 history with no trace artifact must
degrade gracefully, not silently skip).

Three consumers:

- ``python -m tpuddp_torch.inspect tune <run_dir>`` — offline: print diff
  + evidence table; ``--emit`` writes the merged overlay
  (:func:`overlay_from`);
- ``python -m tpuddp_torch.tune`` — A/B probe: baseline vs recommended
  through the real entry point, predicted-vs-measured into TUNE_r*.json
  (``tpuddp_torch/tune/probe.py`` builds + schema-validates the artifact);
- the fleet tuner (``tpuddp_torch/tune/online.py``) — applies at most one
  ENDORSED knob per job per cooldown via drain-and-relaunch, reverts on
  regression.

Deliberately **pure stdlib** (no torch, no package imports): the flight
recorder's ``pending_tune`` context provider must never pull device deps
into a crash path.
"""

from __future__ import annotations

import glob as glob_lib
import json
import os
from typing import Dict, List, Optional

RULE_CLASSES = ("pipeline", "comm", "snapshot", "serving")

# Evidence thresholds — module constants so tests can reference (not patch)
# the exact boundaries the rules fire at.
HOST_STALL_SHARE_THRESHOLD = 0.10   # host stall fraction of epoch wall time
READBACK_SHARE_THRESHOLD = 0.20     # readback span share of traced step time
DISPATCH_SHARE_THRESHOLD = 0.30     # dispatch span share of traced step time
SNAPSHOT_HOT_EVERY_STEPS = 2        # a cadence this tight is itself evidence
SNAPSHOT_WRITE_SHARE_FLOOR = 0.02   # min predicted win for cadence backoff
OCCUPANCY_FLOOR = 0.30              # serving batch occupancy below = starved
KV_PRESSURE_THRESHOLD = 0.85        # decode KV-pool occupancy above = thrash
COMM_BYTES_FLOOR = 1024             # per-update grad bytes below this: noise


def _mean(xs) -> Optional[float]:
    vals = [float(x) for x in xs if isinstance(x, (int, float))]
    return sum(vals) / len(vals) if vals else None


def _num(x, default=None):
    return float(x) if isinstance(x, (int, float)) else default


def cite(source: str, field: str, value) -> dict:
    """One evidence citation: which artifact, which field, what we saw."""
    return {"source": source, "field": field, "value": value}


# ---------------------------------------------------------------- loading --


def load_run(run_dir: str) -> dict:
    """Gather a run directory's artifacts, tolerantly: a missing or torn
    artifact yields an absent feature, never an exception — the advisor must
    run over a crashed run's partial output (that is its whole point)."""
    history_path = os.path.join(run_dir, "history.jsonl")
    records: List[dict] = []
    try:
        with open(history_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    records.append(rec)
    except OSError:
        pass

    run_meta: Dict = {}
    for rec in records:
        if rec.get("type") == "run_meta":
            run_meta.update(rec)  # resumed runs append headers; last wins

    traces = []
    for path in sorted(glob_lib.glob(os.path.join(run_dir, "trace_*.json"))):
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(payload, dict):
            payload["_path"] = os.path.basename(path)
            traces.append(payload)

    sidecars = []
    for path in sorted(
        glob_lib.glob(os.path.join(run_dir, "**", "*.writer.json"),
                      recursive=True)
    ):
        try:
            with open(path) as f:
                stats = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(stats, dict):
            sidecars.append({"path": os.path.relpath(path, run_dir),
                             "stats": stats})

    return {
        "run_dir": run_dir,
        "history_path": history_path,
        "records": records,
        "run_meta": run_meta,
        "traces": traces,
        "writer_sidecars": sidecars,
    }


# ------------------------------------------------------ evidence features --


def _epoch_features(records: List[dict]) -> dict:
    epochs = [r for r in records if r.get("type") == "epoch"]
    steps = [r for r in records if r.get("type") == "step_stats"]
    total_time = sum(
        v for v in (_num(r.get("epoch_time_s")) for r in epochs) if v
    )
    total_stall_ms = sum(
        v for v in (_num(r.get("host_stall_ms")) for r in epochs) if v
    )
    stall_share = (
        (total_stall_ms / 1000.0) / total_time if total_time > 0 else None
    )
    return {
        "epochs": len(epochs),
        "step_windows": len(steps),
        "samples_per_sec_mean": _mean(r.get("samples_per_sec") for r in epochs),
        "step_time_ms_p50_mean": _mean(
            r.get("step_time_ms_p50") for r in epochs
        ),
        "epoch_time_s_total": total_time or None,
        "host_stall_ms_total": total_stall_ms or 0.0,
        "host_stall_share": stall_share,
        "inflight_depth_mean": _mean(r.get("inflight_depth") for r in steps),
        "staging_queue_depth_mean": _mean(
            r.get("staging_queue_depth") for r in steps
        ),
    }


def _span_features(traces: List[dict]) -> dict:
    """Per-category span-time shares across every trace artifact. The share
    denominator is the traced step-phase time (dispatch+stage+readback+
    collective), NOT wall time — ring-dropped spans make wall shares lie."""
    if not traces:
        return {"available": False}
    by_cat: Dict[str, float] = {}
    overlap_segments = set()
    spans = 0
    dropped = 0
    for payload in traces:
        meta = payload.get("tpuddp") or {}
        dropped += int(_num(meta.get("dropped"), 0) or 0)
        for e in payload.get("traceEvents") or []:
            if not isinstance(e, dict) or e.get("ph") != "X":
                continue
            spans += 1
            cat = str(e.get("cat") or "")
            dur = _num(e.get("dur"), 0.0) or 0.0
            by_cat[cat] = by_cat.get(cat, 0.0) + dur
            name = str(e.get("name") or "")
            if name.startswith("grad_comm.seg"):
                overlap_segments.add(name)
    phase_total = sum(
        by_cat.get(c, 0.0)
        for c in ("dispatch", "stage", "readback", "collective")
    )
    shares = {}
    if phase_total > 0:
        for c in ("dispatch", "stage", "readback", "collective"):
            shares[c] = by_cat.get(c, 0.0) / phase_total
    return {
        "available": spans > 0,
        "spans": spans,
        "dropped": dropped,
        "time_us_by_cat": by_cat,
        "shares": shares,
        "overlap_segment_names": sorted(overlap_segments),
    }


def _snapshot_features(run_meta: dict, sidecars: List[dict]) -> dict:
    block = run_meta.get("snapshot")
    armed = isinstance(block, dict)
    agg = {"snapshots": 0, "skipped_queue_full": 0, "write_s": 0.0,
           "bytes": 0}
    for sc in sidecars:
        stats = sc["stats"]
        agg["snapshots"] += int(_num(stats.get("snapshots"), 0) or 0)
        agg["skipped_queue_full"] += int(
            _num(stats.get("skipped_queue_full"), 0) or 0
        )
        agg["write_s"] += _num(stats.get("write_s"), 0.0) or 0.0
        agg["bytes"] += int(_num(stats.get("bytes"), 0) or 0)
    return {
        "armed": armed,
        "config": dict(block) if armed else None,
        "sidecars": len(sidecars),
        "writer": agg if sidecars else None,
    }


def _serving_features(records: List[dict]) -> dict:
    windows = [r for r in records if r.get("type") == "serving_stats"]
    if not windows:
        return {"available": False}
    return {
        "available": True,
        "windows": len(windows),
        "occupancy_mean": _mean(r.get("batch_occupancy") for r in windows),
        "queue_ms_p50_mean": _mean(r.get("queue_ms_p50") for r in windows),
        "device_ms_p50_mean": _mean(r.get("device_ms_p50") for r in windows),
        "e2e_ms_p50_mean": _mean(r.get("e2e_ms_p50") for r in windows),
        "throughput_rps_mean": _mean(
            r.get("throughput_rps") for r in windows
        ),
        "shed_total": sum(
            int(v) for v in (_num(r.get("shed")) for r in windows) if v
        ),
        "rejected_total": sum(
            int(v) for v in (_num(r.get("rejected")) for r in windows) if v
        ),
    }


def _decode_features(records: List[dict]) -> dict:
    windows = [r for r in records if r.get("type") == "decode_stats"]
    if not windows:
        return {"available": False}
    return {
        "available": True,
        "windows": len(windows),
        "tokens_per_sec_mean": _mean(
            r.get("tokens_per_sec") for r in windows
        ),
        "ttft_ms_p50_mean": _mean(r.get("ttft_ms_p50") for r in windows),
        "itl_ms_p50_mean": _mean(r.get("itl_ms_p50") for r in windows),
        "itl_ms_p95_mean": _mean(r.get("itl_ms_p95") for r in windows),
        "kv_occupancy_mean": _mean(r.get("kv_occupancy") for r in windows),
        "shed_total": sum(
            int(v) for v in (_num(r.get("shed")) for r in windows) if v
        ),
    }


def extract_evidence(run: dict) -> dict:
    """Distill loaded artifacts into the typed feature dict the rule table
    consumes. Every feature group is present (possibly with ``available:
    False`` / None members) so rules index safely."""
    run_meta = run["run_meta"]
    records = run["records"]
    comm_block = run_meta.get("comm") if isinstance(
        run_meta.get("comm"), dict
    ) else None
    return {
        "run_dir": run["run_dir"],
        "run_meta": {
            "present": bool(run_meta),
            "world_size": _num(run_meta.get("world_size")),
            "process_count": _num(run_meta.get("process_count")),
            "comm_hook": run_meta.get("comm_hook"),
            "comm_topology": run_meta.get("comm_topology"),
            "pipeline": run_meta.get("pipeline") if isinstance(
                run_meta.get("pipeline"), dict
            ) else None,
            "scan_steps": run_meta.get("scan_steps"),
            "overlap": (comm_block or {}).get("overlap"),
            "grad_comm_bytes_per_update": _num(
                run_meta.get("grad_comm_bytes_per_update")
            ),
            "grad_comm_bytes_per_update_f32": _num(
                run_meta.get("grad_comm_bytes_per_update_f32")
            ),
            "grad_comm_bytes_inter_host": _num(
                run_meta.get("grad_comm_bytes_inter_host")
            ),
            "grad_comm_bytes_intra_host": _num(
                run_meta.get("grad_comm_bytes_intra_host")
            ),
            "tuning": run_meta.get("tuning"),
        },
        "train": _epoch_features(records),
        "spans": _span_features(run["traces"]),
        "snapshot": _snapshot_features(run_meta, run["writer_sidecars"]),
        "serving": _serving_features(records),
        "decode": _decode_features(records),
    }


# -------------------------------------------------------------- rule table --


def _rec(rule, rule_class, section, knob, diff, metric, predicted, reason,
         evidence):
    """``predicted_delta_pct`` is a predicted IMPROVEMENT on ``metric``,
    always positive-is-better: for lower-better metrics (latencies, wire
    bytes, sheds) it is the predicted reduction. tune/probe.py
    measures deltas under the same convention, so predicted and measured
    columns compare directly."""
    return {
        "rule": rule,
        "rule_class": rule_class,
        "section": section,
        "knob": knob,
        "diff": diff,
        "metric": metric,
        "predicted_delta_pct": round(float(predicted), 2),
        "reason": reason,
        "evidence": evidence,
    }


def _rule_pipeline_sync(ev):
    """pipeline:false (the synchronous A/B reference) left in production:
    every dispatch blocks on its own readback. Predicted win = the measured
    host-stall share of epoch wall time (the time the device sat idle
    waiting on the host), floored at 2% when stall accounting is absent."""
    pipe = ev["run_meta"]["pipeline"]
    if not pipe:
        return None
    sync = bool(pipe.get("sync_readback")) or (
        int(_num(pipe.get("depth"), 2) or 2) <= 1
        and int(_num(pipe.get("host_workers"), 2) or 2) == 0
    )
    if not sync:
        return None
    stall = ev["train"]["host_stall_share"]
    predicted = max((stall or 0.0) * 100.0, 2.0)
    evidence = [cite("history.jsonl#run_meta", "pipeline", pipe)]
    if stall is not None:
        evidence.append(cite(
            "history.jsonl#epoch", "host_stall_share", round(stall, 4)
        ))
    return _rec(
        "pipeline_sync_readback", "pipeline", "training", "pipeline",
        {"pipeline": True}, "samples_per_sec", predicted,
        "synchronous readback pipeline (depth 1, no host workers) — enable "
        "the staged async pipeline to overlap host assembly with device "
        "compute",
        evidence,
    )


def _rule_pipeline_stall_depth(ev):
    """Pipeline is on but the device still stalls on the host: the staged
    lookahead is too shallow (or too few loader workers). Deepen both;
    predicted win = half the stall share (lookahead hides latency, it does
    not create host bandwidth)."""
    pipe = ev["run_meta"]["pipeline"]
    stall = ev["train"]["host_stall_share"]
    if not pipe or bool(pipe.get("sync_readback")):
        return None
    if stall is None or stall <= HOST_STALL_SHARE_THRESHOLD:
        return None
    depth = int(_num(pipe.get("depth"), 2) or 2)
    workers = int(_num(pipe.get("host_workers"), 2) or 2)
    return _rec(
        "pipeline_host_stall_depth", "pipeline", "training", "pipeline",
        {"pipeline": {"depth": depth * 2,
                      "host_workers": max(workers * 2, 4)}},
        "samples_per_sec", stall * 100.0 / 2.0,
        f"host stall is {stall:.0%} of epoch wall time with the async "
        "pipeline already on — deepen the staged lookahead and host workers",
        [
            cite("history.jsonl#epoch", "host_stall_share", round(stall, 4)),
            cite("history.jsonl#run_meta", "pipeline.depth", depth),
            cite("history.jsonl#run_meta", "pipeline.host_workers", workers),
        ],
    )


def _rule_span_readback(ev):
    """Trace evidence: readback spans dominate the traced step phases —
    the dispatch cursor is draining results too eagerly. Deepen the staged
    chunk lookahead so readbacks ride behind more dispatched work."""
    spans = ev["spans"]
    if not spans.get("available"):
        return "insufficient_evidence"
    share = (spans.get("shares") or {}).get("readback")
    if share is None or share <= READBACK_SHARE_THRESHOLD:
        return None
    pipe = ev["run_meta"]["pipeline"] or {}
    depth = int(_num(pipe.get("depth"), 2) or 2)
    return _rec(
        "span_readback_share", "pipeline", "training", "pipeline",
        {"pipeline": {"depth": depth + 2}},
        "step_time_ms_p50", share * 100.0 / 2.0,
        f"readback spans are {share:.0%} of traced step time — deepen the "
        "staged lookahead so result drains overlap later dispatches",
        [cite("trace_*.json", "shares.readback", round(share, 4))],
    )


def _rule_span_dispatch(ev):
    """Trace evidence: per-step dispatch overhead dominates — fuse more
    steps into one compiled scan so the host pays the dispatch cost once
    per scan window instead of once per step."""
    spans = ev["spans"]
    if not spans.get("available"):
        return "insufficient_evidence"
    share = (spans.get("shares") or {}).get("dispatch")
    if share is None or share <= DISPATCH_SHARE_THRESHOLD:
        return None
    scan = ev["run_meta"]["scan_steps"]
    current = int(scan) if isinstance(scan, (int, float)) else 1
    return _rec(
        "span_dispatch_share", "pipeline", "training", "scan_steps",
        {"scan_steps": max(current * 4, 8)},
        "step_time_ms_p50", share * 100.0 / 2.0,
        f"dispatch spans are {share:.0%} of traced step time — widen the "
        "compiled scan window to amortize per-step dispatch",
        [
            cite("trace_*.json", "shares.dispatch", round(share, 4)),
            cite("history.jsonl#run_meta", "scan_steps", scan),
        ],
    )


def _rule_comm_uncompressed(ev):
    """Gradients cross the wire uncompressed in a multi-chip world. bf16
    with error feedback halves the wire bytes at (empirically) neutral
    convergence — the DynamiQ-style first rung of the compression ladder."""
    rm = ev["run_meta"]
    world = rm["world_size"]
    per_update = rm["grad_comm_bytes_per_update"]
    if rm["comm_hook"] not in (None, "none"):
        return None
    if not world or world <= 1:
        return None
    if not per_update or per_update < COMM_BYTES_FLOOR:
        return None
    return _rec(
        "comm_hook_uncompressed", "comm", "training", "comm_hook",
        {"comm_hook": "bf16_ef"}, "grad_comm_bytes", 50.0,
        f"{int(per_update)} gradient bytes/update cross the interconnect "
        "uncompressed — bf16 error-feedback compression halves the wire "
        "bytes",
        [
            cite("history.jsonl#run_meta", "comm_hook", rm["comm_hook"]),
            cite("history.jsonl#run_meta", "grad_comm_bytes_per_update",
                 int(per_update)),
            cite("history.jsonl#run_meta", "world_size", int(world)),
        ],
    )


def _rule_comm_topology(ev):
    """Multi-host job reducing over a flat topology: every gradient byte
    crosses the slow inter-host wire world_size-wide. Hierarchical reduction
    (intra-host first) cuts inter-host bytes to ~1/local_world of flat."""
    rm = ev["run_meta"]
    procs = rm["process_count"]
    inter = rm["grad_comm_bytes_inter_host"]
    if rm["comm_topology"] != "flat" or not procs or procs <= 1:
        return None
    if not inter or inter <= 0:
        return None
    world = rm["world_size"] or procs
    local = max(int(world // procs), 1)
    predicted = (1.0 - 1.0 / local) * 100.0 if local > 1 else 50.0
    return _rec(
        "comm_topology_flat_multihost", "comm", "training", "comm_topology",
        {"comm_topology": "hierarchical"}, "grad_comm_bytes_inter_host",
        predicted,
        f"{procs} hosts reduce over a flat topology — hierarchical "
        "reduction drains intra-host first and sends one local-reduced "
        "shard across the inter-host wire",
        [
            cite("history.jsonl#run_meta", "comm_topology",
                 rm["comm_topology"]),
            cite("history.jsonl#run_meta", "process_count", int(procs)),
            cite("history.jsonl#run_meta", "grad_comm_bytes_inter_host",
                 int(inter)),
        ],
    )


def _rule_comm_overlap_off(ev):
    """The gradient exchange ran as one trailing barrier although the world
    is multi-chip: segmented-backward overlap interleaves bucket collectives
    with backward compute (run_meta.comm.overlap records enabled: false)."""
    rm = ev["run_meta"]
    overlap = rm["overlap"]
    world = rm["world_size"]
    if not isinstance(overlap, dict) or overlap.get("enabled"):
        return None
    if not world or world <= 1:
        return None
    return _rec(
        "comm_overlap_disabled", "comm", "training", "comm_overlap",
        {"comm_overlap": True}, "step_time_ms_p50", 5.0,
        "gradient exchange ran as a single trailing barrier — segmented "
        "backward overlap hides bucket collectives behind backward compute",
        [
            cite("history.jsonl#run_meta", "comm.overlap", overlap),
            cite("history.jsonl#run_meta", "world_size", int(world)),
        ],
    )


def _rule_snapshot_backlog(ev):
    """The async snapshot writer dropped cadence points because its inflight
    queue was full (sidecar skipped_queue_full > 0): the durability contract
    is silently thinner than configured. Double the inflight budget."""
    snap = ev["snapshot"]
    writer = snap.get("writer")
    if not snap["armed"] or not writer:
        return None
    skipped = writer.get("skipped_queue_full", 0)
    if skipped <= 0:
        return None
    inflight = int(_num((snap["config"] or {}).get("inflight"), 1) or 1)
    return _rec(
        "snapshot_writer_backlog", "snapshot", "training", "snapshot",
        {"snapshot": {"inflight": max(inflight * 2, 2)}},
        "snapshot_skipped_queue_full", 100.0,
        f"writer skipped {skipped} snapshot(s) on a full inflight queue — "
        "double the inflight budget so cadence points are not dropped",
        [
            cite("*.writer.json", "skipped_queue_full", int(skipped)),
            cite("history.jsonl#run_meta", "snapshot.inflight", inflight),
        ],
    )


def _rule_snapshot_cadence(ev):
    """Snapshotting every step (or two): the writer serializes the whole
    model state at step cadence, which even async dispatch cannot make free.
    Back the cadence off; predicted win = the measured write-seconds share
    of epoch wall time (floored — toy runs measure tiny absolute writes)."""
    snap = ev["snapshot"]
    if not snap["armed"]:
        return None
    cfg = snap["config"] or {}
    every = int(_num(cfg.get("every_steps"), 0) or 0)
    if every <= 0 or every > SNAPSHOT_HOT_EVERY_STEPS:
        return None
    writer = snap.get("writer") or {}
    write_s = _num(writer.get("write_s"), 0.0) or 0.0
    total = ev["train"]["epoch_time_s_total"]
    share = write_s / total if total else 0.0
    evidence = [
        cite("history.jsonl#run_meta", "snapshot.every_steps", every),
    ]
    if writer:
        evidence.append(cite("*.writer.json", "write_s", round(write_s, 3)))
        evidence.append(cite("*.writer.json", "snapshots",
                             writer.get("snapshots")))
    return _rec(
        "snapshot_cadence_hot", "snapshot", "training", "snapshot",
        {"snapshot": {"every_steps": max(every * 8, 16)}},
        "samples_per_sec",
        max(share * 100.0, SNAPSHOT_WRITE_SHARE_FLOOR * 100.0),
        f"step snapshots every {every} step(s) serialize model state at "
        "near-step cadence — back off the cadence; mid-epoch resume only "
        "needs bounded replay, not per-step durability",
        evidence,
    )


def _rule_serving_linger(ev):
    """Serving batches leave mostly empty while requests wait in queue:
    the batch window (batch_timeout_ms) lingers for fill that never comes.
    Shorten it; predicted win = the queue share of end-to-end latency."""
    srv = ev["serving"]
    if not srv.get("available"):
        return None
    occ = srv.get("occupancy_mean")
    queue = srv.get("queue_ms_p50_mean")
    device = srv.get("device_ms_p50_mean")
    e2e = srv.get("e2e_ms_p50_mean")
    if occ is None or occ >= OCCUPANCY_FLOOR:
        return None
    if queue is None or device is None or queue <= device:
        return None
    share = queue / e2e if e2e else 0.5
    return _rec(
        "serving_low_occupancy_linger", "serving", "serving",
        "batch_timeout_ms", {"batch_timeout_ms": 1}, "e2e_ms_p50",
        min(share, 0.9) * 100.0,
        f"batch occupancy {occ:.0%} with queue wait ({queue:.1f} ms p50) "
        f"above device time ({device:.1f} ms p50) — the batch window "
        "lingers for fill that never arrives; dispatch eagerly",
        [
            cite("history.jsonl#serving_stats", "batch_occupancy_mean",
                 round(occ, 3)),
            cite("history.jsonl#serving_stats", "queue_ms_p50_mean",
                 round(queue, 2)),
            cite("history.jsonl#serving_stats", "device_ms_p50_mean",
                 round(device, 2)),
        ],
    )


def _rule_serving_shed(ev):
    """The survivability layer shed deadline-expired requests: admission
    capacity is below arrival rate. Deepen the admission queue so bursts
    wait instead of dying (sustained overload needs replicas, not queue —
    the reason lands in the recommendation text)."""
    srv = ev["serving"]
    if not srv.get("available"):
        return None
    shed = srv.get("shed_total", 0)
    if shed <= 0:
        return None
    return _rec(
        "serving_shed_pressure", "serving", "serving", "max_queue_depth",
        {"max_queue_depth": 128}, "shed", 100.0,
        f"{shed} request(s) shed at the deadline — deepen the admission "
        "queue to absorb bursts (if shed persists at depth, the fix is "
        "replicas, not queue)",
        [cite("history.jsonl#serving_stats", "shed_total", int(shed))],
    )


def _rule_decode_kv_pressure(ev):
    """Decode KV pool runs near-full and tail inter-token latency detaches
    from the median: too many concurrent sequences thrash the pool. Fewer
    slots trade admission concurrency for stable ITL."""
    dec = ev["decode"]
    if not dec.get("available"):
        return None
    kv = dec.get("kv_occupancy_mean")
    p50 = dec.get("itl_ms_p50_mean")
    p95 = dec.get("itl_ms_p95_mean")
    if kv is None or kv <= KV_PRESSURE_THRESHOLD:
        return None
    if p50 is None or p95 is None or p95 <= 2.0 * p50:
        return None
    return _rec(
        "decode_kv_pressure", "serving", "decode", "max_slots",
        {"max_slots": 0.75}, "itl_ms_p95", 25.0,
        f"KV occupancy {kv:.0%} with ITL p95 ({p95:.1f} ms) detached from "
        f"p50 ({p50:.1f} ms) — shrink max_slots ~25% so resident sequences "
        "stop thrashing the pool",
        [
            cite("history.jsonl#decode_stats", "kv_occupancy_mean",
                 round(kv, 3)),
            cite("history.jsonl#decode_stats", "itl_ms_p95_mean",
                 round(p95, 2)),
            cite("history.jsonl#decode_stats", "itl_ms_p50_mean",
                 round(p50, 2)),
        ],
    )


# (rule id, rule class, needs) → fn(evidence) -> recommendation | None |
# "insufficient_evidence". ``needs`` names the artifact family the rule
# cannot run without; history-only rules keep firing on a trace-less run.
RULES = (
    ("pipeline_sync_readback", "pipeline", "history", _rule_pipeline_sync),
    ("pipeline_host_stall_depth", "pipeline", "history",
     _rule_pipeline_stall_depth),
    ("span_readback_share", "pipeline", "trace", _rule_span_readback),
    ("span_dispatch_share", "pipeline", "trace", _rule_span_dispatch),
    ("comm_hook_uncompressed", "comm", "history", _rule_comm_uncompressed),
    ("comm_topology_flat_multihost", "comm", "history", _rule_comm_topology),
    ("comm_overlap_disabled", "comm", "history", _rule_comm_overlap_off),
    ("snapshot_writer_backlog", "snapshot", "history", _rule_snapshot_backlog),
    ("snapshot_cadence_hot", "snapshot", "history", _rule_snapshot_cadence),
    ("serving_low_occupancy_linger", "serving", "history",
     _rule_serving_linger),
    ("serving_shed_pressure", "serving", "history", _rule_serving_shed),
    ("decode_kv_pressure", "serving", "history", _rule_decode_kv_pressure),
)


def advise(run_dir: str) -> dict:
    """Run the full rule table over a run directory. Returns::

        {
          "run_dir": ...,
          "evidence": <extract_evidence features>,
          "recommendations": [rec, ...],   # typed diffs, best-first
          "insufficient": [{rule, rule_class, needs, reason}, ...],
        }

    Span-needing rules land in ``insufficient`` (not silence) when no trace
    artifact exists — the reader can tell "evidence said no" from "evidence
    was never collected"."""
    run = load_run(run_dir)
    ev = extract_evidence(run)
    recommendations = []
    insufficient = []
    for rule_id, rule_class, needs, fn in RULES:
        try:
            out = fn(ev)
        except Exception as e:  # noqa: BLE001 — one bad rule must not
            insufficient.append({       # take the advisor down
                "rule": rule_id, "rule_class": rule_class, "needs": needs,
                "reason": f"rule error: {e}",
            })
            continue
        if out == "insufficient_evidence":
            insufficient.append({
                "rule": rule_id, "rule_class": rule_class, "needs": needs,
                "reason": "insufficient_evidence: no trace artifact in "
                          "this run dir (tracing was off or predates v9)",
            })
        elif out is not None:
            recommendations.append(out)
    recommendations.sort(
        key=lambda r: r["predicted_delta_pct"], reverse=True
    )
    return {
        "run_dir": run_dir,
        "evidence": ev,
        "recommendations": recommendations,
        "insufficient": insufficient,
    }


def overlay_from(recommendations: List[dict]) -> dict:
    """Merge recommendation diffs into one config overlay, sectioned the way
    settings files are (``training`` / ``serving`` / ``decode``). Dict-valued
    knobs (pipeline, snapshot) merge shallowly; a later scalar replaces —
    EXCEPT ``True`` landing on a dict: a bare enable never erases a sibling
    rule's refinement of the same knob (``pipeline: true`` after
    ``pipeline: {depth: 3}`` keeps the depth)."""
    overlay: Dict[str, dict] = {}
    for rec in recommendations:
        section = overlay.setdefault(rec.get("section") or "training", {})
        for knob, value in rec["diff"].items():
            have = section.get(knob)
            if isinstance(value, dict) and isinstance(have, dict):
                section[knob] = {**have, **value}
            elif value is True and isinstance(have, dict):
                pass  # already enabled with refinements
            else:
                section[knob] = value
    return overlay


# ------------------------------------------------------------ measurement --


def measure_run(run_dir: str, mode: str = "train") -> dict:
    """The A/B probe's metric reader: summarize a finished run into the
    flat metric dict predicted deltas are verified against. Direction
    semantics live in tune/probe.py (this just reports numbers)."""
    run = load_run(run_dir)
    ev = extract_evidence(run)
    metrics: Dict[str, Optional[float]] = {}
    if mode == "train":
        tr = ev["train"]
        metrics["samples_per_sec"] = tr["samples_per_sec_mean"]
        metrics["step_time_ms_p50"] = tr["step_time_ms_p50_mean"]
        metrics["epoch_time_s"] = tr["epoch_time_s_total"]
        metrics["host_stall_ms"] = tr["host_stall_ms_total"]
        writer = ev["snapshot"].get("writer") or {}
        metrics["snapshot_skipped_queue_full"] = float(
            writer.get("skipped_queue_full", 0)
        )
        metrics["snapshot_write_s"] = float(writer.get("write_s", 0.0))
        rm = ev["run_meta"]
        metrics["grad_comm_bytes"] = rm["grad_comm_bytes_per_update"]
        metrics["grad_comm_bytes_inter_host"] = rm[
            "grad_comm_bytes_inter_host"
        ]
    else:
        srv = ev["serving"]
        metrics["throughput_rps"] = srv.get("throughput_rps_mean")
        metrics["e2e_ms_p50"] = srv.get("e2e_ms_p50_mean")
        metrics["batch_occupancy"] = srv.get("occupancy_mean")
        metrics["shed"] = float(srv.get("shed_total", 0) or 0)
        dec = ev["decode"]
        if dec.get("available"):
            metrics["tokens_per_sec"] = dec.get("tokens_per_sec_mean")
            metrics["itl_ms_p95"] = dec.get("itl_ms_p95_mean")
    return {k: v for k, v in metrics.items() if v is not None}


def pending_summary(run_dir: str) -> Optional[dict]:
    """The flight recorder's ``pending_tune`` context payload: the top
    (unendorsed) recommendation the advisor would make over this run dir
    right now — dumped on preempt/exception so a crash never discards the
    evidence that was about to be acted on. None when nothing fires."""
    try:
        report = advise(run_dir)
    except Exception:  # noqa: BLE001 — crash paths must never re-crash
        return None
    recs = report["recommendations"]
    if not recs:
        return None
    top = recs[0]
    return {
        "rule": top["rule"],
        "rule_class": top["rule_class"],
        "knob": top["knob"],
        "diff": top["diff"],
        "metric": top["metric"],
        "predicted_delta_pct": top["predicted_delta_pct"],
        "endorsed": False,
        "pending_rules": [r["rule"] for r in recs],
    }


# ---------------------------------------------------------------- display --


def format_report(report: dict) -> str:
    """Human rendering for ``python -m tpuddp_torch.inspect tune`` — the diff, then the
    evidence table, then the rules that could not run."""
    lines = [f"advisor report for {report['run_dir']}"]
    recs = report["recommendations"]
    if not recs:
        lines.append("  no recommendations — evidence looks clean")
    for rec in recs:
        lines.append(
            f"  [{rec['rule_class']}] {rec['rule']}: "
            f"{json.dumps(rec['diff'], sort_keys=True)} "
            f"(predicted {rec['predicted_delta_pct']:+.1f}% improvement "
            f"on {rec['metric']})"
        )
        lines.append(f"      why: {rec['reason']}")
        for c in rec["evidence"]:
            lines.append(
                f"      evidence: {c['source']} :: {c['field']} = "
                f"{json.dumps(c['value'], sort_keys=True)}"
            )
    for miss in report["insufficient"]:
        lines.append(
            f"  [{miss['rule_class']}] {miss['rule']}: skipped — "
            f"{miss['reason']}"
        )
    if recs:
        lines.append(
            "  overlay: "
            + json.dumps(overlay_from(recs), sort_keys=True)
        )
    return "\n".join(lines)
