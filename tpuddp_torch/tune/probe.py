"""A/B probe arithmetic + the ``TUNE_r*.json`` report (schema v12) — the
counterpart of ``tpuddp/tune/probe.py``.

The advisor predicts; this module is where predictions meet measurement.
One sign convention everywhere: a delta is an **improvement percentage**
(positive = better). For higher-better metrics (throughput) that is the
raw relative change; for lower-better metrics (latencies, wire bytes,
sheds) it is the relative REDUCTION — so a predicted +50% on
``grad_comm_bytes`` and a measured +48% compare directly, and the
endorsement rule is one comparison: ``measured >= min_improvement``.

The honesty contract (enforced by ``schema.validate_tune_payload``): a rule
whose measured delta regresses ships ``endorsed: false`` in the artifact —
the probe REFUSES to endorse it, whatever the prediction promised. The
fleet tuner (``tpuddp_torch/tune/online.py``) only acts on endorsed rules.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

from tpuddp_torch.observability import schema as schema_lib

# Direction table for every metric the advisor predicts on or the probe
# measures (observability/advisor.py measure_run keys). A metric missing
# from BOTH sets cannot be judged — delta_pct returns None and the row
# ships unendorsed, never silently assumed a direction.
HIGHER_BETTER = frozenset({
    "samples_per_sec",
    "throughput_rps",
    "tokens_per_sec",
    "batch_occupancy",
})
LOWER_BETTER = frozenset({
    "step_time_ms_p50",
    "epoch_time_s",
    "host_stall_ms",
    "e2e_ms_p50",
    "itl_ms_p95",
    "shed",
    "snapshot_skipped_queue_full",
    "snapshot_write_s",
    "grad_comm_bytes",
    "grad_comm_bytes_inter_host",
})


def delta_pct(metric: str, baseline, tuned) -> Optional[float]:
    """Improvement percentage of ``tuned`` over ``baseline`` on ``metric``
    (positive = better), or None when it cannot be judged (missing value,
    unknown direction)."""
    if baseline is None or tuned is None:
        return None
    if metric not in HIGHER_BETTER and metric not in LOWER_BETTER:
        return None
    baseline = float(baseline)
    tuned = float(tuned)
    if baseline == 0.0:
        # zero baselines are common for count metrics (shed 0, skips 0):
        # staying at zero is neutral, leaving zero is a full regression /
        # improvement — a ratio against zero would be meaningless either way
        if tuned == baseline:
            return 0.0
        good = (tuned > 0) == (metric in HIGHER_BETTER)
        return 100.0 if good else -100.0
    change = (tuned - baseline) / abs(baseline) * 100.0
    return change if metric in HIGHER_BETTER else -change


def endorse(
    measured_delta_pct: Optional[float], min_improvement_pct: float = 0.0
) -> bool:
    """The endorsement verdict: measured, and not a regression. An
    unmeasurable delta is NOT endorsable — no data is not a pass."""
    return (
        measured_delta_pct is not None
        and measured_delta_pct >= min_improvement_pct
    )


def make_result_row(
    rec: dict,
    baseline_metrics: Dict[str, float],
    tuned_metrics: Dict[str, float],
    min_improvement_pct: float = 0.0,
) -> dict:
    """One TUNE_r*.json result row from an advisor recommendation + the
    two measured metric dicts (advisor.measure_run of each run dir)."""
    metric = rec["metric"]
    baseline = baseline_metrics.get(metric)
    tuned = tuned_metrics.get(metric)
    measured = delta_pct(metric, baseline, tuned)
    return {
        "rule": rec["rule"],
        "rule_class": rec["rule_class"],
        "knob": rec["knob"],
        "diff": rec["diff"],
        "metric": metric,
        "predicted_delta_pct": rec["predicted_delta_pct"],
        "measured_delta_pct": (
            round(measured, 2) if measured is not None else None
        ),
        "baseline_value": baseline,
        "tuned_value": tuned,
        "endorsed": endorse(measured, min_improvement_pct),
        "evidence": rec["evidence"],
        "reason": rec.get("reason"),
    }


def build_tune_report(
    *,
    device: Optional[str],
    mode: str,
    baseline_metrics: Dict[str, float],
    results: List[dict],
    extra: Optional[dict] = None,
) -> dict:
    """Assemble + validate the tune_report payload; raises ValueError on a
    payload that would not survive the schema's ``validate_tune_payload`` (the writer
    must never ship an artifact its own reader rejects)."""
    payload = schema_lib.stamp("tune_report", {
        "device": device,
        "mode": mode,
        "baseline_metrics": dict(baseline_metrics),
        "results": list(results),
        **(extra or {}),
    })
    errors = schema_lib.validate_tune_payload(payload)
    if errors:
        raise ValueError(
            "refusing to write an invalid tune report: " + "; ".join(errors)
        )
    return payload


_TUNE_NAME_RE = re.compile(r"^TUNE_r(\d+)\.json$")


def next_tune_path(root: str) -> str:
    """Next free ``TUNE_rNN.json`` path under ``root`` (r01, r02, ...) —
    the BENCH_r*/SERVING_r* artifact-family naming."""
    highest = 0
    try:
        names = os.listdir(root)
    except OSError:
        names = []
    for name in names:
        m = _TUNE_NAME_RE.match(name)
        if m:
            highest = max(highest, int(m.group(1)))
    return os.path.join(root, f"TUNE_r{highest + 1:02d}.json")
