"""The online fleet tuner — advisor recommendations applied through the
drain-and-relaunch contract, with measured verification and auto-revert;
the counterpart of ``tpuddp/tune/online.py``.

The shape mirrors the autoscaler (``tpuddp_torch/fleet/autoscale.py``): a frozen
:class:`TunePolicy`, a stateful :class:`FleetTuner` whose decision function
is pure in (artifacts, internal state, now), and injectable edges (the
``advise``/``reader`` callables) so the whole policy matrix unit-tests
without processes or sockets. The controller calls
:meth:`FleetTuner.observe_and_decide` per running job per tick and applies
any decision by mutating the job supervisor's env
(``$TPUDDP_TUNE_OVERLAY``, ``tpuddp_torch/config.py``) and signalling a drain — the
child exits 75, the supervisor relaunches with the overlay, and the
resumed header carries ``run_meta.tuning`` provenance.

The contract, per job:

- **at most one knob change per cooldown** — and only rules ENDORSED by an
  offline A/B probe (``endorsed_rules``, usually
  :func:`endorsed_rules_from_report` over a ``TUNE_r*.json``), unless the
  tuner was explicitly built with ``endorsed_rules=None`` (trust-advisor
  mode, for controlled experiments);
- **post-change measurement** — after an apply, the tuner watches the
  job's own history rows appended SINCE the change and compares the judge
  metric against the pre-change baseline window;
- **revert-if-regressed** — a measured improvement below
  ``revert_threshold_pct`` restores the previous overlay through the same
  drain contract; the refuted rule is never retried on that job;
- **typed audit** — every apply/keep/revert lands as a ``tune_action``
  event row in the job's namespaced ``history.jsonl`` and moves the
  ``tpuddp_tune_*`` /metrics counters (:meth:`FleetTuner.export_source`).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Callable, Dict, Iterable, List, Optional, Set

from tpuddp_torch.observability import advisor as advisor_lib
from tpuddp_torch.observability import schema as schema_lib
from tpuddp_torch.tune import probe

logger = logging.getLogger("tpuddp")

# Which history row types carry each judge metric — the post-change window
# is measured from the job's OWN typed records, not a scrape, so the tuner
# works on any run dir the advisor works on.
ROW_METRIC_TYPES = {
    "samples_per_sec": ("epoch", "step_stats"),
    "step_time_ms_p50": ("epoch", "step_stats"),
    "throughput_rps": ("serving_stats",),
    "e2e_ms_p50": ("serving_stats",),
    "tokens_per_sec": ("decode_stats",),
    "itl_ms_p95": ("decode_stats",),
}
_DEFAULT_JUDGE = {"training": "samples_per_sec", "serving": "throughput_rps"}


def _read_records(run_dir: str) -> List[dict]:
    return advisor_lib.load_run(run_dir)["records"]


def endorsed_rules_from_report(path: str) -> Set[str]:
    """The rules a ``TUNE_r*.json`` artifact endorsed — the offline probe's
    verdict feeding the online tuner. Empty set on a missing/invalid file
    (no probe = nothing endorsed, the tuner stays inert)."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return set()
    if not isinstance(payload, dict):
        return set()
    return {
        row["rule"]
        for row in payload.get("results") or []
        if isinstance(row, dict) and row.get("endorsed") is True
        and isinstance(row.get("rule"), str)
    }


@dataclasses.dataclass(frozen=True)
class TunePolicy:
    """The online tuner's knob table (README "Self-tuning").

    ``cooldown_s`` bounds the action rate per job (applies, keeps and
    reverts all arm it); ``baseline_rows``/``measure_rows`` size the
    pre/post windows of history rows the judge metric is averaged over;
    ``revert_threshold_pct`` is the measured-improvement floor below which
    an applied change is rolled back; ``min_improvement_pct`` is the
    advisor-prediction floor below which a recommendation is not worth a
    drain at all."""

    cooldown_s: float = 300.0
    baseline_rows: int = 3
    measure_rows: int = 2
    revert_threshold_pct: float = 0.0
    min_improvement_pct: float = 1.0

    def __post_init__(self):
        if self.cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0, got {self.cooldown_s}")
        if self.baseline_rows < 1:
            raise ValueError(
                f"baseline_rows must be >= 1, got {self.baseline_rows}"
            )
        if self.measure_rows < 1:
            raise ValueError(
                f"measure_rows must be >= 1, got {self.measure_rows}"
            )


class FleetTuner:
    """Per-job apply/measure/revert state around the advisor's rule table.

    ``endorsed_rules``: the allow-list of rules the offline probe endorsed
    (None = trust the advisor's predictions — explicit opt-in only).
    ``advise``/``reader`` are injectable for socket-free tests."""

    def __init__(
        self,
        policy: Optional[TunePolicy] = None,
        endorsed_rules: Optional[Iterable[str]] = None,
        advise: Callable[[str], dict] = advisor_lib.advise,
        reader: Callable[[str], List[dict]] = _read_records,
    ):
        self.policy = policy or TunePolicy()
        self.endorsed_rules = (
            None if endorsed_rules is None else set(endorsed_rules)
        )
        self.advise = advise
        self.reader = reader
        # name -> {"phase", "active" (decision), "n_records",
        #          "baseline_value", "judge_metric"}
        self._state: Dict[str, dict] = {}
        self._kept: Dict[str, dict] = {}          # name -> overlay sections
        self._applied_rules: Dict[str, Set[str]] = {}
        self._generation: Dict[str, int] = {}
        self._last_action: Dict[str, float] = {}
        self.counters = {"applied": 0, "reverted": 0, "kept": 0}
        self.actions: List[dict] = []  # audit trail (tests + CLI logging)

    # ------------------------------------------------------------ helpers --
    def _cooled(self, name: str, now: float) -> bool:
        last = self._last_action.get(name)
        return last is None or (now - last) >= self.policy.cooldown_s

    @staticmethod
    def _tail_value(
        records: List[dict], metric: str, rows: int
    ) -> Optional[float]:
        types = ROW_METRIC_TYPES.get(metric, ())
        vals = [
            float(r[metric])
            for r in records
            if r.get("type") in types
            and isinstance(r.get(metric), (int, float))
        ]
        if not vals:
            return None
        tail = vals[-rows:]
        return sum(tail) / len(tail)

    @staticmethod
    def _merge_sections(base: dict, extra: dict) -> dict:
        merged = {sec: dict(knobs) for sec, knobs in base.items()}
        for sec, knobs in extra.items():
            dst = merged.setdefault(sec, {})
            for knob, value in knobs.items():
                if isinstance(value, dict) and isinstance(dst.get(knob), dict):
                    dst[knob] = {**dst[knob], **value}
                else:
                    dst[knob] = value
        return merged

    def _overlay_env(self, name: str, sections: dict, rule: str,
                     generation: int) -> dict:
        """The ``$TPUDDP_TUNE_OVERLAY`` JSON value: config sections plus
        the provenance fields config.apply_tune_overlay stamps into
        ``run_meta.tuning``."""
        return {
            "source": "fleet",
            "rule": rule,
            "generation": generation,
            **sections,
        }

    # ------------------------------------------------------------- decide --
    def observe_and_decide(
        self, name: str, kind: str, run_dir: str, now: float
    ) -> Optional[dict]:
        """One tick for one job: a decision dict (action apply/keep/revert)
        or None. Pure in (artifacts, internal state, now) — the controller
        applies the decision and then calls :meth:`mark_applied`."""
        st = self._state.get(name)
        if st is not None and st["phase"] == "measuring":
            return self._decide_measuring(name, st, run_dir)
        return self._decide_idle(name, kind, run_dir, now)

    def _decide_measuring(
        self, name: str, st: dict, run_dir: str
    ) -> Optional[dict]:
        active = st["active"]
        metric = st["judge_metric"]
        records = self.reader(run_dir)
        post = records[st["n_records"]:]
        post_value = self._tail_value(post, metric, self.policy.measure_rows)
        n_post = sum(
            1 for r in post
            if r.get("type") in ROW_METRIC_TYPES.get(metric, ())
            and isinstance(r.get(metric), (int, float))
        )
        if post_value is None or n_post < self.policy.measure_rows:
            return None  # not enough post-change evidence yet — keep waiting
        measured = probe.delta_pct(metric, st["baseline_value"], post_value)
        if measured is None:
            return None
        base = {
            "job": name,
            "rule": active["rule"],
            "rule_class": active["rule_class"],
            "knob": active["knob"],
            "diff": active["diff"],
            "section": active.get("section") or "training",
            "generation": active["generation"],
            "predicted_delta_pct": active["predicted_delta_pct"],
            "judge_metric": metric,
            "baseline_value": st["baseline_value"],
            "measured_value": post_value,
            "measured_delta_pct": round(measured, 2),
        }
        if measured < self.policy.revert_threshold_pct:
            kept = self._kept.get(name) or {}
            return {
                **base,
                "action": "revert",
                "overlay_env": (
                    self._overlay_env(
                        name, kept, active["rule"], active["generation"]
                    )
                    if kept else None
                ),
                "why": (
                    f"measured {measured:+.2f}% on {metric} below revert "
                    f"threshold {self.policy.revert_threshold_pct:+.2f}% "
                    f"(predicted {active['predicted_delta_pct']:+.2f}%)"
                ),
            }
        return {
            **base,
            "action": "keep",
            "overlay_env": None,  # keep = env unchanged, no drain
            "why": (
                f"measured {measured:+.2f}% on {metric} (predicted "
                f"{active['predicted_delta_pct']:+.2f}%) — change endorsed "
                "online"
            ),
        }

    def _decide_idle(
        self, name: str, kind: str, run_dir: str, now: float
    ) -> Optional[dict]:
        if not self._cooled(name, now):
            return None
        try:
            report = self.advise(run_dir)
        except Exception as e:  # noqa: BLE001 — a torn run dir is "no data"
            logger.warning("tune: advise over %s failed: %s", run_dir, e)
            return None
        recs = report.get("recommendations") or []
        tried = self._applied_rules.get(name, set())
        candidates = [
            r for r in recs
            if r["rule"] not in tried
            and r["predicted_delta_pct"] >= self.policy.min_improvement_pct
            and (
                self.endorsed_rules is None
                or r["rule"] in self.endorsed_rules
            )
        ]
        if not candidates:
            return None
        top = candidates[0]
        metric = (
            top["metric"]
            if top["metric"] in ROW_METRIC_TYPES
            else _DEFAULT_JUDGE.get(kind, "samples_per_sec")
        )
        records = self.reader(run_dir)
        baseline = self._tail_value(
            records, metric, self.policy.baseline_rows
        )
        if baseline is None:
            # nothing to judge a change against — acting now would make the
            # revert contract unenforceable, so don't act at all
            return None
        generation = self._generation.get(name, 0) + 1
        sections = self._merge_sections(
            self._kept.get(name) or {}, advisor_lib.overlay_from([top])
        )
        return {
            "action": "apply",
            "job": name,
            "rule": top["rule"],
            "rule_class": top["rule_class"],
            "knob": top["knob"],
            "diff": top["diff"],
            "section": top.get("section") or "training",
            "generation": generation,
            "predicted_delta_pct": top["predicted_delta_pct"],
            "evidence": top["evidence"],
            "judge_metric": metric,
            "baseline_value": baseline,
            "n_records": len(records),
            "overlay_env": self._overlay_env(
                name, sections, top["rule"], generation
            ),
            "why": top["reason"],
        }

    # -------------------------------------------------------------- commit --
    def mark_applied(
        self, name: str, run_dir: str, decision: dict, now: float
    ) -> None:
        """The controller applied ``decision`` (env + drain where needed):
        advance state, arm the cooldown, bump counters, land the typed
        ``tune_action`` event in the job's namespaced history."""
        action = decision["action"]
        self._last_action[name] = now
        if action == "apply":
            self._generation[name] = decision["generation"]
            self._state[name] = {
                "phase": "measuring",
                "active": decision,
                "n_records": decision["n_records"],
                "baseline_value": decision["baseline_value"],
                "judge_metric": decision["judge_metric"],
            }
            self.counters["applied"] += 1
        elif action == "keep":
            self._kept[name] = self._merge_sections(
                self._kept.get(name) or {},
                advisor_lib.overlay_from([{
                    "section": decision.get("section") or "training",
                    "diff": decision["diff"],
                }]),
            )
            self._applied_rules.setdefault(name, set()).add(decision["rule"])
            self._state[name] = {"phase": "idle", "active": None}
            self.counters["kept"] += 1
        elif action == "revert":
            self._applied_rules.setdefault(name, set()).add(decision["rule"])
            self._state[name] = {"phase": "idle", "active": None}
            self.counters["reverted"] += 1
        else:
            raise ValueError(f"unknown tune action {action!r}")
        entry = {"t": now, **{
            k: decision.get(k)
            for k in ("action", "job", "rule", "knob", "generation",
                      "measured_delta_pct", "why")
        }}
        self.actions.append(entry)
        logger.warning(
            "tune: %s -> %s rule=%s gen=%s (%s)",
            name, action, decision["rule"], decision["generation"],
            decision.get("why"),
        )
        self._append_event(run_dir, decision, now)

    def _append_event(self, run_dir: str, decision: dict, now: float) -> None:
        """One ``tune_action`` event row in the job's namespaced history —
        best-effort (a vanished run dir must not take the control loop
        down), single atomic append."""
        record = schema_lib.stamp("event", {
            "event": "tune_action",
            "action": decision["action"],
            "job": decision["job"],
            "rule": decision["rule"],
            "rule_class": decision["rule_class"],
            "knob": decision["knob"],
            "diff": decision["diff"],
            "generation": decision["generation"],
            "predicted_delta_pct": decision.get("predicted_delta_pct"),
            "measured_delta_pct": decision.get("measured_delta_pct"),
            "judge_metric": decision.get("judge_metric"),
            "why": decision.get("why"),
        })
        path = os.path.join(run_dir, "history.jsonl")
        try:
            with open(path, "a") as f:
                f.write(json.dumps(record, sort_keys=True) + "\n")
        except OSError as e:
            logger.warning("tune: could not append tune_action to %s: %s",
                           path, e)

    # ------------------------------------------------------------- metrics --
    def export_source(self) -> dict:
        """The ``tpuddp_tune_*`` /metrics series (exporter source shape —
        observability/exporter.py gauge/counter dicts, built inline so this
        module stays importable without the exporter)."""
        measuring = sum(
            1 for st in self._state.values() if st.get("phase") == "measuring"
        )
        def _counter(value, help):
            return {"type": "counter", "help": help, "value": value}
        return {
            "tpuddp_tune_applied_total": _counter(
                self.counters["applied"],
                "knob changes applied through drain-and-relaunch",
            ),
            "tpuddp_tune_reverted_total": _counter(
                self.counters["reverted"],
                "applied knob changes rolled back on a measured regression",
            ),
            "tpuddp_tune_kept_total": _counter(
                self.counters["kept"],
                "applied knob changes endorsed by their post-change window",
            ),
            "tpuddp_tune_measuring": {
                "type": "gauge",
                "help": "jobs currently inside a post-change measurement "
                        "window",
                "value": measuring,
            },
        }
