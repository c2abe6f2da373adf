"""Metric-driven autoscaler: the fleet's sensor-to-planner loop — the
counterpart of ``tpuddp/fleet/autoscale.py``.

The live plane (``observability.exporter``) makes every job scrapeable
while it runs; this module closes the loop: each poll it discovers a job's endpoint
through the NAMESPACED ``<run_dir>/exporter.port`` file, verifies liveness
with a short-timeout ``/healthz`` probe (a SIGKILLed predecessor's stale
port file must never be trusted — ``exporter.read_live_port``), scrapes
``/metrics``, and proposes a new *desired world* for the planner:

- **serving**: scale replicas up on a p99-latency or batch-occupancy SLO
  breach, back down when p99 sits far under the SLO — one replica at a
  time, so capacity moves at the rate evidence accumulates;
- **training**: shrink a job the PodAggregator has CONVICTED as
  straggler-plagued (the typed ``straggler`` events surface as the
  ``tpuddp_pod_straggler_events_total`` counter) — a pod that keeps
  convicting hosts is better off smaller than stalled.

Flapping is structurally damped three ways: a breach must hold for
``hysteresis`` consecutive FRESH observations (the freshness cursor must
move — re-reading one stale window is one piece of evidence, not N); at
most one action per job per ``cooldown_s``; and every proposal is clamped
to the spec's ``[min_world, max_world]`` by the planner anyway.

:class:`Autoscaler` is deliberately split from scraping: ``propose()`` is a
pure function of (observation, per-job streak state, now) so the policy
matrix is unit-testable without sockets, and the controller injects the
real :func:`scrape_job` at the edge.
"""

from __future__ import annotations

import dataclasses
import logging
import re
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

logger = logging.getLogger("tpuddp")


# ------------------------------------------------------ prometheus parsing --
_SAMPLE_RE = re.compile(
    r"^(?P<name>[A-Za-z_:][A-Za-z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$"
)
_LABEL_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> Dict[str, List[Tuple[Dict[str, str], float]]]:
    """Prometheus text exposition -> ``{name: [(labels, value), ...]}``.
    Comment/HELP/TYPE lines and unparseable samples are skipped — the
    scraper consumes its OWN exporter's format, but a partial page (endpoint
    died mid-response) must degrade to fewer samples, not an exception."""
    families: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        labels = {
            k: v.replace('\\"', '"').replace("\\\\", "\\")
            for k, v in _LABEL_RE.findall(m.group("labels") or "")
        }
        families.setdefault(m.group("name"), []).append((labels, value))
    return families


def metric_value(
    families: Dict[str, List[Tuple[Dict[str, str], float]]],
    name: str,
    **labels: str,
) -> Optional[float]:
    """First sample of ``name`` whose labels include every given pair."""
    for sample_labels, value in families.get(name, []):
        if all(sample_labels.get(k) == v for k, v in labels.items()):
            return value
    return None


# --------------------------------------------------------------- scraping --
def scrape_job(run_dir: str, timeout: float = 2.0) -> Optional[dict]:
    """One observation of a job's live plane, or None (no live endpoint —
    port file missing/stale, /healthz dead, or the scrape failed). The
    observation carries the SLO signals plus a ``fresh_cursor``: a value
    that moves only when the job produced new evidence (completed requests
    for serving, telemetry scrapes of a moving counter for training)."""
    from tpuddp_torch.observability import exporter as exp

    port = exp.read_live_port(run_dir, probe_timeout=timeout)
    if port is None:
        return None
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=timeout
        ) as resp:
            families = parse_prometheus(resp.read().decode())
    except Exception as e:  # noqa: BLE001 — a dying job must read as "no data"
        logger.warning("autoscale: scrape of %s failed: %s", run_dir, e)
        return None
    completed = metric_value(families, "tpuddp_serving_completed_total")
    tokens = metric_value(families, "tpuddp_decode_tokens_total")
    steps = metric_value(families, "tpuddp_train_steps_total")
    # survivability (schema v7): a decode job exports decode_shed_total
    # where the request engine exports serving_shed_total — either one is
    # "work shed past its deadline", the overload signal the shed-rate
    # scale-up rule consumes
    shed = metric_value(families, "tpuddp_serving_shed_total")
    if shed is None:
        shed = metric_value(families, "tpuddp_decode_shed_total")
    cursor = completed
    if cursor is None:
        cursor = tokens
    if cursor is None:
        cursor = steps
    return {
        "p99_ms": metric_value(
            families, "tpuddp_serving_e2e_ms", quantile="0.99"
        ),
        "occupancy": metric_value(families, "tpuddp_serving_batch_occupancy"),
        "straggler_events": metric_value(
            families, "tpuddp_pod_straggler_events_total"
        ),
        "shed_total": shed,
        "fresh_cursor": cursor,
        "port": port,
    }


# ----------------------------------------------------------------- policy --
@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """The knob table (README "Fleet operations").

    ``slo_p99_ms``/``occupancy_high`` arm serving scale-up;
    ``shed_high`` arms the survivability scale-up rule: >= this many NEWLY
    shed requests (``tpuddp_serving_shed_total`` / ``decode_shed_total``
    delta) in a fresh window is a breach — the engine is dropping
    deadline-expired work, the most direct overload evidence there is;
    ``scale_down_below`` (fraction of the SLO) arms scale-down;
    ``hysteresis`` fresh breached observations are required before any
    action, and ``cooldown_s`` bounds the action rate per job.
    ``straggler_shrink`` arms the training-shrink path."""

    slo_p99_ms: Optional[float] = None
    occupancy_high: Optional[float] = None
    shed_high: Optional[int] = None
    scale_down_below: float = 0.25
    hysteresis: int = 2
    cooldown_s: float = 30.0
    straggler_shrink: bool = True
    shrink_factor: int = 2

    def __post_init__(self):
        if self.hysteresis < 1:
            raise ValueError(f"hysteresis must be >= 1, got {self.hysteresis}")
        if self.shed_high is not None and self.shed_high < 1:
            raise ValueError(
                f"shed_high must be >= 1 or None, got {self.shed_high}"
            )
        if self.cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0, got {self.cooldown_s}")
        if not (0.0 <= self.scale_down_below < 1.0):
            raise ValueError(
                f"scale_down_below must be in [0, 1), got {self.scale_down_below}"
            )
        if self.shrink_factor < 2:
            raise ValueError(
                f"shrink_factor must be >= 2, got {self.shrink_factor}"
            )


class Autoscaler:
    """Per-job streak/cooldown state around the pure breach rules.

    ``scraper`` is injectable (tests feed synthetic observations); the
    controller calls :meth:`observe_and_propose` per running job per poll
    and forwards any proposal to the planner as the job's new desired."""

    def __init__(
        self,
        policy: Optional[AutoscalePolicy] = None,
        scraper: Callable[[str], Optional[dict]] = scrape_job,
    ):
        self.policy = policy or AutoscalePolicy()
        self.scraper = scraper
        self._breach: Dict[str, int] = {}
        self._low: Dict[str, int] = {}
        self._cursor: Dict[str, object] = {}
        self._last_action: Dict[str, float] = {}
        self._stragglers_seen: Dict[str, float] = {}
        self._shed_seen: Dict[str, float] = {}
        self.actions: List[dict] = []  # audit trail (tests + CLI logging)

    # ------------------------------------------------------------ helpers --
    def _cooled(self, name: str, now: float) -> bool:
        last = self._last_action.get(name)
        return last is None or (now - last) >= self.policy.cooldown_s

    def _record(self, name: str, now: float, action: str, world: int, why: str):
        self._last_action[name] = now
        self._breach[name] = 0
        self._low[name] = 0
        entry = {"job": name, "action": action, "world": world, "why": why,
                 "t": now}
        self.actions.append(entry)
        logger.warning(
            "autoscale: %s -> %s to world %d (%s)", name, action, world, why
        )

    # ------------------------------------------------------------- decide --
    def propose(
        self,
        name: str,
        kind: str,
        current: int,
        min_world: int,
        max_world: int,
        obs: Optional[dict],
        now: float,
    ) -> Optional[int]:
        """New desired world, or None (no action this poll). Pure in
        (obs, internal streaks, now) — no I/O."""
        if obs is None:
            return None  # a dead endpoint is absence of evidence, not breach
        pol = self.policy
        fresh = obs.get("fresh_cursor") != self._cursor.get(name)
        self._cursor[name] = obs.get("fresh_cursor")

        if kind == "training":
            events = obs.get("straggler_events")
            if events is None or not pol.straggler_shrink:
                return None
            seen = self._stragglers_seen.get(name)
            if seen is None:
                self._stragglers_seen[name] = events  # baseline observation
                return None
            if events <= seen:
                return None
            if current <= min_world:
                # convicted, but nowhere to go: consume the evidence so a
                # later (autoscaler-external) grow doesn't re-fire on it
                self._stragglers_seen[name] = events
                return None
            if not self._cooled(name, now):
                # keep the evidence pending: a conviction landing inside
                # the cooldown must still shrink once the cooldown ends
                return None
            self._stragglers_seen[name] = events
            world = max(min_world, current // pol.shrink_factor)
            if world < current:
                self._record(
                    name, now, "shrink", world,
                    f"straggler conviction(s) {seen:.0f} -> {events:.0f}",
                )
                return world
            return None

        # serving: SLO-driven replica scaling
        p99 = obs.get("p99_ms")
        occ = obs.get("occupancy")
        # shed-rate rule (survivability, schema v7): newly shed work since
        # the last FRESH observation is overload evidence — the first
        # observation is a baseline, never a breach
        shed_now = obs.get("shed_total")
        shed_delta = 0.0
        if shed_now is not None:
            seen = self._shed_seen.get(name)
            if seen is not None:
                shed_delta = shed_now - seen
            if fresh or seen is None:
                self._shed_seen[name] = shed_now
        breach = (
            pol.slo_p99_ms is not None and p99 is not None and p99 > pol.slo_p99_ms
        ) or (
            pol.occupancy_high is not None
            and occ is not None
            and occ > pol.occupancy_high
        ) or (
            pol.shed_high is not None and shed_delta >= pol.shed_high
        )
        low = (
            pol.slo_p99_ms is not None
            and p99 is not None
            and p99 < pol.slo_p99_ms * pol.scale_down_below
        )
        if fresh:  # only new evidence moves a streak
            self._breach[name] = self._breach.get(name, 0) + 1 if breach else 0
            self._low[name] = self._low.get(name, 0) + 1 if low else 0
        if (
            self._breach.get(name, 0) >= pol.hysteresis
            and self._cooled(name, now)
            and current < max_world
        ):
            self._record(
                name, now, "scale_up", current + 1,
                f"p99 {p99} ms / occupancy {occ} / shed +{shed_delta:.0f} "
                f"breached for {self._breach[name]} fresh window(s)",
            )
            return current + 1
        if (
            self._low.get(name, 0) >= pol.hysteresis
            and self._cooled(name, now)
            and current > min_world
        ):
            self._record(
                name, now, "scale_down", current - 1,
                f"p99 {p99} ms under {pol.scale_down_below:.0%} of SLO for "
                f"{self._low[name]} fresh window(s)",
            )
            return current - 1
        return None

    # ---------------------------------------------------------- full tick --
    def observe_and_propose(
        self,
        name: str,
        kind: str,
        run_dir: str,
        current: int,
        min_world: int,
        max_world: int,
        now: float,
    ) -> Optional[int]:
        return self.propose(
            name, kind, current, min_world, max_world,
            self.scraper(run_dir), now,
        )
