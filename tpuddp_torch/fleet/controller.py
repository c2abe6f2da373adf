"""The live fleet controller — per-job supervisors under one planner; the
counterpart of ``tpuddp/fleet/controller.py``.

Each admitted :class:`~tpuddp_torch.fleet.spec.JobSpec` runs as its own
:class:`~tpuddp_torch.resilience.supervisor.RestartSupervisor` (on a thread, with
the supervisor's full exit-code policy: 75 resume-now, backoff restarts,
signal-death classification) inside a **namespaced run dir**
``<fleet_dir>/jobs/<name>`` — heartbeats, ``exporter.port``, checkpoints,
``history.jsonl`` and flight recordings all live under the job's own dir,
so co-scheduled jobs cannot clobber each other's channels.

Every control decision is the pure planner's
(:func:`~tpuddp_torch.fleet.scheduler.plan_fleet`); the controller only *applies*
plans, and always through the drain contract:

- **start**   — spawn the job's supervisor at its planned world on its slice;
- **resize**  — retarget the supervisor's world (``set_world``), then
  SIGTERM the live child: it drains to exit 75 (emergency checkpoint) and
  the supervisor relaunches IMMEDIATELY at the new
  ``$TPUDDP_WORLD_SIZE`` / ``$TPUDDP_SERVING_REPLICAS`` — the elastic
  restore (``training/checkpoint.py``, ``training/reshard.py``) refits the
  state; nothing is lost to a rebalance;
- **preempt** — ``request_stop()`` FIRST (so the supervisor cannot win the
  race and relaunch preempted work), then SIGTERM and let the child drain.

**Never SIGKILL first.** A drained/resized/preempted child gets the full
``$TPUDDP_PREEMPT_GRACE`` window (plus a margin for the in-child failsafe
to dump its flight recording and force exit 75); only a child still alive
past that deadline is escalated to SIGKILL — and that lands as a negative
rc the supervisor classifies by signal name.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional

from tpuddp_torch.fleet.scheduler import JobView, Plan, plan_fleet
from tpuddp_torch.fleet.spec import FleetAdmissionError, JobSpec
from tpuddp_torch.observability import trace as trace_lib
from tpuddp_torch.resilience.preemption import preemption_grace_seconds
from tpuddp_torch.resilience.supervisor import (
    WORLD_ENV,
    RestartSupervisor,
    SupervisorPolicy,
)

logger = logging.getLogger("tpuddp")

SERVING_WORLD_ENV = "TPUDDP_SERVING_REPLICAS"

# job lifecycle states
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
FAILED = "failed"
PREEMPTED = "preempted"
TERMINAL = (DONE, FAILED, PREEMPTED)

# headroom past $TPUDDP_PREEMPT_GRACE before SIGKILL: the child's own
# failsafe needs time to dump its flight recording and force exit 75
_ESCALATE_MARGIN_S = 5.0


def escalate_drain(
    proc: subprocess.Popen,
    grace: Optional[float] = None,
    poll: float = 0.1,
) -> int:
    """Blocking drain-then-escalate: SIGTERM, wait up to ``grace`` seconds
    for the child to drain (exit 75 on the contract), SIGKILL only past the
    deadline. Returns the child's rc (negative = killed by signal). The
    controller's async path mirrors this with per-step deadlines; this
    helper is for shutdown paths and the chaos proof of the escalation
    ordering."""
    if grace is None:
        grace = preemption_grace_seconds() + _ESCALATE_MARGIN_S
    if proc.poll() is not None:
        return proc.returncode
    try:
        proc.send_signal(signal.SIGTERM)
    except (ProcessLookupError, OSError):
        return proc.wait()
    deadline = time.monotonic() + grace
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            return proc.returncode
        time.sleep(poll)
    logger.critical(
        "fleet: child pid %d ignored SIGTERM for %.1fs; escalating to "
        "SIGKILL", proc.pid, grace,
    )
    try:
        proc.kill()
    except (ProcessLookupError, OSError):
        pass
    return proc.wait()


class ManagedJob:
    """One job's live state under the controller."""

    def __init__(self, spec: JobSpec, arrival: int, run_dir: str):
        self.spec = spec
        self.arrival = arrival
        self.run_dir = run_dir
        self.trace_span = None  # the job's lifecycle span (tracing on only)
        self.state = QUEUED
        self.desired = spec.initial_desired()
        self.slice: Optional[tuple] = None
        self.supervisor: Optional[RestartSupervisor] = None
        self.thread: Optional[threading.Thread] = None
        self.exit_code: Optional[int] = None
        self.stopping = False
        # drain-escalation bookkeeping: the child we SIGTERMed + when to
        # give up on its drain
        self.drain_child: Optional[subprocess.Popen] = None
        self.drain_deadline: Optional[float] = None
        self.resizes = 0
        self.preempted_by: Optional[str] = None

    @property
    def world(self) -> int:
        if self.supervisor is not None and self.supervisor.world_size:
            return self.supervisor.world_size
        return 0

    def view(self) -> JobView:
        return JobView(
            name=self.spec.name,
            priority=self.spec.priority,
            arrival=self.arrival,
            min_world=self.spec.min_world,
            max_world=self.spec.max_world,
            desired=self.desired,
            running=self.state == RUNNING,
            current_world=self.world,
            kind=self.spec.kind,
        )


class FleetController:
    """Gang-schedule jobs over a ``pool_size``-device pool.

    ``max_jobs`` bounds the admission queue (running + queued);
    ``supervisor_policy`` is shared by every per-job supervisor (restart
    budget overridden per spec); ``autoscaler`` (optional) moves each
    running job's ``desired`` world from its scraped live metrics.
    ``env`` is the base environment every job inherits (specs layer their
    own on top). ``clock`` is injectable for deterministic tests."""

    def __init__(
        self,
        pool_size: int,
        fleet_dir: str,
        max_jobs: int = 16,
        supervisor_policy: Optional[SupervisorPolicy] = None,
        autoscaler=None,
        tuner=None,
        env: Optional[Dict[str, str]] = None,
        drain_grace: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        observability: Optional[dict] = None,
    ):
        """``observability``: the live-plane block (config shape); the
        controller consumes its ``tracing`` knobs — one job-lifecycle
        span per submitted job (start/resize/preempt/tune action children),
        exported as ``trace_fleet.json`` at shutdown — and, with
        ``exporter: true``, serves a fleet-level /metrics endpoint carrying
        the tuner's ``tpuddp_tune_*`` counters.

        ``tuner`` (optional, a :class:`tpuddp_torch.tune.online.FleetTuner`)
        closes the observe->advise->act loop: its decisions apply by
        mutating the job supervisor's ``$TPUDDP_TUNE_OVERLAY`` env and
        draining the child — the same exit-75 relaunch contract resizes
        ride, so a knob change is exactly as disruptive as a resize and
        never less safe."""
        if pool_size < 1:
            raise ValueError(f"pool_size must be >= 1, got {pool_size}")
        self.pool_size = int(pool_size)
        self.fleet_dir = fleet_dir
        self.max_jobs = int(max_jobs)
        self.supervisor_policy = supervisor_policy or SupervisorPolicy(
            backoff_base=0.5, backoff_cap=5.0
        )
        self.autoscaler = autoscaler
        self.tuner = tuner
        self.env = dict(env or {})
        self.drain_grace = drain_grace
        self.clock = clock
        self._lock = threading.RLock()
        self.jobs: Dict[str, ManagedJob] = {}
        self._arrivals = 0
        self.last_plan: Optional[Plan] = None
        from tpuddp_torch import config as cfg_lib
        from tpuddp_torch.observability import exporter as exp_lib

        obs_cfg = cfg_lib.resolve_observability(observability)
        self.tracer = trace_lib.tracer_from_config(
            obs_cfg, "fleet", run_dir=fleet_dir,
        )
        self.exporter = exp_lib.exporter_from_config(
            obs_cfg, run_dir=fleet_dir
        )
        if self.exporter is not None:
            self.exporter.start()
            if self.tuner is not None:
                self.exporter.register_source(
                    "tune", self.tuner.export_source
                )
        os.makedirs(os.path.join(fleet_dir, "jobs"), exist_ok=True)

    # -------------------------------------------------------------- admit --
    def submit(self, spec: JobSpec) -> ManagedJob:
        """Admit one job into the bounded queue; the next :meth:`step`
        places it (or leaves it queued behind higher-priority gangs)."""
        if spec.min_world > self.pool_size:
            raise FleetAdmissionError(
                "bad_spec",
                f"job {spec.name!r}: min_world {spec.min_world} exceeds the "
                f"pool ({self.pool_size} devices) — it can never gang-place",
            )
        with self._lock:
            if spec.name in self.jobs:
                raise FleetAdmissionError(
                    "duplicate_name", f"job {spec.name!r} already submitted"
                )
            active = sum(
                1 for j in self.jobs.values() if j.state not in TERMINAL
            )
            if active >= self.max_jobs:
                raise FleetAdmissionError(
                    "fleet_full",
                    f"{active} active jobs >= max_jobs {self.max_jobs}",
                )
            run_dir = os.path.join(self.fleet_dir, "jobs", spec.name)
            os.makedirs(run_dir, exist_ok=True)
            job = ManagedJob(spec, self._arrivals, run_dir)
            job.trace_span = self.tracer.start_span(
                f"job {spec.name}", trace_lib.KIND_JOB, tid="jobs",
                attrs={
                    "kind": spec.kind,
                    "priority": spec.priority,
                    "min_world": spec.min_world,
                    "max_world": spec.max_world,
                },
            )
            self._arrivals += 1
            self.jobs[spec.name] = job
            logger.info(
                "fleet: admitted %s (%s, prio %d, world %d-%d) -> %s",
                spec.name, spec.kind, spec.priority, spec.min_world,
                spec.max_world, run_dir,
            )
            return job

    # -------------------------------------------------------------- spawn --
    @staticmethod
    def _gang_world(spec: JobSpec, world: int) -> int:
        """Clamp a planned world to a (data, model)-factorable gang size.

        The planner and autoscaler reason in raw chip counts; a TP job can
        only gang-run at multiples of its model width (mesh_from refuses
        anything else). Floor to the nearest multiple — min_world is
        validated as a multiple at admission, so the floor never violates
        gang semantics."""
        m = spec.model_size or 1
        if m <= 1:
            return world
        return max((world // m) * m, spec.min_world)

    def _start(self, job: ManagedJob, world: int) -> None:
        spec = job.spec
        world = self._gang_world(spec, world)
        env = dict(self.env)
        env.update(spec.resolved_env(job.run_dir))
        policy = SupervisorPolicy(
            max_restarts=spec.max_restarts,
            backoff_base=self.supervisor_policy.backoff_base,
            backoff_cap=self.supervisor_policy.backoff_cap,
            jitter=self.supervisor_policy.jitter,
            shrink_after=self.supervisor_policy.shrink_after,
            shrink_factor=self.supervisor_policy.shrink_factor,
            min_world=spec.min_world,
        )
        job.supervisor = RestartSupervisor(
            spec.resolved_argv(job.run_dir),
            policy=policy,
            world_size=world,
            env=env,
            first_attempt_env=dict(spec.first_attempt_env),
            flight_dir=job.run_dir,
            world_env_var=(
                SERVING_WORLD_ENV if spec.kind == "serving" else WORLD_ENV
            ),
            # TP training jobs pin their model width ($TPUDDP_MODEL_SIZE) so
            # every relaunch factors the handed world as (data, model) and
            # the supervisor's capacity-loss shrink stays mesh-aware
            model_size=(
                spec.model_size
                if spec.kind == "training" and spec.model_size > 1
                else None
            ),
        )
        job.state = RUNNING
        self.tracer.end_span(self.tracer.start_span(
            "start", trace_lib.KIND_ACTION, parent=job.trace_span,
            attrs={"world": world},
        ))

        def _supervise():
            rc = job.supervisor.run()
            with self._lock:
                job.exit_code = rc
                job.state = (
                    PREEMPTED if job.stopping else (DONE if rc == 0 else FAILED)
                )
                self.tracer.end_span(
                    job.trace_span, state=job.state, exit_code=rc,
                    resizes=job.resizes,
                )
                logger.info(
                    "fleet: %s finished supervision: state=%s rc=%s",
                    spec.name, job.state, rc,
                )

        job.thread = threading.Thread(
            target=_supervise, name=f"fleet-{spec.name}", daemon=True
        )
        job.thread.start()

    # ------------------------------------------------------ drain machinery --
    def _signal_drain(self, job: ManagedJob) -> None:
        """SIGTERM the live child and arm the escalation deadline. If no
        child is live (supervisor mid-backoff) there is nothing to drain —
        the next attempt already picks up the new world / the stop flag."""
        sup = job.supervisor
        child = sup.child if sup is not None else None
        signaled = False
        if child is not None and child.poll() is None:
            # signal the SNAPSHOT, not sup.child re-read: if the old child
            # exits between the poll and the signal, the supervisor's
            # immediate exit-75 relaunch would make a re-read deliver this
            # SIGTERM to the NEW child — a pointless extra drain whose
            # escalation deadline would then track the wrong process
            try:
                child.send_signal(signal.SIGTERM)
                signaled = True
            except (ProcessLookupError, OSError):
                pass
        if signaled:
            grace = (
                self.drain_grace
                if self.drain_grace is not None
                else preemption_grace_seconds() + _ESCALATE_MARGIN_S
            )
            job.drain_child = child
            job.drain_deadline = self.clock() + grace
        else:
            job.drain_child = None
            job.drain_deadline = None

    def _escalate_expired_drains(self, now: float) -> None:
        for job in self.jobs.values():
            if job.drain_child is None:
                continue
            if job.drain_child.poll() is not None:
                job.drain_child = None
                job.drain_deadline = None
                continue
            if job.drain_deadline is not None and now >= job.drain_deadline:
                logger.critical(
                    "fleet: %s ignored SIGTERM past the grace window; "
                    "escalating to SIGKILL", job.spec.name,
                )
                try:
                    job.drain_child.kill()
                except (ProcessLookupError, OSError):
                    pass
                job.drain_child = None
                job.drain_deadline = None

    def _resize(self, job: ManagedJob, world: int) -> None:
        if job.supervisor is None:
            return
        world = self._gang_world(job.spec, world)
        if job.supervisor.world_size == world:
            return
        logger.warning(
            "fleet: resizing %s %s -> %d via the drain contract",
            job.spec.name, job.supervisor.world_size, world,
        )
        # retarget FIRST: if the child exits before our SIGTERM lands (or
        # is already draining), the relaunch still gets the new world
        self.tracer.end_span(self.tracer.start_span(
            "resize", trace_lib.KIND_ACTION, parent=job.trace_span,
            attrs={"from_world": job.supervisor.world_size, "to_world": world},
        ))
        job.supervisor.set_world(world)
        job.resizes += 1
        self._signal_drain(job)

    def _apply_tune(self, job: ManagedJob, decision: dict, now: float) -> None:
        """Commit one tuner decision: mutate the supervisor's
        ``$TPUDDP_TUNE_OVERLAY`` (consumed by ``_child_env`` at every
        attempt) and drain the child so the relaunch resolves its config
        THROUGH the overlay. ``keep`` endorses the live overlay in place —
        no env change, no drain. The tuner's own state machine advances in
        ``mark_applied`` (which also lands the ``tune_action`` history
        event), called only after the env mutation is really in."""
        from tpuddp_torch import config as cfg_lib

        sup = job.supervisor
        if sup is None:
            return
        action = decision["action"]
        self.tracer.end_span(self.tracer.start_span(
            f"tune_{action}", trace_lib.KIND_ACTION, parent=job.trace_span,
            attrs={
                "rule": decision.get("rule"),
                "generation": decision.get("generation"),
                "measured_delta_pct": decision.get("measured_delta_pct"),
            },
        ))
        if action in ("apply", "revert"):
            overlay_env = decision.get("overlay_env")
            if overlay_env is not None:
                sup.env[cfg_lib.TUNE_OVERLAY_ENV] = json.dumps(
                    overlay_env, sort_keys=True
                )
            else:
                # revert to the pristine config: no kept overlay remains
                sup.env.pop(cfg_lib.TUNE_OVERLAY_ENV, None)
            logger.warning(
                "fleet: tune %s on %s (rule %s, gen %s) via the drain "
                "contract", action, job.spec.name, decision.get("rule"),
                decision.get("generation"),
            )
            self._signal_drain(job)
        self.tuner.mark_applied(job.spec.name, job.run_dir, decision, now)

    def _preempt(self, job: ManagedJob, by: Optional[str] = None) -> None:
        if job.stopping or job.supervisor is None:
            return
        job.stopping = True
        job.preempted_by = by
        self.tracer.end_span(self.tracer.start_span(
            "preempt", trace_lib.KIND_ACTION, parent=job.trace_span,
            attrs={"by": by},
        ))
        logger.warning(
            "fleet: preempting %s%s — drain first, SIGKILL only after the "
            "grace window", job.spec.name, f" (displaced by {by})" if by else "",
        )
        # order matters: stop BEFORE the signal, or the supervisor can
        # relaunch between the child's exit and our flag
        job.supervisor.request_stop()
        if job.drain_child is not None and job.drain_child.poll() is None:
            # already draining (e.g. a resize in flight): a second SIGTERM
            # would be the "operator escalated" signal and force an
            # immediate exit mid-flush — let the running drain finish; the
            # stop flag keeps the supervisor from relaunching
            return
        self._signal_drain(job)

    def _held_devices(self) -> int:
        """Devices the pool is ACTUALLY holding right now: a draining child
        still occupies the world it was LAUNCHED at (``current_world``),
        regardless of where ``set_world`` has already retargeted the next
        attempt. New starts are gated on this sum so a drain window can
        never transiently oversubscribe the pool."""
        held = 0
        for job in self.jobs.values():
            if job.state in TERMINAL:
                continue
            sup = job.supervisor
            if sup is None:
                continue
            child = sup.child
            if child is not None and child.poll() is None:
                held += sup.current_world or 0
            elif job.state == RUNNING and not job.stopping:
                # between attempts (backoff / relaunch gap): the supervisor
                # is about to claim its target world again
                held += sup.world_size or 0
        return held

    # --------------------------------------------------------------- tick --
    def step(self, now: Optional[float] = None) -> Plan:
        """One control tick: reap finished supervisors, let the autoscaler
        move desires, re-plan, apply the diff, escalate expired drains."""
        now = self.clock() if now is None else now
        # autoscaler scrapes are blocking HTTP probes (healthz + /metrics,
        # seconds against a blackholed port) — run them OUTSIDE the lock so
        # supervisor completion threads, submit() and stop_job() never stall
        # behind a slow endpoint; proposals re-checked under the lock
        proposals: Dict[str, int] = {}
        if self.autoscaler is not None:
            with self._lock:
                targets = [
                    (j.spec.name, j.spec.kind, j.run_dir,
                     j.world or j.desired, j.spec.min_world, j.spec.max_world)
                    for j in self.jobs.values()
                    if j.state == RUNNING and not j.stopping
                ]
            for name, kind, run_dir, current, min_w, max_w in targets:
                proposal = self.autoscaler.observe_and_propose(
                    name, kind, run_dir,
                    current=current, min_world=min_w, max_world=max_w,
                    now=now,
                )
                if proposal is not None:
                    proposals[name] = proposal
        # tuner decisions read run-dir artifacts (history/trace files) —
        # same outside-the-lock rule as the autoscaler's scrapes; the
        # decisions are re-checked against job state before applying
        tune_decisions: List[tuple] = []
        if self.tuner is not None:
            with self._lock:
                tune_targets = [
                    (j.spec.name, j.spec.kind, j.run_dir)
                    for j in self.jobs.values()
                    if j.state == RUNNING and not j.stopping
                ]
            for name, kind, run_dir in tune_targets:
                decision = self.tuner.observe_and_decide(
                    name, kind, run_dir, now=now
                )
                if decision is not None:
                    tune_decisions.append((name, decision))
        with self._lock:
            # reap: threads that returned already set their final state
            for job in self.jobs.values():
                if (
                    job.state == RUNNING
                    and job.thread is not None
                    and not job.thread.is_alive()
                    and job.exit_code is None
                ):
                    job.state = FAILED  # defensive: thread died un-reported
            for name, desired in proposals.items():
                job = self.jobs.get(name)
                if job is not None and job.state == RUNNING and not job.stopping:
                    job.desired = desired
            views = [
                j.view() for j in self.jobs.values() if j.state not in TERMINAL
            ]
            plan = plan_fleet(self.pool_size, views) if views else Plan(
                self.pool_size, (), (), self.pool_size
            )
            self.last_plan = plan
            alloc = plan.alloc
            held = self._held_devices()
            for name, action in plan.actions:
                job = self.jobs[name]
                if job.stopping:
                    continue  # already on its way out; let the drain finish
                if action == "start":
                    # the plan's capacity math assumes resizes/preempts have
                    # LANDED; a draining child still holds its old world, so
                    # defer the gang until the pool can really seat it
                    if held + alloc[name] > self.pool_size:
                        logger.info(
                            "fleet: deferring start of %s (world %d): %d/%d "
                            "devices still held through a drain window",
                            name, alloc[name], held, self.pool_size,
                        )
                        continue
                    held += alloc[name]
                    job.slice = plan.slices[name]
                    self._start(job, alloc[name])
                elif action == "resize":
                    # shrinks always proceed (they free capacity); a GROW
                    # relaunches at the bigger world the moment its own
                    # drain lands, so gate it on the same held-device sum —
                    # a neighbor's unfinished shrink must complete first
                    delta = alloc[name] - (job.world or 0)
                    if delta > 0 and held + delta > self.pool_size:
                        logger.info(
                            "fleet: deferring grow of %s (+%d): %d/%d "
                            "devices still held through a drain window",
                            name, delta, held, self.pool_size,
                        )
                        continue
                    held += max(delta, 0)
                    job.slice = plan.slices[name]
                    self._resize(job, alloc[name])
                elif action == "preempt":
                    displacer = next(
                        (p.name for p in plan.placements
                         if self.jobs[p.name].state == QUEUED), None,
                    )
                    self._preempt(job, by=displacer)
                elif action == "keep":
                    job.slice = plan.slices[name]
            for name, decision in tune_decisions:
                job = self.jobs.get(name)
                if job is None or job.state != RUNNING or job.stopping:
                    continue  # the job left while we were deciding
                self._apply_tune(job, decision, now)
            self._escalate_expired_drains(now)
            return plan

    # ---------------------------------------------------------- lifecycle --
    def stop_job(self, name: str) -> None:
        with self._lock:
            job = self.jobs[name]
            if job.state == QUEUED:
                job.state = PREEMPTED
                job.stopping = True
                self.tracer.end_span(
                    job.trace_span, state=PREEMPTED, cancelled=True
                )
                return
            if job.state == RUNNING:
                self._preempt(job)

    def run_until(
        self,
        predicate: Callable[["FleetController"], bool],
        poll: float = 1.0,
        timeout: Optional[float] = None,
    ) -> bool:
        """Tick until ``predicate(self)`` holds; False on timeout."""
        deadline = None if timeout is None else self.clock() + timeout
        while True:
            self.step()
            if predicate(self):
                return True
            if deadline is not None and self.clock() >= deadline:
                return False
            time.sleep(poll)

    def training_complete(self) -> bool:
        with self._lock:
            return all(
                j.state in TERMINAL
                for j in self.jobs.values()
                if j.spec.kind == "training"
            )

    def shutdown(self, timeout: float = 120.0) -> None:
        """Drain every still-running job (preempt path: SIGTERM, grace,
        escalate) and join the supervisor threads. Queued jobs are cancelled
        too — the capacity the drains free must not gang-place NEW work in
        the step() calls below."""
        with self._lock:
            for job in self.jobs.values():
                if job.state == QUEUED:
                    job.state = PREEMPTED
                    job.stopping = True
                    self.tracer.end_span(
                        job.trace_span, state=PREEMPTED, cancelled=True
                    )
                elif job.state == RUNNING:
                    self._preempt(job)
        deadline = time.monotonic() + timeout
        alive = []
        while time.monotonic() < deadline:
            self.step()
            with self._lock:
                alive = [
                    j for j in self.jobs.values()
                    if j.thread is not None and j.thread.is_alive()
                ]
            if not alive:
                self._shutdown_telemetry()
                return
            time.sleep(0.2)
        for j in alive:  # last resort: the escalation path already SIGKILLed
            logger.error(
                "fleet: %s supervisor thread still alive at shutdown "
                "timeout", j.spec.name,
            )
        self._shutdown_telemetry()

    def _shutdown_telemetry(self) -> None:
        self.tracer.export()
        if self.exporter is not None:
            self.exporter.stop()

    def status(self) -> List[dict]:
        with self._lock:
            return [
                {
                    "name": j.spec.name,
                    "kind": j.spec.kind,
                    "priority": j.spec.priority,
                    "state": j.state,
                    "world": j.world,
                    "desired": j.desired,
                    "slice": j.slice,
                    "resizes": j.resizes,
                    "exit_code": j.exit_code,
                    "run_dir": j.run_dir,
                }
                for j in sorted(self.jobs.values(), key=lambda x: x.arrival)
            ]
