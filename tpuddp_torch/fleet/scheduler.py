"""Gang-placement + rebalance planner — pure, deterministic, process-free;
the counterpart of ``tpuddp/fleet/scheduler.py``, decision for decision.

The controller's every placement decision routes through :func:`plan_fleet`:
given (pool size, the current job views) it returns the complete target
allocation, the disjoint device slices, and the action diff against what is
currently running. No wall clock, no randomness, no I/O — the acceptance
criterion is that the planner is unit-testable apart from any process tree,
and that the same inputs always produce the same plan (input order
included: jobs are ordered by ``(-priority, arrival, name)`` before any
capacity is handed out, so a dict-ordering change upstream can never move
a job).

Policy, in order:

1. **Admission (gang, all-or-nothing).** Walk jobs by priority; admit each
   whose ``min_world`` still fits the remaining pool. A job that does not
   fit is skipped (it stays queued — or, if running, is *preempted*: a
   higher-priority arrival consumed the capacity its gang needs). Lower-
   priority jobs behind a skipped large job may still backfill.
2. **Growth.** In the same order, grow each admitted job toward
   ``clamp(desired, min_world, max_world)`` from whatever pool remains.
   ``desired`` is the autoscaler's lever (serving replicas under SLO
   pressure, straggler-convicted training shrink); it can never push a job
   outside its spec bounds.
3. **Slices.** Placements pack the pool left-to-right in the same order —
   disjoint ``[offset, offset + world)`` ranges by construction.

The action diff compares target allocation to each view's
``running``/``current_world``: ``start`` (queued -> placed), ``resize``
(placed at a different world — the controller drains through exit 75 and
the supervisor resumes at the new world), ``preempt`` (running -> not
placed), ``keep``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class JobView:
    """The planner's entire knowledge of one job — a pure value."""

    name: str
    priority: int = 0
    arrival: int = 0
    min_world: int = 1
    max_world: int = 1
    desired: Optional[int] = None  # None -> max_world
    running: bool = False
    current_world: int = 0
    kind: str = "training"


@dataclasses.dataclass(frozen=True)
class Placement:
    name: str
    world: int
    offset: int  # device slice = [offset, offset + world)


@dataclasses.dataclass(frozen=True)
class Plan:
    pool_size: int
    placements: Tuple[Placement, ...]
    # action per job name: "start" | "resize" | "preempt" | "keep" | "queued"
    actions: Tuple[Tuple[str, str], ...]
    free: int

    @property
    def alloc(self) -> Dict[str, int]:
        return {p.name: p.world for p in self.placements}

    @property
    def slices(self) -> Dict[str, Tuple[int, int]]:
        return {p.name: (p.offset, p.offset + p.world) for p in self.placements}

    def action(self, name: str) -> Optional[str]:
        for n, a in self.actions:
            if n == name:
                return a
        return None


def _order(jobs: Sequence[JobView]) -> list:
    return sorted(jobs, key=lambda j: (-j.priority, j.arrival, j.name))


def plan_fleet(pool_size: int, jobs: Sequence[JobView]) -> Plan:
    if pool_size < 1:
        raise ValueError(f"pool_size must be >= 1, got {pool_size}")
    names = [j.name for j in jobs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate job names in plan input: {sorted(names)}")
    order = _order(jobs)

    # 1. gang admission by priority, all-or-nothing at min_world
    remaining = pool_size
    alloc: Dict[str, int] = {}
    for j in order:
        if j.min_world <= remaining:
            alloc[j.name] = j.min_world
            remaining -= j.min_world

    # 2. growth toward clamp(desired) in the same order
    for j in order:
        if j.name not in alloc or remaining == 0:
            continue
        desired = j.max_world if j.desired is None else j.desired
        want = max(j.min_world, min(j.max_world, desired))
        extra = min(want - alloc[j.name], remaining)
        if extra > 0:
            alloc[j.name] += extra
            remaining -= extra

    # 3. disjoint slices, packed in priority order
    placements = []
    offset = 0
    for j in order:
        if j.name in alloc:
            placements.append(Placement(j.name, alloc[j.name], offset))
            offset += alloc[j.name]

    actions = []
    for j in order:
        target = alloc.get(j.name)
        if target is None:
            actions.append((j.name, "preempt" if j.running else "queued"))
        elif not j.running:
            actions.append((j.name, "start"))
        elif target != j.current_world:
            actions.append((j.name, "resize"))
        else:
            actions.append((j.name, "keep"))
    return Plan(
        pool_size=pool_size,
        placements=tuple(placements),
        actions=tuple(actions),
        free=remaining,
    )
