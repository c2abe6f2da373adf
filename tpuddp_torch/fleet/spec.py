"""Declarative job specs: what the fleet controller admits and places —
the counterpart of ``tpuddp/fleet/spec.py``.

A :class:`JobSpec` is everything the controller needs to run one job under
its own :class:`~tpuddp_torch.resilience.supervisor.RestartSupervisor`: the argv,
the world-size range the job can gang-run at, a priority (higher preempts
lower), and the job kind — ``training`` jobs speak the exit-75 drain ->
``$TPUDDP_WORLD_SIZE`` elastic-resume contract, ``serving`` jobs the same
drain contract with ``$TPUDDP_SERVING_REPLICAS`` as their world knob
(``tpuddp_torch.config.serving_config`` honors it the way
``world_size_from`` honors the training override).

``argv`` and ``env`` values may carry a ``{run_dir}`` placeholder: the
controller substitutes each job's NAMESPACED run dir
(``<fleet_dir>/jobs/<name>``) so heartbeats, ``exporter.port``, checkpoints,
``history.jsonl`` and flight recordings of co-scheduled jobs can never
clobber each other — two jobs sharing one pool must never share a channel.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Sequence, Tuple

KINDS = ("training", "serving")

# job names become directory components (the run-dir namespace) and metric
# labels; keep them path- and label-safe
_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


class FleetAdmissionError(ValueError):
    """A job the queue refused, with a machine-readable ``reason``
    (``bad_spec`` / ``duplicate_name`` / ``fleet_full``) — the serving
    queue's AdmissionError shape, at the job granularity."""

    def __init__(self, reason: str, message: str):
        self.reason = reason
        super().__init__(message)


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One declarative fleet job.

    ``min_world``/``max_world`` bound the gang size: the planner never
    places the job below ``min_world`` (gang semantics — all or nothing)
    and never grows it past ``max_world``. ``priority`` breaks every tie:
    a higher-priority arrival preempts lower-priority capacity through the
    drain contract, never by losing work. ``first_attempt_env`` rides the
    supervisor's attempt-0-only env (chaos injection)."""

    name: str
    argv: Tuple[str, ...]
    kind: str = "training"
    priority: int = 0
    min_world: int = 1
    max_world: int = 1
    env: Dict[str, str] = dataclasses.field(default_factory=dict)
    first_attempt_env: Dict[str, str] = dataclasses.field(default_factory=dict)
    max_restarts: int = 8
    # tensor-parallel width (training jobs): every world the planner hands
    # this job must factor as (data, model) — min/max_world and resizes are
    # clamped to multiples of model_size; exported as $TPUDDP_MODEL_SIZE
    model_size: int = 1

    def __post_init__(self):
        object.__setattr__(self, "argv", tuple(str(a) for a in self.argv))
        for k in ("env", "first_attempt_env"):
            v = getattr(self, k)
            if v is None:  # a YAML `env:` with no value parses to None
                object.__setattr__(self, k, {})
            elif not isinstance(v, dict):
                raise FleetAdmissionError(
                    "bad_spec", f"job {self.name!r}: {k} must be a mapping"
                )
        if not _NAME_RE.match(self.name):
            raise FleetAdmissionError(
                "bad_spec",
                f"job name {self.name!r} must match {_NAME_RE.pattern} "
                "(it becomes the run-dir namespace component)",
            )
        if self.kind not in KINDS:
            raise FleetAdmissionError(
                "bad_spec", f"job kind {self.kind!r} not in {KINDS}"
            )
        if not self.argv:
            raise FleetAdmissionError("bad_spec", f"job {self.name!r}: empty argv")
        if self.min_world < 1:
            raise FleetAdmissionError(
                "bad_spec",
                f"job {self.name!r}: min_world must be >= 1, got {self.min_world}",
            )
        if self.max_world < self.min_world:
            raise FleetAdmissionError(
                "bad_spec",
                f"job {self.name!r}: max_world {self.max_world} < "
                f"min_world {self.min_world}",
            )
        if self.max_restarts < 0:
            raise FleetAdmissionError(
                "bad_spec",
                f"job {self.name!r}: max_restarts must be >= 0",
            )
        if self.model_size < 1:
            raise FleetAdmissionError(
                "bad_spec",
                f"job {self.name!r}: model_size must be >= 1, got "
                f"{self.model_size}",
            )
        if self.model_size > 1:
            if self.kind != "training":
                raise FleetAdmissionError(
                    "bad_spec",
                    f"job {self.name!r}: model_size applies to training "
                    f"jobs only (got kind {self.kind!r})",
                )
            # gang worlds must factor as (data, model): a world that is not
            # a multiple of model_size has no mesh, so refuse it at
            # admission instead of at the child's mesh_from
            for field in ("min_world", "max_world"):
                w = getattr(self, field)
                if w % self.model_size:
                    raise FleetAdmissionError(
                        "bad_spec",
                        f"job {self.name!r}: {field} {w} is not a multiple "
                        f"of model_size {self.model_size} — no (data, "
                        f"model) mesh exists at that world",
                    )

    # ------------------------------------------------------- substitution --
    def resolved_argv(self, run_dir: str) -> list:
        return [a.replace("{run_dir}", run_dir) for a in self.argv]

    def resolved_env(self, run_dir: str) -> Dict[str, str]:
        return {
            k: str(v).replace("{run_dir}", run_dir) for k, v in self.env.items()
        }

    # the world the controller starts a job at before the autoscaler has an
    # opinion: training jobs soak whatever capacity the planner can spare
    # (elastic — they shrink when neighbors arrive); serving jobs start at
    # min and earn replicas from measured SLO pressure, not from idle pool
    def initial_desired(self) -> int:
        return self.max_world if self.kind == "training" else self.min_world


def spec_from_dict(obj: dict) -> JobSpec:
    """Build a JobSpec from a parsed fleet-file entry (``python -m tpuddp_torch.fleet run``),
    refusing unknown keys the way the config blocks do."""
    if not isinstance(obj, dict):
        raise FleetAdmissionError("bad_spec", f"job entry must be a mapping, got {obj!r}")
    known = {f.name for f in dataclasses.fields(JobSpec)}
    unknown = set(obj) - known
    if unknown:
        raise FleetAdmissionError(
            "bad_spec",
            f"unknown job key(s) {sorted(unknown)}; known: {sorted(known)}",
        )
    kw = dict(obj)
    argv = kw.pop("argv", None)
    if not isinstance(argv, Sequence) or isinstance(argv, str):
        raise FleetAdmissionError(
            "bad_spec", f"job {kw.get('name')!r}: argv must be a list"
        )
    return JobSpec(argv=tuple(argv), **kw)
