"""Fleet control plane — gang-schedule many jobs over one device pool; the
counterpart of ``tpuddp/fleet/``.

- :mod:`tpuddp_torch.fleet.spec`       — declarative job specs + admission
  rules;
- :mod:`tpuddp_torch.fleet.scheduler`  — the pure, deterministic
  gang-placement / priority-preemption / rebalance planner (no processes,
  unit-testable);
- :mod:`tpuddp_torch.fleet.controller` — the live controller: per-job
  ``RestartSupervisor`` under a namespaced run dir, drain-first preemption
  with grace-window SIGKILL escalation, elastic resizes through the exit-75
  -> ``$TPUDDP_WORLD_SIZE`` resume contract;
- :mod:`tpuddp_torch.fleet.autoscale`  — the metric-driven autoscaler:
  scrapes each job's live ``/metrics`` endpoint (port discovered via the
  namespaced ``exporter.port`` file, liveness-verified through
  ``/healthz``) and moves the planner's per-job desired worlds with
  hysteresis + cooldown.

``python -m tpuddp_torch.fleet`` is the CLI (``run --spec``,
``chaos-demo --out``). The package is host Python: it starts the port's
entry points as child processes and launches no kernel itself.
"""

from tpuddp_torch.fleet.autoscale import Autoscaler, AutoscalePolicy  # noqa: F401
from tpuddp_torch.fleet.controller import FleetController  # noqa: F401
from tpuddp_torch.fleet.scheduler import JobView, Plan, plan_fleet  # noqa: F401
from tpuddp_torch.fleet.spec import FleetAdmissionError, JobSpec  # noqa: F401
