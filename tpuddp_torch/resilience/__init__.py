"""Resilience — the counterpart of ``tpuddp/resilience/``: the numerical
guard (:mod:`~tpuddp_torch.resilience.guard`: the non-finite firewall, the
skip counters, the desync auditor and its exit code), the SIGTERM/SIGINT
drain (:mod:`~tpuddp_torch.resilience.preemption`: the flag, the grace
failsafe, exit 75 and ``$TPUDDP_AUTO_RESUME``), ``$TPUDDP_FAULT``
injection (:mod:`~tpuddp_torch.resilience.faults`: ``crash``, ``preempt``,
``hang``, ``corrupt`` and ``nan``), the retry with jittered backoff
(:mod:`~tpuddp_torch.resilience.retry`, the multi-host rendezvous's), the
multi-host heartbeat and stale-peer watchdog
(:mod:`~tpuddp_torch.resilience.watchdog`, ``$TPUDDP_WATCHDOG_TIMEOUT``,
exit 76) and the restart supervisor
(:mod:`~tpuddp_torch.resilience.supervisor`: 75 resume now, 76/77/113
back off and resume, repeated 76 shrinks the world, which the elastic
restore of ``training/checkpoint.py`` then refits the checkpoint onto;
CLI ``python -m tpuddp_torch.supervise``)."""

from tpuddp_torch.resilience.guard import (  # noqa: F401
    DISABLED as GUARD_DISABLED,
    EXIT_DESYNC,
    Firewall,
    GuardConfig,
    ReplicaDesync,
    audit_or_raise,
    audit_params,
    resolve_guard,
)
from tpuddp_torch.resilience.preemption import (  # noqa: F401
    EXIT_INJECTED_CRASH,
    EXIT_PREEMPTED,
    EXIT_WATCHDOG,
    TrainingPreempted,
    auto_resume_requested,
    install_preemption_handler,
    preemption_deadline,
    preemption_grace_seconds,
    preemption_requested,
    request_preemption,
    reset_preemption,
    uninstall_preemption_handler,
)
from tpuddp_torch.resilience.faults import (  # noqa: F401
    FaultSpec,
    active_faults,
    is_hung,
    maybe_fire,
    parse_fault_specs,
    reload_faults,
)
from tpuddp_torch.resilience.supervisor import (  # noqa: F401
    RestartSupervisor,
    SupervisorPolicy,
    classify_exit,
    supervise,
)
from tpuddp_torch.resilience.watchdog import (  # noqa: F401
    Heartbeat,
    Watchdog,
    watchdog_timeout_seconds,
)
