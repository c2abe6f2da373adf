"""Resilience — the counterpart of ``tpuddp/resilience/``: the numerical
guard (:mod:`~tpuddp_torch.resilience.guard`: the non-finite firewall, the
skip counters, the desync auditor and its exit code), the SIGTERM/SIGINT
drain (:mod:`~tpuddp_torch.resilience.preemption`: the flag, the grace
failsafe, exit 75 and ``$TPUDDP_AUTO_RESUME``), ``$TPUDDP_FAULT``
injection (:mod:`~tpuddp_torch.resilience.faults`, its ``nan`` and
``preempt`` kinds) and the retry with jittered backoff
(:mod:`~tpuddp_torch.resilience.retry`, the multi-host rendezvous's). The
watchdog and the restart supervisor are not ported (ROADMAP.md Queue 1
item 8)."""

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
