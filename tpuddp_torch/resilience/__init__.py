"""Resilience — the counterpart of ``tpuddp/resilience/``: the numerical
guard (:mod:`~tpuddp_torch.resilience.guard`: the non-finite firewall, the
skip counters, the desync auditor and its exit code) and
``$TPUDDP_FAULT`` injection (:mod:`~tpuddp_torch.resilience.faults`, its
``nan`` kind) and the retry with jittered backoff
(:mod:`~tpuddp_torch.resilience.retry`, the multi-host rendezvous's). The
preemption drain, the watchdog and the restart supervisor are not ported
(ROADMAP.md Queue 1 item 8)."""

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
