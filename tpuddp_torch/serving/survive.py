"""Serving survivability — the counterpart of ``tpuddp/serving/survive.py``:
probation, retry budgets, deadlines, typed failure.

The serving plane's original failure story was terminal: an unhealthy
replica was removed forever, every in-flight decode stream riding it died,
and overload had no deadline semantics at all. This module holds the shared
policy pieces the two engines (request-granularity ``serving/engine.py``,
token-level ``serving/decode/engine.py``) thread through their dispatch
loops to invert that:

- **Probation & recovery** (:func:`run_probation`): an unhealthy replica is
  not removed — it enters a bounded recovery loop (rebuild its device state,
  re-warm, probe with a canary dispatch) with the jittered exponential
  backoff of ``resilience/retry.py``, and rejoins routing only after the
  canary passes. Permanent removal is the *fallback* (``max_recoveries``
  lifetime episodes exhausted, or every in-episode attempt failed), not the
  policy. The replica state machine is::

      healthy --incident--> recovering --canary ok--> healthy   (rejoin)
                                |
                                +--attempts/max_recoveries exhausted--> removed

- **Retry budgets** (:class:`RetryBudget`): a transient dispatch failure
  costs the affected tenant one retry token and re-enters the queue instead
  of surfacing to the client; a retried request that finally succeeds
  refunds its tokens, so only *sustained* failure exhausts the budget and
  fails through.

- **Deadlines** (:func:`admission_deadline`): every request can carry an
  absolute deadline — the minimum of an admission-time TTL
  (``request_ttl_s``) and an optional per-call client deadline. Expired
  work still *queued* is shed with a machine-readable ``deadline_exceeded``
  rejection before it wastes device time; work already in flight is NEVER
  killed by its deadline (a stream that started is finished).

- **Typed terminal failure** (:class:`NoHealthyReplicaError`): when the
  last replica's recovery is exhausted, queued and parked work fails with
  ``reason == "no_healthy_replica"`` — machine-readable, and never a hang.

Everything here is host-side policy: no tensors, no devices — the engines
own the device-facing rebuild/canary callables.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
from typing import Callable, Dict, Optional, Tuple

from tpuddp_torch.resilience.retry import RetryError, RetryPolicy, retry

logger = logging.getLogger("tpuddp")

# The machine-readable reason carried by NoHealthyReplicaError and the
# typed event row the engines land when the pool dies.
REASON_NO_HEALTHY_REPLICA = "no_healthy_replica"

# Replica survivability states (Replica.state / DecodeReplica.state).
STATE_HEALTHY = "healthy"
STATE_RECOVERING = "recovering"
STATE_REMOVED = "removed"


class NoHealthyReplicaError(RuntimeError):
    """Terminal serving failure: every replica is removed and at least one
    recovery round was attempted. ``reason`` is machine-readable (clients
    and tests dispatch on it, not the message)."""

    reason = REASON_NO_HEALTHY_REPLICA

    def __init__(self, detail: str):
        super().__init__(f"request failed ({self.reason}): {detail}")


@dataclasses.dataclass(frozen=True)
class SurvivePolicy:
    """The survivability knob block (config keys of the ``serving`` /
    ``serving.decode`` blocks; see README "Serving survivability").

    ``request_ttl_s``: admission-time TTL applied to every request (None =
    no TTL; clients can still pass a per-call deadline).
    ``max_recoveries``: lifetime probation episodes per replica; past it an
    incident removes the replica permanently (0 = legacy remove-on-first).
    ``recovery_attempts``: rebuild+canary tries within one episode.
    ``recovery_backoff_s``: base of the jittered exponential backoff
    between in-episode tries (resilience/retry.py semantics).
    ``retry_budget``: per-tenant transient-dispatch retry tokens for the
    request-granularity engine (0 = off; the decode engine's failover
    journal makes per-request retries redundant there).
    ``max_failovers``: per-SESSION failover episodes (decode): a sequence
    that has already been parked this many times is failed with the
    dispatch error instead of re-parked. This is the poisoned-request
    firewall — a request whose OWN content deterministically kills any
    dispatch must not ride its journal around the pool burning every
    replica's probation budget (0 = never re-park: legacy stream-dies
    behavior)."""

    request_ttl_s: Optional[float] = None
    max_recoveries: int = 2
    recovery_attempts: int = 2
    recovery_backoff_s: float = 0.1
    retry_budget: int = 0
    max_failovers: int = 1

    def __post_init__(self):
        if self.request_ttl_s is not None and self.request_ttl_s <= 0:
            raise ValueError(
                f"request_ttl_s must be > 0 or None, got {self.request_ttl_s}"
            )
        if self.max_recoveries < 0:
            raise ValueError(
                f"max_recoveries must be >= 0, got {self.max_recoveries}"
            )
        if self.recovery_attempts < 1:
            raise ValueError(
                f"recovery_attempts must be >= 1, got {self.recovery_attempts}"
            )
        if self.recovery_backoff_s < 0:
            raise ValueError(
                f"recovery_backoff_s must be >= 0, got {self.recovery_backoff_s}"
            )
        if self.retry_budget < 0:
            raise ValueError(
                f"retry_budget must be >= 0, got {self.retry_budget}"
            )
        if self.max_failovers < 0:
            raise ValueError(
                f"max_failovers must be >= 0, got {self.max_failovers}"
            )

    @classmethod
    def from_config(cls, cfg: dict) -> "SurvivePolicy":
        """Pull the survivability keys out of a resolved ``serving`` /
        ``serving.decode`` block (missing keys take the defaults, so stale
        config dicts built before this layer keep working)."""
        ttl = cfg.get("request_ttl_s")
        return cls(
            request_ttl_s=None if ttl is None else float(ttl),
            max_recoveries=int(cfg.get("max_recoveries", 2)),
            recovery_attempts=int(cfg.get("recovery_attempts", 2)),
            recovery_backoff_s=float(cfg.get("recovery_backoff_s", 0.1)),
            retry_budget=int(cfg.get("retry_budget") or 0),
            max_failovers=int(cfg.get("max_failovers", 1)),
        )

    def meta(self) -> dict:
        """The run_meta ``survivability`` provenance block (schema v7)."""
        return dataclasses.asdict(self)


def admission_deadline(
    t_enqueue: float,
    ttl_s: Optional[float],
    deadline_s: Optional[float],
) -> Optional[float]:
    """Absolute deadline (perf_counter seconds) for a request admitted at
    ``t_enqueue``: the tighter of the engine TTL and the client's own
    deadline, or None when neither applies."""
    bounds = [b for b in (ttl_s, deadline_s) if b is not None]
    if not bounds:
        return None
    if min(bounds) < 0:
        raise ValueError(f"deadline must be >= 0, got {min(bounds)}")
    return t_enqueue + min(bounds)


class RetryBudget:
    """Per-tenant transient-dispatch retry tokens.

    ``try_consume`` takes one token (False when the tenant is exhausted —
    the caller fails the request through instead of retrying);
    ``refund`` returns tokens when a retried request LEAVES the system —
    success or failure-through alike — so the budget bounds how many
    retries any one request may consume, never how many the tenant gets
    for the engine's lifetime (a request that burned its retries and
    failed must not disable retries for the tenant's next, unrelated
    request hours later). ``limit <= 0`` disables retries entirely."""

    def __init__(self, limit: int):
        self.limit = int(limit)
        self._lock = threading.Lock()
        self._used: Dict[str, int] = {}

    def try_consume(self, tenant: str) -> bool:
        if self.limit <= 0:
            return False
        with self._lock:
            used = self._used.get(tenant, 0)
            if used >= self.limit:
                return False
            self._used[tenant] = used + 1
            return True

    def refund(self, tenant: str, n: int = 1) -> None:
        with self._lock:
            used = self._used.get(tenant, 0)
            self._used[tenant] = max(0, used - int(n))

    def used(self, tenant: str) -> int:
        with self._lock:
            return self._used.get(tenant, 0)


def run_probation(
    *,
    name: str,
    recover: Callable[[], None],
    policy: SurvivePolicy,
    sleep=None,
) -> bool:
    """One probation episode: call ``recover()`` (rebuild + canary; raises
    on failure) up to ``policy.recovery_attempts`` times with jittered
    exponential backoff. True = the replica passed probation and may rejoin
    routing; False = the episode is exhausted (the caller decides between
    another episode and permanent removal via ``max_recoveries``)."""
    retry_policy = RetryPolicy(
        max_attempts=policy.recovery_attempts,
        base_delay=policy.recovery_backoff_s,
        max_delay=max(policy.recovery_backoff_s, 5.0),
        jitter=0.5,
    )
    kwargs = {} if sleep is None else {"sleep": sleep}
    try:
        retry(
            recover,
            retry_policy,
            describe=f"{name} probation (rebuild + canary)",
            **kwargs,
        )
        return True
    except RetryError as e:
        logger.critical("%s failed probation: %s", name, e)
        return False


def probation_episode(
    replica,
    *,
    name: str,
    recover: Callable[[], None],
    policy: SurvivePolicy,
    count_recovery: bool = True,
    lock=None,
) -> Tuple[bool, dict]:
    """The whole incident->probation outcome both engines share: check the
    lifetime budget, run one :func:`run_probation` episode, transition
    ``replica.state`` (under ``lock`` when given), and return
    ``(rejoined, event)`` — the typed ``replica_recovered`` /
    ``replica_removed`` record for the caller's history writer.

    ``replica`` is any object with ``index`` / ``state`` / ``recoveries``.
    ``count_recovery=False`` passes probation WITHOUT charging the
    replica's lifetime ``max_recoveries`` budget — the request-attributed
    incident case, where a passed canary proves the device was never the
    problem (the request's own failover budget bounds the culprit)."""
    allowed = replica.recoveries < policy.max_recoveries
    ok = allowed and run_probation(name=name, recover=recover, policy=policy)
    ctx = lock if lock is not None else contextlib.nullcontext()
    if ok:
        if count_recovery:
            replica.recoveries += 1
        with ctx:
            replica.state = STATE_HEALTHY
        logger.warning(
            "%s passed probation (recovery %d/%d); rejoining routing",
            name, replica.recoveries, policy.max_recoveries,
        )
        return True, {
            "event": "replica_recovered",
            "replica": replica.index,
            "recoveries": replica.recoveries,
        }
    with ctx:
        replica.state = STATE_REMOVED
    return False, {
        "event": "replica_removed",
        "replica": replica.index,
        "recoveries": replica.recoveries,
        "reason": "probation_failed" if allowed else "max_recoveries",
    }


def live_survivors(replicas, me) -> bool:
    """True when any OTHER replica can still own traffic: not removed AND
    its loop thread is running (``loop_alive``) — at drain, peers exit
    once the queue looks drained, and handing journals or retried work to
    an exited loop strands the futures forever. Callers hold their own
    health lock."""
    return any(
        r.state != STATE_REMOVED and getattr(r, "loop_alive", False)
        for r in replicas
        if r is not me
    )
