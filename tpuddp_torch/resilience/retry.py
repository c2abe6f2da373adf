"""Retry with jittered exponential backoff — the counterpart of
``tpuddp/resilience/retry.py``.

The multi-host rendezvous (:func:`tpuddp_torch.parallel.backend.setup`)
wraps its connection to the coordinator in :func:`retry`: hosts race to come
up and the coordinator may not be listening yet. The jitter decorrelates the
retries of hosts that all saw the same transient failure.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import time
from typing import Callable, Optional

logger = logging.getLogger("tpuddp")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """``delay(attempt) = min(max_delay, base_delay * 2**(attempt-1))``, then
    multiplied by ``uniform(1 - jitter, 1 + jitter)``."""

    max_attempts: int = 3
    base_delay: float = 0.5
    max_delay: float = 30.0
    jitter: float = 0.5  # fraction of the delay, in [0, 1]

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if not (0.0 <= self.jitter <= 1.0):
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")

    def delay(self, attempt: int, rng: Optional[random.Random] = None) -> float:
        base = min(self.max_delay, self.base_delay * (2.0 ** (attempt - 1)))
        r = rng.uniform if rng is not None else random.uniform
        return base * r(1.0 - self.jitter, 1.0 + self.jitter)


class RetryError(RuntimeError):
    """All attempts exhausted. ``__cause__`` is the final attempt's
    exception; the message names the operation and the attempt count."""


def retry(
    fn: Callable,
    policy: Optional[RetryPolicy] = None,
    *,
    describe: str = "operation",
    sleep: Callable[[float], None] = time.sleep,
):
    """Call ``fn()`` up to ``policy.max_attempts`` times. Every ``Exception``
    counts as transient; KeyboardInterrupt and SystemExit propagate at once.
    Exhaustion raises :class:`RetryError` chaining the last failure."""
    policy = policy or RetryPolicy()
    last: Optional[BaseException] = None
    for attempt in range(1, policy.max_attempts + 1):
        try:
            return fn()
        except Exception as e:
            last = e
            if attempt == policy.max_attempts:
                break
            d = policy.delay(attempt)
            logger.warning("%s failed (attempt %d/%d): %s — retrying in %.1fs",
                           describe, attempt, policy.max_attempts, e, d)
            sleep(d)
    raise RetryError(f"{describe} failed after {policy.max_attempts} attempt(s): {last}") from last
