"""The restart supervisor: the interpreter of the exit-code contract — the
counterpart of ``tpuddp/resilience/supervisor.py``.

The resilience layer speaks in exit codes (:mod:`~tpuddp_torch.resilience.
preemption`): 75 drained after a preemption, 76 a peer's heartbeat went
stale, 77 a replica diverged, 113 an injected crash. :class:`RestartSupervisor`
runs the training command as a child process, reads the code it exits with
and restarts it:

- ``0``: done; the supervisor exits 0.
- ``75``: the drain wrote its checkpoint, so resume at once
  (``$TPUDDP_AUTO_RESUME=1``, no backoff).
- ``76``, ``77`` and any other non-zero code: restart after a jittered
  exponential backoff (the retry's delay shape: N supervisors must not
  stampede one rendezvous) and auto-resume from the newest intact
  checkpoint.
- a negative code, a child killed by a signal (an OOM SIGKILL, a node's
  reclaim): a backoff restart whose log line names the signal
  (:func:`classify_exit`); it breaks a streak of 76s, so a killed child
  never shrinks the world.
- ``76`` again and again (``shrink_after`` in a row): the job lost
  capacity for good, so the world shrinks by ``shrink_factor``
  (``$TPUDDP_WORLD_SIZE``, which both entry points read) and the run
  resumes through the elastic restore (:mod:`tpuddp_torch.training.
  checkpoint` refits the checkpoint onto the smaller world).

``model_size`` pins the child's tensor-parallel width (``$TPUDDP_MODEL_SIZE``)
and makes the shrink mesh-aware, data axis first (:meth:`RestartSupervisor.
_shrunk_mesh`), as the JAX supervisor's; the native entry point's child
derives ``data = world / model`` from it and reshapes the checkpoint onto
the new ``(data, model)`` shape under ``training.reshard_on_mismatch``
(``training/reshard.py``). Every restart counts against
``max_restarts``; once it is spent the supervisor returns the child's last
code, so the scheduler around it still sees the truth.

``runner`` is injectable (tests drive the policy with a fake child);
``first_attempt_env`` applies to attempt 0 only and is stripped from every
restart, so a fault injected there (``$TPUDDP_FAULT``) cannot fire again in
the resumed child. ``flight_dir`` (usually the run's ``out_dir``) is where
the child's flight recorder dumps ``flightrec_<reason>.json``: after every
abnormal exit, and once before the first attempt, the supervisor logs a
summary of each recording it has not logged yet (:meth:`RestartSupervisor.
summarize_flight`), before it decides the restart.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import random
import signal as signal_lib
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from tpuddp_torch.resilience.preemption import (
    AUTO_RESUME_ENV,
    EXIT_DESYNC,
    EXIT_PREEMPTED,
    EXIT_WATCHDOG,
)

logger = logging.getLogger("tpuddp")

WORLD_ENV = "TPUDDP_WORLD_SIZE"
MODEL_ENV = "TPUDDP_MODEL_SIZE"
_SPAWNED_ENV = "TPUDDP_SPAWNED"


def classify_exit(rc: int) -> str:
    """A label for a child's exit code: a signal's name for a negative code
    (``killed by SIGKILL``), else what the contract says it is."""
    if rc < 0:
        try:
            name = signal_lib.Signals(-rc).name
        except ValueError:
            name = f"signal {-rc}"
        return f"killed by {name}"
    return {
        EXIT_PREEMPTED: "preemption drain",
        EXIT_WATCHDOG: "stale peer",
        EXIT_DESYNC: "replica desync",
    }.get(rc, "crash")


@dataclasses.dataclass(frozen=True)
class SupervisorPolicy:
    """The restart policy (``python -m tpuddp_torch.supervise`` takes each as
    a flag). ``shrink_after`` consecutive watchdog exits (76) shrink the
    world by ``shrink_factor``, never below ``min_world``; past that, peer
    deaths are plain bounded restarts. ``backoff_base``, ``backoff_cap``
    and ``jitter`` shape the delay as the retry's."""

    max_restarts: int = 8
    backoff_base: float = 1.0
    backoff_cap: float = 60.0
    jitter: float = 0.5
    shrink_after: int = 2
    shrink_factor: int = 2
    min_world: int = 1

    def __post_init__(self):
        if self.max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got {self.max_restarts}")
        if self.shrink_factor < 2:
            raise ValueError(f"shrink_factor must be >= 2, got {self.shrink_factor}")
        if not (0.0 <= self.jitter <= 1.0):
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")

    def delay(self, consecutive_failures: int, rng: random.Random) -> float:
        base = min(self.backoff_cap,
                   self.backoff_base * (2.0 ** max(0, consecutive_failures - 1)))
        return base * rng.uniform(1.0 - self.jitter, 1.0 + self.jitter)


class RestartSupervisor:
    """Supervise one training command through the exit-code contract.

    ``world_size`` None leaves the child's world to the child (no shrink:
    the supervisor cannot shrink a world it does not set); an int pins
    ``$TPUDDP_WORLD_SIZE`` (``world_env_var``) and arms the shrink.
    ``model_size`` pins ``$TPUDDP_MODEL_SIZE`` on every attempt."""

    def __init__(
        self,
        argv: Sequence[str],
        policy: Optional[SupervisorPolicy] = None,
        world_size: Optional[int] = None,
        env: Optional[Dict[str, str]] = None,
        first_attempt_env: Optional[Dict[str, str]] = None,
        auto_resume_first: bool = False,
        runner: Optional[Callable[[Sequence[str], Dict[str, str]], int]] = None,
        sleep: Callable[[float], None] = time.sleep,
        rng: Optional[random.Random] = None,
        flight_dir: Optional[str] = None,
        world_env_var: str = WORLD_ENV,
        model_size: Optional[int] = None,
    ):
        self.argv = list(argv)
        self.policy = policy or SupervisorPolicy()
        self.world_size = int(world_size) if world_size else None
        self.model_size = int(model_size) if model_size else None
        if self.model_size and self.world_size and self.world_size % self.model_size:
            raise ValueError(
                f"world_size {self.world_size} is not a multiple of "
                f"model_size {self.model_size}: no (data, model) mesh exists"
            )
        self.env = dict(env or {})
        self.first_attempt_env = dict(first_attempt_env or {})
        self.auto_resume_first = bool(auto_resume_first)
        self.runner = runner or self._popen_runner
        self.sleep = sleep
        self._rng = rng or random.Random()
        self.world_env_var = world_env_var
        self.flight_dir = flight_dir
        self._summarized: set = set()  # (path, mtime) of the recordings logged
        # (attempt, exit code, world) per child run: the supervisor's trail
        self.history: List[Tuple[int, int, Optional[int]]] = []
        # the live child (the default runner's), which a controller may signal
        self.child: Optional[subprocess.Popen] = None
        self._current_world: Optional[int] = None
        self._stop = threading.Event()

    # ---------------------------------------------------------- the child --
    def _popen_runner(self, argv: Sequence[str], env: Dict[str, str]) -> int:
        """Run the child, keeping it on ``self.child`` for
        :meth:`signal_child`; an exception while waiting (a KeyboardInterrupt)
        kills the child before it propagates, so no trainer is orphaned."""
        proc = subprocess.Popen(list(argv), env=env)
        self.child = proc
        try:
            return proc.wait()
        except BaseException:
            try:
                proc.kill()
            except OSError:
                pass
            proc.wait()
            raise
        finally:
            self.child = None

    @property
    def current_world(self) -> Optional[int]:
        """The world the live (or last) child was launched at, which
        :meth:`set_world` may already have retargeted for the next."""
        return self._current_world

    def set_world(self, world_size: Optional[int]) -> None:
        """Retarget the NEXT attempt's world; SIGTERM the child after it and
        the drain's 75 relaunches it at once at that world."""
        self.world_size = int(world_size) if world_size else None

    def request_stop(self) -> None:
        """Stop supervising once the current child exits (set it before
        signalling the child, or the supervisor may relaunch it)."""
        self._stop.set()

    @property
    def stop_requested(self) -> bool:
        return self._stop.is_set()

    def signal_child(self, sig: int) -> bool:
        """Send ``sig`` to the live child; False when none runs."""
        child = self.child
        if child is None or child.poll() is not None:
            return False
        try:
            child.send_signal(sig)
            return True
        except (ProcessLookupError, OSError):
            return False

    def _child_env(self, attempt: int, world: Optional[int] = None) -> Dict[str, str]:
        env = dict(os.environ)
        env.update(self.env)
        env.pop(_SPAWNED_ENV, None)  # the child re-derives its launch for its world
        if attempt == 0:
            env.update(self.first_attempt_env)
            if self.auto_resume_first:
                env[AUTO_RESUME_ENV] = "1"
        else:
            # a restart always resumes, and never re-fires the first attempt's fault
            for k in self.first_attempt_env:
                env.pop(k, None)
            env[AUTO_RESUME_ENV] = "1"
        world = self.world_size if world is None else world
        if world:
            env[self.world_env_var] = str(world)
        if self.model_size:
            env[MODEL_ENV] = str(self.model_size)
        return env

    # ------------------------------------------------------------ shrink --
    def _shrunk_mesh(self) -> Optional[tuple]:
        """The next smaller ``(world, model)`` after a lasting loss of
        capacity, or None: the data axis shrinks first; only at data 1 does
        the model axis, when ``shrink_factor`` divides it; ``min_world``
        floors the chips either way (``model`` None: unchanged)."""
        f = self.policy.shrink_factor
        floor = max(1, self.policy.min_world)
        world = self.world_size
        if not world:
            return None
        model = self.model_size or 1
        if model <= 1:
            new_world = world // f
            return (new_world, None) if new_world >= floor else None
        data = world // model
        if data // f >= 1 and (data // f) * model >= floor:
            return ((data // f) * model, model)
        if data == 1 and model % f == 0 and model // f >= floor:
            return (model // f, model // f)
        return None

    # ------------------------------------------------------------ flight --
    def summarize_flight(self) -> int:
        """Log the recordings in ``flight_dir`` not logged yet, newest
        first (``tpuddp/resilience/supervisor.py:316-348``); returns how
        many. Best-effort: a missing directory or a corrupt file never
        holds back the restart."""
        if self.flight_dir is None:
            return 0
        from tpuddp_torch.observability import flight as flight_lib

        summarized = 0
        for path in flight_lib.find_recordings(self.flight_dir):
            try:
                key = (path, os.path.getmtime(path))
            except OSError:
                continue
            if key in self._summarized:
                continue
            self._summarized.add(key)
            summarized += 1
            for line in flight_lib.summarize_recording(path):
                logger.warning("supervisor: %s", line)
        return summarized

    # --------------------------------------------------------------- run --
    def run(self) -> int:
        restarts = 0
        consecutive_failures = 0  # the backoff's exponent (75 resets it)
        consecutive_peer_deaths = 0  # the shrink's trigger (a streak of 76)
        attempt = 0
        self.summarize_flight()  # what an earlier, unsupervised run left
        while True:
            if self._stop.is_set():
                # stopped before this attempt: preempted work must not run
                return self.history[-1][1] if self.history else 0
            launched = self.world_size  # set_world may retarget it meanwhile
            self._current_world = launched
            rc = self.runner(self.argv, self._child_env(attempt, launched))
            self.history.append((attempt, rc, launched))
            attempt += 1
            if rc == 0:
                logger.info("supervisor: child finished cleanly")
                return 0
            self.summarize_flight()  # the child's post-mortem, before deciding
            if self._stop.is_set():
                logger.warning("supervisor: stop requested; child exited %d (%s), not "
                               "restarting", rc, classify_exit(rc))
                return rc
            restarts += 1
            if restarts > self.policy.max_restarts:
                logger.critical("supervisor: restart budget (%d) exhausted; surfacing the "
                                "child's exit code %d", self.policy.max_restarts, rc)
                return rc
            if rc == EXIT_PREEMPTED:
                consecutive_failures = 0
                consecutive_peer_deaths = 0
                logger.warning("supervisor: child drained after preemption (exit %d); resuming "
                               "immediately (restart %d/%d)", rc, restarts,
                               self.policy.max_restarts)
                continue
            consecutive_failures += 1
            if rc == EXIT_WATCHDOG:
                consecutive_peer_deaths += 1
                shrunk = (self._shrunk_mesh()
                          if consecutive_peer_deaths >= self.policy.shrink_after else None)
                if shrunk is not None:
                    new_world, new_model = shrunk
                    logger.critical(
                        "supervisor: %d consecutive peer deaths (exit %d) — the pod lost "
                        "capacity, not a transient. Shrinking mesh %d (model=%s) -> %d "
                        "(model=%s) and resuming through the elastic restore path.",
                        consecutive_peer_deaths, rc, self.world_size, self.model_size or 1,
                        new_world, new_model or self.model_size or 1,
                    )
                    self.world_size = new_world
                    if new_model is not None:
                        self.model_size = new_model
                    consecutive_peer_deaths = 0
                    consecutive_failures = 0
                    continue
            else:
                consecutive_peer_deaths = 0
            delay = self.policy.delay(consecutive_failures, self._rng)
            logger.warning("supervisor: child exited %d (%s); restart %d/%d with auto-resume "
                           "in %.1fs", rc, classify_exit(rc), restarts,
                           self.policy.max_restarts, delay)
            self.sleep(delay)


def supervise(argv: Sequence[str], **kwargs) -> int:
    """``RestartSupervisor(argv, **kwargs).run()``: the exit code."""
    return RestartSupervisor(argv, **kwargs).run()
