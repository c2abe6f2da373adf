"""The SIGTERM/SIGINT drain — the counterpart of
``tpuddp/resilience/preemption.py``.

HTCondor (the reference tutorial's scheduler) sends SIGTERM, waits a grace
window, then sends SIGKILL. The contract:

1. :func:`install_preemption_handler` (called by each rank of
   ``parallel/spawn.py`` before it trains) registers handlers that only set
   a flag: a signal handler must not run a collective or touch the device.
2. The epoch loops poll :func:`preemption_requested` at dispatch
   boundaries, write an emergency checkpoint (or, with ``training.snapshot``
   armed, flush the snapshot writer and write a final step snapshot) and
   raise :class:`TrainingPreempted`.
3. ``parallel/spawn.py`` turns that into ``sys.exit(EXIT_PREEMPTED)``: exit
   75 (BSD ``EX_TEMPFAIL``), the "requeue me" code schedulers understand; the
   requeued command with ``$TPUDDP_AUTO_RESUME=1`` continues the run.
4. A daemon failsafe started at the signal force-exits with the same code
   after ``$TPUDDP_PREEMPT_GRACE`` seconds (default 25), so a drain that
   wedges (a collective that never completes) still beats the SIGKILL and
   still reports 75. Before it exits it dumps the flight recorders
   (``flightrec_preempt_forced.json``) on a thread it waits for at most
   :data:`FORCED_DUMP_WAIT_S` seconds: a dump stuck on a wedged filesystem
   does not hold the exit back.

A second signal during the drain exits at once: the operator, or the
scheduler escalating, asked twice.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time
from typing import Optional

from tpuddp_torch.resilience.guard import EXIT_DESYNC  # noqa: F401 (77, the guard's)

logger = logging.getLogger("tpuddp")

# The exit codes (README "Preemption"). 75 = EX_TEMPFAIL, "transient,
# requeue"; 76, 77 and 113 are the JAX package's own, outside the shell's
# and the signals' ranges (126-165).
EXIT_PREEMPTED = 75  # drained after SIGTERM/SIGINT; safe to requeue and resume
EXIT_WATCHDOG = 76  # a peer's heartbeat went stale (resilience/watchdog.py)
EXIT_INJECTED_CRASH = 113  # $TPUDDP_FAULT crash@... (resilience/faults.py)

_GRACE_ENV = "TPUDDP_PREEMPT_GRACE"
_DEFAULT_GRACE = 25.0
FORCED_DUMP_WAIT_S = 5.0  # the failsafe's wait for its flight dump
AUTO_RESUME_ENV = "TPUDDP_AUTO_RESUME"

_flag = threading.Event()
_state = {
    "installed": False,
    "previous": {},  # signum -> the handler before ours
    "signum": None,
    "deadline": None,
    "cancel": None,  # the running failsafe's Event; reset_preemption sets it
}


class TrainingPreempted(Exception):
    """Raised by an epoch loop after its emergency save. ``epoch`` is the
    epoch that was interrupted; ``checkpoint`` the file written (on rank 0;
    None elsewhere or without a save directory)."""

    def __init__(self, epoch: int, checkpoint: Optional[str] = None):
        self.epoch = epoch
        self.checkpoint = checkpoint
        super().__init__(
            f"training preempted during epoch {epoch}"
            + (f"; emergency checkpoint at {checkpoint}" if checkpoint else "")
        )


def auto_resume_requested() -> bool:
    """``$TPUDDP_AUTO_RESUME`` set to anything but empty or ``0``: restore
    the newest intact checkpoint at the loop's entry (both entry points)."""
    return os.environ.get(AUTO_RESUME_ENV, "") not in ("", "0")


def preemption_grace_seconds() -> float:
    """The SIGTERM-to-forced-exit budget (``$TPUDDP_PREEMPT_GRACE``, s)."""
    raw = os.environ.get(_GRACE_ENV, "")
    try:
        return float(raw) if raw else _DEFAULT_GRACE
    except ValueError:
        logger.warning("ignoring non-numeric %s=%r", _GRACE_ENV, raw)
        return _DEFAULT_GRACE


def _failsafe(grace: float, cancel: threading.Event) -> None:
    if cancel.wait(grace):
        return  # reset_preemption ended the drain window
    if _flag.is_set():  # the drain did not finish in time: beat the SIGKILL
        logger.critical(
            "preemption drain exceeded the %.0fs grace window; forcing exit %d",
            grace, EXIT_PREEMPTED,
        )
        # a wedged drain is when a post-mortem matters: dump the flight rings
        # before the forced exit skips every finally, on a side thread with a
        # bounded wait (the dump writes to the filesystem the drain may have
        # hung on, and a hang raises nothing): the exit goes on regardless
        try:
            from tpuddp_torch.observability import flight

            t = threading.Thread(target=flight.dump_all, args=("preempt_forced",),
                                 name="tpuddp-flight-forced", daemon=True)
            t.start()
            t.join(timeout=FORCED_DUMP_WAIT_S)
            if t.is_alive():
                logger.critical("forced-exit flight dump is wedged too (shared FS?); exiting "
                                "without it")
        except Exception:
            logger.exception("forced-exit flight dump failed")
        os._exit(EXIT_PREEMPTED)


def request_preemption(signum: Optional[int] = None, frame=None) -> None:
    """The handler's body (also called by ``$TPUDDP_FAULT=preempt@...``): set
    the flag and start the grace-window failsafe; never touch the runtime."""
    if _flag.is_set():
        logger.critical("second preemption signal; exiting immediately")
        os._exit(EXIT_PREEMPTED)
    grace = preemption_grace_seconds()
    _flag.set()
    _state["signum"] = signum
    _state["deadline"] = time.monotonic() + grace
    name = signal.Signals(signum).name if signum is not None else "request"
    logger.warning(
        "%s received: draining — emergency checkpoint at the next batch-group boundary, "
        "then exit %d (grace %.0fs)", name, EXIT_PREEMPTED, grace,
    )
    _state["cancel"] = threading.Event()
    threading.Thread(target=_failsafe, args=(grace, _state["cancel"]),
                     name="tpuddp-preempt-failsafe", daemon=True).start()


def preemption_requested() -> bool:
    return _flag.is_set()


def preemption_deadline() -> Optional[float]:
    """``time.monotonic()`` deadline of the drain window; None if not draining."""
    return _state["deadline"] if _flag.is_set() else None


def install_preemption_handler(signals=(signal.SIGTERM, signal.SIGINT)) -> bool:
    """Register the drain handlers. Main thread only (a Python rule): returns
    False, and does nothing, elsewhere."""
    if threading.current_thread() is not threading.main_thread():
        logger.debug("not main thread; preemption handler not installed")
        return False
    if _state["installed"]:
        return True
    for s in signals:
        _state["previous"][s] = signal.signal(s, request_preemption)
    _state["installed"] = True
    return True


def uninstall_preemption_handler() -> None:
    if not _state["installed"]:
        return
    for s, prev in _state["previous"].items():
        signal.signal(s, prev)
    _state["previous"].clear()
    _state["installed"] = False


def reset_preemption() -> None:
    """Clear the flag and the deadline and end the failsafe's thread
    (tests; a real process exits)."""
    _flag.clear()
    if _state["cancel"] is not None:
        _state["cancel"].set()
    _state.update(signum=None, deadline=None, cancel=None)
