"""On-demand profiling through ``torch.profiler`` — the counterpart of
``tpuddp/observability/profiling.py``: three triggers, one trace at a time.

- ``$TPUDDP_PROFILE=<dir>`` (or ``1`` for ``<save_dir>/trace``): trace the
  first epoch, its evaluation included.
- ``$TPUDDP_PROFILE_STEPS=<start>:<stop>``: trace the updates ``[start,
  stop)`` (counted from the loop's entry). The trace starts before the
  dispatch that holds ``start`` and stops once the dispatch that holds
  ``stop - 1`` has run on the device: exact one step per batch, widened to
  whole chunks (native ``scan_steps``) or whole queued groups (managed
  ``fuse_steps``) otherwise. Its directory is ``$TPUDDP_PROFILE`` when that
  names one, else ``<save_dir>/trace_steps_<start>_<stop>``.
- ``SIGUSR1``: trace the next whole epoch into ``<save_dir>/trace_sigusr1_e<N>``.

Each trace is one Chrome trace file, ``trace_rank<R>.json`` in its
directory (the host's operators and, on the card, its kernels and copies),
which Perfetto and ``chrome://tracing`` load as it is. A trigger that finds
a trace running is skipped with a warning.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger("tpuddp")

_PROFILE_ENV = "TPUDDP_PROFILE"
_PROFILE_STEPS_ENV = "TPUDDP_PROFILE_STEPS"
_profiling = {"profiler": None, "dir": None}
_sigusr1 = {"installed": False, "requested": False}


def active() -> bool:
    return _profiling["profiler"] is not None


def _start_trace(target: str) -> bool:
    if active():
        logger.warning("profiler trigger for %s skipped: a trace is already active", target)
        return False
    os.makedirs(target, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _profiling.update(profiler=prof, dir=target)
    return True


def stop_profiler(fence: Optional[Callable[[], None]] = None) -> Optional[str]:
    """Stop the active trace and write it; returns the trace file (None
    when no trace was active). ``fence()`` first waits for the device, so
    the trace holds the work it covers."""
    prof, target = _profiling["profiler"], _profiling["dir"]
    if prof is None:
        return None
    if fence is not None:
        fence()
    prof.stop()
    _profiling.update(profiler=None, dir=None)
    rank = dist.get_rank() if dist.is_initialized() else 0
    path = os.path.join(target, f"trace_rank{rank}.json")
    prof.export_chrome_trace(path)
    return path


def maybe_start_profiler(default_dir: Optional[str] = None) -> bool:
    """Start the first-epoch trace if ``$TPUDDP_PROFILE`` is set (its value
    is the directory; ``1`` is ``default_dir/trace``). The step window owns
    the trace when ``$TPUDDP_PROFILE_STEPS`` is set too."""
    target = os.environ.get(_PROFILE_ENV)
    if not target or active() or os.environ.get(_PROFILE_STEPS_ENV):
        return False
    if target == "1":
        if default_dir is None:
            return False
        target = os.path.join(default_dir, "trace")
    return _start_trace(target)


def parse_profile_steps(raw: Optional[str] = None) -> Optional[Tuple[int, int]]:
    """``$TPUDDP_PROFILE_STEPS`` as ``(start, stop)``; None when unset. A
    malformed value is the JAX package's ``ValueError``."""
    raw = os.environ.get(_PROFILE_STEPS_ENV, "") if raw is None else raw
    if not raw:
        return None
    try:
        start_s, stop_s = raw.split(":")
        start, stop = int(start_s), int(stop_s)
    except ValueError:
        raise ValueError(
            f"{_PROFILE_STEPS_ENV}={raw!r} is not <start>:<stop> "
            "(two integers, e.g. 100:110)"
        )
    if start < 0 or stop <= start:
        raise ValueError(f"{_PROFILE_STEPS_ENV}={raw!r}: need 0 <= start < stop")
    return start, stop


class StepWindowProfiler:
    """The ``$TPUDDP_PROFILE_STEPS`` hook: :meth:`before_dispatch` with the
    update index the dispatch starts at and its updates,
    :meth:`after_dispatch` with the index after it. Two integer compares a
    dispatch when the variable is unset."""

    def __init__(self, save_dir: Optional[str]):
        self.window = parse_profile_steps()
        self.dir = None
        self.active = False
        self.done = self.window is None
        if self.window is not None:
            start, stop = self.window
            explicit = os.environ.get(_PROFILE_ENV)
            if explicit and explicit != "1":
                self.dir = explicit
            elif save_dir is not None:
                self.dir = os.path.join(save_dir, f"trace_steps_{start}_{stop}")
            else:
                logger.warning("%s set but no trace directory (no save_dir and no %s=<dir>); "
                               "step-window profiling disabled", _PROFILE_STEPS_ENV, _PROFILE_ENV)
                self.done = True

    def before_dispatch(self, global_step: int, n_steps: int) -> None:
        if self.done or self.active:
            return
        if global_step + n_steps > self.window[0]:  # this dispatch holds `start`
            self.active = _start_trace(self.dir)
            if not self.active:
                self.done = True

    def after_dispatch(self, global_step_end: int, fence=None) -> Optional[str]:
        """The trace file once the window is complete, else None."""
        if not self.active or global_step_end < self.window[1]:
            return None
        path = stop_profiler(fence)
        self.active, self.done = False, True
        logger.info("step-window trace [%d, %d) captured -> %s", *self.window, path)
        return path

    def finish(self, fence=None) -> Optional[str]:
        """A window that never reached ``stop`` (a short run, an exception)
        still writes its partial trace."""
        if not self.active:
            return None
        self.active, self.done = False, True
        return stop_profiler(fence)


def _on_sigusr1(signum, frame) -> None:
    _sigusr1["requested"] = True


def install_sigusr1_trigger() -> bool:
    """Arm SIGUSR1 -> trace the next epoch (main thread only)."""
    if _sigusr1["installed"]:
        return True
    if threading.current_thread() is not threading.main_thread():
        return False
    try:
        signal.signal(signal.SIGUSR1, _on_sigusr1)
    except (ValueError, OSError, AttributeError):
        return False
    _sigusr1["installed"] = True
    return True


def consume_sigusr1_request() -> bool:
    """True once per received SIGUSR1 (polled at each epoch's start)."""
    if _sigusr1["requested"]:
        _sigusr1["requested"] = False
        return True
    return False


def start_epoch_trace(save_dir: Optional[str], epoch: int) -> bool:
    """Start the SIGUSR1-requested one-epoch trace."""
    if save_dir is None:
        logger.warning("SIGUSR1 trace requested but no save_dir; skipped")
        return False
    return _start_trace(os.path.join(save_dir, f"trace_sigusr1_e{epoch}"))


def reset_profiling_state() -> None:
    """Test isolation: stop any trace (unwritten) and drop a pending
    SIGUSR1 request."""
    if _profiling["profiler"] is not None:
        _profiling["profiler"].stop()
        _profiling.update(profiler=None, dir=None)
    _sigusr1["requested"] = False
