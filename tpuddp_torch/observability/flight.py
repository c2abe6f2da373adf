"""The crash flight recorder — the counterpart of
``tpuddp/observability/flight.py``: bounded in-memory rings of the last
history records, dumped on an abnormal exit.

The recorder keeps the last ``capacity`` records of each kind (step_stats
windows, events, epoch rows, serving and decode windows), fed by the tee
every history write passes through (``MetricsWriter(flight=...)``), the
newest ``run_meta`` header, and the notes and context providers a loop adds
(:meth:`FlightRecorder.note`, :meth:`FlightRecorder.add_context`). It is
host-side: nothing here reads a device.

On an abnormal exit the recorder writes one strict-JSON file,
``flightrec_<reason>.json``, atomically (staged, fsync'd, renamed) into the
run directory:

=================  ========================================================
reason             exit path
=================  ========================================================
preempt            SIGTERM/SIGINT drain -> emergency save -> exit 75
preempt_forced     the drain blew its grace window; the failsafe forced 75
watchdog           a peer's heartbeat went stale -> exit 76
desync             the guard's auditor found a divergent replica -> exit 77
exception          an unhandled exception in either epoch loop
=================  ========================================================

A host other than 0 names its file ``flightrec_<reason>_p<host>.json``
(the run directory is shared across hosts). In the port one process of
each host keeps a recorder, its local rank 0, the process that stands for
the JAX package's process of that host, so one world-2 run on one host
leaves the files a JAX run of two devices leaves. A dump is idempotent per
reason and best-effort: a failing write logs and returns None, and the exit
path goes on. :func:`install` and :func:`dump_all` let the detached exit
paths (the watchdog's thread, the drain's failsafe) dump every live
recorder of the process. :func:`find_recordings` and
:func:`summarize_recording` serve the restart supervisor's summaries
(``python -m tpuddp_torch.supervise --flight-dir``).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from tpuddp_torch.observability import schema
from tpuddp_torch.observability.metrics import json_sanitize

logger = logging.getLogger("tpuddp")

DEFAULT_CAPACITY = 64

# the record types with a ring each; any other (run_meta) is kept whole
_RING_TYPES = ("step_stats", "event", "epoch", "serving_stats", "decode_stats")

_registry_lock = threading.Lock()
_registry: List["FlightRecorder"] = []


def _host_index() -> int:
    from tpuddp_torch.parallel import backend

    return backend.host_index()


class FlightRecorder:
    """Bounded per-kind record rings of one process and the atomic dump.
    ``process_index`` is the host (default: this process's,
    :func:`~tpuddp_torch.parallel.backend.host_index`)."""

    def __init__(self, save_dir: Optional[str], capacity: int = DEFAULT_CAPACITY,
                 process_index: Optional[int] = None):
        self.save_dir = save_dir
        self.capacity = max(1, int(capacity))
        self.process_index = int(_host_index() if process_index is None else process_index)
        self._lock = threading.Lock()
        self._rings: Dict[str, deque] = {t: deque(maxlen=self.capacity) for t in _RING_TYPES}
        self._run_meta: Optional[dict] = None
        self._notes: dict = {}
        # zero-argument callables sampled when the dump is made (the tracer's
        # open spans: the step a process died in)
        self._context: Dict[str, Callable] = {}
        self.observed = 0
        self.dumped: Dict[str, str] = {}  # reason -> path (one dump per reason)

    def observe(self, record) -> None:
        """Tee one history record into its ring (the writer calls it for
        every record); untyped records are ignored."""
        if not isinstance(record, dict):
            return
        rtype = record.get("type")
        with self._lock:
            self.observed += 1
            if rtype == "run_meta":
                self._run_meta = record  # the newest header (a resume appends one)
            elif rtype in self._rings:
                self._rings[rtype].append(record)

    def note(self, **fields) -> None:
        """Add fields to the next dump's ``notes`` (the drain's checkpoint
        and steps, the last snapshot, an elastic reshard)."""
        with self._lock:
            self._notes.update(fields)

    def add_context(self, name: str, fn: Callable) -> None:
        """Register ``fn``, called when a dump is made, its result under
        ``notes[name]``; a provider that raises leaves its error's text
        there instead of stopping the dump."""
        with self._lock:
            self._context[name] = fn

    def payload(self, reason: str) -> dict:
        with self._lock:
            providers = list(self._context.items())
        notes = {}
        for name, fn in providers:
            # outside self._lock: a provider takes its own lock (the tracer's)
            try:
                notes[name] = fn()
            except Exception as e:  # noqa: BLE001 — never block an exit path
                notes[name] = f"<context provider failed: {e}>"
        with self._lock:
            notes.update(self._notes)
            records = {t: list(ring) for t, ring in self._rings.items()}
            return json_sanitize({
                "type": schema.FLIGHT_TYPE,
                "schema_version": schema.SCHEMA_VERSION,
                "reason": reason,
                "process_index": self.process_index,
                "capacity": self.capacity,
                "dumped_at": round(time.time(), 3),
                "observed_records": self.observed,
                "counts": {t: len(r) for t, r in records.items()},
                "run_meta": self._run_meta,
                "notes": notes,
                "records": records,
            })

    def dump(self, reason: str) -> Optional[str]:
        """Write ``flightrec_<reason>.json`` (``_p<host>`` past host 0)
        atomically; returns its path, the earlier path when this reason was
        dumped already, or None (no ``save_dir``, or a failed write, logged,
        never raised)."""
        if self.save_dir is None:
            return None
        if reason in self.dumped:
            return self.dumped[reason]
        name = (f"flightrec_{reason}.json" if self.process_index == 0
                else f"flightrec_{reason}_p{self.process_index}.json")
        path = os.path.join(self.save_dir, name)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            os.makedirs(self.save_dir, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(self.payload(reason), f, allow_nan=False, indent=1)
                f.write("\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except (OSError, ValueError) as e:
            logger.warning("flight recorder dump (%s) failed: %s", reason, e)
            try:
                os.remove(tmp)
            except OSError:
                pass
            return None
        self.dumped[reason] = path
        logger.warning("flight recording (%s) -> %s", reason, path)
        return path

    def describe(self) -> dict:
        """The run_meta ``observability.flight_recorder`` field."""
        return {"capacity": self.capacity}


def arm_pending_tune(recorder: Optional[FlightRecorder], obs_cfg: dict,
                     run_dir: Optional[str]) -> bool:
    """With ``observability.advisor`` on or ``$TPUDDP_TUNE_OVERLAY`` set,
    give ``recorder`` the ``pending_tune`` context (``tpuddp/training/
    loop.py:293-300``): a dump then carries the advisor's top pending
    recommendation over ``run_dir``, so a preempted or crashed run keeps
    what it had learned. Returns whether it armed."""
    from tpuddp_torch.config import TUNE_OVERLAY_ENV

    if recorder is None or run_dir is None:
        return False
    if not (obs_cfg.get("advisor") or os.environ.get(TUNE_OVERLAY_ENV)):
        return False
    from tpuddp_torch.observability import advisor

    recorder.add_context("pending_tune", lambda: advisor.pending_summary(run_dir))
    return True


def install(recorder: FlightRecorder) -> FlightRecorder:
    """Register a live recorder for :func:`dump_all`."""
    with _registry_lock:
        if recorder not in _registry:
            _registry.append(recorder)
    return recorder


def uninstall(recorder: FlightRecorder) -> None:
    with _registry_lock:
        if recorder in _registry:
            _registry.remove(recorder)


def dump_all(reason: str) -> List[str]:
    """Dump every installed recorder; never raises (its callers are exit
    paths). Returns the paths written."""
    with _registry_lock:
        recorders = list(_registry)
    paths = []
    for rec in recorders:
        try:
            path = rec.dump(reason)
        except Exception:  # noqa: BLE001 — never block an exit path
            logger.exception("flight recorder dump_all(%r) failed", reason)
            continue
        if path:
            paths.append(path)
    return paths


def find_recordings(directory: str) -> List[str]:
    """The ``flightrec_*.json`` files of ``directory``, newest first."""
    try:
        names = [n for n in os.listdir(directory)
                 if n.startswith("flightrec_") and n.endswith(".json")]
    except OSError:
        return []
    paths = [os.path.join(directory, n) for n in names]
    return sorted(paths, key=lambda p: os.path.getmtime(p), reverse=True)


def summarize_recording(path: str) -> List[str]:
    """A few summary lines of a recording (the supervisor logs them); an
    unreadable file gives a line that says so."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError) as e:
        return [f"flight recording {path}: unreadable ({e})"]
    if not isinstance(payload, dict):
        return [f"flight recording {path}: not a JSON object"]
    lines = [f"flight recording: reason={payload.get('reason')} "
             f"process={payload.get('process_index')} capacity={payload.get('capacity')}"]
    meta = payload.get("run_meta") or {}
    if meta:
        lines.append(f"  run: api={meta.get('api')} model={meta.get('model')} "
                     f"world={meta.get('world_size')} epoch span "
                     f"{meta.get('start_epoch')}..{meta.get('num_epochs')}")
    records = payload.get("records") or {}
    windows = records.get("step_stats") or []
    if windows:
        last = windows[-1]
        lines.append(f"  last window: epoch {last.get('epoch')} steps "
                     f"[{last.get('step_start')}, "
                     f"{(last.get('step_start') or 0) + (last.get('steps') or 0)}) "
                     f"p50 {last.get('step_time_ms_p50')} ms "
                     f"({len(windows)} window(s) retained)")
    epochs = records.get("epoch") or []
    if epochs:
        last = epochs[-1]
        lines.append(f"  last epoch: {last.get('epoch')} train_loss {last.get('train_loss')} "
                     f"skips {last.get('skipped_steps_epoch', 0)}")
    for ev in (records.get("event") or [])[-5:]:
        fields = {k: v for k, v in ev.items() if k not in ("type", "schema_version", "event")}
        lines.append(f"  event: {ev.get('event')} {fields}")
    return lines
