"""The multi-host watchdog: heartbeat files and stale-peer detection — the
counterpart of ``tpuddp/resilience/watchdog.py``.

One host of a multi-host run dies (preempted, OOM-killed, cut off) and
every other host waits forever inside its next collective: neither NCCL nor
Gloo gives up on a peer that never arrives. Detection lives beside the
collectives:

- each host runs a :class:`Heartbeat` thread that rewrites
  ``<dir>/hb_<process_id>`` every ``interval`` seconds (staged and renamed;
  its first line is the wall clock, since mtime is unreliable on NFS);
- a :class:`Watchdog` thread reads the peers' files and, when one goes
  stale past ``$TPUDDP_WATCHDOG_TIMEOUT`` seconds, logs which peer died and
  how stale it is, writes a ``watchdog_stale`` event row into
  ``history.jsonl`` (fsync'd), and acts: ``action="exit"`` (the default)
  leaves with ``EXIT_WATCHDOG`` (76) so that the scheduler or the restart
  supervisor requeues and auto-resumes the whole job; a callable action
  gets the stale list instead.

The directory is ``$TPUDDP_HEARTBEAT_DIR``, else ``<save_dir>/.heartbeats``
(the checkpoint directory is the one every host already shares). A ``hang``
fault (:func:`~tpuddp_torch.resilience.faults.is_hung`) stops the beat
without stopping the process: to its peers it is a dead host.

A heartbeat file may carry a second line, one JSON object: the host's
telemetry shard, which the pod aggregator reads
(:mod:`tpuddp_torch.observability.aggregate`; :func:`set_heartbeat_payload`
registers the shard's source with the beat thread,
:func:`read_heartbeat_payload` reads it); the liveness reader takes line 1
alone. The files are the JAX package's, so either package's reader reads
the other's. Before it exits 76 the watchdog dumps the process's flight
recorders (``flightrec_watchdog.json``).
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
from typing import Callable, List, Optional, Tuple, Union

from tpuddp_torch.resilience import faults
from tpuddp_torch.resilience.preemption import EXIT_WATCHDOG

logger = logging.getLogger("tpuddp")

_TIMEOUT_ENV = "TPUDDP_WATCHDOG_TIMEOUT"
_DIR_ENV = "TPUDDP_HEARTBEAT_DIR"


def watchdog_timeout_seconds() -> Optional[float]:
    """``$TPUDDP_WATCHDOG_TIMEOUT`` in seconds; None when unset, not a
    number or not above 0 (the watchdog is then off)."""
    raw = os.environ.get(_TIMEOUT_ENV, "")
    if not raw:
        return None
    try:
        t = float(raw)
    except ValueError:
        logger.warning("ignoring non-numeric %s=%r", _TIMEOUT_ENV, raw)
        return None
    return t if t > 0 else None


def heartbeat_dir(save_dir: Optional[str]) -> Optional[str]:
    """``$TPUDDP_HEARTBEAT_DIR``, else ``<save_dir>/.heartbeats``; None
    without either. The checkpoints' peer spills live under it too."""
    env = os.environ.get(_DIR_ENV)
    if env:
        return env
    if save_dir:
        return os.path.join(save_dir, ".heartbeats")
    return None


def _hb_path(directory: str, process_id: int) -> str:
    return os.path.join(directory, f"hb_{process_id}")


_HB_RE = re.compile(r"^hb_(\d+)$")


def purge_stale_peers(directory: str, num_processes: int) -> int:
    """Remove the heartbeat files of ids ``>= num_processes``: a previous,
    larger world's, which no process of this world rewrites and which a
    watchdog would take for dead peers (an elastic resume reuses
    ``save_dir``). The files of this world's ids stay, with their payloads.
    Best-effort; returns how many went."""
    try:
        names = os.listdir(directory)
    except OSError:
        return 0
    removed = 0
    for name in names:
        m = _HB_RE.match(name)
        if m and int(m.group(1)) >= num_processes:
            try:
                os.remove(os.path.join(directory, name))
                removed += 1
            except OSError:
                pass  # a peer got there first
    if removed:
        logger.info(
            "watchdog: purged %d stale heartbeat file(s) from a previous larger world in %s "
            "(current world: %d processes)", removed, directory, num_processes,
        )
    return removed


def write_heartbeat(directory: str, process_id: int, now: Optional[float] = None,
                    payload: Optional[dict] = None) -> str:
    """Rewrite this process's file atomically: the timestamp line and, when
    given, one JSON ``payload`` line."""
    path = _hb_path(directory, process_id)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(f"{time.time() if now is None else now:.6f}\n")
        if payload is not None:
            f.write(json.dumps(payload, allow_nan=False) + "\n")
    os.replace(tmp, path)
    return path


def read_heartbeat(directory: str, process_id: int) -> Optional[float]:
    """The peer's last beat (line 1 only); None without a readable file."""
    try:
        with open(_hb_path(directory, process_id)) as f:
            return float(f.readline().strip())
    except (OSError, ValueError):
        return None


def read_heartbeat_payload(directory: str, process_id: int) -> Optional[dict]:
    """The peer's payload (line 2), or None: no file, no payload, or a torn
    line, which is skipped with a warning."""
    try:
        with open(_hb_path(directory, process_id)) as f:
            f.readline()
            raw = f.readline().strip()
    except OSError:
        return None
    if not raw:
        return None
    try:
        shard = json.loads(raw)
    except ValueError:
        logger.warning("heartbeat shard for process %d is torn mid-write; skipping this read "
                       "(the next rewrite heals it)", process_id)
        return None
    return shard if isinstance(shard, dict) else None


# the beat thread's payload source: a callable returning the freshest
# payload (or None), registered by whoever publishes one
_payload_fn = {"fn": None}


def set_heartbeat_payload(fn: Optional[Callable[[], Optional[dict]]]) -> None:
    """Register ``fn`` (None: none), whose dict every later beat carries on
    its second line."""
    _payload_fn["fn"] = fn


def _current_payload() -> Optional[dict]:
    fn = _payload_fn["fn"]
    if fn is None:
        return None
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 — liveness must outlive the payload
        logger.warning("heartbeat payload callback failed: %s", e)
        return None


class Heartbeat:
    """Daemon thread rewriting this process's heartbeat file."""

    def __init__(self, directory: str, process_id: int, interval: float = 1.0):
        self.directory = directory
        self.process_id = int(process_id)
        self.interval = float(interval)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Heartbeat":
        os.makedirs(self.directory, exist_ok=True)
        write_heartbeat(self.directory, self.process_id)  # one beat before returning
        self._thread = threading.Thread(target=self._run, name="tpuddp-heartbeat", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            if faults.is_hung():
                continue  # an injected hang: look exactly like a dead peer
            try:
                write_heartbeat(self.directory, self.process_id, payload=_current_payload())
            except OSError as e:  # a shared filesystem's hiccup: keep beating
                logger.warning("heartbeat write failed: %s", e)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


def start(save_dir: Optional[str], process_id: int, num_processes: int,
          interval: float = 1.0) -> Optional[Tuple["Heartbeat", "Watchdog"]]:
    """Start this process's heartbeat and stale-peer watchdog (what
    ``parallel/spawn.py`` arms beside a rendezvous of more than one host);
    hand the pair to :func:`stop`. None, and nothing started, unless
    ``$TPUDDP_WATCHDOG_TIMEOUT`` is set, there are peers and a directory
    resolves. A previous run's files of ids past this world are purged;
    beats older than the watchdog's start get the startup grace."""
    timeout = watchdog_timeout_seconds()
    if timeout is None or num_processes <= 1:
        return None
    directory = heartbeat_dir(save_dir)
    if directory is None:
        logger.warning("%s set but no heartbeat dir resolvable (no save_dir and no %s); "
                       "watchdog disabled", _TIMEOUT_ENV, _DIR_ENV)
        return None
    purge_stale_peers(directory, num_processes)
    hb = Heartbeat(directory, process_id, interval=interval).start()
    # the verdict lands in history.jsonl from whichever process saw it (the
    # process-0 rule does not hold: process 0 may be the dead one)
    event_writer = None
    if save_dir is not None:
        from tpuddp_torch.observability import MetricsWriter

        event_writer = MetricsWriter(save_dir, main_only=False)
    wd = Watchdog(directory, process_id, num_processes, timeout,
                  event_writer=event_writer).start()
    logger.info("watchdog armed: %d-process heartbeat dir %s, timeout %.1fs",
                num_processes, directory, timeout)
    return hb, wd


def stop(pair: Optional[Tuple["Heartbeat", "Watchdog"]]) -> None:
    """Stop a :func:`start` pair (None passes)."""
    if pair is None:
        return
    hb, wd = pair
    wd.stop()
    hb.stop()


class Watchdog:
    """Daemon thread that finds stale peers.

    ``action``: ``"exit"`` (``os._exit(EXIT_WATCHDOG)``, the one way out
    while the main thread waits inside a collective) or a callable given
    ``[(peer_id, age_seconds), ...]``."""

    def __init__(self, directory: str, process_id: int, num_processes: int, timeout: float,
                 action: Union[str, Callable] = "exit", interval: Optional[float] = None,
                 event_writer=None):
        self.directory = directory
        self.process_id = int(process_id)
        self.num_processes = int(num_processes)
        self.timeout = float(timeout)
        self.action = action
        self.interval = float(interval) if interval else max(0.25, self.timeout / 4.0)
        self.event_writer = event_writer  # a MetricsWriter, or None
        self.max_observed_lag = 0.0
        self._started_at = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def check_once(self, now: Optional[float] = None) -> List[Tuple[int, float]]:
        """The stale peers as ``(peer_id, age_seconds)``. A peer without a
        file, or whose beat predates this watchdog's start (a previous
        run's), is stale only once the timeout has passed since the start
        (the startup grace)."""
        now = time.time() if now is None else now
        started = self._started_at if self._started_at is not None else now
        stale = []
        for peer in range(self.num_processes):
            if peer == self.process_id:
                continue
            beat = read_heartbeat(self.directory, peer)
            if beat is not None and beat < started:
                beat = None  # a previous run's file: as if there were none
            if beat is None:
                if now - started > self.timeout:
                    stale.append((peer, now - started))
            elif now - beat > self.timeout:
                stale.append((peer, now - beat))
            else:
                self.max_observed_lag = max(self.max_observed_lag, now - beat)
        return stale

    def start(self) -> "Watchdog":
        self._started_at = time.time()
        self._thread = threading.Thread(target=self._run, name="tpuddp-watchdog", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                stale = self.check_once()
            except OSError as e:
                logger.warning("watchdog scan failed: %s", e)
                continue
            if stale:
                self._fire(stale)
                return

    def _fire(self, stale: List[Tuple[int, float]]) -> None:
        desc = ", ".join(f"process {p} ({age:.1f}s stale)" for p, age in stale)
        logger.critical(
            "watchdog: peer heartbeat stale past %.1fs — %s; a dead peer wedges every "
            "collective, so this process will not wait", self.timeout, desc,
        )
        if self.event_writer is not None:
            # the verdict as a history row, fsync'd before os._exit skips
            # every finally
            try:
                from tpuddp_torch.observability import schema

                path = self.event_writer.path
                if path is not None and (not os.path.exists(path) or os.path.getsize(path) == 0):
                    # no epoch loop wrote a header yet: the history must still
                    # open with one to validate
                    self.event_writer.write(schema.make_run_meta(
                        world_size=None, process_count=self.num_processes,
                        process_index=self.process_id,
                        extra={"api": "watchdog", "process": self.process_id}))
                self.event_writer.write(schema.stamp("event", {
                    "event": "watchdog_stale",
                    "process": self.process_id,
                    "timeout_s": self.timeout,
                    "stale_peers": [{"process": p, "lag_s": round(age, 3)} for p, age in stale],
                    "max_observed_lag_s": round(self.max_observed_lag, 3),
                }))
                self.event_writer.sync()
            except Exception:
                logger.exception("watchdog event record failed")
        # the exit-76 flight recording: the last windows and events this
        # process saw before it stopped waiting for the dead peer
        try:
            from tpuddp_torch.observability import flight

            flight.dump_all("watchdog")
        except Exception:
            logger.exception("watchdog flight dump failed")
        if callable(self.action):
            self.action(stale)
        else:
            os._exit(EXIT_WATCHDOG)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
