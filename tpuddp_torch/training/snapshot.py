"""Step snapshots: device copies between dispatches, a background writer,
and the v4 data cursor for an exact mid-epoch resume — the counterpart of
``tpuddp/training/snapshot.py``.

**The copy.** :meth:`SnapshotEngine.maybe` runs in the native dispatch
loop between dispatches. The parameters, the buffers, the optimizer's
moments, the device step count, the comm hook's residual, the guard's
counters and the epoch's partial sums are updated in place by the next
step (or by the CUDA graph that replays it), so the engine clones them on
the compute stream before that step is enqueued; a side stream then copies
the clones into pinned host buffers and records an event. The loop's
thread polls that event (``query()``, at the next dispatch boundary: never
a wait) and hands the finished copy to the writer thread, which touches no
CUDA call at all: a call from another thread could break a graph capture in
progress. The pinned buffers are the engine's, reused and freed on the
loop's thread. The host values (each rank's random streams, the
micro-batch count) are read at the copy. The engine holds at most
``inflight`` snapshots between the copy and the end of the write; when it
is full a due snapshot is SKIPPED (counted), never waited for.

**The writer.** A daemon thread writes each snapshot through
:func:`~tpuddp_torch.training.checkpoint.write_captured`, the synchronous
save's own writer (staged, fsync'd, renamed, ``.sha256``), so an async
snapshot of step N is byte-identical to a synchronous save of it. Its
statistics (snapshots, skips, write seconds, bytes, the loop's seconds in
the engine) go into a ``.writer.json`` sidecar beside each file.

**The v4 cursor.** Each snapshot records ``(epoch, step, plan key)`` and
the partial sums ``{loss_sum, n}`` under ``__cursor__``; ``restore_latest``
surfaces it and the loop, when :func:`epoch_plan_key` of the restored epoch
matches, continues that epoch at the step through :class:`EpochTailLoader`
(random access through ``make_batch_plan``: zero batches replayed) with
the sums seeded from the cursor. A mismatch redoes the epoch.

**Peer copies.** With ``peer_redundancy`` each written snapshot is also
copied under ``<heartbeat_dir>/peer_ckpt/ring_<i>`` (the ring neighbour's
directory); ``restore_latest`` weighs those copies with the local files.

**World > 1 on one host.** Every rank is a process and a capture is a
collective (each rank's random streams, ZeRO-1's shards, the native
residual and the epoch's partial sums are gathered), so every rank runs
the engine and calls the capture at a due step, on the loop's thread,
between dispatches; only rank 0 clones, copies and hands the copy to its
writer thread, and the other ranks drop what they gathered at once. Whether
a due snapshot is taken or skipped must be the same on every rank: the loop
passes ``room``, rank 0's free slot, agreed at the dispatch boundary
(``training/loop.py``'s :class:`~tpuddp_torch.training.loop.AgreedPoll`),
and a rank never decides alone. This is the JAX package's one-process,
N-device case. Across hosts (``backend.num_hosts() > 1``) the engine
disarms itself with the JAX package's warning for state that spans
processes, and the run keeps the epoch-granular saves.

Config block (``training.snapshot``, unknown keys refused)::

    snapshot:
      every_steps: 50        # cadence in real micro-batches; 0 = off
      async: true            # the background writer (false: inline)
      inflight: 2            # snapshots held between copy and write; full => skip
      peer_redundancy: false # spill ring-neighbour copies via the heartbeat dir
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import queue
import re
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from tpuddp_torch.training import checkpoint as ckpt

logger = logging.getLogger("tpuddp")

SNAPSHOT_DEFAULTS: Dict[str, Any] = {
    "every_steps": 50,
    "async": True,
    "inflight": 2,
    "peer_redundancy": False,
}


@dataclass(frozen=True)
class SnapshotConfig:
    """The resolved ``training.snapshot`` block; ``every_steps == 0`` is off
    (the default). The config key ``async`` is the field ``async_writes``."""

    every_steps: int = 0
    async_writes: bool = True
    inflight: int = 2
    peer_redundancy: bool = False

    @property
    def enabled(self) -> bool:
        return self.every_steps > 0

    def as_dict(self) -> Dict[str, Any]:
        return {"every_steps": self.every_steps, "async": self.async_writes,
                "inflight": self.inflight, "peer_redundancy": self.peer_redundancy}


OFF = SnapshotConfig()


def resolve_snapshot(block) -> SnapshotConfig:
    """``training.snapshot`` -> :class:`SnapshotConfig`: None or false is
    off, true all the defaults, a mapping merged over
    :data:`SNAPSHOT_DEFAULTS` with unknown keys refused
    (``tpuddp/training/snapshot.py:118-151``, its messages)."""
    if isinstance(block, SnapshotConfig):
        return block
    if block is None or block is False:
        return OFF
    if block is True:
        block = {}
    if not isinstance(block, dict):
        raise ValueError(
            f"training.snapshot must be a mapping (or true/false), got {type(block).__name__}"
        )
    from tpuddp_torch.config import _merge_refusing_unknown

    cfg = _merge_refusing_unknown(SNAPSHOT_DEFAULTS, block, "training.snapshot")
    every = int(cfg["every_steps"])
    if every < 0:
        raise ValueError(f"training.snapshot.every_steps must be >= 0, got {every}")
    inflight = int(cfg["inflight"])
    if inflight < 1:
        raise ValueError(f"training.snapshot.inflight must be >= 1, got {inflight}")
    return SnapshotConfig(every_steps=every, async_writes=bool(cfg["async"]),
                          inflight=inflight, peer_redundancy=bool(cfg["peer_redundancy"]))


# ---------------------------------------------------------------- cursor --

def epoch_plan_key(loader, epoch: int, local_ranks=None) -> str:
    """The fingerprint of what fixes ``loader``'s batch order in ``epoch``
    (``tpuddp/training/snapshot.py:157-197``): the innermost loader's class,
    the batch count, batch size, seed, shuffle, drop_last, world size, the
    ranks it serves and the epoch. The port's ``ShardedDataLoader`` serves
    one rank with one sampler, so its ``local_ranks`` is ``[rank]`` and its
    seed and shuffle are its sampler's: the key is the JAX package's for
    the same settings, and a cursor written by either package matches.
    ``local_ranks`` overrides the ranks: the loops pass every rank of
    their host, which one JAX process serves, so that all ranks of a host
    agree on one key (the JAX package's one-process key of that world)."""
    inner = loader
    for _ in range(4):  # Staged / Prefetch / Tail wrappers
        nxt = inner.__dict__.get("loader", inner.__dict__.get("inner"))
        if nxt is None:
            break
        inner = nxt
    fields: Dict[str, Any] = {
        "loader": type(inner).__name__,
        "n_batches": len(loader),
        "batch_size": getattr(inner, "batch_size", None),
        "seed": getattr(inner, "seed", None),
        "shuffle": getattr(inner, "shuffle", None),
        "drop_last": getattr(inner, "drop_last", None),
        "world_size": getattr(inner, "world_size", None),
        "epoch": int(epoch),
    }
    sampler = getattr(inner, "sampler", None)
    local_ranks = local_ranks if local_ranks is not None else getattr(inner, "local_ranks", None)
    if local_ranks is None and sampler is not None and hasattr(inner, "rank"):
        local_ranks = [inner.rank]
    if local_ranks is not None:
        fields["local_ranks"] = [int(r) for r in local_ranks]
    samplers = getattr(inner, "samplers", None) or ([sampler] if sampler is not None else None)
    if samplers:
        fields["seed"] = getattr(samplers[0], "seed", fields["seed"])
        fields["shuffle"] = getattr(samplers[0], "shuffle", fields["shuffle"])
    canon = json.dumps(fields, sort_keys=True, default=str)
    return hashlib.sha256(canon.encode("utf-8")).hexdigest()[:16]


_KEYSTR_RE = re.compile(r"^\['([^']*)'\]$")


def acc_from_cursor(cursor: Optional[dict]) -> Optional[Dict[str, np.ndarray]]:
    """The cursor's partial sums keyed by their names (``read_cursor`` keys
    them ``['loss_sum']``); None when it carries none."""
    acc = (cursor or {}).get("acc") or None
    if not acc:
        return None
    out: Dict[str, np.ndarray] = {}
    for k, v in acc.items():
        m = _KEYSTR_RE.match(k)
        out[m.group(1) if m else k] = v
    return out


class EpochTailLoader:
    """``loader`` from batch ``start`` on: the resumed epoch's remaining
    batches, fetched by random access through ``make_batch_plan`` so that
    the applied prefix is never assembled (iterate-and-discard only for a
    loader without a plan). Everything else is the loader's."""

    def __init__(self, loader, start: int):
        self.loader = loader
        self.start = int(start)

    def __len__(self) -> int:
        return max(0, len(self.loader) - self.start)

    def __iter__(self):
        plan = getattr(self.loader, "make_batch_plan", None)
        if plan is not None:
            steps, fetch = plan()
            for s in range(self.start, steps):
                yield fetch(s)
            return
        it = iter(self.loader)
        for _ in range(self.start):
            try:
                next(it)
            except StopIteration:
                return
        yield from it

    def __getattr__(self, name):
        return getattr(self.loader, name)


# ---------------------------------------------------------------- engine --

class _Job:
    __slots__ = ("cap", "acc", "epoch", "step", "plan_key", "done", "clones", "buffers")

    def __init__(self, cap, acc, epoch, step, plan_key):
        self.cap, self.acc = cap, acc
        self.epoch, self.step, self.plan_key = int(epoch), int(step), plan_key
        self.done = None  # the side stream's event after the device-to-host copies
        self.clones = None  # the device clones, held until ``done``
        self.buffers = None  # the pinned host buffers the job's tensors live in


_STOP = object()


def writer_stats_path(path: str) -> str:
    """The ``.writer.json`` sidecar of a snapshot: outside the payload,
    which must not depend on the writer's mode."""
    return path + ".writer.json"


def read_writer_stats(path: str) -> Optional[dict]:
    try:
        with open(writer_stats_path(path), "r", encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


class SnapshotEngine:
    """The step-snapshot engine (module doc). One per run: :meth:`begin_epoch`
    per epoch, :meth:`maybe` after every dispatch, :meth:`flush` and
    :meth:`final_snapshot` from the preemption drain, :meth:`close` on every
    way out. ``capture`` arguments are callables returning
    :func:`~tpuddp_torch.training.checkpoint.capture`'s record of the live
    state; ``acc`` maps the partial sums' names to live tensors."""

    prefix = ckpt.PREFIX[ckpt.NATIVE]  # the native loop's files: ckpt_{epoch}_s{step}.npz

    def __init__(self, save_dir: str, cfg: SnapshotConfig, *, rank: int = 0, world_size: int = 1,
                 hosts: int = 1, host: int = 0, keep_last: Optional[int] = None, tracer=None,
                 flight=None):
        from tpuddp_torch.observability import trace as trace_lib

        self.save_dir = save_dir
        # the live plane (tpuddp/training/snapshot.py:297-307, :363-390,
        # :565-571): a ``snapshot`` span per snapshot taken, under the epoch
        # span the loop sets as trace_parent, and the flight recorder's
        # ``snapshot_last`` note per file written
        self.tracer = tracer if tracer is not None else trace_lib.NULL_TRACER
        self.flight = flight
        self.trace_parent = None
        self.cfg = cfg
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.hosts, self.host = max(int(hosts), 1), int(host)
        self.keep_last = keep_last
        self.stats: Dict[str, Any] = {
            "snapshots": 0, "taken": 0, "skipped_queue_full": 0, "flushes": 0, "write_s": 0.0,
            "bytes": 0, "host_s": 0.0, "last_epoch": None, "last_step": None,
            "last_path": None,
        }
        self._disarmed: Optional[str] = None
        if self.hosts > 1:  # the JAX engine's _addressable text
            self._disarmed = (
                "state holds cross-host-sharded leaves (weight-update sharding across "
                "processes); step snapshots need a collective gather the background writer "
                "cannot join — falling back to epoch-granular checkpoints"
            )
            logger.warning("snapshot engine disarmed: %s", self._disarmed)
        self._last_taken = None  # (epoch, step) of the last snapshot taken, on every rank
        self._next_due = cfg.every_steps
        self._lock = threading.Lock()
        self._errors: List[str] = []
        self._queue: Optional[queue.Queue] = queue.Queue() if cfg.async_writes else None
        self._thread: Optional[threading.Thread] = None
        self._held = 0  # snapshots between their copy and the end of their write
        self._copying: List[_Job] = []  # device-to-host copies not yet seen done
        self._free: List[Dict[str, torch.Tensor]] = []  # pinned buffer sets to reuse
        self._returned: List[Dict[str, torch.Tensor]] = []  # given back by the writer
        self._side = None  # the device-to-host copy stream
        self._closed = False

    # ------------------------------------------------------------ public --

    def describe(self) -> Dict[str, Any]:
        """The run_meta header's ``snapshot`` block (schema v11)."""
        out = self.cfg.as_dict()
        out["prefix"] = self.prefix
        if self._disarmed:
            out["disarmed"] = self._disarmed
        elif self.world_size > 1:
            out["writer_rank"] = 0  # every rank captures, rank 0 writes
        return out

    @property
    def armed(self) -> bool:
        """This rank takes part in the snapshots (every rank of one host
        does: the capture is a collective)."""
        return self.cfg.enabled and not self._disarmed

    @property
    def writes(self) -> bool:
        """This rank writes the files (rank 0)."""
        return self.armed and self.rank == 0

    def has_room(self) -> bool:
        """A due snapshot would be taken now (fewer than ``inflight``
        held); rank 0's answer is the one the loop agrees on."""
        self._advance()
        return self._held < self.cfg.inflight

    def begin_epoch(self, epoch: int, start_step: int = 0) -> None:
        """Reset the cadence for ``epoch`` (a resumed epoch passes the
        cursor's step: the next snapshot is one cadence later)."""
        self._next_due = int(start_step) + self.cfg.every_steps

    def maybe(self, capture: Callable, *, epoch: int, step: int, plan_key,
              acc=None, room: Optional[bool] = None) -> bool:
        """Snapshot at ``(epoch, step)`` if the cadence is due; never waits
        for the writer (a full engine skips, counted). ``acc`` maps the
        partial sums' names to tensors, or is a callable returning that map
        (called, like ``capture``, only when a snapshot is taken: at world >
        1 both gather). ``room`` is the agreed answer of rank 0's
        :meth:`has_room` at world > 1 (None: this engine's own). Returns
        True when a snapshot was taken."""
        if not self.armed:
            return False
        t0 = time.perf_counter()
        self._advance()
        taken = False
        if step >= self._next_due:
            if not (self._held < self.cfg.inflight if room is None else room):
                self.stats["skipped_queue_full"] += 1
            else:
                from tpuddp_torch.observability import trace as trace_lib

                span = self.tracer.start_span(
                    "snapshot", trace_lib.KIND_ACTION, parent=self.trace_parent,
                    attrs={"epoch": int(epoch), "step": int(step),
                           "mode": "async" if self.cfg.async_writes else "sync"})
                job = _Job(capture(), acc() if callable(acc) else acc, epoch, step, plan_key)
                if not self.writes:
                    self.tracer.end_span(span)  # a collective taken part in; rank 0 writes
                elif self._queue is None:
                    job.cap = self._host_copy(job)
                    self._write(job)
                    self.tracer.end_span(span)
                else:
                    self._held += 1
                    self._copy(job)
                    self._advance()
                    self.tracer.end_span(span, enqueued=True)
                taken = True
                self.stats["taken"] += 1
                self._last_taken = (int(epoch), int(step))
                self._next_due = int(step) + self.cfg.every_steps
        self.stats["host_s"] += time.perf_counter() - t0
        return taken

    def flush(self) -> Optional[int]:
        """Wait until every snapshot taken is on disk; the step of the last
        one written (None before any). The drain calls it first: the work
        it waits for is already done."""
        for job in self._copying:
            job.done.synchronize()
        self._advance()
        if self._queue is not None and self._thread is not None:
            self._queue.join()
        self._reclaim()
        self.stats["flushes"] += 1
        return self.stats["last_step"]

    def final_snapshot(self, capture: Callable, *, epoch: int, step: int, plan_key,
                       acc=None) -> Optional[str]:
        """The drain's final delta: flush, then write the state at ``(epoch,
        step)`` inline; its path (None off rank 0 or disarmed). Every rank
        captures (a collective) unless the snapshot taken last, on every
        rank alike, is this one."""
        self.flush()
        if not self.armed:
            return None
        if self._last_taken == (int(epoch), int(step)):
            return self.stats["last_path"] if self.writes else None  # the flush wrote it
        job = _Job(capture(), acc() if callable(acc) else acc, epoch, step, plan_key)
        if not self.writes:
            return None
        job.cap = self._host_copy(job)
        return self._write(job)

    def close(self) -> None:
        """Flush and stop the writer thread; idempotent."""
        if self._closed:
            return
        self.flush()
        self._closed = True
        if self._queue is not None and self._thread is not None:
            self._queue.put(_STOP)
            self._thread.join(timeout=60)
        self._free.clear()
        if self._errors:
            logger.warning("snapshot writer finished with %d error(s); first: %s",
                           len(self._errors), self._errors[0])

    # ----------------------------------------------------------- private --

    @staticmethod
    def _tensors(job: _Job) -> Dict[str, torch.Tensor]:
        out = dict(job.cap.tensors)
        out.update((f"acc/{k}", v) for k, v in (job.acc or {}).items())
        return out

    @staticmethod
    def _split(job: _Job, tensors: Dict[str, torch.Tensor]) -> None:
        job.acc = {k[4:]: tensors.pop(k) for k in [k for k in tensors if k.startswith("acc/")]}
        job.cap = dataclasses.replace(job.cap, tensors=tensors)

    def _host_copy(self, job: _Job):
        """The job's tensors read to the host now (a wait for the device):
        the synchronous writer and the drain's final delta."""
        tensors = {k: t.detach().to("cpu", copy=True) for k, t in self._tensors(job).items()}
        self._split(job, tensors)
        return job.cap

    def _copy(self, job: _Job) -> None:
        """Clone the job's tensors on the current stream; on a GPU copy the
        clones to pinned host buffers on the side stream and record the
        event the loop's thread polls."""
        tensors = self._tensors(job)
        if not any(t.is_cuda for t in tensors.values()):
            self._split(job, {k: t.detach().clone() for k, t in tensors.items()})
            self._hand_over(job)
            return
        clones = {k: t.detach().clone() for k, t in tensors.items()}
        self._reclaim()
        buffers = self._free.pop() if self._free else None
        if buffers is None or any(buffers[k].shape != t.shape or buffers[k].dtype != t.dtype
                                  for k, t in clones.items() if k in buffers) \
                or set(buffers) != set(clones):
            buffers = {k: torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                       for k, t in clones.items()}
        if self._side is None:
            self._side = torch.cuda.Stream(device=next(iter(clones.values())).device)
        self._side.wait_stream(torch.cuda.current_stream(self._side.device))
        with torch.cuda.stream(self._side):
            for k, t in clones.items():
                buffers[k].copy_(t, non_blocking=True)
            job.done = torch.cuda.Event()
            job.done.record(self._side)
        job.clones, job.buffers = clones, buffers
        self._split(job, dict(buffers))
        self._copying.append(job)

    def _advance(self) -> None:
        """Hand every copy whose event has completed to the writer (the
        loop's thread; ``query()`` never waits)."""
        while self._copying and self._copying[0].done.query():
            job = self._copying.pop(0)
            job.clones = None  # the side stream is done with them
            self._hand_over(job)

    def _hand_over(self, job: _Job) -> None:
        self._ensure_thread()
        self._queue.put(job)

    def _reclaim(self) -> None:
        with self._lock:
            self._free.extend(self._returned)
            self._returned.clear()

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._worker, name="tpuddp-snapshot-writer",
                                            daemon=True)
            self._thread.start()

    def _worker(self) -> None:
        while True:
            job = self._queue.get()
            try:
                if job is _STOP:
                    return
                self._write(job)
            except Exception as e:  # noqa: BLE001 — a failed snapshot must not stop training
                logger.exception("snapshot write failed: %s", e)
                self._errors.append(str(e))
            finally:
                if job is not _STOP:
                    with self._lock:
                        self._held -= 1
                        if job.buffers is not None:
                            self._returned.append(job.buffers)
                self._queue.task_done()

    def _peer_dir(self) -> Optional[str]:
        hb = ckpt.heartbeat_dir(self.save_dir)
        if not hb:
            return None
        ring = (self.host + 1) % self.hosts  # the host's neighbour (the JAX process ring)
        return os.path.join(hb, "peer_ckpt", f"ring_{ring}")

    def _spill_peer(self, path: str) -> None:
        """Copy the written snapshot (payload and manifest) into the ring
        neighbour's directory, each file atomically; a failed spill is
        logged, never raised."""
        peer = self._peer_dir()
        if peer is None:
            return
        try:
            os.makedirs(peer, exist_ok=True)
            for src in (path, ckpt.manifest_path(path)):
                if not os.path.exists(src):
                    continue
                dst = os.path.join(peer, os.path.basename(src))
                shutil.copyfile(src, dst + ".tmp")
                os.replace(dst + ".tmp", dst)
            if self.keep_last is not None:
                ckpt.prune_checkpoints(peer, self.keep_last, self.prefix)
        except OSError as e:
            logger.warning("peer-redundant spill to %s failed: %s", peer, e)

    def _write(self, job: _Job) -> str:
        """Write one snapshot (the writer thread's body; inline for the
        synchronous mode and the final delta) through the synchronous
        save's writer: the same bytes."""
        t0 = time.perf_counter()
        cursor = {"version": ckpt.FORMAT_VERSION, "epoch": job.epoch, "step": job.step,
                  "plan_key": job.plan_key}
        acc = {k: ckpt._bits(v) for k, v in (job.acc or {}).items()}
        path = ckpt.write_captured(self.save_dir, job.epoch, job.cap, snapshot_step=job.step,
                                   cursor=cursor, cursor_acc=acc or None,
                                   keep_last=self.keep_last)
        if self.cfg.peer_redundancy:
            self._spill_peer(path)
        with self._lock:
            self.stats["snapshots"] += 1
            self.stats["write_s"] += time.perf_counter() - t0
            try:
                self.stats["bytes"] += os.path.getsize(path)
            except OSError:
                pass
            self.stats.update(last_epoch=job.epoch, last_step=job.step, last_path=path)
            sidecar = {
                "async": self.cfg.async_writes, "inflight": self.cfg.inflight,
                "peer_redundancy": self.cfg.peer_redundancy,
                "snapshots": self.stats["snapshots"],
                "skipped_queue_full": self.stats["skipped_queue_full"],
                "write_s": round(self.stats["write_s"], 6), "bytes": self.stats["bytes"],
                "host_s": round(self.stats["host_s"], 6),
            }
        try:
            tmp = writer_stats_path(path) + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(sidecar, f, sort_keys=True)
            os.replace(tmp, writer_stats_path(path))
        except OSError:
            pass
        if self.flight is not None:
            self.flight.note(snapshot_last={"epoch": job.epoch, "step": job.step,
                                            "path": os.path.basename(path)})
        return path
