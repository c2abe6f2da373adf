"""Epoch driver — a trimmed counterpart of ``tpuddp/training/loop.py``
(the reference's ``run_training_loop``, multi-GPU-training-torch.py:156-225).

Per epoch: ``set_epoch`` reshuffle, optional RNG probe, train pass, eval
pass, per-replica loss lines, one all-reduce of the epoch sums, the process-0
epoch line, and a rank-0 checkpoint when ``epoch % checkpoint_epoch == 0``
(quirk Q6 kept: it fires at epoch 0). The process-0 log lines are the JAX
package's, byte for byte (``loop.py:799-806, 978-990, 1072-1076``).

``scan_steps`` (``tpuddp/training/loop.py:55-98, :238-270``) is K, the
batches of one dispatch: ``auto`` is up to 64 (32 when neither the
parameter bytes are small nor the batch bytes known), capped by the staging
budget over one batch's bytes and by the pass's batch count; an integer
pins it; 1 runs one step per batch. The train pass and the eval pass each
resolve it over their own batch count. A pass is dispatched as the JAX
``run_pass`` dispatches it (``tpuddp/training/pipeline.py:227-420``,
:func:`dispatches`): full chunks of K batches, each one dispatch
(``ddp.train_step_many``/``eval_step_many``: one CUDA-graph replay on a GPU,
the same steps one after another on the CPU), then the remainder as single
steps.

Under gradient accumulation (``ddp.grad_accumulation = A > 1``) an epoch is
whole cycles of A micro-batches: K is rounded to a multiple of A within the
staging budget (at least one cycle), and a ragged tail is padded with
all-padding micro-batches to whole cycles (``tpuddp/training/pipeline.py:
209-220``) and run as one dispatch, so an epoch makes ``ceil(len(train_loader)
/ A)`` updates (``tpuddp/training/loop.py:1006-1008``). With ``scan_steps:
1`` the chunks are single cycles, run as before through ``ddp.train_cycle``.

Both passes take their batches through :class:`~tpuddp_torch.training.
pipeline.StagedLoader`: each host batch is copied from pinned memory without
blocking, ``pipeline.depth`` batches ahead of its step (``pipeline: false``
stages each batch just before its step and synchronises after it).

Each history row also carries the train pass's times per update in
milliseconds (``step_ms``, one entry per update): on the GPU from CUDA
events recorded between dispatches, read once after the pass, so the loop
adds no synchronisation per update; a dispatch of K updates (a replay)
gives each of them its time over K. Also the time the pass waited for host
batches (``host_stall_s``) and the resolved ``scan_steps`` of both passes.
Process 0 appends every row to ``save_dir/history.jsonl`` in the JAX
package's typed schema (``tpuddp/training/loop.py:399-520``;
:mod:`tpuddp_torch.observability`): a ``run_meta`` header at the loop's
start (a resumed run appends a fresh one), ``epoch`` rows with the
step-time percentiles over ``step_ms`` and MFU, one ``step_stats`` row per
``step_stats_every`` updates (one wait for the device per window; none
with 0) and ``event`` rows; ``$TPUDDP_PROFILE``, ``$TPUDDP_PROFILE_STEPS``
and SIGUSR1 trace through ``torch.profiler``. Each row also says
whether the update was sharded (``weight_update_sharding``, ZeRO-1: each
checkpoint then gathers the moment shards from every rank), the comm hook
and one update's gradient wire bytes with it and in float32
(``grad_comm_bytes_per_update``, ``_f32``, as the JAX rows name them),
the top-k density (``comm_density``), the topology, and the bytes' split
by link (``grad_comm_bytes_inter_host``, ``grad_comm_bytes_intra_host``).

Resume (``tpuddp/training/loop.py:271-359``): with ``auto_resume`` (or
``$TPUDDP_AUTO_RESUME``) the newest intact ``ckpt_{epoch}.npz`` in
``save_dir`` is restored (parameters, buffers, the optimizer's state, the
micro-batch count, every rank's random streams, the comm hook's
error-feedback residual, which the wrap's graphs hold and update in place)
and the run continues at the epoch after it; ``keep_last=K`` keeps the K
newest checkpoints after each save. Every process resumes and rolls back
from the file process 0 finds (``checkpoint.agreed_latest``), so across
hosts ``save_dir`` must be one shared filesystem.

The numerical guard (``ddp.guard``; ``tpuddp/training/loop.py:548-625,
:760-795, :1026-1110``): one counter fetch per epoch gives the row's
``skipped_steps`` (the total) and ``skipped_steps_epoch``, and a
``skipped_updates`` event for an epoch with skips; ``audit_every_n_epochs``
audits the replicas at the start of those epochs (a ``desync`` event, then
``ReplicaDesync``, or a rollback with ``on_desync: rollback``); more than
``max_consecutive_skips`` consecutive skips at an epoch's end restore the
newest intact checkpoint and redo the epoch from there (a ``rollback``
event; ``set_epoch`` re-derives its order), at most ``max_rollbacks``
times (then ``RuntimeError``), or raise ``FloatingPointError`` without a
checkpoint. ``$TPUDDP_FAULT=nan@step=N`` poisons the host micro-batch of
global train index N from the loop's entry before it is staged, so a chunk
carries it as any batch. Rows are strict JSON: a non-finite loss is null.

The preemption drain and step snapshots (``tpuddp/training/loop.py:
303-360, :612-708, :759-1000``): at world 1 every pass polls the drain
flag (SIGTERM, SIGINT, ``$TPUDDP_FAULT=preempt@step=N``) before it stages a
batch and stops after the last dispatch issued. At world > 1 on one host
(the JAX package's one process with N devices) rank 0's flag is agreed
after every dispatch of both passes (:class:`AgreedPoll`, one broadcast on
a Gloo group of CPU tensors, which also carries whether rank 0's snapshot
engine has room), and every pass polls that verdict, so all ranks stop
after the same dispatch. Across hosts no pass polls, and the drain is
decided at each epoch's start on rank 0's flag (one broadcast). The drain
writes one save (a collective: every rank captures, rank 0 writes) and
raises ``TrainingPreempted``
(exit 75 in ``parallel/spawn.py``): a cut train pass saves
``ckpt_{epoch}.npz`` with ``completed=0`` (the epoch is redone), or, with
``training.snapshot`` armed, flushes the snapshot writer and writes the
final step snapshot at the drained step; a cut eval pass writes the
epoch's row with null eval metrics and saves the epoch as done; then a
``preempt`` event row, fsync'd. With ``training.snapshot`` the engine
snapshots every ``every_steps`` real micro-batches after a dispatch's
telemetry (between chunks under replay). A resume whose file carries a
cursor with this epoch's plan key (keyed on every rank of the host, so all
ranks agree on it) continues the epoch at its step through
``EpochTailLoader``, each rank's train sums seeded from its entry of the
cursor's per-replica sums: the rows are bitwise an uninterrupted run's; a
mismatched key redoes the epoch. A guard rollback to a step snapshot
continues that epoch at its step.

The elastic resume (``tpuddp/training/loop.py:321-395, :435-441, :493,
:576``): a checkpoint written at another world size is refitted onto this
one by ``checkpoint.restore_latest`` (the error-feedback residual
redistributed, ZeRO-1's moments re-padded), whose ``topology_change`` and
``comm_state_reset`` rows follow the run's header (which then carries
``resumed_from_world`` and ``resumed_from_model``) or the guard's
``rollback`` row. With ``reshard_on_mismatch`` a file of another ``(data,
model)`` shape is reshaped on load (``training/reshard.py``).

Tensor parallelism (a wrap with ``model_size > 1``): the metric sums and
the per-replica lines are the data group's (each data replica's, as the
JAX package's per-replica metrics; model-axis neighbours hold the same
batch), the header's ``mesh`` block is the wrap's, and step snapshots are
refused (ROADMAP.md Queue 1 item 8: tensor parallel, part 2).
"""

from __future__ import annotations

import logging
import math
import os
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from tpuddp_torch import optim, seeding
from tpuddp_torch.config import resolve_observability
from tpuddp_torch.observability import CommBytesCounter, MetricsWriter, RunTelemetry, schema
from tpuddp_torch.observability import aggregate as agg_lib
from tpuddp_torch.observability import exporter as exp_lib
from tpuddp_torch.observability import flight as flight_lib
from tpuddp_torch.observability import trace as trace_lib
from tpuddp_torch.observability.recorder import count_step_flops
from tpuddp_torch.parallel import backend
from tpuddp_torch.parallel import collectives as col
from tpuddp_torch.resilience import faults, preemption
from tpuddp_torch.resilience import guard as guard_lib
from tpuddp_torch.resilience import watchdog as wd_lib
from tpuddp_torch.resilience.preemption import TrainingPreempted
from tpuddp_torch.training import checkpoint as ckpt
from tpuddp_torch.training import pipeline as pipeline_lib
from tpuddp_torch.training import snapshot as snapshot_lib
from tpuddp_torch.training.step import EVAL_KEYS, TRAIN_KEYS, finalize_metrics
from tpuddp_torch.utils import batching

logger = logging.getLogger("tpuddp")

AUTO_SCAN_CAP = 64  # the JAX package's auto depth (tpuddp/training/loop.py:55)
AUTO_SCAN_FALLBACK_CAP = 32  # when the staged chunk's size cannot be known
SMALL_PARAM_BYTES = 4 * 1024 * 1024


def resolve_scan_steps(scan_steps, n_batches: int, param_bytes=None, batch_nbytes=None) -> int:
    """K, the batches of one dispatch (``tpuddp/training/loop.py:68-98``):
    ``auto`` (or None) is 64 when the parameters take under 4 MiB or one
    batch's input bytes are known, else 32; capped by the staging budget
    over those bytes and by ``n_batches``. An integer pins K (>= 1)."""
    if scan_steps in (None, "auto"):
        small = param_bytes is not None and param_bytes < SMALL_PARAM_BYTES
        cap = AUTO_SCAN_CAP if (small or batch_nbytes) else AUTO_SCAN_FALLBACK_CAP
        cap = batching.resolve_fuse(batch_nbytes, cap=cap)
        return max(1, min(cap, n_batches))
    k = int(scan_steps)
    if k < 1:
        raise ValueError(f"scan_steps must be >= 1 or 'auto', got {scan_steps!r}")
    return k


def scan_steps_in_cycles(k: int, accum: int, batch_nbytes=None) -> int:
    """K under accumulation (``tpuddp/training/loop.py:250-270``): a
    multiple of ``accum``, at least one cycle, and inside the staging budget
    over ``batch_nbytes`` in whole cycles where that allows one cycle (a
    warning when even one cycle exceeds it)."""
    if accum <= 1:
        return k
    k = max(accum, (k // accum) * accum)
    budget = batching.STAGE_BYTES_BUDGET
    if batch_nbytes and k * batch_nbytes > budget:
        k = max(accum, (budget // batch_nbytes) // accum * accum)
        if k * batch_nbytes > budget:
            logger.warning(
                "gradient_accumulation_steps=%d forces a staged chunk of %.0f MB (one whole "
                "cycle), over the ~%d MB staging budget", accum, k * batch_nbytes / 1e6,
                budget // 2**20,
            )
    return k


def dispatches(batches, k: int, accum: int = 1):
    """The dispatch plan of a pass (``tpuddp/training/pipeline.py:227-420``):
    yields ``(many, chunk)``. Full chunks of ``k`` batches are one dispatch
    each (``many``); under ``accum > 1`` a ragged tail is padded with
    all-padding copies of its last batch to whole cycles and is one
    dispatch; otherwise the remainder is single steps. With ``k <= 1`` and
    no accumulation every batch is a single step. A pass ``batches`` marks
    ``interrupted`` (the preemption drain) ends after the last dispatch
    issued: a partial chunk is dropped with the staged batches."""
    if k <= 1 and accum <= 1:
        for batch in batches:
            yield False, [batch]
        return
    chunk = []
    for batch in batches:
        chunk.append(batch)
        if len(chunk) == k:
            yield True, chunk
            chunk = []
    if getattr(batches, "interrupted", False):
        return
    if chunk and accum > 1:
        x, y, w = chunk[-1]
        yield True, chunk + [(x, y, torch.zeros_like(w))] * (-len(chunk) % accum)
        return
    for batch in chunk:
        yield False, [batch]


class StepClock:
    """Marks between dispatches; CUDA events on the GPU, the host clock on
    the CPU. ``groups`` holds each dispatch's update count; ``step_ms()``
    gives each update its dispatch's time over that count."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []
        self.groups = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def fence(self):
        """A mark taken now and waited for (not one of ``marks``): the
        ``step_stats`` window's one wait."""
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ev.synchronize()
        return ev

    def seconds(self, a, b) -> float:
        """Seconds from mark ``a`` to a completed mark ``b``."""
        return a.elapsed_time(b) / 1e3 if self.cuda else b - a

    def step_ms(self):
        if self.cuda:
            self.marks[-1].synchronize()
            ms = [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        else:
            ms = [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]
        return [t / k for t, k in zip(ms, self.groups) for _ in range(k)]


def _count(v: float):
    return int(v) if math.isfinite(v) else v


def _per_replica_lines(sums: torch.Tensor, world_size: int, log, group=None) -> None:
    """The reference's per-replica loss lines (:186-191), on process 0; the
    replicas are ``group``'s (a tensor-parallel rank's data group) when
    given."""
    if group is not None:
        world_size = dist.get_world_size(group)
    if dist.is_initialized() and world_size > 1:
        parts = [torch.empty_like(sums) for _ in range(world_size)]
        dist.all_gather(parts, sums, group=group)
    else:
        parts = [sums]
    if dist.is_initialized() and dist.get_rank() != 0:
        return
    rows = [p.tolist() for p in parts]
    nt = len(TRAIN_KEYS)
    for r, row in enumerate(rows):
        loss_sum, n = row[0], row[1]
        log(f"Train loss on replica {r}: {loss_sum / max(n, 1):.4f} "
            f"based on {_count(n)} samples")
    for r, row in enumerate(rows):
        loss_sum, n = row[nt], row[nt + EVAL_KEYS.index("n")]
        log(f"Test loss on replica {r}: {loss_sum / max(n, 1):.4f} "
            f"based on {_count(n)} samples")


def event(name: str, **fields) -> dict:
    """A typed history event row (``{"type": "event", "event": name, ...}``,
    stamped with the schema version)."""
    return schema.stamp("event", {"event": name, **fields})


def step_fault_hook():
    """The ``$TPUDDP_FAULT`` hook of the train pass (None when no step fault
    is armed): each host micro-batch counted from the loop's entry;
    ``preempt@step=N`` asks for the drain there (the poll that follows stops
    the pass before batch N is staged), ``crash@step=N`` exits 113 there,
    ``nan@step=N`` poisons it."""
    if not faults.has_step_fault():
        return None
    counter = {"i": 0}

    def inject(host_batch):
        i = counter["i"]
        counter["i"] += 1
        faults.maybe_fire("step", step=i)
        return faults.maybe_corrupt_batch(host_batch, i)

    return inject


class AgreedPoll:
    """The drain flag agreed at a dispatch boundary at world > 1 on one host
    (the JAX package's one-process branch, ``tpuddp/training/loop.py:
    625-630``, where one process polls for all its devices). Signals land on
    the ranks apart, and a rank that stopped alone would leave the others in
    the step's collectives, so :meth:`exchange` broadcasts rank 0's flag,
    with rank 0's snapshot room (``engine.has_room()``: whether a due
    snapshot is taken or skipped, which every rank must decide alike, as
    the capture is a collective). The exchange is one broadcast of two
    int32 on a Gloo group of CPU tensors, made once here: no read of the
    device, so the staged pipeline keeps its depth. Calling the object
    reads the last agreed verdict without a collective (the staged
    loader's poll, consulted before each batch is staged). The drain flag
    is sticky. ``exchanges`` and ``seconds`` count the exchanges and their
    host time."""

    def __init__(self, engine=None):
        self.engine = engine
        self.rank = dist.get_rank()
        self.group = dist.new_group(backend="gloo")
        self.box = torch.zeros(2, dtype=torch.int32)
        self.drain = False
        self.room = True
        self.exchanges = 0
        self.seconds = 0.0

    def exchange(self) -> bool:
        """One agreement; returns the drain verdict."""
        t0 = time.perf_counter()
        if self.rank == 0:
            engine = self.engine
            self.box[0] = int(preemption.preemption_requested())
            self.box[1] = int(engine is None or not engine.armed or engine.has_room())
        dist.broadcast(self.box, src=0, group=self.group)
        self.drain = self.drain or bool(self.box[0])
        self.room = bool(self.box[1])
        self.exchanges += 1
        self.seconds += time.perf_counter() - t0
        return self.drain

    def __call__(self) -> bool:
        return self.drain

    def describe(self) -> str:
        ms = 1e3 * self.seconds / max(self.exchanges, 1)
        return f"agreed poll: {self.exchanges} exchanges, {ms:.6f} ms each"


def agreed_poll(world_size: int, engine=None) -> Optional[AgreedPoll]:
    """The :class:`AgreedPoll` of a world over 1 on one host; None at world
    1 (the flag itself is the poll) and across hosts (no poll inside a pass:
    the drain is decided at the epoch boundary, the JAX package's
    multi-process branch)."""
    if world_size == 1 or (backend.num_hosts() or 1) > 1 or not dist.is_initialized():
        return None
    return AgreedPoll(engine)


def host_ranks(world_size: int):
    """The global ranks of one host when the run has one host (the ranks
    one JAX process would serve: the step snapshots' plan key); None
    across hosts (each rank's own key)."""
    return list(range(world_size)) if (backend.num_hosts() or 1) == 1 else None


def drain_requested(world_size: int, device, agreed: Optional[AgreedPoll] = None) -> bool:
    """Rank 0's drain flag on every rank (one broadcast of one int at world
    > 1: signals land on the ranks apart, and all must agree before the
    save's collectives; ``tpuddp/training/loop.py:626-639``); through
    ``agreed`` when there is one."""
    if agreed is not None:
        return agreed.exchange()
    flag = preemption.preemption_requested()
    if world_size == 1 or not dist.is_initialized():
        return flag
    box = torch.tensor([int(flag)], device=device)
    dist.broadcast(box, src=0)
    return bool(box.item())


def _replica_entry(values, rank: int) -> np.ndarray:
    """A cursor's partial sum for ``rank``: its entry of a per-replica
    vector (entry 0 of a world-1 one)."""
    flat = np.asarray(values, np.float32).reshape(-1)
    return flat[rank:rank + 1] if flat.size > rank else flat[:1]


def _log_drain_stats(rank: int, engine, agreed: Optional[AgreedPoll]) -> None:
    """One line per rank on stderr (each rank writes it whole, so the
    ranks' lines never split the epoch lines on stdout): the snapshots
    taken and skipped, the loop's time in the engine, and the agreed
    poll's exchanges."""
    parts = [f"rank {rank}"]
    if engine is not None:
        st = engine.stats
        parts.append(f"snapshot engine: {st['taken']} taken, {st['snapshots']} written, "
                     f"{st['skipped_queue_full']} skipped, host_s {st['host_s']:.6f}")
    if agreed is not None:
        parts.append(agreed.describe())
    print("; ".join(parts), file=sys.stderr, flush=True)


def observability_meta(obs_cfg: dict, exporter, flight) -> dict:
    """The run_meta header's ``observability`` field from the live objects
    (``tpuddp/training/loop.py:452-460``): the exporter's bound endpoint
    and the flight recorder's capacity, or False where they are off."""
    return {
        "exporter": exporter.describe() if exporter is not None else False,
        "aggregate": bool(obs_cfg["aggregate"]),
        "straggler_ratio": float(obs_cfg["straggler_ratio"]),
        "straggler_windows": int(obs_cfg["straggler_windows"]),
        "flight_recorder": flight.describe() if flight is not None else False,
    }


def live_plane(obs_cfg: dict, save_dir: Optional[str], hosts: int, leader: bool, is_main: bool,
               writer):
    """``(aggregator, shard_dir)`` of a run (``tpuddp/training/loop.py:
    513-539``): with ``aggregate`` on and more than one host, each host's
    leader publishes its shard into the heartbeat directory
    (:func:`~tpuddp_torch.resilience.watchdog.heartbeat_dir`) and process 0
    merges the shards into ``writer``'s history; else ``(None, None)``."""
    if not (obs_cfg["aggregate"] and hosts > 1 and leader):
        return None, None
    shard_dir = wd_lib.heartbeat_dir(save_dir)
    if shard_dir is None:
        return None, None
    os.makedirs(shard_dir, exist_ok=True)
    aggregator = None
    if is_main:
        aggregator = agg_lib.PodAggregator(
            shard_dir, hosts, writer=writer, straggler_ratio=float(obs_cfg["straggler_ratio"]),
            straggler_windows=int(obs_cfg["straggler_windows"]))
    return aggregator, shard_dir


def collective_attrs(ddp) -> Optional[dict]:
    """The attributes of a train dispatch's ``collective`` annotation spans
    (``tpuddp/training/loop.py:718-760``), or None without a comm hook and
    without the segmented overlap: the hook, the topology and the bucket
    plan's wire bytes per update (host integers), and under the overlap
    each segment's layers, flat range and bucket count."""
    overlap_on = bool((getattr(ddp, "comm_overlap_meta", None) or {}).get("enabled"))
    hook = getattr(ddp, "comm_hook", "none")
    if hook == "none" and not overlap_on:
        return None
    attrs = {
        "hook": hook,
        "topology": getattr(ddp, "comm_topology", "flat"),
        "wire_bytes_per_update": getattr(ddp, "grad_comm_bytes_per_step", None),
        "wire_bytes_per_update_f32": getattr(ddp, "grad_comm_bytes_per_step_f32", None),
        "inter_host_bytes_per_update": getattr(ddp, "grad_comm_bytes_inter_host", None),
    }
    if overlap_on:
        attrs["overlap"] = True
        attrs["segments"] = [
            {"segment": i, "layers": list(seg.layers), "flat": list(seg.flat),
             "buckets": len(seg.buckets)}
            for i, seg in enumerate(ddp._overlap.segments)
        ]
    return attrs


def annotate_collectives(tracer, parent, comm_attrs: dict, updates: int) -> None:
    """A train dispatch's zero-length ``collective`` spans, nested in it:
    ``grad_comm``, or ``grad_comm.seg{k}`` per segment of the overlap. The
    exchange runs inside the step, so the host cannot time it; the spans
    carry what the plan counts (``tpuddp/training/pipeline.py:316-344``)."""
    segs = comm_attrs.get("segments")
    if segs:
        shared = {k: v for k, v in comm_attrs.items() if k != "segments"}
        for seg in segs:
            tracer.end_span(tracer.start_span(
                f"grad_comm.seg{seg['segment']}", trace_lib.KIND_COLLECTIVE, parent=parent,
                attrs={**shared, **seg, "updates": updates}))
    else:
        tracer.end_span(tracer.start_span("grad_comm", trace_lib.KIND_COLLECTIVE, parent=parent,
                                          attrs={**comm_attrs, "updates": updates}))


def _host_rows(chunk, world_size: int, hosts: int) -> int:
    """A dispatch's rows on this host (every rank of a host holds batches
    of one shape): the JAX process's host batch rows."""
    return sum(len(b[1]) for b in chunk) * (world_size // hosts)


def _sync_readback(staged, tracer, parent) -> None:
    """Under ``sync_readback`` the dispatch's wait for the device, a
    ``readback`` span nested in its dispatch span."""
    if staged.cfg.sync_readback:
        rsp = tracer.start_span("readback", trace_lib.KIND_READBACK, parent=parent)
        staged.fence()
        tracer.end_span(rsp, sync=True)


def _prober(loader, every: Optional[int], log):
    """The shard-disjointness probe of every ``every``-th host batch."""
    def probe(batch_idx, batch):
        if every and batch_idx % every == 0:
            log(f"TRAIN: Batch {batch_idx}, Data {loader.probe_fingerprint(batch[0])}")

    return probe


def run_training_loop(
    ddp,
    train_loader,
    test_loader,
    save_dir: Optional[str],
    num_epochs: int = 20,
    checkpoint_epoch: int = 5,
    set_epoch: bool = True,
    print_rand: bool = False,
    data_probe_every: Optional[int] = None,
    per_replica_log: bool = False,
    base_seed: Optional[int] = None,
    auto_resume: bool = False,
    keep_last: Optional[int] = None,
    pipeline=None,
    scan_steps="auto",
    step_stats_every: int = 0,
    run_meta: Optional[dict] = None,
    model_input: Optional[tuple] = None,
    snapshot=None,
    observability=None,
    reshard_on_mismatch: bool = False,
    log=print,
):
    """Run the epochs from the first not yet done (0 unless resumed) to
    ``num_epochs``; returns the list of per-epoch records. ``run_meta``
    holds the entry point's header fields (config_hash, model, dataset);
    ``model_input`` is one train batch's ``(shape, dtype)`` as the model
    takes it, which the telemetry counts an update's FLOPs on (MFU is
    null without it); ``snapshot`` the ``training.snapshot`` block;
    ``observability`` the settings file's ``observability`` block (the
    live plane, :func:`tpuddp_torch.config.resolve_observability`);
    ``reshard_on_mismatch`` the ``training`` knob (a resume reshapes a
    checkpoint of another ``(data, model)`` shape)."""
    rank, world_size, device = ddp.rank, ddp.world_size, ddp.device
    model_size = int(getattr(ddp, "model_size", 1) or 1)
    metrics_group = getattr(ddp, "metrics_group", None)
    accum = int(getattr(ddp, "grad_accumulation", 1) or 1)
    pipeline = pipeline_lib.resolve_pipeline(pipeline)
    param_bytes = sum(p.numel() * p.element_size() for p in ddp.model.parameters())
    eval_k = resolve_scan_steps(scan_steps, len(test_loader), param_bytes,
                                getattr(test_loader, "batch_nbytes", None))
    train_nbytes = getattr(train_loader, "batch_nbytes", None)
    train_k = resolve_scan_steps(scan_steps, len(train_loader), param_bytes, train_nbytes)
    chunked = train_k > 1  # else one step (one cycle) per dispatch, as before
    train_k = scan_steps_in_cycles(train_k, accum, train_nbytes)
    is_main = rank == 0
    residual = getattr(ddp, "residual", None)
    counters = None if getattr(ddp, "firewall", None) is None else ddp.firewall.counters

    replicated = getattr(ddp, "mode", "shard_map") == "auto"  # mode auto's one residual

    def capture():
        """The live state as a save writes it (the snapshot engine copies
        it); a collective at world > 1."""
        return ckpt.capture(ddp.model, ddp.optimizer, seed=base_seed, generator=ddp.generator,
                            world_size=world_size, step=ddp.step, comm_state=residual,
                            skipped=counters, residual_replicated=replicated)

    hosts = backend.num_hosts() or 1
    host = rank // (world_size // hosts)
    # the live plane (tpuddp/training/loop.py:229-545): in each host's local
    # rank 0, the process standing for the JAX package's one process of that
    # host: the flight recorder (before the writer, which tees into it),
    # the tracer, the exporter, this host's shard; process 0 aggregates
    obs_cfg = resolve_observability(observability)
    leader = backend.is_host_leader()
    tracer = (trace_lib.tracer_from_config(obs_cfg, "train", run_dir=save_dir) if leader
              else trace_lib.NULL_TRACER)
    flight = None
    if leader and obs_cfg["flight_recorder"] and save_dir is not None:
        flight = flight_lib.install(flight_lib.FlightRecorder(
            save_dir, capacity=int(obs_cfg["flight_capacity"]), process_index=host))
        if tracer.enabled:  # a dump names the spans still open: where the process died
            flight.add_context("open_spans", tracer.open_span_summaries)
    # step snapshots (training/snapshot.py): device copies between
    # dispatches, a background writer; pending["c"] carries a restored v4
    # cursor to the epoch it continues (tpuddp/training/loop.py:303-359)
    snap_cfg = snapshot_lib.resolve_snapshot(snapshot)
    if snap_cfg.enabled and model_size > 1:
        raise NotImplementedError(
            "training.snapshot of a parallel.model > 1 job is not implemented in tpuddp_torch "
            "yet (ROADMAP.md Queue 1 item 8: tensor parallel, part 2)")
    snap_engine = None
    if snap_cfg.enabled and save_dir is not None:
        snap_engine = snapshot_lib.SnapshotEngine(
            save_dir, snap_cfg, rank=rank, world_size=world_size, hosts=hosts,
            host=host, keep_last=keep_last, tracer=tracer, flight=flight)
    plan_ranks = host_ranks(world_size)
    pending = {"c": None}
    if is_main:
        log(f"Training on {len(train_loader)} batches, test on {len(test_loader)} batches")
    start_epoch = 0
    # the run is one trace, minted before the restore so that an elastic
    # reshard lands in the same tree as the epochs after it
    run_trace_id = tracer.new_trace()
    # an elastic restore's topology_change/comm_state_reset rows, written
    # after the run_meta header (tpuddp/training/loop.py:321-395, :493)
    reshard_log = []
    if auto_resume or ckpt.auto_resume_requested():
        if save_dir is None:
            if is_main:
                log("Auto-resume requested but no save_dir configured; starting fresh.")
        else:
            resume_span = tracer.start_span("auto-resume restore", trace_lib.KIND_ACTION,
                                            trace_id=run_trace_id, tid="train")
            cursors = []
            start_epoch, meta = ckpt.restore_latest(
                save_dir, ddp.model, ddp.optimizer, generator=ddp.generator,
                comm_state=residual, skipped=counters, cursor_out=cursors,
                reshard_log=reshard_log, model_size=model_size, residual_replicated=replicated,
                reshard_on_mismatch=reshard_on_mismatch,
            )
            pending["c"] = cursors[-1] if cursors else None
            ddp.step = meta.get("step", ddp.step)
            ddp.clear_graphs()  # the restore replaced what a graph writes
            if start_epoch > 0 and is_main:
                log(f"Auto-resume: continuing from epoch {start_epoch}.")
            if cursors and flight is not None:
                flight.note(snapshot_resume={
                    "epoch": cursors[-1].get("epoch"), "step": cursors[-1].get("step"),
                    "provenance": cursors[-1].get("provenance"),
                    "path": os.path.basename(cursors[-1].get("path") or "")})
            topo = next((ev for ev in reshard_log if ev.get("event") == "topology_change"), None)
            if topo is not None:  # the reshard on every surface: a span, a note, the rows
                keys = ("from_world", "to_world", "from_model", "to_model", "checkpoint")
                tracer.end_span(
                    tracer.start_span("elastic reshard", trace_lib.KIND_ACTION,
                                      parent=resume_span,
                                      attrs={k: topo.get(k) for k in keys + ("residual",)}),
                    resharded_leaves=len(topo.get("resharded_leaves") or ()))
                if flight is not None:
                    flight.note(elastic_reshard={k: topo.get(k) for k in keys})
            tracer.end_span(resume_span, resumed_epoch=start_epoch,
                            resharded=bool(reshard_log))
    # the drain flag, polled at every batch boundary at world 1; at world > 1
    # on one host agreed at every dispatch boundary (AgreedPoll: the staged
    # loaders read the last verdict); across hosts never inside a pass (one
    # rank stopping while the others issue the step's collectives would
    # wedge them): drain_requested decides at the epoch's start
    agreed = agreed_poll(world_size, snap_engine)
    poll = preemption.preemption_requested if world_size == 1 else agreed
    train_pass = pipeline_lib.StagedLoader(
        train_loader, device, pipeline, probe=_prober(train_loader, data_probe_every, log),
        inject=step_fault_hook(), poll=poll,
    )
    test_pass = pipeline_lib.StagedLoader(test_loader, device, pipeline, poll=poll)
    for staged_pass in (train_pass, test_pass):  # sync_readback: a wait in each dispatch span
        staged_pass.tracer, staged_pass.fence_in_consumer = tracer, True
    guard = getattr(ddp, "guard", guard_lib.DISABLED)
    prev_total = ddp.skip_counters()[0] if guard.enabled else 0
    rollbacks = 0
    # the typed history (tpuddp/training/loop.py:399-520): the run_meta
    # header first (a resumed run appends a fresh one), then the recorder
    # and the profiling triggers
    writer = MetricsWriter(save_dir, flight=flight)
    comm_counter = CommBytesCounter(getattr(ddp, "grad_comm_bytes_per_step", None))
    # the exporter binds before the header, which records the bound port
    exporter = (exp_lib.exporter_from_config(obs_cfg, run_dir=save_dir, process_index=host)
                if leader else None)
    if exporter is not None:
        exporter.start()
        if tracer.enabled:
            exporter.set_trace_source(tracer.endpoint_payload)
    writer.write(schema.make_run_meta(
        world_size=world_size,
        process_count=backend.num_hosts() or 1,
        process_index=rank // (world_size // (backend.num_hosts() or 1)),
        device_kind=torch.cuda.get_device_name(device) if device.type == "cuda" else None,
        hierarchy=getattr(ddp, "hierarchy", None),
        mesh=getattr(ddp, "mesh_block", None),
        comm_hook=getattr(ddp, "comm_hook", "none"),
        comm_topology=getattr(ddp, "comm_topology", "flat"),
        guard=guard,
        observability=observability_meta(obs_cfg, exporter, flight),
        tracing=tracer.describe(),
        comm={"overlap": dict(ddp.comm_overlap_meta)},
        snapshot=snap_engine.describe() if snap_engine is not None else False,
        extra={
            "api": "native",
            "scan_steps": scan_steps,
            "grad_accumulation": accum,
            "start_epoch": start_epoch,
            "num_epochs": num_epochs,
            "step_stats_every": int(step_stats_every or 0),
            "pipeline": pipeline.as_dict(),
            "grad_comm_bytes_per_update": comm_counter.bytes_per_update,
            "grad_comm_bytes_per_update_f32": getattr(ddp, "grad_comm_bytes_per_step_f32", None),
            "comm_density": getattr(ddp, "topk_density", None),
            "grad_comm_bytes_inter_host": getattr(ddp, "grad_comm_bytes_inter_host", None),
            "grad_comm_bytes_intra_host": getattr(ddp, "grad_comm_bytes_intra_host", None),
            **(run_meta or {}),
            # a run continued from another world (and model width)
            **ckpt.resumed_from(reshard_log, with_model=True),
        },
    ))
    for ev in reshard_log:
        writer.write(schema.stamp("event", ev))
    flops_fn = None
    if accum == 1 and model_input is not None:  # the JAX package's null under accumulation
        def flops_fn():
            return count_step_flops(ddp.model, *model_input)
    tel = RunTelemetry(writer, save_dir, step_stats_every, device, flops_fn)
    aggregator, shard_dir = live_plane(obs_cfg, save_dir, hosts, leader, is_main, writer)
    tel.attach_live(exporter=exporter, aggregator=aggregator, shard_dir=shard_dir,
                    process_id=host)
    comm_attrs = collective_attrs(ddp) if tracer.enabled else None

    def can_roll_back() -> bool:
        return save_dir is not None and ckpt.agreed_latest(save_dir, device=device) is not None

    def rollback(epoch: int, reason: str) -> int:
        """Restore the freshest intact checkpoint; the epoch to redo (a step
        snapshot's epoch continues at its step)."""
        nonlocal rollbacks
        rollbacks += 1
        if rollbacks > guard.max_rollbacks:
            raise RuntimeError(
                f"guard rollback limit ({guard.max_rollbacks}) exceeded; last trigger: {reason}. "
                "The failure recurs after restoring known-good state — a systematic divergence, "
                "not a transient."
            )
        cursors, reshard = [], []
        redo, meta = ckpt.restore_latest(
            save_dir, ddp.model, ddp.optimizer, generator=ddp.generator,
            comm_state=residual, skipped=ddp.firewall.counters, cursor_out=cursors,
            reshard_log=reshard, model_size=model_size, residual_replicated=replicated,
            reshard_on_mismatch=reshard_on_mismatch,
        )
        pending["c"] = cursors[-1] if cursors else None
        resume_step = pending["c"]["step"] if cursors else None
        ddp.step = meta.get("step", ddp.step)
        ddp.clear_graphs()  # the restore replaced what a graph writes
        writer.write(event("rollback", epoch=epoch, resume_epoch=redo, resume_step=resume_step,
                           reason=reason))
        for ev in reshard:
            writer.write(schema.stamp("event", ev))
        if is_main:
            log(f"Guard rollback ({reason}): restored last-good checkpoint, "
                f"redoing from epoch {redo}.")
            if resume_step is not None:
                log(f"Rollback target is a step snapshot: epoch {redo} continues at step "
                    f"{resume_step}.")
        return redo

    def emergency_stop(epoch: int, completed: bool = False, partial: Optional[dict] = None):
        """The drain (``tpuddp/training/loop.py:641-708``): one save, then
        :class:`TrainingPreempted`. ``completed=False`` marks a train pass
        cut mid-epoch (resume redoes the epoch from that state);
        ``completed=True`` an eval pass cut after every update of the epoch
        (resume starts at the next). With the snapshot engine armed, a cut
        train pass (``partial``: its step, plan key and sums) flushes the
        writer and writes a final step snapshot; resume continues at that
        step. The ``preempt`` event row is fsync'd before the raise."""
        path = None
        flushed = None
        snap_drain = snap_engine is not None and not completed and partial is not None
        if save_dir is not None:
            if snap_drain:
                flushed = snap_engine.flush()
                path = snap_engine.final_snapshot(
                    capture, epoch=epoch, step=int(partial["step"]),
                    plan_key=partial["plan_key"], acc=partial["acc"],
                )
                snap_drain = snap_engine.armed
            if not snap_drain:
                path = ckpt.save_on_main(
                    save_dir, epoch, ddp.model, ddp.optimizer, rank, seed=base_seed,
                    generator=ddp.generator, world_size=world_size, completed=completed,
                    step=ddp.step, comm_state=residual, skipped=counters,
                    residual_replicated=replicated,
                )
                if is_main:
                    log(f"Preempted: emergency checkpoint for epoch {epoch} saved.")
            elif is_main:
                log(f"Preempted: drained snapshot writer (flushed step {flushed}) and saved "
                    f"final step snapshot for epoch {epoch} step {int(partial['step'])}.")
        row = {"epoch": epoch, "completed": bool(completed), "step": tel.recorder.global_step}
        if snap_drain:
            row["snapshot_step"] = int(partial["step"])
        writer.write(event("preempt", **row))
        writer.sync()
        if flight is not None:  # the exit-75 recording: the preempt row rode the tee above
            notes = dict(emergency_checkpoint=path, emergency_epoch=epoch,
                         emergency_step=tel.recorder.global_step)
            if snap_drain:  # the last snapshot the writer published, and the drain's own
                notes.update(snapshot_flushed_step=flushed,
                             snapshot_final_step=int(partial["step"]))
            flight.note(**notes)
            flight.dump("preempt")
        raise TrainingPreempted(epoch, path)

    try:
        history = []
        epoch = start_epoch
        while epoch < num_epochs:
            faults.maybe_fire("epoch", epoch=epoch)  # $TPUDDP_FAULT=preempt@epoch=N
            if drain_requested(world_size, device, agreed):
                emergency_stop(epoch)
            if guard.enabled and guard.audit_every_n_epochs and \
                    (epoch - start_epoch) % guard.audit_every_n_epochs == 0:
                bad_leaf = ddp.audit_replicas()  # a TP shard against its data replicas'
                if bad_leaf is not None:
                    writer.write(event("desync", epoch=epoch, leaf=bad_leaf))
                    if guard.on_desync == "rollback" and can_roll_back():
                        epoch = rollback(epoch, f"replica desync at leaf {bad_leaf}")
                        prev_total = ddp.skip_counters()[0]
                        continue
                    raise guard_lib.ReplicaDesync(bad_leaf, where=f"epoch {epoch} audit")
            t0 = time.perf_counter()
            epoch_span = tracer.start_span(f"epoch {epoch}", trace_lib.KIND_EPOCH,
                                           trace_id=run_trace_id, tid="train",
                                           attrs={"epoch": epoch})
            if is_main:
                log(f"Process {rank}, Epoch {epoch}")
            if set_epoch:
                # without it every epoch replays epoch-0 order (reference :175-178)
                train_loader.set_epoch(epoch)
                test_loader.set_epoch(epoch)
                if is_main:
                    log(f"DistributedSampler.set_epoch: {set_epoch}")
            if print_rand:
                log(f"Process {rank}, {seeding.rng_probe_string(base_seed)}")

            # the exact mid-epoch resume: a cursor restored for this epoch
            # whose plan key matches this loader's continues at its step
            # (zero batches replayed); a mismatch redoes the epoch
            base_step, acc0 = 0, None
            cur, pending["c"] = pending["c"], None
            if cur is not None and int(cur.get("epoch", -1)) == epoch:
                expect = snapshot_lib.epoch_plan_key(train_loader, epoch, plan_ranks)
                if not cur.get("plan_key"):
                    logger.warning("Step snapshot for epoch %d carries no plan key (resharded "
                                   "restore): redoing the epoch.", epoch)
                elif cur["plan_key"] != expect:
                    logger.warning(
                        "Step snapshot plan key mismatch for epoch %d (%s != %s): data order "
                        "changed, redoing the epoch from the restored state.",
                        epoch, cur["plan_key"], expect,
                    )
                else:
                    base_step = int(cur["step"])
                    acc0 = snapshot_lib.acc_from_cursor(cur)
                    if is_main:
                        log(f"Exact resume: epoch {epoch} continues at step {base_step} "
                            "(zero batches replayed).")
            train_pass.loader = (snapshot_lib.EpochTailLoader(train_loader, base_step)
                                 if base_step else train_loader)
            plan_key = None
            if snap_engine is not None:
                plan_key = snapshot_lib.epoch_plan_key(train_loader, epoch, plan_ranks)
                snap_engine.begin_epoch(epoch, base_step)
                snap_engine.trace_parent = epoch_span
            train_pass.trace_parent = test_pass.trace_parent = epoch_span
            if tracer.enabled:
                train_pass.stage_plan = pipeline_lib.stage_units(len(train_pass), train_k, accum)
                test_pass.stage_plan = pipeline_lib.stage_units(len(test_pass), eval_k)

            train_sums = torch.zeros(len(TRAIN_KEYS), device=device)
            if acc0 is not None:  # the cursor's partial sums (this replica's) seed this pass's
                train_sums.copy_(torch.from_numpy(np.concatenate(
                    [_replica_entry(acc0[k], rank) for k in TRAIN_KEYS])))

            def sums_by_key():
                """The partial sums as the cursor keeps them: one entry per
                replica (the JAX package's per-replica metrics; gathered at
                world > 1, a collective)."""
                if world_size == 1:
                    return {k: train_sums[i:i + 1] for i, k in enumerate(TRAIN_KEYS)}
                full = torch.empty(world_size * len(TRAIN_KEYS), device=device)
                col.all_gather_shards(full, train_sums.contiguous())
                return {k: full[i::len(TRAIN_KEYS)].clone() for i, k in enumerate(TRAIN_KEYS)}

            clock = StepClock(device)
            tel.start_epoch(epoch, clock)
            left = len(train_pass)  # loader batches not yet dispatched
            done = base_step  # real micro-batches of the epoch dispatched
            dispatched = 0  # dispatches since the last wait for the device
            for many, chunk in dispatches(train_pass, train_k, accum):
                updates = len(chunk) // accum
                tel.pre_dispatch(updates)
                dsp = tracer.start_span("dispatch", trace_lib.KIND_DISPATCH, parent=epoch_span,
                                        attrs={"steps": len(chunk),
                                               "samples": _host_rows(chunk, world_size, hosts)})
                clock.mark()
                clock.groups.append(updates)
                if not many:
                    train_sums += ddp.train_step(chunk[0])
                elif chunked:
                    train_sums = ddp.train_step_many(chunk, train_sums)
                else:
                    train_sums += ddp.train_cycle(chunk)
                _sync_readback(train_pass, tracer, dsp)
                if comm_attrs is not None:
                    annotate_collectives(tracer, dsp, comm_attrs, max(1, len(chunk) // accum))
                tracer.end_span(dsp, inflight=dispatched + 1)
                real = min(len(chunk), left)  # an accumulation tail's padding is not the loader's
                left -= real
                done += real
                windows = tel.recorder.windows_emitted
                tel.post_dispatch(updates, train_pass.take_rows(real),
                                  host_stall_s=train_pass.stall.take(),
                                  staging_depth=train_pass.staged_depth,
                                  inflight_depth=dispatched + 1)
                dispatched = 0 if tel.recorder.windows_emitted > windows else dispatched + 1
                if agreed is not None:  # the drain verdict and rank 0's room, agreed
                    agreed.exchange()
                if snap_engine is not None:  # after the telemetry, before the next dispatch
                    snap_engine.maybe(capture, epoch=epoch, step=done, plan_key=plan_key,
                                      acc=sums_by_key,
                                      room=None if agreed is None else agreed.room)
            if train_pass.interrupted:
                emergency_stop(epoch, partial=None if snap_engine is None else {
                    "step": done, "plan_key": plan_key, "acc": sums_by_key})
            rsp = tracer.start_span("readback", trace_lib.KIND_READBACK, parent=epoch_span,
                                    attrs={"pending": dispatched})
            clock.mark()
            step_ms = clock.step_ms()  # waits for the pass's last mark
            tracer.end_span(rsp)
            if not step_ms and not base_step:
                raise RuntimeError(
                    "train loader yielded no batches this epoch; check the "
                    "dataset and batch size"
                )
            train_time_s = time.perf_counter() - t0

            eval_sums = torch.zeros(len(EVAL_KEYS), device=device)
            eval_dispatches = 0
            for many, chunk in dispatches(test_pass, eval_k):
                dsp = tracer.start_span("dispatch", trace_lib.KIND_DISPATCH, parent=epoch_span,
                                        attrs={"steps": len(chunk),
                                               "samples": _host_rows(chunk, world_size, hosts)})
                if many:
                    eval_sums = ddp.eval_step_many(chunk, eval_sums)
                else:
                    eval_sums += ddp.eval_step(chunk[0])
                _sync_readback(test_pass, tracer, dsp)
                eval_dispatches += 1
                tracer.end_span(dsp, inflight=eval_dispatches)
                if agreed is not None:
                    agreed.exchange()
            # a drain during the eval pass: every update of the epoch is in,
            # so its row lands (eval metrics null) and the save counts it done
            eval_cut = test_pass.interrupted
            # every process here before the epoch's sums are combined (the
            # reference's :194; a $TPUDDP_FAULT barrier site)
            col.barrier()

            if per_replica_log and not eval_cut:
                _per_replica_lines(torch.cat([train_sums, eval_sums]), world_size, log,
                                   metrics_group)
            rsp = tracer.start_span("readback", trace_lib.KIND_READBACK, parent=epoch_span,
                                    attrs={"pending": eval_dispatches})
            # the epoch's one read of its sums
            sums = finalize_metrics(train_sums, eval_sums, metrics_group)
            tracer.end_span(rsp)
            tel.stop_epoch_trace()  # the first-epoch and SIGUSR1 traces hold the eval pass
            train_m, eval_m = sums["train"], sums["eval"]
            train_loss = train_m["loss_sum"] / max(train_m["n"], 1.0)
            test_loss = eval_m["loss_sum"] / max(eval_m["n"], 1.0)
            test_accuracy = 100.0 * eval_m["correct"] / max(eval_m["n"], 1.0)
            if eval_cut:
                test_loss = test_accuracy = float("nan")
                eval_m = dict(eval_m, n=0.0)
            elif is_main:
                log(
                    f"Epoch {epoch + 1}/{num_epochs}, "
                    f"Train Loss: {train_loss:.4f}, "
                    f"Test Loss: {test_loss:.4f}, "
                    f"Test Accuracy: {test_accuracy:.2f}%"
                )
            epoch_time = time.perf_counter() - t0
            epoch_updates = -(-len(train_loader) // accum)
            comm_counter.add_updates(epoch_updates)
            record = {
                "epoch": epoch,
                "train_loss": train_loss,
                "test_loss": test_loss,
                "test_accuracy": test_accuracy,
                "train_samples": train_m["n"],
                "test_samples": eval_m["n"],
                "train_time_s": train_time_s,
                "epoch_time_s": epoch_time,
                "samples_per_sec": (train_m["n"] + eval_m["n"]) / max(epoch_time, 1e-9),
                # step-time percentiles and MFU over step_ms (the recorder)
                **tel.end_epoch(step_ms),
                "step_ms": step_ms,
                "host_stall_s": train_pass.stall.total,
                "pipeline": pipeline.as_dict(),
                "grad_accumulation": accum,
                "weight_update_sharding": bool(getattr(ddp, "weight_update_sharding", False)),
                "comm_hook": getattr(ddp, "comm_hook", "none"),
                **comm_counter.snapshot(epoch_updates),
                "grad_comm_bytes_per_update_f32": getattr(ddp, "grad_comm_bytes_per_step_f32",
                                                          None),
                # the top-k density and the bytes' split by link, under the JAX
                # names (tpuddp/training/loop.py:415-431)
                "comm_density": getattr(ddp, "topk_density", None),
                "comm_topology": getattr(ddp, "comm_topology", "flat"),
                "grad_comm_bytes_inter_host": getattr(ddp, "grad_comm_bytes_inter_host", None),
                "grad_comm_bytes_intra_host": getattr(ddp, "grad_comm_bytes_intra_host", None),
                "scan_steps": train_k,
                "eval_scan_steps": eval_k,
                "world_size": world_size,
            }
            # the guard's skips: one counter fetch per epoch
            epoch_skips = consecutive = 0
            if guard.enabled:
                total, consecutive = ddp.skip_counters()
                epoch_skips, prev_total = total - prev_total, total
                record.update(skipped_steps=total, skipped_steps_epoch=epoch_skips)
                optim.sync_steps(ddp.optimizer)  # the host's step counts, at the epoch's end
            # the live gauges the recorder cannot see (host values)
            tel.update_live(train_loss=train_loss, test_loss=test_loss,
                            test_accuracy=test_accuracy,
                            skipped_steps=record.get("skipped_steps", 0),
                            grad_comm_bytes_total=comm_counter.total_bytes)
            if aggregator is not None:
                aggregator.update()  # the epoch's merge (windows may be off)
            record = schema.stamp("epoch", record)
            history.append(record)
            writer.write(record)
            if epoch_skips:
                writer.write(event("skipped_updates", epoch=epoch, count=epoch_skips,
                                   total=record["skipped_steps"]))
            if eval_cut:
                emergency_stop(epoch, completed=True)
            if consecutive > guard.max_consecutive_skips:
                # updates skipped back to back: restore the last good state
                # instead of checkpointing a wedged trajectory
                reason = f"{consecutive} consecutive non-finite updates skipped"
                if can_roll_back():
                    tracer.end_span(epoch_span, rollback="consecutive_skips")
                    epoch = rollback(epoch, reason)
                    prev_total = ddp.skip_counters()[0]
                    continue
                raise FloatingPointError(
                    f"non-finite gradients forced {consecutive} consecutive skipped updates and no "
                    "checkpoint exists to roll back to (set save_dir / checkpoint_epoch to arm "
                    "rollback)"
                )
            if save_dir is not None and epoch % checkpoint_epoch == 0:
                if epoch_skips:
                    logger.warning("checkpointing epoch %d after %d skipped update(s) this epoch "
                                   "(total %d)", epoch, epoch_skips, record["skipped_steps"])
                if snap_engine is not None:
                    snap_engine.flush()  # its writes land before this file and its pruning
                ckpt.save_on_main(
                    save_dir, epoch, ddp.model, ddp.optimizer, rank, seed=base_seed,
                    generator=ddp.generator, world_size=world_size, keep_last=keep_last,
                    step=ddp.step, comm_state=residual, skipped=counters,
                    residual_replicated=replicated,
                )
            tracer.end_span(epoch_span, train_loss=float(train_loss), skipped_steps=epoch_skips)
            epoch += 1
        if is_main:
            log(f"Finished Training on process {rank}.")
        return history
    except TrainingPreempted:
        raise  # emergency_stop dumped the "preempt" recording
    except guard_lib.ReplicaDesync:
        if flight is not None:
            flight.dump("desync")
        raise
    except BaseException:
        if flight is not None:
            flight.dump("exception")
        raise
    finally:
        if snap_engine is not None:
            snap_engine.close()
        if agreed is not None or snap_engine is not None:
            _log_drain_stats(rank, snap_engine, agreed)
        tel.finish()
        if tracer.enabled:
            # on every way out: the summary row before the history closes, the
            # Chrome trace beside it (an interrupted epoch's spans flagged open)
            writer.write(schema.stamp("trace_summary", tracer.summary_record()))
            tracer.export()
        writer.close()
        if exporter is not None:
            exporter.stop()
        if flight is not None:
            flight_lib.uninstall(flight)
