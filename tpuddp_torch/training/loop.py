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
Process 0 appends every row to ``save_dir/history.jsonl``; it also says
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
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from tpuddp_torch import optim, seeding
from tpuddp_torch.resilience import faults
from tpuddp_torch.resilience import guard as guard_lib
from tpuddp_torch.training import checkpoint as ckpt
from tpuddp_torch.training import pipeline as pipeline_lib
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
    no accumulation every batch is a single step."""
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

    def step_ms(self):
        if self.cuda:
            self.marks[-1].synchronize()
            ms = [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        else:
            ms = [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]
        return [t / k for t, k in zip(ms, self.groups) for _ in range(k)]


def _count(v: float):
    return int(v) if math.isfinite(v) else v


def _per_replica_lines(sums: torch.Tensor, world_size: int, log) -> None:
    """The reference's per-replica loss lines (:186-191), on process 0."""
    if dist.is_initialized() and world_size > 1:
        parts = [torch.empty_like(sums) for _ in range(world_size)]
        dist.all_gather(parts, sums)
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


def strict_json(value):
    """``value`` with every non-finite float as None (strict JSON: a
    poisoned epoch's loss is ``null``, never a bare ``NaN``)."""
    if isinstance(value, float) and not math.isfinite(value):
        return None
    if isinstance(value, dict):
        return {k: strict_json(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [strict_json(v) for v in value]
    return value


def append_row(save_dir: Optional[str], row: dict) -> None:
    """One strict-JSON line of ``save_dir/history.jsonl`` (nothing without a
    directory)."""
    if save_dir is not None:
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, "history.jsonl"), "a") as f:
            f.write(json.dumps(strict_json(row)) + "\n")


def event(name: str, **fields) -> dict:
    """A history event row (``{"type": "event", "event": name, ...}``)."""
    return {"type": "event", "event": name, **fields}


def nan_injector():
    """The ``nan@step=N`` hook of the train pass (None when no such fault
    is armed): each host micro-batch counted from the loop's entry."""
    faults.refuse_unported()
    if not faults.has_nan_fault():
        return None
    counter = {"i": 0}

    def inject(host_batch):
        i = counter["i"]
        counter["i"] += 1
        return faults.maybe_corrupt_batch(host_batch, i)

    return inject


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
    log=print,
):
    """Run the epochs from the first not yet done (0 unless resumed) to
    ``num_epochs``; returns the list of per-epoch records."""
    rank, world_size, device = ddp.rank, ddp.world_size, ddp.device
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
    if is_main:
        log(f"Training on {len(train_loader)} batches, test on {len(test_loader)} batches")
    start_epoch = 0
    if auto_resume or ckpt.auto_resume_requested():
        if save_dir is None:
            if is_main:
                log("Auto-resume requested but no save_dir configured; starting fresh.")
        else:
            start_epoch, meta = ckpt.restore_latest(
                save_dir, ddp.model, ddp.optimizer, generator=ddp.generator,
                comm_state=getattr(ddp, "residual", None),
                skipped=None if getattr(ddp, "firewall", None) is None else ddp.firewall.counters,
            )
            ddp.step = meta.get("step", ddp.step)
            ddp.clear_graphs()  # the restore replaced what a graph writes
            if start_epoch > 0 and is_main:
                log(f"Auto-resume: continuing from epoch {start_epoch}.")
    train_pass = pipeline_lib.StagedLoader(
        train_loader, device, pipeline, probe=_prober(train_loader, data_probe_every, log),
        inject=nan_injector(),
    )
    test_pass = pipeline_lib.StagedLoader(test_loader, device, pipeline)
    guard = getattr(ddp, "guard", guard_lib.DISABLED)
    prev_total = ddp.skip_counters()[0] if guard.enabled else 0
    rollbacks = 0

    def can_roll_back() -> bool:
        return save_dir is not None and ckpt.agreed_latest(save_dir, device=device) is not None

    def rollback(epoch: int, reason: str) -> int:
        """Restore the newest intact checkpoint; the epoch to redo."""
        nonlocal rollbacks
        rollbacks += 1
        if rollbacks > guard.max_rollbacks:
            raise RuntimeError(
                f"guard rollback limit ({guard.max_rollbacks}) exceeded; last trigger: {reason}. "
                "The failure recurs after restoring known-good state — a systematic divergence, "
                "not a transient."
            )
        redo, meta = ckpt.restore_latest(
            save_dir, ddp.model, ddp.optimizer, generator=ddp.generator,
            comm_state=getattr(ddp, "residual", None), skipped=ddp.firewall.counters,
        )
        ddp.step = meta.get("step", ddp.step)
        ddp.clear_graphs()  # the restore replaced what a graph writes
        if is_main:
            append_row(save_dir, event("rollback", epoch=epoch, resume_epoch=redo,
                                       resume_step=None, reason=reason))
            log(f"Guard rollback ({reason}): restored last-good checkpoint, "
                f"redoing from epoch {redo}.")
        return redo

    history = []
    epoch = start_epoch
    while epoch < num_epochs:
        if guard.enabled and guard.audit_every_n_epochs and \
                (epoch - start_epoch) % guard.audit_every_n_epochs == 0:
            bad_leaf = guard_lib.audit_params(ddp.model)
            if bad_leaf is not None:
                if is_main:
                    append_row(save_dir, event("desync", epoch=epoch, leaf=bad_leaf))
                if guard.on_desync == "rollback" and can_roll_back():
                    epoch = rollback(epoch, f"replica desync at leaf {bad_leaf}")
                    prev_total = ddp.skip_counters()[0]
                    continue
                raise guard_lib.ReplicaDesync(bad_leaf, where=f"epoch {epoch} audit")
        t0 = time.perf_counter()
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

        train_sums = torch.zeros(len(TRAIN_KEYS), device=device)
        clock = StepClock(device)
        for many, chunk in dispatches(train_pass, train_k, accum):
            clock.mark()
            clock.groups.append(len(chunk) // accum)
            if not many:
                train_sums += ddp.train_step(chunk[0])
            elif chunked:
                train_sums = ddp.train_step_many(chunk, train_sums)
            else:
                train_sums += ddp.train_cycle(chunk)
        clock.mark()
        step_ms = clock.step_ms()
        if not step_ms:
            raise RuntimeError(
                "train loader yielded no batches this epoch; check the "
                "dataset and batch size"
            )
        train_time_s = time.perf_counter() - t0

        eval_sums = torch.zeros(len(EVAL_KEYS), device=device)
        for many, chunk in dispatches(test_pass, eval_k):
            if many:
                eval_sums = ddp.eval_step_many(chunk, eval_sums)
            else:
                eval_sums += ddp.eval_step(chunk[0])

        if per_replica_log:
            _per_replica_lines(torch.cat([train_sums, eval_sums]), world_size, log)
        sums = finalize_metrics(train_sums, eval_sums)
        train_m, eval_m = sums["train"], sums["eval"]
        train_loss = train_m["loss_sum"] / max(train_m["n"], 1.0)
        test_loss = eval_m["loss_sum"] / max(eval_m["n"], 1.0)
        test_accuracy = 100.0 * eval_m["correct"] / max(eval_m["n"], 1.0)
        if is_main:
            log(
                f"Epoch {epoch + 1}/{num_epochs}, "
                f"Train Loss: {train_loss:.4f}, "
                f"Test Loss: {test_loss:.4f}, "
                f"Test Accuracy: {test_accuracy:.2f}%"
            )
        record = {
            "epoch": epoch,
            "train_loss": train_loss,
            "test_loss": test_loss,
            "test_accuracy": test_accuracy,
            "train_samples": train_m["n"],
            "test_samples": eval_m["n"],
            "train_time_s": train_time_s,
            "epoch_time_s": time.perf_counter() - t0,
            "step_ms": step_ms,
            "host_stall_s": train_pass.stall.total,
            "pipeline": pipeline.as_dict(),
            "grad_accumulation": accum,
            "weight_update_sharding": bool(getattr(ddp, "weight_update_sharding", False)),
            "comm_hook": getattr(ddp, "comm_hook", "none"),
            "grad_comm_bytes_per_update": getattr(ddp, "grad_comm_bytes_per_step", None),
            "grad_comm_bytes_per_update_f32": getattr(ddp, "grad_comm_bytes_per_step_f32", None),
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
        history.append(record)
        if is_main:
            append_row(save_dir, record)
            if epoch_skips:
                append_row(save_dir, event("skipped_updates", epoch=epoch, count=epoch_skips,
                                           total=record["skipped_steps"]))
        if consecutive > guard.max_consecutive_skips:
            # updates skipped back to back: restore the last good state
            # instead of checkpointing a wedged trajectory
            reason = f"{consecutive} consecutive non-finite updates skipped"
            if can_roll_back():
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
            ckpt.save_on_main(
                save_dir, epoch, ddp.model, ddp.optimizer, rank, seed=base_seed,
                generator=ddp.generator, world_size=world_size, keep_last=keep_last,
                step=ddp.step, comm_state=getattr(ddp, "residual", None),
                skipped=None if getattr(ddp, "firewall", None) is None else ddp.firewall.counters,
            )
        epoch += 1
    if is_main:
        log(f"Finished Training on process {rank}.")
    return history
