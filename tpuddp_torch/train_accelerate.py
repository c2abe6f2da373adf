"""Managed training entry point of the port — the counterpart of
``train_accelerate.py`` and of the reference's
``multi-GPU-training-accelerate.py``.

    python -m tpuddp_torch.train_accelerate --settings_file F

One process per GPU, as ``accelerate launch`` starts them
(``local.gpu.num_gpus``, ``local.condor.num_gpus`` or ``$TPUDDP_WORLD_SIZE``),
through the native path's launcher; ``local.device: cpu`` runs the same path
on the CPU with Gloo. The ``Accelerator`` hides the topology: ``prepare``
shards the train loader, and ``backward`` syncs the gradient.

Reference behaviours kept on purpose (quirk Q3): the test loader is not
prepared, so every process evaluates the whole test set; the test loss is
the sum of per-batch mean losses over ``len(test_loader)`` and the accuracy
counts the rows with ``w > 0``, with no cross-process reduction. The train
loss is the sum of the per-step global losses over ``len(train_loader)``,
read once per epoch (``sum_losses``, which also flushes the last queued
steps). The eval pass counts its correct and real rows on the device and
reads them once; with ``deferred_metrics`` it is a
:class:`~tpuddp_torch.accelerate.FusedEvaluator` (one per model, cached on
it), without it each batch's loss is read, as the reference does.

``fuse_steps`` (``auto`` with ``deferred_metrics``: 32 steps per flush for
small batches) queues the steps behind ``optimizer.step()``; on the GPU each
flush is one CUDA-graph replay (``training/graphs.py``). Process 0 prints
the epoch line of the JAX package byte for byte and appends one
``history.jsonl`` row per epoch (``api: "managed"``, ``fuse_steps`` the
resolved depth, ``step_ms`` per step: CUDA events on the GPU around each
flush, divided by the steps it ran, so a step that was only queued is never
timed on its own). At ``epoch % checkpoint_epoch == 0`` it writes
``model.npz`` and ``state_{epoch}.npz`` (``keep_last`` prunes the older
state files).

As ``train_accelerate.py:864-876`` does, the loaders are wrapped after
``prepare``: in ``PrefetchLoader(workers=pipeline.host_workers)`` under
``prefetch: true``, then in the staging of ``training/pipeline.py``, which
copies each batch from pinned memory without blocking, ``pipeline.depth``
batches ahead. ``training.resume``, ``auto_resume`` or
``$TPUDDP_AUTO_RESUME`` restore the newest intact ``state_{epoch}.npz`` in
``out_dir`` before the first epoch (``train_accelerate.py:894-912``) and the
run continues at the epoch after it. ``weight_update_sharding: true``
shards the optimizer's update and state across the processes (ZeRO-1,
``accelerate.py``); ``comm_hook`` round-trips each update's gradient
through the hook's wire format, with its error-feedback residual.

``training.guard`` (the numerical guard; ``train_accelerate.py:431-460,
:555-600, :674-750``): a skipped update is a bitwise no-op
(``accelerate.py``); each row carries ``skipped_steps`` and
``skipped_steps_epoch`` (one counter fetch per epoch), an epoch with skips
prints its count and writes a ``skipped_updates`` event
(``$TPUDDP_FAULT=nan@step=N`` poisons a host micro-batch before it is
staged, as the native loop does, so a fused flush carries it);
``audit_every_n_epochs`` audits the processes' parameters at those epochs'
starts; more than ``max_consecutive_skips`` consecutive skips restore the
newest intact ``state_{epoch}.npz`` (``load_state``) and redo the epoch (a
``rollback`` event), at most ``max_rollbacks`` times, or raise
``FloatingPointError`` without one. A divergent replica exits 77
(``parallel/spawn.py``).

Every row is typed (``observability/schema.py``): ``history.jsonl`` opens
with a ``run_meta`` header (a resumed run appends a fresh one), the epoch
rows carry the step-time percentiles over ``step_ms`` (MFU null, as the
JAX managed rows), ``step_stats_every: N`` adds a ``step_stats`` row per N
steps (each group of fused steps counted once it has run), and
``$TPUDDP_PROFILE``, ``$TPUDDP_PROFILE_STEPS`` (widened to whole queued
groups) and SIGUSR1 write ``torch.profiler`` traces. ``training.remat`` is
accepted and changes nothing here: the JAX managed path does not read it.

The drain (``train_accelerate.py:470-655``): a SIGTERM or SIGINT seen at an
epoch's start saves the last whole epoch's state and exits 75; seen when
the train pass ends, it saves that epoch as done (its eval is lost). With
``training.snapshot`` on one host the train pass also polls after each
accumulation cycle (at world > 1 rank 0's flag, agreed by every process
there: ``training/loop.py``'s ``AgreedPoll``; across hosts no poll inside a
pass): a drain there writes ``state_{epoch}_s{step}.npz``
with the v4 cursor (the plan key; the sums ``loss_total`` and ``n_seen``
under the JAX names, and the pass's per-step losses, with which the
resumed epoch's loss is the uninterrupted one's bitwise), and the requeued
run continues that epoch at that step. ``pipeline.device_augment: false``
runs the augment as its own op on each batch before the step, outside the
step and its CUDA graph (``train_accelerate.py:879-886``); it draws the same
flips from the same stream, so the run is the in-step one's.

The ``observability`` block (``train_accelerate.py:298-534``), in each
host's local rank 0: the flight recorder (dumped on a drain, a desync or an
exception), the ``/metrics`` exporter and, across hosts, the telemetry
shards with process 0's straggler detector. The JAX managed loop builds no
tracer, so ``tracing: true`` is accepted and changes nothing here.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from functools import partial
from typing import Optional

import numpy as np
import torch

from tpuddp_torch import config as cfg_lib
from tpuddp_torch import seeding
from tpuddp_torch.accelerate import Accelerator, FusedEvaluator, loss_values
from tpuddp_torch.data import (
    DataLoader, PrefetchLoader, compute_dtype_for, flip_for, load_datasets_for,
    norm_stats_for,
)
from tpuddp_torch.data.transforms import make_eval_transform, make_train_augment
from tpuddp_torch.models.convert import jax_leaf_index
from tpuddp_torch.nn import CrossEntropyLoss
from tpuddp_torch.observability import MetricsWriter, RunTelemetry, config_hash, schema
from tpuddp_torch.observability import exporter as exp_lib
from tpuddp_torch.observability import flight as flight_lib
from tpuddp_torch.parallel import backend, comm
from tpuddp_torch.parallel.collectives import all_reduce_sum_
from tpuddp_torch.parallel.spawn import resolve_world, run_ddp_training
from tpuddp_torch.resilience import faults, preemption
from tpuddp_torch.resilience import guard as guard_lib
from tpuddp_torch.resilience.preemption import TrainingPreempted
from tpuddp_torch.train_native import load_model_for, set_numerics
from tpuddp_torch.training import checkpoint as ckpt
from tpuddp_torch.training import snapshot as snapshot_lib
from tpuddp_torch.training.loop import (
    StepClock, agreed_poll, drain_requested, event, host_ranks, live_plane, observability_meta,
    step_fault_hook,
)
from tpuddp_torch.training.pipeline import StagedLoader, resolve_pipeline


def setup_dataloaders(training):
    """Plain, distribution-unaware loaders (reference :22-36); ``prepare``
    re-creates the train loader sharded."""
    train_dataset, test_dataset = load_datasets_for(training)
    train_loader = DataLoader(train_dataset, batch_size=training["train_batch_size"], shuffle=True)
    test_loader = DataLoader(test_dataset, batch_size=training["test_batch_size"])
    return train_loader, test_loader


def train(model, train_loader, criterion, optimizer, accelerator,
          clock: Optional[StepClock] = None, tel=None, *, augment=None, start_batch: int = 0,
          carried: Optional[dict] = None, poll=None, progress: Optional[dict] = None,
          total_batches: Optional[int] = None):
    """One training epoch; returns ``(mean per-step loss, real rows of the
    global batches)``. A partial accumulation cycle is applied at the end;
    the fuse queue's last steps run at the epoch's ``sum_losses``. ``tel``
    (a :class:`~tpuddp_torch.observability.RunTelemetry`, with ``clock``)
    sees each group of steps once it has run, as one dispatch
    (``train_accelerate.py:100-160``): a step that only queued is not one.
    ``augment`` (``pipeline.device_augment: false``) runs on each batch as
    its own op before the step; None when the step augments.

    The step snapshot's resume and drain (``train_accelerate.py:61-215``):
    the loader may be an epoch's tail from batch ``start_batch``;
    ``carried`` (``{"losses", "n_seen"}``, from the cursor) seeds the
    pass's sums so the epoch row is the uninterrupted run's, bitwise: the
    loss sum is over the same vector of per-step losses; ``total_batches``
    is the whole epoch's count, the mean's denominator. ``poll`` is checked
    after each completed accumulation cycle (at world > 1 it is the agreed
    poll, a collective every process makes there): True stops the pass
    there and ``progress`` gets ``interrupted``, the epoch ``step`` reached
    and the sums, which the drain writes as the cursor: the global rows
    seen (process 0 seeds them back on resume, the others start at 0)."""
    model.train()
    n_seen = torch.zeros((), device=model.device)
    if carried is not None and accelerator.process_index == 0:
        n_seen.fill_(float(carried["n_seen"]))
    losses = []
    pending = 0  # steps of the open group (queued, or not yet marked)
    rows = 0.0  # the open group's real rows, from the host weights
    depth = 0  # the deepest the fuse queue ran in the open group
    interrupted_at = None
    for i, (inputs, labels, weights) in enumerate(train_loader):
        n_seen = n_seen + model.to_device(weights, torch.float32).sum()
        optimizer.zero_grad()
        if clock is not None and pending == 0:
            clock.mark()
        if tel is not None:
            # the dispatch that will carry this step is the whole queued
            # group, so a profiled window inside it arms at its first step
            tel.pre_dispatch(pending + 1)
            rows += train_loader.take_rows(1)
        if augment is not None:
            inputs = augment(model.to_device(inputs))  # its own op, outside the step
        outputs = model(inputs)  # else flip/normalize/resize run inside the step's forward
        loss = criterion(outputs, labels, weights)
        accelerator.backward(loss)
        optimizer.step()
        losses.append(loss)
        pending += 1
        depth = max(depth, optimizer.queued)
        if not optimizer.queued:  # the step ran, or the flush it filled did
            if clock is not None:
                clock.groups.append(pending)
            if tel is not None:
                tel.post_dispatch(pending, rows, host_stall_s=train_loader.stall.take(),
                                  staging_depth=train_loader.staged_depth, inflight_depth=depth)
            pending, rows, depth = 0, 0.0, 0
        if poll is not None and not optimizer.accumulating and poll():
            interrupted_at = start_batch + i + 1  # a cycle boundary: every step taken is whole
            break
    if interrupted_at is None:
        optimizer.flush_accumulation()
    values = loss_values(losses, initial=None if carried is None else carried["losses"])
    loss_sum = values.sum()
    if clock is not None:
        if pending:
            clock.groups.append(pending)
            if tel is not None:
                tel.post_dispatch(pending, rows, host_stall_s=train_loader.stall.take(),
                                  staging_depth=train_loader.staged_depth, inflight_depth=depth)
        clock.mark()
    # one read of the loss sum and of the rows every process saw
    totals = torch.stack([loss_sum, n_seen])
    all_reduce_sum_([totals[1:]])
    loss_total, n_seen = totals.tolist()
    if progress is not None:
        progress.update(interrupted=interrupted_at is not None,
                        step=start_batch + len(train_loader) if interrupted_at is None
                        else interrupted_at,
                        losses=values.cpu().numpy(), n_seen=n_seen, loss_total=loss_total)
    return loss_total / (total_batches or len(train_loader)), n_seen


def evaluate(model, test_loader, criterion, transform, deferred: bool = False):
    """Returns ``(mean per-batch loss, accuracy %, rows evaluated)``."""
    model.eval()
    if deferred:
        # one evaluator per (model, criterion, transform), cached on the
        # model as train_accelerate.py:224-243 caches it
        ev = getattr(model, "_tpuddp_fused_eval", None)
        if ev is None or ev.criterion is not criterion or ev.transform is not transform:
            ev = model._tpuddp_fused_eval = FusedEvaluator(model, criterion, transform=transform)
        for inputs, labels, weights in test_loader:
            ev.add(inputs, labels, weights)
        test_loss, correct, total = ev.finalize()
        return test_loss / len(test_loader), 100 * correct / total, total
    test_loss = 0.0
    correct = total = torch.zeros((), dtype=torch.int64, device=model.device)
    for inputs, labels, weights in test_loader:
        outputs = model(transform(model.to_device(inputs)))
        loss = criterion(outputs, labels, weights)
        mask = model.to_device(weights, torch.float32) > 0
        right = (outputs.argmax(dim=-1) == model.to_device(labels, torch.int64)) & mask
        total = total + mask.sum()
        correct = correct + right.sum()
        test_loss += loss.item()  # the reference's read per batch
    correct, total = int(correct), int(total)
    return test_loss / len(test_loader), 100 * correct / total, total


def run_training_loop(
    model, train_loader, test_loader, criterion, optimizer, save_dir: Optional[str],
    accelerator, eval_transform, num_epochs: int = 20, checkpoint_epoch: int = 5,
    deferred_metrics: bool = False, start_epoch: int = 0, keep_last: Optional[int] = None,
    step_stats_every: int = 0, run_meta: Optional[dict] = None, snapshot=None, augment=None,
    observability=None,
):
    """Run epochs ``start_epoch`` to ``num_epochs``; returns the list of
    per-epoch records. ``run_meta`` holds the entry point's header fields;
    ``snapshot`` the ``training.snapshot`` block (the managed flavour: no
    background writer; armed on one host, a drain caught at a cycle boundary
    writes ``state_{epoch}_s{step}.npz`` with the v4 cursor and the resumed
    run continues that epoch at that step); ``augment`` the out-of-step
    augment of ``pipeline.device_augment: false``; ``observability`` the
    ``observability`` block (``train_accelerate.py:298-534``: the flight
    recorder, the exporter, the shards and the aggregator in each host's
    local rank 0; the JAX managed loop builds no tracer, so ``tracing`` is
    accepted and changes nothing here)."""
    # $TPUDDP_FAULT step hook: nan@step=N poisons that staged host batch,
    # preempt@step=N asks for the drain there
    train_loader.inject = step_fault_hook()
    full_loader = train_loader.loader  # an epoch's tail is put in its place
    snap_cfg = snapshot_lib.resolve_snapshot(snapshot)
    pending = {"c": getattr(accelerator, "last_restore_cursor", None)}
    hosts = backend.num_hosts() or 1
    world = accelerator.num_processes
    host = accelerator.process_index // (world // hosts)
    leader = backend.is_host_leader()
    obs_cfg = cfg_lib.resolve_observability(observability)
    flight = None
    if leader and obs_cfg["flight_recorder"] and save_dir is not None:
        flight = flight_lib.install(flight_lib.FlightRecorder(
            save_dir, capacity=int(obs_cfg["flight_capacity"]), process_index=host))
    # the typed history (train_accelerate.py:276-420): the header, then the
    # recorder and the profiling triggers; MFU stays null, as the JAX
    # managed rows have it (no FLOPs probe on this path)
    writer = MetricsWriter(save_dir, flight=flight)
    guard = accelerator.guard
    restore_events = list(accelerator.last_restore_events)
    device = accelerator.device
    # the exporter binds before the header, which records the bound port
    exporter = (exp_lib.exporter_from_config(obs_cfg, run_dir=save_dir, process_index=host)
                if leader else None)
    if exporter is not None:
        exporter.start()
    writer.write(schema.make_run_meta(
        world_size=world, process_count=hosts, process_index=host,
        device_kind=torch.cuda.get_device_name(device) if device.type == "cuda" else None,
        comm_hook=accelerator.comm_hook, comm_topology=accelerator.comm_topology, guard=guard,
        observability=observability_meta(obs_cfg, exporter, flight),
        comm={"overlap": dict(accelerator.comm_overlap_meta)},
        # the managed flavour's provenance (drain-time step snapshots only)
        snapshot={**snap_cfg.as_dict(), "mode": "drain"} if snap_cfg.enabled else False,
        extra={
            "api": "managed",
            "fuse_steps": accelerator.fuse_steps,
            "grad_accumulation": accelerator.gradient_accumulation_steps,
            "start_epoch": start_epoch,
            "num_epochs": num_epochs,
            "step_stats_every": int(step_stats_every or 0),
            "pipeline": train_loader.cfg.as_dict(),
            "comm_density": accelerator.topk_density,
            # known once the model has materialised (a resumed run); the
            # JAX header leaves the key out otherwise
            **({"grad_comm_bytes_per_update": optimizer.grad_comm_bytes_per_step}
               if optimizer.grad_comm_bytes_per_step is not None else {}),
            **(run_meta or {}),
            **ckpt.resumed_from(restore_events),
        },
    ))
    for ev in restore_events:  # an elastic restore's rows (train_accelerate.py:329-394)
        writer.write(schema.stamp("event", ev))
    tel = RunTelemetry(writer, save_dir, step_stats_every, device)
    aggregator, shard_dir = live_plane(obs_cfg, save_dir, hosts, leader,
                                       accelerator.process_index == 0, writer)
    tel.attach_live(exporter=exporter, aggregator=aggregator, shard_dir=shard_dir,
                    process_id=host)
    prev_skips = optimizer.skip_counters()[0] if guard.enabled else 0
    rollbacks = 0

    def rollback(epoch: int, reason: str) -> Optional[int]:
        """Restore the newest intact state file; the epoch to redo (None
        when there is none)."""
        nonlocal rollbacks
        if save_dir is None or ckpt.agreed_latest(save_dir, "state", accelerator.device) is None:
            return None
        rollbacks += 1
        if rollbacks > guard.max_rollbacks:
            raise RuntimeError(
                f"guard rollback limit ({guard.max_rollbacks}) exceeded; last trigger: {reason}. "
                "The failure recurs after restoring known-good state — a systematic divergence, "
                "not a transient."
            )
        redo = accelerator.load_state(model, optimizer, save_dir)
        pending["c"] = accelerator.last_restore_cursor
        writer.write(event("rollback", epoch=epoch, resume_epoch=redo, reason=reason))
        accelerator.print(f"Guard rollback ({reason}): restored last-good state, "
                          f"redoing from epoch {redo}.")
        return redo

    def drain(last_completed: int):
        """The drain at an epoch boundary (``train_accelerate.py:470-494``):
        the state of the last whole epoch, so the requeued run continues
        after it; then :class:`TrainingPreempted`."""
        if last_completed >= 0 and save_dir is not None:
            accelerator.wait_for_everyone()
            accelerator.save_state(model, optimizer, save_dir, epoch=last_completed)
            accelerator.print(f"Preempted: emergency state for epoch {last_completed} saved.")
        writer.write(event("preempt", epoch=last_completed + 1, completed=True,
                           step=tel.recorder.global_step))
        writer.sync()
        if flight is not None:  # the exit-75 recording (the preempt row rode the tee)
            flight.note(emergency_epoch=last_completed, emergency_step=tel.recorder.global_step)
            flight.dump("preempt")
        raise TrainingPreempted(last_completed + 1)

    def mid_drain(epoch: int, prog: dict, plan_key: str):
        """The drain inside a train pass (``train_accelerate.py:496-535``):
        ``state_{epoch}_s{step}.npz`` with the v4 cursor (the plan key and
        the pass's sums), which the requeued run continues at that step."""
        step = int(prog["step"])
        if save_dir is not None:
            accelerator.wait_for_everyone()
            accelerator.save_state(model, optimizer, save_dir, epoch=epoch, step=step, cursor={
                "plan_key": plan_key,
                "acc": {"loss_total": np.asarray(prog["loss_total"], np.float64),
                        "n_seen": np.asarray(prog["n_seen"], np.float64),
                        "losses": np.asarray(prog["losses"], np.float32)},
            })
            accelerator.print(f"Preempted: step snapshot for epoch {epoch} step {step} saved "
                              "(exact resume).")
        writer.write(event("preempt", epoch=epoch, completed=False,
                           step=tel.recorder.global_step, snapshot_step=step))
        writer.sync()
        if flight is not None:
            flight.note(emergency_epoch=epoch, emergency_step=tel.recorder.global_step,
                        snapshot_final_step=step)
            flight.dump("preempt")
        raise TrainingPreempted(epoch)

    # the poll inside a pass, armed by training.snapshot on one host: the
    # flag at world 1, rank 0's flag agreed at each cycle boundary at world
    # > 1 (train_accelerate.py:537-542); across hosts the drain waits for
    # the epoch boundary
    agreed = agreed_poll(world)
    poll = None
    if snap_cfg.enabled and hosts == 1:
        poll = preemption.preemption_requested if agreed is None else agreed.exchange
    plan_ranks = host_ranks(world)

    try:
        history = []
        epoch = start_epoch
        while epoch < num_epochs:
            faults.maybe_fire("epoch", epoch=epoch)  # $TPUDDP_FAULT=preempt@epoch=N
            if drain_requested(world, device, agreed):
                drain(epoch - 1)
            if guard.enabled and guard.audit_every_n_epochs and \
                    (epoch - start_epoch) % guard.audit_every_n_epochs == 0:
                bad_leaf = guard_lib.audit_params(model.module)
                if bad_leaf is not None:
                    writer.write(event("desync", epoch=epoch, leaf=bad_leaf))
                    if guard.on_desync == "rollback":
                        redo = rollback(epoch, f"replica desync at leaf {bad_leaf}")
                        if redo is not None:
                            epoch, prev_skips = redo, optimizer.skip_counters()[0]
                            continue
                    raise guard_lib.ReplicaDesync(bad_leaf, where=f"epoch {epoch} audit")
            epoch_t0 = time.perf_counter()
            train_loader.loader = full_loader
            train_loader.set_epoch(epoch)
            plan_key = snapshot_lib.epoch_plan_key(train_loader, epoch, plan_ranks)
            # the exact mid-epoch resume: a cursor for this epoch whose plan
            # key matches continues at its step with the sums it carried
            start_batch, carried = 0, None
            cur, pending["c"] = pending["c"], None
            if cur is not None and int(cur.get("epoch", -1)) == epoch:
                if cur.get("plan_key") == plan_key:
                    start_batch = int(cur["step"])
                    acc = snapshot_lib.acc_from_cursor(cur) or {}
                    carried = {"n_seen": float(np.asarray(acc.get("n_seen", 0.0))),
                               "losses": acc.get("losses")}
                    if carried["losses"] is None:  # a JAX cursor: its float total
                        carried["losses"] = np.asarray(acc.get("loss_total", 0.0)).reshape(1)
                    train_loader.loader = snapshot_lib.EpochTailLoader(full_loader, start_batch)
                    accelerator.print(f"Exact resume: epoch {epoch} continues at step "
                                      f"{start_batch} (zero batches replayed).")
                else:
                    logging.getLogger("tpuddp").warning(
                        "step snapshot plan key mismatch for epoch %d: data order changed, "
                        "redoing the epoch from the restored state", epoch,
                    )
            clock = StepClock(accelerator.device)
            tel.start_epoch(epoch, clock)
            updates = optimizer.updates
            progress = {}
            train_loss, train_samples = train(
                model, train_loader, criterion, optimizer, accelerator, clock, tel,
                augment=augment, start_batch=start_batch, carried=carried, poll=poll,
                progress=progress, total_batches=len(full_loader),
            )
            if progress["interrupted"]:  # stopped at a cycle boundary inside the epoch
                mid_drain(epoch, progress, plan_key)
            if drain_requested(world, device, agreed):  # every update of the epoch is in
                drain(epoch)
            step_ms = clock.step_ms()
            step_fields = tel.end_epoch(step_ms)
            train_time_s = time.perf_counter() - epoch_t0
            test_loss, test_accuracy, test_samples = evaluate(
                model, test_loader, criterion, eval_transform, deferred=deferred_metrics
            )
            tel.stop_epoch_trace()  # the first-epoch and SIGUSR1 traces hold the eval pass
            epoch_time = time.perf_counter() - epoch_t0
            accelerator.print(
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
                "train_samples": train_samples,
                "test_samples": test_samples,
                "train_time_s": train_time_s,
                "epoch_time_s": epoch_time,
                "samples_per_sec": (train_samples + test_samples) / max(epoch_time, 1e-9),
                **step_fields,
                "step_ms": step_ms,
                "host_stall_s": train_loader.stall.total,
                "updates": optimizer.updates - updates,
                "api": "managed",
                "grad_accumulation": accelerator.gradient_accumulation_steps,
                "fuse_steps": optimizer.fuse_depth or accelerator.fuse_steps,
                "comm_hook": accelerator.comm_hook,
                "grad_comm_bytes_per_update": optimizer.grad_comm_bytes_per_step,
                "world_size": accelerator.num_processes,
            }
            # the guard's skips: one counter fetch per epoch, never silent
            epoch_skips = consecutive = 0
            if guard.enabled:
                total, consecutive = optimizer.skip_counters()
                epoch_skips, prev_skips = total - prev_skips, total
                record.update(skipped_steps=total, skipped_steps_epoch=epoch_skips)
                if epoch_skips:
                    accelerator.print(f"Guard: skipped {epoch_skips} non-finite update(s) in epoch "
                                      f"{epoch} (total {total}).")
            # the live gauges (train_accelerate.py:688-701)
            tel.update_live(train_loss=train_loss, test_loss=test_loss,
                            test_accuracy=test_accuracy,
                            skipped_steps=record.get("skipped_steps", 0))
            if aggregator is not None:
                aggregator.update()
            record = schema.stamp("epoch", record)
            history.append(record)
            writer.write(record)
            if epoch_skips:
                writer.write(event("skipped_updates", epoch=epoch, count=epoch_skips,
                                   total=record["skipped_steps"]))
            if consecutive > guard.max_consecutive_skips:
                # training stalled on frozen weights: roll back, or fail loudly
                reason = f"{consecutive} consecutive non-finite updates skipped"
                redo = rollback(epoch, reason)
                if redo is not None:
                    epoch, prev_skips = redo, optimizer.skip_counters()[0]
                    continue
                raise FloatingPointError(
                    f"non-finite gradients forced {consecutive} consecutive skipped updates and no "
                    "saved state exists to roll back to (lower checkpoint_epoch to arm rollback)"
                )
            if save_dir is not None and epoch % checkpoint_epoch == 0:
                accelerator.wait_for_everyone()
                accelerator.save_model(model, save_dir)
                accelerator.save_state(model, optimizer, save_dir, epoch=epoch, keep_last=keep_last)
            epoch += 1
        accelerator.print("Finished Training.")
        return history
    except TrainingPreempted:
        raise  # the drain dumped the "preempt" recording
    except guard_lib.ReplicaDesync:
        if flight is not None:
            flight.dump("desync")
        raise
    except BaseException:
        if flight is not None:
            flight.dump("exception")
        raise
    finally:
        train_loader.loader = full_loader
        if agreed is not None:
            # on stderr, whole: a rank's line never splits the epoch lines
            print(f"rank {accelerator.process_index}; {agreed.describe()}", file=sys.stderr,
                  flush=True)
        tel.finish()
        writer.close()
        if exporter is not None:
            exporter.stop()
        if flight is not None:
            flight_lib.uninstall(flight)

def build_training(training: dict, device: str = "cuda"):
    """The accelerator and the prepared objects a process trains with:
    ``(accelerator, model, optimizer, train_loader, test_loader, criterion,
    eval_transform)``; the process group, if any, is already up."""
    cfg_lib.check_supported(training)
    set_numerics()
    accum = int(training.get("gradient_accumulation_steps") or 1)
    accelerator = Accelerator(
        seed=training.get("seed"),
        fuse_steps=cfg_lib.resolve_fuse_steps(
            training.get("fuse_steps"), accum, bool(training.get("deferred_metrics"))
        ),
        gradient_accumulation_steps=accum,
        device=device,
        clip_grad_norm=training.get("clip_grad_norm"),
        weight_update_sharding=bool(training.get("weight_update_sharding")),
        # the comm hook, emulated on the all-reduced gradient (accelerate.py)
        comm_hook=str(training.get("comm_hook") or "none"),
        bucket_cap_mb=float(training.get("bucket_cap_mb") or comm.DEFAULT_BUCKET_CAP_MB),
        comm_topology=str(training.get("comm_topology") or "flat"),
        topk_density=float(training.get("topk_density") or comm.DEFAULT_TOPK_DENSITY),
        # the barrier step; true is refused (accelerate.py)
        comm_overlap=training.get("comm_overlap", "auto"),
        # the numerical guard: non-finite updates skipped, replicas audited
        guard=training.get("guard"),
    )
    size = training.get("image_size")
    mean, std = norm_stats_for(training)
    cdtype = compute_dtype_for(training)
    accelerator.augment = make_train_augment(
        size=size, flip=flip_for(training), mean=mean, std=std,
        generator=accelerator.generator, compute_dtype=cdtype,
    )
    eval_transform = make_eval_transform(size=size, mean=mean, std=std, compute_dtype=cdtype)

    train_loader, test_loader = setup_dataloaders(training)
    in_hw = size if size else train_loader.dataset.images.shape[1]
    if training.get("pretrained_path"):  # no init, so no draw (tpuddp/accelerate.py:597-605)
        model = load_model_for(training, (in_hw, in_hw, 3))
    else:
        with seeding.fork_from(accelerator.generator):  # the init draws from the stream
            model = load_model_for(training, (in_hw, in_hw, 3))
    leaf = jax_leaf_index(training["model"], model)
    optimizer = cfg_lib.optimizer_from(
        training, model.parameters(), leaf_index=[leaf[n] for n, _ in model.named_parameters()]
    )
    # the test loader stays unprepared: every process evaluates all of it (Q3)
    model, optimizer, train_loader = accelerator.prepare(model, optimizer, train_loader)
    pipeline = resolve_pipeline(training.get("pipeline"))
    if training.get("prefetch", True) and pipeline.host_workers > 0:
        train_loader = PrefetchLoader(train_loader, workers=pipeline.host_workers)
        test_loader = PrefetchLoader(test_loader, workers=pipeline.host_workers)
    train_loader = StagedLoader(train_loader, accelerator.device, pipeline)
    test_loader = StagedLoader(test_loader, accelerator.device, pipeline)
    return accelerator, model, optimizer, train_loader, test_loader, CrossEntropyLoss(), eval_transform


def basic_accelerate_training(
    rank: int, world_size: int, save_dir: Optional[str], optional_args: dict,
    training: Optional[dict] = None, device: str = "cuda", observability: Optional[dict] = None,
):
    """Per-process worker; returns the epoch history. ``observability`` is
    the settings file's resolved block (None: its defaults)."""
    training = dict(training or cfg_lib.TRAINING_DEFAULTS)
    accelerator, model, optimizer, train_loader, test_loader, criterion, eval_transform = (
        build_training(training, device)
    )
    augment = None
    if not train_loader.cfg.device_augment:
        # the augment as its own op on each batch before the step, not in
        # the step (nor in a fused flush's graph): train_accelerate.py:879-886
        augment, accelerator.augment = accelerator.augment, None
    start_epoch = 0
    if save_dir is not None and (
        training.get("resume") or training.get("auto_resume") or ckpt.auto_resume_requested()
    ):
        start_epoch = accelerator.load_state(model, optimizer, save_dir)
        cursor = accelerator.last_restore_cursor
        if cursor is not None:
            accelerator.print(f"Resumed from step snapshot: epoch {start_epoch} step "
                              f"{int(cursor.get('step', 0))}.")
        elif start_epoch:
            accelerator.print(f"Resumed from epoch {start_epoch - 1} state.")
    return run_training_loop(
        model, train_loader, test_loader, criterion, optimizer, save_dir, accelerator,
        eval_transform, num_epochs=training["num_epochs"],
        checkpoint_epoch=training["checkpoint_epoch"],
        deferred_metrics=bool(training.get("deferred_metrics")),
        start_epoch=start_epoch,
        keep_last=int(training["keep_last"]) if training.get("keep_last") else None,
        step_stats_every=int(training.get("step_stats_every") or 0),
        run_meta={
            "config_hash": config_hash(training),
            "model": training.get("model"),
            "dataset": training.get("dataset"),
        },
        # drain-time step snapshots and the exact mid-epoch resume
        snapshot=training.get("snapshot"),
        augment=augment,
        observability=observability,
    )


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="tpuddp_torch managed training (Accelerator over NCCL, Gloo on the CPU).",
    )
    parser.add_argument(
        "--settings_file", type=str, required=True,
        help="YAML settings: out_dir, local.{device,gpu}, optional_args, training.",
    )
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    settings = cfg_lib.load_settings(args.settings_file)
    device = cfg_lib.device_from(settings)
    rendezvous = cfg_lib.rendezvous_from(settings)
    world_size, _ = resolve_world(cfg_lib.world_size_from(settings), device, **rendezvous)
    parallel = cfg_lib.check_settings(settings, world_size)
    training = cfg_lib.training_config(settings)
    # the managed path has no tensor-parallel step: a model axis is the JAX
    # entry point's ValueError (train_accelerate.py:986-994)
    if parallel["model"] > 1:
        raise ValueError(
            "parallel.model > 1 needs the explicit API (train_native.py / "
            "DistributedDataParallel); the managed Accelerator path runs "
            "pure data parallelism"
        )
    out_dir = cfg_lib.prepare_out_dir(settings, args.settings_file)
    return run_ddp_training(
        partial(basic_accelerate_training, training=training, device=device,
                observability=cfg_lib.observability_config(settings)),
        world_size, out_dir, cfg_lib.optional_args_from(settings), backend=device, **rendezvous,
    )


if __name__ == "__main__":
    main()
