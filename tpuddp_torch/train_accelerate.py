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
"""

from __future__ import annotations

import argparse
import logging
import time
from functools import partial
from typing import Optional

import torch

from tpuddp_torch import config as cfg_lib
from tpuddp_torch import seeding
from tpuddp_torch.accelerate import Accelerator, FusedEvaluator, sum_losses
from tpuddp_torch.data import (
    DataLoader, PrefetchLoader, compute_dtype_for, flip_for, load_datasets_for,
    norm_stats_for,
)
from tpuddp_torch.data.transforms import make_eval_transform, make_train_augment
from tpuddp_torch.models.convert import jax_leaf_index
from tpuddp_torch.nn import CrossEntropyLoss
from tpuddp_torch.parallel import comm
from tpuddp_torch.parallel.collectives import all_reduce_sum_
from tpuddp_torch.parallel.spawn import resolve_world, run_ddp_training
from tpuddp_torch.resilience import guard as guard_lib
from tpuddp_torch.train_native import load_model_for, set_numerics
from tpuddp_torch.training import checkpoint as ckpt
from tpuddp_torch.training.loop import StepClock, append_row, event, nan_injector
from tpuddp_torch.training.pipeline import StagedLoader, resolve_pipeline


def setup_dataloaders(training):
    """Plain, distribution-unaware loaders (reference :22-36); ``prepare``
    re-creates the train loader sharded."""
    train_dataset, test_dataset = load_datasets_for(training)
    train_loader = DataLoader(train_dataset, batch_size=training["train_batch_size"], shuffle=True)
    test_loader = DataLoader(test_dataset, batch_size=training["test_batch_size"])
    return train_loader, test_loader


def train(model, train_loader, criterion, optimizer, accelerator,
          clock: Optional[StepClock] = None):
    """One training epoch; returns ``(mean per-step loss, real rows of the
    global batches)``. A partial accumulation cycle is applied at the end;
    the fuse queue's last steps run at the epoch's ``sum_losses``."""
    model.train()
    n_seen = torch.zeros((), device=model.device)
    losses = []
    pending = 0  # steps of the open group (queued, or not yet marked)
    for inputs, labels, weights in train_loader:
        n_seen = n_seen + model.to_device(weights, torch.float32).sum()
        optimizer.zero_grad()
        if clock is not None and pending == 0:
            clock.mark()
        outputs = model(inputs)  # flip/normalize/resize run inside the step's forward
        loss = criterion(outputs, labels, weights)
        accelerator.backward(loss)
        optimizer.step()
        losses.append(loss)
        pending += 1
        if not optimizer.queued:  # the step ran, or the flush it filled did
            if clock is not None:
                clock.groups.append(pending)
            pending = 0
    optimizer.flush_accumulation()
    loss_sum = sum_losses(losses)  # flushes what is still queued
    if clock is not None:
        if pending:
            clock.groups.append(pending)
        clock.mark()
    # one read of the loss sum and of the rows every process saw
    totals = torch.stack([loss_sum, n_seen])
    all_reduce_sum_([totals[1:]])
    loss_sum, n_seen = totals.tolist()
    return loss_sum / len(train_loader), n_seen


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
):
    """Run epochs ``start_epoch`` to ``num_epochs``; returns the list of
    per-epoch records."""
    # nan@step=N: the train loader's staging poisons that host micro-batch
    train_loader.inject = nan_injector()
    guard = accelerator.guard
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
        if accelerator.is_main_process:
            append_row(save_dir, event("rollback", epoch=epoch, resume_epoch=redo, reason=reason))
        accelerator.print(f"Guard rollback ({reason}): restored last-good state, "
                          f"redoing from epoch {redo}.")
        return redo

    history = []
    epoch = start_epoch
    while epoch < num_epochs:
        if guard.enabled and guard.audit_every_n_epochs and \
                (epoch - start_epoch) % guard.audit_every_n_epochs == 0:
            bad_leaf = guard_lib.audit_params(model.module)
            if bad_leaf is not None:
                if accelerator.is_main_process:
                    append_row(save_dir, event("desync", epoch=epoch, leaf=bad_leaf))
                if guard.on_desync == "rollback":
                    redo = rollback(epoch, f"replica desync at leaf {bad_leaf}")
                    if redo is not None:
                        epoch, prev_skips = redo, optimizer.skip_counters()[0]
                        continue
                raise guard_lib.ReplicaDesync(bad_leaf, where=f"epoch {epoch} audit")
        epoch_t0 = time.perf_counter()
        train_loader.set_epoch(epoch)
        clock = StepClock(accelerator.device)
        updates = optimizer.updates
        train_loss, train_samples = train(
            model, train_loader, criterion, optimizer, accelerator, clock
        )
        step_ms = clock.step_ms()
        train_time_s = time.perf_counter() - epoch_t0
        test_loss, test_accuracy, test_samples = evaluate(
            model, test_loader, criterion, eval_transform, deferred=deferred_metrics
        )
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
        history.append(record)
        if accelerator.is_main_process:
            append_row(save_dir, record)
            if epoch_skips:
                append_row(save_dir, event("skipped_updates", epoch=epoch, count=epoch_skips,
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
    training: Optional[dict] = None, device: str = "cuda",
):
    """Per-process worker; returns the epoch history."""
    training = dict(training or cfg_lib.TRAINING_DEFAULTS)
    accelerator, model, optimizer, train_loader, test_loader, criterion, eval_transform = (
        build_training(training, device)
    )
    start_epoch = 0
    if save_dir is not None and (
        training.get("resume") or training.get("auto_resume") or ckpt.auto_resume_requested()
    ):
        start_epoch = accelerator.load_state(model, optimizer, save_dir)
        if start_epoch:
            accelerator.print(f"Resumed from epoch {start_epoch - 1} state.")
    return run_training_loop(
        model, train_loader, test_loader, criterion, optimizer, save_dir, accelerator,
        eval_transform, num_epochs=training["num_epochs"],
        checkpoint_epoch=training["checkpoint_epoch"],
        deferred_metrics=bool(training.get("deferred_metrics")),
        start_epoch=start_epoch,
        keep_last=int(training["keep_last"]) if training.get("keep_last") else None,
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
    cfg_lib.check_settings(settings, world_size)
    training = cfg_lib.training_config(settings)
    out_dir = cfg_lib.prepare_out_dir(settings, args.settings_file)
    return run_ddp_training(
        partial(basic_accelerate_training, training=training, device=device),
        world_size, out_dir, cfg_lib.optional_args_from(settings), backend=device, **rendezvous,
    )


if __name__ == "__main__":
    main()
