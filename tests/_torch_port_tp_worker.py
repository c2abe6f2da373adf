"""Tensor-parallel jobs of the port on one Gloo world, for
tests/test_torch_port_tp_gloo.py and tests/test_torch_port_tp_elastic.py.

    python tests/_torch_port_tp_worker.py WORKDIR WORLD
    python tests/_torch_port_tp_worker.py --train OUT_DIR EPOCHS

``--train`` is the elastic legs' token job, the JAX package's
``tests/_chaos_tp_worker.py`` on the port: ``transformer_tiny`` (V 64,
T 32, global batch 8, 4 batches an epoch) through ``run_ddp_training`` ->
``train_native.basic_ddp_training_loop`` on ``$TPUDDP_WORLD_SIZE``
processes (default 4) at ``parallel: {model: 2}`` unless
``$TPUDDP_MODEL_SIZE`` says otherwise, a checkpoint every epoch,
``reshard_on_mismatch: true``; ``$TPUDDP_FAULT`` and
``$TPUDDP_AUTO_RESUME`` act as on any run.

``WORKDIR/jobs.json`` is a list of jobs, run one after another in one world
of ``WORLD`` processes (the port's own launcher, ``run_ddp_training`` on
the CPU, Gloo). Each job builds the native entry point's wrap
(``train_native.build_training`` of a ``transformer*`` token job with the
job's ``parallel`` block), loads the whole model of ``WORKDIR/init.npz``
(each rank cutting its shard), runs its ``kind`` and saves what rank 0
gathers to ``WORKDIR/<name>.npz``:

- ``forward``: the logits of ``x`` (every rank's, which must agree);
- ``steps``: a train step per batch of ``batches.npz``: each step's loss
  (the data group's sums), the whole parameters after the first step and
  at the end, the moments after the first step, each rank's residual, the
  byte counters, then an eval step's sums;
- ``many``: the same batches as one ``train_step_many`` chunk and as
  single steps from one state, both end states;
- ``guard``: the wrap's audit, a step on a poisoned batch and a clean one;
- ``audit``: ``run_training_loop`` with the periodic audit on, two epochs
  on clean shards, then one more after rank ``corrupt[0]`` added
  ``corrupt[1]`` to one element of its shard of ``param``: the leaf every
  rank's ``ReplicaDesync`` names (in rank order), and ``param``'s JAX path;
- ``save``: one step, then a checkpoint into ``WORKDIR/<name>/``;
- ``load``: a restore of ``WORKDIR/<dir>/`` (its state, or the refusal's
  text), after waiting up to ``WAIT_S`` for its file's manifest (the test
  writes a JAX checkpoint while the world runs).

Imports only torch, numpy and ``tpuddp_torch``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from functools import partial

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpuddp_torch import config as cfg, train_native  # noqa: E402
from tpuddp_torch.data.tokens import token_loaders  # noqa: E402
from tpuddp_torch.parallel import tensor as tp_lib  # noqa: E402
from tpuddp_torch.parallel.spawn import run_ddp_training  # noqa: E402
from tpuddp_torch.resilience import guard as guard_lib  # noqa: E402
from tpuddp_torch.training import checkpoint as ckpt  # noqa: E402
from tpuddp_torch.training.loop import run_training_loop  # noqa: E402

WAIT_S = 240.0


def _wrap(job, rank, world, workdir):
    training = job["training"]
    ddp, _, _, _ = train_native.build_training(
        rank, world, training, "cpu", partial(token_loaders, **job["loaders"]),
        cfg.resolve_parallel(job.get("parallel")))
    with np.load(os.path.join(workdir, "init.npz")) as data:
        full = {k: torch.from_numpy(data[k]) for k in data.files}
    if ddp.model_size > 1:
        full = tp_lib.local_state_dict(full, ddp.mesh.model_index, ddp.model_size)
    ddp.model.load_state_dict(full)
    return ddp


def _rows(ddp, arrays):
    """This rank's rows of a global batch: its data replica's block."""
    index = ddp.rank if ddp.mesh is None else ddp.mesh.data_index
    n = arrays[0].shape[0] // ddp.data_size
    return tuple(torch.from_numpy(np.ascontiguousarray(a[index * n:(index + 1) * n])) for a in arrays)


def _global(ddp, sums):
    sums = sums.clone()
    if ddp.data_size > 1:
        dist.all_reduce(sums, group=ddp.metrics_group)
    return sums


def _moments(ddp):
    """The whole moments by parameter name (gathered over the model group)."""
    out = {}
    for key in ("exp_avg", "exp_avg_sq"):
        named = {n: ddp.optimizer.state[p][key] for n, p in ddp.model.named_parameters()}
        if ddp.model_size > 1:
            named = tp_lib.gather_named(named, ddp.mesh)
        for n, t in named.items():
            t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
            out[f"{key}/{n}"] = t.numpy()
    return out


def _params(ddp, prefix=""):
    return {prefix + k: v.numpy().copy() for k, v in ddp.gather_params().items()}


def _residuals(ddp):
    if ddp.residual is None:
        return {}
    parts = [torch.empty_like(ddp.residual) for _ in range(ddp.world_size)]
    dist.all_gather(parts, ddp.residual)
    return {"residual": torch.stack(parts).numpy()}


def _audit(job, rank, world, workdir):
    training = dict(job["training"])
    ddp, train, test, _ = train_native.build_training(
        rank, world, training, "cpu", partial(token_loaders, **job["loaders"]),
        cfg.resolve_parallel(job.get("parallel")))
    out_dir = os.path.join(workdir, job["name"])
    loop = partial(run_training_loop, ddp, train, test, out_dir, checkpoint_epoch=1, scan_steps=1,
                   log=lambda *_: None)
    loop(num_epochs=2)
    param = dict(ddp.model.named_parameters())[job["param"]]
    path = next(name for name, p in guard_lib.jax_leaf_names(ddp.model) if p is param)
    bad_rank, delta = job["corrupt"]
    if rank == bad_rank:
        with torch.no_grad():
            param.view(-1)[0] += delta
    try:
        loop(num_epochs=1)
        raised = ""
    except guard_lib.ReplicaDesync as e:
        raised = e.leaf
    verdicts = [None] * world
    dist.all_gather_object(verdicts, raised)
    return {"raised": np.asarray(verdicts), "path": np.asarray(path)}


def run_job(job, rank, world, workdir):
    kind = job["kind"]
    out = {}
    if kind == "audit":
        return _audit(job, rank, world, workdir)
    if kind == "load":
        ddp = _wrap(job, rank, world, workdir)
        manifest = os.path.join(workdir, job["dir"], "ckpt_0.npz.sha256")
        deadline = time.monotonic() + WAIT_S
        while not os.path.exists(manifest) and time.monotonic() < deadline:
            time.sleep(0.05)
        try:
            _, meta = ckpt.restore_latest(
                os.path.join(workdir, job["dir"]), ddp.model, ddp.optimizer,
                comm_state=ddp.residual, model_size=ddp.model_size,
                reshard_on_mismatch=job.get("reshard", False))
            out.update(_params(ddp), **_moments(ddp), **_residuals(ddp), step=meta["step"])
        except ckpt.TopologyMismatch as e:
            out["refused"] = np.asarray(str(e))
        return out
    ddp = _wrap(job, rank, world, workdir)
    with np.load(os.path.join(workdir, job.get("batches", "batches.npz"))) as data:
        batches = [(data["x"][i], data["y"][i], data["w"][i]) for i in range(len(data["x"]))]
    if kind == "forward":
        with torch.no_grad():
            logits = ddp.model(_rows(ddp, batches[0])[0])
        parts = [torch.empty_like(logits) for _ in range(world)]
        dist.all_gather(parts, logits.contiguous())
        out["logits"] = torch.stack(parts).numpy()
    elif kind == "steps":
        tp_lib.reset_counts()
        losses = []
        for i, b in enumerate(batches):
            s = _global(ddp, ddp.train_step(_rows(ddp, b)))
            losses.append(float(s[0] / s[1]))
            if i == 0:
                out.update(_params(ddp, "step1/"), **_moments(ddp))
        out.update(_params(ddp, "final/"), **_residuals(ddp), losses=np.asarray(losses))
        out["collectives"] = np.asarray([tp_lib.collectives_issued(k)
                                         for k in ("forward", "backward", "eval")])
        out["eval"] = _global(ddp, ddp.eval_step(_rows(ddp, batches[0]))).numpy()
        out["bytes"] = np.asarray([ddp.grad_comm_bytes_per_step, ddp.grad_comm_bytes_per_step_f32])
    elif kind == "many":
        rows = [_rows(ddp, b) for b in batches]
        ddp.train_step_many(rows)
        out.update(_params(ddp, "many/"))
        other = _wrap(job, rank, world, workdir)
        for b in rows:
            other.train_step(b)
        out.update(_params(other, "single/"))
    elif kind == "guard":
        before = _params(ddp, "before/")
        x, y, w = _rows(ddp, batches[0])
        w = w.clone()
        w[0, 0] = float("nan")
        ddp.train_step((x, y, w))
        out.update(before, **_params(ddp, "skipped/"))
        out["after_skip"] = np.asarray(ddp.skip_counters())
        ddp.train_step(_rows(ddp, batches[1]))
        out.update(_params(ddp, "clean/"))
        out["after_clean"] = np.asarray(ddp.skip_counters())
    elif kind == "save":
        ddp.train_step(_rows(ddp, batches[0]))
        ddp.step = 1
        ckpt.save_on_main(os.path.join(workdir, job["name"]), 0, ddp.model, ddp.optimizer, rank,
                          world_size=world, step=ddp.step, comm_state=ddp.residual)
        out.update(_params(ddp), **_moments(ddp), **_residuals(ddp))
        out["bytes"] = np.asarray([ddp.grad_comm_bytes_per_step, ddp.grad_comm_bytes_per_step_f32])
    return out


def worker(rank, world_size, save_dir, optional_args, workdir):
    torch.set_num_threads(2)
    with open(os.path.join(workdir, "jobs.json")) as f:
        jobs = json.load(f)
    for job in jobs:
        out = run_job(job, rank, world_size, workdir)
        if rank == 0:
            np.savez(os.path.join(workdir, job["name"] + ".npz"), **out)
        dist.barrier()


TRAIN = dict(model="transformer_tiny", num_classes=64, learning_rate=1e-3, seed=0,
             checkpoint_epoch=1, scan_steps=2, dataset="synthetic_tokens",
             reshard_on_mismatch=True)
TRAIN_LOADERS = dict(vocab=64, seq_len=32, global_batch=8, n_batches=4)


def train(out_dir: str, epochs: int):
    training = dict(cfg.TRAINING_DEFAULTS, num_epochs=epochs, **TRAIN)
    parallel = cfg.resolve_parallel({"model": 2})  # $TPUDDP_MODEL_SIZE overrides the width
    world = int(os.environ.get("TPUDDP_WORLD_SIZE") or 4)
    torch.set_num_threads(2)
    run_ddp_training(
        partial(train_native.basic_ddp_training_loop, training=training, device="cpu",
                loaders=partial(token_loaders, **TRAIN_LOADERS), parallel=parallel),
        world, out_dir, {}, backend="cpu")


if __name__ == "__main__":
    if sys.argv[1] == "--train":
        train(sys.argv[2], int(sys.argv[3]))
    else:
        workdir, world = sys.argv[1], int(sys.argv[2])
        run_ddp_training(partial(worker, workdir=workdir), world, workdir, {}, backend="cpu")
