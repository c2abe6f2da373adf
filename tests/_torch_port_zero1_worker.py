"""ZeRO-1 runs of the port on two Gloo processes, for
tests/test_torch_port_zero1_gloo.py and tests/test_torch_port_zero1_ckpt.py.

    python tests/_torch_port_zero1_worker.py WORKDIR

``WORKDIR/jobs.json`` holds a list of jobs, each run in order by every rank
of one launch (the port's ``run_ddp_training``, world 2, CPU, Gloo):

- ``{"kind": "run", "name", "path", "training"}`` (and optionally
  ``"save_dir"``, ``"resume"``): the entry point's ``build_training`` of
  ``path`` (``native``: ``train_native``; ``managed``: ``train_accelerate``)
  on ``training``, the weights of ``WORKDIR/{name}_init.npz`` when it
  exists, then the entry point's epoch loop (checkpoints into ``save_dir``;
  with ``resume`` the newest one there is restored first). Every rank saves
  its state_dict to ``{name}_{rank}.npz`` and its optimizer state to
  ``{name}_opt_{rank}.npz`` (the shard's slots, ``lo``, ``hi`` and
  ``step``; the per-parameter state without ZeRO-1); rank 0 saves the
  history to ``{name}_history.json``;
- ``{"kind": "restore", "name", "path", "training", "dir"}``: the same
  objects, the newest checkpoint of ``dir`` restored into them, then saved
  as a "run" saves them;
- ``{"kind": "exchange", "name", "hook", "sizes", "cap", "density"}``: the
  comm hook's bucketed ``reduce`` and ZeRO-1 ``reduce_scatter`` of
  ``parallel/comm.py`` on this rank's row of ``g`` and ``r`` in
  ``WORKDIR/{name}_inputs.npz``, saved to ``{name}_{rank}.npz``.

A job may also carry ``"vgg_plans"`` (plans registered in the port's
``VGG_PLANS`` before the build, a test's narrow VGG) and ``"dropout"``
(every ``Dropout``'s ``p`` after it).

With a comm hook, every rank also saves its error-feedback residual to
``{name}_residual_{rank}.npz`` (native: ``vec``; managed: one array per
parameter name). A native "run" also saves ``{name}_overlap_{rank}.json``:
the wrap's ``comm_overlap_meta`` and, for the segmented step, how many
segment exchanges were issued from the backward and at the join.

Imports only torch, numpy and ``tpuddp_torch``.
"""

from __future__ import annotations

import json
import os
import sys
from functools import partial

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpuddp_torch import train_accelerate, train_native  # noqa: E402
from tpuddp_torch.models import vgg  # noqa: E402
from tpuddp_torch.optim import ShardedUpdate  # noqa: E402
from tpuddp_torch.parallel import comm  # noqa: E402
from tpuddp_torch.parallel.spawn import run_ddp_training  # noqa: E402
from tpuddp_torch.training import checkpoint as ckpt  # noqa: E402
from tpuddp_torch.training.loop import run_training_loop  # noqa: E402


def build(rank, world_size, path, training):
    """``(model, optimizer, train)``: the entry point's objects and a
    function ``train(save_dir, resume) -> history`` (managed: with
    ``train.load(directory)``, the accelerator's ``load_state``)."""
    if path == "native":
        ddp, train_loader, test_loader, seed = train_native.build_training(
            rank, world_size, training, "cpu")

        def train(save_dir, resume):
            return run_training_loop(
                ddp, train_loader, test_loader, save_dir, num_epochs=training["num_epochs"],
                checkpoint_epoch=training["checkpoint_epoch"], base_seed=seed,
                auto_resume=resume, scan_steps=training.get("scan_steps", "auto"),
                log=lambda *_: None)

        train.residual = lambda: ddp.residual
        train.overlap = lambda: {"meta": ddp.comm_overlap_meta,
                                 "counts": None if ddp._overlap is None else ddp._overlap.counts}
        return ddp.model, ddp.optimizer, train
    acc, model, opt, train_loader, test_loader, criterion, eval_transform = (
        train_accelerate.build_training(training, "cpu"))

    def train(save_dir, resume):
        start = acc.load_state(model, opt, save_dir) if resume else 0
        return train_accelerate.run_training_loop(
            model, train_loader, test_loader, criterion, opt, save_dir, acc, eval_transform,
            num_epochs=training["num_epochs"], checkpoint_epoch=training["checkpoint_epoch"],
            deferred_metrics=bool(training.get("deferred_metrics")), start_epoch=start)

    train.load = partial(acc.load_state, model, opt)
    train.residual = opt.comm_residual
    return model.module, opt.optimizer, train


def optimizer_state(model, optimizer) -> dict:
    """The optimizer's state as numpy float32 arrays: a ZeRO-1 shard's
    slots with its bounds, or each parameter's slots by name."""
    out = {}
    if isinstance(optimizer, ShardedUpdate):
        state = optimizer.state.get(optimizer.shard, {})
        out.update(lo=np.asarray(optimizer.lo), hi=np.asarray(optimizer.hi))
        params = [("", optimizer.shard)]
    else:
        state = None
        params = list(model.named_parameters())
    for name, p in params:
        st = state if state is not None else optimizer.state.get(p, {})
        for k, v in st.items():
            out[f"{name}/{k}"] = np.asarray(v) if not torch.is_tensor(v) else v.float().numpy()
    return out


def save(workdir, name, rank, model, optimizer, history=None, residual=None):
    prefix = os.path.join(workdir, f"{name}_")
    np.savez(f"{prefix}{rank}.npz", **{k: v.numpy() for k, v in model.state_dict().items()})
    np.savez(f"{prefix}opt_{rank}.npz", **optimizer_state(model, optimizer))
    if torch.is_tensor(residual):
        np.savez(f"{prefix}residual_{rank}.npz", vec=residual.numpy())
    elif residual is not None:
        np.savez(f"{prefix}residual_{rank}.npz",
                 **{n: r.numpy() for (n, _), r in zip(model.named_parameters(), residual)})
    if rank == 0 and history is not None:
        with open(prefix + "history.json", "w") as f:
            json.dump(history, f)


def exchange(workdir, job, rank, world_size):
    """One comm hook's bucketed reduce and ZeRO-1 reduce-scatter of this
    rank's inputs (the exchange's order: the JAX package's)."""
    with np.load(os.path.join(workdir, f"{job['name']}_inputs.npz")) as data:
        g, r = data["g"][rank], data["r"][rank]
    plan = comm.make_grad_comm(job["sizes"], world_size, job["hook"], job["cap"], job["density"])
    out = {}
    for kind in ("reduce", "reduce_scatter"):
        res = torch.from_numpy(r.copy()) if plan.needs_residual else None
        if kind == "reduce":
            vec, res = plan.reduce(torch.from_numpy(g.copy()), res)
        else:
            vec, res = plan.reduce_scatter(torch.from_numpy(g.copy()), res, rank)
        out[kind] = vec.numpy()
        if res is not None:
            out[f"{kind}_residual"] = res.numpy()
    np.savez(os.path.join(workdir, f"{job['name']}_{rank}.npz"), **out)


def worker(rank, world_size, save_dir, optional_args, workdir):
    torch.set_num_threads(2)
    with open(os.path.join(workdir, "jobs.json")) as f:
        jobs = json.load(f)
    for job in jobs:
        if job["kind"] == "exchange":
            exchange(workdir, job, rank, world_size)
            continue
        vgg.VGG_PLANS.update(job.get("vgg_plans", {}))
        model, optimizer, train = build(rank, world_size, job["path"], job["training"])
        if "dropout" in job:
            for m in model.modules():
                if isinstance(m, torch.nn.Dropout):
                    m.p = job["dropout"]
        init = os.path.join(workdir, f"{job['name']}_init.npz")
        if os.path.exists(init):
            with np.load(init) as data:
                model.load_state_dict({k: torch.from_numpy(data[k]) for k in data.files})
        if job["kind"] == "restore":
            if job["path"] == "native":
                ckpt.restore_latest(job["dir"], model, optimizer, comm_state=train.residual())
            else:
                train.load(job["dir"])
            save(workdir, job["name"], rank, model, optimizer, residual=train.residual())
            continue
        if job.get("save_dir"):
            os.makedirs(job["save_dir"], exist_ok=True)
        history = train(job.get("save_dir"), bool(job.get("resume")))
        save(workdir, job["name"], rank, model, optimizer, history, train.residual())
        if hasattr(train, "overlap"):
            with open(os.path.join(workdir, f"{job['name']}_overlap_{rank}.json"), "w") as f:
                json.dump(train.overlap(), f)


if __name__ == "__main__":
    workdir = sys.argv[1]
    run_ddp_training(partial(worker, workdir=workdir), 2, workdir, {}, backend="cpu")
