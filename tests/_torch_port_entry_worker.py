"""Entry-point runs of the port from a settings block, for
tests/test_torch_port_optim_train.py, tests/test_torch_port_digits.py and
tests/test_torch_port_fuse_train.py.

    python tests/_torch_port_entry_worker.py WORKDIR

``WORKDIR/run.json`` holds a list of runs, each ``{"name", "path",
"training"}``; ``WORKDIR/{name}_init.npz`` holds the model's state_dict.
Through the port's own launcher (``run_ddp_training``, world 2, CPU, Gloo)
each rank does every run in order with :func:`run`: the entry point's
``build_training`` of ``path`` (``native``: ``train_native``; ``managed``:
``train_accelerate``) on ``training``, the weights of ``{name}_init.npz``,
then the entry point's epoch loop. Rank 0 saves the history to
``{name}_history.json``; every rank saves its state_dict to
``{name}_{rank}.npz``.

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
from tpuddp_torch.parallel.spawn import run_ddp_training  # noqa: E402
from tpuddp_torch.training.loop import run_training_loop  # noqa: E402


def run(rank: int, world_size: int, path: str, training: dict, init: dict):
    """One run of the entry point ``path``: ``(history, state_dict)``."""
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in init.items()}
    if path == "native":
        ddp, train_loader, test_loader, _ = train_native.build_training(
            rank, world_size, training, "cpu")
        ddp.model.load_state_dict(sd)
        history = run_training_loop(ddp, train_loader, test_loader, None,
                                    num_epochs=training["num_epochs"], log=lambda *_: None)
        return history, ddp.model.state_dict()
    acc, model, opt, train_loader, test_loader, criterion, eval_transform = (
        train_accelerate.build_training(training, "cpu"))
    model.module.load_state_dict(sd)
    history = train_accelerate.run_training_loop(
        model, train_loader, test_loader, criterion, opt, None, acc, eval_transform,
        num_epochs=training["num_epochs"], checkpoint_epoch=training["checkpoint_epoch"],
        deferred_metrics=bool(training.get("deferred_metrics")))
    return history, model.module.state_dict()


def worker(rank, world_size, save_dir, optional_args, workdir):
    torch.set_num_threads(2)
    with open(os.path.join(workdir, "run.json")) as f:
        runs = json.load(f)
    for r in runs:
        prefix = os.path.join(workdir, f"{r['name']}_")
        history, sd = run(rank, world_size, r["path"], r["training"], dict(np.load(prefix + "init.npz")))
        np.savez(f"{prefix}{rank}.npz", **{k: v.numpy() for k, v in sd.items()})
        if rank == 0:
            with open(prefix + "history.json", "w") as f:
                json.dump(history, f)


if __name__ == "__main__":
    workdir = sys.argv[1]
    run_ddp_training(partial(worker, workdir=workdir), 2, workdir, {}, backend="cpu")
