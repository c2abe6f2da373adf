"""A token job of the port on two Gloo processes, for
tests/test_torch_port_transformer_gloo.py.

    python tests/_torch_port_token_worker.py WORKDIR

``WORKDIR/job.json`` holds ``{"training": ..., "loaders": ...}``: the
native entry point's ``build_training`` of ``training`` (a
``transformer*`` model) fed by ``token_loaders(rank, world, **loaders)``,
the weights of ``WORKDIR/init.npz``, then its epoch loop, through the port's
own launcher (``run_ddp_training``, world 2, CPU, Gloo). Every rank saves
its ``state_dict`` to ``WORKDIR/final_{rank}.npz`` and its error-feedback
residual (when the comm hook keeps one) to ``WORKDIR/residual_{rank}.npz``;
rank 0 saves the history to ``WORKDIR/history.json``.

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

from tpuddp_torch import train_native  # noqa: E402
from tpuddp_torch.data.tokens import token_loaders  # noqa: E402
from tpuddp_torch.parallel.spawn import run_ddp_training  # noqa: E402
from tpuddp_torch.training.loop import run_training_loop  # noqa: E402


def worker(rank, world_size, save_dir, optional_args, workdir):
    torch.set_num_threads(2)
    with open(os.path.join(workdir, "job.json")) as f:
        job = json.load(f)
    training = job["training"]
    ddp, train, test, seed = train_native.build_training(
        rank, world_size, training, "cpu", partial(token_loaders, **job["loaders"]))
    with np.load(os.path.join(workdir, "init.npz")) as data:
        ddp.model.load_state_dict({k: torch.from_numpy(data[k]) for k in data.files})
    history = run_training_loop(
        ddp, train, test, None, num_epochs=training["num_epochs"], base_seed=seed,
        scan_steps=training["scan_steps"], log=lambda *a, **k: None)
    np.savez(os.path.join(workdir, f"final_{rank}.npz"),
             **{k: v.numpy() for k, v in ddp.model.state_dict().items()})
    if ddp.residual is not None:
        np.savez(os.path.join(workdir, f"residual_{rank}.npz"), vec=ddp.residual.numpy())
    if rank == 0:
        with open(os.path.join(workdir, "history.json"), "w") as f:
            json.dump(history, f)


if __name__ == "__main__":
    workdir = sys.argv[1]
    run_ddp_training(partial(worker, workdir=workdir), 2, workdir, {}, backend="cpu")
