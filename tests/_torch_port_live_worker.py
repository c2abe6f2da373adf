"""Traced and untraced native runs of the port for
tests/test_torch_port_trace.py (two Gloo processes on the CPU).

    python tests/_torch_port_live_worker.py WORKDIR

``WORKDIR/init.npz`` holds the toy_cnn ``state_dict`` (buffers included).
Through the port's own launcher (``run_ddp_training``, world 2, CPU, Gloo)
each rank trains a toy_cnn with sync_bn and the ``bf16_ef`` comm hook from
those weights at ``scan_steps: 4`` twice: with ``observability: {tracing:
true}`` into ``WORKDIR/traced`` and with no block into ``WORKDIR/plain``,
saving each run's state_dict to ``WORKDIR/{run}_{rank}.npz`` and, on rank 0,
its history to ``WORKDIR/{run}_history.json``. The schedule is
``tests/_torch_port_scan_worker.py``'s.

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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _torch_port_scan_worker as cfg  # noqa: E402

from tpuddp_torch.data import ShardedDataLoader  # noqa: E402
from tpuddp_torch.data.synthetic import SyntheticClassification  # noqa: E402
from tpuddp_torch.models import ToyCNN  # noqa: E402
from tpuddp_torch.nn import CrossEntropyLoss  # noqa: E402
from tpuddp_torch.nn.norm import convert_sync_batchnorm  # noqa: E402
from tpuddp_torch.optim import Adam  # noqa: E402
from tpuddp_torch.parallel.ddp import DistributedDataParallel  # noqa: E402
from tpuddp_torch.parallel.spawn import run_ddp_training  # noqa: E402
from tpuddp_torch.training.loop import run_training_loop  # noqa: E402

HOOK = "bf16_ef"
RUNS = {"traced": {"tracing": True}, "plain": None}


def train(rank, world_size, init, save_dir, observability):
    model = ToyCNN(10, cfg.WIDTHS, input_shape=cfg.SHAPE)
    model.load_state_dict(init)
    convert_sync_batchnorm(model)
    ddp = DistributedDataParallel(model, Adam(model.parameters(), lr=cfg.LR), CrossEntropyLoss(),
                                  device="cpu", comm_hook=HOOK)
    train_ds, test_ds = SyntheticClassification(n=cfg.DATA_N, shape=cfg.SHAPE,
                                                seed=cfg.DATA_SEED).split(cfg.DATA_TEST)
    history = run_training_loop(
        ddp,
        ShardedDataLoader(train_ds, cfg.BATCH, rank, world_size, shuffle=True),
        ShardedDataLoader(test_ds, cfg.BATCH, rank, world_size, shuffle=True),
        save_dir=save_dir, num_epochs=cfg.EPOCHS, checkpoint_epoch=cfg.EPOCHS,
        scan_steps=cfg.SCAN, observability=observability, log=lambda *_: None,
    )
    return history, ddp


def worker(rank, world_size, save_dir, optional_args, workdir):
    torch.set_num_threads(2)
    init = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(workdir, "init.npz")).items()}
    for name, observability in RUNS.items():
        history, ddp = train(rank, world_size, init, os.path.join(workdir, name), observability)
        np.savez(os.path.join(workdir, f"{name}_{rank}.npz"),
                 **{k: v.numpy() for k, v in ddp.model.state_dict().items()})
        if rank == 0:
            with open(os.path.join(workdir, f"{name}_history.json"), "w") as f:
                json.dump(history, f)


if __name__ == "__main__":
    workdir = sys.argv[1]
    run_ddp_training(partial(worker, workdir=workdir), 2, workdir, {}, backend="cpu")
