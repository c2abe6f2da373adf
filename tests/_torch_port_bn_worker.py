"""Two-process Gloo runs of the port's BatchNorm paths for
tests/test_torch_port_bn.py.

    python tests/_torch_port_bn_worker.py WORKDIR

``WORKDIR/run.json`` says what to run (``{"mode": "toy_cnn", "sync_bn":
bool}`` or ``{"mode": "buffers"}``). Through the port's own launcher
(``run_ddp_training``, world 2, CPU, Gloo) each rank:

- mode ``toy_cnn``: wraps a ToyCNN from ``WORKDIR/init.npz`` (its state_dict,
  buffers included) with ``sync_bn`` as asked, takes one train step on its
  batch of ``WORKDIR/grad_batches.npz`` and saves the synced gradients and
  the buffers to ``WORKDIR/step_{rank}.npz``; then wraps a fresh one from the
  same weights and trains 2 epochs on the synthetic dataset (padded last
  batches), saving the buffers to ``WORKDIR/final_{rank}.npz`` and, on rank 0,
  the history to ``WORKDIR/history.json``;
- mode ``buffers``: wraps a model whose buffer takes the mean of each
  forward's (rank-dependent) batch, takes one step and saves the buffer to
  ``WORKDIR/buffers_{rank}.npz``.

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

from tpuddp_torch.data import ShardedDataLoader  # noqa: E402
from tpuddp_torch.data.synthetic import SyntheticClassification  # noqa: E402
from tpuddp_torch.models import ToyCNN  # noqa: E402
from tpuddp_torch.nn import CrossEntropyLoss  # noqa: E402
from tpuddp_torch.nn.norm import convert_sync_batchnorm  # noqa: E402
from tpuddp_torch.optim import Adam  # noqa: E402
from tpuddp_torch.parallel.ddp import DistributedDataParallel  # noqa: E402
from tpuddp_torch.parallel.spawn import run_ddp_training  # noqa: E402
from tpuddp_torch.training.loop import run_training_loop  # noqa: E402

# shared with the test: dataset, model and schedule of the parity run
DATA_N, DATA_TEST, DATA_SEED, SHAPE = 120, 30, 7, (8, 8, 3)
WIDTHS, LR, BATCH, EPOCHS = (4, 8), 1e-2, 8, 2


def make_ddp(workdir, sync_bn):
    sd = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(workdir, "init.npz")).items()}
    model = ToyCNN(10, WIDTHS, input_shape=SHAPE)
    model.load_state_dict(sd)
    if sync_bn:
        convert_sync_batchnorm(model)
    return DistributedDataParallel(
        model, Adam(model.parameters(), lr=LR), CrossEntropyLoss(), device="cpu"
    )


def buffers(model):
    return {k: b.numpy().copy() for k, b in model.named_buffers()}


def toy_cnn(rank, world_size, workdir, sync_bn):
    batches = np.load(os.path.join(workdir, "grad_batches.npz"))
    ddp = make_ddp(workdir, sync_bn)
    ddp.train_step((batches[f"x{rank}"], batches[f"y{rank}"], batches[f"w{rank}"]))
    np.savez(
        os.path.join(workdir, f"step_{rank}.npz"),
        **{f"grad/{k}": p.grad.numpy() for k, p in ddp.model.named_parameters()},
        **{f"buffer/{k}": v for k, v in buffers(ddp.model).items()},
    )

    train, test = SyntheticClassification(n=DATA_N, shape=SHAPE, seed=DATA_SEED).split(DATA_TEST)
    ddp = make_ddp(workdir, sync_bn)
    history = run_training_loop(
        ddp,
        ShardedDataLoader(train, BATCH, rank, world_size, shuffle=True),
        ShardedDataLoader(test, BATCH, rank, world_size, shuffle=True),
        save_dir=None, num_epochs=EPOCHS,
    )
    np.savez(os.path.join(workdir, f"final_{rank}.npz"), **buffers(ddp.model))
    if rank == 0:
        with open(os.path.join(workdir, "history.json"), "w") as f:
            json.dump(history, f)


class BatchMean(torch.nn.Module):
    """A buffer that takes the mean of each train forward's batch: on two
    ranks with different batches it diverges unless the wrap syncs it."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(3, 2)
        self.register_buffer("seen", torch.zeros(3))

    def forward(self, x):
        if self.training:
            self.seen.copy_(x.mean(0))
        return self.lin(x)


def buffer_sync(rank, world_size, workdir):
    x = np.full((4, 3), float(rank + 1), np.float32)
    model = BatchMean()
    ddp = DistributedDataParallel(model, Adam(model.parameters()), CrossEntropyLoss(), device="cpu")
    ddp.train_step((x, np.zeros(4, np.int64), np.ones(4, np.float32)))
    np.savez(os.path.join(workdir, f"buffers_{rank}.npz"), seen=model.seen.numpy())


def worker(rank, world_size, save_dir, optional_args, workdir):
    torch.set_num_threads(2)
    with open(os.path.join(workdir, "run.json")) as f:
        run = json.load(f)
    if run["mode"] == "toy_cnn":
        toy_cnn(rank, world_size, workdir, run["sync_bn"])
    else:
        buffer_sync(rank, world_size, workdir)


if __name__ == "__main__":
    workdir = sys.argv[1]
    run_ddp_training(partial(worker, workdir=workdir), 2, workdir, {}, backend="cpu")
