"""Two-process Gloo run of the port for tests/test_torch_port_train.py.

    python tests/_torch_port_worker.py WORKDIR

``WORKDIR/init.npz`` holds the ToyMLP ``state_dict`` (keys as saved by the
test) and ``WORKDIR/grad_batches.npz`` one fixed batch per rank. Through the
port's own launcher (``run_ddp_training``, world 2, CPU, Gloo) each rank:

1. wraps a ToyMLP in the port's DDP, takes one train step on its batch and
   saves the synced gradients to ``WORKDIR/grads_{rank}.npz``;
2. wraps a fresh ToyMLP from the same weights and trains 2 epochs on the
   synthetic dataset (padded last batches), rank 0 saving the history to
   ``WORKDIR/history.json``.

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
from tpuddp_torch.models import ToyMLP  # noqa: E402
from tpuddp_torch.nn import CrossEntropyLoss  # noqa: E402
from tpuddp_torch.optim import Adam  # noqa: E402
from tpuddp_torch.parallel.ddp import DistributedDataParallel  # noqa: E402
from tpuddp_torch.parallel.spawn import run_ddp_training  # noqa: E402
from tpuddp_torch.training.loop import run_training_loop  # noqa: E402

# shared with the test: dataset, model and schedule of the parity run
DATA_N, DATA_TEST, DATA_SEED, SHAPE = 120, 30, 7, (8, 8, 3)
HIDDEN, LR, BATCH, EPOCHS = (16,), 1e-2, 8, 2


def make_ddp(workdir):
    sd = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(workdir, "init.npz")).items()}
    model = ToyMLP(int(np.prod(SHAPE)), 10, HIDDEN)
    model.load_state_dict(sd)
    return DistributedDataParallel(
        model, Adam(model.parameters(), lr=LR), CrossEntropyLoss(), device="cpu"
    )


def worker(rank, world_size, save_dir, optional_args, workdir):
    torch.set_num_threads(2)
    batches = np.load(os.path.join(workdir, "grad_batches.npz"))
    ddp = make_ddp(workdir)
    ddp.train_step((batches[f"x{rank}"], batches[f"y{rank}"], batches[f"w{rank}"]))
    np.savez(
        os.path.join(workdir, f"grads_{rank}.npz"),
        **{k: p.grad.numpy() for k, p in ddp.model.named_parameters()},
    )

    train, test = SyntheticClassification(n=DATA_N, shape=SHAPE, seed=DATA_SEED).split(DATA_TEST)
    ddp = make_ddp(workdir)
    history = run_training_loop(
        ddp,
        ShardedDataLoader(train, BATCH, rank, world_size, shuffle=True),
        ShardedDataLoader(test, BATCH, rank, world_size, shuffle=True),
        save_dir=None, num_epochs=EPOCHS, per_replica_log=True,
    )
    if rank == 0:
        with open(os.path.join(workdir, "history.json"), "w") as f:
            json.dump(history, f)


if __name__ == "__main__":
    workdir = sys.argv[1]
    run_ddp_training(partial(worker, workdir=workdir), 2, workdir, {}, backend="cpu")
