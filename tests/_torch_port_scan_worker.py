"""Native ``scan_steps`` runs of the port for tests/test_torch_port_scan_train.py
(in-process, world 1) and tests/test_torch_port_scan_gloo.py (two Gloo
processes).

    python tests/_torch_port_scan_worker.py WORKDIR

``WORKDIR/init.npz`` holds the toy_cnn ``state_dict`` (buffers included)
and ``WORKDIR/run.json`` a list of gradient-accumulation depths. Through
the port's own launcher (``run_ddp_training``, world 2, CPU, Gloo) each rank
trains, for each depth A, a toy_cnn with sync_bn from those weights for
``EPOCHS`` epochs of the synthetic dataset at ``scan_steps: SCAN`` (batches
of ``BATCH`` rows per rank, the last ragged), saving the state_dict and the
micro-batch count to ``WORKDIR/a{A}_{rank}.npz`` and, on rank 0, the history
to ``WORKDIR/a{A}_history.json``.

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

# shared with the tests: dataset, model and schedule of the parity runs
DATA_N, DATA_TEST, DATA_SEED, SHAPE = 120, 30, 7, (8, 8, 3)
WIDTHS, LR, BATCH, EPOCHS, SCAN = (4, 8), 1e-2, 7, 2, 4


def train(rank, world_size, init, accum):
    """One run; returns ``(history, ddp)``."""
    model = ToyCNN(10, WIDTHS, input_shape=SHAPE)
    model.load_state_dict(init)
    convert_sync_batchnorm(model)
    ddp = DistributedDataParallel(model, Adam(model.parameters(), lr=LR), CrossEntropyLoss(),
                                  device="cpu", grad_accumulation=accum)
    train_ds, test_ds = SyntheticClassification(n=DATA_N, shape=SHAPE, seed=DATA_SEED).split(DATA_TEST)
    history = run_training_loop(
        ddp,
        ShardedDataLoader(train_ds, BATCH, rank, world_size, shuffle=True),
        ShardedDataLoader(test_ds, BATCH, rank, world_size, shuffle=True),
        save_dir=None, num_epochs=EPOCHS, scan_steps=SCAN, log=lambda *_: None,
    )
    return history, ddp


def worker(rank, world_size, save_dir, optional_args, workdir):
    torch.set_num_threads(2)
    init = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(workdir, "init.npz")).items()}
    with open(os.path.join(workdir, "run.json")) as f:
        depths = json.load(f)
    for accum in depths:
        history, ddp = train(rank, world_size, init, accum)
        np.savez(os.path.join(workdir, f"a{accum}_{rank}.npz"), __step__=np.array(ddp.step),
                 **{k: v.numpy() for k, v in ddp.model.state_dict().items()})
        if rank == 0:
            with open(os.path.join(workdir, f"a{accum}_history.json"), "w") as f:
                json.dump(history, f)


if __name__ == "__main__":
    workdir = sys.argv[1]
    run_ddp_training(partial(worker, workdir=workdir), 2, workdir, {}, backend="cpu")
