"""Two-process Gloo runs of the port's managed path and of native gradient
accumulation for tests/test_torch_port_accelerate.py and
tests/test_torch_port_accum.py.

    python tests/_torch_port_accel_worker.py WORKDIR

``WORKDIR/run.json`` holds a list of runs, each ``{"name", "mode", "model",
"accum", ...}``, whose files are prefixed with ``WORKDIR/{name}_``. Through
the port's own launcher (``run_ddp_training``, world 2, CPU, Gloo) each rank
does every run in order:

- mode ``managed``: builds ``model`` from ``{name}_init.npz`` (its
  state_dict), prepares it with an Adam through an ``Accelerator`` (no
  augment, ``accum`` accumulation steps) and takes one ``backward``/``step``
  per global batch of ``{name}_batches.npz`` (``x{i}``, ``y{i}``, ``w{i}``;
  rank 1 perturbs its weights before ``prepare``, which must undo that),
  feeding rank ``r`` the ``r``-th half of its rows, then
  ``flush_accumulation()``. It saves every step's loss, the synced gradient
  that ``backward`` left, the state_dict after every step and the final one
  to ``{name}_{rank}.npz`` (``loss{i}``, ``grad{i}/<param>``,
  ``step{i}/<key>``, ``final/<key>``);
- mode ``native_accum``: wraps the same model in the native DDP with
  ``grad_accumulation = accum`` and trains ``EPOCHS`` epochs of the
  synthetic dataset with ``BATCH`` rows per rank (a ragged last batch and an
  all-padding tail micro-batch), saving the history (rank 0) to
  ``{name}_history.json`` and the state_dict to ``{name}_{rank}.npz``.

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

from tpuddp_torch.accelerate import Accelerator  # noqa: E402
from tpuddp_torch.data import ShardedDataLoader  # noqa: E402
from tpuddp_torch.data.synthetic import SyntheticClassification  # noqa: E402
from tpuddp_torch.models import ToyCNN, ToyMLP  # noqa: E402
from tpuddp_torch.nn import CrossEntropyLoss  # noqa: E402
from tpuddp_torch.optim import Adam  # noqa: E402
from tpuddp_torch.parallel.ddp import DistributedDataParallel  # noqa: E402
from tpuddp_torch.parallel.spawn import run_ddp_training  # noqa: E402
from tpuddp_torch.training.loop import run_training_loop  # noqa: E402

# shared with the tests: models, dataset and schedule of the parity runs
SHAPE, HIDDEN, WIDTHS, LR = (8, 8, 3), (16,), (4, 8), 1e-2
DATA_N, DATA_TEST, DATA_SEED, BATCH, EPOCHS = 120, 30, 7, 7, 2


def make_model(name: str, init_path: str) -> torch.nn.Module:
    model = ToyMLP(int(np.prod(SHAPE)), 10, HIDDEN) if name == "toy_mlp" else \
        ToyCNN(10, WIDTHS, input_shape=SHAPE)
    sd = {k: torch.from_numpy(v) for k, v in np.load(init_path).items()}
    model.load_state_dict(sd)
    return model


def state(module) -> dict:
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


def managed(rank, prefix, run):
    batches = np.load(prefix + "batches.npz")
    acc = Accelerator(seed=0, gradient_accumulation_steps=run["accum"], device="cpu")
    module = make_model(run["model"], prefix + "init.npz")
    if rank == 1:  # prepare must hand every process rank 0's weights
        with torch.no_grad():
            for p in module.parameters():
                p.add_(1.0)
    model, opt = acc.prepare(module, Adam(module.parameters(), lr=LR))
    criterion = CrossEntropyLoss()
    out = {}
    for i in range(len(batches.files) // 3):
        x, y, w = (batches[f"{k}{i}"] for k in "xyw")
        half = len(y) // 2
        rows = slice(rank * half, (rank + 1) * half)
        opt.zero_grad()
        outputs = model(x[rows])
        loss = criterion(outputs, y[rows], w[rows])
        acc.backward(loss)
        out.update({f"grad{i}/{k}": p.grad.numpy().copy()
                    for k, p in model.module.named_parameters()})
        opt.step()
        out[f"loss{i}"] = np.asarray(loss.item())
        out.update({f"step{i}/{k}": v for k, v in state(model.module).items()})
    opt.flush_accumulation()
    out.update({f"final/{k}": v for k, v in state(model.module).items()})
    np.savez(f"{prefix}{rank}.npz", **out)


def native_accum(rank, world_size, prefix, run):
    module = make_model(run["model"], prefix + "init.npz")
    ddp = DistributedDataParallel(
        module, Adam(module.parameters(), lr=LR), CrossEntropyLoss(), device="cpu",
        grad_accumulation=run["accum"],
    )
    train, test = SyntheticClassification(n=DATA_N, shape=SHAPE, seed=DATA_SEED).split(DATA_TEST)
    history = run_training_loop(
        ddp,
        ShardedDataLoader(train, BATCH, rank, world_size, shuffle=True),
        ShardedDataLoader(test, BATCH, rank, world_size, shuffle=True),
        save_dir=None, num_epochs=EPOCHS,
    )
    np.savez(f"{prefix}{rank}.npz", **state(ddp.model))
    if rank == 0:
        with open(prefix + "history.json", "w") as f:
            json.dump(history, f)


def worker(rank, world_size, save_dir, optional_args, workdir):
    torch.set_num_threads(2)
    with open(os.path.join(workdir, "run.json")) as f:
        runs = json.load(f)
    for run in runs:
        prefix = os.path.join(workdir, f"{run['name']}_")
        if run["mode"] == "managed":
            managed(rank, prefix, run)
        else:
            native_accum(rank, world_size, prefix, run)


if __name__ == "__main__":
    workdir = sys.argv[1]
    run_ddp_training(partial(worker, workdir=workdir), 2, workdir, {}, backend="cpu")
