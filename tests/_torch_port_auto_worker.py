"""``mode: auto`` runs of the port for tests/test_torch_port_auto.py
(in-process, world 1) and its two-Gloo-process cases.

    python tests/_torch_port_auto_worker.py WORKDIR

``WORKDIR/init.npz`` holds the toy_cnn ``state_dict`` (buffers included)
and ``WORKDIR/batches.npz`` the global batches (``x``, ``y``, ``w``, each
``(STEPS, GLOBAL, ...)``). Through the port's own launcher
(``run_ddp_training``, world 2, CPU, Gloo) each rank runs every case of
:data:`CASES` on its rows of each global batch (:func:`steps`) and the
native loop at ``scan_steps: 2`` (:func:`loop`), writing
``WORKDIR/{case}_{rank}.npz`` (and ``bf16_ef``'s state to ``WORKDIR/ckpt``) and, on rank 0, ``WORKDIR/loop_history.json``.

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
from tpuddp_torch.data import transforms as tf  # noqa: E402
from tpuddp_torch.data.synthetic import SyntheticClassification  # noqa: E402
from tpuddp_torch.models import ToyCNN  # noqa: E402
from tpuddp_torch.nn import CrossEntropyLoss  # noqa: E402
from tpuddp_torch.optim import Adam  # noqa: E402
from tpuddp_torch.parallel.ddp import DistributedDataParallel  # noqa: E402
from tpuddp_torch.parallel.spawn import run_ddp_training  # noqa: E402
from tpuddp_torch.training import checkpoint as ckpt  # noqa: E402
from tpuddp_torch.training.loop import run_training_loop  # noqa: E402

# shared with the tests: model, batches and the loop's dataset
WIDTHS, SHAPE, LR, GLOBAL, STEPS = (4, 8), (8, 8, 3), 1e-2, 8, 3
DATA_N, DATA_TEST, DATA_SEED, BATCH, EPOCHS, SCAN = 72, 24, 7, 6, 2, 2
# one flip mask of the global batch, the same at every step
FLIP = np.array([1, 0, 0, 1, 1, 1, 0, 0], bool)
# name -> (comm_hook, guard)
CASES = {"none": ("none", False), "bf16_ef": ("bf16_ef", False), "guarded": ("bf16_ef", True)}


def _augment():
    """The train augment with the global flip mask :data:`FLIP` at every
    step: ``mode: auto`` draws the global batch's mask and keeps this
    replica's rows, so the draw is of ``GLOBAL`` rows."""
    aug = tf.make_train_augment(size=None, flip=True)
    aug.flip_mask = lambda x, device=None: torch.from_numpy(FLIP[:x.shape[0]].copy())
    return aug


def weights(w, i, guard):
    """Global batch ``i``'s row weights; a guarded case's second batch has
    a NaN in row 5 (replica 1's at world 2), which every replica's
    aggregated gradient then carries: the step is skipped everywhere."""
    w = np.array(w[i], np.float32)
    if guard and i == 1:
        w[5] = np.nan
    return w


def make_ddp(init, hook, guard, **kw):
    model = ToyCNN(10, WIDTHS, input_shape=SHAPE)
    model.load_state_dict(init)
    return DistributedDataParallel(
        model, Adam(model.parameters(), lr=LR), CrossEntropyLoss(), augment=_augment(),
        eval_transform=tf.make_eval_transform(size=None), device="cpu", comm_hook=hook,
        guard=guard, mode="auto", **kw)


def steps(rank, world, init, batches, hook, guard, save_dir=None):
    """:data:`STEPS` train steps on this replica's rows of each global
    batch, then one eval of the first; the arrays the test compares. With
    ``save_dir`` the state after the steps is saved there as epoch 0."""
    ddp = make_ddp(init, hook, guard)
    rows = slice(rank * GLOBAL // world, (rank + 1) * GLOBAL // world)
    sums = [ddp.train_step((batches["x"][i][rows], batches["y"][i][rows],
                            torch.from_numpy(weights(batches["w"].numpy(), i, guard))[rows]))
            for i in range(STEPS)]
    if save_dir is not None:
        ckpt.save_on_main(save_dir, 0, ddp.model, ddp.optimizer, rank, world_size=world,
                          step=ddp.step, comm_state=ddp.residual, residual_replicated=True)
    ev = ddp.eval_step((batches["x"][0][rows], batches["y"][0][rows], batches["w"][0][rows]))
    out = {f"sd/{k}": v.numpy() for k, v in ddp.model.state_dict().items()}
    out.update(sums=torch.stack(sums).numpy(), eval=ev.numpy(),
               skipped=np.array(ddp.skip_counters()),
               bytes=np.array([ddp.grad_comm_bytes_per_step, ddp.grad_comm_bytes_per_step_f32]))
    if ddp.residual is not None:
        out["residual"] = ddp.residual.numpy()
    return out


def loop(rank, world, init):
    """The native loop at ``scan_steps: 2`` with ``bf16_ef``, no flips:
    ``(history, final state_dict)``."""
    model = ToyCNN(10, WIDTHS, input_shape=SHAPE)
    model.load_state_dict(init)
    ddp = DistributedDataParallel(model, Adam(model.parameters(), lr=LR), CrossEntropyLoss(),
                                  device="cpu", comm_hook="bf16_ef", mode="auto")
    train_ds, test_ds = SyntheticClassification(n=DATA_N, shape=SHAPE,
                                                seed=DATA_SEED).split(DATA_TEST)
    history = run_training_loop(
        ddp, ShardedDataLoader(train_ds, BATCH, rank, world, shuffle=True),
        ShardedDataLoader(test_ds, BATCH, rank, world, shuffle=True),
        save_dir=None, num_epochs=EPOCHS, scan_steps=SCAN, log=lambda *_: None)
    return history, {k: v.numpy() for k, v in ddp.model.state_dict().items()}


def worker(rank, world_size, save_dir, optional_args, workdir):
    torch.set_num_threads(2)
    init = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(workdir, "init.npz")).items()}
    batches = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(workdir, "batches.npz")).items()}
    for name, (hook, guard) in CASES.items():
        np.savez(os.path.join(workdir, f"{name}_{rank}.npz"),
                 **steps(rank, world_size, init, batches, hook, guard,
                         os.path.join(workdir, "ckpt") if name == "bf16_ef" else None))
    history, final = loop(rank, world_size, init)
    np.savez(os.path.join(workdir, f"loop_{rank}.npz"), **final)
    if rank == 0:
        with open(os.path.join(workdir, "loop_history.json"), "w") as f:
            json.dump(history, f)


if __name__ == "__main__":
    workdir = sys.argv[1]
    run_ddp_training(partial(worker, workdir=workdir), 2, workdir, {}, backend="cpu")
