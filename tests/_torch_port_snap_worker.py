"""A world-2 native run whose snapshot engine is held full, for
tests/test_torch_port_snapshot_gloo.py.

    python tests/_torch_port_snap_worker.py WORKDIR

Through the port's own launcher (``run_ddp_training``, world 2, CPU, Gloo)
each rank trains toy_mlp for one synthetic epoch with a snapshot due at
every step, ``inflight: 1`` and an asynchronous writer that rank 0's
``write_captured`` slows by 0.3 s a file. Each rank records every due
step's outcome (``(step, taken)``) to ``WORKDIR/skips_{rank}.json``; the
loop prints each rank's counts on stderr.

Imports only torch, numpy and ``tpuddp_torch``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from functools import partial

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpuddp_torch import config as cfg_lib  # noqa: E402
from tpuddp_torch.parallel.spawn import run_ddp_training  # noqa: E402
from tpuddp_torch.train_native import basic_ddp_training_loop  # noqa: E402
from tpuddp_torch.training import checkpoint as ckpt  # noqa: E402
from tpuddp_torch.training import snapshot as snap  # noqa: E402

TRAINING = dict(cfg_lib.TRAINING_DEFAULTS, model="toy_mlp", dataset="synthetic",
                synthetic_n=(160, 16), train_batch_size=8, test_batch_size=16, image_size=None,
                seed=0, num_epochs=1, checkpoint_epoch=1, scan_steps=1,
                snapshot={"every_steps": 1, "inflight": 1})


def worker(rank, world_size, save_dir, optional_args, workdir):
    torch.set_num_threads(2)
    if rank == 0:
        write = ckpt.write_captured

        def slow(*args, **kwargs):
            time.sleep(0.3)
            return write(*args, **kwargs)

        ckpt.write_captured = slow
    outcomes = []
    maybe = snap.SnapshotEngine.maybe

    def recorded(self, capture, **kw):
        due = kw["step"] >= self._next_due
        taken = maybe(self, capture, **kw)
        if due:
            outcomes.append((int(kw["step"]), bool(taken)))
        return taken

    snap.SnapshotEngine.maybe = recorded
    basic_ddp_training_loop(rank, world_size, save_dir, {}, training=TRAINING, device="cpu")
    with open(os.path.join(workdir, f"skips_{rank}.json"), "w") as f:
        json.dump(outcomes, f)


if __name__ == "__main__":
    workdir = sys.argv[1]
    run_ddp_training(partial(worker, workdir=workdir), 2, os.path.join(workdir, "out"), {},
                     backend="cpu")
