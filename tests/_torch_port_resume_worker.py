"""Continuity runs of the port for tests/test_torch_port_resume.py.

    python tests/_torch_port_resume_worker.py WORKDIR WORLD

For the native and the managed entry points' workers, through the port's
launcher (``run_ddp_training``, CPU, Gloo, ``WORLD`` processes), toy_cnn with
sync_bn, flips and ``gradient_accumulation_steps: 2``, a checkpoint every
epoch:

- ``WORKDIR/<path>/straight``: 2 epochs in one run;
- ``WORKDIR/<path>/resumed``: epoch 0 alone, then a second run with
  ``resume: true`` and ``num_epochs: 2``, which restores ``*_0.npz`` and
  trains epoch 1.

Imports only torch, numpy and ``tpuddp_torch``.
"""

from __future__ import annotations

import os
import sys
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpuddp_torch import config as cfg_lib  # noqa: E402
from tpuddp_torch.parallel.spawn import run_ddp_training  # noqa: E402
from tpuddp_torch.train_accelerate import basic_accelerate_training  # noqa: E402
from tpuddp_torch.train_native import basic_ddp_training_loop  # noqa: E402

TRAINING = dict(
    cfg_lib.TRAINING_DEFAULTS, model="toy_cnn", dataset="synthetic", synthetic_n=(100, 40),
    train_batch_size=16, test_batch_size=16, num_epochs=2, checkpoint_epoch=1,
    image_size=None, seed=3, sync_bn=True, flip=True, learning_rate=1e-2,
    gradient_accumulation_steps=2,
)
PATHS = {"native": basic_ddp_training_loop, "managed": basic_accelerate_training}
RUNS = {"straight": [{}], "resumed": [{"num_epochs": 1}, {"resume": True}]}


def continuity(workdir: str, path: str, world: int) -> None:
    for name, runs in RUNS.items():
        out = os.path.join(workdir, path, name)
        os.makedirs(out, exist_ok=True)
        for overrides in runs:
            training = dict(TRAINING, **overrides)
            run_ddp_training(
                partial(PATHS[path], training=training, device="cpu"),
                world, out, {}, backend="cpu",
            )


if __name__ == "__main__":
    workdir, world = sys.argv[1], int(sys.argv[2])
    for path in PATHS:
        continuity(workdir, path, world)
