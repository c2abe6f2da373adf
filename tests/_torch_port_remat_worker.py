"""Two-process Gloo runs of remat against plain for
tests/test_torch_port_remat.py.

    python tests/_torch_port_remat_worker.py WORKDIR

Through the port's own launcher (``run_ddp_training``, world 2, CPU, Gloo)
each rank trains a ToyCNN (BatchNorm, ``sync_bn``) from one seeded init on
its own batches (the last one padded: half its rows weigh 0), once per
variant of :data:`VARIANTS` without and with ``remat``, and saves each run's
parameters, last gradients, BatchNorm buffers and step sums to
``WORKDIR/{variant}_{plain|remat}_{rank}.npz``.

Imports only torch, numpy and ``tpuddp_torch``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpuddp_torch.models import ToyCNN  # noqa: E402
from tpuddp_torch.nn import CrossEntropyLoss  # noqa: E402
from tpuddp_torch.nn.norm import convert_sync_batchnorm  # noqa: E402
from tpuddp_torch.optim import Adam  # noqa: E402
from tpuddp_torch.parallel.ddp import DistributedDataParallel  # noqa: E402
from tpuddp_torch.parallel.spawn import run_ddp_training  # noqa: E402

SHAPE, WIDTHS, BATCH, STEPS = (8, 8, 3), (4, 8), 6, 4
# variant -> the wrap's keywords and how its steps are taken ("step": one
# train_step per batch; "cycle": A = 2 accumulation cycles; "chunk": one
# train_step_many over every batch)
VARIANTS = {
    "replicated": ({}, "step"),
    "zero1": ({"weight_update_sharding": True}, "step"),
    "int8_ef": ({"comm_hook": "int8_ef"}, "step"),
    "accum": ({"grad_accumulation": 2}, "cycle"),
    "chunk": ({}, "chunk"),
}


def batches(rank):
    rng = np.random.RandomState(11 + rank)
    out = []
    for i in range(STEPS):
        w = np.ones(BATCH, np.float32)
        if i == STEPS - 1:
            w[BATCH // 2:] = 0  # the padded final batch
        out.append((rng.randn(BATCH, *SHAPE).astype(np.float32),
                    rng.randint(0, 10, BATCH).astype(np.int64), w))
    return out


def run(rank, workdir, variant, remat):
    torch.manual_seed(0)  # one init on every rank
    model = convert_sync_batchnorm(ToyCNN(10, WIDTHS, input_shape=SHAPE))
    kwargs, how = VARIANTS[variant]
    ddp = DistributedDataParallel(model, Adam(model.parameters(), lr=1e-2), CrossEntropyLoss(),
                                  device="cpu", remat=remat, **kwargs)
    data = batches(rank)
    if how == "step":
        sums = torch.stack([ddp.train_step(b) for b in data])
    elif how == "cycle":
        sums = torch.stack([ddp.train_cycle(data[i:i + 2]) for i in range(0, STEPS, 2)])
    else:
        sums = ddp.train_step_many(data)[None]
    np.savez(
        os.path.join(workdir, f"{variant}_{'remat' if remat else 'plain'}_{rank}.npz"),
        sums=sums.numpy(),
        **{f"param/{k}": p.detach().numpy() for k, p in model.named_parameters()},
        **{f"grad/{k}": p.grad.numpy() for k, p in model.named_parameters()},
        **{f"buffer/{k}": b.numpy() for k, b in model.named_buffers()},
    )


def worker(rank, world_size, save_dir, optional_args, workdir):
    torch.set_num_threads(2)
    for variant in VARIANTS:
        for remat in (False, True):
            run(rank, workdir, variant, remat)


if __name__ == "__main__":
    from functools import partial

    run_ddp_training(partial(worker, workdir=sys.argv[1]), 2, None, {}, backend="cpu")
