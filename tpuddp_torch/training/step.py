"""Train and eval cores — the counterpart of ``tpuddp/training/step.py``
(``_make_grad_core``/``_make_update_fn`` at 197-225 and 452-481, the eval
core at 737-753, ``finalize_metrics`` at 1224).

A train step is forward -> buffer sync (the DDP wrap's broadcast of the
model's buffers from rank 0) -> weighted loss -> backward -> gradient sync
(the DDP wrap's all-reduce mean) -> Adam. The train forward hands the batch
weights to the model's BatchNorms, so padded rows stay out of their
statistics (``tpuddp/training/step.py:203-207``); eval normalises with the
running statistics. Metrics stay on the device as sums:
``loss_sum = loss * n`` and ``n`` (the batch's real rows) for training,
plus ``correct`` for eval; nothing is read back per batch.
:func:`finalize_metrics` makes one all-reduce of the stacked epoch sums.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from tpuddp_torch.nn.norm import batch_weights

TRAIN_KEYS = ("loss_sum", "n")
EVAL_KEYS = ("loss_sum", "correct", "n")


def train_core(
    model, optimizer, criterion, augment: Optional[Callable], sync_grads: Callable,
    sync_buffers: Callable, x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
) -> torch.Tensor:
    """One train step; returns the on-device sums ``[loss_sum, n]``."""
    model.train()
    if augment is not None:
        x = augment(x)
    with batch_weights(model, w):
        logits = model(x)
    sync_buffers()
    loss = criterion(logits, y, w)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    sync_grads()
    optimizer.step()
    n = w.sum()
    return torch.stack([loss.detach() * n, n])


@torch.no_grad()
def eval_core(
    model, criterion, transform: Optional[Callable],
    x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
) -> torch.Tensor:
    """One eval step; returns the on-device sums ``[loss_sum, correct, n]``."""
    model.eval()
    if transform is not None:
        x = transform(x)
    logits = model(x)
    loss = criterion(logits, y, w)
    n = w.sum()
    correct = ((logits.argmax(dim=-1) == y) * w).sum()
    return torch.stack([loss * n, correct, n])


def finalize_metrics(train_sums: torch.Tensor, eval_sums: torch.Tensor) -> Dict[str, Dict[str, float]]:
    """Epoch-end aggregation: ONE all-reduce (SUM) of the stacked epoch sums
    over the process group, then one host read."""
    stacked = torch.cat([train_sums, eval_sums])
    if dist.is_initialized():
        dist.all_reduce(stacked, op=dist.ReduceOp.SUM)
    values = stacked.tolist()
    return {
        "train": dict(zip(TRAIN_KEYS, values[: len(TRAIN_KEYS)])),
        "eval": dict(zip(EVAL_KEYS, values[len(TRAIN_KEYS) :])),
    }
