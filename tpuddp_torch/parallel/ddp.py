"""DistributedDataParallel — the counterpart of ``tpuddp/parallel/ddp.py``
for the native path.

It does not use ``torch.nn.parallel.DistributedDataParallel``: like the JAX
package, which computes its own ``pmean``, it makes one explicit all-reduce
per step, which is what the parity tests pin:

- at wrap time, parameters and buffers are broadcast from rank 0
  (``tpuddp/parallel/ddp.py:443``), so every replica starts identical;
- after every train forward, the model's buffers (BatchNorm running
  statistics) are broadcast from rank 0, as the JAX step does with its
  ``sync_buffers="broadcast"`` default (``tpuddp/training/step.py:216-223``).
  torch DDP broadcasts before the forward instead, which leaves other
  buffers at epoch end;
- after backward, all gradients go into one flat buffer, one all-reduce SUM,
  then a division by the world size. Each replica's gradient is the gradient
  of its own weighted-mean loss, so the result is the MEAN OF PER-REPLICA
  WEIGHTED-MEAN GRADIENTS, as ``pmean`` gives it
  (``tpuddp/training/step.py:197-225``) — not a global weighted mean, which
  differs when padded tails give replicas different real-row counts.

``clip_grad_norm`` clips the averaged gradient to that global L2 norm
before each update, on every replica alike (``tpuddp/training/step.py:
406-413``); under accumulation once per cycle, after its division.

``step`` counts the micro-batches trained, as the JAX ``TrainState.step``
does (1 per step, A per cycle, padding micro-batches included); checkpoints
carry it as ``.step``.

``grad_accumulation=A > 1`` makes one update per A micro-batches
(:meth:`DistributedDataParallel.train_cycle`, ``tpuddp/parallel/ddp.py:100-106``):
each replica's gradient is the n-weighted mean over its cycle, and the
all-reduce runs once, at the cycle boundary. The per-batch
:meth:`~DistributedDataParallel.train_step` is refused then: a full-scale
update per micro-batch would be an A-fold learning rate.

The wrap runs on ``cuda`` unless ``device`` asks for the CPU; without a
visible GPU it raises. Batches may arrive already on the device (the epoch
loop stages them, ``training/pipeline.py``); a host batch is staged here
the same way, from pinned memory with ``non_blocking=True``. ``generator`` is
the rank's host random stream (the flip masks), which checkpoints save and
restore.

A one-process world skips the collectives: a sum over one replica divided by
one is the identity, and so is a broadcast.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from tpuddp_torch.parallel import backend, collectives
from tpuddp_torch.training.pipeline import stage_batch
from tpuddp_torch.training.step import eval_core, train_core, train_cycle


class DistributedDataParallel:
    def __init__(
        self,
        model: torch.nn.Module,
        optimizer: torch.optim.Optimizer,
        criterion: Callable,
        augment: Optional[Callable] = None,
        eval_transform: Optional[Callable] = None,
        device: Optional[torch.device] = None,
        grad_accumulation: int = 1,
        generator: Optional[torch.Generator] = None,
        clip_grad_norm: Optional[float] = None,
    ):
        self.generator = generator
        self.clip_grad_norm = None if clip_grad_norm is None else float(clip_grad_norm)
        self.step = 0
        self.grad_accumulation = int(grad_accumulation)
        if self.grad_accumulation < 1:
            raise ValueError(f"grad_accumulation must be >= 1, got {grad_accumulation!r}")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise backend.BackendUnavailableError(
                "DistributedDataParallel on cuda but no GPU is visible; pass "
                "device='cpu' to run on the CPU"
            )
        self.model = model.to(self.device)
        self.optimizer = optimizer
        self.criterion = criterion
        self.augment = augment
        self.eval_transform = eval_transform
        self.rank = backend.get_rank()
        self.world_size = backend.get_world_size()
        collectives.broadcast_one_to_all(self.model)

    def _mean(self, flat: torch.Tensor) -> None:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        flat.div_(self.world_size)

    def sync_grads(self) -> None:
        """All-reduce mean of every gradient, through one flat buffer."""
        if self.world_size == 1:
            return
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        collectives.flat_collective(grads, self._mean)

    def sync_buffers(self) -> None:
        """Broadcast the model's buffers from rank 0, one flat collective per
        buffer dtype; nothing for a world of one or a model without buffers."""
        collectives.broadcast_(self.model.buffers())

    def to_device(self, batch):
        """``(x, y, w)`` on the device: staged tensors as they are, a host
        batch copied from pinned memory without blocking."""
        return stage_batch(batch, self.device)

    def train_step(self, batch) -> torch.Tensor:
        """One step on a host batch; returns on-device ``[loss_sum, n]``."""
        if self.grad_accumulation > 1:
            raise RuntimeError(
                "per-batch train_step is undefined under grad_accumulation "
                f"(= {self.grad_accumulation}): it would apply one full-scale update "
                "per micro-batch; use train_cycle with a whole cycle of batches"
            )
        x, y, w = self.to_device(batch)
        self.step += 1
        return train_core(
            self.model, self.optimizer, self.criterion, self.augment,
            self.sync_grads, self.sync_buffers, x, y, w, self.clip_grad_norm,
        )

    def train_cycle(self, batches) -> torch.Tensor:
        """One accumulation cycle over ``grad_accumulation`` host batches;
        returns the cycle's on-device ``[loss_sum, n]``."""
        if len(batches) != self.grad_accumulation:
            raise ValueError(
                f"a cycle takes {self.grad_accumulation} micro-batches, got {len(batches)}"
            )
        self.step += len(batches)
        return train_cycle(
            self.model, self.optimizer, self.criterion, self.augment, self.sync_grads,
            self.sync_buffers, [self.to_device(b) for b in batches], self.clip_grad_norm,
        )

    def eval_step(self, batch) -> torch.Tensor:
        """Returns on-device ``[loss_sum, correct, n]``."""
        x, y, w = self.to_device(batch)
        return eval_core(self.model, self.criterion, self.eval_transform, x, y, w)
