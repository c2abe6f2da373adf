"""Train and eval cores — the counterpart of ``tpuddp/training/step.py``
(``_make_grad_core``/``_make_update_fn`` at 173-420, the accumulation cycle
at 945-1000, the eval core at 737-753, ``finalize_metrics`` at 1224).

A train step is its grad half (:func:`grad_core`: forward -> buffer sync
(the DDP wrap's broadcast of the model's buffers from rank 0) -> weighted
loss -> backward) and its update half (:func:`update_core`: gradient sync
(the DDP wrap's all-reduce mean) -> the optional ``clip_grad_norm`` on the
averaged gradient, the same on every replica (``tpuddp/training/step.py:
406-413``) -> the optimizer). The train forward hands the batch weights to
the model's BatchNorms, so padded rows stay out of their
statistics (``tpuddp/training/step.py:203-207``); eval normalises with the
running statistics. Metrics stay on the device as sums:
``loss_sum = loss * n`` and ``n`` (the batch's real rows) for training,
plus ``correct`` for eval; nothing is read back per batch.
:func:`finalize_metrics` makes one all-reduce of the stacked epoch sums.

:func:`train_cycle` is the native path's gradient accumulation: A
micro-batches through the grad half, their local gradients summed as
``n_i * g_i``, divided by ``sum n_i`` at the cycle boundary, then ONE update
half (one gradient all-reduce, one clip, one optimizer step). All-padding
micro-batches (``n = 0``) add nothing.

:func:`train_many` and :func:`eval_many` are the ``scan_steps`` cores: K
steps (or K / A cycles) and K eval batches as one group, their sums added
to a running sum in step order. They read nothing on the host, so a group
runs as one CUDA graph too (``training/graphs.py``); each step's flip mask
is an input, drawn before the group.

Under ``weight_update_sharding`` (ZeRO-1) the optimizer is a
:class:`tpuddp_torch.optim.ShardedUpdate` over the flat layout of
:func:`make_flat_param_spec` (``tpuddp/training/step.py:50-97``), and its
``step()`` is the whole update half of ``tpuddp/training/step.py:291-366``:
flatten the gradients, reduce-scatter, divide by the world size, clip,
update the shard, all-gather. The DDP wrap then passes no gradient sync and
no clip to these cores; everything else is unchanged.

With a comm hook (:mod:`tpuddp_torch.parallel.comm`) the DDP wrap's
gradient sync is :func:`comm_sync`, the exchange of
``tpuddp/training/step.py:390-396`` in its order of operations: flatten the
gradients in the JAX package's flat order, add the error-feedback residual,
compress, sum and decompress per bucket, divide by the world size, keep
``send - kept`` as the new residual, unflatten; the clip (on the
decompressed mean) and the optimizer follow as before. Under accumulation
it runs once per cycle, at its boundary; under ZeRO-1 the wrapped
optimizer's reduce-scatter is the hooked one.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpuddp_torch.nn.norm import batch_weights
from tpuddp_torch.optim import clip_grad_norm_

TRAIN_KEYS = ("loss_sum", "n")
EVAL_KEYS = ("loss_sum", "correct", "n")


class FlatParamSpec(NamedTuple):
    """The flat layout of weight-update sharding (the JAX package's
    ``FlatParamSpec``): the model's parameters in ``model.parameters()``
    order, each raveled as PyTorch stores it, as ONE float32 vector
    zero-padded from ``raw`` to ``total = world * ceil(raw / world)``
    elements, as the JAX spec pads, so each of ``world`` replicas owns an
    equal contiguous shard. The JAX package orders the same vector by its
    tree's leaves, each in its own layout;
    :func:`tpuddp_torch.models.convert.flat_to_jax` and ``flat_from_jax``
    permute between the two (exactly), which checkpoints pay. The port's
    order lets the parameters be views into the vector, so a step needs no
    permute."""

    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]
    raw: int
    total: int
    world: int

    @property
    def shard_n(self) -> int:
        return self.total // self.world

    @property
    def ends(self) -> Tuple[int, ...]:
        """Where each parameter's elements end in the vector."""
        return tuple(int(e) for e in np.cumsum(self.sizes))

    def check(self, params: Sequence[torch.Tensor]) -> None:
        shapes = tuple(tuple(p.shape) for p in params)
        if shapes != self.shapes:
            raise ValueError(f"parameters of shapes {shapes} for a flat spec of {self.shapes}")

    def flatten(self, tensors: Sequence[torch.Tensor], out: torch.Tensor) -> torch.Tensor:
        """``tensors`` (one per parameter) raveled into ``out``'s first
        ``raw`` elements, in one copy (``_tree_to_vec``); the padding is
        left as it is."""
        torch.cat([t.reshape(-1) for t in tensors], out=out[:self.raw])
        return out

    def views(self, vec: torch.Tensor):
        """Each parameter's shaped view into ``vec`` (``_vec_to_tree``)."""
        out, offset = [], 0
        for shape, size in zip(self.shapes, self.sizes):
            out.append(vec[offset:offset + size].view(shape))
            offset += size
        return out


def make_flat_param_spec(model: torch.nn.Module, world: int) -> FlatParamSpec:
    """The flat layout of ``model``'s parameters over ``world`` replicas;
    a parameter that is not float32 is the JAX package's ``ValueError``."""
    shapes, sizes = [], []
    for i, p in enumerate(model.parameters()):
        if p.dtype != torch.float32:
            raise ValueError(
                "weight_update_sharding flattens parameters into one f32 vector; leaf "
                f"{i} has dtype {p.dtype} (tpuddp keeps f32 master params — mixed compute "
                "dtypes live in activations, not parameters)"
            )
        shapes.append(tuple(p.shape))
        sizes.append(p.numel())
    raw = sum(sizes)
    total = world * math.ceil(raw / world)
    return FlatParamSpec(tuple(shapes), tuple(sizes), raw, total, int(world))


def grad_core(
    model, optimizer, criterion, augment: Optional[Callable], sync_buffers: Callable,
    x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, flip_mask: Optional[torch.Tensor] = None,
):
    """Forward and backward of one batch; the replica's local weighted-mean
    gradient replaces each parameter's ``.grad``. Returns the on-device
    ``(loss, n)``. Without ``flip_mask`` the augment draws its own."""
    model.train()
    if augment is not None:
        x = augment(x) if flip_mask is None else augment(x, flip_mask=flip_mask)
    with batch_weights(model, w):
        logits = model(x)
    sync_buffers()
    loss = criterion(logits, y, w)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    return loss.detach(), w.sum()


@torch.no_grad()
def comm_sync(params: Sequence[torch.Tensor], comm, order, residual: Optional[torch.Tensor]) -> None:
    """The hooked gradient exchange: each parameter's ``.grad`` (None counts
    as zeros) flattened into one vector in the JAX order (``order``, a
    :class:`~tpuddp_torch.models.convert.JaxFlatOrder`) and zero-padded to
    ``comm.total``, through ``comm.reduce`` (``residual`` updated in place),
    then each ``.grad`` set to its view of the mean, in the port's order."""
    port = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    g_vec = order.to_jax(port)
    if comm.total > order.raw:
        g_vec = torch.cat([g_vec, g_vec.new_zeros(comm.total - order.raw)])
    reduced, _ = comm.reduce(g_vec, residual)
    flat, offset = order.from_jax(reduced), 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()


def update_core(optimizer, sync_grads: Callable, clip: Optional[float] = None) -> None:
    """The gradient all-reduce, the clip to global norm ``clip`` (if any),
    then one optimizer update."""
    sync_grads()
    if clip is not None:
        clip_grad_norm_([p for g in optimizer.param_groups for p in g["params"]], clip)
    optimizer.step()


def train_core(
    model, optimizer, criterion, augment: Optional[Callable], sync_grads: Callable,
    sync_buffers: Callable, x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
    clip: Optional[float] = None, flip_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One train step; returns the on-device sums ``[loss_sum, n]``."""
    loss, n = grad_core(model, optimizer, criterion, augment, sync_buffers, x, y, w, flip_mask)
    update_core(optimizer, sync_grads, clip)
    return torch.stack([loss * n, n])


def train_cycle(
    model, optimizer, criterion, augment: Optional[Callable], sync_grads: Callable,
    sync_buffers: Callable, batches: Sequence, clip: Optional[float] = None,
    flip_masks: Optional[Sequence] = None,
) -> torch.Tensor:
    """One accumulation cycle over the device batches ``(x, y, w)`` of
    ``batches``: ``sum n_i g_i / sum n_i`` (the mean gradient of their
    concatenation on this replica; the all-padding case divides by 1), then
    one update. Returns the cycle's on-device sums ``[loss_sum, n]``."""
    params = list(model.parameters())
    acc = [None] * len(params)
    sums = None
    for (x, y, w), mask in zip(batches, flip_masks or [None] * len(batches)):
        loss, n = grad_core(model, optimizer, criterion, augment, sync_buffers, x, y, w, mask)
        for i, p in enumerate(params):
            if p.grad is not None:
                acc[i] = n * p.grad if acc[i] is None else acc[i] + n * p.grad
        step = torch.stack([loss * n, n])
        sums = step if sums is None else sums + step
    denom = torch.where(sums[1] == 0, torch.ones_like(sums[1]), sums[1])
    for p, a in zip(params, acc):
        p.grad = None if a is None else a / denom
    update_core(optimizer, sync_grads, clip)
    return sums


def train_many(
    model, optimizer, criterion, augment: Optional[Callable], sync_grads: Callable,
    sync_buffers: Callable, sums: torch.Tensor, batches: Sequence, flip_masks: Sequence,
    clip: Optional[float] = None, accum: int = 1,
) -> torch.Tensor:
    """K train steps on the device batches (K / ``accum`` accumulation
    cycles), each step's flip mask given: the counterpart of
    ``build_train_scan_step`` (``tpuddp/training/step.py:840-1100``).
    Returns ``sums`` plus each step's (each cycle's) sums, added in order,
    as the per-batch loop adds them."""
    for i in range(0, len(batches), accum):
        if accum == 1:
            x, y, w = batches[i]
            step = train_core(model, optimizer, criterion, augment, sync_grads, sync_buffers,
                              x, y, w, clip, flip_masks[i])
        else:
            step = train_cycle(model, optimizer, criterion, augment, sync_grads, sync_buffers,
                               batches[i:i + accum], clip, flip_masks[i:i + accum])
        sums = sums + step
    return sums


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


def eval_many(model, criterion, transform: Optional[Callable], sums: torch.Tensor,
              batches: Sequence) -> torch.Tensor:
    """K eval steps: ``sums`` plus each batch's sums, added in order (the
    counterpart of ``build_eval_scan_step``,
    ``tpuddp/training/step.py:1155-1185``)."""
    for x, y, w in batches:
        sums = sums + eval_core(model, criterion, transform, x, y, w)
    return sums


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
