"""Process-group collectives — the counterparts of
``tpuddp/parallel/collectives.py:179-236`` that the port uses.

Each works on the default process group and is the identity when no group
is up or the world is one process. Tensors of one dtype travel as one flat
buffer, so a model's parameters cost one collective per dtype, not one per
tensor. ZeRO-1 (:class:`tpuddp_torch.optim.ShardedUpdate`) adds the
reduce-scatter of a flat gradient into each rank's shard
(``lax.psum_scatter``) and the all-gather of the shards into the flat
vector (``lax.all_gather(tiled=True)``), through
``dist.reduce_scatter_tensor`` and ``dist.all_gather_into_tensor``, which
NCCL and Gloo both run.
"""

from __future__ import annotations

from typing import Callable, Iterable, List

import torch
import torch.distributed as dist

from tpuddp_torch.parallel.backend import get_world_size


def flat_collective(tensors: List[torch.Tensor], collective: Callable) -> None:
    """Run ``collective`` in place on one flat buffer holding ``tensors``
    (one dtype) and copy the result back into them."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    collective(flat)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset : offset + t.numel()].view_as(t))
        offset += t.numel()


def _by_dtype(tensors: Iterable[torch.Tensor]):
    groups = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups.values()


def barrier() -> None:
    """Every process waits here for the others (``col.barrier``)."""
    if dist.is_initialized():
        dist.barrier()


@torch.no_grad()
def broadcast_(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` with process ``src``'s values, one flat
    broadcast per dtype."""
    if get_world_size() == 1:
        return
    for group in _by_dtype(tensors):
        flat_collective(group, lambda flat: dist.broadcast(flat, src=src))


def broadcast_one_to_all(module: torch.nn.Module, src: int = 0) -> torch.nn.Module:
    """Give every process ``src``'s parameters and buffers of ``module``
    (``col.broadcast_one_to_all``, which the JAX ``Accelerator`` applies to a
    freshly initialised model, ``tpuddp/accelerate.py:620``)."""
    broadcast_(list(module.parameters()) + list(module.buffers()), src)
    return module


def all_reduce_sum_(tensors: Iterable[torch.Tensor]) -> None:
    """In-place all-reduce SUM of ``tensors``, one flat collective per
    dtype."""
    if get_world_size() == 1:
        return
    for group in _by_dtype(tensors):
        flat_collective(group, lambda flat: dist.all_reduce(flat, op=dist.ReduceOp.SUM))


def process_allgather(t: torch.Tensor) -> torch.Tensor:
    """Every process's ``t`` (one shape on all of them; a scalar counts as
    one row) concatenated along axis 0 in rank order, on every process
    (``multihost_utils.process_allgather`` behind ``Accelerator.gather``)."""
    n = get_world_size()
    if n == 1:
        return t
    t = t.reshape(1) if t.dim() == 0 else t
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts)


def reduce_scatter_sum(out: torch.Tensor, flat: torch.Tensor) -> None:
    """``out`` (``flat.numel() / world`` elements) = this rank's contiguous
    shard of the SUM of every rank's ``flat``."""
    if get_world_size() == 1:
        out.copy_(flat)
        return
    dist.reduce_scatter_tensor(out, flat, op=dist.ReduceOp.SUM)


def all_gather_shards(flat: torch.Tensor, shard: torch.Tensor) -> None:
    """``flat`` = every rank's ``shard`` concatenated in rank order."""
    if get_world_size() == 1:
        flat.copy_(shard)
        return
    dist.all_gather_into_tensor(flat, shard)
