"""Process-group collectives — the counterparts of
``tpuddp/parallel/collectives.py:179-236`` that the port uses.

Each works on the default process group, or on the subgroup ``group`` it
is given (the hierarchical topology's local and host groups,
:mod:`tpuddp_torch.parallel.mesh`), and is the identity when no group is
up or that group is one process. Tensors of one dtype travel as one flat
buffer, so a model's parameters cost one collective per dtype, not one per
tensor. ZeRO-1 (:class:`tpuddp_torch.optim.ShardedUpdate`) adds the
reduce-scatter of a flat gradient into each rank's shard
(``lax.psum_scatter``) and the all-gather of the shards into the flat
vector (``lax.all_gather(tiled=True)``), through
``dist.reduce_scatter_tensor`` and ``dist.all_gather_into_tensor``, which
NCCL and Gloo both run.

The comm hooks (:mod:`tpuddp_torch.parallel.comm`) add the exchanges of
``tpuddp/parallel/collectives.py:100-145``: a bucket's all-reduce in its
wire dtype, the int8 codes and scales all-gathered and dequantised and
summed in rank order, the top-k payloads scatter-added in rank order (one
``index_add_`` per replica, each over distinct indices, so a CUDA sum
repeats bitwise), and the bf16 reduce-scatter of a whole vector.
"""

from __future__ import annotations

from typing import Callable, Iterable, List

import torch
import torch.distributed as dist

from tpuddp_torch.parallel.backend import get_world_size
from tpuddp_torch.resilience import faults


def group_size(group=None) -> int:
    """Processes in ``group`` (the default group when None); 1 when no
    group is up."""
    if group is None:
        return get_world_size()
    return dist.get_world_size(group) if dist.is_initialized() else 1


def group_rank(group=None) -> int:
    """This process's rank in ``group`` (the default group when None)."""
    if not dist.is_initialized():
        return 0
    return dist.get_rank(group) if group is not None else dist.get_rank()


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
    """Every process waits here for the others (``col.barrier``). Its entry
    is a ``$TPUDDP_FAULT`` site: ``hang@barrier`` is the dead peer that the
    watchdog must find (``tpuddp/parallel/collectives.py:179-198``)."""
    faults.maybe_fire("barrier")
    if dist.is_initialized():
        dist.barrier()


@torch.no_grad()
def broadcast_(tensors: Iterable[torch.Tensor], src: int = 0, group=None) -> None:
    """Overwrite ``tensors`` with process ``src``'s values (``src`` a
    global rank), one flat broadcast per dtype."""
    if group_size(group) == 1:
        return
    for same in _by_dtype(tensors):
        flat_collective(same, lambda flat: dist.broadcast(flat, src=src, group=group))


def broadcast_one_to_all(module: torch.nn.Module, src: int = 0) -> torch.nn.Module:
    """Give every process ``src``'s parameters and buffers of ``module``
    (``col.broadcast_one_to_all``, which the JAX ``Accelerator`` applies to a
    freshly initialised model, ``tpuddp/accelerate.py:620``)."""
    broadcast_(list(module.parameters()) + list(module.buffers()), src)
    return module


def all_reduce_sum_(tensors: Iterable[torch.Tensor], group=None) -> None:
    """In-place all-reduce SUM of ``tensors``, one flat collective per
    dtype."""
    if group_size(group) == 1:
        return
    for same in _by_dtype(tensors):
        flat_collective(same, lambda flat: dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group))


def process_allgather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every process's ``t`` (one shape on all of them; a scalar counts as
    one row) concatenated along axis 0 in rank order, on every process
    (``multihost_utils.process_allgather`` behind ``Accelerator.gather``)."""
    n = group_size(group)
    if n == 1:
        return t
    t = t.reshape(1) if t.dim() == 0 else t
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def reduce_scatter_sum(out: torch.Tensor, flat: torch.Tensor, group=None) -> None:
    """``out`` (``flat.numel() / world`` elements) = this rank's contiguous
    shard of the SUM of every rank's ``flat``."""
    if group_size(group) == 1:
        out.copy_(flat)
        return
    dist.reduce_scatter_tensor(out, flat, op=dist.ReduceOp.SUM, group=group)


def all_gather_shards(flat: torch.Tensor, shard: torch.Tensor, group=None) -> None:
    """``flat`` = every rank's ``shard`` concatenated in rank order."""
    if group_size(group) == 1:
        flat.copy_(shard)
        return
    dist.all_gather_into_tensor(flat, shard, group=group)


def all_reduce_wire(b: torch.Tensor, group=None) -> torch.Tensor:
    """In-place all-reduce SUM of one bucket in its own (wire) dtype;
    returns it."""
    if group_size(group) > 1:
        dist.all_reduce(b, op=dist.ReduceOp.SUM, group=group)
    return b


def _gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` (one shape), stacked in the group's rank order:
    ``(group size, *t.shape)``."""
    n = group_size(group)
    out = torch.empty((n * t.numel(),), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.reshape(-1).contiguous(), group=group)
    return out.view(n, *t.shape)


def allgather_dequant_sum(q: torch.Tensor, scale: torch.Tensor, group=None) -> torch.Tensor:
    """The SUM over replicas of ``q * scale`` (int8 codes, a float32
    scale): codes and scales all-gathered, each replica's payload
    dequantised and added in rank order on every replica, each addition
    rounded once with its product, as the fused multiply-adds of the JAX
    package's compiled reduction round it (computed in float64, where the
    product is exact, and so is the sum unless the replicas' scales are
    over 2^20 apart)."""
    if group_size(group) == 1:
        return q.float() * scale
    codes, scales = _gather(q, group), _gather(scale.reshape(1), group)
    out = codes[0].float() * scales[0]
    for r in range(1, codes.shape[0]):
        out = (out.double() + codes[r].double() * scales[r].double()).float()
    return out


def allgather_topk_sum(idx: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, n: int,
                       group=None) -> torch.Tensor:
    """The SUM over replicas of each one's sparse payload (indices ``idx``,
    sent as int32, int8 codes ``q``, a float32 scale) as a dense ``(n,)``
    float32 vector: all three all-gathered, each replica's dequantised
    values added at its indices in rank order."""
    out = torch.zeros(n, dtype=torch.float32, device=q.device)
    if group_size(group) == 1:
        return out.index_add_(0, idx, q.float() * scale)
    idxs, codes, scales = (_gather(idx.to(torch.int32), group), _gather(q, group),
                           _gather(scale.reshape(1), group))
    for r in range(codes.shape[0]):
        out.index_add_(0, idxs[r], codes[r].float() * scales[r])
    return out


def psum_scatter_compressed(vec: torch.Tensor, wire_dtype: torch.dtype, group=None):
    """``vec`` cast to ``wire_dtype`` and reduce-scattered (SUM) in it:
    ``(this rank's float32 shard of the sum, the compressed send)``."""
    comp = vec.to(wire_dtype)
    n = group_size(group)
    if n == 1:
        return comp.float(), comp
    shard = torch.empty(vec.numel() // n, dtype=wire_dtype, device=vec.device)
    dist.reduce_scatter_tensor(shard, comp, op=dist.ReduceOp.SUM, group=group)
    return shard.float(), comp
