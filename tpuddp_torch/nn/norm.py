"""BatchNorm with optional cross-replica statistics — the counterpart of
``tpuddp/nn/norm.py:37-234``.

Features on axis 1 (NCHW, or ``(N, C)``). torch parity: momentum 0.1 (the
new statistic's weight), eps 1e-5, the biased variance to normalise and the
unbiased one for the running buffer. What ``torch.nn.BatchNorm2d`` and
``SyncBatchNorm`` do not do, and the JAX package does:

- statistics accumulate in float32 and the output is cast back to the
  input's dtype (a bf16 activation is normalised in float32);
- padded rows (sample weight 0) are left out of the batch statistics: the
  train step hands the batch weights to every BatchNorm of the model through
  :func:`batch_weights` for the forward;
- with ``sync`` the per-replica sums ``(sum_x, sum_x2, count)`` are averaged
  over the process group (``lax.pmean``: all-reduce, then divide by the
  world size) before the mean and variance are formed, and the running
  variance's ``n`` counts every replica's rows;
- a batch with no real rows (on this replica, or on every replica when
  synced) leaves the running buffers as they are;
- ``stable_var`` forms the variance in two passes, ``E[(x - mean)^2]``,
  instead of ``E[x^2] - mean^2``, at the price of a second all-reduce.

On the managed path (:mod:`tpuddp_torch.accelerate`) BatchNorm statistics
are the global batch's whatever ``sync_bn`` says, as the JAX ``Accelerator``
computes them over the whole sharded batch (``tpuddp/accelerate.py:26-28``):
its ``prepare`` applies :func:`convert_sync_batchnorm`. The averaged sums
give the global statistics whenever the global batch holds at least as many
real elements per feature as there are processes (the clamp of the
averaged count to 1 acts below that).

This is plain PyTorch; no TPU kernel stands behind it.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


class _AllReduceMean(torch.autograd.Function):
    """``lax.pmean`` over the default process group: all-reduce SUM, then
    divide by the world size. Its gradient is the same all-reduce mean of
    the cotangent, which is what the JAX package's gradient through
    ``lax.pmean`` gives under its ``shard_map`` (check_vma=False) — the 2-process
    parity test holds it to that."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM)
        return y.div_(_world())

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM)
        return g.div_(_world())


def pmean(*tensors: torch.Tensor):
    """All-reduce mean of ``tensors`` (1-D or 0-D float32) in one
    collective; the identity in a world of one."""
    if _world() == 1:
        return tensors
    sizes = [t.numel() for t in tensors]
    flat = _AllReduceMean.apply(torch.cat([t.reshape(-1) for t in tensors]))
    return tuple(p.view_as(t) for p, t in zip(flat.split(sizes), tensors))


class BatchNorm(nn.Module):
    """Batch normalisation over every axis but axis 1. Parameters ``weight``
    (the JAX ``scale``) and ``bias``; buffers ``running_mean`` and
    ``running_var`` (the JAX model state ``mean`` and ``var``)."""

    def __init__(
        self,
        num_features: int,
        momentum: float = 0.1,
        eps: float = 1e-5,
        affine: bool = True,
        track_running_stats: bool = True,
        sync: bool = False,
        stable_var: bool = False,
    ):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.eps = eps
        self.affine = affine
        self.track_running_stats = track_running_stats
        self.sync = sync
        self.stable_var = stable_var
        # the batch's sample weights during a train forward (batch_weights)
        self.sample_weight: Optional[torch.Tensor] = None
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        if track_running_stats:
            self.register_buffer("running_mean", torch.zeros(num_features))
            self.register_buffer("running_var", torch.ones(num_features))

    def _batch_stats(self, xs: torch.Tensor):
        """(mean, biased var, count, denom) of this batch: count is the
        (weighted) element count, all of them averaged over the group when
        synced, and denom is count clamped to at least 1."""
        dims = [d for d in range(xs.dim()) if d != 1]
        shape = [1] * xs.dim()
        shape[1] = -1
        sync = pmean if self.sync else (lambda *t: t)
        w = self.sample_weight
        if w is not None:
            wb = w.float().view([-1] + [1] * (xs.dim() - 1))
            spatial = xs.numel() // (xs.shape[0] * xs.shape[1])
            count = wb.sum() * spatial
            sum_x = (xs * wb).sum(dims)
        else:
            wb = None
            count = torch.tensor(float(xs.numel() // xs.shape[1]), device=xs.device)
            sum_x = xs.sum(dims)
        if self.stable_var:
            sum_x, count = sync(sum_x, count)
            denom = count.clamp_min(1.0)
            mean = sum_x / denom
            dev = (xs - mean.view(shape)).square()
            (sum_dev,) = sync((dev * wb if wb is not None else dev).sum(dims))
            var = sum_dev / denom
        else:
            xsq = xs.square()
            sum_x2 = (xsq * wb if wb is not None else xsq).sum(dims)
            sum_x, sum_x2, count = sync(sum_x, sum_x2, count)
            denom = count.clamp_min(1.0)
            mean = sum_x / denom
            var = sum_x2 / denom - mean.square()
        return mean, var, count, denom

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = x.float()  # statistics in float32 even for bf16 activations
        if self.training or not self.track_running_stats:
            mean, var, count, denom = self._batch_stats(xs)
            if self.track_running_stats and self.training:
                with torch.no_grad():
                    m = self.momentum
                    # the element count behind the statistics (all replicas when synced)
                    n = denom * (_world() if self.sync else 1)
                    unbiased = var * (n / (n - 1.0).clamp_min(1.0))
                    # no real rows (on this replica, or anywhere when synced)
                    # leaves the buffers untouched
                    has_data = count > 0
                    self.running_mean.copy_(torch.where(
                        has_data, (1 - m) * self.running_mean + m * mean, self.running_mean))
                    self.running_var.copy_(torch.where(
                        has_data, (1 - m) * self.running_var + m * unbiased, self.running_var))
        else:
            mean, var = self.running_mean, self.running_var
        shape = [1] * x.dim()
        shape[1] = -1
        y = (xs - mean.view(shape)) * torch.rsqrt(var + self.eps).view(shape)
        if self.affine:
            y = y * self.weight.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


@contextmanager
def batch_weights(model: nn.Module, w: Optional[torch.Tensor]):
    """Hand the batch's sample weights ``w`` to every BatchNorm of ``model``
    for the forward inside the block (the JAX package's
    ``Context(sample_weight=w)``), so padded rows stay out of the
    statistics."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.sample_weight = w
    try:
        yield
    finally:
        for m in norms:
            m.sample_weight = None


def convert_sync_batchnorm(module: nn.Module) -> nn.Module:
    """Set ``sync`` on every BatchNorm of ``module`` (the counterpart of
    ``torch.nn.SyncBatchNorm.convert_sync_batchnorm``); returns it."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.sync = True
    return module


def has_divergent_buffers(module: nn.Module) -> bool:
    """True when ``module`` holds a buffer that diverges across replicas
    under data parallelism: a BatchNorm that tracks running statistics
    without ``sync``, or any other module with buffers of its own (judged
    divergent, since nothing declares otherwise)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            if m.track_running_stats and not m.sync:
                return True
        elif next(m.buffers(recurse=False), None) is not None:
            return True
    return False
