"""Linear and Conv2d with the JAX package's mixed-precision rule
(``tpuddp/nn/layers.py:50-56, 134-144``): parameters stay float32 masters
and are cast to the input's dtype on every call, so a bfloat16 activation
runs the product in bfloat16 and the gradient flows back to the float32
weight through the cast. With a float32 input the cast is the identity and
the layer is ``torch.nn``'s own.

:class:`SpaceToDepthConv2d` is the JAX package's exact reparameterisation of
a strided convolution (``alexnet_s2d``'s stem).

:class:`AdaptiveAvgPool2d` is the JAX package's adaptive average pool
(``tpuddp/nn/layers.py:258-321``) as two products with fixed bin matrices,
so that its backward has no atomics and repeats bit for bit on a GPU.

:func:`global_batch_dropout` makes a model's dropout layers draw the
global batch's mask and keep this replica's rows (``mode: auto``).

:class:`Embedding` is the JAX package's token-id lookup table
(``tpuddp/nn/layers.py:62-83``), the transformers' embeddings and tied head.
Its backward is an accumulating ``index_put_``, which sums each row's
gradients in one order on every run (sorted by id on a GPU): the backward
of ``torch.nn.functional.embedding`` on a GPU can add them in an order that
changes from run to run (on a transformer_small batch of 64 x 256 tokens
on an H100 it did), and then neither two runs nor a CUDA-graph replay and
its eager steps can be held bitwise.

Explicit casts, not ``torch.autocast``: autocast brings its own op lists and
cast cache, which the JAX package does not have, and the parity tests compare
dtypes layer by layer.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class _Lookup(torch.autograd.Function):
    """Rows ``ids`` of ``weight``; the backward sums each row's gradients
    with an accumulating ``index_put_``, the same bits on every run."""

    @staticmethod
    def forward(ctx, weight: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(ids)
        ctx.rows = weight.shape[0]
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (ids,) = ctx.saved_tensors
        flat = grad.reshape(-1, grad.shape[-1])
        out = flat.new_zeros((ctx.rows, flat.shape[1]))
        out.index_put_((ids.reshape(-1).long(),), flat, accumulate=True)
        return out, None


class Embedding(nn.Module):
    """Token-id lookup: ids of any shape -> ``(*ids.shape, features)`` rows
    of ``weight``, a ``(num_embeddings, features)`` table in torch's layout
    (``nn.Embedding``'s, so its ``state_dict`` key is ``weight``), N(0, 1)
    at init, drawn from ``generator`` when given. A transformer ties its LM
    head to this table (logits = h @ W.T)."""

    def __init__(self, num_embeddings: int, features: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_embeddings, self.features = int(num_embeddings), int(features)
        self.weight = nn.Parameter(torch.empty(self.num_embeddings, self.features, device=device))
        if not self.weight.is_meta:
            with torch.no_grad():
                self.weight.normal_(generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return _Lookup.apply(self.weight, ids)


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class SpaceToDepthConv2d(Conv2d):
    """A strided convolution computed as space-to-depth plus a stride-1
    convolution (``tpuddp/nn/layers.py:150-218``), on NCHW: the input is
    padded so that every window starts on a block boundary, blocked
    ``(C, H, W) -> (s*s*C, H/s, W/s)``; the ``(F, C, kh, kw)`` weight is
    zero-padded to a multiple of ``s`` and reshaped to match, so a VALID
    stride-1 convolution, cropped to the output size, computes the same sum
    re-associated. Parameters keep :class:`Conv2d`'s shapes and names, so
    initialisation, ``state_dict`` and checkpoints are interchangeable with
    it. The convolution itself is cuDNN's (XLA's ``conv_general_dilated`` in
    the JAX package). Needs a square integer stride of at least 2 (the block
    size) and an integer, symmetric padding."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride, padding=0,
                 bias: bool = True):
        strides = (stride, stride) if isinstance(stride, int) else tuple(stride)
        if strides[0] != strides[1] or strides[0] < 2:
            raise ValueError(
                f"SpaceToDepthConv2d needs a square stride >= 2 (the block size); got {strides}"
            )
        if not isinstance(padding, int) or isinstance(padding, bool):
            raise ValueError("SpaceToDepthConv2d supports integer (symmetric) padding only")
        super().__init__(in_channels, out_channels, kernel_size, stride=strides, padding=padding,
                         bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.stride[0]
        kh, kw = self.kernel_size
        p = self.padding[0]
        n, c, h, w = x.shape
        oh, ow = (h + 2 * p - kh) // s + 1, (w + 2 * p - kw) // s + 1
        kbh, kbw = -(-kh // s), -(-kw // s)

        def pads(dim, o, k):  # left p; right slack for the last window, to an s multiple
            right = max(p, s * (o - 1) + k - dim - p)
            right += -(dim + p + right) % s
            return p, right

        (top, bottom), (left, right) = pads(h, oh, kbh * s), pads(w, ow, kbw * s)
        xp = F.pad(x, (left, right, top, bottom))
        bh, bw = xp.shape[2] // s, xp.shape[3] // s
        # channel (sh * s + sw) * C + c, the JAX package's blocked order
        xb = xp.reshape(n, c, bh, s, bw, s).permute(0, 3, 5, 1, 2, 4).reshape(n, s * s * c, bh, bw)
        wk = F.pad(self.weight.to(x.dtype), (0, kbw * s - kw, 0, kbh * s - kh))
        wb = wk.reshape(-1, c, kbh, s, kbw, s).permute(0, 3, 5, 1, 2, 4).reshape(-1, s * s * c, kbh, kbw)
        y = F.conv2d(xb, wb)[:, :, :oh, :ow]
        if self.bias is not None:
            y = y + self.bias.to(y.dtype).view(1, -1, 1, 1)
        return y


def _bin_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """The ``(n_out, n_in)`` float32 matrix whose row ``i`` is 1 on the
    JAX package's bin ``[floor(i * n_in / n_out), ceil((i + 1) * n_in /
    n_out))`` and 0 elsewhere; made by device ops only (no copy from the
    host, so it may be built inside a CUDA-graph capture)."""
    i = torch.arange(n_out, device=device)
    starts = torch.div(i * n_in, n_out, rounding_mode="floor")
    ends = -torch.div(-(i + 1) * n_in, n_out, rounding_mode="floor")
    j = torch.arange(n_in, device=device)
    return ((j >= starts[:, None]) & (j < ends[:, None])).float()


class AdaptiveAvgPool2d(nn.Module):
    """Adaptive average pooling of NCHW to ``output_size`` with the JAX
    package's bins (``tpuddp/nn/layers.py:270-294``): output ``(i, j)``
    averages the rows of bin ``i`` and the columns of bin ``j``, so bins
    overlap where the sizes do not divide and repeat one input where the
    output is larger (1 -> 7). Each bin's sum is ``A_h @ x @ A_w^T`` with
    the 0/1 bin matrices of :func:`_bin_matrix`, divided by the bin's area,
    in float32, cast back to the input's dtype, as the JAX layer pools.
    ``torch.nn.AdaptiveAvgPool2d``'s CUDA backward sums into the input with
    atomics, so where bins overlap its gradient varies from run to run;
    the backward of these products is two more products, the same bits on
    every run. At identity bins (7 -> 7) the input is returned as it is."""

    def __init__(self, output_size):
        super().__init__()
        self.output_size = (output_size, output_size) if isinstance(output_size, int) else tuple(output_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (h, w), (oh, ow) = x.shape[-2:], self.output_size
        if (h, w) == (oh, ow):
            return x
        rows, cols = _bin_matrix(h, oh, x.device), _bin_matrix(w, ow, x.device)
        sums = rows @ x.float() @ cols.T
        area = rows.sum(1)[:, None] * cols.sum(1)[None, :]
        return (sums / area).to(x.dtype)


def _rows_dropout(self, x: torch.Tensor) -> torch.Tensor:
    """``nn.Dropout``'s forward on replica ``rank``'s rows of a global batch
    of ``world`` such batches: the mask of the whole (drawn alike on every
    replica from a stream seeded alike), this replica's rows of it."""
    if not self.training or self.p == 0.0:
        return x
    rank, world = self.tpuddp_rows
    b = x.shape[0]
    keep = F.dropout(torch.ones((world * b,) + tuple(x.shape[1:]), dtype=x.dtype,
                                device=x.device), self.p, True)
    return x * keep[rank * b:(rank + 1) * b]


def global_batch_dropout(model: nn.Module, rank: int, world: int) -> nn.Module:
    """Every ``nn.Dropout`` of ``model`` draws the mask of the global batch
    (``world`` replicas' rows, in rank order) and keeps replica ``rank``'s
    rows: ``mode: auto``'s one dropout key per step, which the JAX package
    draws over the whole sharded batch (``tpuddp/training/step.py:134-141``
    with no replica fold). Needs torch's generators seeded alike on every
    replica. Returns ``model``."""
    for m in model.modules():
        if isinstance(m, nn.Dropout):
            m.tpuddp_rows = (int(rank), int(world))
            m.forward = _rows_dropout.__get__(m)
    return model
