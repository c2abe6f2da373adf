"""Linear and Conv2d with the JAX package's mixed-precision rule
(``tpuddp/nn/layers.py:50-56, 134-144``): parameters stay float32 masters
and are cast to the input's dtype on every call, so a bfloat16 activation
runs the product in bfloat16 and the gradient flows back to the float32
weight through the cast. With a float32 input the cast is the identity and
the layer is ``torch.nn``'s own.

:class:`SpaceToDepthConv2d` is the JAX package's exact reparameterisation of
a strided convolution (``alexnet_s2d``'s stem).

Explicit casts, not ``torch.autocast``: autocast brings its own op lists and
cast cache, which the JAX package does not have, and the parity tests compare
dtypes layer by layer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


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
