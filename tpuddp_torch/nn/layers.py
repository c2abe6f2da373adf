"""Linear and Conv2d with the JAX package's mixed-precision rule
(``tpuddp/nn/layers.py:50-56, 134-144``): parameters stay float32 masters
and are cast to the input's dtype on every call, so a bfloat16 activation
runs the product in bfloat16 and the gradient flows back to the float32
weight through the cast. With a float32 input the cast is the identity and
the layer is ``torch.nn``'s own.

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
