"""ToyMLP and ToyCNN — the counterparts of ``tpuddp/models/toy.py``.

Each is a ``Sequential`` with the JAX model's layer indices, so
``state_dict`` keys name the same positions as the JAX parameter tuple:

- ToyMLP: 0 Flatten, 1 Linear, 2 ReLU, 3 Linear, 4 ReLU, 5 Linear. The NHWC
  input is flattened as it is, with no permute, so a Linear weight differs
  from JAX's only by a transpose.
- ToyCNN: per width, Conv 3x3 (no bias: BatchNorm cancels it), BatchNorm,
  ReLU, MaxPool 2; then Flatten and a Linear head (0-3, 4-7, 8 Flatten,
  9 Linear for the default widths (32, 64)). The convolutions run NCHW; the
  NHWC input is permuted once at the start, and the Flatten permutes back,
  flattening ``(h, w, c)`` as the JAX model's NHWC Flatten does, so the
  head's weight too differs from JAX's only by a transpose.

Linear and Conv2d cast their float32 weights to the input's dtype
(:mod:`tpuddp_torch.nn.layers`); BatchNorm normalises in float32 and returns
the input's dtype.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tpuddp_torch.nn.layers import Conv2d, Linear
from tpuddp_torch.nn.norm import BatchNorm


class ToyMLP(nn.Sequential):
    def __init__(
        self, in_features: int, num_classes: int = 10, hidden: Sequence[int] = (256, 128)
    ):
        layers = [nn.Flatten()]
        width = in_features
        for h in hidden:
            layers += [Linear(width, h), nn.ReLU()]
            width = h
        layers.append(Linear(width, num_classes))
        super().__init__(*layers)


class FlattenNHWC(nn.Module):
    """Flatten an NCHW batch in ``(h, w, c)`` order."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute(0, 2, 3, 1).flatten(1)


class ToyCNN(nn.Sequential):
    def __init__(
        self,
        num_classes: int = 10,
        widths: Sequence[int] = (32, 64),
        input_shape: Sequence[int] = (32, 32, 3),
        sync_bn: bool = False,
    ):
        h, w, c = input_shape
        layers = []
        for width in widths:
            layers += [
                Conv2d(c, width, kernel_size=3, padding=1, bias=False),
                BatchNorm(width, sync=sync_bn),
                nn.ReLU(),
                nn.MaxPool2d(2),
            ]
            c, h, w = width, h // 2, w // 2
        layers += [FlattenNHWC(), Linear(h * w * c, num_classes)]
        super().__init__(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2))  # NHWC -> NCHW
