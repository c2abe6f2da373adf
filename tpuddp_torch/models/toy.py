"""ToyMLP — the counterpart of ``tpuddp/models/toy.py``'s ``ToyMLP``.

A ``Sequential`` with the JAX model's layer indices (0 Flatten, 1 Linear,
2 ReLU, 3 Linear, 4 ReLU, 5 Linear), so ``state_dict`` keys name the same
positions as the JAX parameter tuple. The NHWC input is flattened as it is,
with no permute, so a Linear weight differs from JAX's only by a transpose.
"""

from __future__ import annotations

from typing import Sequence

from torch import nn


class ToyMLP(nn.Sequential):
    def __init__(
        self, in_features: int, num_classes: int = 10, hidden: Sequence[int] = (256, 128)
    ):
        layers = [nn.Flatten()]
        width = in_features
        for h in hidden:
            layers += [nn.Linear(width, h), nn.ReLU()]
            width = h
        layers.append(nn.Linear(width, num_classes))
        super().__init__(*layers)
