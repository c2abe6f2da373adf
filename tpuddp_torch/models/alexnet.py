"""AlexNet — the counterpart of ``tpuddp/models/alexnet.py``.

Laid out exactly as torchvision's AlexNet (``features.N``, ``avgpool``,
``classifier.N``), so its ``state_dict`` keys are torchvision's. ``forward``
takes NHWC, as the JAX model does, and permutes to NCHW inside. Any spatial
size >= 63 works; the reference feeds 224x224 CIFAR upsamples.

Mixed precision follows the JAX package: every conv and linear runs in the
input's dtype with its float32 master weight cast per call
(:mod:`tpuddp_torch.nn.layers`); ReLU, pooling and dropout keep the dtype,
so a bfloat16 input gives bfloat16 logits (the loss takes them in float32).

``space_to_depth=True`` (``alexnet_s2d``) computes the 11x11 stride-4 stem
as :class:`~tpuddp_torch.nn.layers.SpaceToDepthConv2d`: the same sum
re-associated, with the same parameters, keys and initialisation, so the two
models load each other's checkpoints.
"""

from __future__ import annotations

import torch
from torch import nn

from tpuddp_torch.nn.layers import Conv2d, Linear, SpaceToDepthConv2d


class AlexNet(nn.Module):
    def __init__(self, num_classes: int = 10, dropout: float = 0.5, space_to_depth: bool = False):
        super().__init__()
        stem = SpaceToDepthConv2d if space_to_depth else Conv2d
        self.features = nn.Sequential(
            stem(3, 64, kernel_size=11, stride=4, padding=2),
            nn.ReLU(inplace=True),
            nn.MaxPool2d(kernel_size=3, stride=2),
            Conv2d(64, 192, kernel_size=5, padding=2),
            nn.ReLU(inplace=True),
            nn.MaxPool2d(kernel_size=3, stride=2),
            Conv2d(192, 384, kernel_size=3, padding=1),
            nn.ReLU(inplace=True),
            Conv2d(384, 256, kernel_size=3, padding=1),
            nn.ReLU(inplace=True),
            Conv2d(256, 256, kernel_size=3, padding=1),
            nn.ReLU(inplace=True),
            nn.MaxPool2d(kernel_size=3, stride=2),
        )
        self.avgpool = nn.AdaptiveAvgPool2d((6, 6))
        self.classifier = nn.Sequential(
            nn.Dropout(p=dropout),
            Linear(256 * 6 * 6, 4096),
            nn.ReLU(inplace=True),
            nn.Dropout(p=dropout),
            Linear(4096, 4096),
            nn.ReLU(inplace=True),
            Linear(4096, num_classes),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x.permute(0, 3, 1, 2))  # NHWC -> NCHW
        x = self.avgpool(x)
        return self.classifier(torch.flatten(x, 1))
