"""VGG-11/13/16/19 (torchvision configurations A/B/D/E) — the counterparts
of ``tpuddp/models/vgg.py``.

Laid out exactly as torchvision's VGG (``features.N``, ``avgpool``,
``classifier.{0,3,6}``), so its ``state_dict`` keys are torchvision's. The
features and the JAX package's ``Sequential`` indices are generated from
one plan per name (:data:`VGG_PLANS`, the port's copy of the JAX table): a
width is a 3x3 convolution and a ReLU, ``"M"`` a 2x2 stride-2 max-pool.
The classifier is Linear, ReLU, Dropout, Linear, ReLU, Dropout, Linear
after the 7x7 adaptive pool (the port's, :class:`~tpuddp_torch.nn.layers.
AdaptiveAvgPool2d`: the JAX bins, a backward without atomics; the identity
at 224 px). ``forward`` takes NHWC, as the JAX model does, and permutes to
NCHW inside.

Mixed precision follows :mod:`tpuddp_torch.nn.layers`: every convolution
and Linear runs in the input's dtype with its float32 master weight cast
per call; ReLU, pooling and dropout keep the dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from tpuddp_torch.nn.layers import AdaptiveAvgPool2d, Conv2d, Linear

# torchvision cfgs: numbers are conv widths, "M" is a 2x2/s2 max-pool
VGG_PLANS = {
    "vgg11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "vgg13": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "vgg16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
              512, 512, 512, "M"],
    "vgg19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}
POOL_GRID = 7  # the adaptive pool's output, each side
HIDDEN = 4096  # the classifier's width


def vgg_conv_indices(name: str):
    """The ``features.N`` indices that hold convolutions: the JAX
    ``Sequential``'s too (a width takes two places, a pool one)."""
    idx, out = 0, []
    for item in VGG_PLANS[name]:
        if item == "M":
            idx += 1
        else:
            out.append(idx)
            idx += 2
    return tuple(out)


def vgg_classifier_linear_indices(name: str):
    """The JAX ``Sequential`` indices of the three classifier Linears:
    features occupy ``[0, F)``, then the pool at F, Flatten at F+1, Linear
    at F+2, ReLU, Dropout, Linear at F+5, ReLU, Dropout, Linear at F+8."""
    f = sum(1 if item == "M" else 2 for item in VGG_PLANS[name])
    return (f + 2, f + 5, f + 8)


def vgg_channels(name: str) -> int:
    """The last convolution's width: the pooled map's channels."""
    return [item for item in VGG_PLANS[name] if item != "M"][-1]


class VGG(nn.Module):
    def __init__(self, name: str, num_classes: int = 10, dropout: float = 0.5):
        super().__init__()
        self.name = name
        layers, in_ch = [], 3
        for item in VGG_PLANS[name]:
            if item == "M":
                layers.append(nn.MaxPool2d(kernel_size=2, stride=2))
            else:
                layers += [Conv2d(in_ch, item, kernel_size=3, padding=1), nn.ReLU(inplace=True)]
                in_ch = item
        self.features = nn.Sequential(*layers)
        self.avgpool = AdaptiveAvgPool2d((POOL_GRID, POOL_GRID))
        self.classifier = nn.Sequential(
            Linear(in_ch * POOL_GRID * POOL_GRID, HIDDEN),
            nn.ReLU(inplace=True),
            nn.Dropout(p=dropout),
            Linear(HIDDEN, HIDDEN),
            nn.ReLU(inplace=True),
            nn.Dropout(p=dropout),
            Linear(HIDDEN, num_classes),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x.permute(0, 3, 1, 2))  # NHWC -> NCHW
        x = self.avgpool(x)
        return self.classifier(torch.flatten(x, 1))
