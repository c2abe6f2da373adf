"""ResNets — the counterparts of ``tpuddp/models/resnet.py``: ResNet-18/34
(:class:`BasicBlock`) and ResNet-50/101/152 (:class:`Bottleneck`, the
torchvision v1.5 placement: the 3x3 convolution strides).

Laid out as torchvision's ResNet (``conv1``, ``bn1``, ``layer{1-4}.{i}.
conv{1..3}``/``bn{1..3}``, ``downsample.0``/``.1``, ``fc``), so its
``state_dict`` keys are torchvision's; a block has ``downsample`` exactly
where the JAX block has ``down_conv`` (its stride is not 1, or its input
width differs from its output). The JAX package's ``Sequential`` children
(stem layers, one child per block, the pool and the head) are what
:mod:`tpuddp_torch.models.convert` maps these keys to. ``forward`` takes
NHWC, as the JAX model does, and permutes to NCHW inside.

Stems: ``small_input`` (the CIFAR stem: 3x3/1 conv, BatchNorm, ReLU, no
max-pool); the full stem (7x7/2 conv with padding 3, BatchNorm, ReLU, 3x3/2
max-pool with padding 1); ``space_to_depth`` computes the full stem's
convolution as :class:`~tpuddp_torch.nn.layers.SpaceToDepthConv2d`, with the
same parameters, keys and initialisation. Every norm is the port's
:class:`~tpuddp_torch.nn.norm.BatchNorm` (``sync`` with ``sync_bn``). The
global average pool is ``x.mean((2, 3))``, as the JAX ``GlobalAvgPool``:
``AdaptiveAvgPool2d``'s CUDA backward is not deterministic, and a replayed
chunk must be bitwise its eager steps.

Mixed precision follows :mod:`tpuddp_torch.nn.layers` and
:mod:`tpuddp_torch.nn.norm`: convolutions and the head run in the input's
dtype with float32 master weights, BatchNorm normalises in float32 and
returns the input's dtype.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpuddp_torch.nn.layers import Conv2d, Linear, SpaceToDepthConv2d
from tpuddp_torch.nn.norm import BatchNorm

WIDTHS = (64, 128, 256, 512)  # each stage's block width; stage 1 keeps stride 1


def _downsample(in_ch: int, out: int, stride: int, sync_bn: bool):
    """The 1x1 projection shortcut where the JAX block has ``down_conv``."""
    if stride == 1 and in_ch == out:
        return None
    return nn.Sequential(Conv2d(in_ch, out, 1, stride=stride, bias=False),
                         BatchNorm(out, sync=sync_bn))


class BasicBlock(nn.Module):
    """Two 3x3 convolutions with an identity (or 1x1-projected) shortcut."""

    expansion = 1

    def __init__(self, in_ch: int, features: int, stride: int = 1, sync_bn: bool = False):
        super().__init__()
        self.conv1 = Conv2d(in_ch, features, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm(features, sync=sync_bn)
        self.conv2 = Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(features, sync=sync_bn)
        self.downsample = _downsample(in_ch, features, stride, sync_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        shortcut = x if self.downsample is None else self.downsample(x)
        return F.relu(h + shortcut)


class Bottleneck(nn.Module):
    """1x1 reduce, 3x3 (strided), 1x1 expand (x4), with an identity (or
    1x1-projected) shortcut."""

    expansion = 4

    def __init__(self, in_ch: int, features: int, stride: int = 1, sync_bn: bool = False):
        super().__init__()
        out = features * self.expansion
        self.conv1 = Conv2d(in_ch, features, 1, bias=False)
        self.bn1 = BatchNorm(features, sync=sync_bn)
        self.conv2 = Conv2d(features, features, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm(features, sync=sync_bn)
        self.conv3 = Conv2d(features, out, 1, bias=False)
        self.bn3 = BatchNorm(out, sync=sync_bn)
        self.downsample = _downsample(in_ch, out, stride, sync_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        shortcut = x if self.downsample is None else self.downsample(x)
        return F.relu(h + shortcut)


class ResNet(nn.Module):
    """Stem, ``block`` stages of ``depths`` blocks at widths 64-512, global
    average pool, Linear head."""

    def __init__(
        self,
        depths: Sequence[int],
        block=BasicBlock,
        num_classes: int = 10,
        sync_bn: bool = False,
        small_input: bool = False,
        space_to_depth: bool = False,
    ):
        super().__init__()
        if small_input and space_to_depth:
            raise ValueError(
                "space_to_depth applies to the full 7x7/s2 stem; the "
                "small_input CIFAR stem (3x3/s1) has no stride to block"
            )
        self.depths = tuple(depths)
        if small_input:
            self.conv1 = Conv2d(3, 64, 3, stride=1, padding=1, bias=False)
            self.maxpool = None
        else:
            stem = SpaceToDepthConv2d if space_to_depth else Conv2d
            self.conv1 = stem(3, 64, 7, stride=2, padding=3, bias=False)
            self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.bn1 = BatchNorm(64, sync=sync_bn)
        in_ch = 64
        for stage, (n_blocks, width) in enumerate(zip(self.depths, WIDTHS), start=1):
            stride = 1 if stage == 1 else 2
            blocks = []
            for b in range(n_blocks):
                blocks.append(block(in_ch, width, stride if b == 0 else 1, sync_bn))
                in_ch = width * block.expansion
            setattr(self, f"layer{stage}", nn.Sequential(*blocks))
        self.fc = Linear(in_ch, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))  # NHWC -> NCHW
        if self.maxpool is not None:
            h = self.maxpool(h)
        h = self.layer4(self.layer3(self.layer2(self.layer1(h))))
        return self.fc(h.mean((2, 3)))


# registry base name -> (blocks per stage, block)
DEPTHS = {
    "resnet18": ((2, 2, 2, 2), BasicBlock),
    "resnet34": ((3, 4, 6, 3), BasicBlock),
    "resnet50": ((3, 4, 6, 3), Bottleneck),
    "resnet101": ((3, 4, 23, 3), Bottleneck),
    "resnet152": ((3, 8, 36, 3), Bottleneck),
}


def resnet(name: str, num_classes: int = 10, sync_bn: bool = False) -> ResNet:
    """The registry's ResNet ``name``: ``resnet{18,34,50,101,152}``, each
    also with ``_small`` (the CIFAR stem) or ``_s2d`` (the space-to-depth
    full stem)."""
    small, s2d = name.endswith("_small"), name.endswith("_s2d")
    base = name[: -len("_small")] if small else name[: -len("_s2d")] if s2d else name
    depths, block = DEPTHS[base]
    return ResNet(depths, block, num_classes, sync_bn, small_input=small, space_to_depth=s2d)
