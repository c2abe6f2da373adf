"""Device-side image transforms — the counterpart of
``tpuddp/data/transforms.py``.

The host ships raw uint8 NHWC 32x32 images; on the device they become float
in [0, 1], get a per-sample horizontal flip (train only), are normalized and
then resized bilinearly to the model's input size. The order (flip,
normalize, resize) is the JAX package's, and tensors stay NHWC at every
function boundary. All of it runs in float32; the last operation casts to
the compute dtype (``tpuddp/data/transforms.py:70,88``), so under
``compute_dtype: bfloat16`` the model receives bfloat16 images.

Nothing here reads a device value on the host or copies from the host once
the normalization statistics of a (device, dtype) are cached, so the train
transform can run inside a CUDA-graph capture; its flip masks are drawn
before it (``augment.flip_mask``) and passed in.

``F.interpolate(mode="bilinear", align_corners=False, antialias=False)``
agrees with ``jax.image.resize(..., "bilinear")`` when upsampling (both use
half-pixel centres and clamp at the edge), which is the only direction the
main path takes (32 -> 224).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from tpuddp_torch.data.cifar10 import CIFAR10_MEAN, CIFAR10_STD


def to_float(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] -> float32 [0,1]; floats pass through as float32."""
    if x.is_floating_point():
        return x.float()
    return x.float() / 255.0


def resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear resize of an NHWC batch to (size, size)."""
    y = F.interpolate(
        x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
        align_corners=False, antialias=False,
    )
    return y.permute(0, 2, 3, 1)


_STATS = {}  # (values, dtype, device) -> tensor


def _stat(values: Sequence[float], x: torch.Tensor) -> torch.Tensor:
    """``values`` as a tensor of ``x``'s dtype on its device, made once."""
    key = (tuple(values), x.dtype, x.device)
    if key not in _STATS:
        _STATS[key] = torch.tensor(values, dtype=x.dtype, device=x.device)
    return _STATS[key]


def normalize(
    x: torch.Tensor,
    mean: Sequence[float] = CIFAR10_MEAN,
    std: Sequence[float] = CIFAR10_STD,
) -> torch.Tensor:
    return (x - _stat(mean, x)) / _stat(std, x)


def horizontal_flip(x: torch.Tensor, flip_mask: torch.Tensor) -> torch.Tensor:
    """Flip the NHWC images whose ``flip_mask`` entry is True along W."""
    return torch.where(flip_mask.view(-1, 1, 1, 1), x.flip(2), x)


def flip_mask_like(
    x: torch.Tensor, generator: torch.Generator, p: float = 0.5, device=None,
) -> torch.Tensor:
    """One Bernoulli(p) per image, drawn on the host from ``generator`` (so a
    rank's masks follow its seed) and moved to ``device`` (``x``'s device
    when None)."""
    draws = torch.rand(x.shape[0], generator=generator)
    return (draws < p).to(x.device if device is None else device)


def make_train_augment(
    size: Optional[int] = 224,
    flip: bool = True,
    mean: Sequence[float] = CIFAR10_MEAN,
    std: Sequence[float] = CIFAR10_STD,
    generator: Optional[torch.Generator] = None,
    compute_dtype: torch.dtype = torch.float32,
):
    """Train transform: ``augment(x, flip_mask=None) -> x``. Without an
    explicit ``flip_mask`` the mask is drawn from ``generator`` (a fresh one
    seeded 0 when None); ``augment.flip_mask(x, device=None)`` draws the one
    the call would draw (None without flips), on ``x``'s device or on
    ``device``."""
    if flip and generator is None:
        generator = torch.Generator().manual_seed(0)

    def augment(x: torch.Tensor, flip_mask: Optional[torch.Tensor] = None):
        x = to_float(x)
        if flip:
            if flip_mask is None:
                flip_mask = flip_mask_like(x, generator)
            x = horizontal_flip(x, flip_mask)
        x = normalize(x, mean, std)
        if size is not None and (x.shape[1] != size or x.shape[2] != size):
            x = resize(x, size)
        return x.to(compute_dtype)

    augment.flip_mask = lambda x, device=None: flip_mask_like(x, generator, device=device) if flip else None
    return augment


def make_eval_transform(
    size: Optional[int] = 224,
    mean: Sequence[float] = CIFAR10_MEAN,
    std: Sequence[float] = CIFAR10_STD,
    compute_dtype: torch.dtype = torch.float32,
):
    """Eval transform (no flip)."""

    def transform(x: torch.Tensor) -> torch.Tensor:
        x = normalize(to_float(x), mean, std)
        if size is not None and (x.shape[1] != size or x.shape[2] != size):
            x = resize(x, size)
        return x.to(compute_dtype)

    return transform
