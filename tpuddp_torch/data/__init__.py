"""Data layer: datasets, the per-process loader and device-side transforms —
the counterpart of ``tpuddp/data``."""

from typing import Any, Dict, Sequence, Tuple

import torch

from tpuddp_torch.data.loader import DataLoader, PrefetchLoader, ShardedDataLoader  # noqa: F401
from tpuddp_torch.data.synthetic import SyntheticClassification  # noqa: F401


def load_datasets_for(training: Dict[str, Any], synthetic_fallback: bool = True):
    """(train, test) datasets for ``training.dataset``: ``cifar10`` (falling
    back to the synthetic stand-in when none is staged), ``digits`` (the
    arrays in the repository) or ``synthetic``."""
    name = str(training.get("dataset") or "cifar10")
    n = tuple(training.get("synthetic_n") or (2048, 512))
    if name == "cifar10":
        from tpuddp_torch.data import cifar10

        return cifar10.load_datasets(
            training.get("data_root", "./data"),
            synthetic_fallback=synthetic_fallback,
            synthetic_n=n,
        )
    if name == "synthetic":
        from tpuddp_torch.data.synthetic import synthetic_uint8_datasets

        return synthetic_uint8_datasets(n[0], n[1])
    if name == "digits":
        from tpuddp_torch.data import digits

        return digits.load_datasets()
    raise ValueError(
        f"unknown training.dataset {name!r}; one of cifar10, digits, synthetic"
    )


def flip_for(training: Dict[str, Any]) -> bool:
    """Horizontal-flip setting: explicit ``training.flip`` wins; the default
    follows the dataset (CIFAR photos are flip-invariant, digits are not)."""
    f = training.get("flip")
    if f is not None:
        return bool(f)
    return str(training.get("dataset") or "cifar10") != "digits"


def compute_dtype_for(training: Dict[str, Any]) -> torch.dtype:
    """Activation dtype for the device-side transforms and the model:
    ``bfloat16`` (``bf16``) is mixed precision (float32 master weights,
    bfloat16 activations), ``float32`` the default."""
    name = str(training.get("compute_dtype") or "float32")
    table = {"float32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}
    if name not in table:
        raise ValueError(
            f"unknown training.compute_dtype {name!r}; one of float32, bfloat16"
        )
    return table[name]


def norm_stats_for(training: Dict[str, Any]) -> Tuple[Sequence[float], Sequence[float]]:
    """Per-dataset normalization (mean, std) for the device-side transforms:
    the digits statistics for ``digits``, CIFAR-10's otherwise."""
    if str(training.get("dataset") or "cifar10") == "digits":
        from tpuddp_torch.data.digits import DIGITS_MEAN, DIGITS_STD

        return DIGITS_MEAN, DIGITS_STD
    from tpuddp_torch.data.cifar10 import CIFAR10_MEAN, CIFAR10_STD

    return CIFAR10_MEAN, CIFAR10_STD


__all__ = [
    "DataLoader",
    "PrefetchLoader",
    "ShardedDataLoader",
    "SyntheticClassification",
    "load_datasets_for",
    "compute_dtype_for",
    "norm_stats_for",
    "flip_for",
]
