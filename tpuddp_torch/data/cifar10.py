"""CIFAR-10 — torchvision-free loader, the counterpart of
``tpuddp/data/cifar10.py`` without its downloader.

Reads either on-disk format (``cifar-10-batches-py`` pickle batches or
``cifar-10-batches-bin`` binaries) from ``root``, ``$TPUDDP_DATA`` or
``./data``. Images stay uint8 NHWC 32x32 in host memory; resize, flip and
normalize run on the device (:mod:`tpuddp_torch.data.transforms`).

There is no download: a missing dataset raises ``FileNotFoundError``, and
``load_datasets(synthetic_fallback=True)`` substitutes the seeded synthetic
stand-in, exactly what the JAX path does after its download fails.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Optional, Tuple

import numpy as np

from tpuddp_torch.data.synthetic import synthetic_uint8_datasets

PY_DIR = "cifar-10-batches-py"
BIN_DIR = "cifar-10-batches-bin"
TRAIN_PY = [f"data_batch_{i}" for i in range(1, 6)]
TEST_PY = ["test_batch"]
TRAIN_BIN = [f"data_batch_{i}.bin" for i in range(1, 6)]
TEST_BIN = ["test_batch.bin"]

# Normalization constants the reference bakes in (data_and_toy_model.py:17,25).
CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2023, 0.1994, 0.2010)


def _load_py_batch(path: str) -> Tuple[np.ndarray, np.ndarray]:
    # the CIFAR-10 python batches are pickles; only read a staged dataset
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    data = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # -> NHWC
    labels = np.asarray(d[b"labels"], dtype=np.int32)
    return np.ascontiguousarray(data), labels


def _load_bin_batch(path: str) -> Tuple[np.ndarray, np.ndarray]:
    raw = np.fromfile(path, dtype=np.uint8).reshape(-1, 3073)
    labels = raw[:, 0].astype(np.int32)
    data = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(data), labels


def _search_roots(root: Optional[str]):
    roots = []
    if root:
        roots.append(root)
    env = os.environ.get("TPUDDP_DATA")
    if env:
        roots.append(env)
    roots.append("./data")
    return roots


def find_cifar10(root: Optional[str] = None) -> Optional[Tuple[str, str]]:
    """Locate an extracted CIFAR-10 copy. Returns (dir, format) or None."""
    for r in _search_roots(root):
        for sub, fmt in ((PY_DIR, "py"), (BIN_DIR, "bin")):
            d = os.path.join(r, sub)
            if os.path.isdir(d):
                return d, fmt
        # tolerate pointing straight at the batches dir
        if os.path.basename(r) in (PY_DIR, BIN_DIR) and os.path.isdir(r):
            return r, ("py" if os.path.basename(r) == PY_DIR else "bin")
    return None


class CIFAR10:
    """In-memory CIFAR-10 split with the vectorized ``get_batch`` path.
    Images: uint8 (N, 32, 32, 3); labels: int32 (N,)."""

    def __init__(self, root: str = "./data", train: bool = True):
        found = find_cifar10(root)
        if found is None:
            raise FileNotFoundError(
                f"CIFAR-10 not found (searched {_search_roots(root)}); stage "
                "cifar-10-batches-py/ or cifar-10-batches-bin/ under the data root"
            )
        d, fmt = found
        if fmt == "py":
            names, loader = (TRAIN_PY if train else TEST_PY), _load_py_batch
        else:
            names, loader = (TRAIN_BIN if train else TEST_BIN), _load_bin_batch
        xs, ys = zip(*(loader(os.path.join(d, n)) for n in names))
        self.images = np.concatenate(xs)
        self.labels = np.concatenate(ys)
        self.num_classes = 10

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, i):
        return self.images[i], self.labels[i]

    def get_batch(self, indices):
        idx = np.asarray(indices)
        return self.images[idx], self.labels[idx]


def load_datasets(
    root: str = "./data",
    synthetic_fallback: bool = False,
    synthetic_n: Tuple[int, int] = (2048, 512),
):
    """(train, test) datasets; with ``synthetic_fallback`` a missing CIFAR-10
    becomes the seeded synthetic uint8 stand-in."""
    try:
        return CIFAR10(root, train=True), CIFAR10(root, train=False)
    except FileNotFoundError:
        if not synthetic_fallback:
            raise
        logging.getLogger("tpuddp_torch").warning(
            "CIFAR-10 unavailable; using synthetic uint8 stand-in datasets"
        )
        return synthetic_uint8_datasets(synthetic_n[0], synthetic_n[1])
