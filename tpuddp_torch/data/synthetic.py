"""Synthetic, learnable classification datasets — a copy of
``tpuddp/data/synthetic.py``, so both packages draw the same arrays from the
same seed.

Deterministic Gaussian class clusters, so loss actually decreases and parity
tests have signal.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class SyntheticClassification:
    """x = class_mean[y] + noise. Arrays live in host memory; ``get_batch``
    does vectorized fancy-indexing (the fast path loaders prefer)."""

    def __init__(
        self,
        n: int = 1024,
        shape: Tuple[int, ...] = (32, 32, 3),
        num_classes: int = 10,
        noise: float = 0.5,
        seed: int = 0,
        dtype=np.float32,
    ):
        rng = np.random.RandomState(seed)
        self.num_classes = num_classes
        self.labels = rng.randint(0, num_classes, size=n).astype(np.int32)
        means = rng.randn(num_classes, *shape).astype(np.float32)
        self.images = (
            means[self.labels] + noise * rng.randn(n, *shape).astype(np.float32)
        ).astype(dtype)

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, i):
        return self.images[i], self.labels[i]

    def get_batch(self, indices):
        idx = np.asarray(indices)
        return self.images[idx], self.labels[idx]

    @classmethod
    def from_arrays(cls, images: np.ndarray, labels: np.ndarray):
        ds = cls.__new__(cls)
        ds.images = images
        ds.labels = labels
        ds.num_classes = int(labels.max()) + 1 if len(labels) else 0
        return ds

    def split(self, n_test: int):
        """(train, test) views sharing this dataset's class distribution —
        a real generalization split, unlike two differently-seeded sets."""
        return (
            self.from_arrays(self.images[:-n_test], self.labels[:-n_test]),
            self.from_arrays(self.images[-n_test:], self.labels[-n_test:]),
        )


def synthetic_uint8_datasets(n_train: int = 2048, n_test: int = 512, seed: int = 0):
    """(train, test) uint8 image datasets in the CIFAR loader's format — the
    single source for every synthetic stand-in (the cifar10 fallback and the
    'synthetic' dataset name must draw the same distribution)."""
    full = SyntheticClassification(n=n_train + n_test, shape=(32, 32, 3), seed=seed)
    full.images = np.clip(full.images * 40 + 128, 0, 255).astype(np.uint8)
    return full.split(n_test)
