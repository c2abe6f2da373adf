"""Handwritten-digits dataset — the counterpart of ``tpuddp/data/digits.py``:
1,797 real 8x8 digit scans, the real-image workload that needs no download.

The arrays ship with the port as ``digits.npz`` beside this file (66 KB):
``images``, uint8 ``(1797, 8, 8, 3)``, and ``labels``, int32 ``(1797,)``,
bit for bit the JAX package's ``_load_arrays()`` (intensities 0..16 rescaled
by ``round(x * 255 / 16)`` to uint8, the gray channel replicated to RGB,
NHWC). They were written from scikit-learn 1.9.0's bundled copy
(``sklearn/datasets/data/digits.csv.gz``, read by ``load_digits``) of the
UCI ML "Optical Recognition of Handwritten Digits" data set's test part (E.
Alpaydin and C. Kaynak, 1998; UCI Machine Learning Repository, CC BY 4.0;
scikit-learn is BSD-3-Clause). So digits need neither scikit-learn nor a
network at run time.

:func:`load_datasets` applies the JAX package's ``RandomState(seed)
.permutation`` shuffle (``load_digits`` is ordered in class blocks), then
the 1,437/360 split through
:class:`~tpuddp_torch.data.synthetic.SyntheticClassification`.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from tpuddp_torch.data.synthetic import SyntheticClassification

ARRAYS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "digits.npz")

# Per-channel normalization of the rescaled set (tpuddp/data/digits.py:27-29)
DIGITS_MEAN = (0.3054, 0.3054, 0.3054)
DIGITS_STD = (0.3757, 0.3757, 0.3757)


def _load_arrays() -> Tuple[np.ndarray, np.ndarray]:
    with np.load(ARRAYS) as data:
        return np.ascontiguousarray(data["images"]), np.ascontiguousarray(data["labels"])


def load_datasets(n_test: int = 360, seed: int = 0):
    """(train, test): the seeded shuffle of the 1,797 digits, the last
    ``n_test`` for test (1,437/360 by default)."""
    images, labels = _load_arrays()
    perm = np.random.RandomState(seed).permutation(len(labels))
    return SyntheticClassification.from_arrays(images[perm], labels[perm]).split(n_test)
