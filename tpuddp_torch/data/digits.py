"""Handwritten-digits dataset (scikit-learn's ``load_digits``) — the
counterpart of ``tpuddp/data/digits.py``: 1,797 real 8x8 digit scans, the
real-image workload that needs no download.

The arrays are the JAX package's, bit for bit: intensities 0..16 rescaled by
``round(x * 255 / 16)`` to uint8, the gray channel replicated to RGB (NHWC),
int32 labels; a ``RandomState(seed).permutation`` shuffle (``load_digits`` is
ordered in class blocks), then the 1,437/360 split through
:class:`~tpuddp_torch.data.synthetic.SyntheticClassification`.

scikit-learn is imported when the arrays are loaded, never at import time.
Without it, loading raises an ``ImportError`` that names it; there is no
fallback to synthetic data.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from tpuddp_torch.data.synthetic import SyntheticClassification

# Per-channel normalization of the rescaled set (tpuddp/data/digits.py:27-29)
DIGITS_MEAN = (0.3054, 0.3054, 0.3054)
DIGITS_STD = (0.3757, 0.3757, 0.3757)


def _load_arrays() -> Tuple[np.ndarray, np.ndarray]:
    try:
        from sklearn.datasets import load_digits
    except ImportError as e:
        raise ImportError(
            "training.dataset='digits' needs scikit-learn (sklearn.datasets.load_digits), "
            "which is not installed; the digits arrays are not in the repository "
            "(ROADMAP.md Queue 1 item 3: digits)"
        ) from e
    bunch = load_digits()
    images = np.round(bunch.images * (255.0 / 16.0)).astype(np.uint8)
    images = np.repeat(images[..., None], 3, axis=-1)
    return np.ascontiguousarray(images), bunch.target.astype(np.int32)


def load_datasets(n_test: int = 360, seed: int = 0):
    """(train, test): the seeded shuffle of the 1,797 digits, the last
    ``n_test`` for test (1,437/360 by default)."""
    images, labels = _load_arrays()
    perm = np.random.RandomState(seed).permutation(len(labels))
    return SyntheticClassification.from_arrays(images[perm], labels[perm]).split(n_test)
