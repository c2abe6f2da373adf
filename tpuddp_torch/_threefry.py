"""JAX's default random keys in numpy uint32 arithmetic — enough of
``jax.random`` (threefry2x32, ``key``, ``fold_in``, ``split``) to write the
key leaves of the JAX package's checkpoints bitwise, without importing JAX.

A key is its key data: a uint32 array of shape ``(2,)``, as
``jax.random.key_data`` returns it. The functions follow JAX 0.9.0 with its
defaults:

- ``jax_enable_x64`` off: :func:`key` keeps the seed's low 32 bits, so
  ``key(seed) == [0, seed mod 2**32]`` for any Python int;
- ``jax_threefry_partitionable`` on: ``split(key, n)[i]`` is the hash of the
  64-bit counter ``i``, ``threefry2x32(key, (0, i))``, and not the old
  iota-and-reshape order (``threefry2x32(key, iota(2n))`` reshaped), which
  gives other keys. ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``
  under either flag.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0, x1):
    """The Threefry-2x32 block cipher with 20 rounds (Salmon et al. 2011),
    as ``jax._src.prng._threefry2x32_lowering``: the two counter words
    ``x0``, ``x1`` (uint32 arrays of one shape) hashed under ``key``;
    returns the two output words."""
    k0, k1 = (np.uint32(k) for k in np.asarray(key, np.uint32))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(_PARITY))
    x = [np.array(x0, np.uint32, ndmin=1) + ks[0], np.array(x1, np.uint32, ndmin=1) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def key(seed: int) -> np.ndarray:
    """``jax.random.key_data(jax.random.key(seed))`` with 64-bit types off:
    ``[0, seed mod 2**32]``."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)`` for a uint32 ``data``."""
    y0, y1 = threefry2x32(k, 0, int(data) & 0xFFFFFFFF)
    return np.array([y0[0], y1[0]], np.uint32)


def split(k: np.ndarray, n: int = 2) -> np.ndarray:
    """``jax.random.split(k, n)`` under ``jax_threefry_partitionable``:
    ``(n, 2)`` uint32, row ``i`` the hash of the counter ``(0, i)``."""
    y0, y1 = threefry2x32(k, np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))
    return np.stack([y0, y1], axis=1)
