"""Rank-aware seeding — the counterpart of ``tpuddp/seeding.py`` and of the
reference tutorial's ``set_seed_based_on_rank``.

torch is seeded at ``base + rank`` and Python/NumPy at
``base % (2**32 - 1) + rank``: the reference's deliberately different seed
range is kept. Each rank also gets its own ``torch.Generator`` (seeded
``base + rank``) for host-side randomness such as the flip mask. On the GPU
``cudnn.deterministic = True`` / ``cudnn.benchmark = False`` are real
settings, not the JAX package's logged no-op.

The managed ``Accelerator`` keeps that generator as its per-process stream
(``tpuddp/accelerate.py:1378, 1487-1494``): the flip masks draw from it, and
:func:`split` and :func:`fork_from` derive fresh generators and the model's
initial weights from it, as ``jax.random.split`` derives keys.

The checkpoints also carry the JAX package's own keys, computed in numpy
(:mod:`tpuddp_torch._threefry`): :func:`jax_run_key`, the native
``TrainState.rng``, and :class:`JaxKeyStream`, the managed ``Accelerator``'s
per-process stream.
"""

from __future__ import annotations

import os
import random
import struct
from contextlib import contextmanager
from typing import Optional, Tuple

import numpy as np
import torch

from tpuddp_torch import _threefry


def initial_seed() -> int:
    """A fresh random base seed (analog of torch's per-run ``initial_seed``)."""
    return struct.unpack("<Q", os.urandom(8))[0] >> 1  # non-negative int64


def set_seed_based_on_rank(
    rank: int, base_seed: Optional[int] = None
) -> Tuple[torch.Generator, int]:
    """Seed torch, Python and NumPy for ``rank``; return
    ``(generator, base_seed)``. ``base_seed=None`` draws a fresh one."""
    if base_seed is None:
        base_seed = initial_seed()
    torch.manual_seed(int(base_seed) + rank)
    generator = torch.Generator().manual_seed(int(base_seed) + rank)

    # Python/NumPy: reduced seed range + rank, exactly the reference quirk.
    reduced_seed = int(base_seed) % (2**32 - 1)
    random.seed(reduced_seed + rank)
    np.random.seed((reduced_seed + rank) % (2**32))

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return generator, base_seed


def _next_seed(generator: torch.Generator) -> int:
    return int(torch.randint(0, 2**62, (1,), generator=generator))


def split(generator: torch.Generator) -> torch.Generator:
    """A fresh generator seeded from the next draw of ``generator``."""
    return torch.Generator().manual_seed(_next_seed(generator))


@contextmanager
def fork_from(generator: torch.Generator):
    """Inside the block torch's global CPU generator is seeded from the next
    draw of ``generator`` (a module built there draws its initial weights
    from the stream); outside it is as it was."""
    seed = _next_seed(generator)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        yield


def rng_probe_string(base_seed: Optional[int]) -> str:
    """Formatted RNG-state dump matching the reference's print_rand probe."""
    py_state = random.getstate()[1][:3]
    np_state = np.random.get_state()[1][:3]
    return (
        f"Python random state: {py_state}, numpy random state: {tuple(np_state)}; "
        f"base seed: {base_seed}"
    )


def jax_process_key(base_seed: int, rank: int) -> np.ndarray:
    """The JAX package's key of ``rank`` (``tpuddp/seeding.py:55``):
    ``fold_in(key(base_seed % 2**63), rank)``, as uint32 key data."""
    return _threefry.fold_in(_threefry.key(int(base_seed) % 2**63), rank)


def jax_run_key(base_seed: int) -> np.ndarray:
    """The native ``TrainState.rng`` of a JAX run of ``base_seed``:
    ``split(jax_process_key(base_seed, 0))[1]``, rank 0's, which the
    construction-time broadcast keeps (``tpuddp/training/train_state.py:60-68``,
    ``tpuddp/parallel/ddp.py:366-372``)."""
    return _threefry.split(jax_process_key(base_seed, 0))[1]


class JaxKeyStream:
    """The JAX ``Accelerator``'s per-process key stream
    (``tpuddp/accelerate.py:1378-1379, 1487-1494``): it starts at
    ``jax_process_key(base_seed, process_index)``, and each draw splits it
    and hands out the second half."""

    def __init__(self, base_seed: int, process_index: int):
        self.key = jax_process_key(base_seed, process_index)

    def draw(self) -> np.ndarray:
        self.key, sub = _threefry.split(self.key)
        return sub
