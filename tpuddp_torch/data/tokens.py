"""The synthetic next-token stream that the transformers train on — the port's
copy of ``TokenLMLoader`` (``tools/bench_mesh.py:62-105``), which the JAX
package trains its token models through (``tools/bench_mesh.py:108-135``).

Each epoch draws one token corpus from ``numpy.random.default_rng((seed,
epoch))``, ``(n_batches, global_batch, seq_len + 1)`` ints below ``vocab``;
batch ``s`` is its slice ``s``: the tokens, the tokens shifted by one as
targets, and all-ones weights (every token a sample). The same seed gives
the same global batches on any world.

One process of the port holds one rank, where the JAX package's one process
holds every replica: the loader takes ``(rank, world)`` and yields that
rank's rows of each global batch, the contiguous block of ``global_batch /
world`` rows that the JAX DDP wrap's ``shard`` places on data replica
``rank``. The loader protocol is the epoch loop's: ``len``,
``set_epoch``, ``make_batch_plan``, iteration and ``batch_nbytes`` (this
rank's input bytes of one batch).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class TokenLMLoader:
    def __init__(self, vocab: int, seq_len: int, global_batch: int, n_batches: int,
                 seed: int = 0, rank: int = 0, world: int = 1):
        if global_batch % world:
            raise ValueError(f"global_batch={global_batch} does not split over {world} ranks")
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} is not one of the world's {world}")
        self.vocab = int(vocab)
        self.seq_len = int(seq_len)
        self.global_batch = int(global_batch)
        self.n_batches = int(n_batches)
        self.seed = int(seed)
        self.rank, self.world = int(rank), int(world)
        self.batch_size = self.global_batch // self.world  # this rank's rows
        self.epoch = 0
        self.batch_nbytes = self.batch_size * self.seq_len * 4

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __len__(self) -> int:
        return self.n_batches

    def make_batch_plan(self):
        """``(n_batches, fetch)``: ``fetch(s)`` is this rank's rows of
        global batch ``s``, ``(tokens, targets, weights)``, int32, int32 and
        float32, each ``(global_batch / world, seq_len)``."""
        rng = np.random.default_rng((self.seed, self.epoch))
        # one contiguous token stream per epoch; batches slice it
        data = rng.integers(
            0, self.vocab, (self.n_batches, self.global_batch, self.seq_len + 1),
        ).astype(np.int32)
        lo = self.rank * self.batch_size

        def fetch(s: int):
            chunk = data[s, lo:lo + self.batch_size]
            x = np.ascontiguousarray(chunk[:, :-1])
            y = np.ascontiguousarray(chunk[:, 1:])
            return x, y, np.ones(x.shape, np.float32)

        return self.n_batches, fetch

    def __iter__(self):
        steps, fetch = self.make_batch_plan()
        for s in range(steps):
            yield fetch(s)


def token_loaders(rank: int, world: int, vocab: int, seq_len: int, global_batch: int,
                  n_batches: int, seed: int = 0, test_batches: Optional[int] = None):
    """``(train, test)`` loaders of rank ``rank`` as the JAX package pairs
    them (``tools/bench_mesh.py:127-129``): the test stream from ``seed + 1``
    with ``max(2, n_batches // 4)`` batches unless ``test_batches`` says."""
    test_n = max(2, n_batches // 4) if test_batches is None else int(test_batches)
    return (TokenLMLoader(vocab, seq_len, global_batch, n_batches, seed, rank, world),
            TokenLMLoader(vocab, seq_len, global_batch, test_n, seed + 1, rank, world))
