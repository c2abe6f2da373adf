"""DistributedSampler — a verbatim copy of ``tpuddp/parallel/sampler.py``.

The port keeps the JAX package's index order (numpy PCG64 permutation keyed
by ``seed + epoch``, pad-by-wrap, strided shard ``indices[rank::world]``), not
``torch.utils.data.DistributedSampler``'s, which permutes with
``torch.randperm`` and gives another order. One order for both packages lets
the parity tests feed them the same batches.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Sized, Union

import numpy as np


class DistributedSampler:
    """Shards dataset indices across the data-parallel world.

    Parameters mirror torch's: ``dataset`` (anything with ``len``, or an int
    length), ``num_replicas``, ``rank``, ``shuffle``, ``seed``, ``drop_last``.
    """

    def __init__(
        self,
        dataset: Union[Sized, int],
        num_replicas: Optional[int] = None,
        rank: Optional[int] = None,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        order_source=None,
    ):
        """``order_source``: optional externally-supplied base order (an
        iterable of dataset indices with ``len``) that REPLACES the seeded
        permutation while keeping this class's pad/drop_last/stride discipline
        authoritative — the mechanism behind preserving a user sampler's order
        in ``Accelerator.prepare`` (HF semantics: the custom sampler rides
        inside the sharded sampler). ``shuffle`` is ignored when set."""
        if num_replicas is None or rank is None:
            raise ValueError("num_replicas and rank are required")
        if not (0 <= rank < num_replicas):
            raise ValueError(f"rank {rank} not in [0, {num_replicas})")
        self.dataset_len = dataset if isinstance(dataset, int) else len(dataset)
        self.num_replicas = int(num_replicas)
        self.rank = int(rank)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.drop_last = bool(drop_last)
        self.order_source = order_source
        self.epoch = 0

        # sizes derive from the order's length when one is supplied (it may
        # be a subset of the dataset), else from the dataset length
        base_len = self.dataset_len if order_source is None else len(order_source)
        self._base_len = base_len
        if self.drop_last and base_len % self.num_replicas != 0:
            self.num_samples = base_len // self.num_replicas
        else:
            self.num_samples = math.ceil(base_len / self.num_replicas)
        self.total_size = self.num_samples * self.num_replicas

    def set_epoch(self, epoch: int) -> None:
        """Re-key the shuffle for a new epoch (reference usage at
        multi-GPU-training-torch.py:175-178). Must be called before iterating
        each epoch, on every rank, with the same value."""
        self.epoch = int(epoch)

    def _global_indices(self) -> np.ndarray:
        if self.order_source is not None:
            src = self.order_source
            if hasattr(src, "__array__"):
                # array-backed source (e.g. the loader's epoch memo): take
                # the ndarray directly, no per-element re-iteration
                indices = np.asarray(src, dtype=np.int64)
            else:
                indices = np.fromiter(iter(src), dtype=np.int64)
            if len(indices) != self._base_len:
                raise ValueError(
                    f"order_source produced {len(indices)} indices but "
                    f"declared len {self._base_len}; shard sizes were computed "
                    "from the declared length"
                )
        elif self.shuffle:
            rng = np.random.Generator(np.random.PCG64(self.seed + self.epoch))
            indices = rng.permutation(self.dataset_len)
        else:
            indices = np.arange(self.dataset_len)

        if not self.drop_last:
            padding = self.total_size - len(indices)
            if padding > 0:
                if padding <= len(indices):
                    indices = np.concatenate([indices, indices[:padding]])
                else:
                    reps = math.ceil(padding / len(indices))
                    indices = np.concatenate(
                        [indices, np.tile(indices, reps)[:padding]]
                    )
        else:
            indices = indices[: self.total_size]
        assert len(indices) == self.total_size
        return indices

    def local_indices(self) -> np.ndarray:
        """This rank's disjoint strided shard of the epoch permutation."""
        shard = self._global_indices()[self.rank : self.total_size : self.num_replicas]
        assert len(shard) == self.num_samples
        return shard

    def __iter__(self) -> Iterator[int]:
        return iter(self.local_indices().tolist())

    def __len__(self) -> int:
        return self.num_samples
