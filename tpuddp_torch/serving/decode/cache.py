"""Paged KV-cache pool — the counterpart of ``tpuddp/serving/decode/cache.py``:
fixed-size block tables over one device-resident pool.

The decode engine's memory problem is the classic one: sequences have wildly
different lengths and lifetimes, but device arrays must be static-shaped. A
naive per-slot ``(max_slots, max_seq_len)`` cache wastes
``max_seq_len - length`` positions per sequence; the paged answer (vLLM's
PagedAttention, here in plain tensor gathers) carves ONE pool of
``kv_blocks x kv_block_size`` token positions per layer and maps each
sequence onto it through a per-slot block table — allocation is
block-granular, fragmentation is bounded by one block per sequence, and a
finishing sequence returns its blocks to the free list immediately, so a
queued request can join the running batch on the very next step.

Device side: ``kpool``/``vpool`` are ``(layers, kv_blocks, kv_block_size,
heads, head_dim)`` tensors written in place by the model's ``prefill`` and
``decode_step`` (:mod:`tpuddp_torch.models.transformer`).
**Block 0 is reserved as the garbage block**: inactive slots and padded
prefill positions redirect their writes there, so every scatter of the
step is total — one shape for any occupancy, which a CUDA graph needs —
and nothing an active sequence reads is ever aliased to it.

Host side: this class is pure bookkeeping — free-list allocation, per-slot
block tables and lengths (the int32 arrays the step program consumes), and
the occupancy accounting the SLO stats and the /metrics gauge report. It is
single-threaded by design (one decode loop owns one cache); no locks.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class PagedKVCache:
    """Block-table allocator + the host mirrors of the device pool geometry.

    ``num_blocks`` counts the WHOLE pool including reserved garbage block 0,
    so ``num_blocks - 1`` blocks are allocatable — sized so that
    ``max_slots`` concurrent sequences of worst-case length fit, or smaller
    when the operator accepts admission waits under pressure."""

    def __init__(
        self,
        layers: int,
        heads: int,
        head_dim: int,
        num_blocks: int,
        block_size: int,
        max_slots: int,
        max_seq_len: int,
    ):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is reserved), got {num_blocks}"
            )
        if block_size < 1 or max_slots < 1 or max_seq_len < 1:
            raise ValueError(
                f"block_size/max_slots/max_seq_len must be >= 1, got "
                f"{block_size}/{max_slots}/{max_seq_len}"
            )
        self.layers = int(layers)
        self.heads = int(heads)
        self.head_dim = int(head_dim)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.max_slots = int(max_slots)
        self.max_seq_len = int(max_seq_len)
        # max blocks any sequence can span — the block-table width, a static
        # shape of the decode step
        self.max_blocks = -(-self.max_seq_len // self.block_size)
        if self.allocatable < self.max_blocks:
            raise ValueError(
                f"kv_blocks={num_blocks} cannot hold even one max-length "
                f"sequence ({self.max_blocks} blocks of {block_size})"
            )
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        # host mirrors the step program consumes every iteration
        self.tables = np.zeros((self.max_slots, self.max_blocks), np.int32)
        self.lengths = np.zeros((self.max_slots,), np.int32)
        self._slot_blocks: List[Optional[List[int]]] = [None] * self.max_slots
        self._free_slots: List[int] = list(range(self.max_slots - 1, -1, -1))

    def pool_shape(self):
        """The device K/V pool shape (one array each for K and V)."""
        return (
            self.layers, self.num_blocks, self.block_size, self.heads,
            self.head_dim,
        )

    # --------------------------------------------------------- accounting --
    @property
    def allocatable(self) -> int:
        return self.num_blocks - 1  # block 0 reserved

    @property
    def used_blocks(self) -> int:
        return self.allocatable - len(self._free)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def free_slots(self) -> int:
        return len(self._free_slots)

    @property
    def active_slots(self) -> int:
        return self.max_slots - len(self._free_slots)

    def occupancy(self) -> float:
        """Allocated fraction of the allocatable pool — the KV-pressure
        gauge (/metrics + decode_stats windows)."""
        return self.used_blocks / self.allocatable

    def blocks_needed(self, total_tokens: int) -> int:
        return -(-int(total_tokens) // self.block_size)

    def can_admit(self, total_tokens: int) -> bool:
        """Whether a sequence of ``total_tokens`` worst-case length (prompt +
        max_new_tokens) can be placed RIGHT NOW: a free slot and enough free
        blocks for its whole lifetime — blocks are reserved up front so a
        running sequence can never hit pool exhaustion mid-decode."""
        return (
            bool(self._free_slots)
            and self.blocks_needed(total_tokens) <= len(self._free)
        )

    # --------------------------------------------------------- allocation --
    def allocate(self, total_tokens: int) -> int:
        """Reserve a slot + its lifetime block budget; returns the slot id.
        The slot starts at length 0 — the prefill commit advances it."""
        if total_tokens < 1 or total_tokens > self.max_seq_len:
            raise ValueError(
                f"sequence of {total_tokens} tokens outside [1, "
                f"{self.max_seq_len}]"
            )
        if not self.can_admit(total_tokens):
            raise RuntimeError(
                f"cannot admit a {total_tokens}-token sequence: "
                f"{self.free_slots} free slots, {self.free_blocks} free "
                f"blocks (need {self.blocks_needed(total_tokens)})"
            )
        slot = self._free_slots.pop()
        blocks = [self._free.pop() for _ in range(self.blocks_needed(total_tokens))]
        self._slot_blocks[slot] = blocks
        row = np.zeros((self.max_blocks,), np.int32)
        row[: len(blocks)] = blocks
        self.tables[slot] = row
        self.lengths[slot] = 0
        return slot

    def free(self, slot: int) -> None:
        """Return a finished sequence's blocks to the pool and its slot to
        the free set — the next step's admission sees the capacity."""
        blocks = self._slot_blocks[slot]
        if blocks is None:
            raise ValueError(f"slot {slot} is not allocated")
        self._free.extend(reversed(blocks))
        self._slot_blocks[slot] = None
        self.tables[slot] = 0
        self.lengths[slot] = 0
        self._free_slots.append(slot)
