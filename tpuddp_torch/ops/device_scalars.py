"""Per-step scalars that a launch captured into a CUDA graph reads from device
memory.

An eager launch takes the scalars that change from step to step (Adam's bias
corrections and bf16 noise words, LAMB's inverse bias corrections) from the
host, by value. A launch captured into a CUDA graph would replay the values
of the step it was captured in. So while a capturing :class:`Recorder` is
active (the capture of ``training/graphs.py``), :meth:`Recorder.slot` gives
each such launch a slice of a device buffer to read its scalars from
instead, and :func:`on_replay` registers the host code that recomputes them
for a later step. Before each later replay :meth:`Recorder.refresh` runs
that code (it also advances the host counters the replay skips, such as each
parameter's step count) and :meth:`Recorder.upload` copies the buffer's new
content to the device: one copy from a fresh pinned block, ordered on the
current stream before the replay that reads it.

The buffer is allocated before the capture, at the size that the same
flush's eager warm-up counted (a counting :class:`Recorder`): memory taken
during a capture may be memory that the graph's earlier kernels use as
scratch, which would overwrite the scalars uploaded before the replay.

A step under the numerical guard takes no slot: whether it applies, and
so its step count, is known only on the device, and the guarded launch
reads its step from there (``ops/fused_adam.py``).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

# slots start on 16-byte boundaries (a kernel may read four words as one)
ALIGN_WORDS = 4

_active: Optional["Recorder"] = None


def active() -> Optional["Recorder"]:
    """The active :class:`Recorder`, if any. Its :meth:`~Recorder.slot`
    returns None while it only counts (the launch then runs as an eager
    one)."""
    return _active


def capturing() -> bool:
    """True while a capturing :class:`Recorder` is active."""
    return _active is not None and _active.buffer is not None


def on_replay(fn: Callable[[], List[np.ndarray]]) -> None:
    """Register ``fn``, which advances the host state of one captured call
    (an optimizer step) and returns the words of that call's slots, in the
    order it took them. Nothing happens unless a capture is active."""
    if capturing():
        _active.callbacks.append(fn)


def _aligned(n: int) -> int:
    return -(-n // ALIGN_WORDS) * ALIGN_WORDS


class Recorder:
    """The slots of one captured graph and the host code that refills them;
    with ``capacity`` None it only counts the words a capture of the same
    work takes. Use as a context manager around the capture (or the
    warm-up)."""

    def __init__(self, device: torch.device, capacity: Optional[int] = None):
        self.words = 0  # in use, slots aligned
        self.buffer = None if capacity is None else torch.empty(
            max(capacity, 1), dtype=torch.float32, device=device)
        self.image = None if capacity is None else np.zeros(max(capacity, 1), np.float32)
        self.slots: List[tuple] = []  # (offset, words), in capture order
        self.callbacks: List[Callable[[], List[np.ndarray]]] = []

    def __enter__(self) -> "Recorder":
        global _active
        if _active is not None:
            raise RuntimeError("a CUDA-graph capture is already recording scalars")
        _active = self
        return self

    def __exit__(self, *exc) -> None:
        global _active
        _active = None

    def slot(self, words: np.ndarray) -> Optional[torch.Tensor]:
        """A float32 device view holding ``words`` (4-byte words: float32
        values, or uint32 bits viewed as float32) for the launch being
        captured, refreshed before every replay; None while counting."""
        words = np.ascontiguousarray(words).view(np.float32).reshape(-1)
        n, off = len(words), self.words
        self.words = off + _aligned(n)
        if self.buffer is None:
            return None
        if self.words > len(self.image):
            raise RuntimeError(
                f"CUDA-graph capture: its scalars take more than the {len(self.image)} words "
                "its eager warm-up counted"
            )
        self.image[off:off + n] = words
        self.slots.append((off, n))
        return self.buffer[off:off + n]

    def refresh(self) -> None:
        """Run the registered host code in order and write the words it
        returns into the slots, which must match the capture's one for
        one."""
        arrays = [a for fn in self.callbacks for a in fn()]
        if len(arrays) != len(self.slots):
            raise RuntimeError(
                f"CUDA-graph replay: {len(arrays)} scalar arrays for {len(self.slots)} "
                "captured slots"
            )
        for (off, n), a in zip(self.slots, arrays):
            a = np.ascontiguousarray(a).view(np.float32).reshape(-1)
            if len(a) != n:
                raise RuntimeError(f"CUDA-graph replay: a slot of {n} words got {len(a)}")
            self.image[off:off + n] = a

    def upload(self) -> None:
        """Copy the host image to the device buffer on the current stream,
        from a fresh pinned block (PyTorch's host allocator keeps it until
        the copy has run)."""
        if self.words:
            host = torch.from_numpy(self.image[:self.words]).pin_memory()
            self.buffer[:self.words].copy_(host, non_blocking=True)
