"""Rematerialisation of the train forward (``training.remat: true``) — the
counterpart of the JAX package's ``jax.checkpoint`` over the whole
``model.apply`` (``tpuddp/training/step.py:187-195``).

:func:`forward` runs the model under ``torch.utils.checkpoint``
(non-reentrant): the forward keeps only its input, and the backward runs
the forward again to get the activations it needs. A remat step must be
bitwise the plain step, which the JAX package gets for free (its forward
is a pure function of the parameters, the state and the dropout key). In
PyTorch three things differ, and this module answers each:

- **Random draws.** Dropout draws from PyTorch's generator, so a second
  forward would draw other masks. ``preserve_rng_state`` would rewind the
  generator, but reading or setting the CUDA generator's state inside a
  CUDA-graph capture raises, and the native chunks and managed flushes are
  captured. Instead the forward records the result of every seeded random
  op (``torch.Tag.nondeterministic_seeded``: ``native_dropout`` on the
  card, ``bernoulli_`` on the CPU) and the recompute takes the recorded
  result in place of a new draw. Nothing reads the generator, so it holds
  in a capture, and the generator advances once, as in the plain step.
  What is kept is what the plain step keeps of dropout (its output and
  mask on the card; the CPU's noise tensor).
- **BatchNorm's running statistics.** The port's BatchNorm writes its
  buffers in place during the forward; :func:`recomputing` tells it that
  the forward running is the recompute, which leaves them alone, so they
  advance once a step.
- **Sample weights.** The padded rows' weights reach the BatchNorms through
  :func:`~tpuddp_torch.nn.norm.batch_weights`, which the checkpointed
  function enters itself, so the recompute sees them too.

Under SyncBN the recompute issues BatchNorm's statistics all-reduce again;
every rank recomputes in the same place of its backward, so the
collectives stay matched.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map
from torch.utils.checkpoint import checkpoint

from tpuddp_torch.nn import norm
from tpuddp_torch.nn.norm import batch_weights, recomputing


def _seeded(func) -> bool:
    return torch.Tag.nondeterministic_seeded in func.tags


class _Record(TorchDispatchMode):
    """The first forward: each seeded op's result onto ``tape`` (an
    in-place draw as a copy, since later ops overwrite its tensor)."""

    def __init__(self, tape: list):
        super().__init__()
        self.tape = tape

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _seeded(func):
            keep = (lambda t: t.clone()) if func._schema.is_mutable else (lambda t: t.detach())
            self.tape.append(tree_map(lambda t: keep(t) if isinstance(t, torch.Tensor) else t, out))
        return out


class _Replay(TorchDispatchMode):
    """The recompute: each seeded op takes its recorded result, in order;
    every other op runs."""

    def __init__(self, tape: list):
        super().__init__()
        self.tape = tape

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not _seeded(func):
            return func(*args, **(kwargs or {}))
        if not self.tape:
            raise RuntimeError(f"remat recompute drew {func} that the forward did not draw")
        recorded = self.tape.pop(0)
        if func._schema.is_mutable:
            return args[0].copy_(recorded)
        return recorded

    def __enter__(self):
        self._prev = recomputing()
        norm._local.recompute = True
        return super().__enter__()

    def __exit__(self, *exc):
        norm._local.recompute = self._prev
        return super().__exit__(*exc)


def forward(model: torch.nn.Module, x: torch.Tensor, w, remat: bool = False) -> torch.Tensor:
    """The train forward of ``model`` on ``x`` with the batch weights ``w``
    handed to its BatchNorms; under ``remat`` checkpointed as the module
    docstring says."""
    def run(inputs):
        with batch_weights(model, w):
            return model(inputs)

    if not remat:
        return run(x)
    tape: list = []
    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (_Record(tape), _Replay(tape)))
