"""Weighted cross-entropy — the counterpart of ``tpuddp/nn/loss.py``.

Padded rows of a static-shape batch carry weight 0. The ``mean`` reduction is
the weighted mean, and a batch that is all padding has loss 0, not 0/0.
Computed in float32 whatever the logits' dtype. Logits of rank over 2 (a
language model's ``(B, T, V)``) are flattened to ``(B*T, V)``, and their
labels and weights to ``(B*T,)``: each token is a sample, as
``tpuddp/nn/loss.py:33-37`` flattens them.

A criterion applied to the managed path's deferred forward (an object with
a ``_tpuddp_bind_loss`` hook, :class:`tpuddp_torch.accelerate.LazyForward`)
returns the deferred loss the hook makes (``tpuddp/nn/loss.py:66-73``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    reduction: str = "mean",
) -> torch.Tensor:
    """Softmax cross-entropy. logits: (N, C), labels: (N,) int, weights:
    (N,); or logits (..., C) with labels and weights (...), flattened first
    (``reduction='none'`` then gives the flattened per-token losses)."""
    if logits.dim() > 2:
        logits = logits.reshape(-1, logits.shape[-1])
        labels = labels.reshape(-1)
        if weights is not None:
            weights = weights.reshape(-1)
    losses = F.cross_entropy(logits.float(), labels.long(), reduction="none")
    if weights is not None:
        losses = losses * weights
    if reduction == "none":
        return losses
    if reduction == "sum":
        return losses.sum()
    if reduction == "mean":
        if weights is None:
            return losses.mean()
        denom = weights.sum()
        return losses.sum() / torch.where(denom == 0, torch.ones_like(denom), denom)
    raise ValueError(f"unknown reduction {reduction!r}")


class CrossEntropyLoss:
    """Callable criterion, ``criterion(logits, labels, weights=None)``."""

    def __init__(self, reduction: str = "mean"):
        self.reduction = reduction

    def __call__(self, logits, labels, weights=None):
        bind = getattr(logits, "_tpuddp_bind_loss", None)
        if bind is not None:
            return bind(self, labels, weights)
        return cross_entropy(logits, labels, weights, self.reduction)
