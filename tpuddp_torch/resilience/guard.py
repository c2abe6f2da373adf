"""The numerical guard — the counterpart of ``tpuddp/resilience/guard.py``.

Three parts, as in the JAX package:

1. **The non-finite firewall** (``training.guard``): after the gradient
   exchange, one finiteness check of the aggregated float32 gradient gives a
   verdict on the device (:class:`Firewall`); the update then applies, or is
   a bitwise no-op on the parameters, the optimizer state, the comm hook's
   error-feedback residual and the BatchNorm buffers, and the skip counters
   advance. The JAX package gates the update with ``lax.cond``; here every
   write of the update is gated on the device verdict instead (the Adam
   kernel reads it and writes nothing at 0; the other writes are selects
   that put the old values back), so nothing reads the device on the host
   and a CUDA-graph replay holds the whole step. ``enabled=False`` (the
   default) is the pre-guard code path.

2. **The desync auditor** (:func:`audit_params`): per-parameter chunked
   float32 sums (``_FP_CHUNK`` elements each), an all-reduce MAX and an
   all-reduce MIN over the default process group, compared: a parameter is
   divergent where they differ or are not finite. It runs at the DDP wrap
   and ``Accelerator.prepare`` and every ``audit_every_n_epochs`` epochs;
   a divergent replica is :class:`ReplicaDesync`, which the entry points
   turn into exit :data:`EXIT_DESYNC` (77), or a rollback with
   ``on_desync: rollback``. The first divergent parameter is named by its
   path in the JAX package's parameter tree (``[i]['weight']``), so both
   packages name the same leaf.

3. **Rollback to the last good checkpoint** lives in the epoch drivers
   (``training/loop.py``, ``train_accelerate.py``): more than
   ``max_consecutive_skips`` consecutive skipped updates restore the newest
   intact checkpoint and redo the epoch, at most ``max_rollbacks`` times.
"""

from __future__ import annotations

import dataclasses
import difflib
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from tpuddp_torch.parallel.backend import get_world_size

# the exit-code contract's divergent replica (``tpuddp/resilience/
# preemption.py:42``): requeue into auto-resume
EXIT_DESYNC = 77

_ON_DESYNC = ("exit", "rollback")


class ReplicaDesync(RuntimeError):
    """A parameter whose per-replica fingerprints disagree (or are not
    finite); the entry points exit with :data:`EXIT_DESYNC`."""

    def __init__(self, leaf: str, where: str = "audit"):
        self.leaf = leaf
        self.where = where
        super().__init__(
            f"cross-replica desync at {where}: parameter leaf {leaf!r} differs "
            "between replicas (or is non-finite on all of them); exit "
            f"{EXIT_DESYNC} requeues into auto-resume"
        )


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """The ``training.guard`` block; ``enabled=False`` (the default) is the
    pre-guard code path."""

    enabled: bool = False
    # roll back once MORE than this many consecutive updates were skipped
    max_consecutive_skips: int = 3
    # audit at the start of every Nth epoch (None: only at wrap/prepare)
    audit_every_n_epochs: Optional[int] = None
    on_desync: str = "exit"  # or "rollback"
    # after this many rollbacks the run raises instead of redoing the epoch
    max_rollbacks: int = 2


DISABLED = GuardConfig()

_GUARD_KEYS = {f.name for f in dataclasses.fields(GuardConfig)}


def resolve_guard(raw: Any) -> GuardConfig:
    """The ``training.guard`` knob: None/False -> disabled, True -> the
    defaults, a mapping -> overrides (``enabled`` defaults to True; unknown
    keys refused with a did-you-mean hint), a :class:`GuardConfig` ->
    itself."""
    if raw is None or raw is False:
        return DISABLED
    if isinstance(raw, GuardConfig):
        return raw
    if raw is True:
        return GuardConfig(enabled=True)
    if not isinstance(raw, dict):
        raise ValueError(
            f"training.guard must be a bool or a mapping, got {type(raw).__name__}"
        )
    unknown = set(raw) - _GUARD_KEYS
    if unknown:
        hints = []
        for k in sorted(unknown):
            close = difflib.get_close_matches(k, _GUARD_KEYS, n=1)
            hints.append(f"{k!r}" + (f" (did you mean {close[0]!r}?)" if close else ""))
        raise ValueError(
            f"unknown training.guard key(s): {', '.join(hints)}. Known keys: "
            f"{sorted(_GUARD_KEYS)}"
        )
    cfg = dict(raw)
    cfg.setdefault("enabled", True)  # writing the block means wanting it on
    out = GuardConfig(**cfg)
    if out.on_desync not in _ON_DESYNC:
        raise ValueError(
            f"training.guard.on_desync must be one of {_ON_DESYNC}, got "
            f"{out.on_desync!r}"
        )
    if out.max_consecutive_skips < 0:
        raise ValueError("training.guard.max_consecutive_skips must be >= 0")
    if out.audit_every_n_epochs is not None and int(out.audit_every_n_epochs) < 1:
        raise ValueError("training.guard.audit_every_n_epochs must be >= 1")
    return out


# ------------------------------------------------------- skipped counters --

def init_skip_counters(device=None) -> Dict[str, torch.Tensor]:
    """``{"total", "consecutive"}``, int32 zeros on ``device``: the skips
    since the start, and the current run of consecutive skips (reset by
    every applied update)."""
    return {k: torch.zeros((), dtype=torch.int32, device=device) for k in ("total", "consecutive")}


def advance_skip_counters_(skipped: Dict[str, torch.Tensor], verdict: torch.Tensor) -> None:
    """The counters after one update, in place on the device: where
    ``verdict`` (int32) is 1, an applied update resets ``consecutive``
    (``reset_consecutive``); where it is 0, a skip advances both
    (``bump_skip_counters``)."""
    skip = 1 - verdict
    skipped["total"].add_(skip)
    skipped["consecutive"].add_(1).mul_(skip)


def read_skip_counters(skipped: Dict[str, torch.Tensor]) -> Tuple[int, int]:
    """Host ``(total, consecutive)``. One host fetch: the epoch drivers call
    it once per epoch, never per step."""
    total, consecutive = torch.stack([skipped["total"], skipped["consecutive"]]).tolist()
    return int(total), int(consecutive)


def all_finite(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """A bool scalar on the tensors' device: True iff every element of every
    tensor is finite (``tree_all_finite``). Each tensor's smallest and
    largest element come from one reading pass (``aminmax``, which
    propagates a NaN to both), and they are finite iff every element is:
    ``isfinite(t).all()`` would write and read a mask and an absolute value
    besides."""
    extremes = [e for t in tensors if t.numel() for e in torch.aminmax(t)]
    if not extremes:
        return torch.ones((), dtype=torch.bool, device=tensors[0].device if tensors else None)
    return torch.isfinite(torch.stack(extremes)).all()


class Firewall:
    """The firewall's device state for one wrap: the verdict (an int32
    scalar: 1 apply, 0 skip), the skip counters, and the error-feedback
    residual's staging vector. Everything is allocated here, before any
    CUDA-graph capture, and written in place, so a replay holds it.

    A guarded update: the exchange writes the new residual into ``staged``
    (not into ``residual``; the hierarchical exchange writes all of it, its
    shard's loss at the shard's offset and zeros elsewhere, so nothing of an
    earlier step is left there); :meth:`judge` sets the verdict from the
    aggregated gradient (before the clip and any quantisation); the
    optimizer reads the verdict; :meth:`commit` lands the staged residual
    where the verdict is 1 and advances the counters. :meth:`keep` and
    :meth:`restore_buffers` are the selects of the other writes."""

    def __init__(self, device, residual: Optional[torch.Tensor] = None):
        self.verdict = torch.ones((), dtype=torch.int32, device=device)
        self.counters = init_skip_counters(device)
        self.residual = residual
        self.staged = None if residual is None else torch.empty_like(residual)

    def judge(self, tensors: Sequence[torch.Tensor], agree: bool = False) -> None:
        """The verdict of ``tensors`` (all finite: 1); with ``agree``, the
        MIN over the process group (a ZeRO-1 shard's verdict must be the
        world's)."""
        ok = all_finite(tensors).to(torch.int32)
        if agree and get_world_size() > 1:
            ok = ok.reshape(1)
            dist.all_reduce(ok, op=dist.ReduceOp.MIN)
        self.verdict.copy_(ok.reshape(()))

    def keep(self, new: torch.Tensor, old: torch.Tensor) -> None:
        """``old`` becomes ``new`` where the verdict is 1, in place."""
        torch.where(self.verdict.bool(), new, old, out=old)

    @staticmethod
    def save_buffers(module: torch.nn.Module):
        """Copies of ``module``'s buffers (BatchNorm running statistics)."""
        return [b.clone() for b in module.buffers()]

    def restore_buffers(self, module: torch.nn.Module, saved) -> None:
        """Each buffer back to its copy in ``saved`` where the verdict is 0."""
        for b, s in zip(module.buffers(), saved):
            torch.where(self.verdict.bool(), b, s, out=b)

    def commit(self) -> None:
        """The staged residual where the verdict is 1; the counters advance."""
        if self.residual is not None:
            self.keep(self.staged, self.residual)
        advance_skip_counters_(self.counters, self.verdict)

    def read(self) -> Tuple[int, int]:
        """Host ``(total, consecutive)`` (one fetch)."""
        return read_skip_counters(self.counters)

    @torch.no_grad()
    def load(self, total: int, consecutive: int) -> None:
        """Set the counters (a restore), in place."""
        self.counters["total"].fill_(int(total))
        self.counters["consecutive"].fill_(int(consecutive))


# --------------------------------------------------------- desync auditor --

_FP_CHUNK = 4096  # fingerprint granularity: a divergence localised to ~16 KB


def _leaf_fingerprint(t: torch.Tensor) -> torch.Tensor:
    """``t``'s elements in float32, zero-padded to whole chunks of
    ``_FP_CHUNK``, each chunk summed."""
    flat = t.detach().reshape(-1).float()
    pad = (-flat.numel()) % _FP_CHUNK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(-1, _FP_CHUNK).sum(dim=1)


def jax_leaf_names(model: torch.nn.Module):
    """``(JAX path, parameter)`` of ``model``'s parameters in the JAX
    package's tree order (its ``keystr`` paths, ``[i]['weight']``, a
    ResNet block's ``[3]['bn1']['scale']``); the port's own names and order
    for a model without a JAX layout."""
    from tpuddp_torch.models.convert import jax_places, keystr, model_name

    named = dict(model.named_parameters())
    try:
        places = jax_places(model_name(model), model)
    except ValueError:
        return list(named.items())
    order = sorted(places, key=places.get)
    return [(keystr((places[n][0],) + places[n][1]), named[n]) for n in order]


@torch.no_grad()
def audit_params(model: torch.nn.Module) -> Optional[str]:
    """Compare every replica's copy of ``model``'s parameters (a collective
    at world > 1): the JAX path of the first divergent or non-finite
    parameter, None when every fingerprint agrees and is finite. One
    all-reduce MAX and one MIN of all fingerprints, one host fetch."""
    leaves = jax_leaf_names(model)
    if not leaves:
        return None
    fps = [_leaf_fingerprint(p) for _, p in leaves]
    hi = torch.cat(fps)
    lo = hi.clone()
    if get_world_size() > 1:
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    diff = hi - lo
    bad = ((diff != 0) | ~torch.isfinite(diff)).cpu()
    offset = 0
    for (name, _), fp in zip(leaves, fps):
        if bool(bad[offset:offset + fp.numel()].any()):
            return name
        offset += fp.numel()
    return None


def audit_or_raise(model: torch.nn.Module, where: str) -> None:
    """:func:`audit_params`, raising :class:`ReplicaDesync` for the first
    divergent parameter (the wrap-time check)."""
    leaf = audit_params(model)
    if leaf is not None:
        raise ReplicaDesync(leaf, where=where)
