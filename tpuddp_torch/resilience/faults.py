"""``$TPUDDP_FAULT`` fault injection — the counterpart of
``tpuddp/resilience/faults.py``, its grammar whole and its training kinds.

    TPUDDP_FAULT=<kind>@<site>[,<kind>@<site>...]

The grammar, the kinds, the sites and the ``ValueError`` of a malformed spec
are the JAX package's (:func:`parse_fault_specs`). The training kinds fire
where the JAX package's do (:func:`maybe_fire`):

- ``crash`` leaves at once with ``os._exit(EXIT_INJECTED_CRASH)`` (113),
  the unclean kill;
- ``preempt`` asks for the drain as a SIGTERM would
  (:func:`~tpuddp_torch.resilience.preemption.request_preemption`);
- ``hang`` raises the hung flag (:func:`is_hung`), which stops this
  process's heartbeat (:mod:`~tpuddp_torch.resilience.watchdog`), and sleeps
  forever: to its peers' watchdogs it is a dead host;
- ``corrupt`` tears the file just published (a header of garbage, the
  tail cut off, its manifest left stale), which the restore must detect and
  skip;
- ``nan@step=N`` poisons the host micro-batch of global train index ``N``
  from the epoch driver's entry (:func:`maybe_corrupt_batch`), so its loss
  and gradient go non-finite and the numerical guard must skip the update.

The sites: ``epoch=N`` at the start of epoch N; ``step=N`` at the global
train micro-batch N, before it is staged; ``barrier`` on entry to
:func:`tpuddp_torch.parallel.collectives.barrier`; ``ckpt_N`` (or
``ckpt_E_sS``, a step snapshot) after that file is published, by the
checkpoint writer and the snapshot writer alike. The serving kinds
(``replica_kill``, ``pool_poison``, ``dispatch_wedge``) fire through
:func:`maybe_serving_fault`, the serving engines' hook, at ``step=N`` (the
decode engine's N-th step) and ``batch=N`` (the request engine's N-th
batch); the training hooks never consume them, as in the JAX package. Each spec fires at most once per process; :func:`reload_faults`
re-reads the variable and lowers the hung flag.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import List, Optional

import numpy as np

from tpuddp_torch.resilience.preemption import EXIT_INJECTED_CRASH, request_preemption

logger = logging.getLogger("tpuddp")

_FAULT_ENV = "TPUDDP_FAULT"
SERVING_KINDS = ("replica_kill", "pool_poison", "dispatch_wedge")
_KINDS = ("crash", "preempt", "hang", "corrupt", "nan") + SERVING_KINDS

_cache = {"raw": None, "specs": None}
_hung = {"active": False}


@dataclasses.dataclass
class FaultSpec:
    kind: str
    site: str  # "epoch" | "barrier" | "ckpt" | "step" | "batch"
    arg: Optional[str]
    fired: bool = False

    def matches(self, site: str, **ctx) -> bool:
        if self.fired or site != self.site:
            return False
        if self.site == "epoch":
            return str(ctx.get("epoch")) == self.arg
        if self.site == "ckpt":
            return ctx.get("name") == self.arg
        if self.site == "step":
            return str(ctx.get("step")) == self.arg
        if self.site == "batch":
            return str(ctx.get("batch")) == self.arg
        return True


def parse_fault_specs(raw: str) -> List[FaultSpec]:
    """The specs of ``raw``, with the JAX package's ``ValueError`` for a
    malformed one."""
    specs = []
    for part in filter(None, (p.strip() for p in raw.split(","))):
        try:
            kind, point = part.split("@", 1)
        except ValueError:
            raise ValueError(
                f"bad {_FAULT_ENV} spec {part!r}: expected <kind>@<site>"
            ) from None
        if kind not in _KINDS:
            raise ValueError(f"bad {_FAULT_ENV} kind {kind!r}; one of {_KINDS}")
        if point.startswith("epoch="):
            specs.append(FaultSpec(kind, "epoch", point[len("epoch="):]))
        elif point == "barrier":
            specs.append(FaultSpec(kind, "barrier", None))
        elif point.startswith("ckpt"):
            specs.append(FaultSpec(kind, "ckpt", point))
        elif point.startswith("step="):
            specs.append(FaultSpec(kind, "step", point[len("step="):]))
        elif point.startswith("batch="):
            specs.append(FaultSpec(kind, "batch", point[len("batch="):]))
        else:
            raise ValueError(
                f"bad {_FAULT_ENV} site {point!r}; expected epoch=N, barrier, "
                "ckpt_N, step=N, or batch=N"
            )
        spec = specs[-1]
        if spec.kind == "nan" and spec.site != "step":
            raise ValueError(
                f"bad {_FAULT_ENV} spec {part!r}: kind 'nan' pairs with site step=N"
            )
        step_kinds = ("nan", "crash", "preempt") + SERVING_KINDS
        if spec.site == "step" and spec.kind not in step_kinds:
            raise ValueError(
                f"bad {_FAULT_ENV} spec {part!r}: site step=N accepts kinds {step_kinds}"
            )
        batch_kinds = ("replica_kill", "dispatch_wedge")
        if spec.site == "batch" and spec.kind not in batch_kinds:
            raise ValueError(
                f"bad {_FAULT_ENV} spec {part!r}: site batch=N accepts kinds {batch_kinds}"
            )
        if spec.kind in SERVING_KINDS and spec.site not in ("step", "batch"):
            raise ValueError(
                f"bad {_FAULT_ENV} spec {part!r}: serving kind "
                f"{spec.kind!r} pairs with the dispatch sites step=N/batch=N"
            )
    return specs


def active_faults() -> List[FaultSpec]:
    raw = os.environ.get(_FAULT_ENV, "")
    if raw != _cache["raw"]:
        _cache["raw"] = raw
        _cache["specs"] = parse_fault_specs(raw) if raw else []
    return _cache["specs"]


def reload_faults() -> None:
    _cache.update(raw=None, specs=None)
    _hung["active"] = False


def is_hung() -> bool:
    """True once a ``hang`` fault fired: the heartbeat thread stops beating,
    so peers see this process as dead."""
    return _hung["active"]


def has_nan_fault() -> bool:
    """True while an un-fired ``nan@step=N`` spec is armed."""
    return any(s.kind == "nan" and not s.fired for s in active_faults())


def has_step_fault() -> bool:
    """True while an un-fired training spec at ``step=N`` is armed
    (``nan``, ``crash`` or ``preempt``): the epoch loops wire their
    per-batch hook only then."""
    return any(s.site == "step" and not s.fired and s.kind not in SERVING_KINDS
               for s in active_faults())


def _corrupt_file(path: str) -> None:
    """Tear ``path`` as a write cut short would: garbage over its header,
    its tail gone (the JAX package's ``_corrupt_file``)."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(0)
        f.write(b"\x00CHAOS\x00" * 4)
        f.truncate(max(32, size // 2))


def maybe_fire(site: str, **ctx) -> None:
    """The injection hook of the epoch loops (``epoch``, ``step``), the
    barrier (``barrier``) and the checkpoint writers (``ckpt``, with
    ``name`` and ``path``): an un-fired spec matching ``site`` (and
    ``ctx``) fires once. ``nan`` and the serving kinds are not consumed
    here."""
    for spec in active_faults():
        if spec.kind == "nan" or spec.kind in SERVING_KINDS:
            continue
        if not spec.matches(site, **ctx):
            continue
        spec.fired = True
        logger.critical("fault injection: %s@%s fired (ctx=%s)", spec.kind, site, ctx)
        if spec.kind == "crash":
            os._exit(EXIT_INJECTED_CRASH)
        elif spec.kind == "preempt":
            request_preemption()
        elif spec.kind == "hang":
            _hung["active"] = True
            while True:  # a peer's watchdog (or the harness) must kill this process
                time.sleep(1.0)
        elif spec.kind == "corrupt":
            path = ctx.get("path")
            if path and os.path.exists(path):
                _corrupt_file(path)


def maybe_serving_fault(site: str, **ctx) -> Optional[str]:
    """The serving engines' injection hook: the serving kind that fired at
    ``site`` (``step`` or ``batch``), or None. Only serving specs are
    considered, each fires once; the engine acts on the kind."""
    for spec in active_faults():
        if spec.kind not in SERVING_KINDS or not spec.matches(site, **ctx):
            continue
        spec.fired = True
        logger.critical("fault injection: %s@%s fired (ctx=%s)", spec.kind, site, ctx)
        return spec.kind
    return None


def maybe_corrupt_batch(batch, step: int):
    """The ``nan@step=N`` injection point: the host micro-batch of global
    train index ``step`` with one NaN, in ``x`` for floating inputs, in the
    sample weight for integer (uint8) ones; fires once. Other batches pass
    as they are."""
    for spec in active_faults():
        if spec.kind == "nan" and spec.matches("step", step=step):
            spec.fired = True
            x, y, w = batch
            x = np.array(x, copy=True)
            if np.issubdtype(x.dtype, np.floating):
                x.flat[0] = np.nan
            else:
                w = np.array(w, copy=True)
                w.flat[0] = np.nan
            logger.critical(
                "fault injection: nan@step=%d fired (poisoned one train micro-batch)", step,
            )
            return x, y, w
    return batch
