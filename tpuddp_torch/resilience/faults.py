"""``$TPUDDP_FAULT`` fault injection — the counterpart of
``tpuddp/resilience/faults.py``, its grammar whole and its ``nan`` kind.

    TPUDDP_FAULT=<kind>@<site>[,<kind>@<site>...]

The grammar, the kinds, the sites and the ``ValueError`` of a malformed spec
are the JAX package's (:func:`parse_fault_specs`). The port runs one kind:
``nan@step=N`` poisons the host micro-batch whose global train index from
the epoch driver's entry is ``N`` (:func:`maybe_corrupt_batch`), so its
loss and gradient go non-finite and the numerical guard's firewall must
skip the update. The other training kinds parse and then raise
``NotImplementedError`` naming their ROADMAP entry at the driver's start
(:func:`refuse_unported`): ``crash``, ``hang`` and ``corrupt`` belong to the
supervisor's chaos matrix ("elastic reshard"), ``preempt`` to the SIGTERM
drain ("async pipeline"). The serving kinds are the serving engines', which
the training hooks never consume, as in the JAX package. Each spec fires at
most once per process; :func:`reload_faults` re-reads the variable.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import List, Optional

import numpy as np

logger = logging.getLogger("tpuddp")

_FAULT_ENV = "TPUDDP_FAULT"
SERVING_KINDS = ("replica_kill", "pool_poison", "dispatch_wedge")
_KINDS = ("crash", "preempt", "hang", "corrupt", "nan") + SERVING_KINDS
# the training kinds the port does not run, by the ROADMAP entry that ports them
_UNPORTED = {
    "crash": "Queue 1 item 8: elastic reshard",
    "hang": "Queue 1 item 8: elastic reshard",
    "corrupt": "Queue 1 item 8: elastic reshard",
    "preempt": "Queue 1 item 8: async pipeline",
}

_cache = {"raw": None, "specs": None}


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


def refuse_unported() -> None:
    """``NotImplementedError`` for a training fault kind the port does not
    run (every kind but ``nan``), naming its ROADMAP entry."""
    for spec in active_faults():
        item = _UNPORTED.get(spec.kind)
        if item is not None:
            raise NotImplementedError(
                f"{_FAULT_ENV} kind {spec.kind!r} ({spec.kind}@{spec.site}) is not implemented "
                f"in tpuddp_torch yet (ROADMAP.md {item})"
            )


def has_nan_fault() -> bool:
    """True while an un-fired ``nan@step=N`` spec is armed: the epoch driver
    wires its per-batch hook only then."""
    return any(s.kind == "nan" and not s.fired for s in active_faults())


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
