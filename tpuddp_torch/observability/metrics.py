"""Metrics sinks — the counterpart of ``tpuddp/observability/metrics.py``:
the ``history.jsonl`` writer and the gradient wire-bytes counter.

``history.jsonl`` is the machine-readable record of a run (one typed JSON
record per line, :mod:`tpuddp_torch.observability.schema`), written by
process 0 next to the checkpoints. Every value passes through
:func:`json_sanitize` and ``json.dumps(..., allow_nan=False)``, so the file
is strict JSON: a blown-up epoch's row carries its non-finite losses as
``null``, never as the bare ``NaN`` tokens strict parsers reject.
"""

from __future__ import annotations

import json
import math
import os
import threading
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def json_sanitize(value):
    """Strict-JSON form of a record: non-finite floats become ``None``,
    recursively through dicts, lists and tuples, and numpy scalars, 0-d
    arrays and 0-d tensors become Python values first."""
    if isinstance(value, dict):
        return {k: json_sanitize(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [json_sanitize(v) for v in value]
    if isinstance(value, np.generic):
        value = value.item()
    elif isinstance(value, (np.ndarray, torch.Tensor)) and value.ndim == 0:
        value = value.item()
    if isinstance(value, float) and not math.isfinite(value):
        return None
    return value


class CommBytesCounter:
    """Running gradient wire-byte counter (per replica). The payload per
    update is fixed by the bucket plan, so the count is host arithmetic;
    ``None`` bytes per update gives an inert counter whose :meth:`snapshot`
    is ``{}``, while a true 0 stays a measurement of 0."""

    def __init__(self, bytes_per_update):
        self.bytes_per_update = int(bytes_per_update) if bytes_per_update is not None else None
        self.updates = 0

    def add_updates(self, n: int) -> None:
        self.updates += int(n)

    @property
    def total_bytes(self):
        if self.bytes_per_update is None:
            return None
        return self.bytes_per_update * self.updates

    def snapshot(self, epoch_updates: Optional[int] = None) -> dict:
        """The history fields: the payload per update, the running total
        and (when given) this epoch's share."""
        if self.bytes_per_update is None:
            return {}
        out = {
            "grad_comm_bytes_per_update": self.bytes_per_update,
            "grad_comm_bytes_total": self.total_bytes,
        }
        if epoch_updates is not None:
            out["grad_comm_bytes_epoch"] = self.bytes_per_update * int(epoch_updates)
        return out


def _process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class MetricsWriter:
    """JSONL sink (``history.jsonl`` in ``save_dir``): one line-buffered
    append handle, opened at the first record, so the file always ends on a
    whole record; :meth:`close` (the loops' ``finally``) fsyncs and
    closes it. Only process 0 (global rank 0) writes, unless
    ``main_only=False`` (the watchdog's verdict: process 0 may be the dead
    one). Writes are serialised by a lock, so threads sharing a writer
    append whole lines. ``flight`` (a :class:`~tpuddp_torch.observability.
    flight.FlightRecorder`) sees every record written, before the process-0
    gate, so a process that writes no file keeps its recording too."""

    def __init__(self, save_dir: Optional[str], main_only: bool = True, flight=None):
        self.path = None
        self._f = None
        self._lock = threading.Lock()
        self.flight = flight
        if save_dir is not None and (not main_only or _process_index() == 0):
            os.makedirs(save_dir, exist_ok=True)
            self.path = os.path.join(save_dir, "history.jsonl")

    def write(self, record: dict) -> None:
        if self.flight is not None:
            self.flight.observe(record)
        if self.path is None:
            return
        line = json.dumps(json_sanitize(record), allow_nan=False) + "\n"
        with self._lock:
            if self._f is None:
                self._f = open(self.path, "a", buffering=1)
            self._f.write(line)

    def sync(self) -> None:
        """Flush and fsync what was written (the preemption drain's event
        row must outlive the SIGKILL that follows the grace window)."""
        with self._lock:
            if self._f is not None:
                self._f.flush()
                try:
                    os.fsync(self._f.fileno())
                except OSError:
                    pass  # fsync is best-effort on exotic filesystems

    def close(self) -> None:
        self.sync()
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def __del__(self):  # for a caller that never reaches close()
        try:
            self.close()
        except Exception:
            pass
