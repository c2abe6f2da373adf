"""Process launch — the counterpart of ``tpuddp/parallel/spawn.py`` and of the
reference tutorial's ``run_DDP_training`` (multi-GPU-training-torch.py:269-279).

One process per GPU through ``torch.multiprocessing.spawn(join=True)``; a
worker's exception propagates to the launcher. World size 1 runs in this
process. The launcher holds the rendezvous server
(:func:`backend.rendezvous_store`) for the spawned ranks. The spawned worker
function lives here, so a child process imports
only ``tpuddp_torch`` (and whatever module ``demo_fn`` comes from).

A :class:`~tpuddp_torch.resilience.guard.ReplicaDesync` (the numerical
guard's auditor found a divergent replica) ends the process with exit
:data:`~tpuddp_torch.resilience.guard.EXIT_DESYNC` (77), the "requeue me
into auto-resume" code (``tpuddp/parallel/spawn.py:163-168``); a spawned
rank that exits so makes the launcher exit so too.
"""

from __future__ import annotations

import logging
import sys
from typing import Callable, Optional

import torch
import torch.multiprocessing as mp

from tpuddp_torch.parallel import backend as _backend
from tpuddp_torch.resilience.guard import EXIT_DESYNC, ReplicaDesync

logger = logging.getLogger("tpuddp")


def _worker(
    rank: int,
    demo_fn: Callable,
    world_size: int,
    save_dir: str,
    optional_args: dict,
    device: str,
    port: Optional[int],
):
    _backend.setup(rank, world_size, device, port)
    try:
        return demo_fn(rank, world_size, save_dir, optional_args)
    except ReplicaDesync as e:
        logger.critical("%s; exiting %d", e, EXIT_DESYNC)
        sys.exit(EXIT_DESYNC)
    finally:
        _backend.cleanup()


def run_ddp_training(
    demo_fn: Callable,
    world_size: Optional[int],
    save_dir: Optional[str],
    optional_args: dict,
    backend: str = "cuda",
):
    """Run ``demo_fn(rank, world_size, save_dir, optional_args)`` once per
    rank. ``backend`` is the device kind, ``cuda`` or ``cpu``; the process
    group's backend follows from it (:func:`backend.detect_backend`).
    ``world_size=None`` means every visible GPU, or one process on the CPU.
    Returns ``demo_fn``'s result when the world is one process."""
    _backend.detect_backend(backend)  # no GPU -> raise before spawning
    if world_size is None:
        world_size = torch.cuda.device_count() if backend == "cuda" else 1
    if world_size == 1:
        return _worker(0, demo_fn, 1, save_dir, optional_args, backend, None)
    store = _backend.rendezvous_store(world_size)  # open until every rank joins
    args = (demo_fn, world_size, save_dir, optional_args, backend, store.port)
    try:
        mp.spawn(_worker, args=args, nprocs=world_size, join=True)
    except mp.ProcessExitedException as e:
        if e.exit_code == EXIT_DESYNC:
            sys.exit(EXIT_DESYNC)
        raise
    return None
