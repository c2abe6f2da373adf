"""Process launch — the counterpart of ``tpuddp/parallel/spawn.py`` and of the
reference tutorial's ``run_DDP_training`` (multi-GPU-training-torch.py:269-279).

One process per GPU through ``torch.multiprocessing.spawn(join=True)``; a
worker's exception propagates to the launcher. World size 1 runs in this
process. The launcher holds the rendezvous server
(:func:`backend.rendezvous_store`) for the spawned ranks. The spawned worker
function lives here, so a child process imports
only ``tpuddp_torch`` (and whatever module ``demo_fn`` comes from).

Each rank installs the SIGTERM/SIGINT drain handler before it trains
(:mod:`~tpuddp_torch.resilience.preemption`); a
:class:`~tpuddp_torch.resilience.preemption.TrainingPreempted` (the drain
saved and stopped) ends the rank with exit 75, and a
:class:`~tpuddp_torch.resilience.guard.ReplicaDesync` (the numerical
guard's auditor found a divergent replica) with exit 77, the "requeue me
into auto-resume" codes (``tpuddp/parallel/spawn.py:149-168``); a spawned
rank that exits so, or with the watchdog's 76 or an injected crash's 113,
makes the launcher exit so too, so that the restart supervisor
(:mod:`~tpuddp_torch.resilience.supervisor`) reads the code. A scheduler's SIGTERM
reaches the launcher alone (HTCondor signals the job's process, then kills
the whole tree after the grace window), so a launcher with spawned ranks
passes each SIGTERM on to them; a SIGINT from a terminal reaches the whole
process group, so the launcher only keeps it from interrupting its wait.

Across hosts (``local.rendezvous``; ``tpuddp/parallel/spawn.py:120-171``)
each host runs this launcher with its ``process_id``: it starts ``world /
num_processes`` ranks (in this process when that is one), global rank
``process_id * local_world + local_rank``, and they meet at the
coordinator (:func:`~tpuddp_torch.parallel.backend.setup`). The
checkpoints and the epoch lines come from global rank 0 alone.
:func:`resolve_world` alone decides the host count, the default world and
whether the hosts tile it. With ``$TPUDDP_WATCHDOG_TIMEOUT`` set, each
host's local rank 0 arms the heartbeat and stale-peer watchdog
(:mod:`~tpuddp_torch.resilience.watchdog`, ``tpuddp/parallel/spawn.py:157``:
id ``process_id`` of ``num_processes`` hosts) in its own process, so a
``hang`` there stops its beat; a dead host then makes every other host
exit 76 instead of waiting forever in its next collective. One host arms
none, as in the JAX package.
"""

from __future__ import annotations

import logging
import os
import signal
import sys
import threading
import time
from multiprocessing import connection as mp_connection
from typing import Callable, Optional, Tuple

import torch
import torch.multiprocessing as mp

from tpuddp_torch.parallel import backend as _backend
from tpuddp_torch.resilience import preemption, watchdog
from tpuddp_torch.resilience.guard import EXIT_DESYNC, ReplicaDesync
from tpuddp_torch.resilience.preemption import (
    EXIT_INJECTED_CRASH, EXIT_PREEMPTED, EXIT_WATCHDOG, TrainingPreempted,
)

logger = logging.getLogger("tpuddp")

# a spawned rank's exits that the launcher passes on as its own
_CONTRACT_EXITS = (EXIT_PREEMPTED, EXIT_WATCHDOG, EXIT_DESYNC, EXIT_INJECTED_CRASH)
# how long the launcher waits for the other ranks of a drain once one exits 75
DRAIN_GRACE_S = 60.0


def resolve_world(world_size: Optional[int], backend: str,
                  coordinator_address: Optional[str] = None,
                  num_processes: Optional[int] = None,
                  process_id: Optional[int] = None) -> Tuple[int, int]:
    """``(world, hosts)`` of a launch with ``run_ddp_training``'s arguments:
    ``hosts`` is ``num_processes`` under a coordinator, else 1; ``world``
    is ``world_size``, or every visible GPU (one process on the CPU) of
    every host. A world the hosts do not tile is a ``ValueError``."""
    hosts = int(num_processes or 1) if coordinator_address else 1
    if world_size is None:
        world_size = hosts * (torch.cuda.device_count() if backend == "cuda" else 1)
    if hosts > 1:
        if world_size % hosts:
            raise ValueError(
                f"a world of {world_size} processes does not tile over local.rendezvous."
                f"num_processes={hosts} hosts; the world size (local.gpu.num_gpus or "
                "$TPUDDP_WORLD_SIZE) is the global one, hosts x processes per host"
            )
    return int(world_size), hosts


def _worker(
    rank: int,
    demo_fn: Callable,
    world_size: int,
    save_dir: str,
    optional_args: dict,
    device: str,
    port: Optional[int],
    rendezvous: Optional[tuple] = None,
    local: Optional[Tuple[int, int]] = None,
):
    """One rank: ``rank`` is the global rank on one host, the local rank
    under a ``rendezvous = (coordinator_address, process_id, local_world)``,
    where local rank 0 arms the watchdog (with ``$TPUDDP_WATCHDOG_TIMEOUT``).
    ``local = (local_rank, local_world)`` pins a rank of one host that its
    caller started itself (two ranks sharing one GPU over Gloo: ``(0, 1)``
    each)."""
    pair = None
    if rendezvous is None:
        local_rank, local_world = local or (None, None)
        _backend.setup(rank, world_size, device, port, local_rank=local_rank,
                       local_world=local_world)
    else:
        address, process_id, local_world = rendezvous
        local_rank, rank = rank, process_id * local_world + rank
        _backend.setup(rank, world_size, device, coordinator_address=address,
                       local_rank=local_rank, local_world=local_world)
        print(f"Rendezvous at {address}: global rank {rank} of a {world_size}-process world, "
              f"host {process_id} of {world_size // local_world}, local rank {local_rank} of "
              f"{local_world}.", flush=True)
        if local_rank == 0:  # this host's beat and its watch over the others
            pair = watchdog.start(save_dir, process_id, world_size // local_world)
    preemption.install_preemption_handler()  # SIGTERM/SIGINT only set the drain flag
    try:
        return demo_fn(rank, world_size, save_dir, optional_args)
    except TrainingPreempted as e:
        logger.warning("%s; exiting %d (requeue+resume)", e, EXIT_PREEMPTED)
        sys.exit(EXIT_PREEMPTED)
    except ReplicaDesync as e:
        logger.critical("%s; exiting %d", e, EXIT_DESYNC)
        sys.exit(EXIT_DESYNC)
    finally:
        watchdog.stop(pair)
        preemption.uninstall_preemption_handler()
        _backend.cleanup()


def run_ddp_training(
    demo_fn: Callable,
    world_size: Optional[int],
    save_dir: Optional[str],
    optional_args: dict,
    backend: str = "cuda",
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
):
    """Run ``demo_fn(rank, world_size, save_dir, optional_args)`` once per
    rank of this host. ``backend`` is the device kind, ``cuda`` or ``cpu``;
    the process group's backend follows from it
    (:func:`backend.detect_backend`). ``world_size=None`` means every
    visible GPU, or one process on the CPU, on every host. With a
    ``coordinator_address`` and ``num_processes`` over 1 (the hosts), this
    host is ``process_id`` and starts ``world_size / num_processes`` ranks.
    Returns ``demo_fn``'s result when this host runs one process."""
    _backend.detect_backend(backend)  # no GPU -> raise before spawning
    world_size, hosts = resolve_world(world_size, backend, coordinator_address, num_processes)
    if hosts > 1:
        return _run_host(demo_fn, world_size, save_dir, optional_args, backend,
                         coordinator_address, hosts, int(process_id))
    if world_size == 1:
        return _worker(0, demo_fn, 1, save_dir, optional_args, backend, None)
    store = _backend.rendezvous_store(world_size)  # open until every rank joins
    _spawn(world_size, (demo_fn, world_size, save_dir, optional_args, backend, store.port))
    return None


def _spawn(nprocs: int, args: tuple) -> None:
    """``nprocs`` ranks of :func:`_worker` on ``args``; a rank's drain (75),
    watchdog (76), desync (77) or injected-crash (113) exit becomes this
    process's (after a drain, once the other ranks end theirs:
    :func:`_await_drain`). While they run, a SIGTERM
    to this process is passed on to every rank, and a SIGINT (which the
    terminal sends to the ranks too) is absorbed."""
    ctx = mp.spawn(_worker, args=args, nprocs=nprocs, join=False)

    def forward(signum, frame):
        if signum == signal.SIGTERM:
            for p in ctx.processes:
                if p.is_alive():
                    os.kill(p.pid, signum)

    previous = {}
    if threading.current_thread() is threading.main_thread():
        previous = {s: signal.signal(s, forward) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        _await_drain(ctx.processes)
        while not ctx.join():
            pass
    except mp.ProcessExitedException as e:
        if e.exit_code in _CONTRACT_EXITS:
            sys.exit(e.exit_code)
        raise
    finally:
        for s, handler in previous.items():
            signal.signal(s, handler)


def _await_drain(processes, grace_s: float = DRAIN_GRACE_S) -> None:
    """Return when every rank has ended, when one has ended with another
    code than 0 or 75, or ``grace_s`` after the first 75. A drain ends every
    rank of the world by itself after its last collective (an agreed stop,
    the save), and ``ctx.join()`` would terminate the others at the first
    exit: this wait lets each finish its drain and exit 75 itself."""
    deadline = None
    while True:
        alive = [p for p in processes if p.is_alive()]
        codes = [p.exitcode for p in processes if p.exitcode is not None]
        if not alive or any(c not in (0, EXIT_PREEMPTED) for c in codes):
            return
        if EXIT_PREEMPTED in codes:
            deadline = deadline or time.monotonic() + grace_s
            if time.monotonic() >= deadline:
                return
        mp_connection.wait([p.sentinel for p in alive], timeout=1.0)


def _run_host(demo_fn, world_size: int, save_dir, optional_args: dict, device: str,
              address: str, hosts: int, process_id: int):
    """This host's share of a multi-host world: ``world_size / hosts``
    ranks, each meeting the others at the coordinator ``address``."""
    local_world = world_size // hosts
    rendezvous = (address, process_id, local_world)
    if local_world == 1:
        return _worker(0, demo_fn, world_size, save_dir, optional_args, device, None, rendezvous)
    _spawn(local_world, (demo_fn, world_size, save_dir, optional_args, device, None, rendezvous))
    return None
