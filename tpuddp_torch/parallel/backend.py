"""Process-group bootstrap — the reference tutorial's ``setup``/``cleanup``
(multi-GPU-training-torch.py:29-51), which ``tpuddp/parallel/backend.py``
mirrors as a TPU -> CPU ladder.

The ladder: on ``cuda``, NCCL, else Gloo, else an error; on ``cpu``, Gloo,
else an error. ``cuda`` without a visible GPU raises: nothing carries on
quietly on the CPU. ``$TPUDDP_BACKEND`` names a preferred rung, tried first
when it is available (``tpuddp/parallel/backend.py:32-33, :67-86``): ``nccl``
or ``gloo`` on ``cuda``; ``gloo`` on ``cpu``, where the JAX package's name
of its CPU rung, ``cpu``, means the same. Any other value raises
``ValueError``. Two processes on one GPU (a two-host world on one machine)
need ``gloo``: NCCL refuses two ranks on one device.

The rendezvous is a ``TCPStore`` on ``localhost`` that the launcher opens
before any rank starts (:func:`rendezvous_store`) and keeps open until they
have all joined; the ranks connect to it as clients. The store binds port 0,
so the OS hands it a port as it binds: no port is picked, released and bound
again, which lets another socket of the machine take it in between (a port
free on ``127.0.0.1`` may still be bound on another address, and the store
listens on all of them).

Across hosts (``local.rendezvous``, :func:`setup` with
``coordinator_address``) the store is served at the coordinator's
``host:port`` by global rank 0, and every other rank connects to it as a
client; both sides go through :func:`~tpuddp_torch.resilience.retry.retry`
(:data:`RENDEZVOUS_RETRY`: 3 attempts, jittered backoff, each connection
waiting at most :data:`RENDEZVOUS_TIMEOUT_S`), as ``tpuddp/parallel/backend.py:117-131``
wraps ``jax.distributed.initialize``: hosts race to come up. The GPU is
pinned by the rank's LOCAL rank, and the one-process-per-GPU check counts
the host's own processes.
"""

from __future__ import annotations

import datetime
import logging
import os
import sys
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger("tpuddp_torch")


class BackendUnavailableError(RuntimeError):
    """No usable process-group backend, or no GPU where one was asked for
    (the reference's terminal error, multi-GPU-training-torch.py:38-42)."""


BACKEND_ENV = "TPUDDP_BACKEND"

# the JAX package's rung names that name one of the port's rungs on a device
_ALIASES = {"cpu": {"cpu": "gloo"}, "cuda": {}}

# the multi-host rendezvous: 3 attempts with jittered backoff
# (resilience/retry.py's RetryPolicy), each connection to the coordinator
# waiting at most RENDEZVOUS_TIMEOUT_S
RENDEZVOUS_RETRY = dict(max_attempts=3, base_delay=2.0, max_delay=15.0)
RENDEZVOUS_TIMEOUT_S = 60.0

# the host count of the rendezvous this process joined (None: one host)
_hosts: Optional[int] = None


def preferred_backend(device: str, ladder) -> Optional[str]:
    """``$TPUDDP_BACKEND`` as a rung of ``device``'s ``ladder`` (None when
    unset); a value that is not one of its rungs is a ``ValueError``."""
    value = os.environ.get(BACKEND_ENV, "").strip().lower()
    if not value:
        return None
    value = _ALIASES.get(device, {}).get(value, value)
    if value not in ladder:
        raise ValueError(
            f"${BACKEND_ENV}={os.environ[BACKEND_ENV]!r} is not a rung of the {device} backend "
            f"ladder {ladder}"
        )
    return value


def detect_backend(device: str = "cuda") -> str:
    """NCCL -> Gloo -> error for ``cuda``; Gloo -> error for ``cpu``;
    ``$TPUDDP_BACKEND``'s rung first when it is available."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise BackendUnavailableError(
                "local.device is cuda but no GPU is visible; set local.device: "
                "cpu to run on the CPU"
            )
        ladder = ("nccl", "gloo")
    elif device == "cpu":
        ladder = ("gloo",)
    else:
        raise ValueError(f"unknown device {device!r} (expected cuda or cpu)")
    available = {"nccl": dist.is_nccl_available(), "gloo": dist.is_gloo_available()}
    prefer = preferred_backend(device, ladder)
    if prefer is not None:
        ladder = (prefer,) + tuple(b for b in ladder if b != prefer)
    for backend in ladder:
        if available[backend]:
            return backend
    raise BackendUnavailableError(
        f"none of {ladder} is available for distributed data parallel on {device}"
    )


def rendezvous_store(world_size: int) -> dist.TCPStore:
    """The rendezvous server, on a port the OS picks as it binds
    (``.port``)."""
    return dist.TCPStore("localhost", 0, world_size, is_master=True,
                         wait_for_workers=False)


# sys.excepthook as it was before setup(): init_process_group wraps it in a
# "[rank N]: " prefixer each time, so a process that runs many groups in turn
# would print N prefixes on every line of a traceback.
_excepthook = None


def split_address(address: str):
    """``"host:port"`` as ``(host, port)``; anything else is a
    ``ValueError``."""
    host, sep, port = str(address).rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"coordinator_address must be host:port, got {address!r}")
    return host, int(port)


def coordinator_store(address: str, rank: int, world_size: int) -> dist.TCPStore:
    """The rendezvous store at the coordinator ``address``: served by
    global rank 0, joined as a client by the others, through
    :data:`RENDEZVOUS_RETRY`'s retries; exhausted, the
    :class:`~tpuddp_torch.resilience.retry.RetryError` names the address."""
    from tpuddp_torch.resilience.retry import RetryPolicy, retry

    host, port = split_address(address)
    timeout = datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S)
    return retry(
        lambda: dist.TCPStore(host, port, world_size, is_master=rank == 0, timeout=timeout,
                              wait_for_workers=False),
        RetryPolicy(**RENDEZVOUS_RETRY), describe=f"the rendezvous at coordinator {address} (rank {rank})",
    )


def num_hosts() -> Optional[int]:
    """The host count of the multi-host rendezvous this process joined;
    None on one host."""
    return _hosts


def setup(
    rank: int,
    world_size: int,
    device: str = "cuda",
    port: Optional[int] = None,
    coordinator_address: Optional[str] = None,
    local_rank: Optional[int] = None,
    local_world: Optional[int] = None,
) -> str:
    """Initialise the process group for global ``rank`` and pin the process
    to ``cuda:local_rank`` on the GPU (``local_rank`` is ``rank`` on one
    host, ``local_world`` the host's processes, ``world_size`` on one
    host). ``port`` is the launcher's :func:`rendezvous_store`;
    ``coordinator_address`` the multi-host rendezvous
    (:func:`coordinator_store`); without either this process opens its
    own store, which only a world of one can use. Returns the backend
    name."""
    global _excepthook, _hosts
    backend = detect_backend(device)
    local_rank = rank if local_rank is None else int(local_rank)
    local_world = world_size if local_world is None else int(local_world)
    if device == "cuda":
        if local_world > torch.cuda.device_count():
            raise BackendUnavailableError(
                f"{local_world} processes on this host exceed its {torch.cuda.device_count()} "
                "visible GPUs (one process per GPU)"
            )
        torch.cuda.set_device(local_rank)
    if coordinator_address is not None:
        store = coordinator_store(coordinator_address, rank, world_size)
        _hosts = world_size // local_world
    elif port is None:
        if world_size != 1:
            raise ValueError(f"world_size={world_size} needs the launcher's "
                             "rendezvous port")
        store = rendezvous_store(world_size)
    else:
        store = dist.TCPStore("localhost", port, world_size, is_master=False)
    _excepthook = sys.excepthook
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world_size,
        device_id=torch.device("cuda", local_rank) if backend == "nccl" else None,
    )
    logger.info(
        "Process group initialized with backend %s, process %d, world size %d.",
        backend, rank, world_size,
    )
    return backend


def cleanup() -> None:
    """``dist.destroy_process_group()`` when a group is up, and the
    excepthook that was before it."""
    global _excepthook, _hosts
    _hosts = None
    if dist.is_initialized():
        dist.destroy_process_group()
    if _excepthook is not None:
        sys.excepthook, _excepthook = _excepthook, None


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1
