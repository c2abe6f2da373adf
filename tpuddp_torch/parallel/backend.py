"""Process-group bootstrap — the reference tutorial's ``setup``/``cleanup``
(multi-GPU-training-torch.py:29-51), which ``tpuddp/parallel/backend.py``
mirrors as a TPU -> CPU ladder.

The ladder: on ``cuda``, NCCL, else Gloo, else an error; on ``cpu``, Gloo,
else an error. ``cuda`` without a visible GPU raises: nothing carries on
quietly on the CPU.

The rendezvous is a ``TCPStore`` on ``localhost`` that the launcher opens
before any rank starts (:func:`rendezvous_store`) and keeps open until they
have all joined; the ranks connect to it as clients. The store binds port 0,
so the OS hands it a port as it binds: no port is picked, released and bound
again, which lets another socket of the machine take it in between (a port
free on ``127.0.0.1`` may still be bound on another address, and the store
listens on all of them).
"""

from __future__ import annotations

import logging
import sys
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger("tpuddp_torch")


class BackendUnavailableError(RuntimeError):
    """No usable process-group backend, or no GPU where one was asked for
    (the reference's terminal error, multi-GPU-training-torch.py:38-42)."""


def detect_backend(device: str = "cuda") -> str:
    """NCCL -> Gloo -> error for ``cuda``; Gloo -> error for ``cpu``."""
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


def setup(
    rank: int,
    world_size: int,
    device: str = "cuda",
    port: Optional[int] = None,
) -> str:
    """Initialise the process group for ``rank`` and pin the process to
    ``cuda:rank`` on the GPU. ``port`` is the launcher's
    :func:`rendezvous_store`; without it this process opens its own, which
    only a world of one can use. Returns the backend name."""
    global _excepthook
    backend = detect_backend(device)
    if device == "cuda":
        if world_size > torch.cuda.device_count():
            raise BackendUnavailableError(
                f"world_size={world_size} exceeds the {torch.cuda.device_count()} "
                "visible GPUs (one process per GPU)"
            )
        torch.cuda.set_device(rank)
    if port is None:
        if world_size != 1:
            raise ValueError(f"world_size={world_size} needs the launcher's "
                             "rendezvous port")
        store = rendezvous_store(world_size)
    else:
        store = dist.TCPStore("localhost", port, world_size, is_master=False)
    _excepthook = sys.excepthook
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world_size,
        device_id=torch.device("cuda", rank) if device == "cuda" else None,
    )
    logger.info(
        "Process group initialized with backend %s, process %d, world size %d.",
        backend, rank, world_size,
    )
    return backend


def cleanup() -> None:
    """``dist.destroy_process_group()`` when a group is up, and the
    excepthook that was before it."""
    global _excepthook
    if dist.is_initialized():
        dist.destroy_process_group()
    if _excepthook is not None:
        sys.excepthook, _excepthook = _excepthook, None


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1
