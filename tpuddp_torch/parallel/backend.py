"""Process-group bootstrap — the reference tutorial's ``setup``/``cleanup``
(multi-GPU-training-torch.py:29-51), which ``tpuddp/parallel/backend.py``
mirrors as a TPU -> CPU ladder.

The ladder: on ``cuda``, NCCL, else Gloo, else an error; on ``cpu``, Gloo,
else an error. ``cuda`` without a visible GPU raises: nothing carries on
quietly on the CPU. The rendezvous is TCP on ``localhost`` at a free port that
the launcher picks (:func:`free_port`) and hands to every rank.
"""

from __future__ import annotations

import logging
import socket
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


def free_port() -> int:
    """A TCP port on localhost that is free right now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def setup(
    rank: int,
    world_size: int,
    device: str = "cuda",
    init_method: Optional[str] = None,
) -> str:
    """Initialise the process group for ``rank`` and pin the process to
    ``cuda:rank`` on the GPU. Returns the backend name."""
    backend = detect_backend(device)
    if device == "cuda":
        if world_size > torch.cuda.device_count():
            raise BackendUnavailableError(
                f"world_size={world_size} exceeds the {torch.cuda.device_count()} "
                "visible GPUs (one process per GPU)"
            )
        torch.cuda.set_device(rank)
    if init_method is None:
        init_method = f"tcp://localhost:{free_port()}"
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        device_id=torch.device("cuda", rank) if device == "cuda" else None,
    )
    logger.info(
        "Process group initialized with backend %s, process %d, world size %d.",
        backend, rank, world_size,
    )
    return backend


def cleanup() -> None:
    """``dist.destroy_process_group()`` when a group is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1
