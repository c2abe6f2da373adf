"""Checkpoints — the counterpart of ``tpuddp/training/checkpoint.py``'s
single-writer save.

Rank 0 writes ``ckpt_{epoch}.npz`` (atomically: staged, fsync'd, renamed)
and then a ``ckpt_{epoch}.npz.sha256`` sidecar in the JAX package's manifest
format (``<sha256>  <name>`` and ``# size=<bytes>``); the other ranks wait at
a barrier. The npz holds the port's own layout: ``model/<state_dict key>``,
``optim/<param index>/<state key>`` and ``__meta__epoch``. Loading a JAX
checkpoint, or this one into the JAX package, is ROADMAP.md Queue 1 item 7.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch
import torch.distributed as dist

FORMAT = "tpuddp_torch/1"


def checkpoint_path(save_dir: str, epoch: int, prefix: str = "ckpt") -> str:
    return os.path.join(save_dir, f"{prefix}_{epoch}.npz")


def _digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def write_manifest(path: str) -> str:
    mpath = path + ".sha256"
    tmp = mpath + ".tmp"
    with open(tmp, "w") as f:
        f.write(f"{_digest(path)}  {os.path.basename(path)}\n")
        f.write(f"# size={os.path.getsize(path)}\n")
    os.replace(tmp, mpath)
    return mpath


def verify(path: str) -> bool:
    """True when ``path`` matches its sha256 sidecar."""
    try:
        with open(path + ".sha256") as f:
            lines = f.read().splitlines()
        size = int(lines[1][len("# size="):])
        return os.path.getsize(path) == size and _digest(path) == lines[0].split()[0]
    except (OSError, IndexError, ValueError):
        return False


def save(path: str, model: torch.nn.Module, optimizer, epoch: int) -> str:
    payload = {
        f"model/{k}": v.detach().cpu().numpy() for k, v in model.state_dict().items()
    }
    for idx, state in optimizer.state_dict()["state"].items():
        for key, value in state.items():
            arr = value.detach().cpu().numpy() if torch.is_tensor(value) else value
            payload[f"optim/{idx}/{key}"] = np.asarray(arr)
    payload["__meta__epoch"] = np.asarray(epoch, dtype=np.int64)
    payload["__format__"] = np.asarray(FORMAT)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    write_manifest(path)
    return path


def load(path: str, model: torch.nn.Module, optimizer=None) -> int:
    """Restore ``model`` (and ``optimizer``'s per-parameter state) from a
    verified checkpoint; returns its epoch."""
    if not verify(path):
        raise ValueError(f"checkpoint {path} does not match its sha256 manifest")
    with np.load(path) as data:
        if str(data["__format__"]) != FORMAT:
            raise ValueError(f"{path}: format {data['__format__']} != {FORMAT}")
        model.load_state_dict(
            {k[len("model/"):]: torch.from_numpy(data[k]) for k in data.files
             if k.startswith("model/")}
        )
        if optimizer is not None:
            state = {}
            for k in data.files:
                if k.startswith("optim/"):
                    _, idx, key = k.split("/")
                    value = data[k]
                    state.setdefault(int(idx), {})[key] = (
                        int(value) if key == "step" else torch.from_numpy(value)
                    )
            optimizer.load_state_dict(
                {"state": state, "param_groups": optimizer.state_dict()["param_groups"]}
            )
        return int(data["__meta__epoch"])


def save_on_main(save_dir: str, epoch: int, model, optimizer, rank: int):
    """Rank 0 writes; everyone waits so no reader races the writer."""
    path = None
    if rank == 0:
        os.makedirs(save_dir, exist_ok=True)
        path = save(checkpoint_path(save_dir, epoch), model, optimizer, epoch)
    if dist.is_initialized():
        dist.barrier()
    return path
