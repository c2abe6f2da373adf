"""Checkpoints — the counterpart of ``tpuddp/training/checkpoint.py``'s
single-writer save.

Rank 0 writes ``ckpt_{epoch}.npz`` (atomically: staged, fsync'd, renamed)
and then a ``ckpt_{epoch}.npz.sha256`` sidecar in the JAX package's manifest
format (``<sha256>  <name>`` and ``# size=<bytes>``); the other ranks wait at
a barrier. The npz holds the port's own layout: ``model/<state_dict key>``
(parameters and buffers, such as BatchNorm's running statistics),
``optim/<param index>/<state key>`` and ``__meta__epoch``. numpy has no
bfloat16, so a bf16 tensor (Adam moments under ``optimizer_state_dtype:
bfloat16``) is stored as its uint16 bit view under the key prefixed with
``__bf16__`` and viewed back on load, as the JAX package stores its bf16
leaves (``tpuddp/training/checkpoint.py:99-101``). Loading a JAX checkpoint,
or this one into the JAX package, is ROADMAP.md Queue 1 item 7.

The managed path writes two more files the same way: ``model.npz``
(:func:`save_model_on_main`: parameters and buffers, no epoch, the
``accelerator.save_model`` contract, ``tpuddp/accelerate.py:1559-1570``) and
``state_{epoch}.npz`` (:func:`save_on_main` with ``prefix="state"``: the
checkpoint's content plus the random generators' states under ``rng/``).
Loading either is Queue 1 item 7 too.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch
import torch.distributed as dist

FORMAT = "tpuddp_torch/1"
_BF16_MARK = "__bf16__"


def _put(payload: dict, key: str, value) -> None:
    """``payload[key]`` as numpy; a bf16 tensor as its uint16 bits under
    ``__bf16__`` + key."""
    if not torch.is_tensor(value):
        payload[key] = np.asarray(value)
    elif value.dtype == torch.bfloat16:
        payload[_BF16_MARK + key] = value.detach().cpu().view(torch.int16).numpy().view(np.uint16)
    else:
        payload[key] = value.detach().cpu().numpy()


def _tensors(data) -> dict:
    """Every stored array of an npz as a tensor by its key, bf16 ones viewed
    back from their bits."""
    out = {}
    for k in data.files:
        if k.startswith(_BF16_MARK):
            bits = torch.from_numpy(data[k].view(np.int16))
            out[k[len(_BF16_MARK):]] = bits.view(torch.bfloat16)
        elif not k.startswith("__"):
            out[k] = torch.from_numpy(data[k])
    return out


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


def save(path: str, model: torch.nn.Module, optimizer=None, epoch=None, extra=None) -> str:
    """Write ``model``'s state_dict, ``optimizer``'s per-parameter state and
    the ``extra`` arrays by their keys; ``epoch`` None stores no epoch."""
    payload = {}
    for k, v in model.state_dict().items():
        _put(payload, f"model/{k}", v)
    if optimizer is not None:
        for idx, state in optimizer.state_dict()["state"].items():
            for key, value in state.items():
                _put(payload, f"optim/{idx}/{key}", value)
    for k, v in (extra or {}).items():
        _put(payload, k, v)
    if epoch is not None:
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


def _restore_optimizer(path: str, optimizer, state: dict) -> None:
    """Put each parameter's saved state (by its index over the param
    groups) into ``optimizer``, on the parameter's device and in the saved
    dtype. ``Optimizer.load_state_dict`` would cast the moments to the
    parameter's dtype; a checkpoint whose moments are not in the optimizer's
    ``state_dtype`` is refused instead."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    want = optimizer.state_dtype
    for idx, saved in state.items():
        if idx >= len(params):
            raise ValueError(f"{path}: optimizer state for parameter {idx} of {len(params)}")
        p = params[idx]
        for key, value in saved.items():
            if not torch.is_tensor(value):
                continue
            if value.dtype != want:
                raise ValueError(
                    f"checkpoint {path}: optimizer state {idx}/{key} is {value.dtype} but "
                    f"the optimizer keeps {want} (check training.optimizer_state_dtype "
                    "matches the saved run)"
                )
            if value.shape != p.shape:
                raise ValueError(
                    f"{path}: optimizer state {idx}/{key} has shape {tuple(value.shape)}, "
                    f"parameter {idx} {tuple(p.shape)}"
                )
        optimizer.state[p] = {
            k: v.to(p.device) if torch.is_tensor(v) else v for k, v in saved.items()
        }


def load(path: str, model: torch.nn.Module, optimizer=None) -> int:
    """Restore ``model`` (and ``optimizer``'s per-parameter state) from a
    verified checkpoint; returns its epoch."""
    if not verify(path):
        raise ValueError(f"checkpoint {path} does not match its sha256 manifest")
    with np.load(path) as data:
        if str(data["__format__"]) != FORMAT:
            raise ValueError(f"{path}: format {data['__format__']} != {FORMAT}")
        epoch = int(data["__meta__epoch"])
        tensors = _tensors(data)
    model.load_state_dict(
        {k[len("model/"):]: v for k, v in tensors.items() if k.startswith("model/")}
    )
    if optimizer is not None:
        state = {}
        for k, value in tensors.items():
            if k.startswith("optim/"):
                _, idx, key = k.split("/")
                state.setdefault(int(idx), {})[key] = int(value) if key == "step" else value
        _restore_optimizer(path, optimizer, state)
    return epoch


def _on_main(rank: int, write):
    """Rank 0 runs ``write()``; everyone waits so no reader races the
    writer."""
    path = write() if rank == 0 else None
    if dist.is_initialized():
        dist.barrier()
    return path


def save_on_main(save_dir: str, epoch: int, model, optimizer, rank: int,
                 prefix: str = "ckpt", extra=None):
    """``{prefix}_{epoch}.npz`` in ``save_dir``, written by rank 0."""
    def write():
        os.makedirs(save_dir, exist_ok=True)
        return save(checkpoint_path(save_dir, epoch, prefix), model, optimizer, epoch, extra)

    return _on_main(rank, write)


def save_model_on_main(save_dir: str, model, rank: int):
    """``save_dir/model.npz`` (parameters and buffers), written by rank 0."""
    def write():
        os.makedirs(save_dir, exist_ok=True)
        return save(os.path.join(save_dir, "model.npz"), model)

    return _on_main(rank, write)
