"""Checkpoints in the JAX package's layout — the counterpart of
``tpuddp/training/checkpoint.py`` and of the managed ``save_model``/
``save_state``/``load_state`` (``tpuddp/accelerate.py:1559-1797``).

Each file is an ``.npz`` of arrays keyed by their paths in the JAX package's
trees, so the unchanged JAX package restores what the port writes and the
port restores what the JAX package writes:

- native ``ckpt_{epoch}.npz``, a ``TrainState``: ``.params[i]['weight']``
  (and ``'bias'``, ``'scale'``), ``.model_state[i]['mean'|'var']``,
  ``.opt_state.step`` (int32), ``.opt_state.m[...]``, ``.opt_state.v[...]``,
  ``.step`` (int32) and ``.rng`` (uint32 ``(2,)``);
- managed ``state_{epoch}.npz``: ``['params']...``, ``['model_state']...``,
  ``['opt_state']...``, ``__prngkey__['rng_key']``, ``__prngkey__['bwd_key']``
  and ``['bwd_counter']`` (int64); managed ``model.npz``: ``['params']`` and
  ``['model_state']`` alone.

Layouts are converted by :mod:`tpuddp_torch.models.convert` (HWIO/OIHW,
``(in, out)``/``(out, in)``, AlexNet's 9216-wide reorder), bitwise. bf16
leaves (Adam moments under ``optimizer_state_dtype: bfloat16``) are stored as
uint16 bits under ``__bf16__`` + key. The port keeps one Adam step per
parameter where the JAX package keeps one per tree; every parameter's must
agree. The JAX random keys are ``jax.random.PRNGKey(seed)``'s
``[seed >> 32, seed & 0xffffffff]``; the port's own random streams (each
rank's generator, the torch CPU and CUDA states) go into
``__tpuddp_torch_rng__``, one JSON record that no JAX loader reads. Files also
carry ``__meta__epoch`` and ``__meta__completed`` (``completed=0``: an
emergency save, resume redoes that epoch) and a ``__topology__`` record with
the world size; all of the port's leaves are replicated, so it tags none.

Rank 0 writes (staged, fsync'd, renamed), then a ``.sha256`` sidecar in the
JAX package's manifest format; every rank waits at a barrier.
:func:`restore_latest` takes the newest intact file (a corrupt or truncated
one is skipped for the one before). A file that needs a part of the JAX
package the port lacks (a step snapshot's ``__cursor__``, weight-update
sharded or per-replica leaves, a comm hook's ``comm_state``, the guard's
``skipped_steps``, a model axis) is refused with ``NotImplementedError``
naming its ROADMAP item, never loaded in part.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpuddp_torch.models.convert import (
    jax_from_state_dict, model_name, state_dict_from_jax, torch_layout,
)

logger = logging.getLogger("tpuddp")

FORMAT_VERSION = 4
NATIVE, MANAGED = "native", "managed"
PREFIX = {NATIVE: "ckpt", MANAGED: "state"}
RNG_KEY = "__tpuddp_torch_rng__"
AUTO_RESUME_ENV = "TPUDDP_AUTO_RESUME"
_BF16, _PRNG, _META, _TOPO, _CURSOR = (
    "__bf16__", "__prngkey__", "__meta__", "__topology__", "__cursor__",
)
_U32 = 0xFFFFFFFF


def auto_resume_requested() -> bool:
    """``$TPUDDP_AUTO_RESUME`` set to anything but empty or ``0``
    (``tpuddp/resilience/preemption.py:77-81``)."""
    return os.environ.get(AUTO_RESUME_ENV, "") not in ("", "0")


def jax_prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as its uint32 pair."""
    seed = int(seed or 0)
    return np.array([(seed >> 32) & _U32, seed & _U32], np.uint32)


def checkpoint_path(save_dir: str, epoch: int, prefix: str = "ckpt") -> str:
    return os.path.join(save_dir, f"{prefix}_{epoch}.npz")


# ---------------------------------------------------------------- integrity --

def manifest_path(path: str) -> str:
    return path + ".sha256"


def _digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def write_manifest(path: str) -> str:
    """``<path>.sha256``: ``<sha256>  <name>`` and ``# size=<bytes>``,
    published atomically."""
    mpath = manifest_path(path)
    tmp = mpath + ".tmp"
    with open(tmp, "w") as f:
        f.write(f"{_digest(path)}  {os.path.basename(path)}\n# size={os.path.getsize(path)}\n")
    os.replace(tmp, mpath)
    return mpath


def read_manifest(path: str) -> Optional[dict]:
    """``{"digest", "size"}`` of ``<path>.sha256``; None if absent or garbled."""
    try:
        with open(manifest_path(path)) as f:
            lines = f.read().splitlines()
        size = None
        for line in lines[1:]:
            if line.startswith("# size="):
                size = int(line[len("# size="):])
        return {"digest": lines[0].split()[0], "size": size}
    except (OSError, IndexError, ValueError):
        return None


def verify_file(path: str, require_manifest: bool = False) -> bool:
    """``tpuddp/resilience/integrity.py::verify_file``: True when ``path``
    matches its manifest; a file without one gets the structural check
    (non-empty, zip magic) unless ``require_manifest``."""
    if not os.path.exists(path):
        return False
    manifest = read_manifest(path)
    try:
        if manifest is None:
            if require_manifest or os.path.getsize(path) == 0:
                return False
            with open(path, "rb") as f:
                return f.read(2) == b"PK"
        if manifest["size"] is not None and os.path.getsize(path) != manifest["size"]:
            logger.warning("integrity: %s size differs from its manifest (truncated?)", path)
            return False
        if _digest(path) != manifest["digest"]:
            logger.warning("integrity: %s sha256 mismatch vs manifest", path)
            return False
    except OSError as e:
        logger.warning("integrity: cannot verify %s (%s)", path, e)
        return False
    return True


# ------------------------------------------------------------------- layout --

def _field(layout: str, name: str) -> str:
    return f".{name}" if layout == NATIVE else f"['{name}']"


def _leaves(prefix: str, tree):
    """``(key, array)`` of a per-layer tuple of dicts, keyed as
    ``jax.tree_util.keystr`` keys them."""
    for i, layer in enumerate(tree):
        for k in sorted(layer or ()):
            yield f"{prefix}[{i}]['{k}']", layer[k]


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _adam_state(model: torch.nn.Module, optimizer) -> Tuple[int, dict, dict]:
    """``(step, m, v)``: the one step count of every parameter and the
    moments by parameter name (numpy; bf16 as bits). A parameter that has
    no state yet has zero moments; mixed step counts are refused."""
    steps, m, v = set(), {}, {}
    for pname, p in model.named_parameters():
        state = optimizer.state.get(p) or {}
        steps.add(int(state.get("step", 0)))
        zeros = torch.zeros(p.shape, dtype=optimizer.state_dtype)
        m[pname] = _bits(state.get("exp_avg", zeros))
        v[pname] = _bits(state.get("exp_avg_sq", zeros))
    if len(steps) > 1:
        raise ValueError(
            f"parameters are at Adam steps {sorted(steps)}; the JAX layout keeps one step "
            "count for the whole tree"
        )
    return (steps.pop() if steps else 0), m, v


def state_payload(layout: str, model: torch.nn.Module, optimizer=None) -> Dict[str, np.ndarray]:
    """The model's (and the optimizer's) arrays by their JAX keys."""
    name = model_name(model)
    params, mstate = jax_from_state_dict(name, model.state_dict())
    payload = dict(_leaves(_field(layout, "params"), params))
    payload.update(_leaves(_field(layout, "model_state"), mstate))
    if optimizer is not None:
        step, m, v = _adam_state(model, optimizer)
        opt = _field(layout, "opt_state")
        mark = _BF16 if optimizer.state_dtype == torch.bfloat16 else ""
        payload[f"{opt}.step"] = np.asarray(step, np.int32)
        for slot, moments in (("m", m), ("v", v)):
            tree, _ = jax_from_state_dict(name, moments)
            payload.update((mark + k, a) for k, a in _leaves(f"{opt}.{slot}", tree))
    return payload


def topology_record(world_size: int) -> dict:
    """The JAX package's topology record for replicated leaves only."""
    w = int(world_size)
    return {"format": FORMAT_VERSION, "world_size": w, "model_size": 1,
            "mesh_axes": ["data"], "mesh_shape": [w], "leaves": {}, "placement": {}}


# -------------------------------------------------------------- random state --

def rng_states(generator: Optional[torch.Generator], device: torch.device) -> dict:
    """This rank's random streams as hex strings: the host generator (if
    any), torch's CPU generator and, on a GPU, the device's."""
    states = {"torch": torch.get_rng_state()}
    if generator is not None:
        states["generator"] = generator.get_state()
    if device.type == "cuda":
        states["cuda"] = torch.cuda.get_rng_state(device)
    return {k: s.numpy().tobytes().hex() for k, s in states.items()}


def _gather_rng(states: dict) -> List[dict]:
    """Every rank's :func:`rng_states`, in rank order (a collective)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        out = [None] * dist.get_world_size()
        dist.all_gather_object(out, states)
        return out
    return [states]


def restore_rng(record: List[dict], generator: Optional[torch.Generator],
                device: torch.device) -> bool:
    """Put this rank's saved streams back; False (nothing restored) when
    the file was written by another world size."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    if len(record) != world:
        return False
    as_tensor = lambda h: torch.frombuffer(bytearray.fromhex(h), dtype=torch.uint8)
    states = record[rank]
    torch.set_rng_state(as_tensor(states["torch"]))
    if generator is not None and "generator" in states:
        generator.set_state(as_tensor(states["generator"]))
    if device.type == "cuda" and "cuda" in states:
        torch.cuda.set_rng_state(as_tensor(states["cuda"]), device)
    return True


# --------------------------------------------------------------------- save --

def write(path: str, payload: dict, meta: Optional[Dict[str, int]] = None,
          topology: Optional[dict] = None) -> str:
    """Write ``payload`` (and the ``__meta__`` scalars and topology record)
    to ``path`` atomically and durably, then its manifest."""
    payload = dict(payload)
    if topology is not None:
        payload[_TOPO] = np.asarray(json.dumps(topology))
    for k, v in (meta or {}).items():
        payload[_META + k] = np.asarray(int(v), dtype=np.int64)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    write_manifest(path)
    return path


def _on_main(rank: int, write_fn):
    """Rank 0 runs ``write_fn()``; everyone waits so no reader races the
    writer."""
    path = write_fn() if rank == 0 else None
    if dist.is_initialized():
        dist.barrier()
    return path


def save_on_main(
    save_dir: str, epoch: int, model: torch.nn.Module, optimizer, rank: int, *,
    layout: str = NATIVE, seed: int = 0, generator: Optional[torch.Generator] = None,
    world_size: int = 1, completed: bool = True, keep_last: Optional[int] = None,
    counter: int = 0,
) -> Optional[str]:
    """``ckpt_{epoch}.npz`` (``layout=NATIVE``) or ``state_{epoch}.npz``
    (``MANAGED``, whose ``['bwd_counter']`` is ``counter``) in ``save_dir``,
    written by rank 0 after every rank's random streams are gathered; with
    ``keep_last`` the older files are pruned. Returns the path on rank 0."""
    device = next(model.parameters()).device
    record = _gather_rng(rng_states(generator, device))

    def write_fn():
        os.makedirs(save_dir, exist_ok=True)
        payload = state_payload(layout, model, optimizer)
        key = jax_prng_key(seed)
        if layout == NATIVE:
            payload[".step"] = payload[".opt_state.step"].copy()
            payload[".rng"] = key
        else:
            payload[f"{_PRNG}['rng_key']"] = key
            payload[f"{_PRNG}['bwd_key']"] = key.copy()
            payload["['bwd_counter']"] = np.asarray(counter, np.int64)
        payload[RNG_KEY] = np.asarray(json.dumps(record))
        path = write(
            checkpoint_path(save_dir, epoch, PREFIX[layout]), payload,
            meta={"epoch": epoch, "completed": int(completed)},
            topology=topology_record(world_size),
        )
        if keep_last is not None:
            prune_checkpoints(save_dir, keep_last, PREFIX[layout])
        return path

    return _on_main(rank, write_fn)


def save_model_on_main(save_dir: str, model: torch.nn.Module, rank: int) -> Optional[str]:
    """``save_dir/model.npz`` (``['params']`` and ``['model_state']``),
    written by rank 0."""
    def write_fn():
        os.makedirs(save_dir, exist_ok=True)
        return write(os.path.join(save_dir, "model.npz"), state_payload(MANAGED, model))

    return _on_main(rank, write_fn)


# --------------------------------------------------------------------- load --

def _refuse_unported(path: str, stored: dict) -> None:
    """``NotImplementedError`` for contents the port cannot restore whole."""
    def refuse(what, item):
        raise NotImplementedError(
            f"checkpoint {path} holds {what}, which tpuddp_torch cannot restore yet "
            f"(ROADMAP.md Queue 1 item 8: {item})"
        )

    if _CURSOR in stored:
        refuse("a step snapshot's data cursor (__cursor__)", "step snapshots")
    topo = json.loads(str(stored[_TOPO])) if _TOPO in stored else {}
    if int(topo.get("model_size") or 1) > 1:
        refuse(f"a model={topo['model_size']} mesh", "tensor parallel")
    for k in stored:
        key = k[len(_BF16):] if k.startswith(_BF16) else k
        if key.startswith((".comm_state", "['comm_state']")):
            refuse("a comm hook's error-feedback residual (comm_state)", "comm hooks")
        if key.startswith((".skipped_steps", "['skipped_steps']")):
            refuse("the numerical guard's skip counters (skipped_steps)", "numerical guard")
    kinds = {info.get("kind") for info in (topo.get("leaves") or {}).values()}
    if "data_flat" in kinds:
        refuse("weight-update-sharded flat leaves (data_flat)", "weight-update sharding (ZeRO-1)")
    if "per_replica" in kinds:
        refuse("per-replica comm residuals", "comm hooks")


def _leaf(path: str, stored: dict, key: str, like: np.ndarray, bf16: bool = False) -> np.ndarray:
    """The stored array for ``key`` (``__bf16__`` + key when ``bf16``),
    checked against the template array ``like``."""
    want = _BF16 + key if bf16 else key
    if want not in stored:
        other = key if bf16 else _BF16 + key
        if other in stored:
            raise ValueError(
                f"checkpoint {path}: leaf {key!r} is stored as "
                f"{'float32' if bf16 else 'bfloat16'} but the optimizer keeps "
                f"{'bfloat16' if bf16 else 'float32'} moments (check "
                "training.optimizer_state_dtype matches the saved run)"
            )
        raise KeyError(f"checkpoint {path} is missing leaf {key!r}")
    arr = stored[want]
    if arr.shape != like.shape:
        raise ValueError(
            f"checkpoint {path}: leaf {key!r} has shape {arr.shape} but the model expects "
            f"{like.shape}"
        )
    if arr.dtype != (np.uint16 if bf16 else like.dtype):
        raise ValueError(f"checkpoint {path}: leaf {key!r} has dtype {arr.dtype}")
    return arr


def _read_tree(path, stored, prefix, template, bf16=False):
    return tuple(
        {k: _leaf(path, stored, f"{prefix}[{i}]['{k}']", layer[k], bf16) for k in layer}
        if layer else ()
        for i, layer in enumerate(template)
    )


def read_meta(path: str) -> Dict[str, int]:
    """The ``__meta__*`` scalars of a checkpoint (empty for files without)."""
    with np.load(path) as data:
        return {k[len(_META):]: int(data[k]) for k in data.files if k.startswith(_META)}


def _restore(path: str, layout: str, model: torch.nn.Module, optimizer=None,
             generator: Optional[torch.Generator] = None) -> Dict[str, int]:
    with np.load(path) as data:
        stored = dict(data.items())
    _refuse_unported(path, stored)
    name = model_name(model)
    params_like, mstate_like = jax_from_state_dict(name, model.state_dict())
    params = _read_tree(path, stored, _field(layout, "params"), params_like)
    mstate = _read_tree(path, stored, _field(layout, "model_state"), mstate_like)
    model.load_state_dict(state_dict_from_jax(name, params, mstate))
    if optimizer is not None:
        opt = _field(layout, "opt_state")
        bf16 = optimizer.state_dtype == torch.bfloat16
        step = int(_leaf(path, stored, f"{opt}.step", np.zeros((), np.int32)))
        m = torch_layout(name, _read_tree(path, stored, f"{opt}.m", params_like, bf16))
        v = torch_layout(name, _read_tree(path, stored, f"{opt}.v", params_like, bf16))

        def tensor(arr, p):
            t = torch.from_numpy(np.ascontiguousarray(arr))
            if bf16:
                t = t.view(torch.int16).view(torch.bfloat16)
            return t.to(p.device).contiguous()

        optimizer.state.clear()
        for pname, p in model.named_parameters():
            optimizer.state[p] = {
                "step": step, "exp_avg": tensor(m[pname], p), "exp_avg_sq": tensor(v[pname], p),
            }
    if RNG_KEY in stored:
        restore_rng(json.loads(str(stored[RNG_KEY])), generator, next(model.parameters()).device)
    meta = {k[len(_META):]: int(a) for k, a in stored.items() if k.startswith(_META)}
    if layout == MANAGED and "['bwd_counter']" in stored:
        meta["bwd_counter"] = int(stored["['bwd_counter']"])
    return meta


def load(path: str, model: torch.nn.Module, optimizer=None, *, layout: str = NATIVE,
         generator: Optional[torch.Generator] = None) -> Dict[str, int]:
    """Restore ``model`` (and ``optimizer``'s moments and step, and the
    random streams) from the intact file ``path`` in ``layout``; returns its
    ``__meta__`` scalars (and a managed file's ``bwd_counter``)."""
    if not verify_file(path):
        raise ValueError(f"checkpoint {path} does not match its sha256 manifest")
    return _restore(path, layout, model, optimizer, generator)


# ---------------------------------------------------------- files of a run --

def _all_checkpoints(save_dir: str, prefix: str = "ckpt") -> List[Tuple[str, int, Optional[int]]]:
    """Every ``(path, epoch, step)``, newest first; a full-epoch file
    (``step`` None) ranks above the step snapshots of its epoch."""
    if not os.path.isdir(save_dir):
        return []
    pat = re.compile(rf"^{re.escape(prefix)}_(\d+)(?:_s(\d+))?\.npz$")
    found = []
    for fname in os.listdir(save_dir):
        m = pat.match(fname)
        if m:
            step = int(m.group(2)) if m.group(2) is not None else None
            found.append((os.path.join(save_dir, fname), int(m.group(1)), step))
    found.sort(key=lambda t: (t[1], 1 if t[2] is None else 0, t[2] or 0), reverse=True)
    return found


def latest(save_dir: str, prefix: str = "ckpt") -> Optional[Tuple[str, int]]:
    """The newest intact ``(path, epoch)``, skipping corrupt or truncated
    files with a warning; None when there is none."""
    for path, epoch, _step in _all_checkpoints(save_dir, prefix):
        if verify_file(path):
            return path, epoch
        logger.warning(
            "checkpoint %s failed integrity verification (corrupt or truncated); skipping "
            "it and falling back to the next-newest", path,
        )
    return None


def sweep_stale_tmp(save_dir: str, prefix: str = "ckpt") -> int:
    """Delete the staging files a writer killed mid-save left; returns how
    many."""
    if not os.path.isdir(save_dir):
        return 0
    pat = re.compile(rf"^{re.escape(prefix)}_\d+(_s\d+)?\.npz(\.sha256)?\.tmp$")
    removed = 0
    for fname in os.listdir(save_dir):
        if pat.match(fname):
            try:
                os.remove(os.path.join(save_dir, fname))
                removed += 1
            except FileNotFoundError:
                pass
    return removed


def prune_checkpoints(save_dir: str, keep_last: int, prefix: str = "ckpt") -> int:
    """Delete all but the ``keep_last`` newest files (and their manifests)
    and stale staging files; the newest intact full-epoch file is never
    collected. Returns how many checkpoints went."""
    if keep_last < 1:
        raise ValueError(f"keep_last must be >= 1, got {keep_last}")
    sweep_stale_tmp(save_dir, prefix)
    found = _all_checkpoints(save_dir, prefix)
    keep = {path for path, _e, _s in found[:keep_last]}
    for path, _epoch, step in found:
        if step is None and verify_file(path):
            keep.add(path)
            break
    removed = 0
    for path, _epoch, _step in found:
        if path in keep:
            continue
        for p in (path, manifest_path(path)):
            try:
                os.remove(p)
            except FileNotFoundError:
                pass
        removed += 1
        logger.info("pruned old checkpoint %s (keep_last=%d)", path, keep_last)
    return removed


def restore_latest(save_dir: str, model: torch.nn.Module, optimizer=None, *,
                   layout: str = NATIVE, generator: Optional[torch.Generator] = None
                   ) -> Tuple[int, Dict[str, int]]:
    """Restore the newest intact file of ``layout`` in ``save_dir``; returns
    ``(next_epoch, meta)``: the epoch to train next (0 when there is no
    file, the file's epoch after an emergency save, ``completed=0``, else
    the one after it) and what :func:`load` returns (empty without a
    file)."""
    prefix = PREFIX[layout]
    sweep_stale_tmp(save_dir, prefix)
    found = latest(save_dir, prefix)
    if found is None:
        return 0, {}
    path, epoch = found
    meta = _restore(path, layout, model, optimizer, generator)
    if not meta.get("completed", 1):
        logger.warning(
            "resuming from EMERGENCY checkpoint %s (preempted during epoch %d); that "
            "epoch restarts from the saved state", path, epoch,
        )
        return epoch, meta
    return epoch + 1, meta
