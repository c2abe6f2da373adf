"""Checkpoints in the JAX package's layout — the counterpart of
``tpuddp/training/checkpoint.py`` and of the managed ``save_model``/
``save_state``/``load_state`` (``tpuddp/accelerate.py:1559-1797``).

Each file is an ``.npz`` of arrays keyed by their paths in the JAX package's
trees, so the unchanged JAX package restores what the port writes and the
port restores what the JAX package writes:

- native ``ckpt_{epoch}.npz``, a ``TrainState``: ``.params[i]['weight']``
  (and ``'bias'``, ``'scale'``; a ResNet block's leaves one level deeper,
  ``.params[3]['bn1']['bias']``), ``.model_state[i]['mean'|'var']``, the
  optimizer's state under ``.opt_state`` (below), ``.step`` (int32: the
  micro-batches trained, so under gradient accumulation A per update,
  padding micro-batches included) and ``__prngkey__.rng`` (uint32 ``(2,)``,
  the key data of the JAX run key ``split(fold_in(key(seed), 0))[1]``,
  :func:`tpuddp_torch.seeding.jax_run_key`);
- managed ``state_{epoch}.npz``: ``['params']...``, ``['model_state']...``,
  ``['opt_state']...``, ``__prngkey__['rng_key']``, ``__prngkey__['bwd_key']``
  and ``['bwd_counter']`` (int64); managed ``model.npz``: ``['params']`` and
  ``['model_state']`` alone. The two keys are those of the JAX
  ``Accelerator`` at the same point of the same run: the port's
  ``Accelerator`` draws from a :class:`~tpuddp_torch.seeding.JaxKeyStream`
  wherever the JAX one draws, so the stream's position is reproduced, not
  approximated.

The optimizer's state (:data:`OPT_STATE`, by optimizer class): Adam and LAMB
keep ``.opt_state.step`` (int32, the updates) and ``.opt_state.m[...]``,
``.opt_state.v[...]``; SGD and SGDW keep ``.opt_state.momentum[...]``, or
nothing with momentum 0 (the JAX ``SGDState(momentum=None)``); LARS keeps
``.opt_state.momentum[...]`` always. A file that holds another optimizer's
state is refused with a ``ValueError`` naming both.

Under ``weight_update_sharding`` (:class:`~tpuddp_torch.optim.ShardedUpdate`)
the optimizer's state is one flat vector per slot, sharded across the ranks,
which the JAX package writes as ``.opt_state.m`` (``['opt_state'].m``
managed) and so on, each the whole ``(total,)`` vector in its flat order,
tagged ``{"kind": "data_flat"}`` in the topology record when the world is
over one (``tpuddp/training/checkpoint.py:226-235``). Saving gathers every
rank's shards (a collective: every rank calls the save), permutes them into
the JAX order and writes them so. Loading re-pads a vector to the current
world as ``_refit_flat`` does (a non-zero tail is refused), permutes it into
the port's order and gives each rank its shard. As in the JAX package, a
file of per-parameter moments does not load into a ZeRO-1 run, nor a ZeRO-1
file into a run without it: the missing leaf is a ``KeyError``.

Layouts are converted by :mod:`tpuddp_torch.models.convert` (HWIO/OIHW,
``(in, out)``/``(out, in)``, AlexNet's 9216-wide reorder), bitwise. bf16
leaves (Adam moments under ``optimizer_state_dtype: bfloat16``) are stored as
uint16 bits under ``__bf16__`` + key. The port keeps one step count per
parameter where the JAX package keeps one per tree; every parameter's must
agree. The port's own random streams (each rank's generator, the torch CPU
and CUDA states) go into ``__tpuddp_torch_rng__``, one JSON record that no
JAX loader reads. Files also carry ``__meta__epoch`` and
``__meta__completed`` (``completed=0``: an emergency save, resume redoes that
epoch) and a ``__topology__`` record with the world size, which tags the
ZeRO-1 vectors and the comm hooks' residual. Files written before the key leaf
became ``__prngkey__.rng`` hold a raw ``.rng`` instead; the port reads
neither, so both load.

A comm hook with error feedback (:mod:`tpuddp_torch.parallel.comm`) saves
its residual under the JAX package's keys (``tpuddp/training/checkpoint.
py:133, :217-230, :620-660``): native ``.comm_state``, every replica's
``(total,)`` residual in the JAX flat order, concatenated in rank order
(``(world * total,)`` float32; the save gathers them, a collective), tagged
``per_replica`` when the world is over one (``data_flat`` on one, as the
JAX package's one-device sharding gives); under ZeRO-1 the port keeps it in
its own flat order and permutes it at the save and the load; under
``comm_topology: hierarchical`` it is the same per-replica vector (each
replica's shard loss at its shard's offset, zeros elsewhere), which the JAX
package's hierarchical run restores at the same world. Managed
``['comm_state']``: a tree like ``['params']``, in the JAX layout. A file
without a residual loads it as zeros (the JAX package's forward-compatible
load, with its warning); a residual in a file for a run without error
feedback is not read, as the JAX template does not read it.

The elastic restore (``tpuddp/training/checkpoint.py:429-538, :692-741``):
a native residual saved at another world size is refitted onto this one by
:func:`fit_residual` in the JAX loader's steps and order (each row re-padded
to this world's per-replica length, a non-zero tail refused, the rows
summed, spread or reset by :func:`~tpuddp_torch.parallel.comm.
redistribute_residual`), and each rank takes its row (permuted under
ZeRO-1); a world-1 file's ``data_flat`` residual is re-padded to the whole
vector, as the JAX loader re-pads it. What was refitted comes back from
:func:`restore_latest` as the JAX package's typed event rows
(:func:`build_reshard_events`: one ``topology_change``, one
``comm_state_reset`` per residual that reset); a step snapshot's cursor
restored across worlds loses its plan key, so the epoch is redone. The
managed residual is a tree of parameter-shaped leaves and crosses worlds as
it is. A file the loader cannot fit raises :class:`TopologyMismatch` (a
``ValueError``) with the JAX package's text.

The numerical guard's skip counters (``training.guard``) ride under the
JAX package's keys (``tpuddp/training/checkpoint.py:620-660``): native
``.skipped_steps['consecutive']`` and ``.skipped_steps['total']``, managed
``['skipped_steps']['consecutive']`` and ``['skipped_steps']['total']``,
int32 scalars, written by a guarded run only. A file without them loads
into a guarded run at zero counters, with the JAX package's warning; a run
without the guard does not read them. Under the guard Adam's and LAMB's
step count lives on the device (:mod:`tpuddp_torch.optim`): a save first
brings the host's per-parameter counts into line with it, a restore sets it
from the file's ``.opt_state.step``.

Rank 0 writes (staged, fsync'd, renamed), then a ``.sha256`` sidecar in the
JAX package's manifest format; every rank waits at a barrier.
:func:`restore_latest` takes the newest intact file (a corrupt or truncated
one is skipped for the one before) as process 0 finds it, on every process
(:func:`agreed_latest`): the hosts of a multi-host run resume from one file
or none, and a process that cannot open it raises on every process, so
``out_dir`` must be one filesystem that every host sees. Publishing a checkpoint is a
``$TPUDDP_FAULT`` site (``corrupt@ckpt_N``, in :func:`write_captured`, the
snapshot writer's writer too).

Step snapshots (format v4, ``tpuddp/training/checkpoint.py:91-115,
:751-782, :862-938, :1008-1095``): ``{prefix}_{epoch}_s{step}.npz``, the
state after ``step`` real micro-batches of ``epoch`` (``__meta__step``,
``completed=0``), with a ``__cursor__`` JSON record (version, epoch, step,
the epoch's plan key) and the partial sums under ``__cursor_acc__['name']``
(:func:`write`, :func:`read_cursor`). :func:`restore_latest` takes the
freshest intact file across the local files, the peer copies under
``<heartbeat_dir>/peer_ckpt/ring_<i>`` (:func:`peer_checkpoint_dirs`) and
the epoch family (an epoch's full file outranks its step snapshots), logs
where it came from, and hands a step snapshot's cursor to the caller, which
continues that epoch at that step. Each save is a :func:`capture` of the
live state, turned into arrays and written by :func:`write_captured`: the
snapshot engine (``training/snapshot.py``) copies the capture's tensors on
the device and writes from its own thread through the same function, and
:func:`_savez` fixes every zip entry's time, so the same state gives the
same bytes either way. Files of both packages cross both ways.

Model-sharded files (``parallel.model > 1``, format v3/v4;
``tpuddp/training/checkpoint.py:196-300, :540-600``): the save gathers
every split parameter and moment over the model group and rank 0 writes
the whole arrays in the JAX TP layout (``wqkv (E, 3, HD)``, ``bqkv (3,
HD)``; a ``model == 1`` file keeps ``(E, 3HD)``); the residual is one
``per_replica`` row a rank, in rank order (``(data_index, model_index)``,
model minor), tagged with the model width; the topology record holds
``model_size``, ``mesh_axes`` ``["data", "model"]``, ``mesh_shape`` and the
``placement`` of every split leaf by its JAX path. The restore cuts each
rank's shard out of the whole arrays. A file of another model width is the
JAX package's :class:`TopologyMismatch` (``_check_model_width``), and so is
a model > 1 residual at another data width; with ``reshard_on_mismatch``
the payload is first reshaped onto this ``(data, model)`` shape by
:func:`tpuddp_torch.training.reshard.reshard_arrays` (a model-width change
drops the residual, which restarts at zero), as the JAX loader does. A
``model == 1`` restore at another world keeps the data-axis refit above.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import re
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpuddp_torch import optim
from tpuddp_torch.models.convert import (
    flat_from_jax, flat_to_jax, jax_from_state_dict, keystr, model_name, state_dict_from_jax,
    torch_layout, tree_leaves, tree_map,
)
from tpuddp_torch.parallel.backend import get_rank, get_world_size
from tpuddp_torch.parallel import collectives
from tpuddp_torch.parallel.comm import redistribute_residual
from tpuddp_torch.resilience import faults
from tpuddp_torch.training import reshard
# the heartbeat directory is the watchdog's (peer spills live under it too)
from tpuddp_torch.resilience.watchdog import heartbeat_dir
# re-exported: the parser moved to the drain's module
from tpuddp_torch.resilience.preemption import (  # noqa: F401
    AUTO_RESUME_ENV, auto_resume_requested,
)
from tpuddp_torch.seeding import jax_run_key

logger = logging.getLogger("tpuddp")

FORMAT_VERSION = 4
NATIVE, MANAGED = "native", "managed"
PREFIX = {NATIVE: "ckpt", MANAGED: "state"}
RNG_KEY = "__tpuddp_torch_rng__"
_BF16, _PRNG, _META, _TOPO, _CURSOR, _CURSOR_ACC = (
    "__bf16__", "__prngkey__", "__meta__", "__topology__", "__cursor__", "__cursor_acc__",
)
_COMM = ".comm_state"  # the native residual's key
_SKIP_KEYS = ("consecutive", "total")  # the guard's counters, in the JAX key order


class TopologyMismatch(ValueError):
    """A checkpoint's world-size-dependent state cannot be fitted onto the
    current topology (``tpuddp/training/checkpoint.py:119-123``): a file
    without a topology record, a tail that is not padding, or a
    redistribution without the world size it needs."""


def checkpoint_path(save_dir: str, epoch: int, prefix: str = "ckpt") -> str:
    return os.path.join(save_dir, f"{prefix}_{epoch}.npz")


def step_checkpoint_path(save_dir: str, epoch: int, step: int, prefix: str = "ckpt") -> str:
    """``{prefix}_{epoch}_s{step}.npz``: a step snapshot, ``step`` real
    micro-batches of ``epoch`` applied."""
    return os.path.join(save_dir, f"{prefix}_{epoch}_s{step}.npz")


def peer_checkpoint_dirs(save_dir: str) -> List[str]:
    """Every ``ring_*`` directory under ``<heartbeat_dir>/peer_ckpt``, where
    the snapshot engine spills its ring neighbour's copies; empty when there
    is none."""
    hb = heartbeat_dir(save_dir)
    root = os.path.join(hb, "peer_ckpt") if hb else None
    if root is None or not os.path.isdir(root):
        return []
    return sorted(os.path.join(root, d) for d in os.listdir(root)
                  if d.startswith("ring_") and os.path.isdir(os.path.join(root, d)))


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
    """``(key, array)`` of a per-layer tuple of (nested) dicts, keyed as
    ``jax.tree_util.keystr`` keys them: ``[0]['weight']``, a ResNet
    block's ``[3]['bn1']['bias']``."""
    for path, leaf in tree_leaves(tree):
        yield prefix + keystr(path), leaf


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


# optimizer class -> (JAX slot -> the optimizer's per-parameter state key,
# whether the JAX state keeps a step count)
_ADAM_SLOTS = ({"m": "exp_avg", "v": "exp_avg_sq"}, True)
_MOMENTUM_SLOTS = ({"momentum": "momentum_buffer"}, False)
OPT_STATE = {
    optim.Adam: _ADAM_SLOTS, optim.LAMB: _ADAM_SLOTS,
    optim.SGD: _MOMENTUM_SLOTS, optim.SGDW: _MOMENTUM_SLOTS, optim.LARS: _MOMENTUM_SLOTS,
}
# what a file's opt_state holds, by the slots it has
_KINDS = {("m", "v"): "Adam or LAMB (step, m, v)", ("momentum",): "SGD, SGDW or LARS (momentum)",
          (): "no optimizer state (SGD or SGDW with momentum 0)"}


def _inner(optimizer):
    """The optimizer whose class keys the state: a ZeRO-1 wrap's own."""
    return optimizer.inner if isinstance(optimizer, optim.ShardedUpdate) else optimizer


def _opt_slots(optimizer) -> Tuple[Dict[str, str], bool]:
    """``optimizer``'s entry of :data:`OPT_STATE`; SGD and SGDW at momentum
    0 keep no state."""
    optimizer = _inner(optimizer)
    try:
        slots, counted = OPT_STATE[type(optimizer)]
    except KeyError:
        raise TypeError(
            f"no checkpoint layout for optimizer {type(optimizer).__name__}; one of "
            f"{sorted(c.__name__ for c in OPT_STATE)}"
        ) from None
    if isinstance(optimizer, (optim.SGD, optim.SGDW)) and optimizer.defaults["momentum"] == 0.0:
        slots = {}
    return slots, counted


def _state_dtype(optimizer) -> torch.dtype:
    return getattr(_inner(optimizer), "state_dtype", torch.float32)


def gather_flat_state(optimizer) -> Dict[str, Any]:
    """A ZeRO-1 optimizer's state, every rank's shards gathered (a
    collective): ``{"step": int, slot: (total,) tensor on the device}``,
    each slot in the moments' dtype, zeros before the first step."""
    slots, counted = _opt_slots(optimizer)
    dtype = _state_dtype(optimizer)
    shard = optimizer.shard
    out = {}
    if counted:
        state = optimizer.state.get(shard) or {}
        out["step"] = int(state.get("step", 0))
    for slot, key in slots.items():
        local = optimizer.shard_state(key)
        # bf16 travels as float32 (exact both ways), which every backend gathers
        local = torch.zeros(shard.shape, device=shard.device) if local is None else local.float()
        full = torch.empty(optimizer.spec.total, device=shard.device)
        collectives.all_gather_shards(full, local.contiguous())
        out[slot] = full.to(dtype)
    return out


def _flat_opt_payload(layout: str, name: str, model: torch.nn.Module, optimizer,
                      flat_state: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The gathered ZeRO-1 state by its JAX keys, each vector in the JAX
    flat order, padded to the world's length (numpy; bf16 as bits)."""
    slots, counted = _opt_slots(optimizer)
    spec = optimizer.spec
    opt = _field(layout, "opt_state")
    payload = {}
    if counted:
        payload[f"{opt}.step"] = np.asarray(flat_state["step"], np.int32)
    mark = _BF16 if _state_dtype(optimizer) == torch.bfloat16 else ""
    for slot in slots:
        port = _bits(flat_state[slot])
        vec = np.zeros(spec.total, port.dtype)
        vec[:spec.raw] = flat_to_jax(name, model, port[:spec.raw])
        payload[f"{mark}{opt}.{slot}"] = vec
    return payload


def _opt_payload(layout: str, name: str, model: torch.nn.Module, optimizer, tensors,
                 steps) -> Dict[str, np.ndarray]:
    """The optimizer's state by its JAX keys (numpy; bf16 as bits), from the
    captured ``tensors`` (``opt/<parameter>/<key>``) and step counts
    ``steps``. A parameter without state yet has zeros; mixed step counts
    are refused."""
    slots, counted = _opt_slots(optimizer)
    dtype = _state_dtype(optimizer)
    by_slot = {slot: {} for slot in slots}
    for pname, p in model.named_parameters():
        for slot, key in slots.items():
            t = tensors.get(f"opt/{pname}/{key}")
            by_slot[slot][pname] = _bits(torch.zeros(p.shape, dtype=dtype) if t is None else t)
    opt = _field(layout, "opt_state")
    payload = {}
    if counted:
        if len(steps) > 1:
            raise ValueError(
                f"parameters are at steps {sorted(steps)}; the JAX layout keeps one step "
                "count for the whole tree"
            )
        payload[f"{opt}.step"] = np.asarray(min(steps) if steps else 0, np.int32)
    mark = _BF16 if dtype == torch.bfloat16 else ""
    for slot, arrays in by_slot.items():
        tree, _ = jax_from_state_dict(name, arrays)
        payload.update((mark + k, a) for k, a in _leaves(f"{opt}.{slot}", tree))
    return payload


def model_payload(layout: str, model: torch.nn.Module, state_dict=None) -> Dict[str, np.ndarray]:
    """The model's parameters and buffers by their JAX keys, from
    ``state_dict`` (the model's own when None)."""
    params, mstate = jax_from_state_dict(
        model_name(model), model.state_dict() if state_dict is None else state_dict)
    payload = dict(_leaves(_field(layout, "params"), params))
    payload.update(_leaves(_field(layout, "model_state"), mstate))
    return payload


def topology_record(world_size: int, flat_keys=(), residual_per: Optional[int] = None,
                    residual_flat: bool = False) -> dict:
    """The JAX package's topology record: replicated leaves carry no tag;
    the ZeRO-1 vectors ``flat_keys`` are ``data_flat``, sharded over the
    data axis, when the world is over one (on one device the JAX package's
    sharding is a replicated one, and it tags nothing). A native residual
    of ``residual_per`` elements per replica is ``per_replica`` over the
    data axis when the world is over one, else ``data_flat``; the one
    replicated residual of ``mode: auto`` (``residual_flat``) is
    ``data_flat`` at every world."""
    w = int(world_size)
    flat_keys = tuple(flat_keys) if w > 1 else ()
    leaves = {k: {"kind": "data_flat"} for k in flat_keys}
    placement = {k: ["data"] for k in flat_keys}
    if residual_flat:
        leaves[_COMM] = {"kind": "data_flat"}
    elif residual_per is not None:
        leaves[_COMM] = ({"kind": "per_replica", "world": w, "per": int(residual_per), "model": 1}
                         if w > 1 else {"kind": "data_flat"})
        if w > 1:
            placement[_COMM] = ["data"]
    return {"format": FORMAT_VERSION, "world_size": w, "model_size": 1,
            "mesh_axes": ["data"], "mesh_shape": [w], "leaves": leaves, "placement": placement}


def gather_residual(residual: torch.Tensor) -> torch.Tensor:
    """Every replica's native residual (``(total,)`` each), concatenated in
    rank order on the device (a collective): ``(world * total,)``."""
    full = torch.empty(get_world_size() * residual.numel(), dtype=torch.float32,
                       device=residual.device)
    collectives.all_gather_shards(full, residual.contiguous())
    return full


def _residual_payload(model: torch.nn.Module, optimizer, full, per: int) -> np.ndarray:
    """The gathered native residual (rows of ``per``, one a replica) in the
    JAX flat order: each row permuted from the port's order under ZeRO-1."""
    out = _bits(full).copy()
    if isinstance(optimizer, optim.ShardedUpdate):
        raw = optimizer.spec.raw
        for row in out.reshape(-1, per):
            row[:raw] = flat_to_jax(model_name(model), model, row[:raw].copy())
    return out


def _skip_key(layout: str, name: str) -> str:
    return f"{_field(layout, 'skipped_steps')}['{name}']"


def _skip_payload(layout: str, skipped) -> Dict[str, np.ndarray]:
    """The guard's counters (int32 scalars) by their JAX keys."""
    values = torch.stack([skipped[k].cpu() for k in _SKIP_KEYS]).tolist()
    return {_skip_key(layout, k): np.asarray(v, np.int32) for k, v in zip(_SKIP_KEYS, values)}


@torch.no_grad()
def _restore_skipped(path: str, stored: dict, layout: str, skipped) -> None:
    """The file's skip counters into ``skipped`` (in place); zeros, with
    the JAX package's warning, for a file written before the guard."""
    for k in _SKIP_KEYS:
        key = _skip_key(layout, k)
        if key in stored:
            skipped[k].fill_(int(_leaf(path, stored, key, np.zeros((), np.int32))))
        else:
            logger.warning(
                "checkpoint %s predates guard state: leaf %r starts at its zero initialization",
                path, key,
            )
            skipped[k].zero_()


def _managed_residual_payload(model: torch.nn.Module, residual) -> Dict[str, np.ndarray]:
    """The managed residual (one tensor per parameter, in the parameters'
    order) as the JAX tree ``['comm_state']``."""
    arrays = {pname: _bits(r) for (pname, _), r in zip(model.named_parameters(), residual)}
    tree, _ = jax_from_state_dict(model_name(model), arrays)
    return dict(_leaves(_field(MANAGED, "comm_state"), tree))


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

_ZIP_TIME = (1980, 1, 1, 0, 0, 0)


def _savez(f, payload: dict) -> None:
    """``np.savez``'s layout (one stored ``<key>.npy`` entry per array, in
    order) with every entry's zip time fixed, so one payload gives one
    sequence of bytes whenever it is written: an async snapshot and a
    synchronous save of the same step are byte-identical."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED, allowZip64=True) as z:
        for key, val in payload.items():
            info = zipfile.ZipInfo(key + ".npy", date_time=_ZIP_TIME)
            with z.open(info, "w", force_zip64=True) as fid:
                np.lib.format.write_array(fid, np.asanyarray(val), allow_pickle=False)


def write(path: str, payload: dict, meta: Optional[Dict[str, int]] = None,
          topology: Optional[dict] = None, cursor: Optional[dict] = None,
          cursor_acc: Optional[Dict[str, Any]] = None) -> str:
    """Write ``payload`` (and the ``__meta__`` scalars, the topology record
    and a step snapshot's v4 ``__cursor__`` record with its partial
    accumulator ``cursor_acc``, ``{name: array}``, stored as
    ``__cursor_acc__['name']``) to ``path`` atomically and durably, then its
    manifest (``tpuddp/training/checkpoint.py:298-361``)."""
    payload = dict(payload)
    if topology is not None:
        payload[_TOPO] = np.asarray(json.dumps(topology))
    if cursor is not None:
        acc = {f"{_CURSOR_ACC}['{k}']": np.asarray(v) for k, v in (cursor_acc or {}).items()}
        record = dict(cursor, acc_keys=sorted(acc))
        payload[_CURSOR] = np.asarray(json.dumps(record, sort_keys=True))
        for k in sorted(acc):
            payload[k] = acc[k]
    for k, v in (meta or {}).items():
        payload[_META + k] = np.asarray(int(v), dtype=np.int64)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        _savez(f, payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    write_manifest(path)
    return path


def read_cursor(path: str) -> Optional[dict]:
    """The v4 data cursor of a step snapshot with its partial accumulator
    under ``"acc"`` (``{"['name']": array}``, the JAX keys); None for a file
    without one (``tpuddp/training/checkpoint.py:364-384``)."""
    with np.load(path) as data:
        if _CURSOR not in data.files:
            return None
        record = json.loads(str(np.asarray(data[_CURSOR]).item()))
        acc = {k[len(_CURSOR_ACC):]: np.asarray(data[k])
               for k in record.pop("acc_keys", []) if k in data.files}
        record["acc"] = acc or None
        return record


def _on_main(rank: int, write_fn):
    """Rank 0 runs ``write_fn()``; everyone waits so no reader races the
    writer (a ``$TPUDDP_FAULT`` barrier site, as the JAX save's)."""
    path = write_fn() if rank == 0 else None
    collectives.barrier()
    return path


@dataclasses.dataclass
class Captured:
    """What one save of a run writes, taken at one point of it: ``tensors``
    by capture key (``sd/<key>`` the model's state_dict, ``opt/<parameter>/
    <slot>`` or ``flat/<slot>`` the optimizer's state, ``opt_count`` the
    guard's device step count, ``residual`` or ``residual/<i>`` the comm
    hook's, ``skip/<counter>`` the guard's), on the device or the host, and
    the host values beside them. ``model`` and ``optimizer`` give the
    layout (names, shapes, the JAX flat order, the optimizer's class); their
    values are never read."""

    layout: str
    model: torch.nn.Module
    optimizer: Any
    tensors: Dict[str, torch.Tensor]
    host: Dict[str, Any]


def _capture_opt(layout: str, model: torch.nn.Module, optimizer, tensors: dict, host: dict) -> None:
    """The optimizer's part of :func:`capture`, into ``tensors`` and
    ``host`` (a ZeRO-1 wrap's shards gathered: a collective)."""
    counted = optim._counted(optimizer)
    if counted is not None and counted.verdict is not None and counted._count is not None:
        tensors["opt_count"] = counted._count  # under the guard the host's steps are stale
    if isinstance(optimizer, optim.ShardedUpdate):  # every rank gathers
        flat = gather_flat_state(optimizer)
        host["steps"] = {flat.pop("step")} if "step" in flat else set()
        tensors.update((f"flat/{slot}", t) for slot, t in flat.items())
        opt = _field(layout, "opt_state")
        host["flat_keys"] = [f"{opt}.{slot}" for slot in _opt_slots(optimizer)[0]]
        return
    slots, _ = _opt_slots(optimizer)
    for pname, p in model.named_parameters():
        state = optimizer.state.get(p) or {}
        host["steps"].add(int(state.get("step", 0)))
        for key in slots.values():
            if key in state:
                tensors[f"opt/{pname}/{key}"] = state[key]


def _captured_opt_payload(layout: str, model: torch.nn.Module, optimizer, t: dict,
                          host: dict) -> Dict[str, np.ndarray]:
    """The optimizer's arrays by their JAX keys, from what
    :func:`_capture_opt` took."""
    name = model_name(model)
    steps = {int(t["opt_count"])} if "opt_count" in t else host["steps"]
    if isinstance(optimizer, optim.ShardedUpdate):
        flat = {k[5:]: v for k, v in t.items() if k.startswith("flat/")}
        flat["step"] = min(steps) if steps else 0
        return _flat_opt_payload(layout, name, model, optimizer, flat)
    return _opt_payload(layout, name, model, optimizer, t, steps)


def state_payload(layout: str, model: torch.nn.Module, optimizer=None) -> Dict[str, np.ndarray]:
    """The model's (and the optimizer's) arrays by their JAX keys, read now."""
    payload = model_payload(layout, model)
    if optimizer is not None:
        tensors, host = {}, {"steps": set(), "flat_keys": ()}
        _capture_opt(layout, model, optimizer, tensors, host)
        payload.update(_captured_opt_payload(layout, model, optimizer, tensors, host))
    return payload


def capture(model: torch.nn.Module, optimizer, *, layout: str = NATIVE, seed: int = 0,
            generator: Optional[torch.Generator] = None, world_size: int = 1, step: int = 0,
            counter: int = 0, keys: Optional[Tuple[np.ndarray, np.ndarray]] = None,
            comm_state=None, skipped=None, residual_replicated: bool = False) -> Captured:
    """Everything a save of ``model`` writes, as references to the live
    tensors, read nothing on the host (the snapshot engine copies them
    before the next step). A collective at world > 1: every rank's random
    streams, ZeRO-1 shards and native residual are gathered (the one
    residual of ``mode: auto``, ``residual_replicated``, is every rank's
    already). Arguments as :func:`save_on_main`."""
    if layout == MANAGED and keys is None:
        raise ValueError("a managed state file needs the accelerator's keys (rng_key, bwd_key)")
    device = next(model.parameters()).device
    tensors = {f"sd/{k}": v.detach() for k, v in model.state_dict().items()}
    host = {"rng": _gather_rng(rng_states(generator, device)), "world_size": world_size,
            "flat_keys": (), "residual_per": None, "residual_flat": False, "step": step,
            "seed": seed, "counter": counter, "keys": keys, "steps": set()}
    if optimizer is not None:
        _capture_opt(layout, model, optimizer, tensors, host)
    if comm_state is not None and layout == NATIVE and residual_replicated:
        tensors["residual"] = comm_state.detach()
        host["residual_per"], host["residual_flat"] = comm_state.numel(), True
    elif comm_state is not None and layout == NATIVE:  # every rank gathers
        tensors["residual"] = gather_residual(comm_state)
        host["residual_per"] = comm_state.numel()
    elif comm_state is not None:
        tensors.update((f"residual/{i}", r) for i, r in enumerate(comm_state))
    if skipped is not None:
        tensors.update((f"skip/{k}", skipped[k]) for k in _SKIP_KEYS)
    shard = _shard(model)
    if shard is not None:  # every rank of a model group gathers its split leaves
        _gather_whole(tensors, shard)
        host["tp"] = shard.mesh.shape
        model = shard.whole_meta()
    return Captured(layout, model, optimizer, tensors, host)


def _shard(model: torch.nn.Module):
    """``model`` when it is a tensor-parallel shard, whose hooks
    (``gather_whole``, ``whole_meta``, ``cut``: ``parallel/tensor.py``'s
    ``TensorParallelLM``) save it as the whole model and restore its own
    part; else None."""
    return model if hasattr(model, "gather_whole") else None


def _gather_whole(tensors: dict, shard) -> None:
    """The captured state_dict and moments of a shard replaced by the whole
    tensors, in place (a collective of the model group, in one order on
    every rank)."""
    sd = {k[3:]: v for k, v in tensors.items() if k.startswith("sd/")}
    tensors.update((f"sd/{k}", v) for k, v in shard.gather_whole(sd).items())
    slots = sorted({k.rsplit("/", 1)[1] for k in tensors if k.startswith("opt/")})
    for slot in slots:
        named = {k[4:-len(slot) - 1]: v for k, v in tensors.items()
                 if k.startswith("opt/") and k.endswith("/" + slot)}
        tensors.update((f"opt/{n}/{slot}", v) for n, v in shard.gather_whole(named).items())


def captured_payload(cap: Captured) -> Dict[str, np.ndarray]:
    """The file's arrays by their JAX keys, from ``cap`` (a host read of
    each tensor still on the device)."""
    layout, model, optimizer, t, host = cap.layout, cap.model, cap.optimizer, cap.tensors, cap.host
    payload = model_payload(layout, model, {k[3:]: v for k, v in t.items() if k.startswith("sd/")})
    if optimizer is not None:
        payload.update(_captured_opt_payload(layout, model, optimizer, t, host))
    if "residual" in t:
        payload[_COMM] = _residual_payload(model, optimizer, t["residual"], host["residual_per"])
    elif "residual/0" in t:
        n = sum(1 for k in t if k.startswith("residual/"))
        payload.update(_managed_residual_payload(model, [t[f"residual/{i}"] for i in range(n)]))
    if "skip/total" in t:
        payload.update(_skip_payload(layout, {k: t[f"skip/{k}"] for k in _SKIP_KEYS}))
    if layout == NATIVE:
        payload[".step"] = np.asarray(host["step"], np.int32)
        payload[f"{_PRNG}.rng"] = jax_run_key(host["seed"] or 0)
    else:
        payload[f"{_PRNG}['rng_key']"], payload[f"{_PRNG}['bwd_key']"] = host["keys"]
        payload["['bwd_counter']"] = np.asarray(host["counter"], np.int64)
    payload[RNG_KEY] = np.asarray(json.dumps(host["rng"]))
    return reshard.qkv_layout(payload, True) if "tp" in host else payload


def write_captured(save_dir: str, epoch: int, cap: Captured, *, completed: bool = True,
                   snapshot_step: Optional[int] = None, cursor: Optional[dict] = None,
                   cursor_acc: Optional[Dict[str, Any]] = None,
                   keep_last: Optional[int] = None) -> str:
    """Write ``cap`` as ``{prefix}_{epoch}.npz``, or with ``snapshot_step``
    as the step snapshot ``{prefix}_{epoch}_s{step}.npz`` (always
    ``completed=0``, its meta carrying the step; ``cursor`` and
    ``cursor_acc`` as :func:`write`); with ``keep_last`` the older files
    are pruned. The one writer of the synchronous save and of the snapshot
    engine's thread, so both give the same bytes."""
    os.makedirs(save_dir, exist_ok=True)
    prefix = PREFIX[cap.layout]
    if snapshot_step is None:
        target = checkpoint_path(save_dir, epoch, prefix)
        meta = {"epoch": epoch, "completed": int(completed)}
    else:
        target = step_checkpoint_path(save_dir, epoch, snapshot_step, prefix)
        meta = {"epoch": epoch, "completed": 0, "step": int(snapshot_step)}
    payload = captured_payload(cap)
    if "tp" in cap.host:
        topology = reshard.tp_topology(cap.host["world_size"], cap.host["tp"][1], payload,
                                       cap.host["residual_per"])
    else:
        topology = topology_record(cap.host["world_size"], cap.host["flat_keys"],
                                   cap.host["residual_per"], cap.host.get("residual_flat", False))
    path = write(target, payload, meta=meta, topology=topology, cursor=cursor,
                 cursor_acc=cursor_acc)
    # $TPUDDP_FAULT corrupt@ckpt_N tears the file just published (its manifest
    # then stale), which the restore must detect and skip
    faults.maybe_fire("ckpt", name=os.path.basename(target)[:-len(".npz")], path=path)
    if keep_last is not None:
        prune_checkpoints(save_dir, keep_last, prefix)
    return path


def save_on_main(
    save_dir: str, epoch: int, model: torch.nn.Module, optimizer, rank: int, *,
    layout: str = NATIVE, seed: int = 0, generator: Optional[torch.Generator] = None,
    world_size: int = 1, completed: bool = True, keep_last: Optional[int] = None,
    step: int = 0, counter: int = 0, keys: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    comm_state=None, skipped=None, snapshot_step: Optional[int] = None,
    cursor: Optional[dict] = None, cursor_acc: Optional[Dict[str, Any]] = None,
    residual_replicated: bool = False,
) -> Optional[str]:
    """``ckpt_{epoch}.npz`` (``layout=NATIVE``, whose ``.step`` is ``step``
    and whose run key derives from ``seed``) or ``state_{epoch}.npz``
    (``MANAGED``, whose ``['bwd_counter']`` is ``counter`` and whose
    ``rng_key`` and ``bwd_key`` are ``keys``) in ``save_dir``, written by
    rank 0 after every rank's random streams are gathered; with
    ``keep_last`` the older files are pruned. ``comm_state`` is the comm
    hook's residual (native: this rank's vector, gathered from every rank;
    managed: one tensor per parameter), or None; ``skipped`` the guard's
    skip counters, or None; ``residual_replicated`` marks the native
    residual as ``mode: auto``'s one replicated vector (saved as it is,
    ``data_flat``). ``snapshot_step`` (with the v4 ``cursor`` and
    ``cursor_acc``) writes the step snapshot ``{prefix}_{epoch}_s{step}.npz``
    of that many real micro-batches of ``epoch`` instead
    (``tpuddp/training/checkpoint.py:804-859``). Returns the path on rank 0."""
    if optimizer is not None:
        optim.sync_steps(optimizer)  # the guard's device step count, on the host
    cap = capture(model, optimizer, layout=layout, seed=seed, generator=generator,
                  world_size=world_size, step=step, counter=counter, keys=keys,
                  comm_state=comm_state, skipped=skipped, residual_replicated=residual_replicated)
    return _on_main(rank, lambda: write_captured(
        save_dir, epoch, cap, completed=completed, snapshot_step=snapshot_step, cursor=cursor,
        cursor_acc=cursor_acc, keep_last=keep_last))


def save_model_on_main(save_dir: str, model: torch.nn.Module, rank: int) -> Optional[str]:
    """``save_dir/model.npz`` (``['params']`` and ``['model_state']``),
    written by rank 0."""
    def write_fn():
        os.makedirs(save_dir, exist_ok=True)
        return write(os.path.join(save_dir, "model.npz"), model_payload(MANAGED, model))

    return _on_main(rank, write_fn)


# --------------------------------------------------------------------- load --

def _topology(stored: dict) -> Optional[dict]:
    """The file's topology record; None for a file without one."""
    return json.loads(str(stored[_TOPO])) if _TOPO in stored else None


def read_topology(path: str) -> Optional[dict]:
    """The topology record of the checkpoint at ``path`` (None without)."""
    with np.load(path) as data:
        return _topology(data)


def topology_model_size(topo: Optional[dict]) -> int:
    """The model-axis width a file was written under: its ``model_size``,
    else its mesh's ``model`` axis, else 1
    (``tpuddp/training/checkpoint.py:254-266``)."""
    if not topo:
        return 1
    if topo.get("model_size") is not None:
        return int(topo["model_size"])
    axes, shape = topo.get("mesh_axes"), topo.get("mesh_shape")
    if axes and shape and "model" in axes:
        return int(shape[list(axes).index("model")])
    return 1


def _check_model_width(path: str, topo: Optional[dict], model_size) -> None:
    """The cross-``model``-width refusal (``tpuddp/training/checkpoint.py:
    269-296``): a file of one tensor-parallel width restored under another,
    or a file without a topology record onto a model axis, is a
    :class:`TopologyMismatch` with the JAX package's text."""
    cur = 1 if model_size is None else int(model_size)
    if topo is None:
        if cur > 1:
            raise TopologyMismatch(
                f"checkpoint {path} predates the topology record (format v1) "
                f"and cannot be restored onto a model={cur} tensor-parallel "
                "mesh: it carries no shard provenance, so even the reshaper "
                "refuses it. Resume it on a pure-DP world (model=1) or "
                "re-save it through save_on_main (format v3) first."
            )
        return
    saved = topology_model_size(topo)
    if saved != cur:
        raise TopologyMismatch(
            f"checkpoint {path} was written on a model={saved} mesh but the "
            f"current run is model={cur}. Cross-topology restore is opt-in: "
            "set training.reshard_on_mismatch=true to reshard on load, or "
            "reshape the file offline with `tpuddp_inspect reshard "
            f"--to data=D,model={cur}` (README '2-D mesh' documents which "
            "reshapes are exact and which reset the comm residual)."
        )


def _reshard_if_asked(path: str, stored: dict, model_size: int, reshard_on_mismatch: bool,
                      actions: Optional[List[dict]]) -> dict:
    """``stored`` reshaped onto this run's ``(data, model)`` shape when
    ``reshard_on_mismatch`` asks and the file's shape needs it: another
    model width, or another data width at model > 1
    (``tpuddp/training/checkpoint.py:554-587``); the reshaper's actions go
    to ``actions``. A model == 1 change of world keeps the loader's own
    refit."""
    topo = _topology(stored)
    world = get_world_size()
    if not reshard_on_mismatch or topo is None:
        return stored
    saved_model, saved_world = topology_model_size(topo), int(topo.get("world_size") or 0)
    if saved_model == model_size and not (model_size > 1 and saved_world and saved_world != world):
        return stored
    stored, _topo, racts = reshard.reshard_arrays(stored, data=world // model_size,
                                                  model=model_size, path=path)
    logger.warning(
        "elastic reshard: checkpoint %s re-shaped in-memory onto (data=%d, model=%d) before "
        "load (%d leaf action(s))", path, world // model_size, model_size, len(racts))
    if actions is not None:
        actions.extend(racts)
    return stored


def _v1_mismatch(path: str, key: str, shape, t_shape) -> TopologyMismatch:
    return TopologyMismatch(
        f"checkpoint {path}: world-size-dependent leaf {key!r} has "
        f"shape {tuple(shape)} but the current topology "
        f"expects {tuple(t_shape)}. This checkpoint predates the format-v2 "
        "topology record and cannot be resharded onto a different "
        "world size — resume it on the topology that wrote it, or "
        "re-save it through save_on_main (elastic v2) first."
    )


def _shape_mismatch(path: str, key: str, shape, t_shape) -> ValueError:
    return ValueError(
        f"checkpoint {path}: leaf {key!r} has shape {tuple(shape)} but the model expects "
        f"{tuple(t_shape)}"
    )


def _refit_flat(path: str, key: str, stored: np.ndarray, n_new: int,
                actions: Optional[List[dict]]) -> np.ndarray:
    """A world-padded flat vector (a ZeRO-1 moment, a world-1 residual)
    re-padded to ``n_new`` elements (``tpuddp/training/checkpoint.py:
    407-425``): a shorter target may drop only zeros, a longer one gains
    zeros. Recorded in ``actions`` as ``repadded``."""
    n_old = int(stored.shape[0])
    if n_new < n_old and np.any(stored[n_new:]):
        raise TopologyMismatch(
            f"checkpoint {path}: flat leaf {key!r} has {n_old} elements but "
            f"the current topology expects {n_new}, and the tail past "
            f"{n_new} is non-zero — this is not world-multiple padding (was "
            "the model changed, not just the world size?)"
        )
    out = np.zeros((n_new,), stored.dtype)
    out[:min(n_old, n_new)] = stored[:min(n_old, n_new)]
    if actions is not None:
        actions.append({"leaf": key, "action": "repadded",
                        "from_shape": list(stored.shape), "to_shape": [n_new]})
    return out


def fit_residual(path: str, stored: np.ndarray, topo: Optional[dict], target_len: int,
                 world_size: Optional[int], actions: Optional[List[dict]] = None) -> np.ndarray:
    """The file's native residual ``stored`` fitted to this run's
    ``(target_len,)`` vector (``world_size`` rows), as the JAX loader fits
    ``.comm_state`` (``tpuddp/training/checkpoint.py:429-538``): as it is at
    the same shape; a ``data_flat`` vector (a world-1 file's) re-padded; a
    ``per_replica`` one written at another world re-padded column-wise to
    this world's per-replica length (a non-zero tail refused), then its rows
    redistributed (:func:`~tpuddp_torch.parallel.comm.redistribute_residual`:
    summed, spread or reset; recorded in ``actions`` with the worlds). A
    file without a topology record, or ``world_size`` None where the rows
    must be redistributed, is a :class:`TopologyMismatch`."""
    key = _COMM
    t_shape = (int(target_len),)
    if tuple(stored.shape) == t_shape:
        return stored
    info = ((topo or {}).get("leaves") or {}).get(key)
    if info is None:
        if topo is None and stored.ndim == 1:
            raise _v1_mismatch(path, key, stored.shape, t_shape)
        raise _shape_mismatch(path, key, stored.shape, t_shape)
    if info["kind"] == "data_flat":
        return _refit_flat(path, key, stored, t_shape[0], actions)
    if info["kind"] != "per_replica":
        raise TopologyMismatch(f"checkpoint {path}: leaf {key!r} has unknown shard tag {info!r}")
    if int(info.get("model", 1) or 1) > 1:
        # (data_index, model_index) slices: the reshaper redistributes them
        # per model column; the loader's own refit does not
        raise TopologyMismatch(
            f"checkpoint {path}: per-replica leaf {key!r} was written on "
            f"a model={info['model']} mesh under a different data width; "
            "set training.reshard_on_mismatch=true (or reshape offline "
            "with `tpuddp_inspect reshard`) to redistribute it, or "
            "resume on the same (data, model) grid"
        )
    if world_size is None:
        raise TopologyMismatch(
            f"checkpoint {path}: per-replica leaf {key!r} (saved on a "
            f"{info['world']}-replica world) needs the CURRENT world "
            "size to redistribute; pass world_size= to load/"
            "restore_latest (the epoch drivers do)"
        )
    n_from, per_from = int(info["world"]), int(info["per"])
    if stored.shape[0] != n_from * per_from:
        raise TopologyMismatch(
            f"checkpoint {path}: per-replica leaf {key!r} has "
            f"{stored.shape[0]} elements but its topology record says "
            f"{n_from} x {per_from}"
        )
    if t_shape[0] % int(world_size) != 0:
        raise TopologyMismatch(
            f"checkpoint {path}: per-replica leaf {key!r} target length "
            f"{t_shape[0]} is not a multiple of world_size={world_size}"
        )
    per_to = t_shape[0] // int(world_size)
    mat = stored.reshape(n_from, per_from)
    if per_from != per_to:  # the column re-pad first: each row is world-padded
        cols = np.zeros((n_from, per_to), stored.dtype)
        keep = min(per_from, per_to)
        if per_from > per_to and np.any(mat[:, per_to:]):
            raise TopologyMismatch(
                f"checkpoint {path}: per-replica leaf {key!r} carries "
                f"non-zero data past the current per-replica length "
                f"{per_to} — not world-multiple padding"
            )
        cols[:, :keep] = mat[:, :keep]
        mat = cols
    new_mat, action = redistribute_residual(mat, int(world_size))
    if actions is not None:
        actions.append({"leaf": key, "action": action,
                        "from_world": n_from, "to_world": int(world_size)})
    if action == "reset":
        logger.warning(
            "checkpoint %s: per-replica leaf %r cannot be redistributed sum-preservingly from "
            "world %d to %d (no divisor relation); residual RESET to zero",
            path, key, n_from, world_size,
        )
    return new_mat.reshape(-1)


def build_reshard_events(path: str, epoch: int, topo: Optional[dict],
                         world_size: Optional[int], actions: List[dict],
                         model_size: Optional[int] = None) -> List[dict]:
    """The typed event rows of an elastic restore
    (``tpuddp/training/checkpoint.py:692-741``): one ``topology_change``
    (the worlds, the model widths, the refitted leaves, what became of the
    residual) and one ``comm_state_reset`` per residual that reset; empty
    for a restore onto the file's own topology. Logs the JAX package's
    "elastic resume" line."""
    from_world = (topo or {}).get("world_size")
    from_model = topology_model_size(topo) if topo else None
    to_model = None if model_size is None else int(model_size)
    if not (actions or (from_world and world_size and from_world != world_size)):
        return []
    events = [{
        "event": "topology_change",
        "from_world": from_world,
        "to_world": world_size,
        "from_model": from_model,
        "to_model": to_model,
        "checkpoint": os.path.basename(path),
        "checkpoint_epoch": epoch,
        "resharded_leaves": [a["leaf"] for a in actions],
        "residual": next((a["action"] for a in actions if a.get("from_world")), None),
    }]
    for a in actions:
        if a.get("action") == "reset":
            events.append({
                "event": "comm_state_reset",
                "leaf": a["leaf"],
                "from_world": a["from_world"],
                "to_world": a["to_world"],
                "reason": a.get("reason") or "no divisor relation between world sizes; "
                "error-feedback residual reset to zero",
            })
    logger.warning(
        "elastic resume: checkpoint %s written on world %s restored onto world %s "
        "(%d leaf/leaves resharded)", path, from_world, world_size, len(actions),
    )
    return events


def resumed_from(events: List[dict], with_model: bool = False) -> Dict[str, Any]:
    """The run header's fields of an elastic restore's rows: its
    ``topology_change``'s world as ``resumed_from_world`` (empty without
    one), as the JAX loops stamp it; with ``with_model`` (the native loop,
    ``tpuddp/training/loop.py:435-443``) its model width as
    ``resumed_from_model`` too, where it has one."""
    change = next((ev for ev in events if ev["event"] == "topology_change"), None)
    if change is None:
        return {}
    out = {"resumed_from_world": change["from_world"]}
    if with_model and change.get("from_model") is not None:
        out["resumed_from_model"] = change["from_model"]
    return out


def _stored(path: str, stored: dict, key: str, dtype, bf16: bool = False) -> np.ndarray:
    """The stored array for ``key`` (``__bf16__`` + key when ``bf16``), of
    ``dtype`` (uint16 bits when ``bf16``)."""
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
    if arr.dtype != (np.uint16 if bf16 else dtype):
        raise ValueError(f"checkpoint {path}: leaf {key!r} has dtype {arr.dtype}")
    return arr


def _leaf(path: str, stored: dict, key: str, like: np.ndarray, bf16: bool = False) -> np.ndarray:
    """The stored array for ``key`` (``__bf16__`` + key when ``bf16``),
    checked against the template array ``like``."""
    arr = _stored(path, stored, key, like.dtype, bf16)
    if arr.shape != like.shape:
        raise ValueError(
            f"checkpoint {path}: leaf {key!r} has shape {arr.shape} but the model expects "
            f"{like.shape}"
        )
    return arr


def _read_tree(path, stored, prefix, template, bf16=False):
    """The file's arrays under ``prefix`` in the structure of ``template``
    (each leaf checked against the template's)."""
    return tree_map(lambda at, like: _leaf(path, stored, prefix + keystr(at), like, bf16),
                    template)


def read_meta(path: str) -> Dict[str, int]:
    """The ``__meta__*`` scalars of a checkpoint (empty for files without)."""
    with np.load(path) as data:
        return {k[len(_META):]: int(data[k]) for k in data.files if k.startswith(_META)}


def _file_slots(stored: dict, opt: str) -> Tuple[str, ...]:
    """The slots of the optimizer state that a file holds under ``opt``."""
    found = set()
    for k in stored:
        k = k[len(_BF16):] if k.startswith(_BF16) else k
        if k.startswith(opt + "."):
            found.add(re.split(r"[.\[]", k[len(opt) + 1:], maxsplit=1)[0])
    return tuple(sorted(found - {"step"}))


def _flat_leaf(path: str, stored: dict, key: str, total: int, bf16: bool,
               actions: Optional[List[dict]] = None) -> np.ndarray:
    """The file's ZeRO-1 vector ``key`` at the current world's length
    ``total``: as it is, or re-padded when the file tags it ``data_flat``
    (``tpuddp/training/checkpoint.py:429-475``; only zeros may go)."""
    arr = _stored(path, stored, key, np.float32, bf16)
    if arr.shape == (total,):
        return arr
    topo = _topology(stored)
    info = ((topo or {}).get("leaves") or {}).get(key)
    if info is None or info.get("kind") != "data_flat":
        if topo is None and arr.ndim == 1:
            raise _v1_mismatch(path, key, arr.shape, (total,))
        raise _shape_mismatch(path, key, arr.shape, (total,))
    return _refit_flat(path, key, arr, total, actions)


def _restore_flat_opt(path, stored, layout, name, model, optimizer, actions=None) -> None:
    """Put the file's ZeRO-1 state into ``optimizer``: each vector re-padded,
    permuted into the port's order, and this rank's shard kept."""
    slots, counted = _opt_slots(optimizer)
    opt = _field(layout, "opt_state")
    spec, shard = optimizer.spec, optimizer.shard
    bf16 = _state_dtype(optimizer) == torch.bfloat16
    state = {}
    for slot, key in slots.items():
        vec = _flat_leaf(path, stored, f"{opt}.{slot}", spec.total, bf16, actions)
        if np.any(vec[spec.raw:]):
            raise ValueError(f"checkpoint {path}: flat leaf '{opt}.{slot}' has a non-zero padding")
        port = np.zeros_like(vec)
        port[:spec.raw] = flat_from_jax(name, model, vec[:spec.raw])
        t = torch.from_numpy(port[optimizer.lo:optimizer.hi].copy())
        if bf16:
            t = t.view(torch.int16).view(torch.bfloat16)
        state[key] = t.to(shard.device)
    if counted:
        state["step"] = int(_leaf(path, stored, f"{opt}.step", np.zeros((), np.int32)))
    optimizer.state.clear()
    if state:
        optimizer.state[shard] = state


def _restore_opt(path, stored, layout, name, model, optimizer, params_like,
                 actions=None, cut=None) -> None:
    """Put the file's optimizer state into ``optimizer``; ``cut`` makes a
    shard's moments of the whole ones (a tensor-parallel restore)."""
    slots, counted = _opt_slots(optimizer)
    opt = _field(layout, "opt_state")
    held = _file_slots(stored, opt)
    if held != tuple(sorted(slots)):
        raise ValueError(
            f"checkpoint {path} holds the optimizer state of "
            f"{_KINDS.get(held, 'an unknown optimizer ' + repr(held))}, but the optimizer is "
            f"{type(_inner(optimizer)).__name__} ({_KINDS[tuple(sorted(slots))]}); check "
            "training.optimizer (and momentum) match the saved run"
        )
    if isinstance(optimizer, optim.ShardedUpdate):
        _restore_flat_opt(path, stored, layout, name, model, optimizer, actions)
        return
    dtype = _state_dtype(optimizer)
    bf16 = dtype == torch.bfloat16
    step = int(_leaf(path, stored, f"{opt}.step", np.zeros((), np.int32))) if counted else None
    trees = {slot: torch_layout(name, _read_tree(path, stored, f"{opt}.{slot}", params_like, bf16))
             for slot in slots}
    if cut is not None:
        trees = {slot: cut(tree) for slot, tree in trees.items()}

    def tensor(arr, p):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if bf16:
            t = t.view(torch.int16).view(torch.bfloat16)
        return t.to(p.device).contiguous()

    optimizer.state.clear()
    for pname, p in model.named_parameters():
        state = {key: tensor(trees[slot][pname], p) for slot, key in slots.items()}
        if counted:
            state["step"] = step
        if state:
            optimizer.state[p] = state


def _residual_missing(path: str, key: str) -> None:
    logger.warning(
        "checkpoint %s predates comm_hook state: leaf %r starts at its zero initialization",
        path, key,
    )


@torch.no_grad()
def _restore_residual(path, stored, layout, name, model, optimizer, params_like, residual,
                      actions=None, replicated: bool = False) -> None:
    """The file's comm-hook residual into ``residual`` (in place): native,
    this rank's row of the per-replica vector fitted to this world
    (:func:`fit_residual`), permuted into the port's order under ZeRO-1, or
    with ``replicated`` (``mode: auto``'s one residual) the file's vector
    fitted to one row (a per-replica file's rows summed); managed, each
    parameter's tensor. Zeros when the file has none."""
    if layout == MANAGED:
        prefix = _field(MANAGED, "comm_state")
        if not any(k.startswith(prefix) for k in stored):
            _residual_missing(path, prefix)
            for r in residual:
                r.zero_()
            return
        arrays = torch_layout(name, _read_tree(path, stored, prefix, params_like))
        for (pname, _), r in zip(model.named_parameters(), residual):
            r.copy_(torch.from_numpy(arrays[pname]))
        return
    if _COMM not in stored:
        _residual_missing(path, _COMM)
        residual.zero_()
        return
    world, rank, per = (1, 0, residual.numel()) if replicated else (
        get_world_size(), get_rank(), residual.numel())
    arr = fit_residual(path, _stored(path, stored, _COMM, np.float32), _topology(stored),
                       world * per, world, actions)
    mine = arr[rank * per:(rank + 1) * per].copy()
    if isinstance(optimizer, optim.ShardedUpdate):
        raw = optimizer.spec.raw
        mine[:raw] = flat_from_jax(name, model, mine[:raw].copy())
    residual.copy_(torch.from_numpy(mine))


def _restore(path: str, layout: str, model: torch.nn.Module, optimizer=None,
             generator: Optional[torch.Generator] = None, comm_state=None,
             skipped=None, actions: Optional[List[dict]] = None,
             residual_replicated: bool = False,
             reshard_on_mismatch: bool = False) -> Dict[str, Any]:
    with np.load(path) as data:
        stored = dict(data.items())
    shard = _shard(model)
    model_size = 1 if shard is None else shard.mesh.model
    stored = _reshard_if_asked(path, stored, model_size, reshard_on_mismatch, actions)
    _check_model_width(path, _topology(stored), model_size)
    name = model_name(model)
    cut = None
    template = model.state_dict()
    if shard is not None:  # the whole arrays, canonical layout; each rank cuts its shard
        stored = reshard.qkv_layout(stored, False)
        template = {k: np.zeros(tuple(v.shape), np.float32)
                    for k, v in shard.whole_meta().state_dict().items()}
        cut = shard.cut
    params_like, mstate_like = jax_from_state_dict(name, template)
    params = _read_tree(path, stored, _field(layout, "params"), params_like)
    mstate = _read_tree(path, stored, _field(layout, "model_state"), mstate_like)
    sd = state_dict_from_jax(name, params, mstate)
    model.load_state_dict(sd if cut is None else cut(sd))
    if optimizer is not None:
        _restore_opt(path, stored, layout, name, model, optimizer, params_like, actions, cut)
        optim.count_from_state(optimizer)
    if comm_state is not None:
        _restore_residual(path, stored, layout, name, model, optimizer, params_like, comm_state,
                          actions, residual_replicated)
    if skipped is not None:
        _restore_skipped(path, stored, layout, skipped)
    if RNG_KEY in stored:
        restore_rng(json.loads(str(stored[RNG_KEY])), generator, next(model.parameters()).device)
    meta = {k[len(_META):]: int(a) for k, a in stored.items() if k.startswith(_META)}
    if layout == NATIVE and ".step" in stored:
        meta["step"] = int(stored[".step"])
    if layout == MANAGED and "['bwd_counter']" in stored:
        meta["bwd_counter"] = int(stored["['bwd_counter']"])
        for k in ("rng_key", "bwd_key"):
            meta[k] = stored[f"{_PRNG}['{k}']"]
    return meta


def load(path: str, model: torch.nn.Module, optimizer=None, *, layout: str = NATIVE,
         generator: Optional[torch.Generator] = None, comm_state=None,
         skipped=None, residual_replicated: bool = False,
         reshard_on_mismatch: bool = False) -> Dict[str, Any]:
    """Restore ``model`` (and ``optimizer``'s state, the comm hook's
    residual ``comm_state`` and the guard's counters ``skipped`` in place,
    and the random streams) from the intact file ``path`` in ``layout``;
    returns its ``__meta__`` scalars, and a native file's ``.step`` as
    ``step`` or a managed file's ``bwd_counter``, ``rng_key`` and
    ``bwd_key``. A file of another model width is a :class:`TopologyMismatch`
    unless ``reshard_on_mismatch`` reshapes it (the module doc)."""
    if not verify_file(path):
        raise ValueError(f"checkpoint {path} does not match its sha256 manifest")
    return _restore(path, layout, model, optimizer, generator, comm_state, skipped,
                    residual_replicated=residual_replicated,
                    reshard_on_mismatch=reshard_on_mismatch)


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


def _latest_any(save_dir: str, prefix: str = "ckpt",
                include_peers: bool = True) -> Optional[Tuple[str, int, Optional[int], str]]:
    """The freshest intact file across the local files, the peer spills
    (:func:`peer_checkpoint_dirs`) and the epoch family: ``(path, epoch,
    step, provenance)``, ``provenance`` ``"local"`` or ``"peer:ring_<i>"``;
    equal freshness prefers the local file (``tpuddp/training/
    checkpoint.py:908-937``)."""
    candidates = [((e, 1 if s is None else 0, s or 0), 0, path, e, s, "local")
                  for path, e, s in _all_checkpoints(save_dir, prefix)]
    if include_peers:
        for pd in peer_checkpoint_dirs(save_dir):
            prov = f"peer:{os.path.basename(pd)}"
            candidates += [((e, 1 if s is None else 0, s or 0), 1, path, e, s, prov)
                           for path, e, s in _all_checkpoints(pd, prefix)]
    candidates.sort(key=lambda c: (c[0], -c[1]), reverse=True)
    for _key, _rank, path, epoch, step, prov in candidates:
        if verify_file(path):
            return path, epoch, step, prov
        logger.warning(
            "checkpoint %s (%s) failed integrity verification (corrupt or truncated); skipping "
            "it and falling back to the next-newest intact candidate across {local, peer, "
            "epoch-family}", path, prov,
        )
    return None


def _agreed(save_dir: str, prefix: str, device: Optional[torch.device]):
    """:func:`_latest_any` as process 0 finds it, on every process (a
    collective at world > 1; ``device`` carries it): each process opens the
    file of that name under its own ``save_dir`` (or its own peer spill
    directory). ``FileNotFoundError`` on every process when one of them
    cannot verify it."""
    found = _latest_any(save_dir, prefix) if get_rank() == 0 else None
    if get_world_size() == 1:
        return found
    peer_root = os.path.join(heartbeat_dir(save_dir), "peer_ckpt")
    box = [None]
    if found is not None:
        path, epoch, step, prov = found
        root = save_dir if prov == "local" else peer_root
        box = [(os.path.relpath(path, root), epoch, step, prov)]
    dist.broadcast_object_list(box, src=0, device=device)
    if box[0] is None:
        return None
    name, epoch, step, prov = box[0]
    path = os.path.join(save_dir if prov == "local" else peer_root, name)
    ok = torch.tensor([int(get_rank() == 0 or verify_file(path))], device=device)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    if not ok.item():
        raise FileNotFoundError(
            f"process 0 resumes from {name}, which a process cannot open under its {save_dir}: "
            "every host must see one out_dir (a shared filesystem) to resume or roll back"
        )
    return path, epoch, step, prov


def agreed_latest(save_dir: str, prefix: str = "ckpt",
                  device: Optional[torch.device] = None) -> Optional[Tuple[str, int]]:
    """The freshest intact ``(path, epoch)`` (:func:`_latest_any`, step
    snapshots and peer spills included) as process 0 finds it, on every
    process; ``FileNotFoundError`` on every process when one of them cannot
    verify that file."""
    found = _agreed(save_dir, prefix, device)
    return None if found is None else found[:2]


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
    """Delete all but the ``keep_last`` newest files (with their manifests
    and a snapshot's writer sidecar) and stale staging files; the newest
    intact full-epoch file is never collected. Returns how many
    checkpoints went."""
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
        for p in (path, manifest_path(path), path + ".writer.json"):
            try:
                os.remove(p)
            except FileNotFoundError:
                pass
        removed += 1
        logger.info("pruned old checkpoint %s (keep_last=%d)", path, keep_last)
    return removed


def restore_latest(save_dir: str, model: torch.nn.Module, optimizer=None, *,
                   layout: str = NATIVE, generator: Optional[torch.Generator] = None,
                   comm_state=None, skipped=None,
                   cursor_out: Optional[List[dict]] = None,
                   reshard_log: Optional[List[dict]] = None,
                   model_size: Optional[int] = None,
                   residual_replicated: bool = False,
                   reshard_on_mismatch: bool = False) -> Tuple[int, Dict[str, Any]]:
    """Restore the freshest intact file of ``layout`` across ``save_dir``,
    the peer spills and the epoch family; returns ``(next_epoch, meta)``:
    the epoch to train next (0 when there is no file; a step snapshot's own
    epoch, whose cursor, with its ``path`` and ``provenance``, is appended
    to ``cursor_out``; the file's epoch after an emergency save,
    ``completed=0``; else the one after it) and what :func:`load` returns
    (empty without a file). ``comm_state`` and ``skipped`` are restored in
    place as :func:`load` does. Every process restores the file process 0
    picks; its provenance is logged when it is not a local epoch file.

    A file written at another world size is refitted onto this one (the
    module doc); ``reshard_log`` receives :func:`build_reshard_events`' rows
    (``model_size`` is their ``to_model``), and a step snapshot's cursor
    then carries no plan key, so the caller redoes that epoch. A file of
    another ``(data, model)`` shape is reshaped first under
    ``reshard_on_mismatch``, else refused where the loader cannot fit it
    (:class:`TopologyMismatch`)."""
    prefix = PREFIX[layout]
    sweep_stale_tmp(save_dir, prefix)
    found = _agreed(save_dir, prefix, next(model.parameters()).device)
    if found is None:
        return 0, {}
    path, epoch, step, provenance = found
    if provenance != "local" or step is not None:
        logger.warning(
            "restore_latest: picked %s (epoch=%d, %s, provenance=%s) as the freshest intact "
            "candidate across {local, peer, epoch-family}", path, epoch,
            "full-epoch" if step is None else f"step={step}", provenance,
        )
    actions: List[dict] = []
    meta = _restore(path, layout, model, optimizer, generator, comm_state, skipped, actions,
                    residual_replicated, reshard_on_mismatch)
    if reshard_log is not None:
        reshard_log.extend(build_reshard_events(path, epoch, read_topology(path),
                                                get_world_size(), actions, model_size))
    cursor = read_cursor(path)
    if cursor is not None:
        if actions:  # the sampler's plan keys on the world: these are other batches
            cursor["plan_key"] = None
        if cursor_out is not None:
            cursor_out.append(dict(cursor, path=path, provenance=provenance))
        logger.warning(
            "resuming from STEP snapshot %s (epoch %d, step %s, provenance=%s); the interrupted "
            "epoch continues at the recorded step — zero batches replayed",
            path, int(cursor.get("epoch", epoch)), cursor.get("step"), provenance,
        )
        return int(cursor.get("epoch", epoch)), meta
    if not meta.get("completed", 1):
        logger.warning(
            "resuming from EMERGENCY checkpoint %s (preempted during epoch %d); that "
            "epoch restarts from the saved state", path, epoch,
        )
        return epoch, meta
    return epoch + 1, meta
