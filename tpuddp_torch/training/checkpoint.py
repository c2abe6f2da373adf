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
load, with its warning); a residual saved at another world size is refused
(its redistribution is the elastic reshard, not ported); a residual in a
file for a run without error feedback is not read, as the JAX template
does not read it.

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
``out_dir`` must be one filesystem that every host sees. A file that needs a part of the JAX
package the port lacks (a step snapshot's ``__cursor__``, a model axis) is
refused with ``NotImplementedError`` naming its ROADMAP item, never loaded
in part.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
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
from tpuddp_torch.seeding import jax_run_key

logger = logging.getLogger("tpuddp")

FORMAT_VERSION = 4
NATIVE, MANAGED = "native", "managed"
PREFIX = {NATIVE: "ckpt", MANAGED: "state"}
RNG_KEY = "__tpuddp_torch_rng__"
AUTO_RESUME_ENV = "TPUDDP_AUTO_RESUME"
_BF16, _PRNG, _META, _TOPO, _CURSOR = (
    "__bf16__", "__prngkey__", "__meta__", "__topology__", "__cursor__",
)
_COMM = ".comm_state"  # the native residual's key
_SKIP_KEYS = ("consecutive", "total")  # the guard's counters, in the JAX key order


def auto_resume_requested() -> bool:
    """``$TPUDDP_AUTO_RESUME`` set to anything but empty or ``0``
    (``tpuddp/resilience/preemption.py:77-81``)."""
    return os.environ.get(AUTO_RESUME_ENV, "") not in ("", "0")


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
    collective): ``{"step": int, slot: (total,) CPU tensor}``, each slot in
    the moments' dtype, zeros before the first step."""
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
        out[slot] = full.to(dtype).cpu()
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


def _opt_payload(layout: str, name: str, model: torch.nn.Module, optimizer) -> Dict[str, np.ndarray]:
    """The optimizer's state by its JAX keys (numpy; bf16 as bits). A
    parameter without state yet has zeros; mixed step counts are refused."""
    slots, counted = _opt_slots(optimizer)
    dtype = _state_dtype(optimizer)
    steps, by_slot = set(), {slot: {} for slot in slots}
    for pname, p in model.named_parameters():
        state = optimizer.state.get(p) or {}
        steps.add(int(state.get("step", 0)))
        for slot, key in slots.items():
            by_slot[slot][pname] = _bits(state.get(key, torch.zeros(p.shape, dtype=dtype)))
    opt = _field(layout, "opt_state")
    payload = {}
    if counted:
        if len(steps) > 1:
            raise ValueError(
                f"parameters are at steps {sorted(steps)}; the JAX layout keeps one step "
                "count for the whole tree"
            )
        payload[f"{opt}.step"] = np.asarray(steps.pop() if steps else 0, np.int32)
    mark = _BF16 if dtype == torch.bfloat16 else ""
    for slot, arrays in by_slot.items():
        tree, _ = jax_from_state_dict(name, arrays)
        payload.update((mark + k, a) for k, a in _leaves(f"{opt}.{slot}", tree))
    return payload


def state_payload(layout: str, model: torch.nn.Module, optimizer=None,
                  flat_state: Optional[Dict[str, Any]] = None) -> Dict[str, np.ndarray]:
    """The model's (and the optimizer's) arrays by their JAX keys; a ZeRO-1
    optimizer's state comes from ``flat_state`` (:func:`gather_flat_state`)."""
    name = model_name(model)
    params, mstate = jax_from_state_dict(name, model.state_dict())
    payload = dict(_leaves(_field(layout, "params"), params))
    payload.update(_leaves(_field(layout, "model_state"), mstate))
    if isinstance(optimizer, optim.ShardedUpdate):
        payload.update(_flat_opt_payload(layout, name, model, optimizer, flat_state))
    elif optimizer is not None:
        payload.update(_opt_payload(layout, name, model, optimizer))
    return payload


def topology_record(world_size: int, flat_keys=(), residual_per: Optional[int] = None) -> dict:
    """The JAX package's topology record: replicated leaves carry no tag;
    the ZeRO-1 vectors ``flat_keys`` are ``data_flat``, sharded over the
    data axis, when the world is over one (on one device the JAX package's
    sharding is a replicated one, and it tags nothing). A native residual
    of ``residual_per`` elements per replica is ``per_replica`` over the
    data axis when the world is over one, else ``data_flat``."""
    w = int(world_size)
    flat_keys = tuple(flat_keys) if w > 1 else ()
    leaves = {k: {"kind": "data_flat"} for k in flat_keys}
    placement = {k: ["data"] for k in flat_keys}
    if residual_per is not None:
        leaves[_COMM] = ({"kind": "per_replica", "world": w, "per": int(residual_per), "model": 1}
                         if w > 1 else {"kind": "data_flat"})
        if w > 1:
            placement[_COMM] = ["data"]
    return {"format": FORMAT_VERSION, "world_size": w, "model_size": 1,
            "mesh_axes": ["data"], "mesh_shape": [w], "leaves": leaves, "placement": placement}


def gather_residual(model: torch.nn.Module, optimizer, residual: torch.Tensor) -> np.ndarray:
    """Every replica's native residual (``(total,)`` each) in the JAX flat
    order, concatenated in rank order (a collective): ``(world * total,)``
    float32. Under ZeRO-1 (``optimizer`` a ShardedUpdate) each is permuted
    from the port's order."""
    world = get_world_size()
    full = torch.empty(world * residual.numel(), dtype=torch.float32, device=residual.device)
    collectives.all_gather_shards(full, residual.contiguous())
    out = full.cpu().numpy().reshape(world, -1)
    if isinstance(optimizer, optim.ShardedUpdate):
        raw = optimizer.spec.raw
        for row in out:
            row[:raw] = flat_to_jax(model_name(model), model, row[:raw].copy())
    return out.reshape(-1)


def _skip_key(layout: str, name: str) -> str:
    return f"{_field(layout, 'skipped_steps')}['{name}']"


def _skip_payload(layout: str, skipped) -> Dict[str, np.ndarray]:
    """The guard's counters (device int32 scalars) by their JAX keys."""
    values = torch.stack([skipped[k] for k in _SKIP_KEYS]).tolist()
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
    """The managed residual (one tensor per parameter) as the JAX tree
    ``['comm_state']``."""
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
    step: int = 0, counter: int = 0, keys: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    comm_state=None, skipped=None,
) -> Optional[str]:
    """``ckpt_{epoch}.npz`` (``layout=NATIVE``, whose ``.step`` is ``step``
    and whose run key derives from ``seed``) or ``state_{epoch}.npz``
    (``MANAGED``, whose ``['bwd_counter']`` is ``counter`` and whose
    ``rng_key`` and ``bwd_key`` are ``keys``) in ``save_dir``, written by
    rank 0 after every rank's random streams are gathered; with
    ``keep_last`` the older files are pruned. ``comm_state`` is the comm
    hook's residual (native: this rank's vector, gathered from every rank;
    managed: one tensor per parameter), or None; ``skipped`` the guard's
    skip counters, or None. Returns the path on rank 0."""
    if layout == MANAGED and keys is None:
        raise ValueError("a managed state file needs the accelerator's keys (rng_key, bwd_key)")
    if optimizer is not None:
        optim.sync_steps(optimizer)  # the guard's device step count, on the host
    device = next(model.parameters()).device
    record = _gather_rng(rng_states(generator, device))
    flat_state, flat_keys = None, ()
    if isinstance(optimizer, optim.ShardedUpdate):  # every rank gathers
        flat_state = gather_flat_state(optimizer)
        opt = _field(layout, "opt_state")
        flat_keys = [f"{opt}.{slot}" for slot in _opt_slots(optimizer)[0]]
    residual, residual_per = {}, None
    if comm_state is not None and layout == NATIVE:  # every rank gathers
        residual = {_COMM: gather_residual(model, optimizer, comm_state)}
        residual_per = comm_state.numel()
    elif comm_state is not None:
        residual = _managed_residual_payload(model, comm_state)
    if skipped is not None:
        residual.update(_skip_payload(layout, skipped))

    def write_fn():
        os.makedirs(save_dir, exist_ok=True)
        payload = state_payload(layout, model, optimizer, flat_state)
        payload.update(residual)
        if layout == NATIVE:
            payload[".step"] = np.asarray(step, np.int32)
            payload[f"{_PRNG}.rng"] = jax_run_key(seed or 0)
        else:
            payload[f"{_PRNG}['rng_key']"], payload[f"{_PRNG}['bwd_key']"] = keys
            payload["['bwd_counter']"] = np.asarray(counter, np.int64)
        payload[RNG_KEY] = np.asarray(json.dumps(record))
        path = write(
            checkpoint_path(save_dir, epoch, PREFIX[layout]), payload,
            meta={"epoch": epoch, "completed": int(completed)},
            topology=topology_record(world_size, flat_keys, residual_per),
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


def _flat_leaf(path: str, stored: dict, key: str, total: int, bf16: bool) -> np.ndarray:
    """The file's ZeRO-1 vector ``key`` at the current world's length
    ``total``: as it is, or re-padded when the file tags it ``data_flat``
    (``tpuddp/training/checkpoint.py:407-425``; only zeros may go)."""
    arr = _stored(path, stored, key, np.float32, bf16)
    if arr.shape == (total,):
        return arr
    topo = json.loads(str(stored[_TOPO])) if _TOPO in stored else {}
    tagged = ((topo.get("leaves") or {}).get(key) or {}).get("kind") == "data_flat"
    if arr.ndim != 1 or not tagged:
        raise ValueError(
            f"checkpoint {path}: leaf {key!r} has shape {arr.shape} but the model expects "
            f"{(total,)}"
        )
    if len(arr) > total and np.any(arr[total:]):
        raise ValueError(
            f"checkpoint {path}: flat leaf {key!r} has {len(arr)} elements but the current "
            f"topology expects {total}, and the tail past {total} is non-zero — this is not "
            "world-multiple padding (was the model changed, not just the world size?)"
        )
    out = np.zeros(total, arr.dtype)
    out[:min(len(arr), total)] = arr[:total]
    return out


def _restore_flat_opt(path, stored, layout, name, model, optimizer) -> None:
    """Put the file's ZeRO-1 state into ``optimizer``: each vector re-padded,
    permuted into the port's order, and this rank's shard kept."""
    slots, counted = _opt_slots(optimizer)
    opt = _field(layout, "opt_state")
    spec, shard = optimizer.spec, optimizer.shard
    bf16 = _state_dtype(optimizer) == torch.bfloat16
    state = {}
    for slot, key in slots.items():
        vec = _flat_leaf(path, stored, f"{opt}.{slot}", spec.total, bf16)
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


def _restore_opt(path, stored, layout, name, model, optimizer, params_like) -> None:
    """Put the file's optimizer state into ``optimizer``."""
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
        _restore_flat_opt(path, stored, layout, name, model, optimizer)
        return
    dtype = _state_dtype(optimizer)
    bf16 = dtype == torch.bfloat16
    step = int(_leaf(path, stored, f"{opt}.step", np.zeros((), np.int32))) if counted else None
    trees = {slot: torch_layout(name, _read_tree(path, stored, f"{opt}.{slot}", params_like, bf16))
             for slot in slots}

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
def _restore_residual(path, stored, layout, name, model, optimizer, params_like, residual) -> None:
    """The file's comm-hook residual into ``residual`` (in place): native,
    this rank's slice of the per-replica vector (permuted into the port's
    order under ZeRO-1); managed, each parameter's tensor. Zeros when the
    file has none."""
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
    topo = json.loads(str(stored[_TOPO])) if _TOPO in stored else {}
    world, per = get_world_size(), residual.numel()
    saved = int(topo.get("world_size") or world)
    if saved != world:
        raise NotImplementedError(
            f"checkpoint {path} holds the per-replica comm-hook residual of a {saved}-replica "
            f"world, and this run has {world}; redistributing it is not implemented in "
            "tpuddp_torch yet (ROADMAP.md Queue 1 item 8: elastic reshard)"
        )
    arr = _stored(path, stored, _COMM, np.float32)
    if arr.shape != (world * per,):
        raise ValueError(
            f"checkpoint {path}: leaf {_COMM!r} has shape {arr.shape} but the model expects "
            f"{(world * per,)}"
        )
    mine = arr[get_rank() * per:(get_rank() + 1) * per].copy()
    if isinstance(optimizer, optim.ShardedUpdate):
        raw = optimizer.spec.raw
        mine[:raw] = flat_from_jax(name, model, mine[:raw].copy())
    residual.copy_(torch.from_numpy(mine))


def _restore(path: str, layout: str, model: torch.nn.Module, optimizer=None,
             generator: Optional[torch.Generator] = None, comm_state=None,
             skipped=None) -> Dict[str, Any]:
    with np.load(path) as data:
        stored = dict(data.items())
    _refuse_unported(path, stored)
    name = model_name(model)
    params_like, mstate_like = jax_from_state_dict(name, model.state_dict())
    params = _read_tree(path, stored, _field(layout, "params"), params_like)
    mstate = _read_tree(path, stored, _field(layout, "model_state"), mstate_like)
    model.load_state_dict(state_dict_from_jax(name, params, mstate))
    if optimizer is not None:
        _restore_opt(path, stored, layout, name, model, optimizer, params_like)
        optim.count_from_state(optimizer)
    if comm_state is not None:
        _restore_residual(path, stored, layout, name, model, optimizer, params_like, comm_state)
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
         skipped=None) -> Dict[str, Any]:
    """Restore ``model`` (and ``optimizer``'s state, the comm hook's
    residual ``comm_state`` and the guard's counters ``skipped`` in place,
    and the random streams) from the intact file ``path`` in ``layout``;
    returns its ``__meta__`` scalars, and a native file's ``.step`` as
    ``step`` or a managed file's ``bwd_counter``, ``rng_key`` and
    ``bwd_key``."""
    if not verify_file(path):
        raise ValueError(f"checkpoint {path} does not match its sha256 manifest")
    return _restore(path, layout, model, optimizer, generator, comm_state, skipped)


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


def agreed_latest(save_dir: str, prefix: str = "ckpt",
                  device: Optional[torch.device] = None) -> Optional[Tuple[str, int]]:
    """:func:`latest` as process 0 finds it, on every process (a collective
    at world > 1; ``device`` carries it). ``FileNotFoundError`` on every
    process when one of them cannot verify that file."""
    found = latest(save_dir, prefix) if get_rank() == 0 else None
    if get_world_size() == 1:
        return found
    box = [None if found is None else (os.path.basename(found[0]), found[1])]
    dist.broadcast_object_list(box, src=0, device=device)
    if box[0] is None:
        return None
    name, epoch = box[0]
    path = os.path.join(save_dir, name)
    ok = torch.tensor([int(get_rank() == 0 or verify_file(path))], device=device)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    if not ok.item():
        raise FileNotFoundError(
            f"process 0 resumes from {name}, which a process cannot open under its {save_dir}: "
            "every host must see one out_dir (a shared filesystem) to resume or roll back"
        )
    return path, epoch


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
                   layout: str = NATIVE, generator: Optional[torch.Generator] = None,
                   comm_state=None, skipped=None) -> Tuple[int, Dict[str, Any]]:
    """Restore the newest intact file of ``layout`` in ``save_dir``; returns
    ``(next_epoch, meta)``: the epoch to train next (0 when there is no
    file, the file's epoch after an emergency save, ``completed=0``, else
    the one after it) and what :func:`load` returns (empty without a
    file). ``comm_state`` and ``skipped`` are restored in place as
    :func:`load` does. Every process restores :func:`agreed_latest`'s
    file."""
    prefix = PREFIX[layout]
    sweep_stale_tmp(save_dir, prefix)
    found = agreed_latest(save_dir, prefix, next(model.parameters()).device)
    if found is None:
        return 0, {}
    path, epoch = found
    meta = _restore(path, layout, model, optimizer, generator, comm_state, skipped)
    if not meta.get("completed", 1):
        logger.warning(
            "resuming from EMERGENCY checkpoint %s (preempted during epoch %d); that "
            "epoch restarts from the saved state", path, epoch,
        )
        return epoch, meta
    return epoch + 1, meta
