"""Cross-topology checkpoint resharding — the port's copy of
``tpuddp/training/reshard.py`` (numpy and the standard library only; it
imports nothing of the JAX package).

A checkpoint written on one ``(data, model)`` shape, reshaped into one for
another, as array surgery on the saved ``.npz`` payload:

- **parameters and tree-shaped optimizer moments** are stored as whole
  arrays, so a model-width change only rewrites the topology record and, at
  the TP <-> DP layout boundary, applies the exact QKV reshape
  (``wqkv (E, 3*H*Dh) <-> (E, 3, H*Dh)``, ``bqkv (3*H*Dh,) <-> (3,
  H*Dh)``), byte for byte;
- **flat data-axis vectors** (tag ``data_flat``: ZeRO-1 moments, the
  ``mode: auto`` residual) are re-padded to the target world (a non-zero
  tail refused); they exist at model 1 only, so a model > 1 target refuses
  them;
- **the per-(data, model) error-feedback residual** (tag ``per_replica``,
  ``(world * per,)`` data-major, model-minor) is redistributed over the
  data axis per model column at a fixed model width
  (:func:`redistribute_rows`, the mirror of
  ``tpuddp_torch.parallel.comm.redistribute_residual``), and dropped across
  model widths (a typed ``reset`` action; the loader re-zeroes it);
- **placement tags** of a model > 1 target come from
  :data:`TP_PLACEMENT_RULES`, the static mirror of the live rule table
  (``parallel/tensor.py``).

Refused (:class:`ReshardError`, a ``ValueError``): files without a topology
record, ``data_flat`` state onto a model > 1 target, a model width that does
not divide a split dimension, and flat vectors whose length contradicts
their tags. The port's loader (``training/checkpoint.py``) calls
:func:`reshard_arrays` under ``training.reshard_on_mismatch``;
:func:`reshard_checkpoint` rewrites a file.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# Mirrors of the checkpoint format markers (checkpoint.py defines the same
# constants; duplicated here so this module imports numpy only —
# tests/test_torch_port_mesh2d.py asserts they match).
KEY_MARK = "__prngkey__"
BF16_MARK = "__bf16__"
META_MARK = "__meta__"
TOPO_MARK = "__topology__"
CURSOR_MARK = "__cursor"  # prefix of both __cursor__ and __cursor_acc__*

FORMAT_VERSION = 4  # tracks checkpoint.FORMAT_VERSION — v4 adds the
# optional __cursor__ data-cursor record; the topology record contents the
# reshaper keys on are unchanged from v3.

_MODEL_AXIS = "model"
_DATA_AXIS = "data"

# The TP<->canonical layout boundary: the two leaves tensor.to_tp_tree /
# from_tp_tree reshape. Matched by key SUFFIX so the rule covers parameters
# AND their path-congruent Adam moments (.opt_state.m/... , .opt_state.v/...)
# in both the native (".params[...]") and managed ("['params'][...]") key
# spellings.
_WQKV_SUFFIX = "['attn']['wqkv']"
_BQKV_SUFFIX = "['attn']['bqkv']"

# Static mirror of the live placement rule table: tensor.tp_param_specs
# (transformer.PARTITION_RULES under tp_rules(), plus the two QKV layout
# overrides), spelled in derive_topology's JSON form — one entry per
# model-sharded leaf suffix, [mesh-axis-or-None per dimension] in the TP
# layout. Leaves not listed are replicated over the model axis and carry no
# placement tag, exactly like derive_topology. tests/test_torch_port_mesh2d.py
# pins this table against the JAX package's and a TP save's tags.
TP_PLACEMENT_RULES: Tuple[Tuple[str, List[Optional[str]]], ...] = (
    ("['embed']['weight']", [_MODEL_AXIS, None]),  # vocab-split embedding/LM head
    (_WQKV_SUFFIX, [None, None, _MODEL_AXIS]),     # (E, 3, H*Dh): head split
    (_BQKV_SUFFIX, [None, _MODEL_AXIS]),
    ("['attn']['wo']", [_MODEL_AXIS, None]),       # row-split attention output
    ("['mlp']['w1']", [None, _MODEL_AXIS]),        # column-split MLP in
    ("['mlp']['b1']", [_MODEL_AXIS]),
    ("['mlp']['w2']", [_MODEL_AXIS, None]),        # row-split MLP out
)


class ReshardError(ValueError):
    """A checkpoint cannot be reshaped onto the requested ``(data, model)``
    mesh: the file predates the topology record, the target shape is
    infeasible (non-dividing model width, data_flat state under model>1), or
    the stored arrays contradict their own shard tags."""


# --------------------------------------------------------------- helpers --


def _is_param_key(key: str) -> bool:
    return key.startswith(".params") or key.startswith("['params']")


def _is_comm_key(key: str) -> bool:
    return key in (".comm_state", "['comm_state']")


def _strip_mark(key: str) -> Tuple[str, str]:
    """``(mark, bare_key)`` — npz entry name minus its dtype-encoding mark."""
    for mark in (KEY_MARK, BF16_MARK):
        if key.startswith(mark):
            return mark, key[len(mark):]
    return "", key


def parse_topology(stored: Dict[str, np.ndarray]) -> Optional[dict]:
    """The parsed ``__topology__`` record of an npz payload dict (None = v1)."""
    if TOPO_MARK not in stored:
        return None
    return json.loads(str(np.asarray(stored[TOPO_MARK]).item()))


def topology_shape(topo: dict) -> Tuple[int, int]:
    """``(data, model)`` widths recorded by a v2/v3 topology record."""
    world = int(topo.get("world_size") or 0)
    model = topo.get("model_size")
    if model is None:
        axes, shape = topo.get("mesh_axes"), topo.get("mesh_shape")
        model = (
            int(shape[list(axes).index(_MODEL_AXIS)])
            if axes and shape and _MODEL_AXIS in axes
            else 1
        )
    model = int(model)
    if world < 1 or model < 1 or world % model:
        raise ReshardError(
            f"topology record is inconsistent: world_size={world} is not a "
            f"multiple of model_size={model}"
        )
    return world // model, model


def redistribute_rows(mat: np.ndarray, new_world: int) -> Tuple[np.ndarray, str]:
    """Sum-preserving re-mapping of per-replica residual rows onto a new
    world size — a numpy-only mirror of
    :func:`tpuddp_torch.parallel.comm.redistribute_residual` (kept in lockstep by
    tests/test_torch_port_mesh2d.py) so the reshaper imports numpy only. Shrink
    along a divisor: consecutive row groups sum (bitwise-reproducible f32
    adds); grow along a divisor: rows place verbatim at stride ``new/old``
    with zeros between; no divisor relation: reset to zeros. Returns
    ``(new_mat, action)``."""
    mat = np.asarray(mat)
    if mat.ndim != 2:
        raise ValueError(f"expected a (world, per) residual view, got {mat.shape}")
    old_world, per = mat.shape
    if new_world < 1:
        raise ValueError(f"new_world must be >= 1, got {new_world}")
    if new_world == old_world:
        return mat, "unchanged"
    if old_world % new_world == 0:
        k = old_world // new_world
        return mat.reshape(new_world, k, per).sum(axis=1), "redistributed"
    if new_world % old_world == 0:
        k = new_world // old_world
        out = np.zeros((new_world, per), mat.dtype)
        out[::k] = mat
        return out, "redistributed"
    return np.zeros((new_world, per), mat.dtype), "reset"


def _padded_total(raw: int, world: int) -> int:
    """``step.make_flat_param_spec``'s padding rule: raw element count
    rounded up to a world multiple."""
    return world * math.ceil(raw / world)


def _placement_for(key: str, placement: Dict[str, list]) -> Optional[list]:
    return placement.get(key)


def _model_split_dims(key: str, axes: Optional[list]) -> List[int]:
    """Dimensions of ``key``'s array that the placement tag splits over the
    model axis (an entry may be a single axis name or a list of axes)."""
    if not axes:
        return []
    out = []
    for d, entry in enumerate(axes):
        names = entry if isinstance(entry, (list, tuple)) else [entry]
        if any(n == _MODEL_AXIS for n in names if n):
            out.append(d)
    return out


def _local_param_numel(
    bare_keys: Dict[str, Tuple[str, np.ndarray]],
    placement: Dict[str, list],
    model: int,
) -> int:
    """Element count of ONE model shard's parameter tree — the ``raw`` the
    gradient-comm flat spec pads from (``local_param_template`` shapes:
    model-split dimensions divided by the width)."""
    raw = 0
    for key, (mark, arr) in bare_keys.items():
        if not _is_param_key(key) or mark == KEY_MARK:
            continue
        n = int(np.prod(arr.shape, dtype=np.int64)) if arr.ndim else 1
        for d in _model_split_dims(key, placement.get(key)):
            if d >= arr.ndim:
                raise ReshardError(
                    f"parameter leaf {key!r} placement names dimension {d} "
                    f"but the stored array has shape {tuple(arr.shape)}"
                )
            size = int(arr.shape[d])
            if size % model:
                raise ReshardError(
                    f"parameter leaf {key!r} dimension {d} (size {size}) is "
                    f"recorded model-split but does not divide model={model}"
                )
            n //= model
        raw += n
    return raw


def _synth_placement(key: str, arr: np.ndarray, model: int) -> Optional[list]:
    """Placement tag for ``key`` on a model>1 target, from the static rule
    table. None = replicated over the model axis (no tag), matching
    ``derive_topology``'s omission of fully-replicated leaves."""
    if _is_comm_key(key):
        return [[_DATA_AXIS, _MODEL_AXIS]]
    if not (_is_param_key(key) or key.startswith(".opt_state")
            or key.startswith("['opt_state']")):
        return None
    for suffix, axes in TP_PLACEMENT_RULES:
        if key.endswith(suffix):
            if len(axes) != arr.ndim:
                raise ReshardError(
                    f"leaf {key!r} has {arr.ndim} dimensions but the TP "
                    f"placement rule table expects {len(axes)} — layout "
                    "reshape missing or table drift"
                )
            # PartitionSpec drops trailing None entries, so derive_topology
            # records ("model", None) as ["model"] — trim to match the live
            # tags bitwise (the drift test compares dict-equal).
            out = list(axes)
            while out and out[-1] is None:
                out.pop()
            return out
    return None


def _reshape_qkv(key: str, arr: np.ndarray, to_tp: bool) -> np.ndarray:
    """The exact tensor.to_tp_tree/from_tp_tree reshape for one QKV leaf —
    applied to f32 payloads and uint16 bf16 bit views alike (a reshape never
    touches bytes)."""
    if key.endswith(_WQKV_SUFFIX):
        if to_tp:
            if arr.ndim != 2 or arr.shape[1] % 3:
                raise ReshardError(
                    f"leaf {key!r} has shape {arr.shape}; expected canonical "
                    "(E, 3*H*Dh) joined QKV to enter the TP layout"
                )
            return arr.reshape(arr.shape[0], 3, arr.shape[1] // 3)
        if arr.ndim != 3 or arr.shape[1] != 3:
            raise ReshardError(
                f"leaf {key!r} has shape {arr.shape}; expected TP-layout "
                "(E, 3, H*Dh) joined QKV to leave the TP layout"
            )
        return arr.reshape(arr.shape[0], arr.shape[1] * arr.shape[2])
    if key.endswith(_BQKV_SUFFIX):
        if to_tp:
            if arr.ndim != 1 or arr.shape[0] % 3:
                raise ReshardError(
                    f"leaf {key!r} has shape {arr.shape}; expected canonical "
                    "(3*H*Dh,) joined QKV bias to enter the TP layout"
                )
            return arr.reshape(3, arr.shape[0] // 3)
        if arr.ndim != 2 or arr.shape[0] != 3:
            raise ReshardError(
                f"leaf {key!r} has shape {arr.shape}; expected TP-layout "
                "(3, H*Dh) joined QKV bias to leave the TP layout"
            )
        return arr.reshape(arr.shape[0] * arr.shape[1])
    return arr


# ------------------------------------------------------------------ core --


def reshard_arrays(
    stored: Dict[str, np.ndarray],
    data: int,
    model: int,
    path: str = "<memory>",
) -> Tuple[Dict[str, np.ndarray], dict, List[dict]]:
    """Reshape a saved npz payload from its recorded ``(data, model)`` mesh
    onto the target one. Returns ``(new_stored, new_topology, actions)`` —
    ``new_stored`` includes the rewritten ``__topology__`` entry and every
    ``__meta__*`` scalar untouched; ``actions`` is shaped for
    ``checkpoint.build_reshard_events`` (one dict per touched leaf).

    Same-shape targets return the payload unchanged (idempotent), which is
    what makes the W -> W' -> W round-trip byte-comparable."""
    topo = parse_topology(stored)
    if topo is None:
        raise ReshardError(
            f"checkpoint {path} predates the topology record (format v1) and "
            "carries no shard provenance to reshard from; re-save it through "
            "save_on_main (which records format v3) first"
        )
    data, model = int(data), int(model)
    if data < 1 or model < 1:
        raise ReshardError(f"target mesh data={data} model={model} is not a mesh")
    from_data, from_model = topology_shape(topo)
    world = data * model
    actions: List[dict] = []
    if (from_data, from_model) == (data, model):
        return dict(stored), topo, actions

    placement: Dict[str, list] = dict(topo.get("placement") or {})
    leaves: Dict[str, dict] = dict(topo.get("leaves") or {})

    # bare-key view of the payload: {bare: (mark, array)}
    bare: Dict[str, Tuple[str, np.ndarray]] = {}
    passthrough: Dict[str, np.ndarray] = {}
    for k, v in stored.items():
        if k == TOPO_MARK or k.startswith(META_MARK) or k.startswith(CURSOR_MARK):
            # the v4 data cursor (and its accumulator arrays) is bookkeeping,
            # not model state — it passes through unreshaped; restore_latest
            # poisons a resharded cursor's plan key so the loop redoes the
            # epoch instead of skipping wrong batches
            passthrough[k] = v
            continue
        mark, bk = _strip_mark(k)
        bare[bk] = (mark, np.asarray(v))

    # 1. TP<->canonical layout boundary: the QKV reshape (bitwise).
    crossing_down = from_model > 1 and model == 1   # TP layout -> canonical
    crossing_up = from_model == 1 and model > 1     # canonical -> TP layout
    if crossing_down or crossing_up:
        for bk in list(bare):
            mark, arr = bare[bk]
            if mark == KEY_MARK:
                continue
            new = _reshape_qkv(bk, arr, to_tp=crossing_up)
            if new is not arr:
                bare[bk] = (mark, new)
                actions.append({
                    "leaf": bk, "action": "relayout",
                    "from_shape": list(arr.shape), "to_shape": list(new.shape),
                })

    # 2. Placement tags for the target: keep (model>1 -> model>1), drop the
    # model axis (-> model=1), or synthesize from the rule table (model=1 ->
    # model>1). Data-axis-only tags (flat vectors) survive every crossing.
    new_placement: Dict[str, list] = {}
    if model == from_model:
        new_placement = dict(placement)
    elif model == 1:
        for key, axes in placement.items():
            kept = []
            for entry in axes:
                names = entry if isinstance(entry, (list, tuple)) else [entry]
                names = [n for n in names if n and n != _MODEL_AXIS]
                kept.append(
                    None if not names
                    else (names[0] if len(names) == 1 else names)
                )
            if any(a is not None for a in kept):
                new_placement[key] = kept
    else:
        for bk, (mark, arr) in bare.items():
            if mark == KEY_MARK:
                continue
            axes = _synth_placement(bk, arr, model)
            if axes is not None:
                new_placement[bk] = axes

    # 3. Feasibility: every model-split dimension must divide the target
    # width (the shape-level shadow of validate_tp_geometry — heads, d_mlp,
    # vocab divisibility all surface here as a named leaf).
    if model > 1:
        for key, axes in new_placement.items():
            if key not in bare:
                continue
            arr = bare[key][1]
            for d in _model_split_dims(key, axes):
                if d >= arr.ndim or int(arr.shape[d]) % model:
                    raise ReshardError(
                        f"checkpoint {path}: leaf {key!r} dimension {d} "
                        f"(shape {tuple(arr.shape)}) does not divide the "
                        f"target model width {model} — this mesh shape is "
                        "infeasible for the saved architecture"
                    )

    # 4. Shape-dependent flat state: data_flat re-pad, per_replica
    # redistribute/reset.
    new_leaves: Dict[str, dict] = {}
    raw_from = raw_to = None  # lazy: only flat leaves need the param counts
    dropped: List[str] = []
    for key, info in leaves.items():
        if key not in bare:
            continue  # tag for a leaf this payload doesn't carry
        mark, arr = bare[key]
        kind = info.get("kind")
        if kind == "data_flat":
            if model > 1:
                raise ReshardError(
                    f"checkpoint {path}: flat data-axis leaf {key!r} "
                    "(weight-update-sharded moments / auto-mode residual) "
                    "has no tensor-parallel layout — the DDP wrapper refuses "
                    "weight_update_sharding under model>1, so there is no "
                    "model>1 target to reshard onto. Restore at model=1."
                )
            if raw_from is None:
                raw_from = _local_param_numel(bare, placement, from_model)
            if int(arr.shape[0]) != _padded_total(raw_from, from_data * from_model):
                raise ReshardError(
                    f"checkpoint {path}: flat leaf {key!r} has "
                    f"{arr.shape[0]} elements but the recorded topology "
                    f"implies {_padded_total(raw_from, from_data * from_model)} "
                    f"({raw_from} raw padded to a world multiple) — the "
                    "model changed, not just the mesh shape"
                )
            total = _padded_total(raw_from, world)
            if total != int(arr.shape[0]):
                if total < arr.shape[0] and np.any(arr[total:]):
                    raise ReshardError(
                        f"checkpoint {path}: flat leaf {key!r} carries "
                        f"non-zero data past {total} — not world-multiple "
                        "padding"
                    )
                out = np.zeros((total,), arr.dtype)
                keep = min(total, int(arr.shape[0]))
                out[:keep] = arr[:keep]
                bare[key] = (mark, out)
                actions.append({
                    "leaf": key, "action": "repadded",
                    "from_shape": [int(arr.shape[0])], "to_shape": [total],
                })
            new_leaves[key] = dict(info)
        elif kind == "per_replica":
            n_from, per_from = int(info["world"]), int(info["per"])
            if int(arr.shape[0]) != n_from * per_from:
                raise ReshardError(
                    f"checkpoint {path}: per-replica leaf {key!r} has "
                    f"{arr.shape[0]} elements but its topology record says "
                    f"{n_from} x {per_from}"
                )
            if from_model != model:
                # slices key by (data_index, model_index); across model
                # widths they describe unrelated model shards — DROP the
                # leaf, the loader re-zero-initializes from its live
                # template (reset semantics), and the action row makes the
                # discontinuity auditable as a comm_state_reset event.
                del bare[key]
                new_placement.pop(key, None)
                dropped.append(key)
                actions.append({
                    "leaf": key, "action": "reset",
                    "from_world": n_from, "to_world": world,
                    "reason": "error-feedback residual slices key by model "
                    "shard; a model-width change resets them to zero",
                })
                continue
            if raw_from is None:
                raw_from = _local_param_numel(bare, placement, from_model)
            per_to = _padded_total(raw_from, data)
            mat = arr.reshape(from_data, model, per_from)
            if per_from != per_to:
                if per_from > per_to and np.any(mat[:, :, per_to:]):
                    raise ReshardError(
                        f"checkpoint {path}: per-replica leaf {key!r} "
                        f"carries non-zero data past the target per-replica "
                        f"length {per_to} — not world-multiple padding"
                    )
                cols = np.zeros((from_data, model, per_to), arr.dtype)
                keep = min(per_from, per_to)
                cols[:, :, :keep] = mat[:, :, :keep]
                mat = cols
            new_cols = []
            action = "unchanged"
            for m in range(model):
                col, action = redistribute_rows(mat[:, m, :], data)
                new_cols.append(col)
            out = np.stack(new_cols, axis=1).reshape(-1)
            bare[key] = (mark, out)
            new_leaves[key] = {
                "kind": "per_replica", "world": world, "per": per_to,
                "model": model,
            }
            act = {
                "leaf": key, "action": action,
                "from_world": n_from, "to_world": world,
            }
            if action == "reset":
                act["reason"] = (
                    "no divisor relation between data widths; error-feedback "
                    "residual reset to zero"
                )
            if action != "unchanged" or per_from != per_to:
                if action == "unchanged":
                    act["action"] = "repadded"
                actions.append(act)
        else:
            raise ReshardError(
                f"checkpoint {path}: leaf {key!r} has unknown shard tag "
                f"{info!r}"
            )

    # 5. The rewritten topology record.
    new_topo = {
        "format": FORMAT_VERSION,
        "world_size": world,
        "model_size": model,
        "mesh_axes": [_DATA_AXIS, _MODEL_AXIS] if model > 1 else [_DATA_AXIS],
        "mesh_shape": [data, model] if model > 1 else [data],
        "leaves": new_leaves,
        "placement": new_placement,
        "resharded": {
            "from": [from_data, from_model],
            "to": [data, model],
            "dropped": dropped,
        },
    }

    new_stored: Dict[str, np.ndarray] = {}
    for bk, (mark, arr) in bare.items():
        new_stored[mark + bk] = arr
    for k, v in passthrough.items():
        if k != TOPO_MARK:
            new_stored[k] = v
    new_stored[TOPO_MARK] = np.asarray(json.dumps(new_topo))
    return new_stored, new_topo, actions


def _is_state_key(key: str) -> bool:
    """A native parameter's or optimizer moment's key."""
    return key.startswith(".params") or key.startswith(".opt_state")


def qkv_layout(stored: Dict[str, np.ndarray], to_tp: bool) -> Dict[str, np.ndarray]:
    """A native file's arrays with every parameter's and moment's QKV leaf
    in the JAX TP layout (``to_tp``) or the canonical one, byte for byte
    (:func:`_reshape_qkv`); every other entry as it is. A tensor-parallel
    save writes its whole arrays through it, and its restore reads them
    back the other way."""
    out = {}
    for key, arr in stored.items():
        _, bare = _strip_mark(key)
        out[key] = _reshape_qkv(bare, arr, to_tp) if _is_state_key(bare) else arr
    return out


def tp_topology(world_size: int, model: int, payload: Dict[str, np.ndarray],
                residual_per: Optional[int]) -> dict:
    """The topology record of a native tensor-parallel save, as the JAX
    package's ``derive_topology`` writes it for a trained state on a 2-D
    mesh: the widths, the ``per_replica`` residual tagged with the model
    width, and the placement of every split parameter and moment of
    ``payload`` (in the TP layout) from :data:`TP_PLACEMENT_RULES`; for the
    residual ``P(("data", "model"))``, whose data axis of 1 drops out."""
    w, m = int(world_size), int(model)
    placement = {}
    for key, arr in payload.items():
        _, bare = _strip_mark(key)
        axes = _synth_placement(bare, arr, m) if _is_state_key(bare) else None
        if axes:
            placement[bare] = axes
    leaves = {}
    if residual_per is not None:
        leaves[".comm_state"] = {"kind": "per_replica", "world": w, "per": int(residual_per),
                                 "model": m}
        placement[".comm_state"] = [[_DATA_AXIS, _MODEL_AXIS]] if w > m else [_MODEL_AXIS]
    return {"format": FORMAT_VERSION, "world_size": w, "model_size": m,
            "mesh_axes": [_DATA_AXIS, _MODEL_AXIS], "mesh_shape": [w // m, m], "leaves": leaves,
            "placement": placement}


def reshard_checkpoint(src: str, dst: str, data: int, model: int) -> dict:
    """File-level wrapper: load ``src``, reshard onto ``(data, model)``,
    publish ``dst`` atomically (tmp + replace) with a fresh ``.sha256``
    manifest. Returns a report dict (shapes, actions, leaf count) for the
    CLI / gate to print."""
    with np.load(src) as f:
        stored = dict(f.items())
    topo = parse_topology(stored)
    from_shape = topology_shape(topo) if topo else None
    new_stored, new_topo, actions = reshard_arrays(
        stored, data, model, path=src
    )
    tmp = dst + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **new_stored)
    os.replace(tmp, dst)  # atomic publish, same discipline as checkpoint.save
    _integrity().write_manifest(dst)
    return {
        "src": src,
        "dst": dst,
        "from": {"data": from_shape[0], "model": from_shape[1]},
        "to": {"data": data, "model": model},
        "actions": actions,
        "leaves": sum(
            1 for k in new_stored
            if k != TOPO_MARK and not k.startswith(META_MARK)
        ),
    }


def _integrity():
    """The port's checkpoint module, whose ``write_manifest`` publishes the
    ``.sha256`` sidecar (imported here: it imports torch)."""
    from tpuddp_torch.training import checkpoint

    return checkpoint
