"""Tensor-parallel execution over the 2-D ``("data", "model")`` world — the
counterpart of ``tpuddp/parallel/tensor.py``.

The transformer family's partition metadata (``models/transformer.py``:
:data:`~tpuddp_torch.models.transformer.PARTITION_RULES` with the vocabulary
split added, :func:`tp_rules`) becomes a running step, as in the JAX
package (Megatron's f/g pattern):

- **column-split** QKV projection and MLP input: each model rank owns
  ``H/M`` heads and ``F/M`` hidden units, its input replicated;
- **row-split** attention output and MLP output: each rank contracts its
  own slice and the partial outputs are summed over the model group, one
  all-reduce per row-split projection; the replicated bias is added once,
  after the sum;
- **vocabulary-split** embedding and tied head: the lookup is a masked
  local lookup whose cross-rank sum is exact (one rank contributes each
  token's row, the others zeros), and the logits are an exact all-gather
  of each rank's vocabulary columns.

The exchanges are three ``torch.autograd.Function``\\ s over the model group
with their backward written out (:func:`copy_to_tp`, :func:`reduce_from_tp`,
:func:`gather_from_tp`); each counts the collectives it issues
(:data:`counts`, forward and backward apart, a train forward's apart from an
eval's), which ``chip_smoke.py`` reads.

:class:`TensorParallelLM` is one rank's shard of a
:class:`~tpuddp_torch.models.transformer.TransformerLM`: the same module
tree and parameter names, local shapes, and ``forward`` the tensor-parallel
forward (:func:`tp_forward`, the JAX order of operations). Torch's
``nn.Linear`` stores ``(out, in)``, the transpose of the JAX ``(in, out)``,
so the splits land on these axes (:data:`TORCH_SPLITS`):

==========================  ==============================  =====================
parameter                   JAX (TP layout)                 torch
==========================  ==============================  =====================
``attn.in_proj.weight``     ``wqkv (E, 3, HD)``, last axis  rows of ``(3, HD, E)``
``attn.in_proj.bias``       ``bqkv (3, HD)``, last axis     ``(3, HD)``, axis 1
``attn.out_proj.weight``    ``wo``, rows                    columns
``mlp.fc1.weight``/``bias`` ``w1`` columns, ``b1``          rows
``mlp.fc2.weight``          ``w2``, rows                    columns
``embed.weight``            rows (the vocabulary)           rows
==========================  ==============================  =====================

The other parameters (``bo``, ``b2``, the LayerNorms, ``pos``) are
replicated. A local shard raveled in torch's layout, its projections
transposed, is the JAX TP-layout local shard raveled (``(3K, E)`` transposed
is ``(E, 3, K)``): the port's JAX flat order and leaf index apply to a shard
unchanged (:mod:`tpuddp_torch.models.convert`). :func:`local_state_dict`
cuts a rank's shard out of a whole ``state_dict``; :func:`full_state_dict`
joins the shards again, and :func:`gather_params` does it over the model
group.

:func:`to_tp_tree`/:func:`from_tp_tree` are the JAX TP layout's one reshape
(``wqkv (E, 3HD) <-> (E, 3, HD)``, ``bqkv (3HD,) <-> (3, HD)``) on numpy
trees, which the model-sharded checkpoints hold.
"""

from __future__ import annotations

import hashlib
import json
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tpuddp_torch.models.transformer import PARTITION_RULES, TransformerLM
from tpuddp_torch.nn.layers import Embedding, Linear
from tpuddp_torch.nn.norm import LayerNorm
from tpuddp_torch.parallel.mesh2d import MODEL_AXIS


def tp_rules() -> dict:
    """The TP rule set: :data:`PARTITION_RULES` with ``vocab`` split over
    the model axis (``tpuddp/parallel/tensor.py:57-74``)."""
    rules = dict(PARTITION_RULES)
    rules["vocab"] = MODEL_AXIS
    return rules


def tp_rules_hash(rules: Optional[dict] = None) -> str:
    """The rule table's 16-hex-digit hash (the run_meta ``mesh`` block's
    ``tp_rules_hash``), the JAX package's for the same table."""
    rules = tp_rules() if rules is None else rules
    canon = json.dumps({k: rules[k] for k in sorted(rules)}, sort_keys=True)
    return hashlib.sha256(canon.encode()).hexdigest()[:16]


def supports_tp(model) -> bool:
    """Does the model declare the partition metadata the TP layer consumes
    (the transformer family)?"""
    return isinstance(model, TransformerLM)


def validate_tp_geometry(model, model_width: int) -> None:
    """``ValueError`` for a model without partition metadata or a width
    that does not tile its heads, MLP units or vocabulary."""
    if not supports_tp(model):
        raise ValueError(
            f"model {type(model).__name__} declares no partition metadata "
            "(param_logical_axes); tensor parallelism supports the "
            "transformer family — run other models at parallel.model=1"
        )
    for name, dim in (("n_heads", model.n_heads), ("d_mlp", model.d_mlp),
                      ("vocab_size", model.vocab_size)):
        if dim % model_width:
            raise ValueError(
                f"parallel.model={model_width} does not tile the model's "
                f"{name}={dim}; every sharded dimension must split evenly"
            )


# ------------------------------------------------------ layout conversion --

def _map_blocks(params: dict, conv) -> dict:
    def block(b):
        attn = dict(b["attn"])
        attn["wqkv"], attn["bqkv"] = conv(attn["wqkv"], attn["bqkv"])
        return dict(b, attn=attn)

    return dict(params, blocks=tuple(block(b) for b in params["blocks"]))


def to_tp_tree(params: dict) -> dict:
    """Canonical JAX tree -> the TP layout: ``wqkv (E, 3HD) -> (E, 3,
    HD)``, ``bqkv (3HD,) -> (3, HD)``; every other leaf as it is."""
    return _map_blocks(params, lambda w, b: (
        np.reshape(w, (w.shape[0], 3, w.shape[1] // 3)), np.reshape(b, (3, -1))))


def from_tp_tree(tp_params: dict) -> dict:
    """The inverse of :func:`to_tp_tree`, exactly."""
    return _map_blocks(tp_params, lambda w, b: (
        np.reshape(w, (w.shape[0], w.shape[1] * w.shape[2])), np.reshape(b, (-1,))))


def tp_param_specs(model, tp_params: Optional[dict] = None) -> dict:
    """The TP-layout tree's specs (tuples of mesh-axis names, None
    replicated): the model's ``partition_spec`` under :func:`tp_rules`,
    with the two QKV leaves re-spelled for their 3-D/2-D layout."""
    from tpuddp_torch.models.transformer import partition_spec

    spec = partition_spec(model, tp_params, rules=tp_rules())

    def conv(_w, _b):
        return (None, None, MODEL_AXIS), (None, MODEL_AXIS)

    return _map_blocks(spec, conv)


def _local_shape(shape, spec, model_width: int):
    return tuple(s // model_width if a == MODEL_AXIS else s for s, a in zip(shape, spec))


def _spec_leaves(specs: dict):
    """``(path, spec)`` of a spec tree (its leaves are tuples of names)."""
    from tpuddp_torch.models.convert import keystr

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                yield from walk(node[k], path + (k,))
        elif isinstance(node, tuple) and all(n is None or isinstance(n, str) for n in node):
            yield keystr(path), node
        else:
            for i, c in enumerate(node):
                yield from walk(c, path + (i,))

    return list(walk(specs, ()))


def local_param_template(tp_params: dict, specs: dict, model_width: int) -> dict:
    """One model shard's view of the TP tree as float32 zeros: the template
    the gradient comm plan (buckets, byte counts) is built from."""
    from tpuddp_torch.models.convert import keystr, tree_map

    by_path = dict(_spec_leaves(specs))
    return tree_map(lambda path, leaf: np.zeros(
        _local_shape(np.shape(leaf), by_path[keystr(path)], model_width), np.float32), tp_params)


def per_chip_param_bytes(tp_params: dict, specs: dict, model_width: int) -> int:
    """Parameter bytes one rank holds under this sharding."""
    from tpuddp_torch.models.convert import keystr, tree_leaves

    by_path = dict(_spec_leaves(specs))
    total = 0
    for path, leaf in tree_leaves(tp_params):
        shape = _local_shape(np.shape(leaf), by_path[keystr(path)], model_width)
        total += int(np.prod(shape, dtype=np.int64)) * np.dtype(getattr(leaf, "dtype", np.float32)).itemsize
    return total


def opt_state_specs(opt_state: dict, param_specs: dict) -> Dict[str, tuple]:
    """Each optimizer-state leaf's spec by its path (``keystr``): a leaf
    whose path ends with a parameter's path (Adam's ``m``/``v``, a
    momentum) inherits that parameter's spec, anything else (the step) is
    replicated, ``()``. The PATH is the key: ``embed`` and ``pos`` may
    share a shape under different specs."""
    from tpuddp_torch.models.convert import keystr, tree_leaves

    params = _spec_leaves(param_specs)
    out = {}
    for path, _leaf in tree_leaves(opt_state):
        key = keystr(path)
        out[key] = next((spec for ppath, spec in params if key.endswith(ppath)), ())
    return out


# ------------------------------------------------ the torch-layout splits --

# a shard's parameter (by the suffix of its name) -> (the (3, HD, E) QKV
# view, the axis of the split in torch's layout)
TORCH_SPLITS = {
    "attn.in_proj.weight": (True, 1),
    "attn.in_proj.bias": (True, 1),
    "attn.out_proj.weight": (False, 1),
    "mlp.fc1.weight": (False, 0),
    "mlp.fc1.bias": (False, 0),
    "mlp.fc2.weight": (False, 1),
    "embed.weight": (False, 0),
}


def torch_split(name: str):
    """``(qkv, axis)`` of a parameter split over the model axis (its name
    as ``named_parameters`` gives it), None for a replicated one."""
    for suffix, split in TORCH_SPLITS.items():
        if name == suffix or name.endswith("." + suffix):
            return split
    return None


def _qkv_view(t, qkv: bool):
    return t.reshape((3, t.shape[0] // 3) + tuple(t.shape[1:])) if qkv else t


def local_state_dict(full: Dict[str, object], model_index: int, model_width: int) -> dict:
    """Rank ``model_index``'s shard of a whole ``state_dict`` (tensors or
    numpy arrays, torch layout): each split parameter's slice, every other
    entry as it is."""
    out = {}
    for name, t in full.items():
        split = torch_split(name)
        if split is None:
            out[name] = t
            continue
        qkv, axis = split
        v = _qkv_view(t, qkv)
        n = v.shape[axis] // model_width
        index = [slice(None)] * len(v.shape)
        index[axis] = slice(model_index * n, (model_index + 1) * n)
        part = v[tuple(index)]
        part = part.contiguous() if torch.is_tensor(part) else np.ascontiguousarray(part)
        out[name] = part.reshape((-1,) + tuple(t.shape[1:])) if qkv else part
    return out


def full_state_dict(shards: Sequence[Dict[str, object]]) -> dict:
    """The inverse of :func:`local_state_dict`: every model rank's shard, in
    model-index order, joined into the whole ``state_dict``."""
    out = {}
    for name, t in shards[0].items():
        split = torch_split(name)
        if split is None:
            out[name] = t
            continue
        qkv, axis = split
        parts = [_qkv_view(s[name], qkv) for s in shards]
        if torch.is_tensor(t):
            whole = torch.cat(parts, dim=axis)
        else:
            whole = np.concatenate(parts, axis=axis)
        out[name] = whole.reshape((-1,) + tuple(t.shape[1:])) if qkv else whole
    return out


# ------------------------------------- model-axis collectives (explicit AD) --

# collectives issued: (function, "forward" | "eval" | "backward") -> count;
# "forward" is a forward under autograd (a train step's), "eval" one without
counts: Dict[tuple, int] = {}


def reset_counts() -> None:
    counts.clear()


def collectives_issued(kind: Optional[str] = None) -> int:
    """The collectives counted since :func:`reset_counts`, of one kind
    (``"forward"``, ``"eval"``, ``"backward"``) or all."""
    return sum(n for (_, k), n in counts.items() if kind is None or k == kind)


def _count(fn: str, kind: str) -> None:
    counts[(fn, kind)] = counts.get((fn, kind), 0) + 1


def _fwd_kind() -> str:
    return "forward" if torch.is_grad_enabled() else "eval"


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _CopyToTP(torch.autograd.Function):
    """Megatron's ``f``: identity forward, the all-reduce of the cotangent
    over the model group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        _count("copy_to_tp", "backward")
        return _all_reduce(ct, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """Megatron's ``g``: the all-reduce over the model group forward (the
    partial contractions sum to the whole one), identity backward."""

    @staticmethod
    def forward(ctx, x, group, kind):
        _count("reduce_from_tp", kind)
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, ct):
        return ct, None, None


class _GatherFromTP(torch.autograd.Function):
    """The exact last-axis all-gather over the model group forward; this
    rank's columns of the cotangent backward."""

    @staticmethod
    def forward(ctx, x, group, index, kind):
        _count("gather_from_tp", kind)
        ctx.index, ctx.width = index, x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, ct):
        lo = ctx.index * ctx.width
        return ct[..., lo:lo + ctx.width].contiguous(), None, None, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromTP.apply(x, group, _fwd_kind())


def gather_from_tp(x: torch.Tensor, group, index: int) -> torch.Tensor:
    return _GatherFromTP.apply(x, group, int(index), _fwd_kind())


# ----------------------------------------------------------- TP module --

def _block(e: int, k: int, f: int) -> nn.Module:
    """One block's local parameters, the names and order of
    :class:`~tpuddp_torch.models.transformer.Block`."""
    b = nn.Module()
    b.ln1 = LayerNorm(e)
    b.attn = nn.Module()
    b.attn.in_proj = Linear(e, 3 * k)
    b.attn.out_proj = Linear(k, e)
    b.ln2 = LayerNorm(e)
    b.mlp = nn.Module()
    b.mlp.fc1 = Linear(e, f)
    b.mlp.fc2 = Linear(f, e)
    return b


class TensorParallelLM(TransformerLM):
    """Model rank ``mesh.model_index``'s shard of ``full`` (a
    :class:`TransformerLM`), its values cut from ``full`` on ``full``'s
    device; ``forward`` is :func:`tp_forward`. The widths (``vocab_size``,
    ``n_heads``, ``d_mlp``) are the whole model's; ``local_heads`` and the
    local shapes are the shard's. A shard has no serving path (prefill,
    decode step), in either package: the serving engines serve the whole
    model."""

    def __init__(self, full: TransformerLM, mesh):
        nn.Module.__init__(self)
        validate_tp_geometry(full, mesh.model)
        for attr in ("vocab_size", "d_model", "n_heads", "n_layers", "d_mlp", "max_seq_len",
                     "head_dim"):
            setattr(self, attr, getattr(full, attr))
        self.mesh = mesh
        m = mesh.model
        self.local_heads = self.n_heads // m
        e, k = self.d_model, self.local_heads * self.head_dim
        with torch.device("meta"):  # no random draw: every value comes from full
            self.embed = Embedding(self.vocab_size // m, e)
            self.pos = Embedding(self.max_seq_len, e)
            self.blocks = nn.ModuleList(_block(e, k, self.d_mlp // m) for _ in range(self.n_layers))
            self.ln_f = LayerNorm(e)
        device = full.embed.weight.device
        self.to_empty(device=device)
        with torch.no_grad():
            sd = {k_: v.detach() for k_, v in full.state_dict().items()}
            self.load_state_dict(local_state_dict(sd, mesh.model_index, m))

    def reset_parameters(self, generator=None) -> None:
        raise NotImplementedError("a tensor-parallel shard takes its values from the whole model")

    # the checkpoint's hooks (training/checkpoint.py): a shard saves as the
    # whole model and restores its own part of it
    def whole_meta(self) -> TransformerLM:
        """The whole model on the meta device (its names and shapes)."""
        with torch.device("meta"):
            return TransformerLM(self.vocab_size, self.d_model, self.n_heads, self.n_layers,
                                 self.d_mlp, self.max_seq_len)

    def gather_whole(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The whole tensors of ``tensors`` keyed by parameter name (the
        state_dict, a moment), on every model rank: a collective of the
        model group."""
        return gather_named(tensors, self.mesh)

    def cut(self, whole: Dict[str, object]) -> dict:
        """This rank's shard of a whole ``state_dict`` (tensors or arrays)."""
        return local_state_dict(whole, self.mesh.model_index, self.mesh.model)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return tp_forward(self, tokens)

    def prefill(self, *args, **kwargs):
        raise NotImplementedError(
            "a tensor-parallel shard has no prefill or decode step: the serving engines "
            "(tpuddp_torch.serving), as the JAX package's, serve the whole model on each "
            "replica's device; reshape the checkpoint to model=1 "
            "(tpuddp_torch.training.reshard.reshard_checkpoint) and serve that")

    decode_step = prefill


def tp_forward(model: TensorParallelLM, tokens: torch.Tensor) -> torch.Tensor:
    """The tensor-parallel causal forward of one rank's shard
    (``tpuddp/parallel/tensor.py:350-398``): ``(B, T)`` int tokens (this
    data replica's, the same on every model rank) -> the whole ``(B, T, V)``
    logits, the vocabulary columns gathered exactly. The lookup sums every
    rank's masked local rows; each block adds its replicated output bias
    once, after the sum of the row-split partials."""
    b, t = tokens.shape
    if t > model.max_seq_len:
        raise ValueError(f"sequence length {t} exceeds max_seq_len={model.max_seq_len}")
    group, index = model.mesh.model_group, model.mesh.model_index
    v_local = model.embed.weight.shape[0]
    local = tokens.long() - index * v_local
    mine = (local >= 0) & (local < v_local)
    rows = model.embed(local.clamp(0, v_local - 1))
    h = reduce_from_tp(torch.where(mine[..., None], rows, torch.zeros_like(rows)), group) \
        + model.pos.weight[:t]
    mask = model._causal(t, tokens.device)
    scale = 1.0 / math.sqrt(model.head_dim)
    for blk in model.blocks:
        a = copy_to_tp(blk.ln1(h), group)
        qkv = blk.attn.in_proj(a).reshape(b, t, 3, model.local_heads, model.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        attn = model._softmax(scores, mask[None, None], h.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, t, -1)
        part = F.linear(o, blk.attn.out_proj.weight)  # this rank's heads' rows
        h = h + reduce_from_tp(part, group) + blk.attn.out_proj.bias
        c = copy_to_tp(blk.ln2(h), group)
        m = F.linear(F.gelu(blk.mlp.fc1(c)), blk.mlp.fc2.weight)
        h = h + reduce_from_tp(m, group) + blk.mlp.fc2.bias
    h = copy_to_tp(model.ln_f(h), group)
    return gather_from_tp(h @ model.embed.weight.T, group, index)


# ------------------------------------------------------------ gathering --

@torch.no_grad()
def gather_params(model: TensorParallelLM) -> Dict[str, torch.Tensor]:
    """The whole model's ``state_dict`` (torch layout) from every model
    rank's shard, on every rank of the model group (a collective of it)."""
    group, m = model.mesh.model_group, model.mesh.model
    local = {k: v.detach() for k, v in model.state_dict().items()}
    return full_state_dict(_gather_shards(local, group, m))


def _gather_shards(local: dict, group, m: int) -> List[dict]:
    """Every model rank's copy of ``local``'s split entries (the others as
    they are), in model-index order."""
    shards = [dict(local) for _ in range(m)]
    for name, t in local.items():
        if torch_split(name) is None:
            continue
        parts = [torch.empty_like(t) for _ in range(m)]
        dist.all_gather(parts, t.contiguous(), group=group)
        for s, p in zip(shards, parts):
            s[name] = p
    return shards


def gather_named(tensors: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """:func:`gather_params` for any tensors keyed by parameter name (the
    optimizer's moments): the whole tensors, on every model rank."""
    return full_state_dict(_gather_shards(tensors, mesh.model_group, mesh.model))
