"""The decoder-only transformer family — the counterpart of
``tpuddp/models/transformer.py`` (``transformer_tiny``, ``transformer_small``).

Learned token and position embeddings, pre-LayerNorm blocks of causal
multi-head attention (one joined QKV projection) and an exact-erf GELU MLP,
a final LayerNorm, and an LM head tied to the token embedding (logits =
h @ embed.weight.T, no head matrix). The module layout is the ``state_dict``
that ``tpuddp/models/torch_import.py:429-444`` documents: ``embed``,
``pos``, ``blocks.{i}.{ln1, attn.in_proj, attn.out_proj, ln2, mlp.fc1,
mlp.fc2}``, ``ln_f``, with no ``head``; so a torch checkpoint of that layout
loads as it is. ``in_proj`` packs ``[q; k; v]`` row blocks, each ``(H, Dh)``
head-major, as the JAX ``wqkv`` packs them column-wise.

Attention is written as the JAX block math writes it: scores by einsum,
divided by ``sqrt(Dh)``, masked with the finite fill ``-1e30`` and
softmaxed in float32. Not ``F.scaled_dot_product_attention``: its fully
masked rows are NaN where this fill gives finite values (a padded prefill
row, an inactive decode slot), and its rounding is a library's.

Three entry points share the per-block helpers, as the JAX model's do:

- ``forward(tokens)``: the full causal forward, ``(B, T)`` int tokens ->
  ``(B, T, V)`` logits (training and eval);
- :meth:`TransformerLM.prefill`: one prompt's forward at a padded length,
  committing its K/V to the paged pools, the last real position's logits;
- :meth:`TransformerLM.decode_step`: the fixed-shape one-token step of
  every slot through its block table (capturable in a CUDA graph).

The pools are ``(layers, blocks, block_size, H, Dh)`` tensors; both serving
entry points write them in place and return them. Block 0 is the garbage
block that padded and inactive positions write to.

:data:`PARTITION_RULES`, :func:`param_logical_axes` and
:func:`partition_spec` are the JAX package's tensor-parallel metadata over
its parameter tree (mesh-axis names as plain tuples: there is no
``PartitionSpec`` without JAX); :func:`prefill_buckets` its prompt-length
ladder. This is plain PyTorch; the JAX model has no Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpuddp_torch.nn.layers import Embedding, Linear
from tpuddp_torch.nn.norm import LayerNorm
from tpuddp_torch.utils import batching

# which mesh axis each LOGICAL parameter axis shards over (None: replicated)
PARTITION_RULES = {
    "batch": None,
    "heads": "model",
    "embed": None,
    "mlp": "model",
    "joined_kv": "model",
    "kv": None,
    "seq": None,
    "vocab": None,
}

_NEG_INF = -1e30  # masked-score fill: finite, so fully masked rows stay NaN-free


def _uniform_(linear: nn.Linear, generator: Optional[torch.Generator]) -> None:
    """The JAX init of a projection: weight U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    bias 0."""
    if linear.weight.is_meta:
        return
    bound = 1.0 / math.sqrt(linear.in_features)
    with torch.no_grad():
        linear.weight.uniform_(-bound, bound, generator=generator)
        linear.bias.zero_()


class Attention(nn.Module):
    """The joined QKV projection ``in_proj`` (E -> 3E) and ``out_proj``."""

    def __init__(self, d_model: int, device=None):
        super().__init__()
        self.in_proj = Linear(d_model, 3 * d_model, device=device)
        self.out_proj = Linear(d_model, d_model, device=device)


class MLP(nn.Module):
    """``fc1`` (E -> F), exact GELU, ``fc2`` (F -> E)."""

    def __init__(self, d_model: int, d_mlp: int, device=None):
        super().__init__()
        self.fc1 = Linear(d_model, d_mlp, device=device)
        self.fc2 = Linear(d_mlp, d_model, device=device)


class Block(nn.Module):
    """One pre-LN block's parameters: ``ln1``, ``attn``, ``ln2``, ``mlp``."""

    def __init__(self, d_model: int, d_mlp: int, device=None):
        super().__init__()
        self.ln1 = LayerNorm(d_model, device=device)
        self.attn = Attention(d_model, device=device)
        self.ln2 = LayerNorm(d_model, device=device)
        self.mlp = MLP(d_model, d_mlp, device=device)


class TransformerLM(nn.Module):
    """Decoder-only LM. ``num_classes`` aliases ``vocab_size`` (the label
    space of a token model is its vocabulary), so ``load_model(name,
    num_classes)`` applies as for the image models. Initialised with the
    JAX laws (``tpuddp/models/transformer.py:101-146``): embeddings
    N(0, 0.02), projections fan-in uniform with zero biases, LayerNorms
    ones and zeros, drawn from ``generator`` when given (else torch's
    global stream)."""

    def __init__(
        self,
        num_classes: int = 256,
        d_model: int = 64,
        n_heads: int = 4,
        n_layers: int = 2,
        d_mlp: Optional[int] = None,
        max_seq_len: int = 128,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model={d_model} not divisible by n_heads={n_heads}")
        self.vocab_size = int(num_classes)
        self.d_model = int(d_model)
        self.n_heads = int(n_heads)
        self.n_layers = int(n_layers)
        self.d_mlp = int(d_mlp) if d_mlp is not None else 4 * self.d_model
        self.max_seq_len = int(max_seq_len)
        self.head_dim = self.d_model // self.n_heads
        self.embed = Embedding(self.vocab_size, self.d_model, device=device)
        self.pos = Embedding(self.max_seq_len, self.d_model, device=device)
        self.blocks = nn.ModuleList(
            Block(self.d_model, self.d_mlp, device=device) for _ in range(self.n_layers))
        self.ln_f = LayerNorm(self.d_model, device=device)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.embed.weight.is_meta:
            return
        with torch.no_grad():
            for table in (self.embed, self.pos):
                table.weight.normal_(0.0, 0.02, generator=generator)
        for block in self.blocks:
            for linear in (block.attn.in_proj, block.attn.out_proj, block.mlp.fc1, block.mlp.fc2):
                _uniform_(linear, generator)

    # ----------------------------------------------------------- block math --
    def _qkv(self, attn: Attention, a: torch.Tensor):
        """``a (..., E) -> q, k, v (..., H, Dh)`` through the joined
        projection."""
        qkv = attn.in_proj(a).reshape(a.shape[:-1] + (3, self.n_heads, self.head_dim))
        return qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]

    @staticmethod
    def _attn_out(attn: Attention, o: torch.Tensor) -> torch.Tensor:
        """``o (..., H, Dh) -> (..., E)`` through the output projection."""
        return attn.out_proj(o.reshape(o.shape[:-2] + (-1,)))

    @staticmethod
    def _mlp(mlp: MLP, a: torch.Tensor) -> torch.Tensor:
        return mlp.fc2(F.gelu(mlp.fc1(a)))  # exact (erf) GELU

    @staticmethod
    def _softmax(scores: torch.Tensor, mask: torch.Tensor, dtype) -> torch.Tensor:
        scores = scores.masked_fill(~mask, _NEG_INF)
        return torch.softmax(scores.float(), dim=-1).to(dtype)

    def _block_full(self, block: Block, h: torch.Tensor, mask: torch.Tensor):
        """One block over a full ``(B, T, E)`` sequence: the new hidden and
        this layer's K/V ``(B, T, H, Dh)`` (the prefill path's cache feed)."""
        q, k, v = self._qkv(block.attn, block.ln1(h))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(self.head_dim)
        attn = self._softmax(scores, mask[None, None], h.dtype)
        h = h + self._attn_out(block.attn, torch.einsum("bhqk,bkhd->bqhd", attn, v))
        return h + self._mlp(block.mlp, block.ln2(h)), (k, v)

    def _embed(self, tokens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        return self.embed(tokens) + pos

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        h = self.ln_f(h)
        return h @ self.embed.weight.to(h.dtype).T

    @staticmethod
    def _causal(n: int, device) -> torch.Tensor:
        return torch.ones((n, n), dtype=torch.bool, device=device).tril()

    # ---------------------------------------------------------- full forward --
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """``(B, T)`` int tokens -> ``(B, T, V)`` logits; ``ValueError`` past
        ``max_seq_len``."""
        _, t = tokens.shape
        if t > self.max_seq_len:
            raise ValueError(f"sequence length {t} exceeds max_seq_len={self.max_seq_len}")
        h = self._embed(tokens, self.pos.weight[:t])
        mask = self._causal(t, tokens.device)
        for block in self.blocks:
            h, _ = self._block_full(block, h, mask)
        return self._logits(h)

    # -------------------------------------------------------------- serving --
    @torch.no_grad()
    def prefill(self, kpool: torch.Tensor, vpool: torch.Tensor, table_row: torch.Tensor,
                tokens: torch.Tensor, length):
        """One prompt's bucketed forward and its paged-pool commit
        (``tpuddp/models/transformer.py:203-232``).

        ``tokens``: ``(1, P)`` ints, the prompt zero-padded to its bucket
        ``P``; ``length``: the true prompt length (an int or a 0-d tensor);
        ``table_row``: ``(max_blocks,)`` pool-block ids of this sequence.
        Position ``p < length`` writes its K/V at ``(table_row[p // BS],
        p % BS)`` of each layer's pools; pad positions go to garbage block
        0. Returns ``(logits (V,) of position length - 1, kpool, vpool)``,
        the pools written in place."""
        p_len = tokens.shape[1]
        bs, mb = kpool.shape[2], table_row.shape[0]
        device = tokens.device
        pos = torch.arange(p_len, device=device)
        length = torch.as_tensor(length, device=device).long()
        row = table_row.long()[(pos // bs).clamp(max=mb - 1)]
        dest_blk = torch.where(pos < length, row, torch.zeros_like(row))
        dest_off = pos % bs
        h = self._embed(tokens.long(), self.pos.weight[:p_len])
        mask = self._causal(p_len, device)
        for li, block in enumerate(self.blocks):
            h, (k, v) = self._block_full(block, h, mask)
            kpool[li, dest_blk, dest_off] = k[0].to(kpool.dtype)
            vpool[li, dest_blk, dest_off] = v[0].to(vpool.dtype)
        h_last = h[0].index_select(0, (length - 1).reshape(1))[0]
        return self._logits(h_last), kpool, vpool

    @torch.no_grad()
    def decode_step(self, kpool: torch.Tensor, vpool: torch.Tensor, tables: torch.Tensor,
                    lengths: torch.Tensor, tokens: torch.Tensor):
        """The fixed-shape one-token step (``tpuddp/models/transformer.py:
        234-274``).

        ``tokens (S,)``: each slot's last sampled token; ``lengths (S,)``:
        tokens already committed per slot (the new token's position, below
        ``MB * BS``); ``tables (S, MB)``: per-slot block tables. Every slot
        writes its new K/V at ``(table[length // BS], length % BS)`` (an
        inactive slot, all-zero table and length 0, writes to garbage block
        0), attends over positions ``0 .. length`` of its table's blocks and
        returns its next-token logits ``(S, V)``, with the pools written in
        place: ``(logits, kpool, vpool)``. No host sync and one shape for any
        occupancy, so the step can be captured in a CUDA graph."""
        s, mb = tables.shape
        bs = kpool.shape[2]
        tables, lengths = tables.long(), lengths.long()
        ctx_pos = torch.arange(mb * bs, device=tables.device)
        x = self._embed(tokens.long(), self.pos.weight[lengths])
        blk = tables.gather(1, (lengths // bs)[:, None])[:, 0]
        off = lengths % bs
        mask = ctx_pos[None, :] <= lengths[:, None]  # (S, MB*BS)
        shape = (s, mb * bs, self.n_heads, self.head_dim)
        for li, block in enumerate(self.blocks):
            q, k, v = self._qkv(block.attn, block.ln1(x))  # (S, H, Dh)
            kpool[li, blk, off] = k.to(kpool.dtype)
            vpool[li, blk, off] = v.to(vpool.dtype)
            # each slot's context through its block table; positions past
            # its length read stale or garbage blocks and are masked
            kctx = kpool[li][tables].reshape(shape).to(x.dtype)
            vctx = vpool[li][tables].reshape(shape).to(x.dtype)
            scores = torch.einsum("shd,skhd->shk", q, kctx) / math.sqrt(self.head_dim)
            attn = self._softmax(scores, mask[:, None, :], x.dtype)
            x = x + self._attn_out(block.attn, torch.einsum("shk,skhd->shd", attn, vctx))
            x = x + self._mlp(block.mlp, block.ln2(x))
        return self._logits(x), kpool, vpool


# ----------------------------------------------------- partition metadata --


def param_logical_axes(model: TransformerLM, params=None) -> dict:
    """The JAX parameter tree's shape (``{"blocks": (...), "embed", "ln_f",
    "pos"}``, ``params``' blocks or the model's layers) with each leaf a
    tuple of LOGICAL axis names, as ``tpuddp/models/transformer.py:280-308``
    gives it."""
    ln = {"scale": ("embed",), "bias": ("embed",)}
    block = {
        "ln1": dict(ln),
        "attn": {
            "wqkv": ("embed", "joined_kv"),
            "bqkv": ("joined_kv",),
            "wo": ("heads", "embed"),
            "bo": ("embed",),
        },
        "ln2": dict(ln),
        "mlp": {
            "w1": ("embed", "mlp"),
            "b1": ("mlp",),
            "w2": ("mlp", "embed"),
            "b2": ("embed",),
        },
    }
    n_blocks = model.n_layers if params is None else len(params["blocks"])
    return {
        "embed": {"weight": ("vocab", "embed")},
        "pos": {"weight": ("seq", "embed")},
        "blocks": tuple(dict(block) for _ in range(n_blocks)),
        "ln_f": dict(ln),
    }


def partition_spec(model: TransformerLM, params=None, rules=None) -> dict:
    """Every parameter's logical axes through the rule table: the same tree
    with each leaf a tuple of MESH axis names (``wqkv`` -> ``(None,
    "model")``, ``w2`` -> ``("model", None)``)."""
    rules = dict(PARTITION_RULES if rules is None else rules)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if all(isinstance(n, str) for n in node):
            return tuple(rules[n] for n in node)
        return tuple(walk(c) for c in node)

    return walk(param_logical_axes(model, params))


def prefill_buckets(max_prompt_len: int):
    """The power-of-two prompt-length ladder: at most ``log2(max) + 1``
    prefill shapes (:func:`tpuddp_torch.utils.batching.bucket_sizes`)."""
    return batching.bucket_sizes(max_prompt_len)
