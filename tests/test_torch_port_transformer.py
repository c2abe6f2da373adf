"""The port's transformer family against the JAX package's, on the CPU.

A small model (V 32, E 16, 4 heads, 2 layers, 24 positions, as
tests/test_transformer.py) with the JAX package's own init, carried into the
port by the converter; inputs made by numpy from a seed:

- ``forward`` against the JAX ``apply``; causality, the tied head, batch
  rows that do not see each other;
- ``prefill``'s last-position logits against the JAX full forward (not the
  JAX prefill bitwise: its own test holds it to that and is red), its pool
  writes against the JAX prefill's; ``decode_step``'s logits and pools
  against the JAX ``decode_step`` for 3 slots, one inactive; greedy prefill
  plus 5 steps equal to greedy decoding by repeated full forwards;
- the partition metadata and the prefill ladder the JAX package's;
- ``Embedding`` and ``LayerNorm`` against the JAX layers;
- the registry's widths; the weight bridge (JAX -> port -> JAX bitwise, the
  JAX leaf order and keys) and ``convert_transformer_state_dict`` (the JAX
  converter's arrays and refusals on one test-built torch state dict);
- the cross-entropy of rank-3 logits against the JAX package's, with and
  without weights, all-zero weights, every reduction; rank 2 bitwise the
  formula it had before token batches.

Tolerances: rtol 1e-4 / atol 1e-5 (PERF.md section 2); everything else
bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpuddp import nn as jax_nn
from tpuddp.models import TransformerLM as JaxTransformerLM
from tpuddp.models import load_model as jax_load_model
from tpuddp.models import transformer as jax_tf
from tpuddp.models.torch_import import convert_transformer_state_dict as jax_convert
from tpuddp.nn.core import Context
from tpuddp.nn.loss import cross_entropy as jax_cross_entropy

from tpuddp_torch.models import TRANSFORMERS, TransformerLM, load_model
from tpuddp_torch.models import transformer as tf
from tpuddp_torch.models.convert import (
    jax_from_state_dict, jax_leaf_index, jax_paths, keystr, model_name, state_dict_from_jax,
    tree_leaves,
)
from tpuddp_torch.models.pretrained import convert_transformer_state_dict
from tpuddp_torch.nn.layers import Embedding
from tpuddp_torch.nn.loss import cross_entropy
from tpuddp_torch.nn.norm import LayerNorm

V, E, H, L, T = 32, 16, 4, 2, 24
RTOL, ATOL = 1e-4, 1e-5
CTX = Context(train=False)


@pytest.fixture(scope="module")
def jax_model():
    return JaxTransformerLM(num_classes=V, d_model=E, n_heads=H, n_layers=L, max_seq_len=T)


@pytest.fixture(scope="module")
def params(jax_model):
    p, state = jax_model.init(jax.random.key(0), jnp.zeros((1, 2), jnp.int32))
    assert state == ()
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def model(params):
    torch.set_num_threads(2)
    m = TransformerLM(num_classes=V, d_model=E, n_heads=H, n_layers=L, max_seq_len=T)
    m.load_state_dict(state_dict_from_jax("transformer", params))
    return m.eval()


def _tokens(seed, b, t):
    return np.random.default_rng(seed).integers(0, V, (b, t)).astype(np.int32)


def _fwd(model, toks):
    with torch.no_grad():
        return model(torch.from_numpy(toks)).numpy()


# ----------------------------------------------------------------- forward --

@pytest.mark.parametrize("shape", [(3, 7), (2, T)])
def test_forward_matches_the_jax_apply(jax_model, params, model, shape):
    toks = _tokens(10, *shape)
    got = _fwd(model, toks)
    want, state = jax_model.apply(params, (), jnp.asarray(toks), CTX)
    assert got.shape == shape + (V,) and got.dtype == np.float32 and state == ()
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_forward_refuses_an_overlong_sequence(model):
    with pytest.raises(ValueError, match="max_seq_len"):
        model(torch.zeros((1, T + 1), dtype=torch.int32))


def test_the_causal_mask_hides_future_positions(model):
    toks = _tokens(11, 1, 10)
    edited = toks.copy()
    edited[0, 6:] = (edited[0, 6:] + 7) % V
    a, b = _fwd(model, toks), _fwd(model, edited)
    np.testing.assert_array_equal(a[0, :6], b[0, :6])
    assert not np.array_equal(a[0, 6:], b[0, 6:])


def test_the_head_is_the_embedding_table(model):
    """No head matrix; a vocabulary row absent from the input reaches only
    the logits: zeroed, its logit column is exactly 0."""
    assert not any("head" in k for k in model.state_dict())
    toks = np.array([[1, 2, 3, 4, 5]], np.int32)
    m = TransformerLM(num_classes=V, d_model=E, n_heads=H, n_layers=L, max_seq_len=T)
    m.load_state_dict(model.state_dict())
    with torch.no_grad():
        m.embed.weight[9] = 0.0
    logits = _fwd(m, toks)
    assert np.all(logits[..., 9] == 0.0) and np.all(logits[..., 8] != 0.0)


def test_batch_rows_do_not_see_each_other(model):
    toks = _tokens(12, 4, 8)
    full, solo = _fwd(model, toks), _fwd(model, toks[1:2])
    np.testing.assert_allclose(full[1], solo[0], rtol=1e-6, atol=1e-7)
    edited = toks.copy()
    edited[[0, 2, 3]] = (edited[[0, 2, 3]] + 5) % V
    np.testing.assert_array_equal(_fwd(model, edited)[1], full[1])


# ------------------------------------------------------- prefill and decode --

def _pools(num_blocks=16, block_size=4, seed=None):
    shape = (L, num_blocks, block_size, H, E // H)
    if seed is None:
        return np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_prefill_matches_the_jax_full_forward(jax_model, params, model):
    """The last real position's logits against the JAX ``apply`` of the
    unpadded prompt; the pool writes (every block but garbage block 0)
    against the JAX prefill's."""
    n, p_len = 5, 8
    prompt = _tokens(13, 1, n)
    buf = np.zeros((1, p_len), np.int32)
    buf[0, :n] = prompt[0]
    row = np.array([1, 2, 3, 0, 0, 0], np.int32)
    kp, vp = _pools()
    last, kpool, vpool = model.prefill(*_t(kp, vp, row, buf), n)
    want, _ = jax_model.apply(params, (), jnp.asarray(prompt), CTX)
    np.testing.assert_allclose(last.numpy(), np.asarray(want[0, n - 1]), rtol=RTOL, atol=ATOL)
    _, jk, jv = jax_model.prefill(params, jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(row),
                                  jnp.asarray(buf), jnp.asarray(n, jnp.int32))
    for got, ref in ((kpool, jk), (vpool, jv)):
        np.testing.assert_allclose(got.numpy()[:, 1:], np.asarray(ref)[:, 1:], rtol=RTOL, atol=ATOL)
    assert np.any(kpool.numpy()[:, 1:3] != 0.0)


def test_decode_step_matches_the_jax_decode_step(jax_model, params, model):
    """3 slots over random pools: slot 0 at length 6 through blocks 3 and 5,
    slot 1 inactive (all-zero table, length 0), slot 2 at length 9 through
    blocks 1, 2 and 7. Logits and the written pools (in place) against the
    JAX step's."""
    kp, vp = _pools(seed=14)
    tables = np.array([[3, 5, 0], [0, 0, 0], [1, 2, 7]], np.int32)
    lengths = np.array([6, 0, 9], np.int32)
    toks = np.array([4, 0, 17], np.int32)
    kpool, vpool, tt, lt, xt = _t(kp, vp, tables, lengths, toks)
    logits, k_out, v_out = model.decode_step(kpool, vpool, tt, lt, xt)
    assert k_out is kpool and v_out is vpool
    want, jk, jv = jax_model.decode_step(params, jnp.asarray(kp), jnp.asarray(vp),
                                         jnp.asarray(tables), jnp.asarray(lengths),
                                         jnp.asarray(toks))
    assert np.all(np.isfinite(logits.numpy()))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(kpool.numpy(), np.asarray(jk), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(vpool.numpy(), np.asarray(jv), rtol=RTOL, atol=ATOL)
    assert not np.array_equal(kpool.numpy(), kp)


def test_greedy_prefill_and_steps_equal_repeated_full_forwards(model):
    """tests/test_transformer.py:126-169 on the port: the sequence in slot
    1 of 3, a prompt of 4 at bucket 8, blocks of 4, then 5 steps."""
    n, steps, slots, bs = 4, 5, 3, 4
    prompt = _tokens(15, 1, n)
    kpool, vpool = _t(*_pools(block_size=bs))
    tables = np.zeros((slots, 6), np.int32)
    tables[1, :3] = [4, 5, 6]
    lengths = np.zeros(slots, np.int32)
    buf = np.zeros((1, 8), np.int32)
    buf[0, :n] = prompt[0]
    last, kpool, vpool = model.prefill(kpool, vpool, torch.from_numpy(tables[1]),
                                       torch.from_numpy(buf), n)
    lengths[1] = n
    got = [int(last.argmax())]
    for _ in range(steps):
        toks = np.zeros(slots, np.int32)
        toks[1] = got[-1]
        logits, kpool, vpool = model.decode_step(kpool, vpool, *_t(tables, lengths, toks))
        lengths[1] += 1
        got.append(int(logits[1].argmax()))
    seq, ref = list(prompt[0]), []
    for _ in range(steps + 1):
        tok = int(_fwd(model, np.array([seq], np.int32))[0, -1].argmax())
        ref.append(tok)
        seq.append(tok)
    assert got == ref


# ----------------------------------------------------- partition metadata --

def test_partition_metadata_and_buckets_are_the_jax_packages(jax_model, params, model):
    assert tf.PARTITION_RULES == jax_tf.PARTITION_RULES
    assert tf.param_logical_axes(model) == jax_tf.param_logical_axes(jax_model, params)
    assert tf.param_logical_axes(model, params) == jax_tf.param_logical_axes(jax_model, params)
    assert tf.partition_spec(model) == jax_tf.partition_spec(jax_model, params)
    alt = {**jax_tf.PARTITION_RULES, "mlp": "x"}
    assert tf.partition_spec(model, rules=alt) == jax_tf.partition_spec(jax_model, params, rules=alt)
    for n in (1, 7, 63, 64, 256):
        assert tf.prefill_buckets(n) == jax_tf.prefill_buckets(n)
    with pytest.raises(ValueError):
        tf.prefill_buckets(0)


# ------------------------------------------------------------------ layers --

def test_embedding_and_layernorm_match_the_jax_layers():
    torch.set_num_threads(2)
    rng = np.random.default_rng(16)
    emb = Embedding(11, 5, generator=torch.Generator().manual_seed(0))
    assert emb.weight.shape == (11, 5) and abs(float(emb.weight.detach().std()) - 1.0) < 0.5
    ids = rng.integers(0, 11, (3, 4)).astype(np.int32)
    want, _ = jax_nn.Embedding(11, 5).apply({"weight": emb.weight.detach().numpy()}, (),
                                             jnp.asarray(ids), CTX)
    np.testing.assert_array_equal(emb(torch.from_numpy(ids)).detach().numpy(), np.asarray(want))
    ln = LayerNorm(6)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(rng.standard_normal(6).astype(np.float32)))
        ln.bias.copy_(torch.from_numpy(rng.standard_normal(6).astype(np.float32)))
    x = (rng.standard_normal((4, 3, 6)) * 3 + 1).astype(np.float32)
    jparams = {"scale": ln.weight.detach().numpy(), "bias": ln.bias.detach().numpy()}
    want, state = jax_nn.LayerNorm().apply(jparams, (), jnp.asarray(x), CTX)
    np.testing.assert_allclose(ln(torch.from_numpy(x)).detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    xb = torch.from_numpy(x).bfloat16()
    assert ln(xb).dtype == torch.bfloat16 and not list(ln.buffers()) and state == ()


# ---------------------------------------------------------------- registry --

@pytest.mark.parametrize("name", sorted(TRANSFORMERS))
def test_the_registry_builds_the_jax_widths(name):
    want = jax_load_model(name, num_classes=256)
    got = load_model(name, 256)
    assert isinstance(got, TransformerLM) and model_name(got) == "transformer"
    for attr in ("vocab_size", "d_model", "n_heads", "n_layers", "d_mlp", "max_seq_len", "head_dim"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert load_model(name, 7, max_seq_len=32).pos.weight.shape == (32, want.d_model)
    with pytest.raises(ValueError, match="divisible"):
        TransformerLM(d_model=10, n_heads=3)


# -------------------------------------------------------------- the bridge --

def test_the_bridge_round_trips_bitwise_in_the_jax_leaf_order(params, model):
    back, mstate = jax_from_state_dict("transformer", model.state_dict())
    assert mstate == ()
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    want = [jax.tree_util.keystr(p) for p, _ in flat]
    assert [keystr(p) for p, _ in tree_leaves(params)] == want
    index, paths = jax_leaf_index("transformer_tiny", model), jax_paths("transformer", model)
    assert sorted(index.values()) == list(range(len(want))) == list(range(12 * L + 4))
    for pname, p in model.named_parameters():
        path, leaf = flat[index[pname]]
        assert keystr(paths[pname]) == jax.tree_util.keystr(path), pname
        assert p.numel() == leaf.size, pname
    assert want[:4] == [f"['blocks'][0]['attn']['{k}']" for k in ("bo", "bqkv", "wo", "wqkv")]
    assert want[-4:] == ["['embed']['weight']", "['ln_f']['bias']", "['ln_f']['scale']",
                         "['pos']['weight']"]
    with pytest.raises(ValueError, match="no weight bridge"):
        state_dict_from_jax("transformer_tiny", (params["embed"],))


def test_the_flat_order_and_the_bucket_plan_are_the_jax_packages(params, model):
    """The port's flat parameter vector in the JAX order (ZeRO-1's file
    layout, the comm hooks' exchange) is the JAX tree's leaves raveled and
    concatenated, bitwise, and the hooks' bucket plan over the JAX leaf
    sizes is the JAX package's."""
    from tpuddp.parallel import comm as jax_comm

    from tpuddp_torch.models.convert import JaxFlatOrder, flat_from_jax, flat_to_jax, jax_sizes
    from tpuddp_torch.parallel import comm

    want = np.concatenate([np.ravel(leaf) for leaf in jax.tree_util.tree_leaves(params)])
    port = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    np.testing.assert_array_equal(flat_to_jax("transformer", model, port.numpy()), want)
    np.testing.assert_array_equal(JaxFlatOrder("transformer", model).to_jax(port).numpy(), want)
    np.testing.assert_array_equal(flat_from_jax("transformer", model, want), port.numpy())
    for cap in (0.01, 25.0):
        plan = comm.make_grad_comm(jax_sizes("transformer", model), 2, "int8_ef", cap)
        assert plan.buckets == jax_comm.make_grad_comm(params, 2, "int8_ef", cap).buckets


def _torch_state_dict(seed, width=E, blocks=L):
    """A torch checkpoint of the documented layout, built here."""
    m = TransformerLM(num_classes=V, d_model=width, n_heads=H, n_layers=blocks, max_seq_len=T,
                      generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():  # biases and norms away from their init values
        for name, p in m.named_parameters():
            if p.dim() == 1:
                p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(len(name))))
    return m.state_dict()


def test_convert_transformer_state_dict_is_the_jax_converters(params):
    sd = _torch_state_dict(3)
    got = convert_transformer_state_dict(sd, params)
    want = jax_convert(sd, params)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)), got, want)
    port = TransformerLM(num_classes=V, d_model=E, n_heads=H, n_layers=L, max_seq_len=T)
    port.load_state_dict(sd)  # the port's own layout: loads as it is
    for k, v in state_dict_from_jax("transformer", got).items():
        assert torch.equal(v, port.state_dict()[k]), k


@pytest.mark.parametrize("case", ["untied head", "wrong geometry", "missing block", "extra block"])
def test_convert_transformer_state_dict_refuses_as_the_jax_converter(params, case):
    sd = dict(_torch_state_dict(4))
    if case == "untied head":
        sd["head.weight"] = torch.zeros(V, E)
    elif case == "wrong geometry":
        sd = _torch_state_dict(4, width=2 * E)
    elif case == "missing block":
        sd = _torch_state_dict(4, blocks=L - 1)
    else:
        sd = _torch_state_dict(4, blocks=L + 1)
    errors = []
    for fn in (convert_transformer_state_dict, jax_convert):
        with pytest.raises((ValueError, KeyError)) as info:
            fn(sd, params)
        errors.append((info.type, str(info.value)))
    assert errors[0] == errors[1]


# ------------------------------------------------------------------- loss --

def _loss_inputs(seed, weights):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((3, 5, V)) * 2).astype(np.float32)
    labels = rng.integers(0, V, (3, 5)).astype(np.int32)
    w = {"none": None, "mask": (rng.random((3, 5)) > 0.3).astype(np.float32),
         "zero": np.zeros((3, 5), np.float32)}[weights]
    return logits, labels, w


@pytest.mark.parametrize("weights", ["none", "mask", "zero"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_token_cross_entropy_matches_the_jax_loss(weights, reduction):
    logits, labels, w = _loss_inputs(17, weights)
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        None if w is None else torch.from_numpy(w), reduction)
    want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), reduction,
                             None if w is None else jnp.asarray(w))
    assert tuple(got.shape) == np.shape(want) == ((15,) if reduction == "none" else ())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    if weights == "zero" and reduction == "mean":
        assert float(got) == 0.0


@pytest.mark.parametrize("weights", ["none", "mask", "zero"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_the_rank_2_loss_is_bitwise_what_it_was(weights, reduction):
    logits, labels, w = _loss_inputs(18, weights)
    logits, labels = torch.from_numpy(logits.reshape(15, V)), torch.from_numpy(labels.reshape(15))
    w = None if w is None else torch.from_numpy(w.reshape(15))
    losses = F.cross_entropy(logits.float(), labels.long(), reduction="none")
    if w is not None:
        losses = losses * w
    before = {"none": losses, "sum": losses.sum(),
              "mean": losses.mean() if w is None else
              losses.sum() / torch.where(w.sum() == 0, torch.ones_like(w.sum()), w.sum())}
    assert torch.equal(cross_entropy(logits, labels, w, reduction), before[reduction])
