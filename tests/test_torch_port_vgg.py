"""The port's VGGs (``tpuddp_torch/models/vgg.py``), its adaptive pool
(``tpuddp_torch/nn/layers.py::AdaptiveAvgPool2d``) and the weight bridge on
the VGG layouts, against the JAX package's ``tpuddp/models/vgg.py`` and
``tpuddp/nn/layers.py``, on the CPU:

- the pool's values and gradients at 1->7, 2->7, 3->7, 7->7, 13->6 and
  14->7, float32 and bfloat16; identity bins bitwise;
- the plan table and its index helpers equal to the JAX package's;
- per name (``vgg_tests``; this file holds ``vgg11``, one file per other
  name): the bridge round trip of the JAX tree bitwise with torchvision's
  keys, eval logits at 32 px (``vgg11`` also at 64 and 224 px, and the JAX
  package's torchvision converter on its ``state_dict``),
  ``jax_leaf_index`` in ``jax.tree_util``'s order, ``jax_layer_sizes`` the
  JAX children (30 / 34 / 40 / 46), ``comm_overlap_meta`` and the segments
  of the JAX wrap at bucket_cap_mb 25 and 5; for ``vgg11`` the flat orders.

Tolerances: float32 values and gradients rtol 1e-4 / atol 1e-5 (PERF.md
section 2: sums in another order by two libraries); bfloat16 within 2^-6
of the largest value; bridge, orders, sizes and plans exact.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuddp import optim as jax_optim
from tpuddp.models import load_model as jax_load_model
from tpuddp.models import vgg as jax_vgg
from tpuddp.models.torch_import import convert_vgg_state_dict
from tpuddp.nn import CrossEntropyLoss as JaxCrossEntropyLoss
from tpuddp.nn.core import Context
from tpuddp.nn.layers import AdaptiveAvgPool2d as JaxAdaptiveAvgPool2d
from tpuddp.parallel import comm as jax_comm
from tpuddp.parallel import make_mesh
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP

from tpuddp_torch.models import VGG, VGG_NAMES, TransformerLM, load_model
from tpuddp_torch.models import vgg
from tpuddp_torch.models.convert import (
    flat_from_jax, flat_to_jax, jax_from_state_dict, jax_layer_sizes, jax_leaf_index,
    jax_param_span, jax_sizes, keystr, model_name, state_dict_from_jax, tree_leaves,
)
from tpuddp_torch.nn import CrossEntropyLoss
from tpuddp_torch.nn.layers import AdaptiveAvgPool2d
from tpuddp_torch.optim import Adam
from tpuddp_torch.parallel import comm
from tpuddp_torch.parallel.ddp import DistributedDataParallel

RTOL, ATOL = 1e-4, 1e-5
BF16_REL = 2.0 ** -6
HW, BATCH = 32, 2
# name -> (the JAX Sequential's children, parameter leaves, parameters)
COUNTS = {
    "vgg11": (30, 22, 128_807_306), "vgg13": (34, 26, 128_991_818),
    "vgg16": (40, 32, 134_301_514), "vgg19": (46, 38, 139_611_210),
}
# (name, bucket_cap_mb) -> (buckets, the JAX plan's segments by child), world 1
PLANS = {
    ("vgg11", 25.0): (6, [(0, 26), (26, 29), (29, 30)]),
    ("vgg11", 5.0): (12, [(0, 16), (16, 18), (18, 23), (23, 26), (26, 29), (29, 30)]),
    ("vgg16", 25.0): (7, [(0, 36), (36, 39), (39, 40)]),
    ("vgg16", 5.0): (17, [(0, 21), (21, 24), (24, 26), (26, 28), (28, 33), (33, 36), (36, 39),
                          (39, 40)]),
    ("vgg19", 25.0): (8, [(0, 42), (42, 45), (45, 46)]),
    ("vgg19", 5.0): (21, [(0, 23), (23, 25), (25, 28), (28, 30), (30, 32), (32, 34), (34, 39),
                          (39, 42), (42, 45), (45, 46)]),
}
POOLS = [(1, 7), (2, 7), (3, 7), (7, 7), (13, 6), (14, 7)]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------------ pool --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_in,n_out", POOLS)
def test_adaptive_pool_matches_the_jax_layer(n_in, n_out, dtype):
    """Values and the gradient of ``sum(pool(x) * r)``; the JAX layer pools
    in float32 and casts back, and so does the port's. At identity bins
    both return the input, and the gradient is ``r``, bitwise."""
    rng = np.random.RandomState(n_in * 10 + n_out)
    w_in = n_in if n_in == n_out else n_in + 1  # NCHW, non-square but at identity bins
    x32 = rng.randn(2, 3, n_in, w_in).astype(np.float32)
    r32 = rng.randn(2, 3, n_out, n_out).astype(np.float32)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(x32).to(tdt).requires_grad_(True)
    r = torch.from_numpy(r32).to(tdt)
    layer = AdaptiveAvgPool2d(n_out)
    y = layer(x)
    (y * r).sum().backward()
    assert y.dtype == tdt and y.shape == (2, 3, n_out, n_out)

    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(x32.transpose(0, 2, 3, 1)).astype(jdt)
    rj = jnp.asarray(r32.transpose(0, 2, 3, 1)).astype(jdt)
    pool = lambda v: JaxAdaptiveAvgPool2d(n_out).apply((), (), v, Context(train=False))[0]
    yj, vjp = jax.vjp(pool, xj)
    (gj,) = vjp(rj)
    want_y = np.asarray(yj.astype(jnp.float32)).transpose(0, 3, 1, 2)
    want_g = np.asarray(gj.astype(jnp.float32)).transpose(0, 3, 1, 2)
    got_y, got_g = y.detach().float().numpy(), x.grad.float().numpy()
    if n_in == n_out:
        assert torch.equal(y, x)
        np.testing.assert_array_equal(got_y, want_y)
        np.testing.assert_array_equal(got_g, want_g)
    elif dtype == "float32":
        np.testing.assert_allclose(got_y, want_y, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got_g, want_g, rtol=RTOL, atol=ATOL)
    else:
        for got, want in ((got_y, want_y), (got_g, want_g)):
            assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()


def test_adaptive_pool_repeats_one_cell_into_every_bin():
    """1 -> 7 (a VGG at 32 px): every bin is the one input, bitwise, as in
    the JAX layer's integral image; the gradient is the sum of the 49."""
    x = torch.randn(4, 5, 1, 1, requires_grad=True)
    y = AdaptiveAvgPool2d((7, 7))(x)
    assert torch.equal(y, x.expand(4, 5, 7, 7))
    y.sum().backward()
    assert torch.equal(x.grad, torch.full_like(x, 49.0))


# -------------------------------------------------------------- registry --

@pytest.mark.parametrize("name", VGG_NAMES)
def test_the_plan_table_and_its_indices_are_the_jax_packages(name):
    assert vgg.VGG_PLANS[name] == jax_vgg.VGG_PLANS[name]
    assert vgg.vgg_conv_indices(name) == jax_vgg.vgg_conv_indices(name)
    assert vgg.vgg_classifier_linear_indices(name) == jax_vgg.vgg_classifier_linear_indices(name)
    with torch.device("meta"):
        model = load_model(name, 7, dropout=0.3)
    assert isinstance(model, VGG) and model_name(model) == name
    assert model.classifier[6].out_features == 7
    assert [m.p for m in model.classifier if isinstance(m, torch.nn.Dropout)] == [0.3, 0.3]
    convs = [i for i, m in enumerate(model.features) if isinstance(m, torch.nn.Conv2d)]
    assert tuple(convs) == vgg.vgg_conv_indices(name)
    assert len(model.features) + 9 == COUNTS[name][0]  # + the pool, flatten and classifier


def test_the_registry_lists_the_vggs_and_refuses_the_transformers():
    assert sorted(VGG_NAMES) == sorted(n for n in jax_vgg.VGG_PLANS)
    for name in ("transformer_tiny", "transformer_small"):
        want = jax_load_model(name, num_classes=10)
        model = load_model(name, 10)
        assert isinstance(model, TransformerLM)
        assert [getattr(model, k) for k in ("vocab_size", "d_model", "n_heads", "n_layers",
                                            "max_seq_len")] == [
            getattr(want, k) for k in ("vocab_size", "d_model", "n_heads", "n_layers", "max_seq_len")]
    with pytest.raises(ValueError, match="vgg11, vgg13, vgg16, vgg19"):
        load_model("vgg15", 10)


# ---------------------------------------------------------- per VGG name --

@lru_cache(maxsize=None)
def _jax_init(name):
    """The JAX model and a parameter tree of its ``init``'s structure and
    shapes, drawn by numpy under the JAX init's law, U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) per layer (the JAX package's own init of 130 M
    parameters takes 10 s on the CPU); the seed differs by name."""
    jax_model = jax_load_model(name, 10)
    shapes, mstate = jax.eval_shape(jax_model.init, jax.random.key(0), jnp.zeros((1, HW, HW, 3)))
    rng = np.random.default_rng(VGG_NAMES.index(name))

    def draw(layer):
        if not layer:
            return ()
        bound = 1.0 / np.sqrt(np.prod(layer["weight"].shape[:-1]))
        return {k: rng.uniform(-bound, bound, v.shape).astype(np.float32) for k, v in sorted(layer.items())}

    return jax_model, tuple(draw(layer) for layer in shapes), mstate


def _port(name):
    """The port's model holding the JAX tree, in eval mode."""
    _, params, _ = _jax_init(name)
    with torch.device("meta"):
        model = load_model(name, 10)
    model.load_state_dict(state_dict_from_jax(name, params), assign=True)
    return model.eval()


def _jax_leaves(name):
    params = _jax_init(name)[1]
    return params, [(jax.tree_util.keystr(path), leaf.shape)
                    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]]


def vgg_tests(name):
    """The parity tests of one VGG, for a test module's namespace: each
    module takes one name, so that each initialises only its own model
    (tests/test_torch_port_vgg{13,16,19}.py)."""

    def test_the_bridge_round_trips_the_jax_tree_bitwise():
        _, params, mstate = _jax_init(name)
        model = _port(name)
        sd = state_dict_from_jax(name, params, mstate)
        assert list(sd) == list(model.state_dict())  # torchvision's keys, in its order
        convs = [f"features.{i}" for i in vgg.vgg_conv_indices(name)]
        assert [k.rsplit(".", 1)[0] for k in sd][::2] == convs + [
            "classifier.0", "classifier.3", "classifier.6"]
        back_p, back_s = jax_from_state_dict(name, model.state_dict())
        assert jax.tree_util.tree_structure(back_p) == jax.tree_util.tree_structure(params)
        assert all(s == () for s in back_s) and len(back_s) == COUNTS[name][0]
        for (path, a), (bpath, b) in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                                         tree_leaves(back_p)):
            assert jax.tree_util.keystr(path) == keystr(bpath)
            assert a.dtype == b.dtype and np.array_equal(a, b), keystr(bpath)

    def test_the_jax_torchvision_converter_reads_the_port_state_dict():
        """The port's keys and layouts are torchvision's: the JAX package's
        own converter (``convert_vgg_state_dict``) takes the port's
        ``state_dict`` into the same tree, bitwise, the first classifier
        Linear's (c, h, w) input order included."""
        _, params, _ = _jax_init(name)
        sd = {k: v.numpy() for k, v in _port(name).state_dict().items()}
        got = convert_vgg_state_dict(name, sd, params)
        for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(got)):
            np.testing.assert_array_equal(a, np.asarray(b))

    def test_eval_logits_match_jax():
        torch.set_num_threads(2)
        jax_model, params, mstate = _jax_init(name)
        x = np.random.RandomState(1).randn(BATCH, HW, HW, 3).astype(np.float32)
        with torch.no_grad():
            got = _port(name)(torch.from_numpy(x)).numpy()
        ref, _ = jax_model.apply(params, mstate, jnp.asarray(x), Context(train=False))
        assert got.shape == (BATCH, 10)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)

    def test_jax_leaf_index_is_the_jax_flatten_order():
        with torch.device("meta"):
            model = load_model(name, 10)
        _, leaves = _jax_leaves(name)
        index = jax_leaf_index(name, model)
        assert sorted(index.values()) == list(range(len(leaves))) and len(leaves) == COUNTS[name][1]
        for pname, p in model.named_parameters():
            path, shape = leaves[index[pname]]
            assert path.endswith(f"['{pname.rsplit('.', 1)[1]}']"), (pname, path)
            assert sorted(shape) == sorted(p.shape), (pname, path)
        assert sum(p.numel() for p in model.parameters()) == COUNTS[name][2]
        sizes = [int(np.prod(shape)) for _, shape in leaves]
        assert list(jax_sizes(name, model)) == sizes

    def test_jax_layer_sizes_are_the_jax_childrens():
        with torch.device("meta"):
            model = load_model(name, 10)
        params, _ = _jax_leaves(name)
        want = tuple(sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(child))
                     for child in params)
        assert jax_layer_sizes(name, model) == want and len(want) == COUNTS[name][0]
        for child in range(len(want)):
            jax_param_span(name, model, (child, child + 1))

    def test_comm_overlap_meta_is_the_jax_wraps(cpu_devices):
        for (plan_name, cap), (n_buckets, segments) in PLANS.items():
            if plan_name != name:
                continue
            torch.manual_seed(0)
            with torch.device("meta"):
                meta_model = load_model(name, 10)
            sizes = jax_sizes(name, meta_model)
            total = sum(sizes)
            buckets = comm.make_buckets(sizes, total, cap)
            layers = jax_layer_sizes(name, meta_model)
            segs = comm.make_segments(layers, buckets, total)
            assert len(buckets) == n_buckets and [s.layers for s in segs] == segments
            assert [tuple(s) for s in segs] == [tuple(s) for s in jax_comm.make_segments(
                layers, jax_comm.make_buckets(sizes, total, cap), total)]
            model = _port(name)
            ours = DistributedDataParallel(model, Adam(model.parameters(), lr=1e-3),
                                           CrossEntropyLoss(), device="cpu", bucket_cap_mb=cap)
            jax_ddp = JaxDDP(jax_load_model(name, 10), jax_optim.Adam(1e-3), JaxCrossEntropyLoss(),
                             mesh=make_mesh(cpu_devices[:1]), bucket_cap_mb=cap)
            _, params, mstate = _jax_init(name)
            jax_ddp.init_state(jax.random.key(0), jnp.zeros((1, HW, HW, 3)), params=params,
                               model_state=mstate)
            assert ours.comm_overlap_meta == jax_ddp.comm_overlap_meta
            assert ours.comm_overlap_meta == {"enabled": True, "segments": len(segments), "reason": None}
            assert [s.layers for s in ours._overlap.segments] == segments
            del ours, jax_ddp, model

    tests = [test_the_bridge_round_trips_the_jax_tree_bitwise, test_eval_logits_match_jax,
             test_jax_leaf_index_is_the_jax_flatten_order, test_jax_layer_sizes_are_the_jax_childrens]
    if name == "vgg11":  # the layout is generated alike for every plan
        tests.append(test_the_jax_torchvision_converter_reads_the_port_state_dict)
    if any(plan_name == name for plan_name, _ in PLANS):
        tests.append(test_comm_overlap_meta_is_the_jax_wraps)
    return {f.__name__: f for f in tests}


globals().update(vgg_tests("vgg11"))


@pytest.mark.parametrize("hw", [64, 224])
def test_vgg11_eval_logits_match_jax_at_larger_inputs(hw):
    """At 64 px the features end at 2x2 (ragged 2->7 bins that overlap), at
    224 px at 7x7 (identity bins)."""
    torch.set_num_threads(2)
    jax_model, params, mstate = _jax_init("vgg11")
    x = np.random.RandomState(hw).randn(BATCH, hw, hw, 3).astype(np.float32)
    with torch.no_grad():
        got = _port("vgg11")(torch.from_numpy(x)).numpy()
    ref, _ = jax_model.apply(params, mstate, jnp.asarray(x), Context(train=False))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_vgg11_flat_orders_are_inverse_and_the_jax_flat_order():
    """``flat_to_jax``/``flat_from_jax`` (ZeRO-1's layout) over vgg11's
    128,807,306 elements, as int32 element indices: inverse of each other,
    and the JAX tree's leaves raveled in ``jax.tree_util``'s order."""
    with torch.device("meta"):
        model = load_model("vgg11", 10)
    n = sum(p.numel() for p in model.parameters())
    port = np.arange(n, dtype=np.int32)
    to_jax = flat_to_jax("vgg11", model, port)
    np.testing.assert_array_equal(flat_from_jax("vgg11", model, to_jax), port)
    arrays, offset = {}, 0
    for pname, p in model.named_parameters():
        arrays[pname] = port[offset:offset + p.numel()].reshape(tuple(p.shape))
        offset += p.numel()
    params, _ = jax_from_state_dict("vgg11", arrays)
    leaves = jax.tree_util.tree_leaves(params)
    assert [leaf.shape for leaf in leaves] == [shape for _, shape in _jax_leaves("vgg11")[1]]
    np.testing.assert_array_equal(to_jax, np.concatenate([np.ravel(leaf) for leaf in leaves]))


def test_bf16_compute_gives_bf16_logits_within_the_bf16_bound():
    """``compute_dtype: bfloat16``: every conv and Linear in bf16 with its
    float32 master cast per call, the pool in float32 cast back, against
    the JAX model on the same bf16 input (within 2^-6 of the largest
    logit)."""
    torch.set_num_threads(2)
    jax_model, params, mstate = _jax_init("vgg11")
    x = np.random.RandomState(3).randn(BATCH, HW, HW, 3).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    with torch.no_grad():
        got = _port("vgg11")(xb)
    assert got.dtype == torch.bfloat16
    ref, _ = jax_model.apply(params, mstate, jnp.asarray(x).astype(jnp.bfloat16), Context(train=False))
    ref = np.asarray(ref.astype(jnp.float32))
    assert np.abs(got.float().numpy() - ref).max() <= BF16_REL * np.abs(ref).max()
