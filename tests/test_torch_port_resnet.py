"""The port's ResNets (``tpuddp_torch/models/resnet.py``) and the weight
bridge on their nested parameter trees, against the JAX package's
``tpuddp/models/resnet.py``, on the CPU, for every registry name: five
depths, each with the full stem, the ``_small`` CIFAR stem and the ``_s2d``
stem.

- the bridge: the JAX init through ``state_dict_from_jax`` and back through
  ``jax_from_state_dict`` bitwise, with the JAX tree's structure and
  torchvision's keys; the JAX package's own torchvision converter reads the
  port's ``state_dict`` as the same tree;
- eval logits and one gradient against ``jax.grad`` (``resnet18_small``,
  ``resnet50``): tests/test_torch_port_resnet_eval.py; a train-mode forward
  (output and updated running statistics) at batch 2:
  tests/test_torch_port_resnet_bn.py and ``_bn_deep.py`` (this file holds
  the helpers they share);
- ``jax_leaf_index`` equal to ``tree_flatten_with_path`` order;
  ``flat_to_jax``/``flat_from_jax`` inverse bitwise and the JAX flat order;
  ``jax_layer_sizes`` the JAX per-child sizes;
- ``comm_overlap_meta`` equal to the JAX wrap's at bucket_cap_mb 25 and 5,
  with the segments of the JAX plan;
- the ``small_input`` + ``space_to_depth`` ``ValueError``.

Tolerances: logits, running statistics and gradients rtol 1e-4 / atol
1e-5 (PERF.md section 2: float32 convolutions and sums in another order by
two libraries), or, where a train-mode forward is ill-conditioned in the
JAX package itself (BatchNorm over 2 values), within 4 times the JAX
package's own move from an init one ulp higher; bridge, orders, sizes and
plans exact.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuddp import optim as jax_optim
from tpuddp.models import load_model as jax_load_model
from tpuddp.models import resnet as jax_resnet
from tpuddp.models.torch_import import (
    convert_resnet_basic_state_dict, convert_resnet_bottleneck_state_dict,
)
from tpuddp.nn import CrossEntropyLoss as JaxCrossEntropyLoss
from tpuddp.nn.core import Context
from tpuddp.nn.loss import cross_entropy as jax_cross_entropy
from tpuddp.parallel import comm as jax_comm
from tpuddp.parallel import make_mesh
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP

from tpuddp_torch.models import RESNET_NAMES, ResNet, load_model
from tpuddp_torch.models.convert import (
    flat_from_jax, flat_to_jax, jax_from_state_dict, jax_layer_sizes, jax_leaf_index,
    jax_param_span, jax_sizes, keystr, model_name, state_dict_from_jax, tree_leaves,
)
from tpuddp_torch.models.resnet import Bottleneck, resnet
from tpuddp_torch.nn import CrossEntropyLoss
from tpuddp_torch.nn.layers import SpaceToDepthConv2d
from tpuddp_torch.nn.norm import BatchNorm, batch_weights
from tpuddp_torch.optim import Adam
from tpuddp_torch.parallel import comm
from tpuddp_torch.parallel.ddp import DistributedDataParallel

RTOL, ATOL = 1e-4, 1e-5
SPREAD = 4
HW, BATCH = 32, 2
# name -> (the JAX Sequential's children, parameter leaves, parameters)
COUNTS = {"resnet18_small": (13, 62, 11_173_962), "resnet50": (22, 161, 23_528_522)}
# (name, bucket_cap_mb) -> the JAX plan's segments by child, at world 1
SEGMENTS = {
    ("resnet18_small", 25.0): [(0, 13)],
    ("resnet18_small", 5.0): [(0, 12), (12, 13)],
    ("resnet50", 25.0): [(0, 22)],
    ("resnet50", 5.0): [(0, 18), (18, 22)],
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@lru_cache(maxsize=None)
def _jax_init(name):
    """The JAX model and its own init at 32 px (numpy leaves); the seed
    differs by name."""
    jax_model = jax_load_model(name, 10)
    params, mstate = jax_model.init(jax.random.key(RESNET_NAMES.index(name)),
                                    jnp.zeros((1, HW, HW, 3)))
    return jax_model, _np_tree(params), _np_tree(mstate)


def _port(name, train=False):
    """The port's model holding the JAX init, params and statistics."""
    _, params, mstate = _jax_init(name)
    model = load_model(name, 10)
    model.load_state_dict(state_dict_from_jax(name, params, mstate))
    return model.train(train)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(BATCH, HW, HW, 3).astype(np.float32)
    return x, rng.randint(0, 10, BATCH), np.ones(BATCH, np.float32)


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL, err_msg=err_msg)


def test_small_input_with_space_to_depth_is_the_jax_value_error():
    with pytest.raises(ValueError) as ours:
        ResNet((2, 2, 2, 2), small_input=True, space_to_depth=True)
    with pytest.raises(ValueError) as theirs:
        jax_resnet.ResNet18(small_input=True, space_to_depth=True)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("name", RESNET_NAMES)
def test_registry_layouts(name):
    with torch.device("meta"):
        model, synced = load_model(name, 7), resnet(name, sync_bn=True)
    base = name.replace("_s2d", "")
    assert model_name(model) == base
    assert isinstance(model.conv1, SpaceToDepthConv2d) == name.endswith("_s2d")
    assert (model.maxpool is None) == name.endswith("_small")
    assert model.fc.out_features == 7
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    assert all(not m.sync for m in norms)
    assert all(m.sync for m in synced.modules() if isinstance(m, BatchNorm))
    bn_layers = {"resnet18": 20, "resnet34": 36, "resnet50": 53, "resnet101": 104, "resnet152": 155}
    assert len(norms) == bn_layers[base.replace("_small", "")]


# ------------------------------------------------------ forward, gradient --

def _ulp_up(tree):
    return jax.tree_util.tree_map(lambda p: np.nextafter(p, np.inf).astype(p.dtype), tree)


def _within(got, ref, spread, err_msg, per_tensor=True):
    """``got`` within rtol/atol of ``ref``, or, where the JAX package's own
    result moves by more than that (``spread``: between its eager and its
    jitted run, or from an init one ulp higher), within SPREAD times that
    move (the rule of tests/test_torch_port_comm_gloo.py). ``per_tensor``:
    only where this tensor's own move exceeds the tolerance somewhere; a
    whole training run that is chaotic in the JAX package passes False."""
    got, ref, spread = (np.asarray(a, np.float64) for a in (got, ref, spread))
    err = np.abs(got - ref)
    if np.all(err <= ATOL + RTOL * np.abs(ref)):
        return
    assert not per_tensor or np.any(spread > ATOL + RTOL * np.abs(ref)), (err_msg, float(err.max()))
    assert err.max() <= SPREAD * spread.max(), (err_msg, float(err.max()), float(spread.max()))


def _jax_runs(fn, params):
    """``fn(params)`` eagerly, jitted, and at an init one ulp higher: the
    reference and the JAX package's own spread (elementwise, the larger
    move), as numpy trees."""
    ref = _np_tree(fn(params))
    runs = [_np_tree(jax.jit(fn)(params)), _np_tree(fn(_ulp_up(params)))]
    spread = jax.tree_util.tree_map(
        lambda r, *others: np.max([np.abs(o - r) for o in others], axis=0), ref, *runs)
    return ref, spread


def _children(model):
    """The port's modules (and functions) that compute the JAX
    ``Sequential``'s children, in order."""
    stem = [model.conv1, model.bn1, torch.relu] + ([model.maxpool] if model.maxpool else [])
    blocks = [b for stage in (model.layer1, model.layer2, model.layer3, model.layer4)
              for b in stage]
    return stem + blocks + [lambda h: h.mean((2, 3)), model.fc]


def _nhwc(a):
    return a.transpose(0, 2, 3, 1) if a.ndim == 4 else a


def _jax_leaves(name):
    """The JAX tree of ``name`` and its leaves' ``(keystr path, shape)``
    in ``jax.tree_util``'s order."""
    params = _jax_init(name)[1]
    return params, [(jax.tree_util.keystr(path), leaf.shape)
                    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]]


# ---------------------------------------------- per depth, every stem --

def depth_tests(base):
    """The parity tests of one depth's three registry names (``base``,
    ``base_small``, ``base_s2d``), for a test module's namespace: each
    module takes one depth, so that each initialises only its own models
    (tests/test_torch_port_resnet{34,50,101,152}.py)."""
    names = [f"{base}{stem}" for stem in ("", "_small", "_s2d")]

    @pytest.mark.parametrize("name", names)
    def test_the_bridge_round_trips_the_jax_init_bitwise(name):
        torch.set_num_threads(2)
        _, params, mstate = _jax_init(name)
        model = _port(name)
        sd = state_dict_from_jax(name, params, mstate)
        assert list(sd) == list(model.state_dict())  # torchvision's keys, in its order
        assert all(tuple(sd[k].shape) == tuple(v.shape) for k, v in model.state_dict().items())
        back_p, back_s = jax_from_state_dict(name, model.state_dict())
        for ref, back in ((params, back_p), (mstate, back_s)):
            assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(ref)
            for (path, a), (bpath, b) in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                                             tree_leaves(back)):
                assert jax.tree_util.keystr(path) == keystr(bpath)
                assert a.dtype == b.dtype and np.array_equal(a, b), keystr(bpath)
        # parameters alone (a moment or gradient tree): the params, no statistics
        alone_p, alone_s = jax_from_state_dict(name, dict(model.named_parameters()))
        assert jax.tree_util.tree_structure(alone_p) == jax.tree_util.tree_structure(params)
        assert all(s == () for s in alone_s)
        assert set(state_dict_from_jax(name, params)) == {n for n, _ in model.named_parameters()}

    @pytest.mark.parametrize("name", [base])
    def test_the_jax_torchvision_converter_reads_the_port_state_dict(name):
        """The port's keys are torchvision's: the JAX package's own converter
        (``tpuddp/models/torch_import.py``) takes the port's ``state_dict``
        into the same tree, bitwise."""
        _, params, mstate = _jax_init(name)
        model = _port(name)
        convert = (convert_resnet_bottleneck_state_dict if isinstance(model.layer1[0], Bottleneck)
                   else convert_resnet_basic_state_dict)
        sd = {k: v.numpy() for k, v in model.state_dict().items()}
        got_p, got_s = convert(sd, params, mstate, depths=model.depths)
        for ref, got in ((params, got_p), (mstate, got_s)):
            for a, b in zip(jax.tree_util.tree_leaves(ref), jax.tree_util.tree_leaves(got)):
                np.testing.assert_array_equal(a, np.asarray(b))

    @pytest.mark.parametrize("name", names)
    def test_eval_logits_match_jax(name):
        torch.set_num_threads(2)
        jax_model, params, mstate = _jax_init(name)
        x, _, _ = _batch(1)
        with torch.no_grad():
            got = _port(name)(torch.from_numpy(x)).numpy()
        ref, _ = jax_model.apply(params, mstate, jnp.asarray(x), Context(train=False))
        assert got.shape == (BATCH, 10)
        _close(got, ref)

    @pytest.mark.parametrize("name", names)
    def test_train_forward_and_running_statistics_match_jax(name):
        """A train-mode forward of 2 rows, at 32 px with the CIFAR stem and 64
        px with the full stem: at 32 px the full stem leaves 1x1 maps in
        ``layer4``, where each BatchNorm normalises 2 values per channel and
        ``E[x^2] - mean^2`` (both packages' one-pass variance) cancels, so the
        JAX package's own logits move by up to 1.5 between its eager and jitted
        runs. The updated running statistics child by child of the JAX
        ``Sequential``, each child from the port's own input to it (rtol 1e-4,
        atol 1e-5); the logits whole, within SPREAD times the JAX package's own
        move where that is wider than the tolerance (a train-mode forward
        carries each child's rounding through every later batch statistic: 33
        and 50 blocks in the 101- and 152-layer nets)."""
        torch.set_num_threads(2)
        jax_model, params, mstate = _jax_init(name)
        hw = HW if name.endswith("_small") else 2 * HW
        x = np.random.RandomState(2).randn(BATCH, hw, hw, 3).astype(np.float32)
        w = np.ones(BATCH, np.float32)
        model = _port(name, train=True)
        ctx = Context(train=True, sample_weight=jnp.asarray(w))
        h, new_state = torch.from_numpy(x).permute(0, 3, 1, 2), list(mstate)
        with batch_weights(model, torch.from_numpy(w)), torch.no_grad():
            for k, child in enumerate(_children(model)):
                _, new_state[k] = jax_model.layers[k].apply(
                    params[k], mstate[k], jnp.asarray(_nhwc(h.numpy())), ctx)
                h = child(h)
        want = state_dict_from_jax(name, params, _np_tree(tuple(new_state)))
        for key, buf in model.named_buffers():
            _close(buf.numpy(), want[key].numpy(), key)
        ref, spread = _jax_runs(lambda p: jax_model.apply(p, mstate, jnp.asarray(x), ctx)[0], params)
        _within(h.numpy(), ref, spread, "logits")

    @pytest.mark.parametrize("name", names)
    def test_jax_leaf_index_is_the_jax_flatten_order(name):
        with torch.device("meta"):
            model = load_model(name, 10)
        _, leaves = _jax_leaves(name)
        index = jax_leaf_index(name, model)
        assert sorted(index.values()) == list(range(len(leaves)))
        for pname, p in model.named_parameters():
            path, shape = leaves[index[pname]]
            key = pname.rsplit(".", 1)[1]
            if key == "weight" and isinstance(model.get_submodule(pname.rsplit(".", 1)[0]), BatchNorm):
                key = "scale"
            assert path.endswith(f"['{key}']"), (pname, path)
            assert sorted(shape) == sorted(p.shape), (pname, path)
        if name in COUNTS:
            assert len(leaves) == COUNTS[name][1]
            assert sum(p.numel() for p in model.parameters()) == COUNTS[name][2]

    @pytest.mark.parametrize("name", names)
    def test_flat_orders_are_inverse_and_the_jax_flat_order(name):
        with torch.device("meta"):
            model = load_model(name, 10)
        n = sum(p.numel() for p in model.parameters())
        port = np.arange(n, dtype=np.int64)
        to_jax = flat_to_jax(name, model, port)
        np.testing.assert_array_equal(flat_from_jax(name, model, to_jax), port)
        # each port element's index, as a tree of the JAX layout raveled leaf by
        # leaf in jax.tree_util's order
        arrays, offset = {}, 0
        for pname, p in model.named_parameters():
            arrays[pname] = port[offset:offset + p.numel()].reshape(tuple(p.shape))
            offset += p.numel()
        params, _ = jax_from_state_dict(name, arrays)
        leaves = jax.tree_util.tree_leaves(params)
        assert [leaf.shape for leaf in leaves] == [shape for _, shape in _jax_leaves(name)[1]]
        np.testing.assert_array_equal(to_jax, np.concatenate([np.ravel(leaf) for leaf in leaves]))

    @pytest.mark.parametrize("name", names)
    def test_jax_layer_sizes_are_the_jax_childrens(name):
        with torch.device("meta"):
            model = load_model(name, 10)
        params, _ = _jax_leaves(name)
        want = tuple(sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(child))
                     for child in params)
        assert jax_layer_sizes(name, model) == want
        if name in COUNTS:
            assert len(want) == COUNTS[name][0]
        # every block's parameters are contiguous in the port's order
        for child in range(len(want)):
            jax_param_span(name, model, (child, child + 1))

    @pytest.mark.parametrize("name,cap", sorted(k for k in SEGMENTS if k[0] in names))
    def test_comm_overlap_meta_is_the_jax_wraps(cpu_devices, name, cap):
        torch.manual_seed(0)
        model = load_model(name, 10)
        ours = DistributedDataParallel(model, Adam(model.parameters(), lr=1e-3), CrossEntropyLoss(),
                                       device="cpu", bucket_cap_mb=cap)
        jax_ddp = JaxDDP(jax_load_model(name, 10), jax_optim.Adam(1e-3), JaxCrossEntropyLoss(),
                         mesh=make_mesh(cpu_devices[:1]), bucket_cap_mb=cap)
        _, params, mstate = _jax_init(name)
        jax_ddp.init_state(jax.random.key(0), jnp.zeros((1, HW, HW, 3)), params=params,
                           model_state=mstate)
        assert ours.comm_overlap_meta == jax_ddp.comm_overlap_meta
        sizes = jax_sizes(name, model)
        total = sum(sizes)
        layers = jax_layer_sizes(name, model)
        segs = comm.make_segments(layers, comm.make_buckets(sizes, total, cap), total)
        assert [s.layers for s in segs] == SEGMENTS[(name, cap)]
        assert [tuple(s) for s in segs] == [tuple(s) for s in jax_comm.make_segments(
            layers, jax_comm.make_buckets(sizes, total, cap), total)]
        assert ours.comm_overlap_meta["enabled"] == (len(segs) > 1)
        if len(segs) > 1:
            spans = [jax_param_span(name, model, s.layers) for s in segs]
            assert spans[0][0] == 0 and spans[-1][1] == len(list(model.parameters()))
            assert [s.layers for s in ours._overlap.segments] == SEGMENTS[(name, cap)]

    tests = [
        test_the_bridge_round_trips_the_jax_init_bitwise,
        test_the_jax_torchvision_converter_reads_the_port_state_dict,
        test_eval_logits_match_jax, test_train_forward_and_running_statistics_match_jax,
        test_jax_leaf_index_is_the_jax_flatten_order, test_flat_orders_are_inverse_and_the_jax_flat_order,
        test_jax_layer_sizes_are_the_jax_childrens]
    if any(name in names for name, _ in SEGMENTS):
        tests.append(test_comm_overlap_meta_is_the_jax_wraps)
    return {f.__name__: f for f in tests}


globals().update(depth_tests("resnet18"))


def _gradient_batch():
    """4 rows at 32 px, the second padded out (weight 0)."""
    rng = np.random.RandomState(3)
    x = rng.randn(4, HW, HW, 3).astype(np.float32)
    return x, np.array([3, 1, 1, 2]), np.array([1, 0, 1, 1], np.float32)


def _port_loss(model, x, y, w):
    with batch_weights(model, torch.from_numpy(w)):
        return CrossEntropyLoss()(model(torch.from_numpy(x)), torch.from_numpy(y),
                                  torch.from_numpy(w))


def _jax_loss(jax_model, mstate, x, y, w, train):
    ctx = Context(train=train, sample_weight=jnp.asarray(w))

    def loss(p):
        logits, _ = jax_model.apply(p, mstate, jnp.asarray(x), ctx)
        return jax_cross_entropy(logits, jnp.asarray(y, np.int32), weights=jnp.asarray(w))
    return loss
