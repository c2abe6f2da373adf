"""The comm hooks of the port (``tpuddp_torch/parallel/comm.py``) against the
JAX package's (``tpuddp/parallel/comm.py``), on the CPU at world 1, with
inputs made from a seed with numpy:

- the bucket plans (random size lists and caps; AlexNet, toy_mlp and
  toy_cnn in the JAX tree order, AlexNet's five buckets named);
- the byte counters, for every hook, worlds 1, 2 and 4, ``wus`` and
  ``wire`` on and off;
- ``quantize_int8``, ``int8_scale``, ``bucket_topk`` and ``local_quantize``;
- ``GradComm.reduce`` and ``reduce_scatter`` against the JAX package's
  ``shard_map`` over one CPU device, and the native wrap's sync (the
  gradient permuted into the JAX order and back), with an all-zero bucket
  and a bucket holding a NaN.

Tolerance: bitwise. The hooks are elementwise casts, roundings and
max-abs scales of the same float32 values; a top-k set of distinct
magnitudes is the same set in both packages (ties could be broken
differently, so kept vectors are compared, never index lists). The JAX
side runs compiled, as its steps run it, and two of XLA's rewrites show:
the scale ``max / 127.0`` becomes ``max * float32(1 / 127)``, and int8_ef's
``send - q * scale`` one fused multiply-add. The port computes both so."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tpuddp.models import load_model as jax_load_model
from tpuddp.parallel import comm as jax_comm
from tpuddp.parallel import make_mesh
from tpuddp.training.step import _tree_to_vec, make_flat_param_spec
from tpuddp.utils.compat import shard_map

from tpuddp_torch.models import load_model
from tpuddp_torch.models.convert import (
    JaxFlatOrder, flat_to_jax, jax_sizes, state_dict_from_jax, torch_layout,
)
from tpuddp_torch.parallel import comm
from tpuddp_torch.training.step import comm_sync

HOOKS = ("bf16", "bf16_ef", "int8_ef", "topk_ef")
CAP = 0.002  # MB: toy_cnn's 22,314 parameters in five buckets
DENSITY = 0.1
ALEXNET_JAX_BUCKETS = ((0, 2473792), (2473792, 40222528), (40222528, 40226624),
                       (40226624, 57003840), (57003840, 57044810))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def toy():
    """toy_cnn at 8 px: the JAX params, and the port's model holding them."""
    params, _ = jax_load_model("toy_cnn", 10).init(jax.random.key(3), jnp.zeros((1, 8, 8, 3)))
    params = _np(params)
    model = load_model("toy_cnn", 10, input_shape=(8, 8, 3))
    model.load_state_dict(state_dict_from_jax("toy_cnn", params), strict=False)
    return params, model


def _grads(params, seed, scale=1.0):
    """A gradient tree like ``params``: each leaf normal at its own scale."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(np.shape(p)) * scale * 10.0 ** rng.uniform(-3, 0))
        .astype(np.float32), params)


# ---------------------------------------------------------------- buckets --

@pytest.mark.parametrize("seed", range(8))
def test_make_buckets_matches_jax_on_random_sizes(seed):
    rng = np.random.default_rng(seed)
    sizes = tuple(int(s) for s in rng.integers(1, 400_000, size=rng.integers(1, 30)))
    world = int(rng.choice([1, 2, 3, 8]))
    total = world * -(-sum(sizes) // world)
    cap = float(rng.choice([0.01, 0.3, 1.0, 25.0]))
    assert comm.make_buckets(sizes, total, cap) == jax_comm.make_buckets(sizes, total, cap)


def _jax_leaf_sizes(name, input_hw):
    shapes = jax.eval_shape(jax_load_model(name, 10).init, jax.random.key(0),
                            jnp.zeros((1, input_hw, input_hw, 3)))[0]
    return tuple(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))


@pytest.mark.parametrize("name,hw,cap", [("alexnet", 224, 25.0), ("alexnet", 224, 4.0),
                                         ("toy_mlp", 8, 0.1), ("toy_cnn", 8, CAP)])
def test_the_native_plan_is_the_jax_packages(name, hw, cap):
    """The port's leaf sizes in the JAX tree order, and the plan over them,
    are the JAX package's."""
    with torch.device("meta"):
        model = load_model(name, 10, input_shape=(hw, hw, 3))
    sizes = jax_sizes(name, model)
    assert sizes == _jax_leaf_sizes(name, hw)
    for world in (1, 2, 8):
        plan = comm.make_grad_comm(sizes, world, "int8_ef", cap)
        total = world * -(-sum(sizes) // world)
        assert plan.total == total
        assert plan.buckets == jax_comm.make_buckets(sizes, total, cap)


def test_alexnet_plan_is_the_jax_five_buckets():
    """Bucket 0 holds the five conv layers and classifier.1's bias: the
    port's own parameter order (weight before bias) packs another plan."""
    with torch.device("meta"):
        model = load_model("alexnet", 10)
    plan = comm.make_grad_comm(jax_sizes("alexnet", model), 1, "topk_ef")
    assert plan.buckets == ALEXNET_JAX_BUCKETS and plan.total == 57_044_810
    port_order = comm.make_buckets([p.numel() for p in model.parameters()], plan.total)
    assert port_order[0] == (0, 2_469_696) and port_order != plan.buckets


# ------------------------------------------------------------ byte counts --

@pytest.fixture(scope="module")
def alexnet_like():
    """AlexNet's leaf sizes (the JAX tree order) and a tree of float32
    zeros of those sizes."""
    sizes = _jax_leaf_sizes("alexnet", 224)
    return sizes, tuple(np.zeros(s, np.float32) for s in sizes)


@pytest.mark.parametrize("hook", comm.COMM_HOOKS)
@pytest.mark.parametrize("world", (1, 2, 4))
@pytest.mark.parametrize("wus", (False, True))
@pytest.mark.parametrize("wire", (True, False))
def test_comm_bytes_match_jax(toy, hook, world, wus, wire):
    params, model = toy
    kw = dict(wus=wus, wire=wire, bucket_cap_mb=CAP, density=DENSITY)
    assert comm.comm_bytes_for_hook(jax_sizes("toy_cnn", model), world, hook, **kw) == \
        jax_comm.comm_bytes_for_hook(params, world, hook, **kw)


def test_alexnet_comm_bytes_match_jax(alexnet_like):
    sizes, tree = alexnet_like
    for hook in comm.COMM_HOOKS:
        for world in (1, 2, 8):
            for wus in (False, True):
                for wire in (True, False):
                    kw = dict(wus=wus, wire=wire)
                    assert comm.comm_bytes_for_hook(sizes, world, hook, **kw) == \
                        jax_comm.comm_bytes_for_hook(tree, world, hook, **kw), (hook, world, wus)


@pytest.mark.parametrize("hook", comm.COMM_HOOKS)
@pytest.mark.parametrize("world", (1, 2, 4))
@pytest.mark.parametrize("wire", (True, False))
def test_comm_bytes_breakdown_matches_jax_flat(toy, hook, world, wire):
    params, model = toy
    kw = dict(wire=wire, bucket_cap_mb=CAP, density=DENSITY)
    assert comm.comm_bytes_breakdown(jax_sizes("toy_cnn", model), world, hook, **kw) == \
        jax_comm.comm_bytes_breakdown(params, world, hook, topology="flat", **kw)


# ------------------------------------------------------------- primitives --

def _buckets_to_quantize():
    rng = np.random.default_rng(0)
    ties = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 126.5, 1.5], np.float32)  # half-way codes
    tiny = (rng.standard_normal(1000) * 1e-30).astype(np.float32)  # subnormal scale
    out = {"ties": ties, "zeros": np.zeros(64, np.float32), "tiny": tiny}
    for i in range(6):  # magnitudes where max / 127 and max * float32(1 / 127) part
        out[f"normal {i}"] = (rng.standard_normal(777) * 10.0 ** rng.uniform(-8, 3)).astype(np.float32)
    return out


@pytest.mark.parametrize("case", sorted(_buckets_to_quantize()))
def test_quantize_int8_and_scale_match_jax(case):
    b = _buckets_to_quantize()[case]
    scale = comm.int8_scale(torch.from_numpy(b))
    jscale = jax.jit(jax_comm.int8_scale)(jnp.asarray(b))  # compiled, as the steps run it
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    q = comm.quantize_int8(torch.from_numpy(b), scale)
    assert q.dtype == torch.int8
    jq = jax.jit(jax_comm.quantize_int8)(jnp.asarray(b), jscale)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


def test_a_nan_poisons_the_int8_scale():
    b = np.arange(10, dtype=np.float32)
    b[3] = np.nan
    scale = comm.int8_scale(torch.from_numpy(b))
    assert torch.isnan(scale) and np.isnan(np.asarray(jax_comm.int8_scale(jnp.asarray(b))))
    kept = comm.quantize_int8(torch.from_numpy(b), scale).float() * scale
    assert torch.isnan(kept).all()


@pytest.mark.parametrize("size", (1, 7, 10, 999, 25_000_000))
@pytest.mark.parametrize("density", (1e-9, 0.1, 0.5, 1.0))
def test_bucket_topk_matches_jax(size, density):
    assert comm.bucket_topk(size, density) == jax_comm.bucket_topk(size, density)


@pytest.mark.parametrize("density", (0.0, 1.5, -0.1))
def test_bucket_topk_refuses_a_density_outside_the_range(density):
    with pytest.raises(ValueError, match=r"topk density must be in \(0, 1\]"):
        comm.bucket_topk(10, density)


def test_loss_parity_tol_matches_jax():
    for hook in comm.COMM_HOOKS:
        for base in (0.01, 1.0, 2.9944, 30.0):
            assert comm.loss_parity_tol(hook, base) == jax_comm.loss_parity_tol(hook, base)


# ------------------------------------------------------ managed emulation --

@pytest.mark.parametrize("hook", comm.COMM_HOOKS)
def test_local_quantize_matches_jax(toy, hook):
    """Per leaf in the port's layout against the JAX package's per leaf in
    its layout (the same elements): quantized gradients and residuals."""
    params, model = toy
    grads, residual = _grads(params, 1), _grads(params, 2, scale=1e-3)
    jax_res = residual if hook in comm.EF_HOOKS else None
    # jitted, as the JAX package's managed step runs it (XLA contracts
    # int8_ef's product and difference into one fused multiply-add)
    jq, jr = jax.jit(lambda g, r: jax_comm.local_quantize(g, r, hook, density=DENSITY))(
        grads, jax_res)
    names = [n for n, _ in model.named_parameters()]
    port = lambda tree: [torch.from_numpy(torch_layout("toy_cnn", _np(tree))[n].copy())
                         for n in names]
    q, r = comm.local_quantize(port(grads), port(residual) if jax_res is not None else None,
                               hook, DENSITY)
    for got, want in zip(q, port(jq)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    if jax_res is None:
        assert r is None
    else:
        for got, want in zip(r, port(jr)):
            torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_local_quantize_keeps_the_error_feedback_invariant():
    g = [torch.randn(40, generator=torch.Generator().manual_seed(0))]
    r = comm.init_residual_tree(g)
    q, r1 = comm.local_quantize(g, r, "topk_ef", 0.25)
    torch.testing.assert_close(q[0] + r1[0], g[0] + r[0], rtol=0, atol=0)
    assert int((q[0] != 0).sum()) == comm.bucket_topk(40, 0.25)


# ----------------------------------------------------------- the exchange --

def _jax_reduce(plan, grads, residual, cpu_devices):
    """The JAX package's ``GradComm.reduce`` in its ``shard_map`` step over
    one CPU device: ``(reduced vector, new residual)``."""
    mesh = make_mesh(cpu_devices[:1])
    r = None if residual is None else jnp.asarray(residual)

    def body(g, r):
        out, new = plan.reduce(g, r, "data")
        return _tree_to_vec(out, plan.spec), new

    fn = shard_map(body, mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P()), check_vma=False)
    out, new = jax.jit(fn)(grads, r)
    return np.asarray(out), None if new is None else np.asarray(new)


def _poisoned(params, grads, case):
    """``grads`` with one leaf all zeros (a whole bucket at CAP: the third
    conv's bias and BatchNorm, and so on), or a NaN in it."""
    leaves, treedef = jax.tree_util.tree_flatten(grads)
    leaves = [np.array(l) for l in leaves]
    if case == "zero bucket":
        for i in range(len(leaves)):
            if leaves[i].size == 18432:  # the second conv's weight: a bucket alone
                leaves[i][...] = 0
    elif case == "nan bucket":
        leaves[-1].reshape(-1)[3] = np.nan
    return jax.tree_util.tree_unflatten(treedef, leaves)


@pytest.mark.parametrize("hook", HOOKS)
@pytest.mark.parametrize("case", ("plain", "zero bucket", "nan bucket"))
def test_reduce_world_1_matches_jax(toy, cpu_devices, hook, case):
    params, model = toy
    plan_j = jax_comm.make_grad_comm(params, 1, hook, CAP, density=DENSITY)
    plan = comm.make_grad_comm(jax_sizes("toy_cnn", model), 1, hook, CAP, DENSITY)
    assert plan.buckets == plan_j.buckets and len(plan.buckets) > 3
    grads = _poisoned(params, _grads(params, 3), case)
    g_vec = np.asarray(_tree_to_vec(grads, make_flat_param_spec(params, 1)))
    residual = (np.random.default_rng(4).standard_normal(plan.total) * 1e-3).astype(np.float32)
    residual = residual if plan.needs_residual else None
    want, want_r = _jax_reduce(plan_j, grads, residual, cpu_devices)
    r = None if residual is None else torch.from_numpy(residual.copy())
    got, got_r = plan.reduce(torch.from_numpy(g_vec.copy()), r)
    assert got_r is r
    np.testing.assert_array_equal(got.numpy(), want)
    if residual is not None:
        np.testing.assert_array_equal(got_r.numpy(), want_r)
    if case == "zero bucket":
        (s, e), = [(s, e) for s, e in plan.buckets if not np.any(g_vec[s:e])]
        if hook == "bf16":  # no residual: the bucket sends zeros
            assert not got[s:e].any()
    if case == "nan bucket" and hook == "int8_ef":
        s, e = plan.buckets[-1]
        assert torch.isnan(got[s:e]).all()  # NaN everywhere in the bucket
    if case == "nan bucket" and hook == "topk_ef":
        s, e = plan.buckets[-1]
        assert int(torch.isnan(got[s:e]).sum()) == comm.bucket_topk(e - s, DENSITY)


@pytest.mark.parametrize("hook", HOOKS)
def test_reduce_scatter_world_1_matches_jax(toy, cpu_devices, hook):
    """ZeRO-1's composition at world 1: one whole-vector bucket."""
    params, model = toy
    plan_j = jax_comm.make_grad_comm(params, 1, hook, CAP, density=DENSITY)
    plan = comm.make_grad_comm(jax_sizes("toy_cnn", model), 1, hook, CAP, DENSITY)
    rng = np.random.default_rng(5)
    g_vec = rng.standard_normal(plan.total).astype(np.float32)
    residual = (rng.standard_normal(plan.total) * 1e-2).astype(np.float32) \
        if plan.needs_residual else None
    mesh = make_mesh(cpu_devices[:1])
    fn = shard_map(lambda g, r: plan_j.reduce_scatter(g, r, "data"), mesh=mesh,
                   in_specs=(P(), P()), out_specs=(P(), P()), check_vma=False)
    want, want_r = jax.jit(fn)(jnp.asarray(g_vec), None if residual is None else jnp.asarray(residual))
    r = None if residual is None else torch.from_numpy(residual.copy())
    got, got_r = plan.reduce_scatter(torch.from_numpy(g_vec), r, rank=0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if residual is not None:
        np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))


@pytest.mark.parametrize("hook", HOOKS)
def test_the_native_sync_is_the_jax_exchange_in_the_ports_layout(toy, cpu_devices, hook):
    """``comm_sync``: the parameters' gradients (port layout) permuted into
    the JAX order, exchanged, and back: each gradient is the JAX package's
    reduced leaf, and the residual is its vector, bitwise."""
    params, model = toy
    plan_j = jax_comm.make_grad_comm(params, 1, hook, CAP, density=DENSITY)
    plan = comm.make_grad_comm(jax_sizes("toy_cnn", model), 1, hook, CAP, DENSITY)
    grads = _grads(params, 6)
    residual = plan.init_residual()
    if residual is not None:
        residual += torch.from_numpy(
            (np.random.default_rng(7).standard_normal(plan.total) * 1e-3).astype(np.float32))
    want, want_r = _jax_reduce(plan_j, grads, None if residual is None else residual.numpy(),
                               cpu_devices)
    torch_grads = torch_layout("toy_cnn", _np(grads))
    ps = list(model.parameters())
    for (n, p) in model.named_parameters():
        p.grad = torch.from_numpy(torch_grads[n].copy())
    comm_sync(ps, plan, JaxFlatOrder("toy_cnn", model), residual)
    got = flat_to_jax("toy_cnn", model, torch.cat([p.grad.reshape(-1) for p in ps]).numpy())
    np.testing.assert_array_equal(got, want[:got.size])
    if residual is not None:
        np.testing.assert_array_equal(residual.numpy(), want_r)


def test_jax_flat_order_round_trips(toy):
    _, model = toy
    order = JaxFlatOrder("toy_cnn", model)
    vec = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    jax_vec = order.to_jax(vec)
    np.testing.assert_array_equal(jax_vec.numpy(), flat_to_jax("toy_cnn", model, vec.numpy()))
    torch.testing.assert_close(order.from_jax(jax_vec), vec, rtol=0, atol=0)
