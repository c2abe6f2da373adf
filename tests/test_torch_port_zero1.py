"""ZeRO-1 (weight-update sharding) in the port, in one process on the CPU:
the flat layout against the JAX package's ``make_flat_param_spec`` and
``_tree_to_vec``, the bf16 rounding of a flat shard against
``tpuddp.optim._stochastic_round_bf16`` (base 0, the native path's, and the
shard's offset, the managed path's), one flat Adam update with bf16 moments
against ``tpuddp.optim.Adam(state_dtype="bfloat16")``, the
:class:`~tpuddp_torch.optim.ShardedUpdate` wrapper, and at world 1 the
ZeRO-1 step of both entry paths against the replicated one. Then, marked
``cuda`` (skipped here, ``pytest -m cuda`` on the card), the flat-shard
kernel launch against its plain version and CUDA-graph replays of ZeRO-1
steps against their eager runs. The 2-process runs against the JAX package
are tests/test_torch_port_zero1_gloo.py; checkpoints
tests/test_torch_port_zero1_ckpt.py.

Tolerances: layouts, rounding and the world-1 ZeRO-1 step against the
replicated one bitwise (the same elementwise arithmetic; the clip's norm
is one float64 sum over the flat vector instead of one per parameter,
which happens to round to the same float32 here); the flat Adam update's
moments bitwise wherever the two packages' float32 moments agree bitwise,
its parameters within 1e-6 (float32 arithmetic in two libraries); on the
card, the kernel's p within 1e-5 and bf16 moments each a bf16 neighbour of
the plain unrounded moment, bitwise at zero gradients, and replays bitwise
their eager steps."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuddp.models import load_model as jax_load_model
from tpuddp.optim import Adam as JaxAdam
from tpuddp.optim import AdamState
from tpuddp.optim import _stochastic_round_bf16 as jax_round
from tpuddp.training.step import _tree_to_vec, make_flat_param_spec as jax_flat_spec

from tpuddp_torch import config as cfg
from tpuddp_torch.accelerate import Accelerator
from tpuddp_torch.models import load_model
from tpuddp_torch.models.convert import flat_from_jax, flat_to_jax, state_dict_from_jax
from tpuddp_torch.nn import CrossEntropyLoss
from tpuddp_torch.ops import fused_adam
from tpuddp_torch.optim import LAMB, LARS, SGD, Adam, ShardedUpdate
from tpuddp_torch.parallel.ddp import DistributedDataParallel
from tpuddp_torch.training.step import make_flat_param_spec

HW = {"toy_mlp": 8, "toy_cnn": 8, "alexnet": 63}
BETAS = (0.9, 0.999)
P_TOL = 1e-6


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


@functools.lru_cache(maxsize=None)
def _jax_init(name):
    hw = HW[name]
    return _np(jax_load_model(name, 10).init(jax.random.key(1), jnp.zeros((1, hw, hw, 3))))


def _port_model(name):
    return load_model(name, 10, input_shape=(HW[name], HW[name], 3))


# ------------------------------------------------------------- the layout --

@pytest.mark.parametrize("world", [1, 2, 3, 4])
@pytest.mark.parametrize("name", ["toy_mlp", "toy_cnn", "alexnet"])
def test_flat_spec_is_the_jax_packages(name, world):
    params, _ = _jax_init(name)
    ref = jax_flat_spec(params, world)
    spec = make_flat_param_spec(_port_model(name), world)
    assert (spec.total, spec.world) == (ref.total, ref.world)
    assert spec.raw == sum(ref.sizes) and sorted(spec.sizes) == sorted(ref.sizes)
    assert spec.shard_n * world == spec.total


@pytest.mark.parametrize("name", ["toy_mlp", "toy_cnn", "alexnet"])
def test_flat_order_is_the_jax_packages(name):
    """The port's flat vector of a JAX init, permuted, is the JAX package's
    ``_tree_to_vec`` of it; and back. Bitwise."""
    params, mstate = _jax_init(name)
    model = _port_model(name)
    model.load_state_dict(state_dict_from_jax(name, params, mstate))
    ours = torch.cat([p.detach().reshape(-1) for p in model.parameters()]).numpy()
    theirs = np.asarray(_tree_to_vec(params, jax_flat_spec(params, 1)))
    np.testing.assert_array_equal(flat_to_jax(name, model, ours), theirs)
    np.testing.assert_array_equal(flat_from_jax(name, model, theirs), ours)
    bits = (np.arange(ours.size) % 65521).astype(np.uint16)  # any dtype moves the same way
    np.testing.assert_array_equal(flat_from_jax(name, model, flat_to_jax(name, model, bits)), bits)


def test_flat_spec_refuses_non_float32_parameters():
    model = _port_model("toy_mlp").to(torch.bfloat16)
    with pytest.raises(ValueError, match="f32"):
        make_flat_param_spec(model, 2)


# -------------------------------------------------------------- rounding --

@pytest.mark.parametrize("world,rank", [(1, 0), (2, 1), (3, 2), (4, 1)])
@pytest.mark.parametrize("step", [1, 7, 65539])
def test_flat_shard_rounding_is_bitwise_the_jax_packages(world, rank, step):
    """Base 0 (the native path: shard_map's iota counts within the shard)
    against the JAX rounding of the shard; base ``rank * shard_n`` (the
    managed path: GSPMD's iota runs over the whole vector) against the JAX
    rounding of the whole vector, sliced."""
    total = world * 2003
    x = np.random.RandomState(step).randn(total).astype(np.float32) * 1e-3
    lo, hi = rank * 2003, (rank + 1) * 2003
    salt = fused_adam.moment_salts(0)[1]
    t = jnp.asarray(np.uint32(step))
    native = np.asarray(jax_round(jnp.asarray(x[lo:hi]), t, salt)).view(np.uint16)
    managed = np.asarray(jax_round(jnp.asarray(x), t, salt)).view(np.uint16)[lo:hi]
    shard = torch.from_numpy(x[lo:hi].copy())
    np.testing.assert_array_equal(_bits(fused_adam.stochastic_round_bf16(shard, step, salt)), native)
    np.testing.assert_array_equal(
        _bits(fused_adam.stochastic_round_bf16(shard, step, salt, base=lo)), managed)


def test_noise_offset_folds_the_base_into_the_row_word():
    """(base + i) * A + w = i * A + (base * A + w) modulo 2^32, which is
    what lets the kernel, indexing within its row, round a shard that
    starts at ``base``."""
    base, step, salt = 123_456_789, 9, fused_adam.moment_salts(0)[0]
    i = np.arange(5000, dtype=np.uint64)
    direct = ((base + i) * fused_adam.WEYL_INDEX + step * fused_adam.WEYL_STEP + salt) & 0xFFFF
    folded = (i * fused_adam.WEYL_INDEX + fused_adam.noise_offset(step, salt, base)) & 0xFFFF
    np.testing.assert_array_equal(direct, folded)
    tables = fused_adam.replay_scalars([5000], [0.1], [0.001], torch.bfloat16, steps=[step],
                                       leaves=[0], bases=[base])
    words = tables[0].view(np.uint32)
    assert words[2] == fused_adam.noise_offset(step, fused_adam.moment_salts(0)[0], base)
    assert words[3] == fused_adam.noise_offset(step, fused_adam.moment_salts(0)[1], base)


@pytest.mark.parametrize("managed", [False, True], ids=["native_base_0", "managed_base_lo"])
def test_one_flat_bf16_adam_update_matches_jax(managed):
    """One update of a world-2 shard with bf16 moments: the port's plain
    version (what a CPU tensor runs) against ``Adam(state_dtype=
    "bfloat16").update`` of the JAX package on the shard (native) or on the
    whole vector, sliced (managed: the JAX rounding numbers the whole
    vector). Moments bitwise wherever the float32 moments agree bitwise."""
    n, rank, step = 4099, 1, 6
    rng = np.random.RandomState(managed)
    p, g = (rng.randn(2 * n).astype(np.float32) for _ in range(2))
    m = (rng.randn(2 * n) * 1e-2).astype(np.float32)
    v = (np.abs(rng.randn(2 * n)) * 1e-3).astype(np.float32)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    jopt = JaxAdam(lr=1e-3, state_dtype="bfloat16")
    lo, hi = rank * n, (rank + 1) * n
    whole = slice(None) if managed else slice(lo, hi)
    state = AdamState(step=jnp.int32(step - 1), m=bf(m[whole]), v=bf(v[whole]))
    new_p, new_state = jopt.update(jnp.asarray(g[whole]), state, jnp.asarray(p[whole]))
    part = slice(lo, hi) if managed else slice(None)
    want_p = np.asarray(new_p)[part]
    want_m, want_v = (np.asarray(x).view(np.uint16)[part] for x in (new_state.m, new_state.v))

    tm, tv = (torch.from_numpy(np.asarray(bf(a[lo:hi])).view(np.uint16).view(np.int16).copy())
              .view(torch.bfloat16) for a in (m, v))
    tp = torch.from_numpy(p[lo:hi].copy())
    m32 = 0.9 * tm.float() + (1 - 0.9) * torch.from_numpy(g[lo:hi])
    v32 = 0.999 * tv.float() + (1 - 0.999) * torch.from_numpy(g[lo:hi]) ** 2
    bc1, bc2 = fused_adam.bias_corrections(step, BETAS)
    fused_adam.adam_update([tp], [torch.from_numpy(g[lo:hi].copy())], [tm], [tv], lr=1e-3,
                           betas=BETAS, eps=1e-8, weight_decay=0.0, bc1s=[bc1], bc2s=[bc2],
                           steps=[step], leaves=[0], bases=[lo if managed else 0])
    np.testing.assert_allclose(tp.numpy(), want_p, rtol=0, atol=P_TOL)
    jm32 = np.asarray(0.9 * bf(m[lo:hi]).astype(jnp.float32) + (1 - 0.9) * jnp.asarray(g[lo:hi]))
    jv32 = np.asarray(0.999 * bf(v[lo:hi]).astype(jnp.float32)
                      + (1 - 0.999) * jnp.square(jnp.asarray(g[lo:hi])))
    for got, want, ours32, theirs32 in ((tm, want_m, m32, jm32), (tv, want_v, v32, jv32)):
        agree = ours32.numpy().view(np.uint32) == theirs32.view(np.uint32)
        assert agree.mean() > 0.99
        np.testing.assert_array_equal(_bits(got)[agree], want[agree])


# ------------------------------------------------------------- the wrap --

def _toy(name="toy_cnn", seed=0):
    torch.manual_seed(seed)
    return _port_model(name)


def test_parameters_become_views_into_one_flat_vector():
    model = _toy()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    spec = make_flat_param_spec(model, 3)
    opt = ShardedUpdate(Adam(model.parameters(), lr=1e-3), list(model.parameters()), spec, rank=1)
    flat = opt.flat
    offset = 0
    for p in model.parameters():
        assert p.data_ptr() == flat.data_ptr() + 4 * offset
        offset += p.numel()
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    assert not flat[spec.raw:].any() and spec.total % 3 == 0
    assert opt.param_groups[0]["params"] == [opt.shard] and opt.shard.numel() == spec.shard_n
    assert opt.shard.data_ptr() == flat.data_ptr() + 4 * spec.shard_n
    model.load_state_dict({k: v + 1 for k, v in before.items()})  # writes through the views
    assert float(flat[:spec.raw].sum()) == pytest.approx(
        sum(float(p.sum()) + p.numel() for k, p in before.items() if "running" not in k
            and "num_batches" not in k), rel=1e-5)


def test_sharded_update_keys_the_rounding_and_the_trust_ratios():
    model = _toy()
    spec = make_flat_param_spec(model, 2)
    opt = ShardedUpdate(Adam(model.parameters(), lr=1e-3, state_dtype="bfloat16",
                             leaf_index=list(range(8))), list(model.parameters()), spec, rank=1,
                        managed=True)
    assert opt.inner.leaf_index == {opt.shard: 0} and opt.inner.noise_base == {opt.shard: spec.shard_n}
    lars = ShardedUpdate(LARS(model.parameters(), 1.0), list(model.parameters()), spec, rank=1)
    segs = lars.inner.flat
    assert segs.num_segments == len(spec.sizes) + 1  # the padding is one more layer
    assert sum(hi - lo for lo, hi in segs.slices) == spec.shard_n
    with pytest.raises(ValueError, match="one param group"):
        groups = [{"params": list(model.parameters())[:2]}, {"params": list(model.parameters())[2:]}]
        ShardedUpdate(SGD(groups, 0.1), list(model.parameters()), spec)


def _batches(n, rows=16, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return [(torch.randn(rows, 8, 8, 3, generator=gen), torch.randint(0, 10, (rows,), generator=gen),
             (torch.arange(rows) < rows - i % 3).float()) for i in range(n)]


OPTIMIZERS = {
    "adam": lambda ps: Adam(ps, lr=1e-2),
    "adam_wd": lambda ps: Adam(ps, lr=1e-2, weight_decay=1e-2),
    "sgd": lambda ps: SGD(ps, 1e-2, momentum=0.9, weight_decay=5e-4),
    "lars": lambda ps: LARS(ps, 1.0, weight_decay=5e-4),
    "lamb": lambda ps: LAMB(ps, 1e-2, weight_decay=1e-2),
}


@pytest.mark.parametrize("clip", [None, 0.5], ids=["no_clip", "clip"])
@pytest.mark.parametrize("opt_name", sorted(OPTIMIZERS))
def test_native_zero1_is_the_replicated_step_at_world_1(opt_name, clip):
    """train_step, train_cycle (A = 2) and train_step_many (K = 4): the same
    parameters and state bitwise as without ZeRO-1."""
    torch.set_num_threads(2)
    batches = _batches(10)

    def run(zero1, accum):
        model = _toy()
        ddp = DistributedDataParallel(model, OPTIMIZERS[opt_name](model.parameters()),
                                      CrossEntropyLoss(), device="cpu", clip_grad_norm=clip,
                                      grad_accumulation=accum, weight_update_sharding=zero1)
        if accum == 1:
            for b in batches[:2]:
                ddp.train_step(b)
        else:
            ddp.train_cycle(batches[:2])
        ddp.train_step_many(batches[2:10])
        return model.state_dict(), ddp

    for accum in (1, 2):
        (a, _), (b, ddp) = run(False, accum), run(True, accum)
        assert isinstance(ddp.optimizer, ShardedUpdate)
        for k in a:
            assert torch.equal(a[k], b[k]), (accum, k)


@pytest.mark.parametrize("fuse,accum", [(4, 1), (1, 2)], ids=["fuse_4", "accum_2"])
def test_managed_zero1_is_the_replicated_step_at_world_1(fuse, accum):
    torch.set_num_threads(2)
    batches = _batches(8)

    def run(zero1):
        acc = Accelerator(seed=0, device="cpu", fuse_steps=fuse, gradient_accumulation_steps=accum,
                          clip_grad_norm=0.5, weight_update_sharding=zero1)
        module = _toy()
        model, opt = acc.prepare(module, LAMB(module.parameters(), 1e-2))
        losses = []
        for x, y, w in batches:
            opt.zero_grad()
            loss = CrossEntropyLoss()(model(x), y, w)
            acc.backward(loss)
            opt.step()
            losses.append(loss)
        opt.flush_accumulation()
        return [float(l.device_value()) for l in losses], model.module.state_dict(), opt

    (la, a, _), (lb, b, opt) = run(False), run(True)
    assert isinstance(opt.optimizer, ShardedUpdate) and la == lb
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------- the card --

@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = deterministic


@pytest.mark.cuda
@pytest.mark.parametrize("base", [0, 28_522_405], ids=["base_0", "base_half"])
@pytest.mark.parametrize("zero_grad", [False, True], ids=["grads", "zero_grads"])
def test_flat_shard_kernel_matches_plain_version_on_the_card(card, base, zero_grad):
    """Needs a GPU and nvcc: one launch over one row of 3,000,017 elements
    (bf16 moments) at base 0 and at half AlexNet's flat vector, 3 steps from
    the kernel's state: p within 1e-5, each moment a bf16 neighbour of the
    plain unrounded moment, bitwise at zero gradients."""
    kernel = fused_adam.kernels[torch.bfloat16]
    gen = torch.Generator(device="cuda").manual_seed(3)
    n = 3_000_017
    p = torch.randn(n, generator=gen, device="cuda")
    g = torch.zeros(n, device="cuda") if zero_grad else torch.randn(n, generator=gen, device="cuda")
    m = (torch.randn(n, generator=gen, device="cuda") * 1e-2).to(torch.bfloat16)
    v = (torch.rand(n, generator=gen, device="cuda") * 1e-3).to(torch.bfloat16)
    kernel.reset_launches()
    for t in range(1, 4):
        plain = [x.clone() for x in (p, g, m, v)]
        before = [x.clone() for x in (p, g, m, v)]
        bc1, bc2 = fused_adam.bias_corrections(t, BETAS)
        kw = dict(lr=1e-3, betas=BETAS, eps=1e-8, weight_decay=0.0)
        kernel([p], [g], [m], [v], bc1s=[bc1], bc2s=[bc2], steps=[t], leaves=[0], bases=[base], **kw)
        fused_adam.adam_update_reference(*plain, bc1=bc1, bc2=bc2, step=t, leaf=0, base=base, **kw)
        torch.cuda.synchronize()
        assert (p - plain[0]).abs().max().item() <= 1e-5
        if zero_grad:
            assert torch.equal(m.view(torch.int16), plain[2].view(torch.int16))
            assert torch.equal(v.view(torch.int16), plain[3].view(torch.int16))
            continue
        b_p, b_g, b_m, b_v = before
        for got, terms in ((m, (0.9 * b_m.float(), 0.1 * b_g)), (v, (0.999 * b_v.float(), 0.001 * b_g * b_g))):
            x32 = terms[0] + terms[1]
            slack = (terms[0].abs() + terms[1].abs() + x32.abs()) * 2.0**-20
            low, _ = fused_adam.bf16_neighbours(x32 - slack)
            _, high = fused_adam.bf16_neighbours(x32 + slack)
            assert ((got.float() >= low) & (got.float() <= high)).all()
    assert kernel.launches == 3 and kernel.table_rows == {1: 3}


@pytest.mark.cuda
@pytest.mark.parametrize("opt_name", ["adam", "lamb"])
def test_zero1_chunk_replays_equal_eager_chunks_on_the_card(card, opt_name):
    """Needs a GPU: 3 native chunks of 4 ZeRO-1 steps of toy_cnn with the
    clip, replayed against the same chunks run eagerly, from one state:
    bitwise; one launch per Adam update, each of one row."""
    batches = [tuple(t.cuda() for t in b) for b in _batches(12)]

    def run(replay):
        model = _toy()
        ddp = DistributedDataParallel(model, OPTIMIZERS[opt_name](model.parameters()),
                                      CrossEntropyLoss(), device="cuda", clip_grad_norm=0.5,
                                      weight_update_sharding=True)
        ddp._graph_replay = replay
        fused_adam.kernel.reset_launches()
        sums = [ddp.train_step_many(batches[i:i + 4]) for i in range(0, 12, 4)]
        torch.cuda.synchronize()
        return model.state_dict(), torch.stack(sums), fused_adam.kernel.launches, dict(
            fused_adam.kernel.table_rows)

    a, b = run(True), run(False)
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    assert torch.equal(a[1], b[1])
    if opt_name == "adam":
        assert a[2] == b[2] == 12 and set(a[3]) == set(b[3]) == {1}


def test_the_fast_file_is_the_jax_recipes_block():
    """``tpuddp_torch/configs/cifar10_alexnet_fast_h100.yaml`` is
    ``configs/cifar10_alexnet_fast.yaml``'s training block unchanged, on one
    GPU, and it parses."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = cfg.load_settings(os.path.join(root, "tpuddp_torch", "configs",
                                          "cifar10_alexnet_fast_h100.yaml"))
    ref = cfg.load_settings(os.path.join(root, "configs", "cifar10_alexnet_fast.yaml"))
    assert port["training"] == ref["training"]
    assert port["local"] == {"device": "cuda", "gpu": {"num_gpus": 1}}
    cfg.check_settings(port, world_size=1)
    training = cfg.training_config(port)
    assert (training["model"], training["weight_update_sharding"], training["compute_dtype"],
            training["optimizer_state_dtype"]) == ("alexnet_s2d", True, "bfloat16", "bfloat16")
