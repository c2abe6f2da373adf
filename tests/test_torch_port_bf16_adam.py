"""bf16 Adam moments in the port (tpuddp_torch.optim / ops.fused_adam)
against the JAX package's ``Adam(state_dtype="bfloat16")`` on the CPU, where
the wrapper runs the kernel's plain PyTorch version; the launch tables of the
bf16 instantiation; checkpoints of bf16 moments; and, on the card, the bf16
kernel against its plain version (the tests marked ``cuda``).

Tolerances:
- the Weyl-sequence rounding is integer arithmetic on the float32 bits:
  bitwise;
- moments after 3 steps: bitwise for 1-D leaves, and for every leaf one of
  the two bf16 neighbours of the JAX package's float32 moment (the float32
  update may round one ulp apart in two libraries, which can move the
  stochastic rounding to the other neighbour);
- parameters 1e-5 after 3 steps (tests/test_fused_adam.py's: float32
  arithmetic in two libraries, from unrounded moments)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuddp.optim import Adam as JaxAdam
from tpuddp.optim import _stochastic_round_bf16 as jax_round

from tpuddp_torch.models import ToyCNN
from tpuddp_torch.models.convert import jax_leaf_index
from tpuddp_torch.ops import fused_adam
from tpuddp_torch.optim import Adam, state_dtype_from
from tpuddp_torch.training import checkpoint as ckpt

P_TOL = 1e-5
LR = 1e-2
BETAS = (0.9, 0.999)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def _edge_values(rng) -> np.ndarray:
    """Signed zeros, subnormals, extremes, and float32 values on, just above,
    just below and half an ulp around a bf16 boundary."""
    b = rng.randn(64).astype(np.float32).view(np.uint32) & np.uint32(0xFFFF0000)
    special = np.array(
        [0.0, -0.0, 1e-40, -1e-40, 1e-45, -1e-45, np.finfo(np.float32).tiny,
         -np.finfo(np.float32).tiny, 3.0e38, -3.0e38, 1.0, -1.0], np.float32
    )
    near = np.concatenate([b, b + 1, b - 1, b + 0x7FFF, b + 0x8000, b + 0xFFFF])
    return np.concatenate([special, near.view(np.float32)])


@pytest.mark.parametrize("size", [1, 3, 4, 5, 7, 1001])
@pytest.mark.parametrize(
    "step, salt",
    [(1, fused_adam.moment_salts(0)[0]), (3, fused_adam.moment_salts(15)[1]),
     (65537, 0xFFFFFFFF), (2**31 + 5, 0x12345678)],
    ids=["m_leaf0_t1", "v_leaf15_t3", "wrap_t", "large_t"],
)
def test_weyl_rounding_is_bitwise_the_jax_packages(size, step, salt):
    rng = np.random.RandomState(size)
    x = np.concatenate([_edge_values(rng), rng.randn(size).astype(np.float32) * 1e-3])
    x = x[-size:] if size < 20 else x
    want = np.asarray(jax_round(jnp.asarray(x), jnp.asarray(np.uint32(step)), salt))
    got = fused_adam.stochastic_round_bf16(torch.from_numpy(x), step, salt)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    np.testing.assert_array_equal(_bits(got), want.view(np.uint16))


def test_weyl_rounding_keeps_the_shape_and_indexes_the_flat_layout():
    x = np.random.RandomState(1).randn(3, 5, 2).astype(np.float32)
    flat = fused_adam.stochastic_round_bf16(torch.from_numpy(x.reshape(-1)), 4, 99)
    got = fused_adam.stochastic_round_bf16(torch.from_numpy(x), 4, 99)
    assert got.shape == (3, 5, 2)
    np.testing.assert_array_equal(_bits(got).reshape(-1), _bits(flat))


def test_salts_are_the_jax_packages():
    """tpuddp/optim.py:127, 223-224 with leaf k: salt0 + 0x68E31DA4 (k + 1)."""
    for k in (0, 1, 15, 1000):
        m, v = fused_adam.moment_salts(k)
        assert m == (0x5ADA0000 + 0x68E31DA4 * (k + 1)) & 0xFFFFFFFF
        assert v == (0x7EE70000 + 0x68E31DA4 * (k + 1)) & 0xFFFFFFFF


@pytest.mark.parametrize(
    "name, want",
    [(None, torch.float32), ("float32", torch.float32), ("f32", torch.float32),
     ("fp32", torch.float32), ("bfloat16", torch.bfloat16), ("bf16", torch.bfloat16),
     (torch.bfloat16, torch.bfloat16)],
)
def test_state_dtype_names(name, want):
    assert state_dtype_from(name) == want


@pytest.mark.parametrize("name", ["float16", "fp16", "int8", "bfloat", ["bf16"]])
def test_unknown_state_dtypes_raise(name):
    with pytest.raises(ValueError, match="optimizer_state_dtype"):
        Adam([torch.nn.Parameter(torch.zeros(2))], state_dtype=name)


def test_bf16_moments_need_the_jax_leaf_index():
    """The salt of a leaf's rounding is its JAX flatten index, which the
    port's parameter order does not give (AlexNet's JAX tree puts each bias
    before its weight): bf16 moments refuse to guess it."""
    params = [torch.nn.Parameter(torch.zeros(2)), torch.nn.Parameter(torch.zeros(3))]
    with pytest.raises(ValueError, match="leaf_index"):
        Adam(params, state_dtype="bfloat16")
    with pytest.raises(ValueError, match="1 entries for 2 parameters"):
        Adam(params, state_dtype="bfloat16", leaf_index=[0])
    assert Adam(params, state_dtype="bfloat16", leaf_index=[1, 0]).leaf_index[params[0]] == 1
    Adam(params)  # float32 moments take no salt


# ------------------------------------------------------ against JAX Adam --

@pytest.fixture()
def problem():
    """tests/test_fused_adam.py's leaves plus a 4-D and a second 1-D one, in
    the JAX layout on both sides (the optimizer sees flat element order).
    Dict keys flatten sorted, so leaf k is the k-th key in sorted order."""
    rng = np.random.RandomState(0)
    params = {
        "b": rng.randn(5).astype(np.float32),
        "big": rng.randn(700, 130).astype(np.float32),
        "conv": rng.randn(3, 3, 4, 8).astype(np.float32),
        "scale": rng.randn(131).astype(np.float32),
        "w": rng.randn(37, 50).astype(np.float32),
    }
    grads = [
        {k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
        for _ in range(3)
    ]
    return params, grads


def _f32_moments_at_last_step(opt, params, grads):
    """The JAX package's float32 moments of the last step, before rounding:
    the state after the steps before it, widened, through its own update
    arithmetic (tpuddp/optim.py:204-211)."""
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(p)
    for g in grads[:-1]:
        p, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, p)
    g = {k: jnp.asarray(v) for k, v in grads[-1].items()}
    if opt.weight_decay:
        g = {k: g[k] + opt.weight_decay * p[k] for k in g}
    m = {k: opt.b1 * state.m[k].astype(jnp.float32) + (1 - opt.b1) * g[k] for k in g}
    v = {k: opt.b2 * state.v[k].astype(jnp.float32) + (1 - opt.b2) * jnp.square(g[k]) for k in g}
    return m, v


def _bf16_neighbours(x32: np.ndarray):
    """The bf16 values just below and just above each float32 (equal when x
    is a bf16 value), as float32."""
    bits = x32.view(np.uint32)
    down = (bits & np.uint32(0xFFFF0000)).view(np.float32)
    up = ((bits & np.uint32(0xFFFF0000)) + np.uint32(0x10000)).view(np.float32)
    exact = (bits & np.uint32(0xFFFF)) == 0
    return down, np.where(exact, down, up)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_bf16_moments_match_jax_adam(problem, weight_decay):
    params, grads = problem
    opt = JaxAdam(LR, weight_decay=weight_decay, state_dtype="bfloat16")
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(p)
    for g in grads:
        p, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, p)
    m32, v32 = _f32_moments_at_last_step(opt, params, grads)

    keys = sorted(params)
    tensors = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in keys]
    ours = Adam(tensors, lr=LR, weight_decay=weight_decay, state_dtype="bf16",
                leaf_index=range(len(keys)))
    for g in grads:
        for k, t in zip(keys, tensors):
            t.grad = torch.from_numpy(g[k])
        ours.step()

    for k, t in zip(keys, tensors):
        st = ours.state[t]
        assert st["step"] == 3
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(p[k]), rtol=0, atol=P_TOL, err_msg=k)
        for name, ref, ref32 in (("exp_avg", state.m[k], m32[k]), ("exp_avg_sq", state.v[k], v32[k])):
            got = st[name]
            assert got.dtype == torch.bfloat16 and got.shape == t.shape
            if t.dim() == 1:
                np.testing.assert_array_equal(_bits(got), np.asarray(ref).view(np.uint16), err_msg=f"{k} {name}")
            down, up = _bf16_neighbours(np.asarray(ref32, np.float32))
            g32 = got.float().numpy()
            assert ((g32 == down) | (g32 == up)).all(), f"{k} {name}"


def test_bf16_moments_follow_each_parameters_step_count_and_leaf_index():
    """The rounding of a leaf is keyed by its own step count and JAX leaf
    index: a parameter that skipped a step rounds as at its own count, and
    the same gradients under another leaf index round differently."""
    g = torch.from_numpy(np.random.RandomState(3).randn(4096).astype(np.float32))

    def run(leaf_index, skip=False):
        a, b = torch.nn.Parameter(torch.zeros(4096)), torch.nn.Parameter(torch.zeros(4096))
        opt = Adam([a, b], lr=LR, state_dtype="bfloat16", leaf_index=leaf_index)
        for step in (1, 2):
            a.grad, b.grad = g.clone(), g.clone()
            if skip and step == 1:
                b.grad = None
            opt.step()
        return opt.state[a], opt.state[b]

    a, b = run([0, 1])
    assert not torch.equal(a["exp_avg"], b["exp_avg"])  # leaf 0 vs leaf 1
    a_swapped, b_swapped = run([1, 0])
    assert torch.equal(a["exp_avg"], b_swapped["exp_avg"])
    _, b_skipped = run([0, 1], skip=True)
    assert b_skipped["step"] == 1
    ref = fused_adam.stochastic_round_bf16((1 - BETAS[0]) * g, 1, fused_adam.moment_salts(1)[0])
    assert torch.equal(b_skipped["exp_avg"], ref)


def test_bf16_dispatch_needs_steps_and_leaves_and_one_moment_dtype():
    p = torch.zeros(4)
    m = torch.zeros(4, dtype=torch.bfloat16)
    kw = dict(lr=1e-3, betas=BETAS, eps=1e-8, weight_decay=0.0, bc1s=[0.1], bc2s=[0.001])
    with pytest.raises(ValueError, match="step count and one JAX leaf index"):
        fused_adam.adam_update([p], [p], [m], [m.clone()], **kw)
    two = dict(kw, bc1s=[0.1, 0.1], bc2s=[0.001, 0.001], steps=[1, 1], leaves=[0, 1])
    with pytest.raises(TypeError, match="another dtype"):
        fused_adam.adam_update([p, p.clone()], [p, p], [m, p.clone()], [m.clone(), p.clone()], **two)
    with pytest.raises(TypeError, match="moments are torch.float16"):
        fused_adam.adam_update([p], [p], [p.half()], [p.half()], **kw)


# ------------------------------------------------------------ launch tables --

def test_bf16_tables_carry_the_noise_offsets_and_8_byte_alignment():
    """Four bf16 moments are 8 bytes: m and v need 8-byte alignment (not
    16), p and g still 16; a view at an odd bf16 offset is 2 bytes off."""
    base = 1 << 32
    ptrs = [
        (base, base + 4096, base + 8192, base + 12288),       # aligned
        (base, base + 4096, base + 8192 + 8, base + 12288),   # m 8 bytes off 16: fine
        (base, base + 4096, base + 8192 + 2, base + 12288),   # m at an odd bf16 offset
        (base + 8, base + 4096, base + 8192, base + 12288),   # p 8 bytes off 16
    ]
    noise = [(fused_adam.noise_offset(t, fused_adam.moment_salts(k)[0]),
              fused_adam.noise_offset(t, fused_adam.moment_salts(k)[1]))
             for t, k in ((1, 0), (2, 5), (3, 7), (70000, 2))]
    (t,) = fused_adam.launch_tables(ptrs, [10] * 4, [0.1] * 4, [0.01] * 4,
                                    noise=noise, moment_bytes=2)
    assert t["aligned"].tolist() == [1, 1, 0, 0]
    assert t["noise_m"].tolist() == [n[0] for n in noise]
    assert t["noise_v"].tolist() == [n[1] for n in noise]
    (f32,) = fused_adam.launch_tables(ptrs, [10] * 4, [0.1] * 4, [0.01] * 4)
    assert f32["aligned"].tolist() == [1, 0, 0, 0]
    assert f32["noise_m"].tolist() == [0] * 4 and f32["noise_v"].tolist() == [0] * 4


def test_bf16_neighbours_bound_every_stochastic_rounding():
    rng = np.random.RandomState(6)
    x = torch.from_numpy(np.concatenate([_edge_values(rng), rng.randn(500).astype(np.float32)]))
    low, high = fused_adam.bf16_neighbours(x)
    assert (low <= x).all() and (x <= high).all()
    assert torch.equal(low.bfloat16().float(), low) and torch.equal(high.bfloat16().float(), high)
    exact = x.bfloat16().float() == x
    assert torch.equal(low[exact], x[exact]) and torch.equal(high[exact], x[exact])
    for step in range(1, 40):
        got = fused_adam.stochastic_round_bf16(x, step, 12345).float()
        assert ((got == low) | (got == high)).all()


def test_noise_offset_is_the_step_and_salt_part_of_the_jax_noise():
    """noise(i) = (i * 0x9E3779B1 + offset) mod 2^16 reproduces the JAX
    rounding for every i."""
    x = np.random.RandomState(4).randn(300).astype(np.float32)
    step, salt = 12, fused_adam.moment_salts(3)[1]
    off = fused_adam.noise_offset(step, salt)
    bits = x.view(np.uint32).astype(np.uint64)
    i = np.arange(x.size, dtype=np.uint64)
    noise = (i * 0x9E3779B1 + off) & 0xFFFF
    want = (((bits + noise) & 0xFFFFFFFF) >> 16).astype(np.uint16)
    np.testing.assert_array_equal(_bits(fused_adam.stochastic_round_bf16(torch.from_numpy(x), step, salt)), want)


# ----------------------------------------------------------------- the card --

CARD_LR = 1e-3


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    return torch.device("cuda")


def _card_leaves(numels, seed, misaligned="", zero_grad=False):
    """(p, g, m, v) per leaf on the card from numpy, bf16 moments from
    non-zero values; the tensors named in `misaligned` are views at storage
    offset 1 (4 bytes off for p and g, 2 for m and v)."""
    rng = np.random.RandomState(seed)
    leaves = []
    for n in numels:
        host = [rng.randn(n).astype(np.float32),
                np.zeros(n, np.float32) if zero_grad else rng.randn(n).astype(np.float32)]
        host += [rng.randn(n).astype(np.float32) * 1e-2, np.abs(rng.randn(n)).astype(np.float32) * 1e-3]
        leaf = []
        for name, x in zip("pgmv", host):
            t = torch.from_numpy(x).cuda()
            if name in "mv":
                t = t.to(torch.bfloat16)
            if name in misaligned:
                t = torch.empty(n + 1, dtype=t.dtype, device="cuda")[1:].copy_(t)
            leaf.append(t)
        leaves.append(leaf)
    return leaves


@pytest.mark.cuda
@pytest.mark.parametrize(
    "numels, misaligned, weight_decay, zero_grad",
    [
        ([37 * 50, 5, 700 * 130], "", 0.0, False),
        ([37 * 50, 5, 700 * 130], "", 1e-2, False),
        *[([37 * 50, 5, 700 * 130], name, 1e-2, False) for name in "pgmv"],
        ([1, 3, 4], "", 0.0, False),
        ([1 + (i * 7919) % 40000 for i in range(100)], "", 1e-2, False),
        ([37 * 50, 5, 700 * 130, 4097], "", 0.0, True),
    ],
    ids=["leaves", "leaves_wd", "view_p", "view_g", "view_m", "view_v", "tiny",
         "100_leaves", "zero_grad"],
)
def test_bf16_kernel_matches_plain_version_on_the_card(card, numels, misaligned, weight_decay, zero_grad):
    """Needs a GPU and nvcc: the bf16 instantiation against the plain
    version over 3 steps, each leaf with its own step count and leaf index,
    at the main path's lr 1e-3, the plain version taking the kernel's state
    before each step. p within 1e-5. Each stored moment a bf16 neighbour of
    a value within 2^-20 of the terms of the plain version's unrounded
    float32 moment: the kernel's fused multiply-adds round once where the
    plain version rounds twice, which can move the float32 moment across a
    rounding threshold (or, where 0.9 m + 0.1 g cancels, across zero).
    Bitwise with zero gradients: both float32 moments are then b * m,
    rounded once."""
    kern = _card_leaves(numels, seed=len(numels), misaligned=misaligned, zero_grad=zero_grad)
    kernel = fused_adam.kernels[torch.bfloat16]
    launches = kernel.launches
    leaves = [(7 * i + 3) % 50 for i in range(len(numels))]
    b1, b2 = BETAS
    for t in range(1, 4):
        before = [[x.clone() for x in leaf] for leaf in kern]
        plain = [[x.clone() for x in leaf] for leaf in kern]
        steps = [t + i % 3 for i in range(len(numels))]
        bcs = [fused_adam.bias_corrections(s, BETAS) for s in steps]
        kw = dict(lr=CARD_LR, betas=BETAS, eps=1e-8, weight_decay=weight_decay)
        kernel(*(list(x) for x in zip(*kern)), bc1s=[b[0] for b in bcs],
               bc2s=[b[1] for b in bcs], steps=steps, leaves=leaves, **kw)
        for leaf, (bc1, bc2), s, k in zip(plain, bcs, steps, leaves):
            fused_adam.adam_update_reference(*leaf, bc1=bc1, bc2=bc2, step=s, leaf=k, **kw)
        torch.cuda.synchronize()
        for k, pl, (p, g, m, v) in zip(kern, plain, before):
            assert (k[0] - pl[0]).abs().max().item() <= P_TOL
            if zero_grad:
                assert torch.equal(k[2].view(torch.int16), pl[2].view(torch.int16))
                assert torch.equal(k[3].view(torch.int16), pl[3].view(torch.int16))
                continue
            g = g + weight_decay * p if weight_decay else g
            for got, terms in ((k[2], (b1 * m.float(), (1 - b1) * g)),
                               (k[3], (b2 * v.float(), (1 - b2) * g * g))):
                x32 = terms[0] + terms[1]
                slack = (terms[0].abs() + terms[1].abs() + x32.abs()) * 2.0**-20
                low, _ = fused_adam.bf16_neighbours(x32 - slack)
                _, high = fused_adam.bf16_neighbours(x32 + slack)
                assert ((got.float() >= low) & (got.float() <= high)).all()
    assert kernel.launches - launches == 3 * math.ceil(len(numels) / fused_adam.MAX_LEAVES)


# -------------------------------------------------------------- checkpoints --

def _adam(model, **kw):
    index = jax_leaf_index("toy_cnn", model)
    return Adam(model.parameters(), leaf_index=[index[n] for n, _ in model.named_parameters()], **kw)


def _trained(state_dtype, seed=0):
    torch.manual_seed(seed)
    model = ToyCNN(10, (4, 8), input_shape=(8, 8, 3))
    opt = _adam(model, lr=LR, state_dtype=state_dtype)
    for _ in range(2):
        model.train()(torch.randn(3, 8, 8, 3)).square().mean().backward()
        opt.step()
    return model, opt


def test_bf16_checkpoint_round_trips_bitwise(tmp_path):
    """bf16 moments are saved as uint16 bit views under __bf16__ (the JAX
    package's key, tpuddp/training/checkpoint.py:99-101) and come back
    bitwise as bf16; BatchNorm buffers are model state."""
    model, opt = _trained("bfloat16")
    path = ckpt.save_on_main(str(tmp_path), 3, model, opt, rank=0)
    with np.load(path) as data:
        assert data["__bf16__.opt_state.m[0]['weight']"].dtype == np.uint16
        assert ".opt_state.m[0]['weight']" not in data.files
        assert ".model_state[1]['var']" in data.files
    other, other_opt = _trained("bfloat16", seed=1)
    assert ckpt.load(path, other, other_opt)["epoch"] == 3
    for k, v in model.state_dict().items():
        assert torch.equal(v, other.state_dict()[k]), k
    for p, q in zip(model.parameters(), other.parameters()):
        a, b = opt.state[p], other_opt.state[q]
        assert b["step"] == a["step"] == 2
        for key in ("exp_avg", "exp_avg_sq"):
            assert b[key].dtype == torch.bfloat16
            np.testing.assert_array_equal(_bits(b[key]), _bits(a[key]))


@pytest.mark.parametrize("saved, loading", [("bfloat16", "float32"), ("float32", "bfloat16")])
def test_checkpoint_of_other_moment_dtype_is_refused(tmp_path, saved, loading):
    model, opt = _trained(saved)
    path = ckpt.save_on_main(str(tmp_path), 1, model, opt, rank=0)
    other = ToyCNN(10, (4, 8), input_shape=(8, 8, 3))
    with pytest.raises(ValueError, match="training.optimizer_state_dtype"):
        ckpt.load(path, other, _adam(other, state_dtype=loading))
