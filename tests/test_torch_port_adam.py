"""The port's Adam (tpuddp_torch.optim / ops.fused_adam) against the JAX
package's Adam and its Pallas FusedAdam (interpret mode), on the CPU, where
the wrapper runs the kernel's plain PyTorch version; and the kernel's launch
tables, which are built in Python. The CUDA kernel itself is held against
the plain version on the card (the test marked ``cuda``, and chip_smoke.py).

Tolerances (tests/test_fused_adam.py's): 1e-5 on parameters and 1e-6 on
moments after 3 steps — float32 arithmetic in two libraries, where a fused
multiply-add may round once instead of twice."""

import math
import os
import re
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuddp.ops import FusedAdam
from tpuddp.optim import Adam as JaxAdam

from tpuddp_torch import optim as port_optim
from tpuddp_torch.models import AlexNet
from tpuddp_torch.ops import _build, fused_adam
from tpuddp_torch.optim import Adam

P_TOL, MOMENT_TOL = 1e-5, 1e-6
LR = 1e-2
BETAS = (0.9, 0.999)
CHUNK = fused_adam.CHUNK


@pytest.fixture()
def problem():
    """tests/test_fused_adam.py's leaves: a matrix, one shorter than a TPU
    lane, and one spanning several TPU blocks."""
    rng = np.random.RandomState(0)
    params = {
        "w": rng.randn(37, 50).astype(np.float32),
        "b": rng.randn(5).astype(np.float32),
        "big": rng.randn(700, 130).astype(np.float32),
    }
    grads = {k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
    return params, grads


def _jax_run(opt, params, grads, steps=3):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    g = {k: jnp.asarray(v) for k, v in grads.items()}
    state = opt.init(p)
    for _ in range(steps):
        p, state = opt.update(g, state, p)
    return p, state


def _port_run(params, grads, weight_decay, grouping, steps=3):
    """The dispatcher on CPU tensors (-> the plain version): one call for all
    leaves, or one call per leaf (a list of one)."""
    out = {
        k: (torch.from_numpy(params[k].copy()), torch.from_numpy(grads[k]),
            torch.zeros(params[k].shape), torch.zeros(params[k].shape))
        for k in params
    }
    calls = [list(out.values())] if grouping == "one_call" else [[leaf] for leaf in out.values()]
    for t in range(1, steps + 1):
        bc1, bc2 = fused_adam.bias_corrections(t, BETAS)
        for leaves in calls:
            ps, gs, ms, vs = (list(x) for x in zip(*leaves))
            fused_adam.adam_update(
                ps, gs, ms, vs, lr=LR, betas=BETAS, eps=1e-8, weight_decay=weight_decay,
                bc1s=[bc1] * len(ps), bc2s=[bc2] * len(ps),
            )
    return {k: (p, m, v) for k, (p, _, m, v) in out.items()}


def _assert_close(ours, ref_p, ref_state):
    for k, (p, m, v) in ours.items():
        np.testing.assert_allclose(p.numpy(), np.asarray(ref_p[k]), rtol=0, atol=P_TOL)
        np.testing.assert_allclose(m.numpy(), np.asarray(ref_state.m[k]), rtol=0, atol=MOMENT_TOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(ref_state.v[k]), rtol=0, atol=MOMENT_TOL)


@pytest.mark.parametrize("grouping", ["one_call", "call_per_leaf"])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_plain_version_matches_jax_adam(problem, weight_decay, grouping):
    params, grads = problem
    ref_p, ref_state = _jax_run(JaxAdam(LR, weight_decay=weight_decay), params, grads)
    _assert_close(_port_run(params, grads, weight_decay, grouping), ref_p, ref_state)


@pytest.mark.parametrize("grouping", ["one_call", "call_per_leaf"])
def test_plain_version_matches_pallas_kernel_in_interpret_mode(problem, grouping):
    params, grads = problem
    ref_p, ref_state = _jax_run(FusedAdam(LR, impl="pallas"), params, grads)
    assert int(ref_state.step) == 3
    _assert_close(_port_run(params, grads, 0.0, grouping), ref_p, ref_state)


@pytest.mark.parametrize("groups", ["one_group", "group_per_param"])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_optimizer_matches_jax_adam(problem, weight_decay, groups):
    """tpuddp_torch.optim.Adam keeps per-parameter step/m/v and updates in
    place, one adam_update call per param group; over 3 steps it tracks the
    JAX Adam."""
    params, grads = problem
    ref_p, ref_state = _jax_run(JaxAdam(LR, weight_decay=weight_decay), params, grads)
    tensors = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    param_groups = (
        list(tensors.values()) if groups == "one_group"
        else [{"params": [t]} for t in tensors.values()]
    )
    opt = Adam(param_groups, lr=LR, weight_decay=weight_decay)
    for _ in range(3):
        for k, t in tensors.items():
            t.grad = torch.from_numpy(grads[k])
        opt.step()
    ours = {}
    for k, t in tensors.items():
        st = opt.state[t]
        assert st["step"] == 3
        ours[k] = (t.detach(), st["exp_avg"], st["exp_avg_sq"])
    _assert_close(ours, ref_p, ref_state)


def test_bias_corrections_are_float32():
    bc1, bc2 = fused_adam.bias_corrections(7, BETAS)
    assert bc1 == float(np.float32(1) - np.float32(0.9) ** np.float32(7))
    assert np.float32(bc2) == bc2  # exactly representable: computed in f32
    t = jnp.float32(7)
    np.testing.assert_allclose(bc1, float(1 - jnp.power(0.9, t)), rtol=2e-7)
    np.testing.assert_allclose(bc2, float(1 - jnp.power(0.999, t)), rtol=2e-7)


def test_bias_corrections_follow_each_parameters_step_count(monkeypatch):
    """A parameter without a gradient on step 2 keeps count 1; on step 3 its
    leaf gets bias_corrections(2) while the others get bias_corrections(3),
    all in one adam_update call."""
    calls = []

    def recording_update(ps, gs, ms, vs, **kw):
        calls.append((len(ps), kw["bc1s"], kw["bc2s"]))
        fused_adam.adam_update(ps, gs, ms, vs, **kw)

    monkeypatch.setattr(port_optim, "adam_update", recording_update)
    a, b, c = (torch.nn.Parameter(torch.ones(n)) for n in (3, 4, 5))
    opt = Adam([a, b, c], lr=LR)
    for step in (1, 2, 3):
        for t in (a, b, c):
            t.grad = torch.full_like(t, 0.5)
        if step == 2:
            b.grad = None
        opt.step()
    assert [opt.state[t]["step"] for t in (a, b, c)] == [3, 2, 3]
    bc = {s: fused_adam.bias_corrections(s, BETAS) for s in (1, 2, 3)}
    assert [n for n, _, _ in calls] == [3, 2, 3]
    assert calls[1][1:] == ([bc[2][0]] * 2, [bc[2][1]] * 2)
    assert calls[2][1] == [bc[3][0], bc[2][0], bc[3][0]]
    assert calls[2][2] == [bc[3][1], bc[2][1], bc[3][1]]


# ------------------------------------------------------------ launch tables --

def _fake_pointers(numels, base=1 << 32):
    """Aligned, non-overlapping (p, g, m, v) addresses, 512 B apart at least,
    as the caching allocator hands them out."""
    ptrs, addr = [], base
    for n in numels:
        four = []
        for _ in range(4):
            four.append(addr)
            addr += -(-4 * n // 512) * 512 + 512
        ptrs.append(tuple(four))
    return ptrs


def _tables(numels, ptrs=None, bcs=None):
    ptrs = ptrs or _fake_pointers(numels)
    bcs = bcs or [fused_adam.bias_corrections(1 + i % 3, BETAS) for i in range(len(numels))]
    return fused_adam.launch_tables(ptrs, numels, [b[0] for b in bcs], [b[1] for b in bcs])


def _prefix_starts(numels):
    return np.cumsum([0] + [-(-n // CHUNK) for n in numels[:-1]])


def test_launch_table_of_alexnet_is_one_aligned_table():
    with torch.device("meta"):
        numels = [p.numel() for p in AlexNet(num_classes=10).parameters()]
    assert len(numels) == 16 and sum(numels) == 57_044_810
    ptrs = _fake_pointers(numels)
    tables = _tables(numels, ptrs)
    assert len(tables) == 1
    (t,) = tables
    assert t.dtype == fused_adam.LEAF_DTYPE and t.flags.c_contiguous
    np.testing.assert_array_equal(t["n"], numels)
    np.testing.assert_array_equal(t["chunk_start"], _prefix_starts(numels))
    np.testing.assert_array_equal(t["aligned"], 1)
    np.testing.assert_array_equal(np.stack([t[k] for k in "pgmv"], axis=1), ptrs)


def test_launch_tables_carry_each_leafs_bias_corrections_in_float32():
    numels = [3, 4, 5]
    bcs = [fused_adam.bias_corrections(s, BETAS) for s in (7, 2, 7)]
    (t,) = _tables(numels, bcs=bcs)
    assert t["bc1"].tolist() == [b[0] for b in bcs]
    assert t["bc2"].tolist() == [b[1] for b in bcs]


@pytest.mark.parametrize(
    "numels",
    [[1, 3, 4], [CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK + 3], [5, 3 * CHUNK + 1, 1]],
    ids=["tiny", "straddling", "mixed"],
)
def test_launch_table_chunk_starts_are_prefix_sums(numels):
    (t,) = _tables(numels)
    np.testing.assert_array_equal(t["chunk_start"], _prefix_starts(numels))


def test_launch_tables_split_at_max_leaves():
    numels = [1 + (i * 7919) % 40000 for i in range(100)]
    tables = _tables(numels)
    m = fused_adam.MAX_LEAVES
    assert [len(t) for t in tables] == [m, m, 100 - 2 * m]
    np.testing.assert_array_equal(np.concatenate([t["n"] for t in tables]), numels)
    for k, t in enumerate(tables):
        np.testing.assert_array_equal(
            t["chunk_start"], _prefix_starts(numels[k * m:(k + 1) * m])
        )


def test_launch_tables_drop_empty_leaves():
    numels = [0, 7, 0, 0, 9, 0]
    (t,) = _tables(numels)
    assert t["n"].tolist() == [7, 9]
    assert t["chunk_start"].tolist() == [0, 1]
    assert _tables([0, 0]) == []
    # 48 non-empty leaves among empty ones still fit one table
    assert len(_tables([0, 1] * fused_adam.MAX_LEAVES)) == 1


@pytest.mark.parametrize("which", range(4), ids=list("pgmv"))
def test_a_pointer_off_by_4_bytes_flags_its_leaf_unaligned(which):
    numels = [10, 20, 30]
    ptrs = [list(four) for four in _fake_pointers(numels)]
    ptrs[1][which] += 4
    (t,) = _tables(numels, [tuple(four) for four in ptrs])
    assert t["aligned"].tolist() == [1, 0, 1]


def test_leaf_dtype_matches_the_c_struct():
    """LEAF_DTYPE's size and offsets are the ones csrc/fused_adam.cu
    static_asserts for `struct Leaf`; its kMaxLeaves is MAX_LEAVES."""
    src = fused_adam.SOURCE.read_text()
    (size,) = re.findall(r"static_assert\(sizeof\(Leaf\) == (\d+)", src)
    offsets = dict(re.findall(r"static_assert\(offsetof\(Leaf, (\w+)\) == (\d+)", src))
    dtype = fused_adam.LEAF_DTYPE
    assert dtype.itemsize == int(size) == 72
    assert {k: dtype.fields[k][1] for k in dtype.names} == {k: int(v) for k, v in offsets.items()}
    assert re.search(r"constexpr int kMaxLeaves = (\d+);", src).group(1) == str(fused_adam.MAX_LEAVES)
    # Table (16-byte header + MAX_LEAVES rows), chunk and 7 float hyperparameters
    # within the 4 KB of kernel parameters
    assert 16 + fused_adam.MAX_LEAVES * dtype.itemsize + 8 + 7 * 4 <= 4096
    # the kernel needs chunk starts at multiples of 4 elements (16 bytes)
    assert CHUNK % 4 == 0 and CHUNK & (CHUNK - 1) == 0


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """The kernel wrapper takes lists of CUDA float32 tensors only; the
    dispatcher sends CPU lists to the plain version and refuses other
    devices, mixed devices and lists of unequal length."""
    p = torch.zeros(4)
    kw = dict(lr=1e-3, betas=BETAS, eps=1e-8, weight_decay=0.0, bc1s=[0.1], bc2s=[0.001])
    launches = fused_adam.kernel.launches
    with pytest.raises(ValueError, match="expected cuda"):
        fused_adam.kernel([p], [p], [p], [p], **kw)
    meta = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_adam.adam_update([meta], [meta], [meta], [meta], **kw)
    two = dict(kw, bc1s=[0.1, 0.1], bc2s=[0.001, 0.001])
    q = torch.ones(4)
    with pytest.raises(ValueError, match="leaf 1 has a tensor on meta"):
        fused_adam.adam_update([p, q], [p, meta], [p, q], [p, q], **two)
    assert q.tolist() == [1.0] * 4  # refused before any leaf was updated
    with pytest.raises(ValueError):
        fused_adam.adam_update([p, p], [p], [p, p], [p, p], **two)
    assert fused_adam.kernel.launches == launches
    fused_adam.adam_update([], [], [], [], **dict(kw, bc1s=[], bc2s=[]))


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_failed_build_raises_and_publishes_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    nvcc = _fake_nvcc(tmp_path, "echo 'error: bad source' >&2\nexit 3\n")
    with pytest.raises(RuntimeError, match="(?s)nvcc failed \\(3\\).*bad source"):
        _build.build(fused_adam.SOURCE, "fused_adam", nvcc=nvcc)
    assert not list((tmp_path / "build").iterdir())


def test_build_is_keyed_by_source_and_runs_once(tmp_path, monkeypatch):
    """The second build of an unchanged source reuses the library; a changed
    source builds anew. The build passes sm_90a and no fast math."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    log = tmp_path / "calls"
    # the fake compiler records its arguments and writes the -o file
    nvcc = _fake_nvcc(
        tmp_path,
        f'echo "$@" >> {log}\n'
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo lib > "$2"\n',
    )
    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    first, out = _build.build(src, "k", nvcc=nvcc)
    again, out_again = _build.build(src, "k", nvcc=nvcc)
    src.write_text("// v2\n")
    changed, _ = _build.build(src, "k", nvcc=nvcc)
    calls = log.read_text().splitlines()
    assert first == again and first != changed and out_again == ""
    assert len(calls) == 2
    assert "arch=compute_90a,code=sm_90a" in calls[0] and "fast_math" not in calls[0]
    assert sorted(os.listdir(tmp_path / "build")) == sorted([first.name, changed.name])


# ----------------------------------------------------------------- the card --

@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    return torch.device("cuda")


def _card_leaves(numels, seed, misaligned=""):
    """(p, g, m, v) per leaf on the card from numpy; the tensors named in
    `misaligned` are views at storage offset 1 (4 bytes off alignment)."""
    rng = np.random.RandomState(seed)
    leaves = []
    for n in numels:
        host = [rng.randn(n).astype(np.float32) for _ in range(2)]
        host += [np.zeros(n, np.float32), np.abs(rng.randn(n)).astype(np.float32) * 1e-3]
        leaf = []
        for name, x in zip("pgmv", host):
            t = torch.from_numpy(x).cuda()
            if name in misaligned:
                t = torch.empty(n + 1, device="cuda")[1:].copy_(t)
                assert t.data_ptr() % 16 == 4 and t.is_contiguous()
            leaf.append(t)
        leaves.append(leaf)
    return leaves


@pytest.mark.cuda
@pytest.mark.parametrize(
    "numels, misaligned, weight_decay",
    [
        ([37 * 50, 5, 700 * 130], "", 0.0),
        ([37 * 50, 5, 700 * 130], "", 1e-2),
        *[([37 * 50, 5, 700 * 130], name, 1e-2) for name in "pgmv"],
        ([1, 3, 4], "", 0.0),
        ([1 + (i * 7919) % 40000 for i in range(100)], "", 1e-2),
    ],
    ids=["leaves", "leaves_wd", "view_p", "view_g", "view_m", "view_v", "tiny", "100_leaves"],
)
def test_kernel_matches_plain_version_on_the_card(card, numels, misaligned, weight_decay):
    """Needs a GPU and nvcc: builds csrc/fused_adam.cu and holds it against
    the plain version over 3 steps, each leaf with its own step count; one
    launch per 48 leaves and step."""
    kern = _card_leaves(numels, seed=len(numels), misaligned=misaligned)
    plain = [[t.clone() for t in leaf] for leaf in kern]
    launches = fused_adam.kernel.launches
    for t in range(1, 4):
        bcs = [fused_adam.bias_corrections(t + i % 3, BETAS) for i in range(len(numels))]
        kw = dict(lr=LR, betas=BETAS, eps=1e-8, weight_decay=weight_decay)
        fused_adam.kernel(*(list(x) for x in zip(*kern)), bc1s=[b[0] for b in bcs],
                          bc2s=[b[1] for b in bcs], **kw)
        for leaf, (bc1, bc2) in zip(plain, bcs):
            fused_adam.adam_update_reference(*leaf, bc1=bc1, bc2=bc2, **kw)
    torch.cuda.synchronize()
    assert fused_adam.kernel.launches - launches == 3 * math.ceil(len(numels) / fused_adam.MAX_LEAVES)
    for k, pl in zip(kern, plain):
        for i, tol in ((0, P_TOL), (2, MOMENT_TOL), (3, MOMENT_TOL)):
            assert (k[i] - pl[i]).abs().max().item() <= tol
