"""The port's Adam (tpuddp_torch.optim / ops.fused_adam) against the JAX
package's Adam and its Pallas FusedAdam (interpret mode), on the CPU, where
the wrapper runs the kernel's plain PyTorch version. The CUDA kernel itself
is held against the plain version on the card (the test marked ``cuda``,
and chip_smoke.py).

Tolerances (tests/test_fused_adam.py's): 1e-5 on parameters and 1e-6 on
moments after 3 steps — float32 arithmetic in two libraries, where a fused
multiply-add may round once instead of twice."""

import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuddp.ops import FusedAdam
from tpuddp.optim import Adam as JaxAdam

from tpuddp_torch.ops import _build, fused_adam
from tpuddp_torch.optim import Adam

P_TOL, MOMENT_TOL = 1e-5, 1e-6
LR = 1e-2


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


def _port_run(params, grads, weight_decay, steps=3):
    """The dispatcher on CPU tensors (-> the plain version)."""
    out = {}
    for k in params:
        p, g = torch.from_numpy(params[k].copy()), torch.from_numpy(grads[k])
        m, v = torch.zeros_like(p), torch.zeros_like(p)
        for t in range(1, steps + 1):
            bc1, bc2 = fused_adam.bias_corrections(t, (0.9, 0.999))
            fused_adam.adam_update(
                p, g, m, v, lr=LR, betas=(0.9, 0.999), eps=1e-8,
                weight_decay=weight_decay, bc1=bc1, bc2=bc2,
            )
        out[k] = (p, m, v)
    return out


def _assert_close(ours, ref_p, ref_state):
    for k, (p, m, v) in ours.items():
        np.testing.assert_allclose(p.numpy(), np.asarray(ref_p[k]), rtol=0, atol=P_TOL)
        np.testing.assert_allclose(m.numpy(), np.asarray(ref_state.m[k]), rtol=0, atol=MOMENT_TOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(ref_state.v[k]), rtol=0, atol=MOMENT_TOL)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_plain_version_matches_jax_adam(problem, weight_decay):
    params, grads = problem
    ref_p, ref_state = _jax_run(JaxAdam(LR, weight_decay=weight_decay), params, grads)
    _assert_close(_port_run(params, grads, weight_decay), ref_p, ref_state)


def test_plain_version_matches_pallas_kernel_in_interpret_mode(problem):
    params, grads = problem
    ref_p, ref_state = _jax_run(FusedAdam(LR, impl="pallas"), params, grads)
    assert int(ref_state.step) == 3
    _assert_close(_port_run(params, grads, 0.0), ref_p, ref_state)


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_optimizer_matches_jax_adam(problem, weight_decay):
    """tpuddp_torch.optim.Adam keeps per-parameter step/m/v and updates in
    place; over 3 steps it tracks the JAX Adam."""
    params, grads = problem
    ref_p, ref_state = _jax_run(JaxAdam(LR, weight_decay=weight_decay), params, grads)
    tensors = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = Adam(tensors.values(), lr=LR, weight_decay=weight_decay)
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
    bc1, bc2 = fused_adam.bias_corrections(7, (0.9, 0.999))
    assert bc1 == float(np.float32(1) - np.float32(0.9) ** np.float32(7))
    assert np.float32(bc2) == bc2  # exactly representable: computed in f32
    t = jnp.float32(7)
    np.testing.assert_allclose(bc1, float(1 - jnp.power(0.9, t)), rtol=2e-7)
    np.testing.assert_allclose(bc2, float(1 - jnp.power(0.999, t)), rtol=2e-7)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """The kernel wrapper takes CUDA float32 tensors only; the dispatcher
    sends CPU tensors to the plain version and refuses other devices."""
    p = torch.zeros(4)
    kw = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0, bc1=0.1, bc2=0.001)
    launches = fused_adam.kernel.launches
    with pytest.raises(ValueError, match="expected cuda"):
        fused_adam.kernel(p, p, p, p, **kw)
    meta = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_adam.adam_update(meta, meta, meta, meta, **kw)
    assert fused_adam.kernel.launches == launches


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


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_the_card(problem):
    """Needs a GPU and nvcc: builds csrc/fused_adam.cu and holds it against
    the plain version over 3 steps, with and without weight decay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    params, grads = problem
    for wd in (0.0, 1e-2):
        for k in params:
            p = torch.from_numpy(params[k]).cuda()
            g = torch.from_numpy(grads[k]).cuda()
            kern = [p.clone(), g, torch.zeros_like(p), torch.zeros_like(p)]
            plain = [p.clone(), g, torch.zeros_like(p), torch.zeros_like(p)]
            for t in range(1, 4):
                bc1, bc2 = fused_adam.bias_corrections(t, (0.9, 0.999))
                kw = dict(lr=LR, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd, bc1=bc1, bc2=bc2)
                fused_adam.kernel(*kern, **kw)
                fused_adam.adam_update_reference(*plain, **kw)
            torch.cuda.synchronize()
            for i, tol in ((0, P_TOL), (2, MOMENT_TOL), (3, MOMENT_TOL)):
                assert (kern[i] - plain[i]).abs().max().item() <= tol
