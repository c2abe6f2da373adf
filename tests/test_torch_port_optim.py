"""The port's SGD, SGDW, LARS, LAMB and global-norm clip
(tpuddp_torch/optim.py) against the JAX package's (tpuddp/optim.py), on the
CPU: 3 steps from one state on toy_mlp's and toy_cnn's trees (the JAX init
and seeded gradients, moved between the layouts by models/convert.py), with
and without momentum and weight decay; the zero-norm fallback of the trust
ratios; the clip above and below its bound; and ``config.optimizer_from``
with the JAX factory's quirks.

Tolerances, float32: parameters and optimizer state rtol 1e-5 / atol 1e-6
(two libraries reducing the norms in another order); the clip's norm rtol
1e-5."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from tpuddp import config as jax_cfg
from tpuddp import optim as jax_optim

from tpuddp_torch import config as cfg
from tpuddp_torch import optim
from tpuddp_torch.models.convert import jax_from_state_dict, torch_layout

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from test_torch_port_accelerate import MODELS, inits, port_model  # noqa: E402,F401

RTOL, ATOL = 1e-5, 1e-6
LR, STEPS = 0.05, 3

# (optimizer, its keyword arguments, the same in both packages)
CASES = {
    "sgd": ("SGD", dict(momentum=0.9, weight_decay=5e-4)),
    "sgd-momentum0": ("SGD", dict(momentum=0.0, weight_decay=5e-4)),
    "sgd-no-decay": ("SGD", dict(momentum=0.9)),
    "sgdw": ("SGDW", dict(momentum=0.9, weight_decay=5e-4)),
    "sgdw-momentum0": ("SGDW", dict(momentum=0.0, weight_decay=1e-2)),
    "lars": ("LARS", dict(momentum=0.9, weight_decay=5e-4, trust_coefficient=0.001)),
    "lars-momentum0": ("LARS", dict(momentum=0.0, weight_decay=0.0, trust_coefficient=0.02)),
    "lamb": ("LAMB", dict(weight_decay=0.0)),
    "lamb-decay": ("LAMB", dict(weight_decay=1e-2)),
}
# the optimizer's state in the JAX tree -> the port's per-parameter key
SLOTS = {"momentum": "momentum_buffer", "m": "exp_avg", "v": "exp_avg_sq"}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _grads(params, seed, scale=0.1):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: (rng.randn(*np.shape(p)) * scale).astype(np.float32), _np(params))


def _set_grads(name, model, grads):
    by_name = torch_layout(name, grads)
    for pname, p in model.named_parameters():
        p.grad = torch.from_numpy(by_name[pname].copy())


def _assert_tree_close(got, want, what):
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want), what
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=what),
        _np(got), _np(want))


def _assert_state_close(name, model, opt, jax_state, what):
    """The port's per-parameter state against the JAX optimizer state."""
    for slot, key in SLOTS.items():
        tree = getattr(jax_state, slot, None)
        if tree is None:
            continue
        want = torch_layout(name, _np(tree))
        for pname, p in model.named_parameters():
            np.testing.assert_allclose(opt.state[p][key].numpy(), want[pname], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{what} {slot} {pname}")
    if hasattr(jax_state, "step"):
        assert all(opt.state[p]["step"] == int(jax_state.step) for p in model.parameters())


def _run_both(name, inits, kind, kw, params=None, steps=STEPS):
    """``steps`` updates of each package's optimizer from the same state and
    gradients; each step's parameters and state compared."""
    jparams, mstate, sd = inits[name]
    if params is not None:
        jparams = params
    model = port_model(name)
    model.load_state_dict(sd)
    if params is not None:
        model.load_state_dict(dict(sd, **{k: torch.from_numpy(v.copy()) for k, v in
                                          torch_layout(name, _np(params)).items()}))
    opt = getattr(optim, kind)(model.parameters(), lr=LR, **kw)
    jopt = getattr(jax_optim, kind)(lr=LR, **kw)
    jstate = jopt.init(jparams)
    for t in range(steps):
        grads = _grads(jparams, seed=10 + t)
        _set_grads(name, model, grads)
        opt.step()
        jparams, jstate = jopt.update(grads, jstate, jparams)
        got, _ = jax_from_state_dict(name, model.state_dict())
        _assert_tree_close(got, jparams, f"{kind} step {t}")
        _assert_state_close(name, model, opt, jstate, f"{kind} step {t}")
    return model, opt


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_jax_over_3_steps(inits, name, case):
    kind, kw = CASES[case]
    model, opt = _run_both(name, inits, kind, kw)
    keeps_state = not (kind in ("SGD", "SGDW") and kw["momentum"] == 0.0)
    assert bool(opt.state) == keeps_state


@pytest.mark.parametrize("kind", ["LARS", "LAMB"])
def test_a_zero_norm_layer_takes_the_unscaled_step(inits, kind):
    """toy_mlp's first weight set to zero: ratio 1 for it (the JAX
    ``_safe_ratio``), and for LARS the first step of that layer is
    ``-lr * g`` exactly."""
    params = jax.tree_util.tree_map(np.asarray, inits["toy_mlp"][0])
    params = list(params)
    params[1] = dict(params[1], weight=np.zeros_like(params[1]["weight"]))
    params = tuple(params)
    kw = CASES[kind.lower()][1]
    model, opt = _run_both("toy_mlp", inits, kind, kw, params=params, steps=1)
    names = [n for n, _ in model.named_parameters()]
    ratios = opt.trust_ratios.numpy()
    assert ratios[names.index("1.weight")] == 1.0
    others = [i for i, n in enumerate(names) if n.endswith("weight") and n != "1.weight"]
    assert others and np.all(ratios[others] != 1.0)
    if kind == "LARS":
        g = torch_layout("toy_mlp", _grads(params, seed=10))["1.weight"]
        np.testing.assert_array_equal(dict(model.named_parameters())["1.weight"].detach().numpy(),
                                      -(g * np.float32(LR)))


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["below", "above"])
def test_clip_matches_jax(inits, name, scale):
    """Gradients whose global norm is under and over ``max_norm = 1``: the
    pre-clip norm and the clipped gradients (unchanged, bitwise, under)."""
    grads = _grads(inits[name][0], seed=3, scale=scale)
    model = port_model(name)
    _set_grads(name, model, grads)
    before = {n: p.grad.clone() for n, p in model.named_parameters()}
    norm = optim.clip_grad_norm_(model.parameters(), 1.0)
    ref, ref_norm = jax_optim.clip_grad_norm_(grads, 1.0)
    np.testing.assert_allclose(float(norm), float(ref_norm), rtol=RTOL)
    assert (float(norm) > 1.0) == (scale > 1.0)
    np.testing.assert_allclose(float(optim.global_norm([p.grad for p in model.parameters()])),
                               min(float(ref_norm), 1.0), rtol=RTOL)
    want = torch_layout(name, _np(ref))
    for pname, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[pname], rtol=RTOL, atol=ATOL, err_msg=pname)
        if scale < 1.0:
            assert torch.equal(p.grad, before[pname])


@pytest.mark.parametrize("kind", ["SGD", "LAMB"])
def test_clip_then_update_matches_jax(inits, kind):
    """The update half of both paths: clip to 0.5, then the optimizer."""
    kw = CASES[kind.lower()][1]
    jparams, _, sd = inits["toy_cnn"]
    model = port_model("toy_cnn")
    model.load_state_dict(sd)
    opt = getattr(optim, kind)(model.parameters(), lr=LR, **kw)
    jopt = getattr(jax_optim, kind)(lr=LR, **kw)
    jstate = jopt.init(jparams)
    for t in range(2):
        grads = _grads(jparams, seed=20 + t, scale=1.0)
        _set_grads("toy_cnn", model, grads)
        optim.clip_grad_norm_(model.parameters(), 0.5)
        opt.step()
        clipped, _ = jax_optim.clip_grad_norm_(grads, 0.5)
        jparams, jstate = jopt.update(clipped, jstate, jparams)
    _assert_tree_close(jax_from_state_dict("toy_cnn", model.state_dict())[0], jparams, kind)


def _hyper(opt):
    """An optimizer's hyperparameters, named alike for both packages."""
    if isinstance(opt, torch.optim.Optimizer):
        out = dict(opt.defaults)
        if "betas" in out:
            out["b1"], out["b2"] = out.pop("betas")
        if isinstance(opt, optim.Adam):
            out["state_dtype"] = str(opt.state_dtype).replace("torch.", "")
        return type(opt).__name__, out
    out = {k: v for k, v in vars(opt).items() if k != "state_dtype"}
    if isinstance(opt, jax_optim.Adam):
        out["state_dtype"] = str(opt.state_dtype or "float32")
    out.pop("nesterov", None)  # no setting reaches it
    return type(opt).__name__, out


@pytest.mark.parametrize("training", [
    {"optimizer": None},
    {"optimizer": "adam", "weight_decay": 1e-4, "optimizer_state_dtype": "bf16"},
    {"optimizer": "sgd", "momentum": None},
    {"optimizer": "sgd", "momentum": 0.0, "weight_decay": 5e-4},
    {"optimizer": "SGDW", "weight_decay": None},
    {"optimizer": "lars", "trust_coefficient": 0},
    {"optimizer": "lars", "trust_coefficient": 0.02, "momentum": 0.8, "weight_decay": 1e-4},
    {"optimizer": "lamb", "momentum": 0.5, "weight_decay": 0.01},
], ids=lambda t: "-".join(f"{k}={v}" for k, v in t.items()))
def test_optimizer_from_builds_what_the_jax_factory_builds(training):
    training = dict(training, learning_rate=0.02)
    ours = cfg.optimizer_from(training, [torch.nn.Parameter(torch.zeros(2))], leaf_index=[0])
    assert _hyper(ours) == _hyper(jax_cfg.optimizer_from(training))


@pytest.mark.parametrize("training", [
    {"optimizer": "sgd", "optimizer_state_dtype": "bfloat16"},
    {"optimizer": "lamb", "optimizer_state_dtype": "float32"},
    {"optimizer": "rmsprop"},
    {"optimizer": "rmsprop", "optimizer_state_dtype": "bf16"},
], ids=lambda t: "-".join(f"{k}={v}" for k, v in t.items()))
def test_optimizer_from_refuses_what_the_jax_factory_refuses(training):
    training = dict(training, learning_rate=0.02)
    with pytest.raises(ValueError) as ref:
        jax_cfg.optimizer_from(training)
    with pytest.raises(ValueError) as got:
        cfg.optimizer_from(training, [torch.nn.Parameter(torch.zeros(2))])
    assert str(got.value) == str(ref.value)
    assert cfg.OPTIMIZERS == jax_cfg.OPTIMIZERS
