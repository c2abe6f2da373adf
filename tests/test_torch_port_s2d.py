"""The space-to-depth stem of the port (``SpaceToDepthConv2d``,
``alexnet_s2d``) against the JAX package's, on the CPU.

Tolerances: the layer's forward and gradients rtol 1e-5 against the JAX
layer and against the port's own strided ``Conv2d`` with the same weights
(float32 sums of 363 products, re-associated; atol 1e-5 of the largest
value, where a relative bound means nothing); ``alexnet_s2d`` logits rtol
1e-4 / atol 1e-5 (PERF.md section 2); state_dict keys and checkpoints
exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuddp import nn as jax_nn
from tpuddp.models import load_model as jax_load_model
from tpuddp.nn.core import Context

from tpuddp_torch.models import AlexNet, load_model
from tpuddp_torch.models.convert import jax_from_state_dict, model_name, state_dict_from_jax
from tpuddp_torch.nn.layers import Conv2d, SpaceToDepthConv2d
from tpuddp_torch.optim import Adam
from tpuddp_torch.training import checkpoint as ckpt

RTOL = 1e-5
LOGITS_RTOL, LOGITS_ATOL = 1e-4, 1e-5
SIZES = (63, 64, 66, 67, 70)  # 64 the only multiple of 4


def _close(got, want, rtol=RTOL, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()),
                               err_msg=err_msg)


def _layer_pair(seed, features=8, kernel=11, stride=4, padding=2, channels=3):
    """The JAX layer's init, and the port layer holding the same weights."""
    jl = jax_nn.SpaceToDepthConv2d(features, kernel, stride, padding)
    params, _ = jl.init(jax.random.key(seed), jnp.zeros((1, 64, 64, channels)))
    ours = SpaceToDepthConv2d(channels, features, kernel, stride, padding)
    with torch.no_grad():
        ours.weight.copy_(torch.from_numpy(np.transpose(np.array(params["weight"]), (3, 2, 0, 1))))
        ours.bias.copy_(torch.from_numpy(np.array(params["bias"])))
    return jl, params, ours


@pytest.mark.parametrize("hw", SIZES)
def test_forward_and_gradients_match_the_jax_layer(hw):
    torch.set_num_threads(2)
    jl, params, ours = _layer_pair(hw)
    rng = np.random.RandomState(hw)
    x = rng.randn(2, hw, hw, 3).astype(np.float32)
    out_shape = np.asarray(jl.apply(params, (), jnp.asarray(x), Context(train=False))[0]).shape
    r = rng.randn(*out_shape).astype(np.float32)  # NHWC cotangent

    def loss(p, xj):
        y, _ = jl.apply(p, (), xj, Context(train=False))
        return jnp.sum(y * r), y

    (_, y_ref), (g_p, g_x) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2)).requires_grad_(True)
    y = ours(xt)
    (y * torch.from_numpy(r.transpose(0, 3, 1, 2))).sum().backward()
    _close(y.detach().numpy().transpose(0, 2, 3, 1), y_ref, err_msg="forward")
    _close(ours.weight.grad.numpy(), np.transpose(np.asarray(g_p["weight"]), (3, 2, 0, 1)),
           err_msg="weight gradient")
    _close(ours.bias.grad.numpy(), g_p["bias"], err_msg="bias gradient")
    _close(xt.grad.numpy().transpose(0, 2, 3, 1), g_x, err_msg="input gradient")


@pytest.mark.parametrize("hw", SIZES)
def test_it_is_the_strided_conv_reassociated(hw):
    """Against the port's own ``Conv2d`` with the same parameters: the same
    sum, to float32 re-association."""
    torch.set_num_threads(2)
    torch.manual_seed(hw)
    ours = SpaceToDepthConv2d(3, 8, 11, 4, 2)
    plain = Conv2d(3, 8, 11, stride=4, padding=2)
    plain.load_state_dict(ours.state_dict())
    assert [n for n, _ in ours.named_parameters()] == [n for n, _ in plain.named_parameters()]
    x = torch.randn(2, 3, hw, hw, requires_grad=True)
    x2 = x.detach().clone().requires_grad_(True)
    a, b = ours(x), plain(x2)
    assert a.shape == b.shape
    a.square().sum().backward()
    b.square().sum().backward()
    _close(a.detach().numpy(), b.detach().numpy(), err_msg="forward")
    _close(ours.weight.grad.numpy(), plain.weight.grad.numpy(), err_msg="weight gradient")
    _close(x.grad.numpy(), x2.grad.numpy(), err_msg="input gradient")


def test_bfloat16_input_runs_in_bfloat16():
    layer = SpaceToDepthConv2d(3, 4, 5, 2, 1)
    y = layer(torch.randn(1, 3, 17, 17, dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16 and y.shape == (1, 4, 8, 8)


@pytest.mark.parametrize("kwargs,message", [
    (dict(stride=(4, 2)), "square stride >= 2"),
    (dict(stride=1), "square stride >= 2"),
    (dict(stride=4, padding="same"), "integer \\(symmetric\\) padding only"),
    (dict(stride=4, padding=(2, 2)), "integer \\(symmetric\\) padding only"),
])
def test_refusals_are_the_jax_layers(kwargs, message):
    with pytest.raises(ValueError, match=message):
        SpaceToDepthConv2d(3, 8, 11, **kwargs)
    jax_kwargs = dict(strides=kwargs["stride"], padding=kwargs.get("padding", 0))
    with pytest.raises(ValueError, match=message):
        jax_nn.SpaceToDepthConv2d(8, 11, **jax_kwargs)


@pytest.fixture(scope="module")
def s2d_pair():
    """One JAX ``alexnet_s2d`` init in both packages."""
    jax_model = jax_load_model("alexnet_s2d", 10)
    params, mstate = jax_model.init(jax.random.key(5), jnp.zeros((1, 67, 67, 3)))
    ours = load_model("alexnet_s2d", 10).eval()
    ours.load_state_dict(state_dict_from_jax("alexnet_s2d", jax.tree_util.tree_map(np.asarray, params)))
    return jax_model, params, mstate, ours


def test_alexnet_s2d_logits_match_jax_at_67px(s2d_pair):
    torch.set_num_threads(2)
    jax_model, params, mstate, ours = s2d_pair
    x = np.random.RandomState(3).randn(2, 67, 67, 3).astype(np.float32)
    with torch.no_grad():
        got = ours(torch.from_numpy(x)).numpy()
    ref, _ = jax_model.apply(params, mstate, jnp.asarray(x), Context(train=False))
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=LOGITS_RTOL, atol=LOGITS_ATOL)


def test_alexnet_s2d_has_alexnets_parameters_and_init():
    s2d, plain = load_model("alexnet_s2d", 10), load_model("alexnet", 10)
    assert isinstance(s2d, AlexNet) and isinstance(s2d.features[0], SpaceToDepthConv2d)
    assert sorted(s2d.state_dict()) == sorted(plain.state_dict())
    assert model_name(s2d) == "alexnet"
    torch.manual_seed(0)
    a = AlexNet(space_to_depth=True)
    torch.manual_seed(0)
    b = AlexNet()
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    params, _ = jax_from_state_dict("alexnet_s2d", s2d.state_dict())
    assert [sorted(p) for p in params if p] == [["bias", "weight"]] * 8


def test_alexnet_s2d_loads_an_alexnet_checkpoint_unchanged(tmp_path):
    torch.manual_seed(1)
    plain = load_model("alexnet", 10)
    opt = Adam(plain.parameters(), lr=1e-3)
    plain(torch.randn(2, 64, 64, 3)).square().mean().backward()
    opt.step()
    ckpt.save_on_main(str(tmp_path), 0, plain, opt, rank=0, step=1)
    s2d = load_model("alexnet_s2d", 10)
    s2d_opt = Adam(s2d.parameters(), lr=1e-3)
    assert ckpt.restore_latest(str(tmp_path), s2d, s2d_opt)[0] == 1
    for (k, a), b in zip(plain.state_dict().items(), s2d.state_dict().values()):
        assert torch.equal(a, b), k
    for p, q in zip(plain.parameters(), s2d.parameters()):
        assert torch.equal(opt.state[p]["exp_avg_sq"], s2d_opt.state[q]["exp_avg_sq"])
    x = torch.randn(2, 64, 64, 3)
    with torch.no_grad():
        _close(s2d.eval()(x).numpy(), plain.eval()(x).numpy(), rtol=1e-5)
