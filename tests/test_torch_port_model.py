"""Models and the weight bridge of the PyTorch port against the JAX package,
on the CPU: a torchvision-layout state_dict drives both AlexNets, the bridge
round-trips it exactly, and eval logits agree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuddp.models import AlexNet as JaxAlexNet
from tpuddp.models import ToyMLP as JaxToyMLP
from tpuddp.models.torch_import import convert_alexnet_state_dict
from tpuddp.nn.core import Context

from tpuddp_torch.models import AlexNet, ToyMLP, TransformerLM, load_model
from tpuddp_torch.models.convert import state_dict_from_jax

# float32 convolutions/matmuls summed in another order by two libraries
LOGITS_RTOL, LOGITS_ATOL = 1e-4, 1e-5

TORCHVISION_ALEXNET_KEYS = [
    f"{block}.{i}.{kind}"
    for block, idx in (("features", (0, 3, 6, 8, 10)), ("classifier", (1, 4, 6)))
    for i in idx
    for kind in ("weight", "bias")
]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def alexnet_pair():
    """One torchvision-layout state_dict loaded into both packages."""
    torch.manual_seed(0)
    ours = AlexNet(num_classes=10).eval()
    sd = {k: v.detach().clone() for k, v in ours.state_dict().items()}
    jax_model = JaxAlexNet(num_classes=10)
    # shapes only: every parameter is replaced from the state_dict
    template, mstate = jax.eval_shape(
        jax_model.init, jax.random.key(0), jnp.zeros((1, 64, 64, 3))
    )
    params = convert_alexnet_state_dict(sd, template)
    return ours, sd, jax_model, params, mstate


def test_alexnet_is_torchvision_layout_at_full_width():
    model = AlexNet(num_classes=10)
    assert sorted(model.state_dict()) == sorted(TORCHVISION_ALEXNET_KEYS)
    params = list(model.parameters())
    assert len(params) == 16
    assert sum(p.numel() for p in params) == 57_044_810


def test_bridge_round_trips_exactly(alexnet_pair):
    _, sd, _, params, _ = alexnet_pair
    back = state_dict_from_jax("alexnet", _np_tree(params))
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_alexnet_eval_logits_match_jax_at_64px(alexnet_pair):
    """64 px is near the smallest input the model takes (63)."""
    ours, _, jax_model, params, mstate = alexnet_pair
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    with torch.no_grad():
        got = ours(torch.from_numpy(x)).numpy()
    ref, _ = jax_model.apply(params, mstate, jnp.asarray(x), Context(train=False))
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=LOGITS_RTOL, atol=LOGITS_ATOL)


def test_toy_mlp_bridge_and_logits_match_jax():
    jax_model = JaxToyMLP(num_classes=10, hidden=(16, 8))
    params, mstate = jax_model.init(jax.random.key(3), jnp.zeros((1, 4, 4, 3)))
    ours = ToyMLP(48, 10, hidden=(16, 8))
    ours.load_state_dict(state_dict_from_jax("toy_mlp", _np_tree(params)))
    x = np.random.RandomState(2).randn(5, 4, 4, 3).astype(np.float32)
    with torch.no_grad():
        got = ours(torch.from_numpy(x)).numpy()
    ref, _ = jax_model.apply(params, mstate, jnp.asarray(x), Context(train=False))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=LOGITS_RTOL, atol=LOGITS_ATOL)


def test_bridge_names_the_key_on_a_shape_mismatch(alexnet_pair):
    params = list(_np_tree(alexnet_pair[3]))
    params[3] = {"weight": params[3]["weight"][:, :, :-1, :], "bias": params[3]["bias"]}
    with pytest.raises(ValueError, match="features.3.weight"):
        state_dict_from_jax("alexnet", params)
    with pytest.raises(ValueError, match="no weight bridge"):
        state_dict_from_jax("transformer_tiny", params)


@pytest.mark.parametrize("p", [0.3, 0.5])
def test_dropout_keep_rate_and_scaling(p):
    """Dropout p is the constructor's; in train mode a unit survives with
    probability 1-p (binomial 5-sigma band) and is scaled by 1/(1-p)."""
    model = AlexNet(num_classes=10, dropout=p)
    drops = [m for m in model.modules() if isinstance(m, torch.nn.Dropout)]
    assert [d.p for d in drops] == [p, p]
    layer = drops[0].train()
    torch.manual_seed(4)
    n = 200_000
    out = layer(torch.ones(n))
    kept = out != 0
    keep = 1.0 - p
    assert abs(kept.float().mean().item() - keep) < 5 * (keep * p / n) ** 0.5
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 1.0 / keep))
    assert torch.equal(layer.eval()(torch.ones(8)), torch.ones(8))


def test_load_model_registry():
    assert isinstance(load_model("alexnet", 10), AlexNet)
    mlp = load_model("toy_mlp", 7, input_shape=(8, 8, 3))
    assert mlp(torch.zeros(2, 8, 8, 3)).shape == (2, 7)
    assert load_model("resnet18_small", 10)(torch.zeros(2, 8, 8, 3)).shape == (2, 10)
    assert load_model("vgg11", 10).classifier[6].out_features == 10
    for name, (width, heads, layers, rows) in (("transformer_tiny", (64, 4, 2, 128)),
                                               ("transformer_small", (128, 8, 4, 256))):
        model = load_model(name, 10)
        assert isinstance(model, TransformerLM) and model.vocab_size == 10
        assert (model.d_model, model.n_heads, model.n_layers, model.max_seq_len) == (
            width, heads, layers, rows)
    with pytest.raises(ValueError):
        load_model("nope", 10)
