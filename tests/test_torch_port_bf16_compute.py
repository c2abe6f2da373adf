"""compute_dtype: bfloat16 and optimizer_state_dtype: bfloat16 in the port
against the JAX package on the CPU: the transforms' output dtype, every
layer's output dtype in AlexNet and toy_cnn, the logits, 3 train steps of
the bf16 recipe, the salt of bf16 moments through the whole train step, and
the entry point with toy_cnn, sync_bn and both bf16 knobs on 2 Gloo
processes.

Tolerances:
- transforms: within one bf16 step of the JAX package's values (the float32
  pipeline agrees to 1e-6, which can move a value across a bf16 rounding
  boundary);
- logits: 2^-6 of the largest logit (4 bf16 steps): the two libraries round
  each layer's bf16 output at other places (a fused or a separate bias add,
  float32 accumulators), and those roundings add up over the layers;
- losses of 3 bf16 train steps: rtol 1e-2 (the same per-layer roundings, and
  Adam's first steps follow the sign of small gradients);
- bf16 moments of 1-D leaves through 3 float32 train steps: at least 95%
  bitwise equal and none more than one bf16 step apart (float32 gradients
  agree to ~1e-6, which moves a stochastic rounding in about one element in
  4,000 per step; a wrong salt would move half of them)."""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuddp import optim as jax_optim
from tpuddp.data import transforms as jax_tf
from tpuddp.models import AlexNet as JaxAlexNet
from tpuddp.models import ToyCNN as JaxToyCNN
from tpuddp.models.torch_import import convert_alexnet_state_dict
from tpuddp.nn import CrossEntropyLoss as JaxCrossEntropyLoss
from tpuddp.nn.core import Context
from tpuddp.parallel import make_mesh
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP

from tpuddp_torch.data.transforms import make_eval_transform, make_train_augment
from tpuddp_torch.models import AlexNet, ToyCNN
from tpuddp_torch.models.convert import jax_leaf_index, state_dict_from_jax
from tpuddp_torch.nn import CrossEntropyLoss
from tpuddp_torch.nn.norm import batch_weights
from tpuddp_torch.optim import Adam
from tpuddp_torch.parallel.ddp import DistributedDataParallel
from tpuddp_torch.training import checkpoint as ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_STEP = 2.0 ** -8
LOGITS_REL = 2.0 ** -6
LOSS_RTOL = 1e-2
SPAWN_TIMEOUT_S = 180


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """AlexNet at 64 px (dropout 0) and toy_cnn (widths 8, 16) at 32 px, one
    set of weights each in both packages."""
    torch.manual_seed(0)
    alexnet = AlexNet(10, dropout=0.0)
    sd = {k: v.detach().clone() for k, v in alexnet.state_dict().items()}
    jax_alexnet = JaxAlexNet(10, dropout=0.0)
    template, mstate = jax.eval_shape(jax_alexnet.init, jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    a_params = convert_alexnet_state_dict(sd, template)
    a_state = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), mstate)

    jax_toy = JaxToyCNN(10, widths=(8, 16))
    t_params, t_state = jax_toy.init(jax.random.key(1), jnp.zeros((1, 32, 32, 3)))
    toy_sd = state_dict_from_jax("toy_cnn", _np_tree(t_params), _np_tree(t_state))
    return {
        "alexnet": (lambda: AlexNet(10, dropout=0.0), sd, jax_alexnet, a_params, a_state, 64),
        "toy_cnn": (lambda: ToyCNN(10, (8, 16), input_shape=(32, 32, 3)), toy_sd,
                    jax_toy, t_params, t_state, None),
    }


def _port(models, name):
    make, sd, *_ = models[name]
    model = make()
    model.load_state_dict(sd)
    return model


@pytest.mark.parametrize("train", [True, False], ids=["augment", "eval"])
def test_transforms_cast_last_to_the_compute_dtype(train):
    x = np.random.RandomState(0).randint(0, 256, size=(3, 32, 32, 3)).astype(np.uint8)
    if train:
        ours = make_train_augment(size=48, flip=False, compute_dtype=torch.bfloat16)(torch.from_numpy(x))
        ref = jax_tf.make_train_augment(size=48, flip=False, compute_dtype=jnp.bfloat16)(None, jnp.asarray(x))
    else:
        ours = make_eval_transform(size=48, compute_dtype=torch.bfloat16)(torch.from_numpy(x))
        ref = jax_tf.make_eval_transform(size=48, compute_dtype=jnp.bfloat16)(jnp.asarray(x))
    assert ours.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(ours.float().numpy(), ref, rtol=BF16_STEP, atol=1e-6)
    f32 = make_eval_transform(size=48)(torch.from_numpy(x))
    assert f32.dtype == torch.float32


def _jax_layer_dtypes(jax_model, params, state, x, ctx):
    out = []
    for i, layer in enumerate(jax_model.layers):
        x, _ = layer.apply(params[i], state[i], x, ctx.child(i))
        out.append(x.dtype.name)
    return out, x


def _port_layer_dtypes(model, x, w):
    """Output dtypes of the modules that stand for the JAX layers, in order
    (AlexNet's functional flatten has no module)."""
    if isinstance(model, AlexNet):
        layers = [*model.features, model.avgpool, *model.classifier]
    else:
        layers = list(model)
    seen = []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append(str(o.dtype).split(".")[1]))
             for m in layers]
    with batch_weights(model, w), torch.no_grad():
        logits = model(x)
    for h in hooks:
        h.remove()
    return seen, logits


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", ["alexnet", "toy_cnn"])
def test_bf16_layer_dtypes_and_logits_match_jax(models, name, train):
    _, _, jax_model, params, mstate, size = models[name]
    model = _port(models, name).train(train)
    hw = size or 32
    x = np.random.RandomState(1).randn(4, hw, hw, 3).astype(np.float32)
    w = np.array([1, 1, 1, 0], np.float32)
    ref_dtypes, ref = _jax_layer_dtypes(
        jax_model, params, mstate, jnp.asarray(x, jnp.bfloat16),
        Context(train=train, rng=jax.random.key(0), sample_weight=jnp.asarray(w)),
    )
    dtypes, logits = _port_layer_dtypes(model, torch.from_numpy(x).bfloat16(), torch.from_numpy(w))
    if name == "alexnet":
        del ref_dtypes[14]  # the JAX Flatten layer
    assert dtypes == ref_dtypes and set(dtypes) == {"bfloat16"}
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(logits.float().numpy(), ref, rtol=0, atol=LOGITS_REL * np.abs(ref).max())


def _three_steps(models, name, compute_dtype, state_dtype):
    """3 train steps (last row padding, no flip) through both DDP wraps on
    one replica; returns the per-step [loss_sum, n] pairs and both
    optimizers' states."""
    _, _, jax_model, params, mstate, size = models[name]
    hw = size or 32
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[compute_dtype]
    jax_ddp = JaxDDP(
        jax_model, jax_optim.Adam(1e-3, state_dtype=state_dtype), JaxCrossEntropyLoss(),
        mesh=make_mesh(jax.devices("cpu")[:1]),
        augment=jax_tf.make_train_augment(size=size, flip=False, compute_dtype=jdt),
    )
    state = jax_ddp.init_state(jax.random.key(0), jnp.zeros((1, hw, hw, 3)),
                               params=params, model_state=mstate)
    model = _port(models, name)
    index = jax_leaf_index(name, model)
    ddp = DistributedDataParallel(
        model,
        Adam(model.parameters(), lr=1e-3, state_dtype=state_dtype,
             leaf_index=[index[n] for n, _ in model.named_parameters()]),
        CrossEntropyLoss(),
        augment=make_train_augment(size=size, flip=False, compute_dtype=compute_dtype),
        device="cpu",
    )
    rng = np.random.RandomState(5)
    losses = []
    for _ in range(3):
        batch = (rng.randint(0, 256, size=(4, 32, 32, 3)).astype(np.uint8),
                 rng.randint(0, 10, size=4).astype(np.int32), np.array([1, 1, 1, 0], np.float32))
        state, metrics = jax_ddp.train_step(state, jax_ddp.shard(batch))
        ours = ddp.train_step(batch)
        losses.append((ours.tolist(), [float(np.asarray(metrics[k])[0]) for k in ("loss_sum", "n")]))
    return losses, ddp, state


@pytest.mark.parametrize("name", ["alexnet", "toy_cnn"])
def test_bf16_recipe_three_step_losses_match_jax(models, name):
    """compute_dtype and optimizer_state_dtype both bfloat16."""
    losses, ddp, _ = _three_steps(models, name, torch.bfloat16, "bfloat16")
    for ours, ref in losses:
        assert ours[1] == ref[1] == 3.0
        np.testing.assert_allclose(ours[0], ref[0], rtol=LOSS_RTOL)
    for p in ddp.model.parameters():
        st = ddp.optimizer.state[p]
        assert st["step"] == 3 and st["exp_avg"].dtype == torch.bfloat16 and p.dtype == torch.float32


def test_bf16_moments_of_1d_leaves_follow_jax_through_the_train_step(models):
    """float32 compute, bf16 moments, toy_cnn: the BatchNorm scales and
    biases and the head's bias are 1-D, laid out alike in both packages, so
    their moments round with the same noise when each leaf gets its JAX
    leaf index."""
    _, ddp, state = _three_steps(models, "toy_cnn", torch.float32, "bfloat16")
    index = jax_leaf_index("toy_cnn", ddp.model)
    jax_m = jax.tree_util.tree_leaves(state.opt_state.m)
    jax_v = jax.tree_util.tree_leaves(state.opt_state.v)
    same = total = 0
    for name, p in ddp.model.named_parameters():
        if p.dim() != 1:
            continue
        st = ddp.optimizer.state[p]
        for ours, ref in ((st["exp_avg"], jax_m[index[name]]), (st["exp_avg_sq"], jax_v[index[name]])):
            a = ours.view(torch.int16).numpy().astype(np.int32)
            b = np.asarray(ref).view(np.int16).astype(np.int32)
            assert np.abs(a - b).max() <= 1, name
            same += int((a == b).sum())
            total += a.size
    assert total == 2 * (8 + 8 + 16 + 16 + 10)
    assert same >= 0.95 * total, (same, total)


def test_entry_point_runs_toy_cnn_sync_bn_with_both_bf16_knobs(tmp_path):
    """python -m tpuddp_torch.train_native on 2 Gloo processes: toy_cnn,
    sync_bn, compute_dtype and optimizer_state_dtype bfloat16. The
    checkpoint holds the bf16 moments as bit views and loads back."""
    out = tmp_path / "out"
    settings = tmp_path / "s.yaml"
    settings.write_text(
        f"out_dir: {out}\n"
        "local: {device: cpu, gpu: {num_gpus: 2}}\n"
        "training: {model: toy_cnn, data_root: /nonexistent, synthetic_n: [72, 24],\n"
        "           train_batch_size: 16, test_batch_size: 8, num_epochs: 1,\n"
        "           image_size: null, seed: 0, sync_bn: true,\n"
        "           compute_dtype: bfloat16, optimizer_state_dtype: bfloat16}\n"
    )
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    env.pop("TPUDDP_WORLD_SIZE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "tpuddp_torch.train_native", "--settings_file", str(settings)],
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S, env=env, cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert "Training on 3 batches, test on 2 batches" in lines
    assert any(re.fullmatch(
        r"Epoch 1/1, Train Loss: \d+\.\d{4}, Test Loss: \d+\.\d{4}, Test Accuracy: \d+\.\d{2}%", l
    ) for l in lines)
    path = str(out / "ckpt_0.npz")
    with np.load(path) as data:
        marked = [k for k in data.files if k.startswith("__bf16__.opt_state.")]
        assert len(marked) == 2 * 8 and all(data[k].dtype == np.uint16 for k in marked)
        assert ".model_state[1]['mean']" in data.files
    model = ToyCNN(10, input_shape=(32, 32, 3))
    index = jax_leaf_index("toy_cnn", model)
    opt = Adam(model.parameters(), state_dtype="bfloat16",
               leaf_index=[index[n] for n, _ in model.named_parameters()])
    assert ckpt.load(path, model, opt)["epoch"] == 0
    assert all(opt.state[p]["exp_avg"].dtype == torch.bfloat16 for p in model.parameters())
