"""BatchNorm, SyncBatchNorm and toy_cnn in the port against the JAX package,
on the CPU: the BatchNorm layer (train and eval, padded rows, an all-padding
batch, stable_var on and off), the toy_cnn weight bridge and JAX leaf order,
and 2-process Gloo runs with and without sync_bn against the JAX package's
2-device run, plus the DDP wrap's buffer sync after every forward.

Tolerances: float32 throughout. BatchNorm outputs, running statistics and
gradients rtol 1e-5 / atol 1e-6 (one layer, the same sums in another order);
2-process gradients rtol 1e-4 / atol 1e-6 and epoch losses rtol 1e-4, as the
existing train tests (convolutions and sums in another order, over at most
2 epochs of Adam)."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tpuddp import nn as jax_nn
from tpuddp import optim as jax_optim
from tpuddp.data import ShardedDataLoader as JaxLoader
from tpuddp.data.synthetic import SyntheticClassification as JaxSynthetic
from tpuddp.models import AlexNet as JaxAlexNet
from tpuddp.models import ToyCNN as JaxToyCNN
from tpuddp.models import ToyMLP as JaxToyMLP
from tpuddp.nn import CrossEntropyLoss as JaxCrossEntropyLoss
from tpuddp.nn.core import Context
from tpuddp.parallel import make_mesh
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP
from tpuddp.training.loop import run_training_loop as jax_run_training_loop
from tpuddp.training.step import _make_grad_core
from tpuddp.utils.compat import shard_map

from tpuddp_torch.models import AlexNet, ToyCNN, ToyMLP, load_model
from tpuddp_torch.models.convert import jax_leaf_index, state_dict_from_jax
from tpuddp_torch.nn.norm import (
    BatchNorm, batch_weights, convert_sync_batchnorm, has_divergent_buffers,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import _torch_port_bn_worker as worker_cfg  # noqa: E402

BN_RTOL, BN_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
LOSS_RTOL = 1e-4
SPAWN_TIMEOUT_S = 180


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    env.pop("TPUDDP_WORLD_SIZE", None)
    return env


# ------------------------------------------------------------ BatchNorm --

@pytest.mark.parametrize("stable_var", [False, True], ids=["one_pass", "stable_var"])
@pytest.mark.parametrize(
    "weights",
    [None, [1, 1, 1, 1, 0, 0], [0, 0, 0, 0, 0, 0]],
    ids=["unweighted", "padded_rows", "all_padding"],
)
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batchnorm_matches_jax(train, weights, stable_var):
    """Outputs, running mean and var, and the gradients of a weighted loss
    with respect to the input, scale and bias."""
    rng = np.random.RandomState(11)
    x = (rng.randn(6, 5, 4, 3) * 2 + 3).astype(np.float32)  # NHWC, 3 features
    scale, bias = rng.rand(3).astype(np.float32) + 0.5, rng.randn(3).astype(np.float32)
    mean0, var0 = rng.randn(3).astype(np.float32), rng.rand(3).astype(np.float32) + 0.5
    cot = rng.randn(*x.shape).astype(np.float32)
    w = None if weights is None else np.asarray(weights, np.float32)

    jax_bn = jax_nn.BatchNorm(stable_var=stable_var)
    ctx = Context(train=train, sample_weight=None if w is None else jnp.asarray(w))

    def f(params, x):
        y, st = jax_bn.apply(params, {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}, x, ctx)
        return jnp.sum(y * cot), (y, st)

    (_, (ref_y, ref_st)), (ref_gp, ref_gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, jnp.asarray(x)
    )

    bn = BatchNorm(3, stable_var=stable_var).train(train)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    with batch_weights(bn, None if w is None else torch.from_numpy(w)):
        y = bn(xt)
    (y * torch.from_numpy(cot.transpose(0, 3, 1, 2).copy())).sum().backward()
    assert bn.sample_weight is None  # cleared after the forward

    close = dict(rtol=BN_RTOL, atol=BN_ATOL)
    np.testing.assert_allclose(y.detach().numpy().transpose(0, 2, 3, 1), np.asarray(ref_y), **close)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(ref_st["mean"]), **close)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(ref_st["var"]), **close)
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1), np.asarray(ref_gx), **close)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(ref_gp["scale"]), **close)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(ref_gp["bias"]), **close)
    if train and weights == [0] * 6:  # nothing real: the buffers stay put
        assert np.array_equal(bn.running_mean.numpy(), mean0)
        assert np.array_equal(bn.running_var.numpy(), var0)


def test_batchnorm_keeps_bf16_activations_and_computes_in_float32():
    bn = BatchNorm(4).train()
    x = torch.randn(8, 4, 3, 3).bfloat16()
    y = bn(x)
    assert y.dtype == torch.bfloat16 and bn.running_mean.dtype == torch.float32
    want = BatchNorm(4).train()(x.float())
    torch.testing.assert_close(y.float(), want.bfloat16().float())


def test_convert_sync_and_divergent_buffers():
    model = ToyCNN(10, (4, 8), input_shape=(8, 8, 3))
    assert has_divergent_buffers(model)
    assert convert_sync_batchnorm(model) is model
    assert all(m.sync for m in model.modules() if isinstance(m, BatchNorm))
    assert not has_divergent_buffers(model)
    assert not has_divergent_buffers(ToyMLP(12, 3, (4,)))
    assert not has_divergent_buffers(AlexNet(10))
    assert not has_divergent_buffers(BatchNorm(3, track_running_stats=False))

    class Counter(torch.nn.Module):  # buffers of its own, nothing declared
        def __init__(self):
            super().__init__()
            self.register_buffer("n", torch.zeros(()))

    assert has_divergent_buffers(torch.nn.Sequential(torch.nn.Linear(2, 2), Counter()))


# -------------------------------------------------------------- toy_cnn --

@pytest.fixture(scope="module")
def toy_cnn_init():
    jax_model = JaxToyCNN(num_classes=10, widths=worker_cfg.WIDTHS)
    params, mstate = jax_model.init(jax.random.key(7), jnp.zeros((1, *worker_cfg.SHAPE)))
    sd = state_dict_from_jax("toy_cnn", _np_tree(params), _np_tree(mstate))
    return jax_model, params, mstate, sd


def test_toy_cnn_bridge_round_trips_the_jax_init(toy_cnn_init):
    _, params, mstate, sd = toy_cnn_init
    params, mstate = _np_tree(params), _np_tree(mstate)
    model = ToyCNN(10, worker_cfg.WIDTHS, input_shape=worker_cfg.SHAPE)
    model.load_state_dict(sd)
    assert sorted(sd) == sorted(model.state_dict())
    back = {k: v.numpy() for k, v in model.state_dict().items()}
    for idx in (0, 4):
        np.testing.assert_array_equal(back[f"{idx}.weight"].transpose(2, 3, 1, 0), params[idx]["weight"])
    for idx in (1, 5):
        np.testing.assert_array_equal(back[f"{idx}.weight"], params[idx]["scale"])
        np.testing.assert_array_equal(back[f"{idx}.bias"], params[idx]["bias"])
        np.testing.assert_array_equal(back[f"{idx}.running_mean"], mstate[idx]["mean"])
        np.testing.assert_array_equal(back[f"{idx}.running_var"], mstate[idx]["var"])
    np.testing.assert_array_equal(back["9.weight"].T, params[9]["weight"])
    np.testing.assert_array_equal(back["9.bias"], params[9]["bias"])
    assert set(state_dict_from_jax("toy_cnn", params)) == {n for n, _ in model.named_parameters()}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_toy_cnn_logits_and_buffers_match_jax(toy_cnn_init, train):
    """The NHWC flatten order of the head and BatchNorm's padded rows."""
    jax_model, params, mstate, sd = toy_cnn_init
    model = ToyCNN(10, worker_cfg.WIDTHS, input_shape=worker_cfg.SHAPE).train(train)
    model.load_state_dict(sd)
    x = np.random.RandomState(2).randn(5, *worker_cfg.SHAPE).astype(np.float32)
    w = np.array([1, 1, 1, 0, 0], np.float32)
    with batch_weights(model, torch.from_numpy(w)), torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    ref, ref_state = jax_model.apply(
        params, mstate, jnp.asarray(x), Context(train=train, sample_weight=jnp.asarray(w))
    )
    np.testing.assert_allclose(got, np.asarray(ref), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    for idx in (1, 5):
        np.testing.assert_allclose(model[idx].running_mean.numpy(), np.asarray(ref_state[idx]["mean"]),
                                   rtol=BN_RTOL, atol=BN_ATOL)
        np.testing.assert_allclose(model[idx].running_var.numpy(), np.asarray(ref_state[idx]["var"]),
                                   rtol=BN_RTOL, atol=BN_ATOL)


def _jax_leaves(jax_model, shape):
    params, _ = jax.eval_shape(jax_model.init, jax.random.key(0), jnp.zeros((1, *shape)))
    return [(jax.tree_util.keystr(path), leaf.shape) for path, leaf in
            jax.tree_util.tree_leaves_with_path(params)]


@pytest.mark.parametrize("name", ["alexnet", "toy_mlp", "toy_cnn"])
def test_jax_leaf_index_is_the_jax_flatten_order(name):
    """Parameter k of the JAX package's flattened tree is the port's
    parameter of the same layer and key ("scale" for a BatchNorm weight),
    with the bridge's transposes of its shape."""
    jax_model, shape, model = {
        "alexnet": (JaxAlexNet(10), (64, 64, 3), AlexNet(10)),
        "toy_mlp": (JaxToyMLP(10, hidden=(16, 8)), (4, 4, 3), ToyMLP(48, 10, (16, 8))),
        "toy_cnn": (JaxToyCNN(10, widths=(4, 8)), (8, 8, 3), ToyCNN(10, (4, 8), input_shape=(8, 8, 3))),
    }[name]
    leaves = _jax_leaves(jax_model, shape)
    index = jax_leaf_index(name, model)
    assert sorted(index.values()) == list(range(len(leaves)))
    for pname, p in model.named_parameters():
        path, jshape = leaves[index[pname]]
        key = "scale" if isinstance(model.get_submodule(pname.rsplit(".", 1)[0]), BatchNorm) \
            and pname.endswith("weight") else pname.rsplit(".", 1)[1]
        assert path.endswith(f"['{key}']"), (pname, path)
        assert sorted(jshape) == sorted(p.shape), (pname, path)


def test_load_model_builds_toy_cnn():
    model = load_model("toy_cnn", 7, input_shape=(16, 16, 3))
    assert model(torch.zeros(2, 16, 16, 3)).shape == (2, 7)
    assert [m.num_features for m in model.modules() if isinstance(m, BatchNorm)] == [32, 64]


# ------------------------------------------------------- 2-process Gloo --

def _run_worker(tmp_path, run):
    (tmp_path / "run.json").write_text(json.dumps(run))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_port_bn_worker.py"), str(tmp_path)],
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S, env=_env(),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]


def _jax_synced_grads(jax_ddp, state, mesh, shards):
    """The JAX package's gradient of one step on a 2-device mesh: its own
    grad core under its shard_map (check_vma=False, as build_train_step
    runs it), pmean'd over the data axis as its update does."""
    core = _make_grad_core(jax_ddp.model, JaxCrossEntropyLoss(), "data", "broadcast", None)

    def f(state, x, y, w):
        grads, model_state, _, _ = core(state, x, y, w)
        return jax.lax.pmean(grads, "data"), model_state

    fn = jax.jit(shard_map(
        f, mesh=mesh, in_specs=(P(), P("data"), P("data"), P("data")),
        out_specs=(P(), P()), check_vma=False,
    ))
    x, y, w = (np.concatenate([s[i] for s in shards]) for i in range(3))
    grads, model_state = fn(state, *jax_ddp.shard((x, y.astype(np.int32), w)))
    return _np_tree(grads), _np_tree(model_state)


@pytest.mark.parametrize("sync_bn", [False, True], ids=["bn", "sync_bn"])
def test_two_process_toy_cnn_matches_jax(tmp_path, cpu_devices, toy_cnn_init, sync_bn):
    """Two Gloo processes through the port's launcher against the JAX
    package on a 2-device mesh: the synced gradient of one step (rank 1's
    shard padded), the buffers after it on both ranks, and the 2-epoch
    losses (the test loss reads the running statistics, so it checks the
    buffer sync too)."""
    jax_model, params, mstate, sd = toy_cnn_init
    if sync_bn:
        jax_model = jax_nn.convert_sync_batchnorm(JaxToyCNN(num_classes=10, widths=worker_cfg.WIDTHS))
    np.savez(tmp_path / "init.npz", **{k: v.numpy() for k, v in sd.items()})
    rng = np.random.RandomState(9)
    shards = []
    for n_real in (6, 4):
        x = rng.randn(6, *worker_cfg.SHAPE).astype(np.float32)
        y = rng.randint(0, 10, 6).astype(np.int64)
        w = (np.arange(6) < n_real).astype(np.float32)
        shards.append((x, y, w))
    np.savez(tmp_path / "grad_batches.npz", **{
        f"{k}{r}": a for r, s in enumerate(shards) for k, a in zip("xyw", s)
    })
    _run_worker(tmp_path, {"mode": "toy_cnn", "sync_bn": sync_bn})

    mesh = make_mesh(cpu_devices[:2])
    jax_ddp = JaxDDP(jax_model, jax_optim.Adam(worker_cfg.LR), JaxCrossEntropyLoss(), mesh=mesh)
    state = jax_ddp.init_state(
        jax.random.key(0), jnp.zeros((1, *worker_cfg.SHAPE)), params=params, model_state=mstate
    )
    ref_grads, ref_mstate = _jax_synced_grads(jax_ddp, state, mesh, shards)
    ref = state_dict_from_jax("toy_cnn", ref_grads, ref_mstate)
    steps = [np.load(tmp_path / f"step_{r}.npz") for r in range(2)]
    for k in steps[0].files:
        np.testing.assert_array_equal(steps[0][k], steps[1][k])  # every replica agrees
        np.testing.assert_allclose(steps[0][k], ref[k.split("/", 1)[1]].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)

    train, test = JaxSynthetic(
        n=worker_cfg.DATA_N, shape=worker_cfg.SHAPE, seed=worker_cfg.DATA_SEED
    ).split(worker_cfg.DATA_TEST)
    _, ref_history = jax_run_training_loop(
        jax_ddp, state,
        JaxLoader(train, worker_cfg.BATCH, mesh, shuffle=True),
        JaxLoader(test, worker_cfg.BATCH, mesh, shuffle=True),
        save_dir=None, num_epochs=worker_cfg.EPOCHS, log=lambda *_: None,
    )
    with open(tmp_path / "history.json") as f:
        history = json.load(f)
    assert len(history) == len(ref_history) == worker_cfg.EPOCHS
    for ours, ref in zip(history, ref_history):
        assert ours["train_samples"] == ref["train_samples"] == worker_cfg.DATA_N - worker_cfg.DATA_TEST
        for key in ("train_loss", "test_loss"):
            np.testing.assert_allclose(ours[key], ref[key], rtol=LOSS_RTOL, err_msg=key)
    final = [np.load(tmp_path / f"final_{r}.npz") for r in range(2)]
    for k in final[0].files:
        np.testing.assert_array_equal(final[0][k], final[1][k])


def test_two_process_buffers_follow_rank_0_after_every_forward(tmp_path):
    """A buffer set from each rank's own batch in the forward (all 1 on rank
    0, all 2 on rank 1) holds rank 0's value on both ranks after the step."""
    _run_worker(tmp_path, {"mode": "buffers"})
    for r in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"buffers_{r}.npz")["seen"],
                                      np.ones(3, np.float32))
