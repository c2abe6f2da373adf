"""Training a VGG in the port against the JAX package, on the CPU.

A full-width VGG cannot train on the CPU at a test's cost: its two
4096-wide classifier Linears are fixed in the JAX package. So ``vgg11``'s
plan is replaced, in both packages' ``VGG_PLANS`` (``monkeypatch``, for
this module only), by the narrow plan ``[8, "M", 16, "M"]``: two 3x3
convolutions, two max-pools, the 8x8 -> 7x7 adaptive pool (ragged bins
that overlap), and the JAX classifier (784 -> 4096 -> 4096 -> 10, 20.0 M
parameters, 10 leaves, 15 JAX children). Dropout 0: the two packages draw
different random numbers. 32 px, batch 8 (the first batch's last row
padded), no flip:

- the first step's loss and gradients against ``jax.grad``;
- 3 Adam steps of the port's DDP wrap against the JAX DDP on one device:
  the losses;
- ZeRO-1 (``weight_update_sharding``) at world 1: bitwise the replicated
  step, and its losses the JAX ZeRO-1 wrap's;
- ``int8_ef`` at bucket_cap_mb 5 (5 buckets, 3 backward segments):
  ``comm_overlap_meta`` the JAX wrap's, the segmented step bitwise the
  barrier step, the exchange the JAX package's compiled exchange;
- the guard: a poisoned step a bitwise no-op; the auditor's leaf names the
  JAX ``keystr`` paths;
- checkpoints both ways in both kinds (native ``ckpt`` with float32 and
  bf16 moments, managed ``state`` and ``model``), bitwise;
- the managed step bitwise the native step at world 1.

Tolerances: losses and gradients rtol 1e-4 / atol 1e-5 (PERF.md section
2); everything else bitwise.
"""

import dataclasses
import shutil
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tpuddp import models as jax_models
from tpuddp import optim as jax_optim
from tpuddp.accelerate import Accelerator as JaxAccelerator
from tpuddp.data import transforms as jax_tf
from tpuddp.models import vgg as jax_vgg
from tpuddp.nn import CrossEntropyLoss as JaxCrossEntropyLoss
from tpuddp.nn.core import Context
from tpuddp.nn.loss import cross_entropy as jax_cross_entropy
from tpuddp.optim import AdamState
from tpuddp.parallel import comm as jax_comm
from tpuddp.parallel import make_mesh
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP
from tpuddp.training import checkpoint as jax_ckpt

from tpuddp_torch.accelerate import Accelerator
from tpuddp_torch.data.transforms import make_train_augment
from tpuddp_torch.models import load_model, vgg
from tpuddp_torch.models.convert import (
    JaxFlatOrder, flat_to_jax, jax_from_state_dict, jax_leaf_index, jax_sizes, keystr,
    state_dict_from_jax, torch_layout, tree_leaves,
)
from tpuddp_torch.nn import CrossEntropyLoss
from tpuddp_torch.optim import Adam
from tpuddp_torch.parallel import comm
from tpuddp_torch.parallel.ddp import DistributedDataParallel
from tpuddp_torch.resilience import guard as guard_lib
from tpuddp_torch.training import checkpoint as ckpt
from tpuddp_torch.training.step import comm_sync

NAME, NARROW = "vgg11", [8, "M", 16, "M"]
HW, BATCH = 32, 8
RTOL, ATOL = 1e-4, 1e-5
LR = 1e-3
LEAVES, CHILDREN = 10, 15
CAP = 5.0  # MB: 5 buckets, 3 segments
MOMENTS = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


@pytest.fixture(scope="module", autouse=True)
def narrow_plan():
    """``vgg11`` is the narrow plan in both packages (and dropout 0 in the
    JAX registry) while this module runs."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_vgg.VGG_PLANS, NAME, NARROW)
        mp.setitem(vgg.VGG_PLANS, NAME, NARROW)
        mp.setitem(jax_models._REGISTRY, NAME, partial(jax_vgg.VGG11, dropout=0.0))
        yield


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _tbits(t):
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()


def _jax_model():
    return jax_models.load_model(NAME, 10)


@lru_cache(maxsize=None)
def _init():
    """The JAX package's own init of the narrow ``vgg11`` (numpy leaves)."""
    params, mstate = _jax_model().init(jax.random.key(4), jnp.zeros((1, HW, HW, 3)))
    return _np(params), _np(mstate)


def _port_model(params=None):
    model = load_model(NAME, 10, dropout=0.0)
    model.load_state_dict(state_dict_from_jax(NAME, params if params is not None else _init()[0]))
    return model


def _batches(n=3, seed=5):
    """``n`` batches of 8 uint8 rows, the first with its last row padded."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        w = np.ones(BATCH, np.float32)
        if i == 0:
            w[-1] = 0.0
        out.append((rng.randint(0, 256, (BATCH, HW, HW, 3)).astype(np.uint8),
                    rng.randint(0, 10, BATCH).astype(np.int64), w))
    return out


def _port_ddp(model, **kwargs):
    return DistributedDataParallel(model, Adam(model.parameters(), lr=LR), CrossEntropyLoss(),
                                   augment=make_train_augment(size=None, flip=False), device="cpu",
                                   **kwargs)


def _jax_ddp(cpu_devices, **kwargs):
    ddp = JaxDDP(_jax_model(), jax_optim.Adam(LR), JaxCrossEntropyLoss(), mesh=make_mesh(cpu_devices[:1]),
                 augment=jax_tf.make_train_augment(size=None, flip=False), **kwargs)
    params, mstate = _init()
    return ddp, ddp.init_state(jax.random.key(0), jnp.zeros((1, HW, HW, 3)), params=params,
                               model_state=mstate)


def _jax_sums(ddp, state, batches):
    sums = []
    for batch in batches:
        state, metrics = ddp.train_step(state, ddp.shard((batch[0], batch[1].astype(np.int32), batch[2])))
        sums.append((float(np.asarray(metrics["loss_sum"])[0]), float(np.asarray(metrics["n"])[0])))
    return np.asarray(sums), state


def _state(ddp):
    out = {f"param/{n}": p.detach().clone() for n, p in ddp.model.named_parameters()}
    for i, st in enumerate(ddp.optimizer.state.values()):
        out.update({f"opt/{i}/{k}": t.clone() for k, t in st.items() if torch.is_tensor(t)})
    if ddp.residual is not None:
        out["residual"] = ddp.residual.clone()
    return out


def _assert_states_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ------------------------------------------------------------- gradients --

def test_the_first_step_gradients_match_jax():
    """Forward through the narrow plan (the 8 -> 7 pool's overlapping bins),
    the weighted loss with a padded row, and every gradient."""
    torch.set_num_threads(2)
    params, mstate = _init()
    x, y, w = _batches(1)[0]
    model = _port_model()
    xa = make_train_augment(size=None, flip=False)(torch.from_numpy(x))
    loss = CrossEntropyLoss()(model(xa), torch.from_numpy(y), torch.from_numpy(w))
    loss.backward()
    jax_augment = jax_tf.make_train_augment(size=None, flip=False)

    def jax_loss(p):
        logits, _ = _jax_model().apply(p, mstate, jax_augment(None, jnp.asarray(x)),
                                       Context(train=True, rng=jax.random.key(1)))
        return jax_cross_entropy(logits, jnp.asarray(y, np.int32), weights=jnp.asarray(w))

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=RTOL)
    ref = state_dict_from_jax(NAME, _np(ref_grads))
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[n].numpy(), rtol=RTOL, atol=ATOL, err_msg=n)


# ------------------------------------------------------------ Adam steps --

def test_three_adam_steps_match_the_jax_ddp(cpu_devices):
    """augment, forward, weighted loss, backward, Adam, 3 times: each
    step's loss sum and count (as tests/test_torch_port_train.py holds
    AlexNet: Adam's first step moves a parameter by about lr * sign(g), so
    a gradient element that float32 rounding leaves near zero, in either
    package, moves it by up to 2 * lr, and the parameters are held through
    the gradients above and the losses here)."""
    torch.set_num_threads(2)
    batches = _batches()
    jax_ddp, state = _jax_ddp(cpu_devices)
    want, _ = _jax_sums(jax_ddp, state, batches)
    ddp = _port_ddp(_port_model())
    got = np.stack([ddp.train_step(b).numpy() for b in batches])
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert {st["step"] for st in ddp.optimizer.state.values()} == {3}


def test_zero1_at_world_1_is_bitwise_the_replicated_step_and_tracks_the_jax_wrap(cpu_devices):
    """ZeRO-1's flat shard (the whole vector at world 1, one Adam launch of
    one row) against the replicated step, bitwise; its losses against the
    JAX package's ZeRO-1 wrap."""
    torch.set_num_threads(2)
    batches = _batches()
    runs = {}
    for wus in (False, True):
        model = _port_model()
        ddp = _port_ddp(model, weight_update_sharding=wus)
        sums = np.stack([ddp.train_step(b).numpy() for b in batches])
        runs[wus] = (sums, {n: p.detach().clone() for n, p in model.named_parameters()})
    np.testing.assert_array_equal(runs[True][0], runs[False][0])
    for n, p in runs[False][1].items():
        assert torch.equal(p, runs[True][1][n]), n
    jax_ddp, state = _jax_ddp(cpu_devices, weight_update_sharding=True)
    want, _ = _jax_sums(jax_ddp, state, batches)
    np.testing.assert_allclose(runs[True][0], want, rtol=RTOL)


# --------------------------------------------------------------- int8_ef --

def test_int8_ef_overlap_plan_is_the_jax_wraps_and_segmented_is_bitwise_the_barrier(cpu_devices):
    torch.set_num_threads(2)
    batches = _batches()
    states, metas = {}, {}
    for overlap in (False, True):
        ddp = _port_ddp(_port_model(), comm_hook="int8_ef", bucket_cap_mb=CAP, comm_overlap=overlap)
        metas[overlap] = ddp.comm_overlap_meta
        for b in batches:
            ddp.train_step(b)
        if overlap:
            assert ddp._overlap.counts == {"hook": 3 * len(batches), "join": 0}
            assert [s.layers for s in ddp._overlap.segments] == [(0, 11), (11, 14), (14, 15)]
        states[overlap] = _state(ddp)
    _assert_states_equal(states[False], states[True])
    jax_ddp, _ = _jax_ddp(cpu_devices, comm_hook="int8_ef", bucket_cap_mb=CAP)
    assert metas[True] == jax_ddp.comm_overlap_meta == {"enabled": True, "segments": 3, "reason": None}
    assert metas[False]["enabled"] is False


def test_int8_ef_exchange_is_the_jax_packages(cpu_devices):
    """The native sync with ``int8_ef`` at bucket_cap_mb 5 over the JAX leaf
    order: the exchanged gradient the JAX package's compiled exchange,
    bitwise; the residual ``send - q * scale`` the JAX package's, or its
    one-rounding neighbour (half an ulp of ``q * scale``), as the XLA
    rewrite at the bucket's size decides (tests/test_torch_port_resnet_train.py)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_port_comm import _grads, _jax_reduce

    params, _ = _init()
    model = _port_model()
    plan_j = jax_comm.make_grad_comm(params, 1, "int8_ef", CAP)
    plan = comm.make_grad_comm(jax_sizes(NAME, model), 1, "int8_ef", CAP)
    assert plan.buckets == plan_j.buckets and len(plan.buckets) == 5
    grads = _grads(params, 6)
    residual = plan.init_residual()
    residual += torch.from_numpy((np.random.default_rng(7).standard_normal(plan.total) * 1e-3)
                                 .astype(np.float32))
    before = residual.numpy().copy()
    want, want_r = _jax_reduce(plan_j, grads, before.copy(), cpu_devices)
    port_g = torch_layout(NAME, _np(grads))
    ps = list(model.parameters())
    for n, p in model.named_parameters():
        p.grad = torch.from_numpy(port_g[n].copy())
    order = JaxFlatOrder(NAME, model)
    send = order.to_jax(torch.cat([p.grad.reshape(-1) for p in ps])) + torch.from_numpy(before)
    comm_sync(ps, plan, order, residual)
    got = flat_to_jax(NAME, model, torch.cat([p.grad.reshape(-1) for p in ps]).numpy())
    np.testing.assert_array_equal(got, want[:got.size])
    for lo, hi in plan.buckets:
        b = send[lo:hi]
        scale = comm.int8_scale(b)
        kept = (comm.quantize_int8(b, scale).float() * scale).numpy()
        exact = b.double() - comm.quantize_int8(b, scale).double() * scale.double()
        np.testing.assert_array_equal(residual[lo:hi].numpy(), exact.float().numpy())
        assert np.all(np.abs(residual[lo:hi].numpy() - want_r[lo:hi]) <= np.spacing(np.abs(kept)) / 2)


# ----------------------------------------------------------------- guard --

def test_a_poisoned_step_is_a_bitwise_no_op_and_the_auditor_names_jax_paths():
    torch.set_num_threads(2)
    model = _port_model()
    ddp = _port_ddp(model, guard=True)
    batches = _batches(3)
    ddp.train_step(batches[0])
    before = _state(ddp)
    x, y, w = batches[1]
    w = w.copy()
    w[2] = np.nan  # $TPUDDP_FAULT=nan's injection: a NaN sample weight
    ddp.train_step((x, y, w))
    _assert_states_equal(before, _state(ddp))
    assert ddp.skip_counters() == (1, 1)
    ddp.train_step(batches[2])
    assert ddp.skip_counters() == (1, 0)
    assert not torch.equal(before["param/classifier.6.weight"], model.classifier[6].weight)
    params, _ = _init()
    want = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    names = [n for n, _ in guard_lib.jax_leaf_names(model)]
    assert names == want and len(names) == LEAVES and names[-1] == "[14]['weight']"


# ------------------------------------------------------------ checkpoints --

def _jax_state(moments, cpu_devices, step=5):
    """A JAX TrainState of the narrow vgg11 with random moments."""
    params, mstate = _init()
    ddp = JaxDDP(_jax_model(), jax_optim.Adam(state_dtype=moments), JaxCrossEntropyLoss(),
                 mesh=make_mesh(cpu_devices[:1]))
    state = ddp.init_state(jax.random.key(1), jnp.zeros((1, HW, HW, 3)), params=params,
                           model_state=mstate)
    rng = np.random.default_rng(2)
    rand = lambda p, scale: (rng.standard_normal(p.shape, np.float32) * scale).astype(MOMENTS[moments])
    return dataclasses.replace(state, opt_state=AdamState(
        step=np.int32(step),
        m=jax.tree_util.tree_map(lambda p: rand(p, 1e-2), state.params),
        v=jax.tree_util.tree_map(lambda p: np.abs(rand(p, 1e-3)), state.params)))


def _port(moments):
    model = load_model(NAME, 10, dropout=0.0)
    leaf = jax_leaf_index(NAME, model)
    return model, Adam(model.parameters(), lr=1e-2, state_dtype=moments,
                       leaf_index=[leaf[n] for n, _ in model.named_parameters()])


def _assert_port_holds(model, opt, params, opt_state):
    want = state_dict_from_jax(NAME, _np(params))
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    m, v = (torch_layout(NAME, jax.tree_util.tree_map(_bits, _np(t))) for t in (opt_state.m, opt_state.v))
    for n, p in model.named_parameters():
        st = opt.state[p]
        assert st["step"] == int(opt_state.step)
        np.testing.assert_array_equal(_tbits(st["exp_avg"]), m[n])
        np.testing.assert_array_equal(_tbits(st["exp_avg_sq"]), v[n])


def _assert_trees_equal(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    jax.tree_util.tree_map(lambda u, w: np.testing.assert_array_equal(_bits(u), _bits(w)), a, b)


def _train_port(model, opt, steps=2):
    gen = torch.Generator().manual_seed(0)
    for _ in range(steps):
        model.train()(torch.randn(3, HW, HW, 3, generator=gen)).square().mean().backward()
        opt.step()
        opt.zero_grad()


@pytest.fixture()
def ckpt_dir(tmp_path):
    """A test's directory of 240 MB checkpoints, deleted after it."""
    yield tmp_path
    shutil.rmtree(tmp_path)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_checkpoints_cross_both_ways_in_the_native_kind(ckpt_dir, cpu_devices, moments):
    tmp_path = ckpt_dir
    torch.set_num_threads(2)
    state = _jax_state(moments, cpu_devices)
    jax_ckpt.save_on_main(str(tmp_path / "jax"), 0, state, world_size=1)
    model, opt = _port(moments)
    assert ckpt.restore_latest(str(tmp_path / "jax"), model, opt)[0] == 1
    _assert_port_holds(model, opt, state.params, state.opt_state)
    keys = set(np.load(str(tmp_path / "jax" / "ckpt_0.npz")).files)
    assert ".params[14]['weight']" in keys and any(k.endswith(".opt_state.m[8]['bias']") for k in keys)

    _train_port(model, opt)
    ckpt.save_on_main(str(tmp_path / "port"), 3, model, opt, rank=0, seed=9, step=7)
    restored, epoch = jax_ckpt.restore_latest(str(tmp_path / "port"), _jax_state(moments, cpu_devices, 0),
                                              world_size=1)
    assert epoch == 4 and int(restored.step) == 7
    params, _ = jax_from_state_dict(NAME, model.state_dict())
    _assert_trees_equal(_np(restored.params), params)
    _assert_port_holds(model, opt, restored.params, restored.opt_state)


@pytest.mark.parametrize("moments", ["float32"])  # bf16 bits in this kind: the native test
def test_checkpoints_cross_both_ways_in_the_managed_kind(ckpt_dir, cpu_devices, moments):
    tmp_path = ckpt_dir
    torch.set_num_threads(2)
    state = _jax_state(moments, cpu_devices)
    key = jax.random.key(4)
    tree = {"params": state.params, "model_state": state.model_state, "opt_state": state.opt_state,
            "rng_key": key, "bwd_key": key, "bwd_counter": np.asarray(7, np.int64)}
    jax_ckpt.save_on_main(str(tmp_path / "jax"), 0, tree, prefix="state", world_size=1)
    jax_ckpt.save(str(tmp_path / "jax" / "model.npz"),
                  {"params": state.params, "model_state": state.model_state})
    model, opt = _port(moments)
    acc = Accelerator(seed=0, device="cpu")
    pmodel, popt = acc.prepare(model, opt)
    assert acc.load_state(pmodel, popt, str(tmp_path / "jax")) == 1
    _assert_port_holds(model, opt, state.params, state.opt_state)

    _train_port(model, opt)
    acc.save_model(pmodel, str(tmp_path / "port"))
    acc.save_state(pmodel, popt, str(tmp_path / "port"), epoch=2)
    assert "['params'][14]['weight']" in set(np.load(str(tmp_path / "port" / "state_2.npz")).files)
    jacc = JaxAccelerator(mesh=make_mesh(cpu_devices[:1]), seed=5)
    jmodel, jopt = jacc.prepare(_jax_model(), jax_optim.Adam(state_dtype=moments))
    jmodel(jnp.zeros((1, HW, HW, 3)))
    assert jacc.load_state(jmodel, jopt, str(tmp_path / "port")) == 3
    params, _ = jax_from_state_dict(NAME, model.state_dict())
    _assert_trees_equal(_np(jmodel.params), params)
    _assert_port_holds(model, opt, jmodel.params, jopt.opt_state)
    jacc.load_model(jmodel, str(tmp_path / "jax"))
    _assert_trees_equal(_np(jmodel.params), _np(state.params))


def test_the_checkpoint_keys_are_the_jax_keystr_paths():
    params, _ = _init()
    want = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    assert [keystr(p) for p, _ in tree_leaves(params)] == want
    assert [k for k, _ in ckpt._leaves(".params", params)] == [".params" + k for k in want]
    assert len(params) == CHILDREN


# ---------------------------------------------------------------- managed --

def test_the_managed_step_is_bitwise_the_native_step_at_world_1():
    torch.set_num_threads(2)
    batches = _batches()
    native = _port_model()
    ddp = _port_ddp(native)
    for batch in batches:
        ddp.train_step(batch)
    acc = Accelerator(seed=0, augment=make_train_augment(size=None, flip=False), device="cpu")
    module = _port_model()
    model, opt = acc.prepare(module, Adam(module.parameters(), lr=LR))
    for x, y, w in batches:
        opt.zero_grad()
        acc.backward(CrossEntropyLoss()(model(x), y, w))
        opt.step()
    for (k, a), b in zip(native.state_dict().items(), module.state_dict().values()):
        assert torch.equal(a, b), k
