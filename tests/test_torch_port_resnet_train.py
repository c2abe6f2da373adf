"""Training ``resnet18_small`` (configs/multihost.yaml's model) in the port
against the JAX package, on the CPU at 16 px, batch 8 (one row padded):

- 3 Adam steps of the port's DDP wrap against the JAX DDP on one device:
  losses and the final parameters and statistics;
- bf16 Adam moments over the nested tree: each leaf salted by its nested
  JAX leaf index (bitwise the JAX package's rounding on the 1-D leaves at
  every step, a bf16 neighbour of its float32 moment on the others);
- the Adam kernel's launch tables for 62 leaves: 2 tables (48 and 14 rows)
  whose chunk starts begin at 0 in each, one ``replay_scalars`` entry per
  table, eagerly and guarded; and, on the card (``cuda``), the 4-table
  launch over ResNet-50's 161 leaves against its plain version;
- the guard: a poisoned step a bitwise no-op on parameters, moments and
  all 40 BatchNorm buffers;
- ``int8_ef``: the native exchange over the nested JAX leaf order bitwise
  the JAX package's compiled exchange (its residual one rounding apart);
- checkpoints both ways in both kinds (native ``ckpt``, managed ``state``
  and ``model``), bitwise, with the nested keys;
- the managed step bitwise the native step at world 1.

Tolerances: losses, parameters and statistics rtol 1e-4 / atol 1e-5, or,
where a train-mode BatchNorm net moves the JAX package's own run by more
than that from an init one ulp higher, 4 times that move (PERF.md section
2); Adam parameters 1e-5 against the JAX optimizer; everything else bitwise.
"""

import dataclasses
import math
import os
import sys
from functools import lru_cache

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tpuddp import optim as jax_optim
from tpuddp.accelerate import Accelerator as JaxAccelerator
from tpuddp.data import transforms as jax_tf
from tpuddp.models import load_model as jax_load_model
from tpuddp.nn import CrossEntropyLoss as JaxCrossEntropyLoss
from tpuddp.optim import AdamState
from tpuddp.parallel import comm as jax_comm
from tpuddp.parallel import make_mesh
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP
from tpuddp.training import checkpoint as jax_ckpt

from tpuddp_torch.accelerate import Accelerator
from tpuddp_torch.data.transforms import make_train_augment
from tpuddp_torch.models import load_model
from tpuddp_torch.models.convert import (
    JaxFlatOrder, flat_to_jax, jax_from_state_dict, jax_leaf_index, jax_sizes, keystr,
    state_dict_from_jax, torch_layout, tree_leaves,
)
from tpuddp_torch.nn import CrossEntropyLoss
from tpuddp_torch.nn.norm import convert_sync_batchnorm
from tpuddp_torch.ops import fused_adam
from tpuddp_torch.optim import Adam
from tpuddp_torch.parallel import comm
from tpuddp_torch.parallel.ddp import DistributedDataParallel
from tpuddp_torch.resilience import guard as guard_lib
from tpuddp_torch.training import checkpoint as ckpt
from tpuddp_torch.training.step import comm_sync

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_comm import _grads, _jax_reduce  # noqa: E402
from test_torch_port_resnet import _ulp_up, _within  # noqa: E402

NAME, HW, BATCH = "resnet18_small", 16, 8
RTOL, P_TOL = 1e-4, 1e-5
LR = 1e-3
LEAVES, BN_LAYERS = 62, 20
MOMENTS = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _tbits(t):
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()


@lru_cache(maxsize=None)
def _init():
    """The JAX package's own init of ``resnet18_small`` (numpy leaves)."""
    params, mstate = jax_load_model(NAME, 10).init(jax.random.key(4), jnp.zeros((1, HW, HW, 3)))
    return _np(params), _np(mstate)


def _port_model(params=None, mstate=None, sync_bn=False):
    if params is None:
        params, mstate = _init()
    model = load_model(NAME, 10)
    model.load_state_dict(state_dict_from_jax(NAME, params, mstate))
    return convert_sync_batchnorm(model) if sync_bn else model


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


def _jax_run(params, mstate, batches, cpu_devices):
    """The JAX DDP on one device: each step's ``(loss_sum, n)`` and the
    final state."""
    ddp = JaxDDP(jax_load_model(NAME, 10), jax_optim.Adam(LR), JaxCrossEntropyLoss(),
                 mesh=make_mesh(cpu_devices[:1]), augment=jax_tf.make_train_augment(size=None, flip=False))
    state = ddp.init_state(jax.random.key(0), jnp.zeros((1, HW, HW, 3)), params=params,
                           model_state=mstate)
    sums = []
    for batch in batches:
        batch = (batch[0], batch[1].astype(np.int32), batch[2])
        state, metrics = ddp.train_step(state, ddp.shard(batch))
        sums.append((float(np.asarray(metrics["loss_sum"])[0]), float(np.asarray(metrics["n"])[0])))
    return sums, state


# ------------------------------------------------------------ Adam steps --

def test_three_adam_steps_match_the_jax_ddp(cpu_devices):
    """augment, forward (train-mode BatchNorm, a padded row), weighted
    loss, backward, Adam, 3 times: the first step's loss at rtol 1e-4; the
    later losses and the final parameters and running statistics within
    SPREAD times the JAX package's own move from an init one ulp higher.
    The run is chaotic in the JAX package itself: Adam's early steps are
    about ``lr * sign(g)``, and a train-mode gradient element near zero
    takes either sign under float32 rounding, so by step 3 its own run
    moves by 4e-3 of the loss and 2.8e-2 of a running variance."""
    torch.set_num_threads(2)
    params, mstate = _init()
    batches = _batches()
    ref_sums, ref_state = _jax_run(params, mstate, batches, cpu_devices)
    up_sums, up_state = _jax_run(_ulp_up(params), mstate, batches, cpu_devices)
    model = _port_model()
    ddp = _port_ddp(model)
    got = np.stack([ddp.train_step(batch).numpy() for batch in batches])
    ref, up = np.asarray(ref_sums), np.asarray(up_sums)
    np.testing.assert_allclose(got[0], ref[0], rtol=RTOL)
    _within(got, ref, np.abs(up - ref), "loss sums", per_tensor=False)
    assert {st["step"] for st in ddp.optimizer.state.values()} == {3}
    want = state_dict_from_jax(NAME, _np(ref_state.params), _np(ref_state.model_state))
    moved = state_dict_from_jax(NAME, _np(up_state.params), _np(up_state.model_state))
    for k, v in model.state_dict().items():
        _within(v.numpy(), want[k].numpy(), np.abs(moved[k].numpy() - want[k].numpy()), k,
                per_tensor=False)


def _jax_f32_moments(opt, params, grads):
    """The JAX package's float32 moments of the last step, before rounding."""
    state = opt.init(params)
    p = params
    for g in grads[:-1]:
        p, state = opt.update(g, state, p)
    m = jax.tree_util.tree_map(lambda mm, g: opt.b1 * mm.astype(jnp.float32) + (1 - opt.b1) * g,
                               state.m, grads[-1])
    v = jax.tree_util.tree_map(lambda vv, g: opt.b2 * vv.astype(jnp.float32) + (1 - opt.b2) * g * g,
                               state.v, grads[-1])
    return _np(m), _np(v)


def _bf16_neighbours(x32):
    bits = x32.view(np.uint32)
    down = (bits & np.uint32(0xFFFF0000)).view(np.float32)
    up = ((bits & np.uint32(0xFFFF0000)) + np.uint32(0x10000)).view(np.float32)
    return down, np.where((bits & np.uint32(0xFFFF)) == 0, down, up)


def test_bf16_moments_are_salted_by_the_nested_leaf_index():
    """Adam with bf16 moments from the same gradients, step by step: the
    1-D leaves (BatchNorm scales and biases, the head's bias), whose noise
    index is the same in both layouts, round bitwise as the JAX package's
    at every step, so their salt is the nested JAX leaf index; after the
    first step every moment is a bf16 neighbour of the JAX float32 one (a
    conv weight's elements take their noise in the port's OIHW order, so
    later steps start from another realisation of the same rounding)."""
    params, _ = _init()
    grads = [_grads(params, s) for s in range(3)]
    opt = jax_optim.Adam(LR, state_dtype="bfloat16")
    model = _port_model()
    leaf = jax_leaf_index(NAME, model)
    ours = Adam(model.parameters(), lr=LR, state_dtype="bf16",
                leaf_index=[leaf[n] for n, _ in model.named_parameters()])
    p, state = params, opt.init(params)
    for step, g in enumerate(grads, start=1):
        p, state = opt.update(g, state, p)
        port_g = torch_layout(NAME, g)
        for n, t in model.named_parameters():
            t.grad = torch.from_numpy(port_g[n].copy())
        ours.step()
        want = {k: torch_layout(NAME, jax.tree_util.tree_map(_bits, _np(tree)))
                for k, tree in (("exp_avg", state.m), ("exp_avg_sq", state.v))}
        bitwise = 0
        for n, t in model.named_parameters():
            for key in ("exp_avg", "exp_avg_sq"):
                got = ours.state[t][key]
                if t.dim() == 1:
                    np.testing.assert_array_equal(_tbits(got), want[key][n], err_msg=f"{n} {key} {step}")
                    bitwise += 1
        assert bitwise == 2 * (2 * BN_LAYERS + 1)
        if step == 1:  # from the same state: parameters within 1e-5, moments neighbours
            want_p = state_dict_from_jax(NAME, _np(p))
            for n, t in model.named_parameters():
                np.testing.assert_allclose(t.detach().numpy(), want_p[n].numpy(), rtol=0, atol=P_TOL,
                                           err_msg=n)
            m32, v32 = _jax_f32_moments(opt, params, grads[:1])
            f32 = {"exp_avg": torch_layout(NAME, m32), "exp_avg_sq": torch_layout(NAME, v32)}
            for n, t in model.named_parameters():
                for key in ("exp_avg", "exp_avg_sq"):
                    down, up = _bf16_neighbours(np.ascontiguousarray(f32[key][n], np.float32))
                    g32 = ours.state[t][key].float().numpy()
                    assert ((g32 == down) | (g32 == up)).all(), f"{n} {key}"


# ----------------------------------------------------------- launch tables --

def _leaf_numels():
    with torch.device("meta"):
        return [p.numel() for p in load_model(NAME, 10).parameters()]


def test_sixty_two_leaves_take_two_launch_tables():
    numels = _leaf_numels()
    assert len(numels) == LEAVES
    ptrs = [(16 * i, 16 * i, 16 * i, 16 * i) for i in range(1, LEAVES + 1)]
    bcs = [fused_adam.bias_corrections(3, (0.9, 0.999))] * LEAVES
    tables = fused_adam.launch_tables(ptrs, numels, [b[0] for b in bcs], [b[1] for b in bcs])
    assert [len(t) for t in tables] == [fused_adam.MAX_LEAVES, LEAVES - fused_adam.MAX_LEAVES]
    chunks = [-(-n // fused_adam.CHUNK) for n in numels]
    for t, lo in zip(tables, (0, fused_adam.MAX_LEAVES)):
        mine = chunks[lo:lo + len(t)]
        assert t["chunk_start"].tolist() == [sum(mine[:i]) for i in range(len(mine))]
        assert t["n"].tolist() == numels[lo:lo + len(t)]
        assert t["aligned"].all()
    # a replay refills one slot per table, from the same host values
    slots = fused_adam.replay_scalars(numels, [b[0] for b in bcs], [b[1] for b in bcs], torch.float32)
    assert [len(s) for s in slots] == [4 * len(t) for t in tables]
    assert all(np.array_equal(s, fused_adam.table_scalars(t)) for s, t in zip(slots, tables))
    with torch.device("meta"):
        assert len([p for p in load_model("resnet50", 10).parameters()]) == 161
    assert math.ceil(161 / fused_adam.MAX_LEAVES) == 4


def test_a_replayed_adam_step_refills_one_slot_per_table():
    """Adam's host part of a replayed step (``_replay``): the step counts
    advance once, and one table-scalar array per launch table comes back,
    the float32 and the bf16 moments alike."""
    for dtype in ("float32", "bfloat16"):
        model = _port_model()
        leaf = jax_leaf_index(NAME, model)
        opt = Adam(model.parameters(), lr=LR, state_dtype=dtype,
                   leaf_index=[leaf[n] for n, _ in model.named_parameters()])
        ps = list(model.parameters())
        for p in ps:
            p.grad = torch.zeros_like(p)
        opt.step()
        slots = opt._replay([ps])
        assert [len(s) for s in slots] == [4 * fused_adam.MAX_LEAVES, 4 * (LEAVES - fused_adam.MAX_LEAVES)]
        assert {st["step"] for st in opt.state.values()} == {2}


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_the_four_table_resnet50_update_matches_its_plain_version_on_the_card(card, moments):
    """Needs a GPU and nvcc: ResNet-50's 161 leaves, 4 launches a step,
    against the plain version over 3 steps from the kernel's state: p
    within 1e-5; float32 moments within 1e-6; bf16 moments each a bf16
    neighbour of the plain unrounded moment within float32 rounding."""
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.device("meta"):
        shapes = [tuple(p.shape) for p in load_model("resnet50", 10).parameters()]
    rng = np.random.RandomState(0)
    leaves = []
    for s in shapes:
        host = [rng.randn(*s), rng.randn(*s), rng.randn(*s) * 1e-2, np.abs(rng.randn(*s)) * 1e-3]
        leaves.append([torch.from_numpy(h.astype(np.float32)).to(card).to(
            moments if i >= 2 else torch.float32) for i, h in enumerate(host)])
    wrapper = fused_adam.kernels[moments]
    hp = dict(lr=LR, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
    for t in range(1, 4):
        plain = [[x.clone() for x in leaf] for leaf in leaves]
        before = [[x.clone() for x in leaf] for leaf in leaves]
        bc = fused_adam.bias_corrections(t, hp["betas"])
        launched = wrapper.launches
        wrapper(*[[leaf[i] for leaf in leaves] for i in range(4)], bc1s=[bc[0]] * len(shapes),
                bc2s=[bc[1]] * len(shapes), steps=[t] * len(shapes), leaves=list(range(len(shapes))),
                **hp)
        assert wrapper.launches - launched == 4
        for k, (p, g, m, v) in enumerate(plain):
            fused_adam.adam_update_reference(p, g, m, v, bc1=bc[0], bc2=bc[1], step=t, leaf=k, **hp)
        for leaf, pl, b in zip(leaves, plain, before):
            assert float((leaf[0] - pl[0]).abs().max()) <= P_TOL
            if moments == torch.float32:
                assert max(float((leaf[i] - pl[i]).abs().max()) for i in (2, 3)) <= 1e-6
                continue
            g = b[1]
            for i, beta in ((2, 0.9), (3, 0.999)):
                new = g if i == 2 else g * g
                x32 = beta * b[i].float() + (1 - beta) * new
                slack = ((beta * b[i].float()).abs() + ((1 - beta) * new).abs() + x32.abs()) * 2.0**-20
                low, _ = fused_adam.bf16_neighbours(x32 - slack)
                _, high = fused_adam.bf16_neighbours(x32 + slack)
                got = leaf[i].float()
                assert bool(((got >= low) & (got <= high)).all())


# ------------------------------------------------------------------ guard --

def _state(ddp):
    out = {f"param/{n}": p.detach().clone() for n, p in ddp.model.named_parameters()}
    out.update({f"buffer/{n}": b.clone() for n, b in ddp.model.named_buffers()})
    for i, st in enumerate(ddp.optimizer.state.values()):
        out.update({f"opt/{i}/{k}": t.clone() for k, t in st.items() if torch.is_tensor(t)})
    return out


def test_a_poisoned_step_is_a_bitwise_no_op_on_every_batchnorm_buffer():
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
    after = _state(ddp)
    assert sum(k.startswith("buffer/") for k in before) == 2 * BN_LAYERS
    for k in before:
        assert torch.equal(before[k], after[k]), k
    assert ddp.skip_counters() == (1, 1)
    ddp.train_step(batches[2])
    assert ddp.skip_counters() == (1, 0)
    assert not torch.equal(after["param/fc.weight"], model.fc.weight)
    # the auditor's leaf names: the JAX auditor's keystr paths
    params, _ = _init()
    want = [jax.tree_util.keystr(path) for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    names = [n for n, _ in guard_lib.jax_leaf_names(model)]
    assert names == want and len(names) == LEAVES and names[3] == "[3]['bn1']['bias']"


# --------------------------------------------------------------- int8_ef --

def test_int8_ef_exchange_is_the_jax_packages_over_the_nested_order(cpu_devices):
    """The native sync with ``int8_ef`` at bucket_cap_mb 5 (9 buckets over
    the nested JAX leaf order): each gradient the JAX package's reduced
    leaf, bitwise. The residual ``send - q * scale``: at these bucket sizes
    the JAX package's compiled step rounds the product before the
    difference (XLA keeps ``q * scale``, which the exchange also sends),
    where at toy_cnn's it contracts the two into one fused multiply-add,
    which is what the port computes (tests/test_torch_port_comm.py); so
    each residual element is the JAX package's two-rounding value, and the
    port's its one-rounding neighbour, at most one float32 ulp apart."""
    params, _ = _init()
    model = _port_model()
    plan_j = jax_comm.make_grad_comm(params, 1, "int8_ef", 5.0)
    plan = comm.make_grad_comm(jax_sizes(NAME, model), 1, "int8_ef", 5.0)
    assert plan.buckets == plan_j.buckets and len(plan.buckets) == 9
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
        kept = comm.quantize_int8(b, scale).float() * scale  # rounded to float32
        np.testing.assert_array_equal(want_r[lo:hi], (b - kept).numpy())
        # the same difference rounded once: at most half an ulp of kept apart
        exact = b.double() - comm.quantize_int8(b, scale).double() * scale.double()
        np.testing.assert_array_equal(residual[lo:hi].numpy(), exact.float().numpy())
        assert np.all(np.abs(residual[lo:hi].numpy() - want_r[lo:hi])
                      <= np.spacing(np.abs(kept.numpy())) / 2)


# ------------------------------------------------------------ checkpoints --

def _jax_state(moments, cpu_devices, step=5):
    """A JAX TrainState of ``resnet18_small`` with random moments."""
    params, mstate = _init()
    ddp = JaxDDP(jax_load_model(NAME, 10), jax_optim.Adam(state_dtype=moments),
                 JaxCrossEntropyLoss(), mesh=make_mesh(cpu_devices[:1]))
    state = ddp.init_state(jax.random.key(1), jnp.zeros((1, HW, HW, 3)), params=params,
                           model_state=mstate)
    rng = np.random.default_rng(2)
    rand = lambda p, scale: (rng.standard_normal(p.shape, np.float32) * scale).astype(MOMENTS[moments])
    return dataclasses.replace(state, opt_state=AdamState(
        step=np.int32(step),
        m=jax.tree_util.tree_map(lambda p: rand(p, 1e-2), state.params),
        v=jax.tree_util.tree_map(lambda p: np.abs(rand(p, 1e-3)), state.params)))


def _port(moments):
    model = load_model(NAME, 10)
    leaf = jax_leaf_index(NAME, model)
    return model, Adam(model.parameters(), lr=1e-2, state_dtype=moments,
                       leaf_index=[leaf[n] for n, _ in model.named_parameters()])


def _assert_port_holds(model, opt, params, mstate, opt_state):
    want = state_dict_from_jax(NAME, _np(params), _np(mstate))
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


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_checkpoints_cross_both_ways_in_the_native_kind(tmp_path, cpu_devices, moments):
    state = _jax_state(moments, cpu_devices)
    jax_ckpt.save_on_main(str(tmp_path / "jax"), 0, state, world_size=1)
    model, opt = _port(moments)
    assert ckpt.restore_latest(str(tmp_path / "jax"), model, opt)[0] == 1
    _assert_port_holds(model, opt, state.params, state.model_state, state.opt_state)
    keys = set(np.load(str(tmp_path / "jax" / "ckpt_0.npz")).files)
    assert ".params[3]['bn1']['bias']" in keys and ".model_state[5]['down_bn']['var']" in keys

    _train_port(model, opt)
    path = ckpt.save_on_main(str(tmp_path / "port"), 3, model, opt, rank=0, seed=9, step=7)
    assert set(np.load(path).files) >= {k for k in keys if k.startswith((".params", ".model_state",
                                                                          ".opt_state"))} - {
        k for k in keys if k.startswith("__bf16__")}
    restored, epoch = jax_ckpt.restore_latest(str(tmp_path / "port"), _jax_state(moments, cpu_devices, 0),
                                              world_size=1)
    assert epoch == 4 and int(restored.step) == 7
    params, mstate = jax_from_state_dict(NAME, model.state_dict())
    _assert_trees_equal(_np(restored.params), params)
    _assert_trees_equal(_np(restored.model_state), mstate)
    _assert_port_holds(model, opt, restored.params, restored.model_state, restored.opt_state)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_checkpoints_cross_both_ways_in_the_managed_kind(tmp_path, cpu_devices, moments):
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
    _assert_port_holds(model, opt, state.params, state.model_state, state.opt_state)

    _train_port(model, opt)
    acc.save_model(pmodel, str(tmp_path / "port"))
    acc.save_state(pmodel, popt, str(tmp_path / "port"), epoch=2)
    keys = set(np.load(str(tmp_path / "port" / "state_2.npz")).files)
    assert "['params'][3]['bn1']['bias']" in keys
    jacc = JaxAccelerator(mesh=make_mesh(cpu_devices[:1]), seed=5)
    jmodel, jopt = jacc.prepare(jax_load_model(NAME, 10), jax_optim.Adam(state_dtype=moments))
    jmodel(jnp.zeros((1, HW, HW, 3)))
    assert jacc.load_state(jmodel, jopt, str(tmp_path / "port")) == 3
    params, mstate = jax_from_state_dict(NAME, model.state_dict())
    _assert_trees_equal(_np(jmodel.params), params)
    _assert_trees_equal(_np(jmodel.model_state), mstate)
    _assert_port_holds(model, opt, jmodel.params, jmodel.model_state, jopt.opt_state)
    jacc.load_model(jmodel, str(tmp_path / "jax"))
    _assert_trees_equal(_np(jmodel.params), _np(state.params))


def test_the_checkpoint_keys_are_the_jax_keystr_paths():
    params, _ = _init()
    want = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    assert [keystr(p) for p, _ in tree_leaves(params)] == want
    assert [k for k, _ in ckpt._leaves(".params", params)] == [".params" + k for k in want]


# ---------------------------------------------------------------- managed --

def test_the_managed_step_is_bitwise_the_native_step_at_world_1():
    """3 steps of each path from one state (sync_bn, the settings file's
    model): parameters and BatchNorm buffers bitwise."""
    torch.set_num_threads(2)
    batches = _batches()
    native = _port_model(sync_bn=True)
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
