"""The numerical guard of the port (``tpuddp_torch/resilience/``,
``training.guard``) against the JAX package's (``tpuddp/resilience/``,
``tests/test_guard.py``), on the CPU at world 1, with inputs made from a
seed with numpy:

- the knob (``resolve_guard``), the ``$TPUDDP_FAULT`` grammar, the batch
  poisoning, the counter functions and the exit code, as the JAX package's;
- the firewall matrix (``tests/test_guard.py:144-311``): for every hook x
  clip None/1.0, under ZeRO-1, with accumulation and with BatchNorm
  buffers, a poisoned step is a bitwise no-op on the parameters, the
  moments, the residual and the buffers; the counters read (1, 1), then
  (1, 0) after a finite step, which trains; the trajectory matches the JAX
  package's guarded step and the skip pattern and counters equal it;
- guard on a finite stream is bitwise guard off, for every optimizer;
- a chunk (``train_step_many``) and a managed fused flush with the poisoned
  step inside are bitwise their per-step guarded runs;
- the overlap guard tests (``tests/test_overlap.py:213, :234``) against
  their JAX counterparts;
- the Adam kernel's plain version with ``verdict``/``count``, its bias
  table, and its C signature against the wrapper's;
- the auditor: synced replicas pass, a non-finite parameter is named by the
  JAX package's path for it, the wrap and ``prepare`` refuse it.

Tolerances (PERF.md section 2): parameters rtol 1e-4 / atol 1e-5, losses
rtol 1e-4; the port against itself bitwise."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuddp import nn as jax_nn
from tpuddp import optim as jax_optim
from tpuddp.accelerate import Accelerator as JaxAccelerator
from tpuddp.models import ToyCNN as JaxToyCNN
from tpuddp.models import ToyMLP as JaxToyMLP
from tpuddp.parallel import make_mesh
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP
from tpuddp.resilience import EXIT_DESYNC as JAX_EXIT_DESYNC
from tpuddp.resilience import faults as jax_faults
from tpuddp.resilience import guard as jax_guard
from tpuddp.training.step import stack_batches

from tpuddp_torch import config as cfg
from tpuddp_torch import optim
from tpuddp_torch.accelerate import Accelerator
from tpuddp_torch.models import ToyCNN, ToyMLP
from tpuddp_torch.models.convert import state_dict_from_jax
from tpuddp_torch.nn import CrossEntropyLoss
from tpuddp_torch.ops import fused_adam
from tpuddp_torch.parallel import comm
from tpuddp_torch.parallel.ddp import DistributedDataParallel
from tpuddp_torch.resilience import faults
from tpuddp_torch.resilience import guard as guard_lib

KEY = jax.random.key(0)
P_RTOL, P_ATOL, LOSS_RTOL = 1e-4, 1e-5, 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def make_batch(n=32, seed=5, nan=False):
    """tests/test_guard.py's batch: float32 8x8x3 inputs, one NaN when
    poisoned."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 8, 8, 3).astype(np.float32)
    if nan:
        x[0, 0, 0, 0] = np.nan
    y = rng.randint(0, 10, n).astype(np.int32)
    return x, y, np.ones(n, np.float32)


# ----------------------------------------------------------------- config --

GUARD_FORMS = {
    "none": None, "false": False, "true": True,
    "policy": {"max_consecutive_skips": 7, "on_desync": "rollback"},
    "disabled": {"enabled": False}, "audit": {"audit_every_n_epochs": 2, "max_rollbacks": 0},
}


@pytest.mark.parametrize("form", sorted(GUARD_FORMS))
def test_resolve_guard_is_the_jax_packages(form):
    raw = GUARD_FORMS[form]
    ours, theirs = guard_lib.resolve_guard(raw), jax_guard.resolve_guard(raw)
    fields = ("enabled", "max_consecutive_skips", "audit_every_n_epochs", "on_desync",
              "max_rollbacks")
    assert [getattr(ours, f) for f in fields] == [getattr(theirs, f) for f in fields]
    assert guard_lib.resolve_guard(ours) is ours


BAD_GUARDS = {
    "typo": {"max_consecutive_skip": 1}, "on_desync": {"on_desync": "panic"},
    "negative": {"max_consecutive_skips": -1}, "audit_zero": {"audit_every_n_epochs": 0},
    "string": "on",
}


@pytest.mark.parametrize("case", sorted(BAD_GUARDS))
def test_a_bad_guard_is_the_jax_value_error(case):
    raw = BAD_GUARDS[case]
    with pytest.raises(ValueError) as theirs:
        jax_guard.resolve_guard(raw)
    with pytest.raises(ValueError) as ours:
        guard_lib.resolve_guard(raw)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match=re.escape(str(theirs.value))):
        cfg.training_config({"training": {"guard": raw}})


def test_the_entry_config_takes_the_guard():
    for raw in (True, {"max_consecutive_skips": 0, "on_desync": "rollback"}):
        assert cfg.training_config({"training": {"guard": raw}})["guard"] == raw


FAULT_SPECS = ("nan@step=5", "crash@step=5", "preempt@step=12", "crash@epoch=2",
               "preempt@epoch=1", "hang@barrier", "corrupt@ckpt_1", "replica_kill@batch=3",
               "pool_poison@step=40", "nan@step=1,crash@epoch=3", "hang@step=5",
               "corrupt@step=5", "nan@epoch=5", "oops@step=1", "nan", "crash@nowhere",
               "pool_poison@batch=1", "replica_kill@epoch=1")


@pytest.mark.parametrize("raw", FAULT_SPECS)
def test_the_fault_grammar_is_the_jax_packages(raw):
    try:
        theirs = [(s.kind, s.site, s.arg) for s in jax_faults.parse_fault_specs(raw)]
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            faults.parse_fault_specs(raw)
        assert str(ours.value) == str(e)
        return
    assert [(s.kind, s.site, s.arg) for s in faults.parse_fault_specs(raw)] == theirs


@pytest.mark.parametrize("raw,entry", [
    ("crash@epoch=2", "elastic reshard"), ("hang@barrier", "elastic reshard"),
    ("corrupt@ckpt_1", "elastic reshard"), ("crash@step=3", "elastic reshard"),
    ("preempt@epoch=1", "async pipeline"), ("preempt@step=12", "async pipeline"),
])
def test_the_other_fault_kinds_are_refused(monkeypatch, raw, entry):
    monkeypatch.setenv("TPUDDP_FAULT", raw)
    faults.reload_faults()
    try:
        with pytest.raises(NotImplementedError, match=f"Queue 1 item 8: {entry}"):
            faults.refuse_unported()
    finally:
        faults.reload_faults()


def test_nan_and_serving_kinds_are_not_refused(monkeypatch):
    monkeypatch.setenv("TPUDDP_FAULT", "nan@step=2,replica_kill@batch=3")
    faults.reload_faults()
    try:
        faults.refuse_unported()
        assert faults.has_nan_fault()
    finally:
        faults.reload_faults()


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_batch_poisoning_is_the_jax_packages(monkeypatch, dtype):
    """The poisoned batch (NaN in x, or in the weight for uint8 inputs) at
    the spec's step only, once."""
    rng = np.random.RandomState(0)
    batch = ((rng.rand(4, 8, 8, 3) * 255).astype(dtype), rng.randint(0, 10, 4),
             np.ones(4, np.float32))
    monkeypatch.setenv("TPUDDP_FAULT", "nan@step=2")
    out = {}
    for name, lib in (("ours", faults), ("theirs", jax_faults)):
        lib.reload_faults()
        out[name] = [lib.maybe_corrupt_batch(batch, i) for i in (0, 2, 2)]
        lib.reload_faults()
    for (a, b) in zip(out["ours"], out["theirs"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert out["ours"][0] is batch and out["ours"][2] is batch  # fires once
    assert not all(np.array_equal(x, y, equal_nan=False) for x, y in zip(out["ours"][1], batch))


def test_the_counters_advance_as_the_jax_packages_bump_and_reset():
    """The device update of one verdict, against ``bump_skip_counters``
    (verdict 0) and ``reset_consecutive`` (verdict 1)."""
    ours, theirs = guard_lib.init_skip_counters(), jax_guard.init_skip_counters()
    for v in (0, 0, 1, 0, 1, 1, 0, 0, 0):
        guard_lib.advance_skip_counters_(ours, torch.tensor(v, dtype=torch.int32))
        theirs = (jax_guard.reset_consecutive if v else jax_guard.bump_skip_counters)(theirs)
        assert guard_lib.read_skip_counters(ours) == jax_guard.read_skip_counters(
            type("S", (), {"skipped_steps": theirs})())
    assert guard_lib.read_skip_counters(ours) == (6, 3)
    assert ours["total"].dtype == torch.int32


def test_the_exit_code_is_the_jax_packages():
    assert guard_lib.EXIT_DESYNC == JAX_EXIT_DESYNC == 77


ALL_FINITE_CASES = [(v, pos) for v in ("nan", "inf", "-inf") for pos in (0, 7, 4095, 4096, -1)]


def _finiteness_leaves(value=None, pos=0, rng=None):
    rng = rng or np.random.RandomState(0)
    leaves = [rng.randn(3, 4).astype(np.float32), rng.randn(5000).astype(np.float32) * np.float32(5e37),
              np.zeros((0,), np.float32)]
    if value is not None:
        leaves[1][pos] = float(value)
    return leaves


@pytest.mark.parametrize("value,pos", ALL_FINITE_CASES + [(None, 0)])
def test_all_finite_is_tree_all_finite(value, pos):
    """NaN and infinities anywhere, finite values near the float32 limit
    (their range overflows: no false skip), an empty leaf."""
    leaves = _finiteness_leaves(value, pos)
    want = bool(jax_guard.tree_all_finite([jnp.asarray(a) for a in leaves]))
    assert bool(guard_lib.all_finite([torch.from_numpy(a) for a in leaves])) == want
    assert want == (value is None)
    assert bool(guard_lib.all_finite([torch.zeros(0)])) and bool(guard_lib.all_finite([]))


# --------------------------------------------------------------- firewall --

def jax_build(hook="none", clip=None, wus=False, accum=1, model=None, guard=True):
    return JaxDDP(model if model is not None else JaxToyMLP(hidden=(16,)), jax_optim.Adam(1e-2),
                  jax_nn.CrossEntropyLoss(), mesh=make_mesh(jax.devices("cpu")[:1]),
                  comm_hook=hook, weight_update_sharding=wus, grad_accumulation=accum,
                  clip_grad_norm=clip, guard=guard)


def port_from(jax_state, name="toy_mlp", hook="none", clip=None, wus=False, accum=1,
              guard=True, opt=None, **kw):
    """The port's wrap of the JAX state's model and weights, with the
    optimizer ``opt(params)`` (Adam at 1e-2 when None)."""
    model = ToyMLP(192, 10, hidden=(16,)) if name == "toy_mlp" else ToyCNN(
        10, widths=(4,), input_shape=(8, 8, 3), sync_bn=name == "toy_cnn_bn")
    mstate = None if name == "toy_mlp" else _np(jax_state.model_state)
    model.load_state_dict(state_dict_from_jax("toy_mlp" if name == "toy_mlp" else "toy_cnn",
                                              _np(jax_state.params), mstate))
    optimizer = (opt or (lambda p: optim.Adam(p, lr=1e-2)))(model.parameters())
    return DistributedDataParallel(model, optimizer, CrossEntropyLoss(), device="cpu",
                                   comm_hook=hook, clip_grad_norm=clip,
                                   weight_update_sharding=wus, grad_accumulation=accum,
                                   guard=guard, **kw)


def snapshot(ddp):
    """Parameters, buffers, optimizer state and the residual, copied."""
    out = {f"model/{k}": v.clone() for k, v in ddp.model.state_dict().items()}
    for i, st in enumerate(ddp.optimizer.state.values()):
        out.update({f"opt{i}/{k}": v.clone() for k, v in st.items() if torch.is_tensor(v)})
    if ddp.residual is not None:
        out["residual"] = ddp.residual.clone()
    return out


def assert_bitwise(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


def assert_params_close(ddp, jax_state, name="toy_mlp"):
    mstate = None if name == "toy_mlp" else _np(jax_state.model_state)
    ref = state_dict_from_jax("toy_mlp" if name == "toy_mlp" else "toy_cnn",
                              _np(jax_state.params), mstate)
    got = ddp.model.state_dict()
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=P_RTOL, atol=P_ATOL, err_msg=k)


def _loss(sums):
    return float(sums[0] / sums[1])


def _jax_loss(m):
    m = jax.device_get(m)
    return float(np.sum(m["loss_sum"]) / np.sum(m["n"]))


STREAM = ("good", "bad", "good", "good")


@pytest.mark.parametrize("hook", comm.COMM_HOOKS)
@pytest.mark.parametrize("clip", [None, 1.0])
def test_firewall_skips_bitwise_and_matches_jax(hook, clip):
    """tests/test_guard.py's acceptance matrix on the port, step by step
    against the JAX package's guarded step from the same weights."""
    jd = jax_build(hook=hook, clip=clip)
    js = jd.init_state(KEY, jnp.zeros((1, 8, 8, 3)))
    ddp = port_from(js, hook=hook, clip=clip)
    before = None
    for i, kind in enumerate(STREAM):
        batch = make_batch(seed=10 + i, nan=kind == "bad")
        if kind == "bad":
            before = snapshot(ddp)
        sums = ddp.train_step(batch)
        js, m = jd.train_step(js, jd.shard(batch))
        assert ddp.skip_counters() == jax_guard.read_skip_counters(js)
        if kind == "bad":
            assert_bitwise(snapshot(ddp), before)
            assert ddp.skip_counters() == (1, 1)
        else:
            np.testing.assert_allclose(_loss(sums), _jax_loss(m), rtol=LOSS_RTOL)
        assert_params_close(ddp, js)
    assert ddp.skip_counters() == (1, 0)
    after = snapshot(ddp)
    assert any(not torch.equal(after[k], before[k]) for k in before if k.startswith("model/"))


@pytest.mark.parametrize("hook", ["bf16_ef", "int8_ef", "topk_ef"])
def test_firewall_under_zero1_matches_jax(hook):
    """ZeRO-1 with a hook and the clip (tests/test_guard.py:189-218): the
    skip keeps the sharded moments and the full-length residual; at world 1
    the shard is the whole vector."""
    jd = jax_build(hook=hook, clip=0.5, wus=True)
    js = jd.init_state(KEY, jnp.zeros((1, 8, 8, 3)))
    ddp = port_from(js, hook=hook, clip=0.5, wus=True)
    for i, kind in enumerate(STREAM):
        batch = make_batch(seed=20 + i, nan=kind == "bad")
        before = snapshot(ddp)
        ddp.train_step(batch)
        js, _ = jd.train_step(js, jd.shard(batch))
        assert ddp.skip_counters() == jax_guard.read_skip_counters(js)
        if kind == "bad":
            assert torch.any(before["residual"] != 0)
            assert_bitwise(snapshot(ddp), before)
        assert_params_close(ddp, js)


def test_firewall_skips_the_whole_accumulation_cycle():
    """One poisoned micro-batch skips its cycle's one update bitwise; the
    clean cycle of the same chunk applies (tests/test_guard.py:242-276)."""
    jd = jax_build(hook="bf16_ef", clip=1.0, accum=2)
    js = jd.init_state(KEY, jnp.zeros((1, 8, 8, 3)))
    ddp = port_from(js, hook="bf16_ef", clip=1.0, accum=2)
    good, bad = make_batch(), make_batch(nan=True)
    for chunk, want in (([good, good], (0, 0)), ([bad, good, good, good], (1, 0)),
                        ([bad, good], (2, 1))):
        before = snapshot(ddp)
        ddp.train_step_many(chunk)
        js, _ = jd.train_step_many(js, jd.shard_stacked(stack_batches(chunk)))
        assert ddp.skip_counters() == jax_guard.read_skip_counters(js) == want
        if len(chunk) == 2 and want[0]:
            assert_bitwise(snapshot(ddp), before)
        assert_params_close(ddp, js)


def test_firewall_reverts_batchnorm_buffers():
    """The no-op covers the BatchNorm running statistics of the poisoned
    forward (tests/test_guard.py:279-293)."""
    model = JaxToyCNN(num_classes=10, widths=(4,), sync_bn=True)
    jax_nn.convert_sync_batchnorm(model)
    jd = jax_build(model=model)
    js = jd.init_state(KEY, jnp.zeros((1, 8, 8, 3)))
    ddp = port_from(js, name="toy_cnn_bn")
    for i, kind in enumerate(STREAM):
        batch = make_batch(seed=30 + i, nan=kind == "bad")
        before = snapshot(ddp)
        ddp.train_step(batch)
        js, _ = jd.train_step(js, jd.shard(batch))
        assert ddp.skip_counters() == jax_guard.read_skip_counters(js)
        if kind == "bad":
            assert_bitwise(snapshot(ddp), before)
        assert_params_close(ddp, js, name="toy_cnn")


def test_a_cycle_skip_reverts_the_buffers_of_every_micro_batch():
    """Under accumulation the buffers go back to their values before the
    cycle's first forward, whichever micro-batch was poisoned."""
    model = JaxToyCNN(num_classes=10, widths=(4,), sync_bn=True)
    jd = jax_build(model=model)
    js = jd.init_state(KEY, jnp.zeros((1, 8, 8, 3)))
    ddp = port_from(js, name="toy_cnn_bn", accum=2)
    ddp.train_cycle([make_batch(seed=1), make_batch(seed=2)])
    before = snapshot(ddp)
    ddp.train_cycle([make_batch(seed=3), make_batch(seed=4, nan=True)])
    assert_bitwise(snapshot(ddp), before)
    assert ddp.skip_counters() == (1, 1)


OPTIMIZERS = {
    "adam": lambda p: optim.Adam(p, lr=1e-2),
    "adam_bf16": lambda p: optim.Adam(p, lr=1e-2, state_dtype="bfloat16",
                                      leaf_index=list(range(len(list(p))))),
    "sgd": lambda p: optim.SGD(p, 0.1, momentum=0.9, weight_decay=1e-3),
    "sgd_plain": lambda p: optim.SGD(p, 0.1),
    "sgdw": lambda p: optim.SGDW(p, 0.1, weight_decay=0.1),
    "lars": lambda p: optim.LARS(p, 1.0, weight_decay=1e-3),
    "lamb": lambda p: optim.LAMB(p, 1e-2, weight_decay=1e-2),
}


def _leafy(name):
    """``OPTIMIZERS[name]`` over a list of parameters (bf16 moments need one
    leaf index per parameter)."""
    return lambda params: OPTIMIZERS[name](list(params))


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
@pytest.mark.parametrize("zero1", [False, True])
def test_every_optimizer_skips_bitwise_and_is_guard_off_on_a_finite_stream(opt, zero1):
    """Adam's guarded kernel form and the other optimizers' selects: a
    poisoned step writes nothing, and a finite stream (with its step
    counts) is bitwise the unguarded run."""
    jd = jax_build(model=JaxToyCNN(num_classes=10, widths=(4,)))
    js = jd.init_state(KEY, jnp.zeros((1, 8, 8, 3)))
    runs = {}
    for guard in (True, False):
        ddp = port_from(js, name="toy_cnn", hook="int8_ef", clip=1.0, wus=zero1, guard=guard,
                        opt=_leafy(opt))
        for i in range(3):
            ddp.train_step(make_batch(seed=40 + i))
        optim.sync_steps(ddp.optimizer)
        runs[guard] = (snapshot(ddp), [st.get("step") for st in ddp.optimizer.state.values()])
        if guard:
            before = snapshot(ddp)
            ddp.train_step(make_batch(seed=50, nan=True))
            assert_bitwise(snapshot(ddp), before)
            assert ddp.skip_counters() == (1, 1)
    assert_bitwise(runs[True][0], runs[False][0])
    assert runs[True][1] == runs[False][1]


@pytest.mark.parametrize("hook", comm.COMM_HOOKS)
def test_guard_on_a_finite_stream_is_bitwise_guard_off(hook):
    """Clip and check on the float32 aggregate before quantisation: the
    guarded run only observes (tests/test_guard.py:296-311)."""
    jd = jax_build(hook=hook, clip=1.0)
    js = jd.init_state(KEY, jnp.zeros((1, 8, 8, 3)))
    runs = {}
    for guard in (True, False, None, {"enabled": False}):
        ddp = port_from(js, hook=hook, clip=1.0, guard=guard)
        for seed in range(4):
            ddp.train_step(make_batch(seed=seed))
        runs[str(guard)] = snapshot(ddp)
        assert ddp.skip_counters() == (0, 0)
        assert (ddp.firewall is not None) == (guard is True)
    for k in ("False", "None", "{'enabled': False}"):
        assert_bitwise(runs["True"], runs[k])


@pytest.mark.parametrize("accum", [1, 2])
def test_a_chunk_with_a_poisoned_step_is_its_per_step_run(accum):
    """``train_step_many`` over a chunk holding the poisoned step is bitwise
    the same steps one at a time (the card replays the same chunk)."""
    jd = jax_build(hook="int8_ef")
    js = jd.init_state(KEY, jnp.zeros((1, 8, 8, 3)))
    batches = [make_batch(seed=60 + i, nan=i == 3) for i in range(8)]
    out = {}
    for mode in ("chunk", "steps"):
        ddp = port_from(js, hook="int8_ef", accum=accum)
        if mode == "chunk":
            sums = ddp.train_step_many(batches)
        else:
            sums = torch.zeros(2)
            for i in range(0, 8, accum):
                sums = sums + (ddp.train_step(batches[i]) if accum == 1
                               else ddp.train_cycle(batches[i:i + accum]))
        out[mode] = (snapshot(ddp), ddp.skip_counters(), sums)
    assert_bitwise(out["chunk"][0], out["steps"][0])
    assert out["chunk"][1] == out["steps"][1] == (1, 0)
    torch.testing.assert_close(out["chunk"][2], out["steps"][2], rtol=0, atol=0, equal_nan=True)


# ------------------------------------------------------------ managed path --

def _managed(js, fuse=1, accum=1, hook="none", name="toy_mlp", guard=True, clip=None):
    acc = Accelerator(seed=0, device="cpu", guard=guard, fuse_steps=fuse,
                      gradient_accumulation_steps=accum, comm_hook=hook, clip_grad_norm=clip)
    model = ToyMLP(192, 10, hidden=(16,)) if name == "toy_mlp" else ToyCNN(
        10, widths=(4,), input_shape=(8, 8, 3))
    mstate = None if name == "toy_mlp" else _np(js.model_state)
    model.load_state_dict(state_dict_from_jax(name, _np(js.params), mstate))
    model, opt = acc.prepare(model, optim.Adam(model.parameters(), lr=1e-2))
    return acc, model, opt


def _managed_step(acc, model, opt, batch):
    criterion = CrossEntropyLoss()
    loss = criterion(model(batch[0]), batch[1], batch[2])
    acc.backward(loss)
    opt.step()
    return loss


def _managed_state(model, opt):
    out = {f"model/{k}": v.clone() for k, v in model.module.state_dict().items()}
    for i, st in enumerate(opt.optimizer.state.values()):
        out.update({f"opt{i}/{k}": v.clone() for k, v in st.items() if torch.is_tensor(v)})
    for i, r in enumerate(opt.comm_residual() or ()):
        out[f"residual{i}"] = r.clone()
    return out


@pytest.mark.parametrize("hook", ["none", "bf16_ef", "int8_ef"])
def test_managed_skip_is_bitwise_and_matches_jax(hook):
    """The managed per-step apply (``tpuddp/accelerate.py:790-840``): the
    poisoned step is a no-op, residual included; the counters and the
    parameters follow the JAX Accelerator's."""
    jd = jax_build()
    js = jd.init_state(KEY, jnp.zeros((1, 8, 8, 3)))
    acc, model, opt = _managed(js, hook=hook, clip=1.0)
    jacc = JaxAccelerator(mesh=make_mesh(jax.devices("cpu")[:1]), seed=0, guard=True,
                          comm_hook=hook, clip_grad_norm=1.0)
    jmod = JaxToyMLP(hidden=(16,))
    jmod._tpuddp_initial_variables = (js.params, js.model_state)
    jmodel, jopt = jacc.prepare(jmod, jax_optim.Adam(1e-2))
    crit = jax_nn.CrossEntropyLoss()
    for i, kind in enumerate(STREAM):
        batch = make_batch(seed=70 + i, nan=kind == "bad")
        before = _managed_state(model, opt)
        _managed_step(acc, model, opt, batch)
        jl = crit(jmodel(batch[0]), batch[1], batch[2])
        jacc.backward(jl)
        jopt.step()
        assert opt.skip_counters() == jopt.skip_counters()
        if kind == "bad":
            assert_bitwise(_managed_state(model, opt), before)
        ref = state_dict_from_jax("toy_mlp", _np(jmodel.params))
        for k, v in ref.items():
            np.testing.assert_allclose(model.module.state_dict()[k].numpy(), v.numpy(),
                                       rtol=P_RTOL, atol=P_ATOL, err_msg=k)
    assert opt.skip_counters() == (1, 0)


def test_managed_accumulation_skip_reverts_buffers():
    """tests/test_guard.py:456-490: a poisoned first micro-batch skips the
    cycle and restores the buffers from before the cycle."""
    jd = jax_build(model=JaxToyCNN(num_classes=10, widths=(4,)))
    js = jd.init_state(KEY, jnp.zeros((1, 8, 8, 3)))
    acc, model, opt = _managed(js, accum=2, name="toy_cnn")
    good, bad = make_batch(), make_batch(nan=True)
    for batch in (good, good):
        _managed_step(acc, model, opt, batch)
    before = _managed_state(model, opt)
    for batch in (bad, good):
        _managed_step(acc, model, opt, batch)
    assert_bitwise(_managed_state(model, opt), before)
    assert opt.skip_counters() == (1, 1)
    for batch in (good, good):
        _managed_step(acc, model, opt, batch)
    assert opt.skip_counters() == (1, 0)
    assert np.isfinite(CrossEntropyLoss()(model.eval()(good[0]), good[1], good[2]).item())


def test_a_managed_flush_with_a_poisoned_step_is_its_per_step_run():
    """A fused flush of 8 (the eager queue on the CPU, a CUDA-graph replay
    on the card) holding the poisoned step: bitwise the depth-1 run."""
    jd = jax_build()
    js = jd.init_state(KEY, jnp.zeros((1, 8, 8, 3)))
    batches = [make_batch(seed=80 + i, nan=i == 5) for i in range(8)]
    out = {}
    for fuse in (8, 1):
        acc, model, opt = _managed(js, fuse=fuse, hook="int8_ef")
        losses = [_managed_step(acc, model, opt, b) for b in batches]
        values = torch.stack([loss.device_value() for loss in losses])
        out[fuse] = (_managed_state(model, opt), opt.skip_counters(), values)
    assert_bitwise(out[8][0], out[1][0])
    assert out[8][1] == out[1][1] == (1, 0)
    torch.testing.assert_close(out[8][2], out[1][2], rtol=0, atol=0, equal_nan=True)


# --------------------------------------------------------- overlap + guard --

SPLIT_CAP = 600 * 4 / (1024 * 1024)  # tests/test_overlap.py: the two Linears apart


def _overlap_pair(js, overlap, hook="bf16_ef"):
    return port_from(js, hook=hook, bucket_cap_mb=SPLIT_CAP, comm_overlap=overlap)


def _overlap_batch(seed, n=64):
    from tpuddp.data import SyntheticClassification

    x, y = SyntheticClassification(n=n, shape=(8, 8, 3), seed=seed).get_batch(np.arange(n))
    return x, y, np.ones(n, np.float32)


def test_overlap_bitwise_parity_with_guard():
    """tests/test_overlap.py:213: segmented and barrier guarded steps are
    bitwise one another, with no skip, and follow the JAX package's."""
    jd = JaxDDP(JaxToyMLP(hidden=(16,)), jax_optim.Adam(1e-2), jax_nn.CrossEntropyLoss(),
                mesh=make_mesh(jax.devices("cpu")[:1]), comm_hook="bf16_ef",
                bucket_cap_mb=SPLIT_CAP, comm_overlap=True, guard=True)
    js0 = jd.init_state(KEY, _overlap_batch(5)[0][:8])
    runs = {}
    for overlap in (True, False):
        ddp = _overlap_pair(js0, overlap)
        assert ddp.comm_overlap_meta["enabled"] is overlap
        losses = [_loss(ddp.train_step(_overlap_batch(100 + i))) for i in range(4)]
        runs[overlap] = (snapshot(ddp), losses, ddp.skip_counters())
    assert runs[True][1] == runs[False][1]
    assert_bitwise(runs[True][0], runs[False][0])
    assert runs[True][2] == runs[False][2] == (0, 0)
    js = js0
    jlosses = []
    for i in range(4):
        js, m = jd.train_step(js, jd.shard(_overlap_batch(100 + i)))
        jlosses.append(_jax_loss(m))
    np.testing.assert_allclose(runs[True][1], jlosses, rtol=LOSS_RTOL)
    assert jax_guard.read_skip_counters(js) == (0, 0)


def test_guard_skip_is_noop_across_all_segment_residual_slices():
    """tests/test_overlap.py:234: after a clean step every segment's
    residual span is armed; a step poisoning every segment's gradient
    leaves each span and the parameters bitwise as they were."""
    jd = JaxDDP(JaxToyMLP(hidden=(16,)), jax_optim.Adam(1e-2), jax_nn.CrossEntropyLoss(),
                mesh=make_mesh(jax.devices("cpu")[:1]), comm_hook="bf16_ef",
                bucket_cap_mb=SPLIT_CAP, comm_overlap=True, guard=True)
    x, y, w = _overlap_batch(5)
    js = jd.init_state(KEY, x[:8])
    ddp = _overlap_pair(js, True)
    segments = ddp._overlap.segments
    assert len(segments) == 2
    ddp.train_step((x, y, w))
    js, _ = jd.train_step(js, jd.shard((x, y, w)))
    before = snapshot(ddp)
    for seg in segments:
        assert before["residual"][seg.flat[0]:seg.flat[1]].abs().sum() > 0, seg
    xb = x.copy()
    xb[:] = np.nan
    ddp.train_step((xb, y, w))
    js, _ = jd.train_step(js, jd.shard((xb, y, w)))
    assert_bitwise(snapshot(ddp), before)
    assert ddp._overlap.counts["hook"] == 2 * len(segments)
    assert ddp.skip_counters() == jax_guard.read_skip_counters(js) == (1, 1)
    np.testing.assert_allclose(before["residual"].numpy(), np.asarray(js.comm_state),
                               rtol=P_RTOL, atol=P_ATOL)


def test_the_guard_leaves_overlap_eligibility_as_the_jax_package_does():
    jd = jax_build()
    js = jd.init_state(KEY, jnp.zeros((1, 8, 8, 3)))
    for overlap in ("auto", True, False):
        metas = [port_from(js, hook="int8_ef", bucket_cap_mb=SPLIT_CAP, comm_overlap=overlap,
                           guard=g).comm_overlap_meta for g in (True, False)]
        assert metas[0] == metas[1]


# -------------------------------------------------- the kernel's guarded form --

def _leaves(seed, moments=torch.float32):
    rng = np.random.RandomState(seed)
    shapes = [(37, 50), (5,), (700, 13)]
    out = []
    for sh in shapes:
        p, g = (torch.from_numpy(rng.randn(*sh).astype(np.float32)) for _ in range(2))
        m = torch.from_numpy(rng.randn(*sh).astype(np.float32) * 0.1).to(moments)
        v = torch.from_numpy(rng.rand(*sh).astype(np.float32) * 0.01).to(moments)
        out.append([p, g, m, v])
    return out


def _update(leaves, moments, guarded, count=None, verdict=1, step=None):
    ps, gs, ms, vs = (list(x) for x in zip(*leaves))
    hp = dict(lr=1e-2, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-3,
              leaves=[3, 0, 7] if moments == torch.bfloat16 else None, bases=[0, 11, 5])
    if guarded:
        fused_adam.adam_update(ps, gs, ms, vs, verdict=torch.tensor(verdict, dtype=torch.int32),
                               count=torch.tensor(count, dtype=torch.int32), **hp)
    else:
        bc1, bc2 = fused_adam.bias_corrections(step, hp["betas"])
        fused_adam.adam_update(ps, gs, ms, vs, bc1s=[bc1] * 3, bc2s=[bc2] * 3, steps=[step] * 3,
                               **hp)


@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("count", [0, 6, 20000, 10**6])
def test_the_plain_guarded_form_is_the_unguarded_one_at_its_count(moments, count):
    """verdict 1 at device count c is bitwise the unguarded update of step
    c + 1 (bias corrections and bf16 noise keyed by it); verdict 0 writes
    nothing."""
    a, b, c = _leaves(1, moments), _leaves(1, moments), _leaves(1, moments)
    _update(a, moments, True, count=count)
    _update(b, moments, False, step=count + 1)
    _update(c, moments, True, count=count, verdict=0)
    for la, lb, lc, l0 in zip(a, b, c, _leaves(1, moments)):
        for x, y, z, w in zip(la, lb, lc, l0):
            assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                               y.view(torch.int16) if y.dtype == torch.bfloat16 else y)
            assert torch.equal(z, w)


def test_the_plain_guarded_form_refuses_host_steps():
    leaves = _leaves(2)
    ps, gs, ms, vs = (list(x) for x in zip(*leaves))
    with pytest.raises(ValueError, match="takes its steps from count"):
        fused_adam.adam_update(ps, gs, ms, vs, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=0.0, bc1s=[1.0] * 3, bc2s=[1.0] * 3,
                               verdict=torch.tensor(1, dtype=torch.int32),
                               count=torch.tensor(0, dtype=torch.int32))


@pytest.mark.parametrize("betas", [(0.9, 0.999), (0.8, 0.99), (0.5, 0.9999), (0.0, 0.95)])
def test_the_bias_table_is_the_hosts_values_and_ends_at_one(betas):
    table = fused_adam.bias_table(betas, "cpu").numpy()
    rows = fused_adam.bias_rows(betas)
    assert table.shape == (rows, 2) and table.dtype == np.float32
    for t in list(range(1, 40)) + [rows // 2, rows - 1]:
        assert tuple(table[t]) == fused_adam.bias_corrections(t, betas)
    assert tuple(table[-1]) == (1.0, 1.0)
    for t in (rows, rows + 1, 3 * rows, 10**7):  # the kernel reads the last row for these
        assert fused_adam.bias_corrections(t, betas) == (1.0, 1.0)
    inverse = fused_adam.bias_table(betas, "cpu", inverse=True).numpy()
    np.testing.assert_array_equal(inverse[1:], np.float32(1) / table[1:])


def test_the_bias_table_refuses_betas_at_one():
    with pytest.raises(ValueError, match="betas below 1"):
        fused_adam.bias_rows((0.9, 1.0))


def test_the_guarded_rows_hold_the_noise_words_step_free_part():
    """The kernel adds t * 0x85EBCA77 (uint32) to the row's word: the
    unguarded word of step t, for every t."""
    for leaf, base in ((0, 0), (7, 123456), (3, 2**31 + 5)):
        free = fused_adam._noise([0], [leaf], 1, [base])[0]
        for t in (1, 2, 5, 10**6, 2**32 - 1):
            want = fused_adam._noise([t], [leaf], 1, [base])[0]
            assert tuple((w + t * fused_adam.WEYL_STEP) & 0xFFFFFFFF for w in free) == want


def test_the_c_signature_matches_the_wrappers_argtypes():
    """The two entry points of csrc/fused_adam.cu take the parameters the
    ctypes wrapper declares, in order (the guarded form added verdict,
    count, the bias table and its length), and the table fits 4 KB."""
    src = open(fused_adam.SOURCE).read()
    for symbol in ("tpuddp_fused_adam_multi", "tpuddp_fused_adam_multi_bf16"):
        decl = re.search(rf'extern "C" int {symbol}\((.*?)\)\s*\{{', src, re.S).group(1)
        kinds = [re.sub(r"\s+\w+$", "", a.strip()) for a in decl.split(",")]
        ptr = lambda k: k.endswith("*")  # noqa: E731
        want = (["ptr", "int", "int64", "ptr", "ptr", "ptr", "ptr", "ptr", "int64"]
                + ["float"] * 7 + ["ptr"])
        got = ["ptr" if ptr(k) else {"int": "int", "int64_t": "int64", "float": "float"}[k]
               for k in kinds]
        assert got == want, symbol
    table = re.search(r"struct Table \{(.*?)\};", src, re.S).group(1)
    assert "const int32_t* verdict" in table and "const float2* bc" in table
    assert "if (table.verdict != nullptr && *table.verdict == 0)" in src


# ----------------------------------------------------------------- auditor --

@pytest.mark.parametrize("name", ["toy_mlp", "toy_cnn"])
def test_the_audit_names_leaves_by_the_jax_paths(name):
    """The port's parameters in the JAX tree order under its keystr paths."""
    from tpuddp.models import load_model as jax_load_model
    from tpuddp_torch.models import load_model

    params, _ = jax_load_model(name, 10).init(KEY, jnp.zeros((1, 8, 8, 3)))
    want = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    model = load_model(name, 10, input_shape=(8, 8, 3))
    assert [n for n, _ in guard_lib.jax_leaf_names(model)] == want


def test_alexnet_audit_names_are_the_jax_paths():
    from tpuddp.models import load_model as jax_load_model
    from tpuddp_torch.models import AlexNet

    shapes = jax.eval_shape(lambda: jax_load_model("alexnet", 10).init(
        KEY, jnp.zeros((1, 224, 224, 3)))[0])
    want = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    with torch.device("meta"):
        model = AlexNet(num_classes=10)
    assert [n for n, _ in guard_lib.jax_leaf_names(model)] == want


@pytest.mark.parametrize("leaf", [0, 1, 3])
def test_the_auditor_names_the_non_finite_leaf_the_jax_package_names(leaf):
    """Synced replicas pass; a non-finite parameter is flagged under the
    path the JAX auditor gives the same leaf (tests/test_guard.py:393-428)."""
    jd = jax_build()
    js = jd.init_state(KEY, jnp.zeros((1, 8, 8, 3)))
    ddp = port_from(js)
    assert guard_lib.audit_params(ddp.model) is None
    leaves, treedef = jax.tree_util.tree_flatten(_np(js.params))
    leaves[leaf] = leaves[leaf] * np.nan
    bad = jax.tree_util.tree_unflatten(treedef, leaves)
    theirs = jax_guard.audit_params(jd.mesh, jax.tree_util.tree_map(jnp.asarray, bad))
    ddp.model.load_state_dict(state_dict_from_jax("toy_mlp", bad))
    assert guard_lib.audit_params(ddp.model) == theirs is not None
    with pytest.raises(guard_lib.ReplicaDesync, match="exit 77"):
        guard_lib.audit_or_raise(ddp.model, where="test")


def test_the_wrap_and_prepare_audit_their_replicas():
    jd = jax_build()
    js = jd.init_state(KEY, jnp.zeros((1, 8, 8, 3)))
    params = _np(js.params)
    params[1]["weight"] = params[1]["weight"] * np.inf  # -> NaN where 0, inf elsewhere
    poisoned = type("S", (), {"params": params, "model_state": js.model_state})()
    with pytest.raises(guard_lib.ReplicaDesync, match="ddp-wrap"):
        port_from(poisoned)
    port_from(poisoned, guard=False)  # the unguarded wrap does not audit
    model = ToyMLP(192, 10, hidden=(16,))
    model.load_state_dict(state_dict_from_jax("toy_mlp", params))
    with pytest.raises(guard_lib.ReplicaDesync, match="accelerator-prepare"):
        Accelerator(seed=0, device="cpu", guard=True).prepare(model, optim.Adam(
            model.parameters(), lr=1e-3))


def test_the_guard_needs_an_optimizer_of_the_port():
    model = ToyMLP(192, 10, hidden=(16,))
    with pytest.raises(TypeError, match="tpuddp_torch.optim"):
        DistributedDataParallel(model, torch.optim.SGD(model.parameters(), lr=0.1),
                                CrossEntropyLoss(), device="cpu", guard=True)


# ------------------------------------------------------------ on the card --

@pytest.fixture()
def card():
    """The GPU, with cuDNN's deterministic algorithms as the entry points
    run them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = deterministic


def _card_copy(leaves):
    return [[t.cuda() for t in leaf] for leaf in leaves]


@pytest.mark.cuda
@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("count", [0, 6, 30000])
def test_the_guarded_kernel_is_the_unguarded_one_on_the_card(card, moments, count):
    """The kernel's guarded form at verdict 1 bitwise its unguarded launch
    of step count + 1; at verdict 0 nothing written, one launch counted;
    against the guarded plain version on the CPU within the kernel's
    tolerances (tests/test_torch_port_adam.py)."""
    kernel = fused_adam.kernels[moments]
    host = _leaves(3, moments)
    a, b, c = _card_copy(host), _card_copy(host), _card_copy(host)
    _update(a, moments, False, step=count + 1)
    ps, gs, ms, vs = (list(x) for x in zip(*b))
    hp = dict(lr=1e-2, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-3,
              leaves=[3, 0, 7] if moments == torch.bfloat16 else None, bases=[0, 11, 5])
    count_t = torch.tensor(count, dtype=torch.int32, device=card)
    kernel(ps, gs, ms, vs, verdict=torch.ones((), dtype=torch.int32, device=card), count=count_t,
           **hp)
    kernel.reset_launches()
    ps, gs, ms, vs = (list(x) for x in zip(*c))
    kernel(ps, gs, ms, vs, verdict=torch.zeros((), dtype=torch.int32, device=card),
           count=count_t, **hp)
    torch.cuda.synchronize()
    assert kernel.launches == 1
    plain = [[t.clone() for t in leaf] for leaf in host]
    _update(plain, moments, True, count=count)
    for la, lb, lc, lh, lp in zip(a, b, c, host, plain):
        for x, y, z, w in zip(la, lb, lc, lh):
            bits = (lambda t: t.view(torch.int16)) if x.dtype == torch.bfloat16 else (lambda t: t)
            assert torch.equal(bits(x), bits(y))
            assert torch.equal(bits(z.cpu()), bits(w))
        np.testing.assert_allclose(lb[0].cpu().numpy(), lp[0].numpy(), rtol=0, atol=1e-5)


def _toy_ddp(guard, replay, hook, opt="adam"):
    torch.manual_seed(0)
    model = ToyCNN(10, widths=(4, 8), input_shape=(8, 8, 3), sync_bn=True)
    gen = torch.Generator().manual_seed(2)
    from tpuddp_torch.data.transforms import make_train_augment

    ddp = DistributedDataParallel(
        model, _leafy(opt)(model.parameters()), CrossEntropyLoss(), device="cuda",
        comm_hook=hook, bucket_cap_mb=0.002, guard=guard,
        augment=make_train_augment(size=None, flip=True, generator=gen), generator=gen)
    ddp._graph_replay = replay
    return ddp


@pytest.mark.cuda
@pytest.mark.parametrize("hook,opt", [("none", "adam"), ("bf16_ef", "adam"), ("int8_ef", "adam_bf16"),
                                      ("none", "lamb"), ("topk_ef", "sgd")])
def test_a_guarded_chunk_replay_is_bitwise_its_eager_chunk_on_the_card(card, hook, opt):
    """3 chunks of 4 toy_cnn steps (segmented with a hook), the last holding
    a poisoned step: the CUDA-graph replay bitwise the eager chunks, the
    counters (1, 0), BatchNorm buffers included."""
    batches = [make_batch(n=16, seed=90 + i, nan=i == 9) for i in range(12)]
    out = {}
    for replay in (True, False):
        ddp = _toy_ddp(True, replay, hook, opt)
        sums = None
        for c in range(3):
            sums = ddp.train_step_many(batches[4 * c:4 * (c + 1)], sums)
        torch.cuda.synchronize()
        out[replay] = ({k: v.cpu() for k, v in snapshot(ddp).items()}, ddp.skip_counters(),
                       sums.cpu())
    assert_bitwise(out[True][0], out[False][0])
    assert out[True][1] == out[False][1] == (1, 0)
    torch.testing.assert_close(out[True][2], out[False][2], rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
def test_a_guarded_managed_flush_replay_is_bitwise_its_eager_queue_on_the_card(card):
    batches = [make_batch(seed=110 + i, nan=i == 13) for i in range(16)]
    out = {}
    for replay in (True, False):
        acc = Accelerator(seed=0, device="cuda", guard=True, fuse_steps=8, comm_hook="int8_ef")
        torch.manual_seed(0)
        module = ToyCNN(10, widths=(4,), input_shape=(8, 8, 3))
        model, opt = acc.prepare(module, optim.Adam(module.parameters(), lr=1e-2))
        opt._graph_replay = replay
        losses = [_managed_step(acc, model, opt, b) for b in batches]
        values = torch.stack([loss.device_value() for loss in losses]).cpu()
        out[replay] = ({k: v.cpu() for k, v in _managed_state(model, opt).items()},
                       opt.skip_counters(), values)
    assert_bitwise(out[True][0], out[False][0])
    assert out[True][1] == out[False][1] == (1, 0)
    torch.testing.assert_close(out[True][2], out[False][2], rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("value,pos", ALL_FINITE_CASES + [(None, 0)])
def test_all_finite_on_the_card_is_isfinite_all(card, value, pos):
    leaves = [torch.from_numpy(a).to(card) for a in _finiteness_leaves(value, pos)]
    got = guard_lib.all_finite(leaves)
    assert got.device.type == "cuda"
    assert bool(got) == all(bool(torch.isfinite(t).all()) for t in leaves) == (value is None)
