"""Gradient accumulation in the port, on the CPU, each path against its own
JAX counterpart (the two rules differ on purpose):

- native (``DistributedDataParallel(grad_accumulation=A)``): the n-weighted
  cycle mean, one all-reduce and one update per cycle, the epoch's ragged
  tail padded with all-padding micro-batches; against the JAX package's
  ``DistributedDataParallel(grad_accumulation=A)`` through both epoch
  loops, at world 1 (in-process, 1-device mesh) and world 2 (two Gloo
  processes, 2-device mesh);
- managed (``Accelerator(gradient_accumulation_steps=A)``): the unweighted
  mean of the micro-batches' global-mean gradients, a partial cycle flushed
  at epoch end; against the JAX ``Accelerator`` step by step and through
  both entry points' ``train``/``evaluate``.

Each also equals one step on the concatenated micro-batches where its rule
says it must (equal micro-batches for the managed rule, any for the native
one), checked with SGD, whose update is linear in the gradient.
Tolerances, float32: params rtol 1e-4 / atol 1e-5, losses rtol 1e-4.
"""

import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train_accelerate as jax_entry
from tpuddp import optim as jax_optim
from tpuddp.accelerate import Accelerator as JaxAccelerator
from tpuddp.data import DataLoader as JaxDataLoader
from tpuddp.data import ShardedDataLoader as JaxLoader
from tpuddp.data.synthetic import SyntheticClassification as JaxSynthetic
from tpuddp.data.transforms import make_eval_transform as jax_eval_transform
from tpuddp.data.transforms import make_train_augment as jax_train_augment
from tpuddp.nn import CrossEntropyLoss as JaxCrossEntropyLoss
from tpuddp.parallel import make_mesh
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP
from tpuddp.training.loop import run_training_loop as jax_run_training_loop

from tpuddp_torch import train_accelerate as port_entry
from tpuddp_torch import train_native
from tpuddp_torch.accelerate import Accelerator
from tpuddp_torch.data import DataLoader, ShardedDataLoader
from tpuddp_torch.data.synthetic import SyntheticClassification
from tpuddp_torch.data.transforms import make_eval_transform, make_train_augment
from tpuddp_torch.nn import CrossEntropyLoss
from tpuddp_torch.optim import Adam
from tpuddp_torch.parallel.ddp import DistributedDataParallel
from tpuddp_torch.training.loop import run_training_loop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import _torch_port_accel_worker as worker_cfg  # noqa: E402
from test_torch_port_accelerate import (  # noqa: E402
    LOSS_RTOL, MODELS, SPAWN_TIMEOUT_S, _env, assert_state_close, jax_managed, jax_model,
    make_batches, port_managed, port_model, to_state_dict,
)
from test_torch_port_accelerate import inits  # noqa: E402,F401  (module fixture)

ACCUM = 2


def _datasets(jax_side: bool):
    cls = JaxSynthetic if jax_side else SyntheticClassification
    return cls(n=worker_cfg.DATA_N, shape=worker_cfg.SHAPE, seed=worker_cfg.DATA_SEED).split(
        worker_cfg.DATA_TEST)


def jax_native(name, inits, devices):
    """The JAX package's native run of the worker's schedule: history and
    final state_dict."""
    params, mstate, _ = inits[name]
    mesh = make_mesh(devices)
    ddp = JaxDDP(jax_model(name), jax_optim.Adam(worker_cfg.LR), JaxCrossEntropyLoss(),
                 mesh=mesh, grad_accumulation=ACCUM)
    state = ddp.init_state(jax.random.key(0), jnp.zeros((1, *worker_cfg.SHAPE)),
                           params=params, model_state=mstate)
    train, test = _datasets(jax_side=True)
    state, history = jax_run_training_loop(
        ddp, state, JaxLoader(train, worker_cfg.BATCH, mesh, shuffle=True),
        JaxLoader(test, worker_cfg.BATCH, mesh, shuffle=True),
        save_dir=None, num_epochs=worker_cfg.EPOCHS, log=lambda *_: None,
    )
    return history, to_state_dict(name, state.params, state.model_state)


def assert_history_close(history, ref_history):
    assert len(history) == len(ref_history) == worker_cfg.EPOCHS
    for ours, ref in zip(history, ref_history):
        assert ours["train_samples"] == ref["train_samples"] == worker_cfg.DATA_N - worker_cfg.DATA_TEST
        for key in ("train_loss", "test_loss"):
            np.testing.assert_allclose(ours[key], ref[key], rtol=LOSS_RTOL, err_msg=key)


# ---------------------------------------------------------------- native --

@pytest.mark.parametrize("name", MODELS)
def test_native_cycle_matches_jax_world_1(cpu_devices, inits, name):
    """90 rows in batches of 7: 13 micro-batches (the last ragged), so each
    epoch ends with a cycle padded by an all-padding micro-batch; 7 updates
    per epoch."""
    ref_history, ref_final = jax_native(name, inits, cpu_devices[:1])
    module = port_model(name)
    module.load_state_dict(inits[name][2])
    ddp = DistributedDataParallel(module, Adam(module.parameters(), lr=worker_cfg.LR),
                                  CrossEntropyLoss(), device="cpu", grad_accumulation=ACCUM)
    train, test = _datasets(jax_side=False)
    history = run_training_loop(
        ddp, ShardedDataLoader(train, worker_cfg.BATCH, 0, 1, shuffle=True),
        ShardedDataLoader(test, worker_cfg.BATCH, 0, 1, shuffle=True),
        save_dir=None, num_epochs=worker_cfg.EPOCHS, log=lambda *_: None,
    )
    assert_history_close(history, ref_history)
    for row in history:
        assert row["grad_accumulation"] == ACCUM and len(row["step_ms"]) == math.ceil(13 / ACCUM)
    assert_state_close(ddp.model.state_dict(), ref_final, "final")


def test_native_cycle_matches_jax_world_2(tmp_path, cpu_devices, inits):
    """Two Gloo processes, 45 rows each in batches of 7: 7 micro-batches,
    the last cycle padded; both models in one launch."""
    runs = []
    for name in MODELS:
        np.savez(tmp_path / f"{name}_init.npz", **{k: v.numpy() for k, v in inits[name][2].items()})
        runs.append({"name": name, "mode": "native_accum", "model": name, "accum": ACCUM})
    (tmp_path / "run.json").write_text(json.dumps(runs))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_port_accel_worker.py"), str(tmp_path)],
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S, env=_env(),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    for name in MODELS:
        ref_history, ref_final = jax_native(name, inits, cpu_devices[:2])
        with open(tmp_path / f"{name}_history.json") as f:
            history = json.load(f)
        assert_history_close(history, ref_history)
        assert all(len(r["step_ms"]) == math.ceil(7 / ACCUM) for r in history)
        finals = [np.load(tmp_path / f"{name}_{r}.npz") for r in range(2)]
        for k in finals[0].files:
            np.testing.assert_array_equal(finals[0][k], finals[1][k])
        assert_state_close(dict(finals[0]), ref_final, name)


def _sgd_ddp(sd, accum):
    module = port_model("toy_mlp")
    module.load_state_dict(sd)
    return DistributedDataParallel(module, torch.optim.SGD(module.parameters(), lr=1.0),
                                   CrossEntropyLoss(), device="cpu", grad_accumulation=accum)


def test_native_cycle_equals_one_step_on_the_concatenation(inits):
    """Micro-batches of 8 and 2 real rows (ragged, the n-weighted rule):
    one cycle == one step on the 10 rows, and the cycle's sums are the
    concatenation's."""
    sd = inits["toy_mlp"][2]
    x, y, w = make_batches(11)[0]
    a, b = (x[:8], y[:8], w[:8]), (x[8:], y[8:], w[8:])
    ddp = _sgd_ddp(sd, ACCUM)
    sums = ddp.train_cycle([a, b])
    big = _sgd_ddp(sd, 1)
    big_sums = big.train_step((x, y, w))
    assert_state_close(ddp.model.state_dict(), big.model.state_dict())
    np.testing.assert_allclose(sums.numpy(), big_sums.numpy(), rtol=1e-5)
    assert float(sums[1]) == 10.0


def test_all_padding_micro_batches_add_nothing(inits):
    sd = inits["toy_mlp"][2]
    x, y, w = make_batches(12, real_rows=((8, 8),))[0]
    ddp = _sgd_ddp(sd, 3)
    pad = (x, y, np.zeros_like(w))
    sums = ddp.train_cycle([(x, y, w), pad, pad])
    one = _sgd_ddp(sd, 1)
    one_sums = one.train_step((x, y, w))
    assert_state_close(ddp.model.state_dict(), one.model.state_dict())
    assert torch.equal(sums, one_sums)
    every = _sgd_ddp(sd, 2)  # a cycle of nothing but padding leaves the model as it was
    every.train_cycle([pad, pad])
    assert_state_close(every.model.state_dict(), sd)


def test_native_refuses_per_batch_steps_and_partial_cycles():
    ddp = _sgd_ddp(port_model("toy_mlp").state_dict(), ACCUM)
    batch = make_batches(13)[0]
    with pytest.raises(RuntimeError, match="grad_accumulation"):
        ddp.train_step(batch)
    with pytest.raises(ValueError, match="takes 2 micro-batches"):
        ddp.train_cycle([batch])
    with pytest.raises(ValueError, match=">= 1"):
        _sgd_ddp(port_model("toy_mlp").state_dict(), 0)


def test_native_entry_point_wires_the_knob():
    training = dict(port_entry.cfg_lib.TRAINING_DEFAULTS, model="toy_mlp", image_size=None,
                    synthetic_n=(40, 10), seed=0, gradient_accumulation_steps=4)
    ddp, train_loader, _, _ = train_native.build_training(0, 1, training, device="cpu")
    assert ddp.grad_accumulation == 4
    with pytest.raises(RuntimeError, match="grad_accumulation"):
        ddp.train_step(next(iter(train_loader)))


# --------------------------------------------------------------- managed --

@pytest.mark.parametrize("name", MODELS)
def test_managed_accumulation_matches_jax_with_a_partial_cycle(cpu_devices, inits, name):
    """A=2 over 3 micro-batches: one update after the second, the third a
    partial cycle that ``flush_accumulation`` applies with scale 1/1."""
    batches = make_batches(14)
    ref_losses, ref_states, ref_final = jax_managed(name, inits, cpu_devices[:1], batches, ACCUM)
    losses, states, final = port_managed(name, inits[name][2], batches, ACCUM)
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)
    for i, (got, ref) in enumerate(zip(states, ref_states)):
        assert_state_close(got, ref, f"step {i}")
    assert_state_close(final, ref_final, "final")
    # the first micro-batch of each cycle leaves the parameters as they were
    init = inits[name][2]
    assert all(torch.equal(states[0][k], init[k]) for k, _ in port_model(name).named_parameters())


def test_managed_accumulation_equals_one_step_on_equal_micro_batches(inits):
    """Four equal micro-batches of 4 (the unweighted rule is the big batch's
    mean when the micro-batches hold as many rows) == one step on all 16
    (``tests/test_accelerate.py:474``); a fifth opens a cycle that leaves the
    parameters alone."""
    sd = inits["toy_mlp"][2]
    x, y, w = make_batches(15, real_rows=((8, 8),))[0]

    def prepared(accum):
        acc = Accelerator(seed=0, gradient_accumulation_steps=accum, device="cpu")
        module = port_model("toy_mlp")
        module.load_state_dict(sd)
        return (acc, *acc.prepare(module, torch.optim.SGD(module.parameters(), lr=1.0)))

    acc_a, m_a, o_a = prepared(4)
    for i in range(4):
        sl = slice(4 * i, 4 * (i + 1))
        acc_a.backward(CrossEntropyLoss()(m_a(x[sl]), y[sl], w[sl]))
        o_a.step()
        o_a.zero_grad()  # safe every batch: it must not clear the cycle's sum
    acc_b, m_b, o_b = prepared(1)
    acc_b.backward(CrossEntropyLoss()(m_b(x), y, w))
    o_b.step()
    assert_state_close(m_a.module.state_dict(), m_b.module.state_dict())
    before = {k: v.clone() for k, v in m_a.module.state_dict().items()}
    acc_a.backward(CrossEntropyLoss()(m_a(x[:4]), y[:4], w[:4]))
    o_a.step()
    assert o_a._accum_count == 1 and o_a.updates == 1
    assert all(torch.equal(v, m_a.module.state_dict()[k]) for k, v in before.items())


def test_managed_and_native_rules_differ_on_ragged_micro_batches(inits):
    """The managed cycle averages the micro-batches' means unweighted, the
    native one weights them by their rows: on micro-batches of 8 and 2 real
    rows they give different updates (each rule is held to its JAX
    counterpart above)."""
    sd = inits["toy_mlp"][2]
    x, y, w = make_batches(16)[0]
    native = _sgd_ddp(sd, ACCUM)
    native.train_cycle([(x[:8], y[:8], w[:8]), (x[8:], y[8:], w[8:])])
    acc = Accelerator(seed=0, gradient_accumulation_steps=ACCUM, device="cpu")
    module = port_model("toy_mlp")
    module.load_state_dict(sd)
    model, opt = acc.prepare(module, torch.optim.SGD(module.parameters(), lr=1.0))
    for sl in (slice(0, 8), slice(8, 16)):
        acc.backward(CrossEntropyLoss()(model(x[sl]), y[sl], w[sl]))
        opt.step()
    gap = max(float((a - b).abs().max()) for a, b in
              zip(model.module.state_dict().values(), native.model.state_dict().values()))
    assert gap > 1e-3, gap


@pytest.mark.parametrize("deferred", [False, True], ids=["per_batch_reads", "deferred"])
def test_managed_entry_epoch_matches_jax(cpu_devices, inits, deferred):
    """One epoch through each entry point's ``train`` and ``evaluate`` at
    world 1, A=2 over 5 batches (the last cycle partial, flushed at epoch
    end), on uint8 images through the train augment (no flip) and the eval
    transform: the train loss (per-step global losses over the batch count),
    the rows seen, and the test loss and accuracy of the unprepared test
    loader (quirk Q3)."""
    name = "toy_cnn"
    params, mstate, sd = inits[name]
    train_j, test_j = _datasets(jax_side=True)
    train_t, test_t = _datasets(jax_side=False)
    kw = dict(size=None, flip=False)

    module = jax_model(name)
    module._tpuddp_initial_variables = (params, mstate)
    acc = JaxAccelerator(mesh=make_mesh(cpu_devices[:1]), seed=0, gradient_accumulation_steps=ACCUM,
                         augment=jax_train_augment(**kw))
    model, opt, loader = acc.prepare(module, jax_optim.Adam(worker_cfg.LR),
                                     JaxDataLoader(train_j, 20, shuffle=True))
    crit = JaxCrossEntropyLoss()
    ref_train = jax_entry.train(model, loader, crit, opt, acc, None)
    ref_eval = jax_entry.evaluate(model, JaxDataLoader(test_j, 8), crit, acc.device,
                                  jax.jit(jax_eval_transform(size=None)), deferred=deferred)

    acc_t = Accelerator(seed=0, gradient_accumulation_steps=ACCUM, device="cpu")
    acc_t.augment = make_train_augment(generator=acc_t.generator, **kw)
    module_t = port_model(name)
    module_t.load_state_dict(sd)
    model_t, opt_t, loader_t = acc_t.prepare(module_t, Adam(module_t.parameters(), lr=worker_cfg.LR),
                                             DataLoader(train_t, 20, shuffle=True))
    got_train = port_entry.train(model_t, loader_t, CrossEntropyLoss(), opt_t, acc_t)
    got_eval = port_entry.evaluate(model_t, DataLoader(test_t, 8), CrossEntropyLoss(),
                                   make_eval_transform(size=None), deferred=deferred)
    assert len(loader_t) == 5 and opt_t.updates == 3
    np.testing.assert_allclose(got_train[0], ref_train[0], rtol=LOSS_RTOL)
    assert got_train[1] == ref_train[1] == 90
    np.testing.assert_allclose(got_eval[0], ref_eval[0], rtol=LOSS_RTOL)
    assert got_eval[1:] == pytest.approx(ref_eval[1:]) and got_eval[2] == 30
    assert_state_close(model_t.module.state_dict(), to_state_dict(name, model.params, model.model_state))
