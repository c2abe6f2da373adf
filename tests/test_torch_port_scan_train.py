"""Native training at ``scan_steps: 4`` in the port against the JAX native
loop at ``scan_steps: 4``, on the CPU, in one process against a 1-device
mesh: toy_cnn with sync_bn on 90 rows in batches of 7 (13 batches: 3 chunks
of 4 and a single step; 5 test batches: 1 group and a single step), and at
A = 2 (3 chunks of two cycles and a tail padded to one cycle), 2 epochs.
The 2-process run is tests/test_torch_port_scan_gloo.py.

Tolerances: epoch losses rtol 1e-4; final parameters and buffers rtol 1e-4
/ atol 1e-6, those of tests/test_torch_port_train.py (float32 convolutions
and sums in another order, over 2 epochs of Adam); samples and the
micro-batch count exact."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuddp import nn as jax_nn
from tpuddp import optim as jax_optim
from tpuddp.data import ShardedDataLoader as JaxLoader
from tpuddp.data.synthetic import SyntheticClassification as JaxSynthetic
from tpuddp.models import ToyCNN as JaxToyCNN
from tpuddp.nn import CrossEntropyLoss as JaxCrossEntropyLoss
from tpuddp.parallel import make_mesh
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP
from tpuddp.training.loop import run_training_loop as jax_run_training_loop

from tpuddp_torch.models.convert import state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import _torch_port_scan_worker as worker_cfg  # noqa: E402

LOSS_RTOL = 1e-4
P_RTOL, P_ATOL = 1e-4, 1e-6


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def init():
    """The JAX toy_cnn init, as ``(params, model_state, state_dict)``."""
    params, mstate = JaxToyCNN(num_classes=10, widths=worker_cfg.WIDTHS).init(
        jax.random.key(11), jnp.zeros((1, *worker_cfg.SHAPE)))
    return params, mstate, state_dict_from_jax("toy_cnn", _np_tree(params), _np_tree(mstate))


def jax_scan_run(init, devices, accum):
    """The JAX native loop at ``scan_steps: 4`` on a mesh of ``devices``:
    ``(history, final state_dict, step)``."""
    params, mstate, _ = init
    mesh = make_mesh(devices)
    model = jax_nn.convert_sync_batchnorm(JaxToyCNN(num_classes=10, widths=worker_cfg.WIDTHS))
    ddp = JaxDDP(model, jax_optim.Adam(worker_cfg.LR), JaxCrossEntropyLoss(), mesh=mesh,
                 grad_accumulation=accum)
    state = ddp.init_state(jax.random.key(0), jnp.zeros((1, *worker_cfg.SHAPE)),
                           params=params, model_state=mstate)
    train, test = JaxSynthetic(n=worker_cfg.DATA_N, shape=worker_cfg.SHAPE,
                               seed=worker_cfg.DATA_SEED).split(worker_cfg.DATA_TEST)
    state, history = jax_run_training_loop(
        ddp, state, JaxLoader(train, worker_cfg.BATCH, mesh, shuffle=True),
        JaxLoader(test, worker_cfg.BATCH, mesh, shuffle=True), save_dir=None,
        num_epochs=worker_cfg.EPOCHS, scan_steps=worker_cfg.SCAN, log=lambda *_: None,
    )
    final = state_dict_from_jax("toy_cnn", _np_tree(state.params), _np_tree(state.model_state))
    return history, final, int(state.step)


def assert_matches_jax(history, final, step, ref):
    ref_history, ref_final, ref_step = ref
    assert len(history) == len(ref_history) == worker_cfg.EPOCHS
    for ours, theirs in zip(history, ref_history):
        assert ours["train_samples"] == theirs["train_samples"]
        assert ours["test_samples"] == theirs["test_samples"]
        for key in ("train_loss", "test_loss"):
            np.testing.assert_allclose(ours[key], theirs[key], rtol=LOSS_RTOL, err_msg=key)
    assert sorted(final) == sorted(ref_final)
    for k in ref_final:
        np.testing.assert_allclose(np.asarray(final[k]), ref_final[k].numpy(), rtol=P_RTOL,
                                   atol=P_ATOL, err_msg=k)
    assert step == ref_step


@pytest.mark.parametrize("accum", [1, 2], ids=["A1", "A2_padded_tail"])
def test_scan_steps_4_matches_the_jax_native_loop_world_1(cpu_devices, init, accum):
    torch.set_num_threads(2)
    history, ddp = worker_cfg.train(0, 1, init[2], accum)
    assert [r["scan_steps"] for r in history] == [4, 4]
    assert all(len(r["step_ms"]) == -(-13 // accum) for r in history)
    assert_matches_jax(history, ddp.model.state_dict(), ddp.step,
                       jax_scan_run(init, cpu_devices[:1], accum))
    assert ddp.step == 2 * (13 + accum - 1)
