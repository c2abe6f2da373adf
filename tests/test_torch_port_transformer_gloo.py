"""A token job on two Gloo processes against the JAX package's wrap on a
2-device mesh.

``transformer_tiny`` at V 64, T 32, global batch 8 (4 rows a rank, the
contiguous blocks the JAX wrap's ``shard`` places on each replica), one
epoch of 3 steps and 2 eval batches, through the port's native entry point
(``train_native.build_training`` with the token loaders, the epoch loop,
``run_ddp_training`` at world 2) with ``comm_hook: bf16_ef``: each
gradient exchanged in the JAX package's flat order (the transformer's
dict-tree leaf order, through ``JaxFlatOrder``), rounded to bf16 per
bucket, the rest kept in the error-feedback residual. The reference is the
JAX ``DistributedDataParallel`` with the same hook on a 2-device mesh and
its ``run_training_loop`` on ``tools/bench_mesh.py``'s ``TokenLMLoader``,
from the same JAX init.

Both replicas end bitwise equal. Tolerance: the epoch losses and the final
parameters rtol 1e-4 / atol 1e-5, or, where the JAX package's own run from
an init one ulp higher moves by more than that (a bf16 rounding flipped by
float32 noise; the key projection's bias, whose exact gradient is 0),
within 4 times that move (the rule of tests/test_torch_port_comm_gloo.py).
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpuddp import optim as jax_optim
from tpuddp.models import load_model as jax_load_model
from tpuddp.nn import CrossEntropyLoss as JaxCrossEntropyLoss
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP
from tpuddp.parallel import make_mesh
from tpuddp.training.loop import run_training_loop as jax_run_training_loop

from tpuddp_torch import config as cfg
from tpuddp_torch.models.convert import state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from bench_mesh import TokenLMLoader as JaxTokenLMLoader  # noqa: E402

SPAWN_TIMEOUT_S = 300
NAME, V, T, B, STEPS, TEST_BATCHES, HOOK = "transformer_tiny", 64, 32, 8, 3, 2, "bf16_ef"
RTOL, ATOL, SPREAD, LR = 1e-4, 1e-5, 4.0, 1e-3
TRAINING = dict(cfg.TRAINING_DEFAULTS, model=NAME, num_classes=V, learning_rate=LR, seed=0,
                num_epochs=1, checkpoint_epoch=1, scan_steps=1, comm_hook=HOOK,
                dataset="synthetic_tokens")
LOADERS = dict(vocab=V, seq_len=T, global_batch=B, n_batches=STEPS, test_batches=TEST_BATCHES)


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    env.pop("TPUDDP_WORLD_SIZE", None)
    return env


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def init():
    params, _ = jax_load_model(NAME, num_classes=V).init(jax.random.key(3),
                                                         jnp.zeros((1, T), jnp.int32))
    return _np(params)


def _jax_reference(params, devices):
    """The JAX wrap's epoch on 2 devices: ``((train_loss, test_loss), the
    final parameters in the port's layout)``."""
    ddp = JaxDDP(jax_load_model(NAME, num_classes=V), jax_optim.Adam(LR), JaxCrossEntropyLoss(),
                 mesh=make_mesh(devices), comm_hook=HOOK)
    state = ddp.init_state(jax.random.key(0), jnp.zeros((1, T), jnp.int32), params=params,
                           model_state=())
    state, history = jax_run_training_loop(
        ddp, state, JaxTokenLMLoader(V, T, B, STEPS, seed=0),
        JaxTokenLMLoader(V, T, B, TEST_BATCHES, seed=1), None, num_epochs=1, scan_steps=1,
        log=lambda *a, **k: None)
    losses = np.array([(r["train_loss"], r["test_loss"]) for r in history])
    return losses, {k: v.numpy() for k, v in state_dict_from_jax(NAME, _np(state.params)).items()}


def _within(got, ref, spread, err_msg):
    got, ref, spread = (np.asarray(a, np.float64) for a in (got, ref, spread))
    err = np.abs(got - ref)
    if np.all(err <= ATOL + RTOL * np.abs(ref)):
        return
    assert np.any(spread > ATOL + RTOL * np.abs(ref)), (err_msg, float(err.max()))
    assert err.max() <= SPREAD * spread.max(), (err_msg, float(err.max()), float(spread.max()))


@pytest.fixture(scope="module")
def world2(tmp_path_factory, init):
    work = tmp_path_factory.mktemp("token_world2")
    np.savez(work / "init.npz", **{k: v.numpy() for k, v in state_dict_from_jax(NAME, init).items()})
    (work / "job.json").write_text(json.dumps({"training": TRAINING, "loaders": LOADERS}))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_port_token_worker.py"), str(work)],
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S, env=_env(),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    yield work
    shutil.rmtree(work)


def test_two_processes_match_the_jax_mesh(cpu_devices, init, world2):
    devices = cpu_devices[:2]
    ref_losses, ref = _jax_reference(init, devices)
    up_losses, up = _jax_reference(
        jax.tree_util.tree_map(lambda p: np.nextafter(p, np.inf).astype(p.dtype), init), devices)
    with open(world2 / "history.json") as f:
        history = json.load(f)
    assert [(r["train_samples"], r["test_samples"]) for r in history] == [
        (STEPS * B * T, TEST_BATCHES * B * T)]
    got = np.array([(r["train_loss"], r["test_loss"]) for r in history])
    _within(got, ref_losses, np.abs(up_losses - ref_losses), "losses")
    final = [np.load(world2 / f"final_{r}.npz") for r in range(2)]
    assert sorted(final[0].files) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(final[0][k], final[1][k])  # the replicas agree
        _within(final[0][k], ref[k], np.abs(up[k] - ref[k]), k)
    residuals = [np.load(world2 / f"residual_{r}.npz")["vec"] for r in range(2)]
    assert all(np.isfinite(r).all() and np.any(r != 0) for r in residuals)
    assert not np.array_equal(residuals[0], residuals[1])  # each replica's own
