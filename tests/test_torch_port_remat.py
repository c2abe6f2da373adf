"""Remat (``training.remat: true``, ``tpuddp_torch/nn/remat.py``) against the
plain step and against the JAX package's ``jax.checkpoint`` step, on the CPU:

- two Gloo processes, ToyCNN with ``sync_bn`` (the recompute all-reduces
  BatchNorm's statistics again on both ranks) and a padded final batch:
  every remat run bitwise its plain run, replicated, under ZeRO-1, with
  ``int8_ef``, per accumulation cycle and per chunk, BatchNorm buffers
  included (advanced once a step);
- the forward really runs twice, the buffers do not advance in the second;
- a remat run against the JAX package's remat run (ToyCNN, BatchNorm,
  padded rows), losses and parameters within the port's tolerances
  (``PERF.md`` section 2: rtol 1e-4 over 3 Adam steps);
- the managed path accepts the key and runs bitwise as without it (the JAX
  managed path never reads it);
- ``comm_overlap``: ``auto`` falls back to the barrier step with the JAX
  package's reason, ``true`` raises the JAX package's ``ValueError``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuddp import optim as jax_optim
from tpuddp.models import ToyCNN as JaxToyCNN
from tpuddp.nn import CrossEntropyLoss as JaxCrossEntropyLoss
from tpuddp.parallel import make_mesh
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP

from tpuddp_torch import config as cfg
from tpuddp_torch.models import ToyCNN
from tpuddp_torch.models.convert import state_dict_from_jax
from tpuddp_torch.nn import CrossEntropyLoss
from tpuddp_torch.nn import remat
from tpuddp_torch.nn.norm import BatchNorm, convert_sync_batchnorm
from tpuddp_torch.optim import Adam
from tpuddp_torch.parallel.ddp import DistributedDataParallel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import _torch_port_remat_worker as worker_cfg  # noqa: E402

LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-4, 1e-5

torch.set_num_threads(2)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------- 2-process Gloo --

@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("remat_gloo")
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    env.pop("TPUDDP_WORLD_SIZE", None)
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "tests", "_torch_port_remat_worker.py"),
                           str(workdir)], capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return workdir


@pytest.mark.parametrize("variant", list(worker_cfg.VARIANTS))
def test_two_process_remat_is_bitwise_plain(gloo_runs, variant):
    torch.manual_seed(0)
    init = {k: v.numpy() for k, v in ToyCNN(10, worker_cfg.WIDTHS,
                                             input_shape=worker_cfg.SHAPE).state_dict().items()}
    for rank in range(2):
        plain = np.load(gloo_runs / f"{variant}_plain_{rank}.npz")
        rematted = np.load(gloo_runs / f"{variant}_remat_{rank}.npz")
        assert plain.files == rematted.files
        for key in plain.files:
            np.testing.assert_array_equal(rematted[key], plain[key], err_msg=f"{variant} {key}")
        assert np.isfinite(plain["sums"]).all()
        for key, value in init.items():  # every BatchNorm buffer moved, once a step as plain
            if key.endswith(("running_mean", "running_var")):
                assert not np.array_equal(plain[f"buffer/{key}"], value), key
    zero, one = (np.load(gloo_runs / f"{variant}_remat_{r}.npz") for r in range(2))
    for key in zero.files:
        if key.startswith(("param/", "buffer/")):  # the replicas agree
            np.testing.assert_array_equal(zero[key], one[key], err_msg=key)


# --------------------------------------------------------------- in-process --

def test_remat_recomputes_the_forward_and_advances_buffers_once():
    torch.manual_seed(0)
    model = ToyCNN(10, worker_cfg.WIDTHS, input_shape=worker_cfg.SHAPE)
    calls = []
    model[0].register_forward_hook(lambda m, i, o: calls.append(1))
    x = torch.randn(4, *worker_cfg.SHAPE)
    w = torch.tensor([1.0, 1.0, 1.0, 0.0])
    bn = next(m for m in model.modules() if isinstance(m, BatchNorm))
    before = bn.running_mean.clone()
    out = remat.forward(model, x, w, remat=True)
    after_forward = bn.running_mean.clone()
    out.sum().backward()
    assert len(calls) == 2  # the forward, then the backward's recompute
    assert not torch.equal(after_forward, before)
    torch.testing.assert_close(bn.running_mean, after_forward, rtol=0, atol=0)
    assert not remat.recomputing() and all(m.sample_weight is None for m in model.modules()
                                          if isinstance(m, BatchNorm))


def test_remat_replays_dropout_draws_without_the_generator():
    """The recompute takes the forward's draws, so the gradient is the plain
    one and the generator advances once, as in the plain step."""
    def step(use_remat):
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(6, 32), torch.nn.ReLU(), torch.nn.Dropout(0.3),
                                    torch.nn.Linear(32, 3))
        x = torch.randn(5, 6)
        out = remat.forward(model, x, None, remat=use_remat)
        out.square().sum().backward()
        return [p.grad.clone() for p in model.parameters()], torch.rand(3)

    (plain, after_plain), (rematted, after_remat) = step(False), step(True)
    for a, b in zip(plain, rematted):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(after_plain, after_remat, rtol=0, atol=0)


def test_remat_run_matches_the_jax_remat_run(cpu_devices):
    """ToyCNN (BatchNorm over the real rows only) on one device: 3 steps of
    the port's remat DDP against the JAX package's (``remat=True``)."""
    jax_model = JaxToyCNN(num_classes=10, widths=worker_cfg.WIDTHS)
    params, mstate = jax_model.init(jax.random.key(7), jnp.zeros((1, *worker_cfg.SHAPE)))
    sd = state_dict_from_jax("toy_cnn", _np_tree(params), _np_tree(mstate))
    jax_ddp = JaxDDP(jax_model, jax_optim.Adam(1e-2), JaxCrossEntropyLoss(),
                     mesh=make_mesh(cpu_devices[:1]), remat=True)
    state = jax_ddp.init_state(jax.random.key(0), jnp.zeros((1, *worker_cfg.SHAPE)),
                               params=params, model_state=mstate)
    model = ToyCNN(10, worker_cfg.WIDTHS, input_shape=worker_cfg.SHAPE)
    model.load_state_dict(sd)
    ddp = DistributedDataParallel(model, Adam(model.parameters(), lr=1e-2), CrossEntropyLoss(),
                                  device="cpu", remat=True)
    for batch in worker_cfg.batches(0)[1:]:  # the last one padded
        state, metrics = jax_ddp.train_step(state, jax_ddp.shard(batch))
        ours = ddp.train_step(batch)
        np.testing.assert_allclose(ours.numpy(), [float(np.asarray(metrics["loss_sum"])[0]),
                                                  float(np.asarray(metrics["n"])[0])], rtol=LOSS_RTOL)
    ref = state_dict_from_jax("toy_cnn", _np_tree(state.params), _np_tree(state.model_state))
    for name, value in model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), ref[name].numpy(), rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=name)


def test_managed_path_runs_bitwise_with_and_without_remat():
    from tpuddp_torch.train_accelerate import build_training, run_training_loop

    def run(flag):
        training = cfg.training_config({"training": {
            "model": "toy_cnn", "data_root": "/nonexistent", "synthetic_n": [48, 16],
            "train_batch_size": 8, "test_batch_size": 8, "num_epochs": 1, "image_size": None,
            "seed": 0, "remat": flag, "prefetch": False}})
        acc, model, opt, train_loader, test_loader, criterion, transform = build_training(training, "cpu")
        history = run_training_loop(model, train_loader, test_loader, criterion, opt, None, acc,
                                    transform, num_epochs=1)
        return history[0], {k: v.clone() for k, v in model.module.state_dict().items()}

    (row_plain, plain), (row_remat, rematted) = run(False), run(True)
    for key in ("train_loss", "test_loss", "test_accuracy"):
        assert row_plain[key] == row_remat[key]
    for key, value in plain.items():
        torch.testing.assert_close(rematted[key], value, rtol=0, atol=0)


def _jax_overlap(cpu_devices, overlap):
    jax_model = JaxToyCNN(num_classes=10, widths=worker_cfg.WIDTHS)
    jax_ddp = JaxDDP(jax_model, jax_optim.Adam(1e-2), JaxCrossEntropyLoss(),
                     mesh=make_mesh(cpu_devices[:1]), remat=True, comm_overlap=overlap)
    jax_ddp.init_state(jax.random.key(0), jnp.zeros((1, *worker_cfg.SHAPE)))
    return jax_ddp


def _overlap(overlap):
    torch.manual_seed(0)
    model = convert_sync_batchnorm(ToyCNN(10, worker_cfg.WIDTHS, input_shape=worker_cfg.SHAPE))
    return DistributedDataParallel(model, Adam(model.parameters()), CrossEntropyLoss(), device="cpu",
                                   remat=True, comm_overlap=overlap)


def test_comm_overlap_under_remat_is_the_jax_fallback_and_refusal(cpu_devices):
    meta = _overlap("auto").comm_overlap_meta
    assert meta == dict(_jax_overlap(cpu_devices, "auto").comm_overlap_meta)
    assert meta["enabled"] is False and meta["reason"].startswith("remat wraps the whole forward")
    with pytest.raises(ValueError) as jax_err:
        _jax_overlap(cpu_devices, True)
    with pytest.raises(ValueError) as ours:
        _overlap(True)
    assert str(ours.value) == str(jax_err.value)
