"""``configs/managed_fused.yaml``'s block (toy_cnn on digits, batch 32,
deferred metrics, ``fuse_steps: auto``) through the port's
``train_accelerate`` on the CPU (``tpuddp_torch/configs/managed_fused_h100.yaml``
with ``local.device: cpu``):

- the fused run (depth 32: each epoch one 32-step flush and a 13-step
  remainder) against the unfused one (depth 1) over the file's 6 epochs:
  bitwise, history rows and every checkpoint array;
- against the JAX package's fused run (its Accelerator at ``fuse_steps:
  auto`` and its ``train``/``evaluate`` with the FusedEvaluator) over 2
  epochs on 1 and 2 Gloo processes, from the JAX init;
- the fused run's ``state_5.npz`` crossing to the JAX package (its fused
  Accelerator loads it and saves it again) and back into the port, bitwise;
- a fused run of 5 epochs resumed for the 6th against the 6 straight.

Tolerances (PERF.md section 2): losses rtol 1e-4, parameters rtol 1e-4 /
atol 1e-5, test accuracy equal; the rest bitwise. The runs write
checkpoints every epoch (``checkpoint_epoch: 1``, where the file says 5) so
that epoch 5's state exists to resume from."""

import json
import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import train_accelerate as jax_entry
from tpuddp import config as jax_cfg
from tpuddp.accelerate import Accelerator as JaxAccelerator
from tpuddp.data import DataLoader as JaxDataLoader
from tpuddp.data import load_datasets_for as jax_datasets_for
from tpuddp.data import norm_stats_for as jax_norm_stats_for
from tpuddp.data import transforms as jax_tf
from tpuddp.models import load_model as jax_load_model
from tpuddp.nn import CrossEntropyLoss as JaxCrossEntropyLoss
from tpuddp.parallel import make_mesh

from tpuddp_torch import config as cfg
from tpuddp_torch.accelerate import Accelerator
from tpuddp_torch.models import load_model
from tpuddp_torch.models.convert import state_dict_from_jax
from tpuddp_torch.parallel.spawn import run_ddp_training
from tpuddp_torch.train_accelerate import basic_accelerate_training

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import _torch_port_entry_worker as entry_worker  # noqa: E402
from test_torch_port_optim_train import (  # noqa: E402
    SPAWN_TIMEOUT_S, _env, _np, assert_run_close, jax_init,
)

PORT_SETTINGS = os.path.join(ROOT, "tpuddp_torch", "configs", "managed_fused_h100.yaml")
JAX_SETTINGS = os.path.join(ROOT, "configs", "managed_fused.yaml")
TIMED = ("train_time_s", "epoch_time_s", "step_ms", "host_stall_s")


def _settings(path):
    with open(path) as f:
        return yaml.safe_load(f)


def _training(**overrides):
    """The port's merged training block, with ``overrides``."""
    return dict(cfg.training_config(_settings(PORT_SETTINGS)), **overrides)


def _run(save_dir, **overrides):
    """The port's entry-point worker at world 1 on the CPU."""
    return run_ddp_training(
        partial(basic_accelerate_training, training=_training(checkpoint_epoch=1, **overrides),
                device="cpu"),
        1, str(save_dir), {}, backend="cpu",
    )


def _arrays(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for the in-process runs, as the subprocess
    workers run (OMP_NUM_THREADS=2): the runs' small operations slow down
    many times over when every test worker's threads compete for the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """The fused block's 6 epochs (auto depth), checkpoints every epoch."""
    out = tmp_path_factory.mktemp("fused_straight")
    return _run(out), out


def test_the_settings_file_is_the_jax_packages_block():
    port, ref = _settings(PORT_SETTINGS), _settings(JAX_SETTINGS)
    assert port["training"] == ref["training"]
    assert port["local"]["device"] == "cuda"
    training = cfg.training_config(port)
    assert (training["fuse_steps"], training["deferred_metrics"]) == ("auto", True)
    assert cfg.resolve_fuse_steps(training["fuse_steps"], 1, True) == "auto"


def test_fused_run_is_bitwise_the_unfused_run(tmp_path, straight):
    history, out = straight
    unfused = _run(tmp_path, fuse_steps=1)
    assert [r["fuse_steps"] for r in history] == [32] * 6
    assert [r["fuse_steps"] for r in unfused] == [1] * 6
    for fused_row, row in zip(history, unfused):
        assert len(fused_row["step_ms"]) == len(row["step_ms"]) == 45
        for k in row:
            if k not in TIMED + ("fuse_steps",):
                assert fused_row[k] == row[k], k
    for epoch in range(6):
        a, b = _arrays(out / f"state_{epoch}.npz"), _arrays(tmp_path / f"state_{epoch}.npz")
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"state_{epoch} {k}")


def jax_fused_reference(training, params, mstate, devices):
    """The JAX package's fused managed run of ``training`` from
    ``params``/``mstate``: per epoch ``(train_loss, test_loss)`` and test
    accuracy, and the final state_dict."""
    mesh = make_mesh(devices)
    train, test = jax_datasets_for(training)
    mean, std = jax_norm_stats_for(training)
    augment = jax_tf.make_train_augment(size=None, flip=False, mean=mean, std=std)
    eval_transform = jax.jit(jax_tf.make_eval_transform(size=None, mean=mean, std=std))
    model = jax_load_model(training["model"], 10)
    model._tpuddp_initial_variables = (params, mstate)
    acc = JaxAccelerator(mesh=mesh, seed=0, fuse_steps="auto", augment=augment)
    jmodel, jopt, loader = acc.prepare(
        model, jax_cfg.optimizer_from(training),
        JaxDataLoader(train, training["train_batch_size"], shuffle=True))
    crit, losses, accuracies = JaxCrossEntropyLoss(), [], []
    for epoch in range(training["num_epochs"]):
        loader.set_epoch(epoch)
        train_loss = jax_entry.train(jmodel, loader, crit, jopt, acc, None)[0]
        test_loss, accuracy, _ = jax_entry.evaluate(
            jmodel, JaxDataLoader(test, training["test_batch_size"]), crit, acc.device,
            eval_transform, deferred=True)
        losses.append((train_loss, test_loss))
        accuracies.append(accuracy)
    assert jopt._fuse == 32
    sd = state_dict_from_jax(training["model"], _np(jmodel.params), _np(jmodel.model_state))
    return losses, accuracies, sd


@pytest.fixture(scope="module")
def init():
    return jax_init(_training())


def test_fused_run_matches_jax_world_1(cpu_devices, init):
    training = _training(num_epochs=2)
    history, final = entry_worker.run(0, 1, "managed", training, init[2])
    losses, accuracies, ref_sd = jax_fused_reference(training, init[0], init[1], cpu_devices[:1])
    assert_run_close(history, final, losses, ref_sd, "fused world 1")
    assert [r["test_accuracy"] for r in history] == accuracies
    assert [r["fuse_steps"] for r in history] == [32, 32]


def test_fused_run_matches_jax_world_2(tmp_path, cpu_devices, init):
    training = _training(num_epochs=2)
    np.savez(tmp_path / "fused_init.npz", **{k: v.numpy() for k, v in init[2].items()})
    (tmp_path / "run.json").write_text(json.dumps(
        [{"name": "fused", "path": "managed", "training": training}]))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_port_entry_worker.py"), str(tmp_path)],
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S, env=_env(),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(tmp_path / "fused_history.json") as f:
        history = json.load(f)
    finals = [dict(np.load(tmp_path / f"fused_{r}.npz")) for r in range(2)]
    for k in finals[0]:
        np.testing.assert_array_equal(finals[0][k], finals[1][k], err_msg=k)
    losses, accuracies, ref_sd = jax_fused_reference(training, init[0], init[1], cpu_devices[:2])
    assert_run_close(history, finals[0], losses, ref_sd, "fused world 2")
    assert [r["test_accuracy"] for r in history] == accuracies


def test_fused_state_crosses_to_the_jax_package_and_back(tmp_path, cpu_devices, straight):
    """The fused run's ``state_5.npz`` loads into the JAX package's fused
    Accelerator, which saves it again; every array the JAX file holds is the
    port's, and the port restores from the JAX file to the same state."""
    _, out = straight
    ours = _arrays(out / "state_5.npz")
    training = _training()
    jacc = JaxAccelerator(mesh=make_mesh(cpu_devices[:1]), seed=0, fuse_steps="auto")
    jmodel, jopt = jacc.prepare(jax_load_model("toy_cnn", 10), jax_cfg.optimizer_from(training))
    jmodel(jnp.zeros((1, 8, 8, 3)))
    assert jacc.load_state(jmodel, jopt, str(out)) == 6
    jacc.save_state(jmodel, jopt, str(tmp_path / "jax"), epoch=5)
    theirs = _arrays(tmp_path / "jax" / "state_5.npz")
    shared = [k for k in theirs if not k.startswith("__meta__")]
    assert {"['opt_state'].step", "['opt_state'].m[0]['weight']", "['bwd_counter']"} <= set(shared)
    for k in shared:
        np.testing.assert_array_equal(theirs[k], ours[k], err_msg=k)

    acc = Accelerator(seed=0, fuse_steps="auto", device="cpu")
    module = load_model("toy_cnn", 10, input_shape=(8, 8, 3))
    model, opt = acc.prepare(module, cfg.optimizer_from(training, module.parameters()))
    assert acc.load_state(model, opt, str(tmp_path / "jax")) == 6
    assert model._bwd_counter == 6 * 45
    acc.save_state(model, opt, str(tmp_path / "back"), epoch=5)
    back = _arrays(tmp_path / "back" / "state_5.npz")
    for k in shared:
        np.testing.assert_array_equal(back[k], ours[k], err_msg=k)


def test_resumed_fused_run_equals_the_straight_run(tmp_path, straight):
    history, out = straight
    _run(tmp_path, num_epochs=5)
    again = _run(tmp_path, resume=True)
    assert [r["epoch"] for r in again] == [5]
    for k in again[0]:
        if k not in TIMED:
            assert again[0][k] == history[5][k], k
    a, b = _arrays(out / "state_5.npz"), _arrays(tmp_path / "state_5.npz")
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
