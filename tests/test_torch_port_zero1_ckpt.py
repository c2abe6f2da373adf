"""ZeRO-1 checkpoints (``data_flat`` leaves) between the port and the JAX
package, on the CPU: configs/digits_tpu.yaml's block with an 11-class head
(22,315 parameters: the flat vector is padded to 22,316 at world 2 and not
at world 1), native files with float32 moments and managed files with bf16
ones.

- The port's files, written on two Gloo processes, restore into the JAX
  package at world 2 and, re-padded, at world 1: each flat moment vector
  is the port's gathered shards in the JAX order; the JAX package's
  ``run_training_loop`` (and its ``Accelerator.load_state``) then resume
  them.
- The JAX package's files, written on a 2-device mesh, restore into the
  port at world 2 (each rank's shard) and, re-padded, at world 1.
- A resumed port run (epoch 0, then ``resume: true`` for epoch 1) equals the
  straight run on both paths.
- Per-parameter moments and flat ones do not cross: a ``KeyError`` names
  the missing leaf, in both packages alike.

Tolerance: bitwise throughout (the layouts only move elements)."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import train_accelerate as jax_entry
from tpuddp import config as jax_cfg
from tpuddp.accelerate import Accelerator as JaxAccelerator
from tpuddp.data import DataLoader as JaxDataLoader
from tpuddp.data import ShardedDataLoader as JaxLoader
from tpuddp.nn import CrossEntropyLoss as JaxCrossEntropyLoss
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP
from tpuddp.training import checkpoint as jax_ckpt
from tpuddp.training.loop import run_training_loop as jax_run_training_loop

from tpuddp_torch import config as cfg
from tpuddp_torch import train_accelerate, train_native
from tpuddp_torch.models import load_model
from tpuddp_torch.models.convert import flat_from_jax, flat_to_jax
from tpuddp_torch.training import checkpoint as ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from test_torch_port_optim_train import _env, _np  # noqa: E402
from test_torch_port_zero1_gloo import BASE, _pieces, jax_init  # noqa: E402

SPAWN_TIMEOUT_S = 400
RAW = 22_315
NATIVE = dict(BASE, num_classes=11, learning_rate=1e-3, num_epochs=2, checkpoint_epoch=1)
MANAGED = dict(NATIVE, optimizer_state_dtype="bfloat16")
TRAININGS = {"native": NATIVE, "managed": MANAGED}
PREFIX = {"native": "ckpt", "managed": "state"}
FIELD = {"native": ".opt_state", "managed": "['opt_state']"}
KEYS = {"m": "exp_avg", "v": "exp_avg_sq"}


def _arrays(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _port_model():
    return load_model("toy_cnn", 11, input_shape=(8, 8, 3))


def _jax_like(path, training, devices):
    """A JAX ZeRO-1 template (native TrainState, or the managed
    Accelerator's objects) on a mesh of ``devices``."""
    mesh, _, _, augment, eval_transform, model, opt = _pieces(training, devices)
    if path == "native":
        ddp = JaxDDP(model, opt, JaxCrossEntropyLoss(), mesh=mesh, augment=augment,
                     eval_transform=eval_transform, weight_update_sharding=True)
        return ddp, ddp.init_state(jax.random.key(0), jnp.zeros((1, 8, 8, 3)))
    acc = JaxAccelerator(mesh=mesh, seed=0, augment=augment, weight_update_sharding=True)
    jmodel, jopt = acc.prepare(model, opt)
    jmodel(jnp.zeros((1, 8, 8, 3)))
    return acc, (jmodel, jopt)


def _jax_writes(path, directory, devices, init):
    """One epoch of the JAX package's ZeRO-1 run from ``init`` with a
    checkpoint of it in ``directory``."""
    training = dict(TRAININGS[path], num_epochs=1)
    params, mstate, _ = init
    mesh, train, test, augment, eval_transform, model, opt = _pieces(training, devices)
    if path == "native":
        ddp = JaxDDP(model, opt, JaxCrossEntropyLoss(), mesh=mesh, augment=augment,
                     eval_transform=eval_transform, weight_update_sharding=True)
        state = ddp.init_state(jax.random.key(0), jnp.zeros((1, 8, 8, 3)), params=params,
                               model_state=mstate)
        jax_run_training_loop(ddp, state, JaxLoader(train, 32, mesh, shuffle=True),
                              JaxLoader(test, 45, mesh, shuffle=True), str(directory),
                              num_epochs=1, checkpoint_epoch=1, log=lambda *_: None)
        return
    model._tpuddp_initial_variables = (params, mstate)
    acc = JaxAccelerator(mesh=mesh, seed=0, augment=augment, weight_update_sharding=True)
    jmodel, jopt, loader = acc.prepare(model, opt, JaxDataLoader(train, 32, shuffle=True))
    loader.set_epoch(0)
    jax_entry.train(jmodel, loader, JaxCrossEntropyLoss(), jopt, acc, None)
    acc.save_state(jmodel, jopt, str(directory), epoch=0)


@pytest.fixture(scope="module")
def init():
    return jax_init(NATIVE)


@pytest.fixture(scope="module")
def world2(tmp_path_factory, cpu_devices, init):
    """The JAX package's files (a 2-device mesh), then one 2-process Gloo
    launch: each path's straight run, its resumed run, and the JAX files
    restored."""
    work = tmp_path_factory.mktemp("zero1_ckpt")
    jobs = []
    for path, training in TRAININGS.items():
        _jax_writes(path, work / f"jax_{path}", cpu_devices[:2], init)
        for name in (f"{path}_straight", f"{path}_first"):
            np.savez(work / f"{name}_init.npz", **{k: v.numpy() for k, v in init[2].items()})
        jobs += [
            {"kind": "run", "name": f"{path}_straight", "path": path, "training": training,
             "save_dir": str(work / f"{path}_straight")},
            {"kind": "run", "name": f"{path}_first", "path": path,
             "training": dict(training, num_epochs=1), "save_dir": str(work / f"{path}_resumed")},
            {"kind": "run", "name": f"{path}_resumed", "path": path, "training": training,
             "save_dir": str(work / f"{path}_resumed"), "resume": True},
            {"kind": "restore", "name": f"{path}_from_jax", "path": path, "training": training,
             "dir": str(work / f"jax_{path}")},
        ]
    (work / "jobs.json").write_text(json.dumps(jobs))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_port_zero1_worker.py"), str(work)],
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S, env=_env(),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return work


def _port_flat(work, name):
    """The port run's gathered optimizer state by JAX slot, in the port's
    order, and its step."""
    opts = [_arrays(work / f"{name}_opt_{r}.npz") for r in range(2)]
    return {slot: np.concatenate([o[f"/{key}"] for o in opts]) for slot, key in KEYS.items()}, int(
        opts[0]["/step"])


@pytest.mark.parametrize("path", ["native", "managed"])
def test_port_files_hold_the_jax_flat_vectors(world2, path):
    file = _arrays(world2 / f"{path}_straight" / f"{PREFIX[path]}_1.npz")
    topo = json.loads(str(file["__topology__"]))
    flat, step = _port_flat(world2, f"{path}_straight")
    model = _port_model()
    bf16 = path == "managed"
    for slot in KEYS:
        key = f"{FIELD[path]}.{slot}"
        assert topo["leaves"][key] == {"kind": "data_flat"} and topo["placement"][key] == ["data"]
        stored = file[("__bf16__" + key) if bf16 else key]
        assert stored.shape == (RAW + 1,) and stored[-1] == 0
        want = flat_to_jax("toy_cnn", model, flat[slot][:RAW])
        if bf16:
            want = want.astype(ml_dtypes.bfloat16).view(np.uint16)
        np.testing.assert_array_equal(stored[:RAW], want, err_msg=key)
    assert int(file[f"{FIELD[path]}.step"]) == step == 2 * 23


@pytest.mark.parametrize("world", [2, 1])
def test_the_jax_loop_resumes_a_port_file(tmp_path, cpu_devices, world2, world):
    directory = tmp_path / "run"
    shutil.copytree(world2 / "native_straight", directory)
    ddp, like = _jax_like("native", NATIVE, cpu_devices[:world])
    restored, next_epoch = jax_ckpt.restore_latest(str(directory), like, world_size=world)
    assert next_epoch == 2
    flat, step = _port_flat(world2, "native_straight")
    model = _port_model()
    for slot in KEYS:
        got = np.asarray(getattr(restored.opt_state, slot))
        assert got.shape == (RAW + world - 1,)
        np.testing.assert_array_equal(got[:RAW], flat_to_jax("toy_cnn", model, flat[slot][:RAW]))
    assert int(restored.opt_state.step) == step
    mesh, train, test = ddp.mesh, *_pieces(NATIVE, cpu_devices[:world])[1:3]
    _, history = jax_run_training_loop(
        ddp, like, JaxLoader(train, 32, mesh, shuffle=True), JaxLoader(test, 45, mesh, shuffle=True),
        str(directory), num_epochs=3, auto_resume=True, log=lambda *_: None)
    assert [r["epoch"] for r in history] == [2] and np.isfinite(history[0]["train_loss"])


@pytest.mark.parametrize("world", [2, 1])
def test_the_jax_accelerator_loads_a_port_state_file(cpu_devices, world2, world):
    acc, (jmodel, jopt) = _jax_like("managed", MANAGED, cpu_devices[:world])
    assert acc.load_state(jmodel, jopt, str(world2 / "managed_straight")) == 2
    flat, step = _port_flat(world2, "managed_straight")
    model = _port_model()
    for slot in KEYS:
        got = _bits(getattr(jopt.opt_state, slot))
        want = flat_to_jax("toy_cnn", model, flat[slot][:RAW]).astype(ml_dtypes.bfloat16)
        assert got.shape == (RAW + world - 1,)
        np.testing.assert_array_equal(got[:RAW], want.view(np.uint16))
    assert int(jopt.opt_state.step) == step


@pytest.mark.parametrize("path", ["native", "managed"])
def test_the_port_restores_a_jax_file_world_2(world2, path):
    """Each rank's shard of each flat vector, bitwise."""
    file = _arrays(world2 / f"jax_{path}" / f"{PREFIX[path]}_0.npz")
    opts = [_arrays(world2 / f"{path}_from_jax_opt_{r}.npz") for r in range(2)]
    model = _port_model()
    for slot, key in KEYS.items():
        stored = file[("__bf16__" if path == "managed" else "") + f"{FIELD[path]}.{slot}"]
        stored = stored.view(ml_dtypes.bfloat16).astype(np.float32) if path == "managed" else stored
        assert stored.shape == (RAW + 1,)
        port = np.append(flat_from_jax("toy_cnn", model, stored[:RAW]), np.float32(0))
        for o in opts:
            np.testing.assert_array_equal(o[f"/{key}"], port[int(o["lo"]):int(o["hi"])], err_msg=slot)
    assert all(int(o["/step"]) == int(file[f"{FIELD[path]}.step"]) for o in opts)
    finals = [_arrays(world2 / f"{path}_from_jax_{r}.npz") for r in range(2)]
    for k in finals[0]:
        np.testing.assert_array_equal(finals[0][k], finals[1][k], err_msg=k)


@pytest.mark.parametrize("path", ["native", "managed"])
def test_the_port_restores_a_jax_file_world_1_repadded(world2, path):
    torch.set_num_threads(2)
    training = TRAININGS[path]
    if path == "native":
        ddp, *_ = train_native.build_training(0, 1, training, "cpu")
        opt = ddp.optimizer
        ckpt.restore_latest(str(world2 / f"jax_{path}"), ddp.model, opt)
    else:
        acc, model, popt, *_ = train_accelerate.build_training(training, "cpu")
        assert acc.load_state(model, popt, str(world2 / f"jax_{path}")) == 1
        opt = popt.optimizer
    assert (opt.lo, opt.hi) == (0, RAW)
    file = _arrays(world2 / f"jax_{path}" / f"{PREFIX[path]}_0.npz")
    for slot, key in KEYS.items():
        stored = file[("__bf16__" if path == "managed" else "") + f"{FIELD[path]}.{slot}"]
        got = opt.shard_state(key)
        got = got.view(torch.int16).numpy().view(np.uint16) if path == "managed" else got.numpy()
        np.testing.assert_array_equal(got, flat_from_jax("toy_cnn", _port_model(), stored[:RAW]))


@pytest.mark.parametrize("path", ["native", "managed"])
def test_a_resumed_port_run_equals_the_straight_run(world2, path):
    a = _arrays(world2 / f"{path}_straight" / f"{PREFIX[path]}_1.npz")
    b = _arrays(world2 / f"{path}_resumed" / f"{PREFIX[path]}_1.npz")
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for r in range(2):
        x, y = (_arrays(world2 / f"{path}_{n}_opt_{r}.npz") for n in ("straight", "resumed"))
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_per_parameter_and_flat_moments_do_not_cross(tmp_path, cpu_devices, world2):
    """A ZeRO-1 file into a run without ZeRO-1 and the reverse: the JAX
    package's ``KeyError`` for the missing leaf, in both packages."""
    torch.set_num_threads(2)
    flat_dir = world2 / "native_straight"
    tree = dict(NATIVE, weight_update_sharding=False)
    ddp, *_ = train_native.build_training(0, 1, tree, "cpu")
    with pytest.raises(KeyError, match=r"\.opt_state\.m\["):
        ckpt.restore_latest(str(flat_dir), ddp.model, ddp.optimizer)
    mesh, _, _, _, _, model, opt = _pieces(tree, cpu_devices[:1])
    like = JaxDDP(model, opt, JaxCrossEntropyLoss(), mesh=mesh).init_state(
        jax.random.key(0), jnp.zeros((1, 8, 8, 3)))
    with pytest.raises(KeyError, match=r"\.opt_state\.m\["):
        jax_ckpt.restore_latest(str(flat_dir), like, world_size=1)
    ckpt.save_on_main(str(tmp_path), 0, ddp.model, ddp.optimizer, rank=0)
    zero1, *_ = train_native.build_training(0, 1, NATIVE, "cpu")
    with pytest.raises(KeyError, match=r"'\.opt_state\.m'"):
        ckpt.restore_latest(str(tmp_path), zero1.model, zero1.optimizer)
    _, like = _jax_like("native", NATIVE, cpu_devices[:1])
    with pytest.raises(KeyError, match=r"'\.opt_state\.m'"):
        jax_ckpt.restore_latest(str(tmp_path), like, world_size=1)


def test_a_non_zero_tail_is_refused(tmp_path, world2):
    """Re-padding may drop only zeros (``_refit_flat``)."""
    src = world2 / "native_straight" / "ckpt_1.npz"
    arrays = _arrays(src)
    arrays[".opt_state.m"] = arrays[".opt_state.m"].copy()
    arrays[".opt_state.m"][-1] = 1.0
    ckpt.write(str(tmp_path / "ckpt_1.npz"), {k: v for k, v in arrays.items()})
    ddp, *_ = train_native.build_training(0, 1, NATIVE, "cpu")
    with pytest.raises(ValueError, match="not world-multiple padding"):
        ckpt.restore_latest(str(tmp_path), ddp.model, ddp.optimizer)
