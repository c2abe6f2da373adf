"""Resume continuity of the port, on the CPU: 2 straight epochs against
epoch 0 and a resumed epoch 1 (native and managed, 1 process and 2 Gloo
processes, toy_cnn with sync_bn, flips and accumulation 2), a JAX run
resumed by the port against the JAX package's own resume, and the entry
point's resume (log line, ``keep_last``, ``history.jsonl`` appended). A file
of its own, beside tests/test_torch_port_resume.py, so that the test
workers share them out.

Tolerances: port-only continuity is bitwise (the same batches and random
streams through the same arithmetic). The JAX package's resume against the
port's from the same file: losses rtol 1e-4, parameters rtol 1e-4 / atol
1e-5 (two libraries summing in another order over one epoch of Adam
steps)."""

import json
import os
import shutil
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpuddp import optim as jax_optim
from tpuddp.data import ShardedDataLoader as JaxLoader
from tpuddp.data import transforms as jax_tf
from tpuddp.data.synthetic import synthetic_uint8_datasets as jax_synthetic_uint8
from tpuddp.models import load_model as jax_load_model
from tpuddp.nn import CrossEntropyLoss as JaxCrossEntropyLoss
from tpuddp.parallel import make_mesh
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP
from tpuddp.training.loop import run_training_loop as jax_run_training_loop

from tpuddp_torch import config as cfg_lib
from tpuddp_torch.models import load_model
from tpuddp_torch.models.convert import state_dict_from_jax
from tpuddp_torch.parallel.spawn import run_ddp_training
from tpuddp_torch.train_native import basic_ddp_training_loop
from tpuddp_torch.training import checkpoint as ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import _torch_port_resume_worker as resume_worker  # noqa: E402

SPAWN_TIMEOUT_S = 300
LOSS_RTOL, P_RTOL, P_ATOL = 1e-4, 1e-4, 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _names(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".npz"))


# ---------------------------------------------------------- continuity -----

def _final_arrays(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _check_continuity(workdir, path):
    name = "ckpt" if path == "native" else "state"
    straight = _final_arrays(os.path.join(workdir, path, "straight", f"{name}_1.npz"))
    resumed = _final_arrays(os.path.join(workdir, path, "resumed", f"{name}_1.npz"))
    assert sorted(straight) == sorted(resumed)
    for k in straight:  # parameters, buffers, moments, steps, every rank's random streams
        np.testing.assert_array_equal(straight[k], resumed[k], err_msg=k)
    rows = {}
    for run in ("straight", "resumed"):
        with open(os.path.join(workdir, path, run, "history.jsonl")) as f:
            rows[run] = [json.loads(line) for line in f]
    assert [r["epoch"] for r in rows["resumed"]] == [0, 1]  # appended, never rewritten
    for a, b in zip(rows["straight"], rows["resumed"]):
        assert (a["train_loss"], a["test_loss"]) == (b["train_loss"], b["test_loss"])


@pytest.mark.parametrize("path", ["native", "managed"])
def test_resume_is_bitwise_continuous_world_1(tmp_path, path):
    resume_worker.continuity(str(tmp_path), path, 1)
    _check_continuity(str(tmp_path), path)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    work = tmp_path_factory.mktemp("resume_world2")
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    env.pop("TPUDDP_WORLD_SIZE", None)
    env.pop(ckpt.AUTO_RESUME_ENV, None)
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_port_resume_worker.py"), str(work), "2"],
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return str(work), proc.stdout


@pytest.mark.parametrize("path", ["native", "managed"])
def test_resume_is_bitwise_continuous_on_2_gloo_processes(world2, path):
    work, stdout = world2
    _check_continuity(work, path)
    assert "Auto-resume: continuing from epoch 1." in stdout.splitlines()
    assert "Resumed from epoch 0 state." in stdout.splitlines()
    with np.load(os.path.join(work, path, "resumed", "ckpt_1.npz" if path == "native" else "state_1.npz")) as data:
        assert len(json.loads(str(data[ckpt.RNG_KEY]))) == 2


def _jax_epoch(name, save_dir, num_epochs, cpu_devices, training):
    """The JAX package's native run of ``training`` (world 1), resuming from
    ``save_dir`` when it holds a checkpoint."""
    train, test = jax_synthetic_uint8(*training["synthetic_n"])
    mesh = make_mesh(cpu_devices[:1])
    ddp = JaxDDP(
        jax_load_model(name, 10), jax_optim.Adam(training["learning_rate"]), JaxCrossEntropyLoss(),
        mesh=mesh, augment=jax_tf.make_train_augment(size=None, flip=False),
        eval_transform=jax_tf.make_eval_transform(size=None),
    )
    state = ddp.init_state(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    state, history = jax_run_training_loop(
        ddp, state,
        JaxLoader(train, training["train_batch_size"], mesh, shuffle=True),
        JaxLoader(test, training["test_batch_size"], mesh, shuffle=True),
        save_dir, num_epochs=num_epochs, checkpoint_epoch=1, auto_resume=True,
        log=lambda *_: None,
    )
    return state, history


@pytest.mark.parametrize("name", ["toy_mlp", "toy_cnn"])
def test_port_resumes_a_jax_run(tmp_path, cpu_devices, name):
    """JAX trains epoch 0; JAX and the port each resume epoch 1 from that
    file (no flip: the packages draw different masks)."""
    training = dict(cfg_lib.TRAINING_DEFAULTS, model=name, dataset="synthetic",
                    synthetic_n=(96, 32), train_batch_size=16, test_batch_size=16,
                    image_size=None, flip=False, seed=0, num_epochs=2, checkpoint_epoch=1,
                    resume=True)
    first, by_jax, by_port = (str(tmp_path / d) for d in ("first", "jax", "port"))
    _jax_epoch(name, first, 1, cpu_devices, training)
    shutil.copytree(first, by_jax)
    shutil.copytree(first, by_port)
    state, jax_history = _jax_epoch(name, by_jax, 2, cpu_devices, training)
    history = run_ddp_training(
        partial(basic_ddp_training_loop, training=training, device="cpu"), 1, by_port, {},
        backend="cpu",
    )
    assert [r["epoch"] for r in history] == [r["epoch"] for r in jax_history] == [1]
    for key in ("train_loss", "test_loss"):
        np.testing.assert_allclose(history[0][key], jax_history[0][key], rtol=LOSS_RTOL)
    model = load_model(name, 10, input_shape=(32, 32, 3))
    ckpt.load(os.path.join(by_port, "ckpt_1.npz"), model)
    want = state_dict_from_jax(name, _np(state.params), _np(state.model_state))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=P_RTOL, atol=P_ATOL, err_msg=k)


def test_entry_point_resumes_prunes_and_appends(tmp_path, capsys, monkeypatch):
    """Two runs of the native entry point's worker: the second, with
    ``$TPUDDP_AUTO_RESUME`` and ``keep_last: 1``, prints the JAX log line,
    trains epochs 1-2 only, keeps ckpt_2.npz alone and appends to
    history.jsonl."""
    monkeypatch.delenv(ckpt.AUTO_RESUME_ENV, raising=False)
    training = dict(resume_worker.TRAINING, model="toy_mlp", sync_bn=False,
                    gradient_accumulation_steps=1, num_epochs=1)
    run = partial(basic_ddp_training_loop, device="cpu")
    run_ddp_training(partial(run, training=training), 1, str(tmp_path), {}, backend="cpu")
    monkeypatch.setenv(ckpt.AUTO_RESUME_ENV, "1")
    capsys.readouterr()
    history = run_ddp_training(partial(run, training=dict(training, num_epochs=3, keep_last=1)),
                               1, str(tmp_path), {}, backend="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert "Auto-resume: continuing from epoch 1." in lines
    assert [r["epoch"] for r in history] == [1, 2]
    assert _names(tmp_path) == ["ckpt_2.npz"]
    with open(tmp_path / "history.jsonl") as f:
        assert [json.loads(line)["epoch"] for line in f] == [0, 1, 2]
