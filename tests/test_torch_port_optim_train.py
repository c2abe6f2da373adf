"""SGD, LARS and LAMB with ``clip_grad_norm`` and gradient accumulation
through the port's entry points, against the JAX package's, on the CPU at
world 1 (in-process, a 1-device mesh) and world 2 (two Gloo processes, a
2-device mesh): native sgd, native lars with clip, native lamb with
accumulation 2 and managed lamb with clip and accumulation 2, two epochs of
toy_mlp on the synthetic stand-in from the JAX init (no flip: the two
packages draw different masks). Then every optimizer's state crossing
between the packages' checkpoints, native and managed, both ways, and a file
of another optimizer refused.

Tolerances (PERF.md section 2): losses rtol 1e-4, parameters rtol 1e-4 /
atol 1e-5; checkpoints bitwise."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train_accelerate as jax_entry
from tpuddp import config as jax_cfg
from tpuddp import nn as jax_nn
from tpuddp.accelerate import Accelerator as JaxAccelerator
from tpuddp.data import DataLoader as JaxDataLoader
from tpuddp.data import ShardedDataLoader as JaxLoader
from tpuddp.data import flip_for as jax_flip_for
from tpuddp.data import load_datasets_for as jax_datasets_for
from tpuddp.data import norm_stats_for as jax_norm_stats_for
from tpuddp.data import transforms as jax_tf
from tpuddp.models import load_model as jax_load_model
from tpuddp.nn import CrossEntropyLoss as JaxCrossEntropyLoss
from tpuddp.parallel import make_mesh
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP
from tpuddp.training import checkpoint as jax_ckpt
from tpuddp.training.loop import run_training_loop as jax_run_training_loop

from tpuddp_torch import config as cfg
from tpuddp_torch.accelerate import Accelerator
from tpuddp_torch.models import load_model
from tpuddp_torch.models.convert import state_dict_from_jax
from tpuddp_torch.training import checkpoint as ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import _torch_port_entry_worker as entry_worker  # noqa: E402

LOSS_RTOL, P_RTOL, P_ATOL = 1e-4, 1e-4, 1e-5
SPAWN_TIMEOUT_S = 300

BASE = dict(
    cfg.TRAINING_DEFAULTS, model="toy_mlp", dataset="synthetic", synthetic_n=(96, 32),
    train_batch_size=16, test_batch_size=16, image_size=None, flip=False, seed=0,
    num_epochs=2, checkpoint_epoch=1,
)
RUNS = {
    "native_sgd": ("native", dict(optimizer="sgd", learning_rate=0.05, weight_decay=5e-4)),
    "native_lars_clip": ("native", dict(optimizer="lars", learning_rate=1.0, weight_decay=5e-4,
                                        clip_grad_norm=1.0)),
    "native_lamb_accum": ("native", dict(optimizer="lamb", learning_rate=1e-2, weight_decay=1e-2,
                                         gradient_accumulation_steps=2)),
    "managed_lamb_clip_accum": ("managed", dict(optimizer="lamb", learning_rate=1e-2,
                                                clip_grad_norm=0.5, gradient_accumulation_steps=2)),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    env.pop("TPUDDP_WORLD_SIZE", None)
    return env


def jax_init(training, key=3):
    """The JAX init of ``training``'s model at its input size: ``(params,
    model_state, the port's state_dict)``."""
    train, _ = jax_datasets_for(training)
    hw = training["image_size"] or train.images.shape[1]
    params, mstate = jax_load_model(training["model"], 10).init(
        jax.random.key(key), jnp.zeros((1, hw, hw, 3)))
    sd = state_dict_from_jax(training["model"], _np(params), _np(mstate))
    return params, mstate, sd


def jax_reference(path, training, params, mstate, devices):
    """The JAX package's run of ``training`` through its entry point's
    pieces (``path`` native: the DDP wrap and the epoch loop; managed: the
    Accelerator and train_accelerate's ``train``/``evaluate``) from
    ``params``/``mstate``: the ``(train_loss, test_loss)`` of each epoch and
    the final state_dict."""
    mesh = make_mesh(devices)
    train, test = jax_datasets_for(training)
    size = training["image_size"]
    mean, std = jax_norm_stats_for(training)
    augment = jax_tf.make_train_augment(size=size, flip=jax_flip_for(training), mean=mean, std=std)
    eval_transform = jax_tf.make_eval_transform(size=size, mean=mean, std=std)
    model = jax_load_model(training["model"], 10)
    if training["sync_bn"]:
        jax_nn.convert_sync_batchnorm(model)
    opt = jax_cfg.optimizer_from(training)
    clip, accum = training["clip_grad_norm"], training["gradient_accumulation_steps"]
    bs, tbs = training["train_batch_size"], training["test_batch_size"]
    if path == "native":
        ddp = JaxDDP(model, opt, JaxCrossEntropyLoss(), mesh=mesh, augment=augment,
                     eval_transform=eval_transform, clip_grad_norm=clip, grad_accumulation=accum)
        hw = size or train.images.shape[1]
        state = ddp.init_state(jax.random.key(0), jnp.zeros((1, hw, hw, 3)), params=params,
                               model_state=mstate)
        state, history = jax_run_training_loop(
            ddp, state, JaxLoader(train, bs, mesh, shuffle=True), JaxLoader(test, tbs, mesh, shuffle=True),
            None, num_epochs=training["num_epochs"], log=lambda *_: None)
        losses = [(r["train_loss"], r["test_loss"]) for r in history]
        return losses, state_dict_from_jax(training["model"], _np(state.params), _np(state.model_state))
    model._tpuddp_initial_variables = (params, mstate)
    acc = JaxAccelerator(mesh=mesh, seed=0, gradient_accumulation_steps=accum, clip_grad_norm=clip,
                         augment=augment)
    jmodel, jopt, loader = acc.prepare(model, opt, JaxDataLoader(train, bs, shuffle=True))
    crit, losses = JaxCrossEntropyLoss(), []
    for epoch in range(training["num_epochs"]):
        loader.set_epoch(epoch)
        train_loss = jax_entry.train(jmodel, loader, crit, jopt, acc, None)[0]
        test_loss = jax_entry.evaluate(jmodel, JaxDataLoader(test, tbs), crit, acc.device,
                                       jax.jit(eval_transform))[0]
        losses.append((train_loss, test_loss))
    return losses, state_dict_from_jax(training["model"], _np(jmodel.params), _np(jmodel.model_state))


def assert_run_close(history, sd, ref_losses, ref_sd, what):
    assert len(history) == len(ref_losses), what
    for row, (train_loss, test_loss) in zip(history, ref_losses):
        np.testing.assert_allclose(row["train_loss"], train_loss, rtol=LOSS_RTOL, err_msg=what)
        np.testing.assert_allclose(row["test_loss"], test_loss, rtol=LOSS_RTOL, err_msg=what)
    assert sorted(sd) == sorted(ref_sd), what
    for k in ref_sd:
        np.testing.assert_allclose(np.asarray(sd[k]), np.asarray(ref_sd[k]), rtol=P_RTOL,
                                   atol=P_ATOL, err_msg=f"{what} {k}")


def _training(run):
    path, overrides = RUNS[run]
    return path, dict(BASE, **overrides)


@pytest.fixture(scope="module")
def init():
    return jax_init(BASE)


@pytest.mark.parametrize("run", sorted(RUNS))
def test_entry_point_matches_jax_world_1(cpu_devices, init, run):
    path, training = _training(run)
    params, mstate, sd = init
    history, final = entry_worker.run(0, 1, path, training, sd)
    ref_losses, ref_sd = jax_reference(path, training, params, mstate, cpu_devices[:1])
    assert_run_close(history, final, ref_losses, ref_sd, run)


@pytest.fixture(scope="module")
def world2(tmp_path_factory, init):
    """One 2-process Gloo launch of every run."""
    work = tmp_path_factory.mktemp("optim_world2")
    runs = []
    for run in sorted(RUNS):
        path, training = _training(run)
        np.savez(work / f"{run}_init.npz", **{k: v.numpy() for k, v in init[2].items()})
        runs.append({"name": run, "path": path, "training": training})
    (work / "run.json").write_text(json.dumps(runs))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_port_entry_worker.py"), str(work)],
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S, env=_env(),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return work


@pytest.mark.parametrize("run", sorted(RUNS))
def test_entry_point_matches_jax_world_2(cpu_devices, init, world2, run):
    path, training = _training(run)
    with open(world2 / f"{run}_history.json") as f:
        history = json.load(f)
    finals = [dict(np.load(world2 / f"{run}_{r}.npz")) for r in range(2)]
    for k in finals[0]:  # every replica holds the same weights
        np.testing.assert_array_equal(finals[0][k], finals[1][k], err_msg=k)
    ref_losses, ref_sd = jax_reference(path, training, init[0], init[1], cpu_devices[:2])
    assert_run_close(history, finals[0], ref_losses, ref_sd, run)


# ---------------------------------------------------------- checkpoints --

OPTIMIZERS = {
    "adam": dict(optimizer="adam"),
    "sgd": dict(optimizer="sgd", momentum=0.9),
    "sgd-momentum0": dict(optimizer="sgd", momentum=0.0),
    "sgdw": dict(optimizer="sgdw", weight_decay=1e-2),
    "lars": dict(optimizer="lars", weight_decay=5e-4),
    "lamb": dict(optimizer="lamb"),
}
HW = 8


def _settings(opt):
    return dict(OPTIMIZERS[opt], learning_rate=0.05)


def _port(opt):
    model = load_model("toy_mlp", 10, input_shape=(HW, HW, 3))
    return model, cfg.optimizer_from(_settings(opt), model.parameters())


def _train_port(model, optimizer, steps=2):
    gen = torch.Generator().manual_seed(1)
    for _ in range(steps):
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=gen)
        optimizer.step()


def _jax_native_state(opt, trained: bool):
    """A JAX TrainState of toy_mlp whose optimizer took 2 updates (or none)
    from seeded gradients."""
    jopt = jax_cfg.optimizer_from(_settings(opt))
    ddp = JaxDDP(jax_load_model("toy_mlp", 10), jopt, JaxCrossEntropyLoss(),
                 mesh=make_mesh(jax.devices("cpu")[:1]))
    state = ddp.init_state(jax.random.key(2), jnp.zeros((1, HW, HW, 3)))
    if trained:
        params, opt_state = _np(state.params), jopt.init(_np(state.params))
        rng = np.random.RandomState(4)
        for _ in range(2):
            grads = jax.tree_util.tree_map(lambda p: rng.randn(*p.shape).astype(np.float32), params)
            params, opt_state = jopt.update(grads, opt_state, params)
        state = dataclasses.replace(state, params=params, opt_state=opt_state, step=jnp.int32(2))
    return state


def _flat(tree):
    """``keystr -> numpy`` of every array leaf (PRNG keys left out)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if not jax.dtypes.issubdtype(jnp.asarray(leaf).dtype, jax.dtypes.prng_key):
            out[jax.tree_util.keystr(path)] = np.asarray(leaf)
    return out


def _assert_same_state(layout, model, optimizer, jax_tree):
    """The port's parameters and optimizer state, by their JAX keys, are
    the JAX tree's, bitwise, and the two have the same optimizer keys."""
    ours = ckpt.state_payload(layout, model, optimizer)
    theirs = _flat(jax_tree)
    opt_key = ".opt_state" if layout == ckpt.NATIVE else "['opt_state']"
    assert sorted(k for k in ours if k.startswith(opt_key)) == \
        sorted(k for k in theirs if k.startswith(opt_key))
    for k, a in ours.items():
        np.testing.assert_array_equal(a, theirs[k], err_msg=k)


def _jax_accelerator(opt):
    acc = JaxAccelerator(mesh=make_mesh(jax.devices("cpu")[:1]), seed=5)
    jmodel, jopt = acc.prepare(jax_load_model("toy_mlp", 10), jax_cfg.optimizer_from(_settings(opt)))
    jmodel(jnp.zeros((1, HW, HW, 3)))
    return acc, jmodel, jopt


def _managed_tree(jmodel, jopt):
    return {"params": jmodel.params, "model_state": jmodel.model_state, "opt_state": jopt.opt_state}


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
@pytest.mark.parametrize("layout", [ckpt.NATIVE, ckpt.MANAGED])
def test_port_optimizer_state_restores_into_the_jax_package(tmp_path, opt, layout):
    model, optimizer = _port(opt)
    _train_port(model, optimizer)
    if layout == ckpt.NATIVE:
        ckpt.save_on_main(str(tmp_path), 0, model, optimizer, rank=0, step=2)
        restored, _ = jax_ckpt.restore_latest(str(tmp_path), _jax_native_state(opt, False),
                                              world_size=1)
        _assert_same_state(layout, model, optimizer, restored)
        return
    acc = Accelerator(seed=0, device="cpu")
    pmodel, popt = acc.prepare(model, optimizer)
    acc.save_state(pmodel, popt, str(tmp_path), epoch=0)
    jacc, jmodel, jopt = _jax_accelerator(opt)
    assert jacc.load_state(jmodel, jopt, str(tmp_path)) == 1
    _assert_same_state(layout, model, optimizer, _managed_tree(jmodel, jopt))


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
@pytest.mark.parametrize("layout", [ckpt.NATIVE, ckpt.MANAGED])
def test_jax_optimizer_state_restores_into_the_port(tmp_path, opt, layout):
    state = _jax_native_state(opt, True)
    model, optimizer = _port(opt)
    if layout == ckpt.NATIVE:
        jax_ckpt.save_on_main(str(tmp_path), 0, state, world_size=1)
        assert ckpt.restore_latest(str(tmp_path), model, optimizer)[1]["step"] == 2
        _assert_same_state(layout, model, optimizer, state)
        return
    jacc, jmodel, jopt = _jax_accelerator(opt)
    jmodel.params, jopt.opt_state = state.params, state.opt_state
    jacc.save_state(jmodel, jopt, str(tmp_path), epoch=0)
    acc = Accelerator(seed=0, device="cpu")
    pmodel, popt = acc.prepare(model, optimizer)
    assert acc.load_state(pmodel, popt, str(tmp_path)) == 1
    _assert_same_state(layout, model, optimizer, _managed_tree(jmodel, jopt))


@pytest.mark.parametrize("saved,loader", [
    ("sgd", "lamb"), ("lamb", "lars"), ("sgd-momentum0", "sgdw"), ("adam", "sgd-momentum0"),
])
def test_a_file_of_another_optimizer_is_refused(tmp_path, saved, loader):
    model, optimizer = _port(saved)
    _train_port(model, optimizer, steps=1)
    ckpt.save_on_main(str(tmp_path), 0, model, optimizer, rank=0)
    other, other_opt = _port(loader)
    with pytest.raises(ValueError, match=f"holds the optimizer state of .* but the optimizer is "
                                         f"{type(other_opt).__name__} "):
        ckpt.restore_latest(str(tmp_path), other, other_opt)
