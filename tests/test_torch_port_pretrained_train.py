"""Training from a pretrained checkpoint (``training.pretrained_path``)
through the port's entry points, against the JAX package, on the CPU, with
donors written by the JAX package's own torchvision-layout model functions
(tests/test_torch_import.py):

- one native epoch of AlexNet at 64 px (the synthetic stand-in's 16 train
  and 8 test images, batch 8, no flip, dropout 0: the two packages draw
  different random numbers) from a 10-class donor, against the JAX
  package's native loop from its own load of the same file: the epoch's
  train and test losses;
- ``resnet18`` from a 1000-class donor (the head swapped), one epoch with
  flips through each entry point at world 1: the managed run's parameters
  bitwise the native run's; the native file's ``__prngkey__.rng`` the JAX
  run key of a pretrained start, the managed file's ``rng_key`` and
  ``bwd_key`` the JAX ``Accelerator``'s with a preloaded model (no init
  key drawn);
- ``resume: true`` after a pretrained start restores the checkpoint, not
  the file: 1 + 1 epochs bitwise 2 straight ones.

Tolerances: losses rtol 1e-4 (PERF.md section 2); everything else bitwise.
"""

import os
import shutil
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuddp import config as jax_cfg
from tpuddp import optim as jax_optim
from tpuddp import seeding as jax_seeding
from tpuddp.accelerate import Accelerator as JaxAccelerator
from tpuddp.data import ShardedDataLoader as JaxLoader
from tpuddp.data import load_datasets_for as jax_datasets_for
from tpuddp.data import norm_stats_for as jax_norm_stats_for
from tpuddp.data import transforms as jax_tf
from tpuddp.models import AlexNet as JaxAlexNet
from tpuddp.models import torch_import
from tpuddp.nn import CrossEntropyLoss as JaxCrossEntropyLoss
from tpuddp.parallel import make_mesh
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP
from tpuddp.training.loop import run_training_loop as jax_run_training_loop

from tpuddp_torch import config as cfg
from tpuddp_torch import train_native
from tpuddp_torch.accelerate import Accelerator
from tpuddp_torch.models.pretrained import pretrained_from_config
from tpuddp_torch.nn import CrossEntropyLoss
from tpuddp_torch.optim import Adam
from tpuddp_torch.parallel.spawn import run_ddp_training
from tpuddp_torch.train_accelerate import basic_accelerate_training
from tpuddp_torch.training.loop import run_training_loop

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_pretrained import donor, saved  # noqa: E402

RTOL = 1e-4
TRAINING = dict(
    cfg.TRAINING_DEFAULTS, dataset="synthetic", synthetic_n=(16, 8), train_batch_size=8,
    test_batch_size=8, seed=0, num_epochs=1, checkpoint_epoch=1, scan_steps=1,
)


def _arrays(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


# ----------------------------------------------------- an epoch vs JAX ---

def _native_epoch(rank, world_size, save_dir, optional_args, training):
    """The native entry point's objects at dropout 0, one epoch."""
    ddp, train_loader, test_loader, seed = train_native.build_training(rank, world_size, training, "cpu")
    for m in ddp.model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return run_training_loop(ddp, train_loader, test_loader, save_dir, num_epochs=1, base_seed=seed,
                             scan_steps=1, log=lambda *_: None)


def _jax_epoch(training, cpu_devices):
    """The JAX package's native loop from its own load of the file, its
    AlexNet at dropout 0, built as root train_native.py builds it."""
    key, _ = jax_seeding.set_seed_based_on_rank(0, training["seed"])
    _, params, mstate = torch_import.pretrained_from_config(training, key)
    mesh = make_mesh(cpu_devices[:1])
    train, test = jax_datasets_for(training)
    mean, std = jax_norm_stats_for(training)
    size = training["image_size"]
    ddp = JaxDDP(JaxAlexNet(10, dropout=0.0), jax_cfg.optimizer_from(training), JaxCrossEntropyLoss(),
                 mesh=mesh, augment=jax_tf.make_train_augment(size=size, flip=False, mean=mean, std=std),
                 eval_transform=jax_tf.make_eval_transform(size=size, mean=mean, std=std))
    state = ddp.init_state(key, jnp.zeros((1, size, size, 3)), params=params, model_state=mstate)
    _, history = jax_run_training_loop(
        ddp, state, JaxLoader(train, training["train_batch_size"], mesh, shuffle=True),
        JaxLoader(test, training["test_batch_size"], mesh, shuffle=True), None, num_epochs=1,
        scan_steps=1, log=lambda *_: None)
    return history


def test_one_native_alexnet_epoch_from_a_10_class_donor_tracks_the_jax_run(tmp_path, cpu_devices):
    torch.set_num_threads(2)
    with saved(tmp_path, donor("alexnet", 10)) as path:
        training = dict(TRAINING, model="alexnet", image_size=64, flip=False, pretrained_path=path)
        got = run_ddp_training(partial(_native_epoch, training=training), 1, None, {}, backend="cpu")
        want = _jax_epoch(dict(jax_cfg.TRAINING_DEFAULTS, **training), cpu_devices)
    assert (got[0]["train_samples"], got[0]["test_samples"]) == (16, 8)
    for k in ("train_loss", "test_loss"):
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=RTOL, err_msg=k)


# ------------------------------------------------ the two entry points ---

@pytest.fixture(scope="module")
def resnet_runs(tmp_path_factory):
    """``resnet18`` at 32 px from a 1000-class donor, with flips: one epoch
    through each entry point at world 1, 2 + (1 resumed) native epochs
    (the files are deleted with the module)."""
    torch.set_num_threads(2)
    work = tmp_path_factory.mktemp("pretrained_runs")
    path = os.path.join(str(work), "resnet18_1000.pt")
    torch.save(donor("resnet18", 1000), path)
    training = dict(TRAINING, model="resnet18", image_size=None, pretrained_path=path)
    out = {}
    for kind, fn in (("native", train_native.basic_ddp_training_loop),
                     ("managed", basic_accelerate_training)):
        save_dir = str(work / kind)
        out[kind] = run_ddp_training(partial(fn, training=training, device="cpu"), 1, save_dir, {},
                                     backend="cpu")
    native = partial(train_native.basic_ddp_training_loop, device="cpu")
    for kind, runs in (("straight", [dict(training, num_epochs=2)]),
                       ("resumed", [training, dict(training, num_epochs=2, resume=True)])):
        for t in runs:
            out[kind] = run_ddp_training(partial(native, training=t), 1, str(work / kind), {},
                                         backend="cpu")
    yield work, training, out
    shutil.rmtree(work)


def _params(arrays, prefix):
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


def test_the_managed_entry_is_bitwise_the_native_entry(resnet_runs):
    work, _, out = resnet_runs
    native = _params(_arrays(work / "native" / "ckpt_0.npz"), ".params")
    managed = _params(_arrays(work / "managed" / "state_0.npz"), "['params']")
    assert native.keys() == managed.keys() and len(native) == 62
    for k in native:
        np.testing.assert_array_equal(native[k], managed[k], err_msg=k)
    assert native["[13]['weight']"].shape == (512, 10)  # the swapped head, (in, out)
    # one full test batch: the managed test loss is the mean of batch means,
    # the native one the mean of rows, equal only where no batch is ragged
    for k in ("train_loss", "test_loss"):
        assert out["native"][0][k] == out["managed"][0][k]


def test_the_native_file_holds_the_jax_run_key_of_a_pretrained_start(resnet_runs, cpu_devices):
    work, training, _ = resnet_runs
    key, _ = jax_seeding.set_seed_based_on_rank(0, training["seed"])
    jax_model, params, mstate = torch_import.pretrained_from_config(training, key)
    ddp = JaxDDP(jax_model, jax_optim.Adam(1e-3), JaxCrossEntropyLoss(), mesh=make_mesh(cpu_devices[:1]))
    state = ddp.init_state(key, jnp.zeros((1, 32, 32, 3)), params=params, model_state=mstate)
    got = _arrays(work / "native" / "ckpt_0.npz")["__prngkey__.rng"]
    np.testing.assert_array_equal(got, np.asarray(jax.random.key_data(state.rng)))


def test_resume_after_a_pretrained_start_restores_the_checkpoint(resnet_runs):
    """1 epoch, then ``resume: true`` for the 2nd, against 2 straight: the
    resumed run starts from ``ckpt_0.npz`` (a start from the file again
    would part at once), bitwise."""
    work, _, out = resnet_runs
    straight, resumed = (_arrays(work / k / "ckpt_1.npz") for k in ("straight", "resumed"))
    assert [r["epoch"] for r in out["resumed"]] == [1]
    for k, v in straight.items():
        if k.startswith((".params", ".opt_state", ".model_state")):
            np.testing.assert_array_equal(v, resumed[k], err_msg=k)


def test_managed_keys_are_the_jax_accelerators_with_a_preloaded_model(cpu_devices, resnet_runs):
    """Both Accelerators from the same donor (the JAX module carrying its
    preloaded variables, the port's ``pretrained_from``): prepare, two
    backward/step pairs; both state files hold the same keys and counter
    (the JAX package draws no init key for a preloaded model)."""
    work, training, _ = resnet_runs
    rng = np.random.RandomState(0)
    x = rng.randn(8, 32, 32, 3).astype(np.float32)
    y, w = rng.randint(0, 10, 8), np.ones(8, np.float32)
    jmodule, params, mstate = torch_import.pretrained_from_config(training)
    jmodule._tpuddp_initial_variables = (params, mstate)
    jacc = JaxAccelerator(mesh=make_mesh(cpu_devices[:1]), seed=11)
    jmodel, jopt = jacc.prepare(jmodule, jax_optim.Adam(1e-3))
    acc = Accelerator(seed=11, device="cpu")
    module = pretrained_from_config(training)
    model, opt = acc.prepare(module, Adam(module.parameters(), lr=1e-3))
    for a, m, o, crit, labels in ((jacc, jmodel, jopt, JaxCrossEntropyLoss(), y.astype(np.int32)),
                                  (acc, model, opt, CrossEntropyLoss(), y)):
        for _ in range(2):
            o.zero_grad()
            a.backward(crit(m(x), labels, w))
            o.step()
        a.save_state(m, o, str(work / type(a).__module__), epoch=0)
    ours = _arrays(work / "tpuddp_torch.accelerate" / "state_0.npz")
    want = _arrays(work / "tpuddp.accelerate" / "state_0.npz")
    for k in ("__prngkey__['rng_key']", "__prngkey__['bwd_key']", "['bwd_counter']"):
        np.testing.assert_array_equal(ours[k], want[k], err_msg=k)
