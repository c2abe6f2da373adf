"""The JAX package's random keys and step count in the port's checkpoints, on
the CPU:

- the numpy threefry2x32, ``key``, ``fold_in`` and ``split``
  (tpuddp_torch/_threefry.py) bitwise against ``jax.random`` as this JAX
  runs it (0.9.0, ``jax_threefry_partitionable`` on, 64-bit types off);
- a native ``ckpt_N.npz`` holds the JAX run key as ``__prngkey__.rng`` and no
  raw ``.rng``; a file with the raw ``.rng`` still resumes;
- ``.step`` counts micro-batches (padding ones included) and
  ``.opt_state.step`` updates, in the port's file as in the JAX package's;
- a managed ``state_N.npz`` holds the JAX ``Accelerator``'s ``rng_key`` and
  ``bwd_key`` at the same point of the same run;
- the JAX package's own ``run_training_loop`` resumes a run that the port's
  ``train_native`` wrote, with its template built as root
  ``train_native.py`` builds it (a typed key from
  ``set_seed_based_on_rank``), with and without accumulation.

Tolerance: bitwise throughout (keys are integers; a restore only moves
elements)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpuddp import config as jax_cfg
from tpuddp import seeding as jax_seeding
from tpuddp.accelerate import Accelerator as JaxAccelerator
from tpuddp.data import ShardedDataLoader as JaxLoader
from tpuddp.data import load_datasets_for as jax_datasets_for
from tpuddp.data import transforms as jax_tf
from tpuddp.models import load_model as jax_load_model
from tpuddp.nn import CrossEntropyLoss as JaxCrossEntropyLoss
from tpuddp.parallel import make_mesh
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP
from tpuddp.training.loop import run_training_loop as jax_run_training_loop

from tpuddp_torch import _threefry as threefry
from tpuddp_torch import config as cfg
from tpuddp_torch import seeding
from tpuddp_torch.accelerate import Accelerator
from tpuddp_torch.models import load_model
from tpuddp_torch.models.convert import jax_from_state_dict
from tpuddp_torch.nn import CrossEntropyLoss
from tpuddp_torch.optim import SGD, Adam
from tpuddp_torch.parallel.spawn import run_ddp_training
from tpuddp_torch.train_native import basic_ddp_training_loop
from tpuddp_torch.training import checkpoint as ckpt

SEEDS = (0, 2**33 + 9, 2**63 - 1)
_PRNG_RNG = "__prngkey__.rng"


def _data(k):
    return np.asarray(jax.random.key_data(k))


# ------------------------------------------------------------- threefry --

@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_and_split_are_jax_random(seed, rank):
    k = jax.random.key(seed % 2**63)
    np.testing.assert_array_equal(threefry.key(seed % 2**63), _data(k))
    folded = jax.random.fold_in(k, rank)
    ours = threefry.fold_in(threefry.key(seed % 2**63), rank)
    np.testing.assert_array_equal(ours, _data(folded))
    np.testing.assert_array_equal(seeding.jax_process_key(seed, rank), _data(folded))
    for n in (2, 3):
        np.testing.assert_array_equal(threefry.split(ours, n), _data(jax.random.split(folded, n)))


def test_the_partitionable_split_of_this_jax():
    """The flag the port's split follows, and the check value of seed 0,
    rank 0 (the old iota-and-reshape order would give another key)."""
    assert jax.config.jax_threefry_partitionable and not jax.config.jax_enable_x64
    np.testing.assert_array_equal(seeding.jax_run_key(0), [1353695780, 2116000888])
    # the old order: the hash of iota(4) as two halves, reshaped to (2, 2)
    old = threefry.threefry2x32(threefry.fold_in(threefry.key(0), 0), [0, 1], [2, 3])
    assert list(old[1]) != [1353695780, 2116000888]


def test_threefry2x32_is_jax_prng():
    from jax._src import prng

    rng = np.random.RandomState(0)
    k = rng.randint(0, 2**32, size=2, dtype=np.uint64).astype(np.uint32)
    x = rng.randint(0, 2**32, size=(2, 64), dtype=np.uint64).astype(np.uint32)
    want = prng.threefry_2x32(jnp.asarray(k), jnp.asarray(x.ravel()))
    ours = threefry.threefry2x32(k, x[0], x[1])
    np.testing.assert_array_equal(np.concatenate(ours), np.asarray(want))


@pytest.mark.parametrize("process_index", [0, 3])
def test_key_stream_draws_as_the_jax_accelerator(process_index):
    """``JaxKeyStream.draw`` is ``Accelerator._next_key``
    (tpuddp/accelerate.py:1487-1489) from ``fold_in(key(seed), index)``."""
    stream = seeding.JaxKeyStream(7, process_index)
    k = jax.random.fold_in(jax.random.key(7), process_index)
    for _ in range(3):
        k, sub = jax.random.split(k)
        np.testing.assert_array_equal(stream.draw(), _data(sub))
    np.testing.assert_array_equal(stream.key, _data(k))


# ------------------------------------------------------- native files ---

TRAINING = dict(
    cfg.TRAINING_DEFAULTS, model="toy_mlp", dataset="synthetic", synthetic_n=(80, 16),
    train_batch_size=8, test_batch_size=8, image_size=None, flip=False, seed=0,
    num_epochs=1, checkpoint_epoch=1, learning_rate=1e-2,
)


def _port_run(save_dir, **overrides):
    training = dict(TRAINING, **overrides)
    return run_ddp_training(partial(basic_ddp_training_loop, training=training, device="cpu"),
                            1, str(save_dir), {}, backend="cpu")


def _arrays(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _jax_native(training, cpu_devices, save_dir, auto_resume=False):
    """The JAX package's native run of ``training`` at world 1, built as root
    train_native.py builds it: the typed key of ``set_seed_based_on_rank``,
    the dataset, transforms and optimizer from the settings."""
    key, _ = jax_seeding.set_seed_based_on_rank(0, training["seed"])
    mesh = make_mesh(cpu_devices[:1])
    train_ds, test_ds = jax_datasets_for(training)
    ddp = JaxDDP(
        jax_load_model(training["model"], 10), jax_cfg.optimizer_from(training),
        JaxCrossEntropyLoss(), mesh=mesh,
        augment=jax_tf.make_train_augment(size=None, flip=False),
        eval_transform=jax_tf.make_eval_transform(size=None),
        grad_accumulation=int(training["gradient_accumulation_steps"]),
        clip_grad_norm=training["clip_grad_norm"],
    )
    in_hw = train_ds.images.shape[1]
    state = ddp.init_state(key, jnp.zeros((1, in_hw, in_hw, 3)))
    return jax_run_training_loop(
        ddp, state,
        JaxLoader(train_ds, training["train_batch_size"], mesh, shuffle=True),
        JaxLoader(test_ds, training["test_batch_size"], mesh, shuffle=True),
        str(save_dir), num_epochs=training["num_epochs"],
        checkpoint_epoch=training["checkpoint_epoch"], auto_resume=auto_resume,
        log=lambda *_: None,
    )


@pytest.mark.parametrize("seed", [0, 2**33 + 9])
def test_native_file_holds_the_jax_run_key(tmp_path, seed):
    _port_run(tmp_path, seed=seed)
    data = _arrays(tmp_path / "ckpt_0.npz")
    assert ".rng" not in data
    run_key = jax.random.split(jax.random.fold_in(jax.random.key(seed % 2**63), 0))[1]
    np.testing.assert_array_equal(data[_PRNG_RNG], _data(run_key))


def test_a_file_with_the_raw_rng_leaf_still_resumes(tmp_path):
    """The layout of files written before ``__prngkey__.rng``: a raw uint32
    ``.rng`` of ``PRNGKey(seed)``. The port reads neither key leaf."""
    _port_run(tmp_path)
    path = str(tmp_path / "ckpt_0.npz")
    data = _arrays(path)
    data[".rng"] = np.array([0, 0], np.uint32)
    del data[_PRNG_RNG]
    meta = {k[len("__meta__"):]: int(data.pop(k)) for k in list(data) if k.startswith("__meta__")}
    ckpt.write(path, data, meta=meta)
    model = load_model("toy_mlp", 10, input_shape=(32, 32, 3))
    opt = Adam(model.parameters())
    assert ckpt.restore_latest(str(tmp_path), model, opt)[0] == 1
    params, _ = jax_from_state_dict("toy_mlp", model.state_dict())
    for i, layer in enumerate(params):
        for k, a in (layer or {}).items():
            np.testing.assert_array_equal(a, data[f".params[{i}]['{k}']"])


@pytest.mark.parametrize("n_train", [80, 72], ids=["10-batches", "9-batches-padded"])
def test_step_counts_micro_batches_in_both_packages(tmp_path, cpu_devices, n_train):
    """10 batches with ``gradient_accumulation_steps: 2``: ``.step`` 10 and
    ``.opt_state.step`` 5; 9 batches make the same 5 cycles, the last padded
    with an all-padding micro-batch that ``.step`` counts."""
    training = dict(TRAINING, synthetic_n=(n_train, 16), gradient_accumulation_steps=2)
    _port_run(tmp_path / "port", **training)
    _jax_native(dict(jax_cfg.TRAINING_DEFAULTS, **training), cpu_devices, tmp_path / "jax")
    for who in ("port", "jax"):
        data = _arrays(tmp_path / who / "ckpt_0.npz")
        assert (int(data[".step"]), int(data[".opt_state.step"])) == (10, 5), who


# ------------------------------------------------------------ managed ---

def test_managed_keys_are_the_jax_accelerators(tmp_path, cpu_devices):
    """The same run on both Accelerators (toy_mlp, SGD): prepare, two
    backward/step pairs, a forward-only read in train mode and a
    ``next_rng_key()``; then both state files hold the same keys and
    counter."""
    rng = np.random.RandomState(0)
    x = rng.randn(8, 8, 8, 3).astype(np.float32)
    y, w = rng.randint(0, 10, 8), np.ones(8, np.float32)

    jacc = JaxAccelerator(mesh=make_mesh(cpu_devices[:1]), seed=11)
    jmodel, jopt = jacc.prepare(jax_load_model("toy_mlp", 10), jax_cfg.optimizer_from(
        {"optimizer": "sgd", "learning_rate": 0.1}))
    acc = Accelerator(seed=11, device="cpu")
    module = load_model("toy_mlp", 10, input_shape=(8, 8, 3))
    model, opt = acc.prepare(module, SGD(module.parameters(), 0.1, momentum=0.9))
    for a, m, o, crit, labels in ((jacc, jmodel, jopt, JaxCrossEntropyLoss(), y.astype(np.int32)),
                                  (acc, model, opt, CrossEntropyLoss(), y)):
        for _ in range(2):
            o.zero_grad()
            loss = crit(m(x), labels, w)
            a.backward(loss)
            o.step()
        crit(m(x), labels, w).item()
        a.next_rng_key()
        a.save_state(m, o, str(tmp_path / type(a).__module__), epoch=0)
    ours = _arrays(tmp_path / "tpuddp_torch.accelerate" / "state_0.npz")
    want = _arrays(tmp_path / "tpuddp.accelerate" / "state_0.npz")
    for k in ("__prngkey__['rng_key']", "__prngkey__['bwd_key']", "['bwd_counter']"):
        np.testing.assert_array_equal(ours[k], want[k], err_msg=k)


def test_load_state_puts_the_keys_back(tmp_path):
    acc = Accelerator(seed=4, device="cpu")
    module = load_model("toy_mlp", 10, input_shape=(8, 8, 3))
    model, opt = acc.prepare(module, SGD(module.parameters(), 0.1))
    for _ in range(3):
        acc.next_rng_key()
    acc.save_state(model, opt, str(tmp_path), epoch=0)
    saved = acc.jax_keys.key.copy(), model._bwd_key.copy()
    fresh = Accelerator(seed=4, device="cpu")
    module = load_model("toy_mlp", 10, input_shape=(8, 8, 3))
    model2, opt2 = fresh.prepare(module, SGD(module.parameters(), 0.1))
    assert not np.array_equal(fresh.jax_keys.key, saved[0])
    assert fresh.load_state(model2, opt2, str(tmp_path)) == 1
    np.testing.assert_array_equal(fresh.jax_keys.key, saved[0])
    np.testing.assert_array_equal(model2._bwd_key, saved[1])


# ------------------------------------------ the JAX package resumes it ---

@pytest.mark.parametrize("accum", [1, 2])
def test_jax_run_training_loop_resumes_a_port_run(tmp_path, cpu_devices, accum):
    """The port's train_native trains 2 epochs (ckpt_0, ckpt_1); the JAX
    package's run_training_loop, asked for 2 epochs with auto_resume,
    restores ckpt_1 (no epoch is left to train) and holds the port's
    parameters, optimizer state and step bitwise."""
    training = dict(TRAINING, num_epochs=2, gradient_accumulation_steps=accum)
    _port_run(tmp_path, **training)
    state, history = _jax_native(dict(jax_cfg.TRAINING_DEFAULTS, **training), cpu_devices,
                                 tmp_path, auto_resume=True)
    assert history == []
    data = _arrays(tmp_path / "ckpt_1.npz")
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    for path, leaf in flat:
        key = jax.tree_util.keystr(path)
        if key == ".rng":
            np.testing.assert_array_equal(_data(leaf), data[_PRNG_RNG])
        else:
            np.testing.assert_array_equal(np.asarray(leaf), data[key], err_msg=key)
    assert int(state.step) == 2 * 10 and int(state.opt_state.step) == 2 * 10 // accum
