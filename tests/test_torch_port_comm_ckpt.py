"""Checkpoints with a comm hook's error-feedback residual, between the port
and the JAX package, on the CPU: configs/digits_tpu.yaml's block (toy_cnn
with sync_bn at 8 px) with ``int8_ef`` (native), ``bf16_ef`` under ZeRO-1
(native) and ``topk_ef`` (managed), buckets of 2 KB (toy_cnn's 22,058
parameters in five).

- Two Gloo processes: the port's files hold ``.comm_state`` as the JAX
  package's per-replica vector (every rank's residual in the JAX flat
  order, rank after rank, tagged ``per_replica``) and ``['comm_state']`` as
  its tree; the JAX package (on 2 devices) restores them and trains on;
  the port restores the JAX package's files into each rank's residual; a
  resumed port run equals the straight one.
- One process: a residual saved at world 2 is redistributed at world 1
  (the file's two rows summed, a ``topology_change`` event); a file
  without a residual starts it at zero; a ``scan_steps`` chunk with a hook equals its per-batch steps.
- On the card (``cuda``, skipped here): a hooked chunk replayed from a
  CUDA graph equals the same chunk run eagerly, residual included.

Tolerance: bitwise throughout (the layouts only move elements; the chunk
runs the same steps in the same order)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train_accelerate as jax_entry
from tpuddp.accelerate import Accelerator as JaxAccelerator
from tpuddp.data import DataLoader as JaxDataLoader
from tpuddp.data import ShardedDataLoader as JaxLoader
from tpuddp.nn import CrossEntropyLoss as JaxCrossEntropyLoss
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP
from tpuddp.training import checkpoint as jax_ckpt
from tpuddp.training.loop import run_training_loop as jax_run_training_loop

from tpuddp_torch import train_accelerate, train_native
from tpuddp_torch.models import load_model
from tpuddp_torch.models.convert import flat_from_jax, flat_to_jax, torch_layout
from tpuddp_torch.parallel.spawn import run_ddp_training
from tpuddp_torch.training import checkpoint as ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from test_torch_port_optim_train import _env, _np  # noqa: E402
from test_torch_port_zero1_gloo import BASE as ZERO1_BASE  # noqa: E402
from test_torch_port_zero1_gloo import _pieces, jax_init  # noqa: E402

SPAWN_TIMEOUT_S = 400
CAP = 0.002
RAW = TOTAL = 22_058  # even: no padding at world 1 or 2
NATIVE = dict(ZERO1_BASE, weight_update_sharding=False, learning_rate=1e-3, num_epochs=2,
              checkpoint_epoch=1, comm_hook="int8_ef", bucket_cap_mb=CAP)
RUNS = {
    "native": ("native", NATIVE),
    "zero1": ("native", dict(NATIVE, comm_hook="bf16_ef", weight_update_sharding=True)),
    "managed": ("managed", dict(NATIVE, comm_hook="topk_ef")),
}
PREFIX = {"native": "ckpt", "managed": "state"}


def _arrays(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _model():
    return load_model("toy_cnn", 10, input_shape=(8, 8, 3))


def _names():
    return [n for n, _ in _model().named_parameters()]


def _to_jax_order(vec, zero1):
    """A native residual row in the JAX flat order (the port keeps ZeRO-1's
    in its own)."""
    vec = np.array(vec)
    if zero1:
        vec[:RAW] = flat_to_jax("toy_cnn", _model(), vec[:RAW])
    return vec


def _jax_objects(key, devices, init=None):
    """The JAX package's objects for run ``key`` on ``devices``: ``(ddp,
    state)`` native, ``(acc, (model, opt, loader))`` managed (from
    ``init``'s weights when given)."""
    path, training = RUNS[key]
    mesh, train, test, augment, eval_transform, model, opt = _pieces(training, devices)
    hook = training["comm_hook"]
    if path == "native":
        ddp = JaxDDP(model, opt, JaxCrossEntropyLoss(), mesh=mesh, augment=augment,
                     eval_transform=eval_transform, comm_hook=hook, bucket_cap_mb=CAP,
                     weight_update_sharding=training["weight_update_sharding"])
        kw = {} if init is None else dict(params=init[0], model_state=init[1])
        return ddp, ddp.init_state(jax.random.key(0), jnp.zeros((1, 8, 8, 3)), **kw)
    if init is not None:
        model._tpuddp_initial_variables = (init[0], init[1])
    acc = JaxAccelerator(mesh=mesh, seed=0, augment=augment, comm_hook=hook)
    jmodel, jopt, loader = acc.prepare(model, opt, JaxDataLoader(train, 32, shuffle=True))
    jmodel(jnp.zeros((1, 8, 8, 3)))
    return acc, (jmodel, jopt, loader)


def _loaders(key, devices):
    mesh, train, test = _pieces(RUNS[key][1], devices)[:3]
    return mesh, JaxLoader(train, 32, mesh, shuffle=True), JaxLoader(test, 45, mesh, shuffle=True)


def _jax_writes(key, directory, devices, init):
    """One epoch of the JAX package's hooked run with its checkpoint in
    ``directory``."""
    path, _ = RUNS[key]
    if path == "native":
        ddp, state = _jax_objects(key, devices, init)
        _, train, test = _loaders(key, devices)
        jax_run_training_loop(ddp, state, train, test, str(directory), num_epochs=1,
                              checkpoint_epoch=1, log=lambda *_: None)
        return
    acc, (jmodel, jopt, loader) = _jax_objects(key, devices, init)
    loader.set_epoch(0)
    jax_entry.train(jmodel, loader, JaxCrossEntropyLoss(), jopt, acc, None)
    acc.save_state(jmodel, jopt, str(directory), epoch=0)


@pytest.fixture(scope="module")
def init():
    return jax_init(NATIVE)


@pytest.fixture(scope="module")
def world2(tmp_path_factory, cpu_devices, init):
    """The JAX package's files (a 2-device mesh), then one 2-process Gloo
    launch: each run straight, resumed, and the JAX files restored."""
    work = tmp_path_factory.mktemp("comm_ckpt")
    jobs = []
    for key, (path, training) in RUNS.items():
        _jax_writes(key, work / f"jax_{key}", cpu_devices[:2], init)
        for name in (f"{key}_straight", f"{key}_first", f"{key}_from_jax"):
            np.savez(work / f"{name}_init.npz", **{k: v.numpy() for k, v in init[2].items()})
        jobs += [
            {"kind": "run", "name": f"{key}_straight", "path": path, "training": training,
             "save_dir": str(work / f"{key}_straight")},
            {"kind": "run", "name": f"{key}_first", "path": path,
             "training": dict(training, num_epochs=1), "save_dir": str(work / f"{key}_resumed")},
            {"kind": "run", "name": f"{key}_resumed", "path": path, "training": training,
             "save_dir": str(work / f"{key}_resumed"), "resume": True},
            {"kind": "restore", "name": f"{key}_from_jax", "path": path, "training": training,
             "dir": str(work / f"jax_{key}")},
        ]
    (work / "jobs.json").write_text(json.dumps(jobs))
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_port_zero1_worker.py"), str(work)],
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S, env=_env(),
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return work


def _port_residuals(work, name, path):
    return [_arrays(work / f"{name}_residual_{rank}.npz") for rank in range(2)]


@pytest.mark.parametrize("key", sorted(RUNS))
def test_port_files_hold_the_jax_residual_world_2(world2, key):
    path, training = RUNS[key]
    file = _arrays(world2 / f"{key}_straight" / f"{PREFIX[path]}_1.npz")
    topo = json.loads(str(file["__topology__"]))
    rows = _port_residuals(world2, f"{key}_straight", path)
    if path == "managed":
        tree = torch_layout("toy_cnn", ckpt._read_tree(
            "f", file, "['comm_state']", ckpt.jax_from_state_dict("toy_cnn", _model().state_dict())[0]))
        for name in _names():
            for row in rows:  # replicated
                np.testing.assert_array_equal(tree[name], row[name], err_msg=name)
        assert not any("comm_state" in k for k in topo["leaves"])
        return
    stored = file[".comm_state"]
    assert stored.shape == (2 * TOTAL,) and stored.dtype == np.float32
    assert topo["leaves"][".comm_state"] == {"kind": "per_replica", "world": 2, "per": TOTAL,
                                             "model": 1}
    assert topo["placement"][".comm_state"] == ["data"]
    zero1 = training["weight_update_sharding"]
    for rank, row in enumerate(rows):
        np.testing.assert_array_equal(stored[rank * TOTAL:(rank + 1) * TOTAL],
                                      _to_jax_order(row["vec"], zero1))
    assert np.any(stored != 0) and np.any(stored[:TOTAL] != stored[TOTAL:])


@pytest.mark.parametrize("key", sorted(RUNS))
def test_the_jax_package_resumes_a_port_file_world_2(tmp_path, cpu_devices, world2, key):
    path, _ = RUNS[key]
    directory = tmp_path / "run"
    shutil.copytree(world2 / f"{key}_straight", directory)
    file = _arrays(directory / f"{PREFIX[path]}_1.npz")
    devices = cpu_devices[:2]
    if path == "native":
        ddp, like = _jax_objects(key, devices)
        restored, next_epoch = jax_ckpt.restore_latest(str(directory), like, world_size=2)
        assert next_epoch == 2
        np.testing.assert_array_equal(np.asarray(restored.comm_state), file[".comm_state"])
        _, train, test = _loaders(key, devices)
        _, history = jax_run_training_loop(ddp, like, train, test, str(directory), num_epochs=3,
                                           auto_resume=True, log=lambda *_: None)
        assert [r["epoch"] for r in history] == [2] and np.isfinite(history[0]["train_loss"])
        return
    acc, (jmodel, jopt, loader) = _jax_objects(key, devices)
    assert acc.load_state(jmodel, jopt, str(directory)) == 2
    want = _port_residuals(world2, f"{key}_straight", path)[0]
    got = torch_layout("toy_cnn", _np(jopt._comm_state))
    for name in _names():
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    loader.set_epoch(2)
    loss = jax_entry.train(jmodel, loader, JaxCrossEntropyLoss(), jopt, acc, None)[0]
    assert np.isfinite(loss)


@pytest.mark.parametrize("key", sorted(RUNS))
def test_the_port_restores_a_jax_file_world_2(world2, key):
    path, training = RUNS[key]
    file = _arrays(world2 / f"jax_{key}" / f"{PREFIX[path]}_0.npz")
    rows = _port_residuals(world2, f"{key}_from_jax", path)
    if path == "managed":
        tree = torch_layout("toy_cnn", ckpt._read_tree(
            "f", file, "['comm_state']", ckpt.jax_from_state_dict("toy_cnn", _model().state_dict())[0]))
        for row in rows:
            for name in _names():
                np.testing.assert_array_equal(row[name], tree[name], err_msg=name)
        assert any(np.any(v != 0) for v in tree.values())
        return
    stored = file[".comm_state"]
    assert stored.shape == (2 * TOTAL,)
    for rank, row in enumerate(rows):
        want = stored[rank * TOTAL:(rank + 1) * TOTAL].copy()
        if training["weight_update_sharding"]:
            want[:RAW] = flat_from_jax("toy_cnn", _model(), want[:RAW])
        np.testing.assert_array_equal(row["vec"], want, err_msg=f"rank {rank}")


@pytest.mark.parametrize("key", sorted(RUNS))
def test_a_resumed_port_run_equals_the_straight_run_world_2(world2, key):
    path, _ = RUNS[key]
    a = _arrays(world2 / f"{key}_straight" / f"{PREFIX[path]}_1.npz")
    b = _arrays(world2 / f"{key}_resumed" / f"{PREFIX[path]}_1.npz")
    assert sorted(a) == sorted(b) and any("comm_state" in k for k in a)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for x, y in zip(*(_port_residuals(world2, f"{key}_{n}", path) for n in ("straight", "resumed"))):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


# ------------------------------------------------------------- one process --

def test_a_per_replica_residual_of_another_world_is_refused(world2):
    """...as a refusal no more: the JAX package's world-2 residual restores
    at world 1, the file's two rows summed (the elastic restore), with a
    ``topology_change`` row."""
    torch.set_num_threads(2)
    ddp, *_ = train_native.build_training(0, 1, NATIVE, "cpu")
    log = []
    ckpt.restore_latest(str(world2 / "jax_native"), ddp.model, ddp.optimizer,
                        comm_state=ddp.residual, reshard_log=log)
    path, _ = ckpt.latest(str(world2 / "jax_native"))
    rows = _arrays(path)[".comm_state"].reshape(2, TOTAL)
    assert np.any(rows[0] != rows[1])
    np.testing.assert_array_equal(ddp.residual.numpy(), rows[0] + rows[1])
    assert [(e["event"], e["from_world"], e["to_world"], e["residual"], e["resharded_leaves"])
            for e in log] == [("topology_change", 2, 1, "redistributed", [".comm_state"])]


@pytest.mark.parametrize("path", ["native", "managed"])
def test_a_file_without_a_residual_starts_it_at_zero(tmp_path, path):
    """The JAX package's forward-compatible load: a file of a run without
    error feedback (here the port's) into a hooked run."""
    torch.set_num_threads(2)
    plain = dict(NATIVE, comm_hook="none", num_epochs=1)
    worker = (train_native.basic_ddp_training_loop if path == "native"
              else train_accelerate.basic_accelerate_training)
    from functools import partial

    run_ddp_training(partial(worker, training=plain, device="cpu"), 1, str(tmp_path), {},
                     backend="cpu")
    if path == "native":
        ddp, *_ = train_native.build_training(0, 1, NATIVE, "cpu")
        ddp.residual.fill_(1.0)
        assert ckpt.restore_latest(str(tmp_path), ddp.model, ddp.optimizer,
                                   comm_state=ddp.residual)[0] == 1
        assert not ddp.residual.any()
        return
    acc, model, opt, *_ = train_accelerate.build_training(dict(NATIVE, comm_hook="int8_ef"), "cpu")
    for r in opt.comm_residual():
        r.fill_(1.0)
    assert acc.load_state(model, opt, str(tmp_path)) == 1
    assert not any(r.any() for r in opt.comm_residual())


def _batches(n, rows=16, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return [(torch.randint(0, 256, (rows, 8, 8, 3), dtype=torch.uint8, generator=gen).numpy(),
             torch.randint(0, 10, (rows,), generator=gen).numpy(),
             (torch.rand(rows, generator=gen) < 0.9).float().numpy()) for _ in range(n)]


def _hooked_ddp(hook, accum, device="cpu", zero1=False):
    from tpuddp_torch import optim
    from tpuddp_torch.data.transforms import make_train_augment
    from tpuddp_torch.nn import CrossEntropyLoss
    from tpuddp_torch.nn.norm import convert_sync_batchnorm
    from tpuddp_torch.parallel.ddp import DistributedDataParallel

    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(2)
    model = convert_sync_batchnorm(_model())
    return DistributedDataParallel(
        model, optim.Adam(model.parameters(), lr=1e-3), CrossEntropyLoss(),
        augment=make_train_augment(size=None, flip=True, generator=gen), device=device,
        grad_accumulation=accum, generator=gen, comm_hook=hook, bucket_cap_mb=CAP,
        weight_update_sharding=zero1)


def _state(ddp):
    out = [t.detach().clone() for t in ddp.model.state_dict().values()]
    out += [t.clone() for st in ddp.optimizer.state.values() for t in st.values() if torch.is_tensor(t)]
    return out + ([] if ddp.residual is None else [ddp.residual.clone()])


@pytest.mark.parametrize("hook,accum,zero1", [
    ("bf16", 1, False), ("bf16_ef", 1, False), ("int8_ef", 1, False), ("topk_ef", 1, False),
    ("int8_ef", 2, False), ("topk_ef", 1, True),
])
def test_a_hooked_chunk_equals_its_per_batch_run(hook, accum, zero1):
    """``train_step_many`` over 8 batches against the same steps one per
    call (one cycle per call under accumulation): parameters, buffers,
    moments, the residual and the sums, bitwise."""
    torch.set_num_threads(2)
    batches = _batches(8)
    chunked = _hooked_ddp(hook, accum, zero1=zero1)
    sums = chunked.train_step_many(batches)
    single = _hooked_ddp(hook, accum, zero1=zero1)
    step_sums = torch.zeros(2)
    for i in range(0, 8, accum):
        step_sums = step_sums + (single.train_step(batches[i]) if accum == 1
                                 else single.train_cycle(batches[i:i + accum]))
    a, b = _state(chunked), _state(single)
    assert len(a) == len(b) and (chunked.residual is None) == (hook == "bf16")
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    torch.testing.assert_close(sums, step_sums, rtol=0, atol=0)


# ------------------------------------------------------------ on the card --

@pytest.fixture()
def card():
    """The GPU, with cuDNN's deterministic algorithms as the entry points
    run them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = deterministic


@pytest.mark.cuda
@pytest.mark.parametrize("hook,zero1", [("bf16_ef", False), ("int8_ef", False),
                                        ("topk_ef", False), ("bf16_ef", True)])
def test_a_hooked_chunk_replay_equals_its_eager_run(card, hook, zero1):
    """3 chunks of 4 steps through CUDA-graph replay against the same
    chunks run eagerly: the state, the residual and the sums, bitwise."""
    batches = _batches(12)
    out = {}
    for replay in (False, True):
        ddp = _hooked_ddp(hook, 1, device="cuda", zero1=zero1)
        ddp._graph_replay = replay
        sums = None
        for c in range(3):
            sums = ddp.train_step_many(batches[4 * c:4 * (c + 1)], sums)
        torch.cuda.synchronize()
        out[replay] = (_state(ddp), sums.clone())
    (a, sa), (b, sb) = out[False], out[True]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    torch.testing.assert_close(sa, sb, rtol=0, atol=0)
