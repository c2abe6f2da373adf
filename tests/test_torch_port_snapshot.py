"""Step snapshots of the port (``tpuddp_torch/training/snapshot.py``) and
the v4 checkpoint file against the JAX package, on the CPU: the config
block's resolution and errors, the epoch plan key, the cursor both ways,
the freshest-file choice across step and epoch families and peer copies,
the async writer against a synchronous save (byte for byte), a full engine
skipping, peer spill and restore, and a JAX step snapshot resumed by the
port and the port's by the JAX package. Mirrors ``tests/test_snapshot.py``.

Tolerances: files, keys, cursors, picks and error texts equal; the
async/sync files byte-identical. A resume across the packages continues at
the snapshot's step (zero batches replayed, the log says so) and ends
within the bounds of tests/test_torch_port_resume_continuity.py (losses
rtol 1e-4, parameters rtol 1e-4 / atol 1e-5: two libraries summing in
another order over an epoch of Adam steps)."""

import json
import logging
import os
import shutil
import threading
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuddp import optim as jax_optim
from tpuddp.data import ShardedDataLoader as JaxLoader
from tpuddp.data import transforms as jax_tf
from tpuddp.data.synthetic import synthetic_uint8_datasets as jax_synthetic_uint8
from tpuddp.models import load_model as jax_load_model
from tpuddp.nn import CrossEntropyLoss as JaxCrossEntropyLoss
from tpuddp.observability import schema as jax_schema
from tpuddp.parallel import make_mesh
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP
from tpuddp.resilience import preemption as jax_preemption
from tpuddp.training import checkpoint as jax_ckpt
from tpuddp.training import snapshot as jax_snap
from tpuddp.training.loop import run_training_loop as jax_run_training_loop

from tpuddp_torch import config as cfg_lib
from tpuddp_torch.data import PrefetchLoader, ShardedDataLoader
from tpuddp_torch.data.synthetic import synthetic_uint8_datasets
from tpuddp_torch.models import load_model
from tpuddp_torch.models.convert import jax_leaf_index, state_dict_from_jax
from tpuddp_torch.observability import schema
from tpuddp_torch.optim import Adam
from tpuddp_torch.parallel.spawn import run_ddp_training
from tpuddp_torch.resilience import preemption
from tpuddp_torch.train_native import basic_ddp_training_loop
from tpuddp_torch.training import checkpoint as ckpt
from tpuddp_torch.training import snapshot as snap
from tpuddp_torch.training.pipeline import StagedLoader

torch.set_num_threads(2)
LOSS_RTOL, P_RTOL, P_ATOL = 1e-4, 1e-4, 1e-5


# ------------------------------------------------------------------ config

@pytest.mark.parametrize("block", [
    None, False, True, {}, {"every_steps": 3, "async": False}, {"every_steps": 0},
    {"inflight": 5, "peer_redundancy": True},
    {"every_step": 3}, "every 5", {"every_steps": -1}, {"inflight": 0},
])
def test_resolve_snapshot_is_the_jax_packages(block):
    try:
        theirs = jax_snap.resolve_snapshot(block)
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            snap.resolve_snapshot(block)
        assert str(ours.value) == str(e)
        return
    ours = snap.resolve_snapshot(block)
    assert (ours.as_dict(), ours.enabled) == (theirs.as_dict(), theirs.enabled)
    assert snap.resolve_snapshot(ours) is ours


# ---------------------------------------------------------------- plan key

def _port_loader(seed=0, batch=8, n=96):
    train, _ = synthetic_uint8_datasets(n, 16)
    return ShardedDataLoader(train, batch, 0, 1, shuffle=True, seed=seed)


def _jax_loader(cpu_devices, seed=0, batch=8, n=96):
    train, _ = jax_synthetic_uint8(n, 16)
    return JaxLoader(train, batch, make_mesh(cpu_devices[:1]), shuffle=True, seed=seed)


@pytest.mark.parametrize("epoch", [0, 3])
def test_epoch_plan_key_is_the_jax_packages(cpu_devices, epoch):
    """The same loader settings give the JAX key through every wrapper the
    entry points put around the loader; anything that changes the batch
    order changes it."""
    want = jax_snap.epoch_plan_key(_jax_loader(cpu_devices), epoch)
    loader = _port_loader()
    for wrapped in (loader, PrefetchLoader(loader, workers=2),
                    StagedLoader(PrefetchLoader(loader), "cpu"), snap.EpochTailLoader(loader, 0)):
        assert snap.epoch_plan_key(wrapped, epoch) == want
    assert snap.epoch_plan_key(loader, epoch + 1) != want
    assert snap.epoch_plan_key(_port_loader(seed=7), epoch) == jax_snap.epoch_plan_key(
        _jax_loader(cpu_devices, seed=7), epoch) != want
    assert snap.epoch_plan_key(_port_loader(batch=16), epoch) != want


def test_epoch_tail_loader_replays_no_batch():
    loader = _port_loader()
    fetched = []
    steps, fetch = loader.make_batch_plan()

    class Planned:
        def __len__(self):
            return steps

        def make_batch_plan(self):
            return steps, lambda s: fetched.append(s) or fetch(s)

    tail = snap.EpochTailLoader(Planned(), 9)
    assert len(tail) == 3
    got = list(tail)
    assert fetched == [9, 10, 11]  # the applied prefix never assembled
    for a, b in zip(got, list(loader)[9:]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert [int(b[1][0]) for b in snap.EpochTailLoader(list(loader), 10)] == \
        [int(b[1][0]) for b in list(loader)[10:]]  # a loader without a plan: skipped
    assert snap.acc_from_cursor(None) is None
    assert snap.acc_from_cursor({"acc": {"['loss_sum']": 1.5, "n": 2.0}}) == {"loss_sum": 1.5, "n": 2.0}


# ------------------------------------------------------------------ cursor

def _toy():
    torch.manual_seed(0)
    model = load_model("toy_mlp", 10, input_shape=(32, 32, 3))
    leaf = jax_leaf_index("toy_mlp", model)
    opt = Adam(model.parameters(), lr=1e-2, leaf_index=[leaf[n] for n, _ in model.named_parameters()])
    x = torch.randn(4, 32, 32, 3)
    model(x).sum().backward()
    opt.step()
    return model, opt


def _jax_state(cpu_devices):
    ddp = JaxDDP(jax_load_model("toy_mlp", 10), jax_optim.Adam(), JaxCrossEntropyLoss(),
                 mesh=make_mesh(cpu_devices[:1]))
    return ddp.init_state(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))


ACC = {"loss_sum": np.asarray([1.5], np.float32), "n": np.asarray([192.0], np.float32)}


def test_the_cursor_round_trips_both_ways(tmp_path, cpu_devices):
    model, opt = _toy()
    cursor = {"version": ckpt.FORMAT_VERSION, "epoch": 2, "step": 6, "plan_key": "abcd" * 4}
    path = ckpt.save_on_main(str(tmp_path / "port"), 2, model, opt, 0, snapshot_step=6,
                             cursor=cursor, cursor_acc=ACC)
    assert os.path.basename(path) == "ckpt_2_s6.npz"
    assert ckpt.read_meta(path) == jax_ckpt.read_meta(path) == {"epoch": 2, "completed": 0, "step": 6}
    ours, theirs = ckpt.read_cursor(path), jax_ckpt.read_cursor(path)
    assert {k: v for k, v in ours.items() if k != "acc"} == \
        {k: v for k, v in theirs.items() if k != "acc"} == cursor
    for got in (snap.acc_from_cursor(ours), jax_snap.acc_from_cursor(theirs)):
        assert sorted(got) == ["loss_sum", "n"]
        for k in ACC:
            np.testing.assert_array_equal(got[k], ACC[k])
    # the JAX package's step snapshot, read by the port
    jpath = jax_ckpt.save_on_main(str(tmp_path / "jax"), 1, _jax_state(cpu_devices), step=4,
                                  cursor=dict(cursor, epoch=1, step=4),
                                  cursor_acc={k: jnp.asarray(v) for k, v in ACC.items()},
                                  world_size=1)
    assert ckpt.read_cursor(jpath) == {**jax_ckpt.read_cursor(jpath),
                                       "acc": ckpt.read_cursor(jpath)["acc"]}
    np.testing.assert_array_equal(snap.acc_from_cursor(ckpt.read_cursor(jpath))["n"], ACC["n"])
    # a full-epoch file carries none
    assert ckpt.read_cursor(ckpt.save_on_main(str(tmp_path / "port"), 2, model, opt, 0)) is None


def test_the_freshest_file_is_the_jax_packages_pick(tmp_path, cpu_devices, caplog):
    """Files of both packages in one directory: the port and the JAX
    package pick the same one, and a full-epoch file outranks its epoch's
    step snapshots."""
    model, opt = _toy()
    state = _jax_state(cpu_devices)
    d = str(tmp_path)
    ckpt.save_on_main(d, 0, model, opt, 0)
    jax_ckpt.save_on_main(d, 1, state, step=4, cursor={"epoch": 1, "step": 4, "plan_key": "k1"},
                          world_size=1)
    ckpt.save_on_main(d, 1, model, opt, 0, snapshot_step=2,
                      cursor={"epoch": 1, "step": 2, "plan_key": "k0"})
    picks = []
    for _ in range(2):
        ours, theirs = ckpt._latest_any(d), jax_ckpt._latest_any(d)
        assert ours == theirs
        picks.append(os.path.basename(ours[0]))
        cursors = []
        with caplog.at_level(logging.WARNING, logger="tpuddp"):
            nxt, _ = ckpt.restore_latest(d, model, opt, cursor_out=cursors)
        jcursors = []
        _, jnxt = jax_ckpt.restore_latest(d, state, cursor_out=jcursors)
        assert nxt == jnxt
        assert [(c["step"], c["plan_key"], c["provenance"]) for c in cursors] == \
            [(c["step"], c["plan_key"], c["provenance"]) for c in jcursors]
        jax_ckpt.save_on_main(d, 1, state, world_size=1)  # epoch 1 done: outranks its steps
    assert picks == ["ckpt_1_s4.npz", "ckpt_1.npz"]
    assert any("zero batches replayed" in r.message for r in caplog.records)


# ------------------------------------------------------------------ engine

def _capture(model, opt):
    return lambda: ckpt.capture(model, opt, seed=0, step=6)


def _acc():
    return {k: torch.from_numpy(v.copy()) for k, v in ACC.items()}


def test_an_async_snapshot_is_byte_identical_to_a_sync_save(tmp_path):
    """The engine's writer thread, its inline mode and a direct synchronous
    save of the same state and cursor publish the same bytes (payload and
    manifest); the writer's statistics live in a sidecar."""
    model, opt = _toy()
    blobs, manifests = {}, {}
    for mode, async_writes in (("async", True), ("sync", False)):
        engine = snap.SnapshotEngine(str(tmp_path / mode),
                                     snap.SnapshotConfig(every_steps=4, async_writes=async_writes))
        assert engine.maybe(_capture(model, opt), epoch=0, step=4, plan_key="pk" * 8, acc=_acc())
        assert engine.flush() == 4
        engine.close()
    ckpt.save_on_main(str(tmp_path / "direct"), 0, model, opt, 0, seed=0, step=6, snapshot_step=4,
                      cursor={"version": ckpt.FORMAT_VERSION, "epoch": 0, "step": 4,
                              "plan_key": "pk" * 8}, cursor_acc=ACC)
    for mode in ("async", "sync", "direct"):
        blobs[mode] = (tmp_path / mode / "ckpt_0_s4.npz").read_bytes()
        manifests[mode] = (tmp_path / mode / "ckpt_0_s4.npz.sha256").read_bytes()
    assert blobs["async"] == blobs["sync"] == blobs["direct"]
    assert manifests["async"] == manifests["sync"] == manifests["direct"]
    stats = snap.read_writer_stats(str(tmp_path / "async" / "ckpt_0_s4.npz"))
    assert stats["snapshots"] == 1 and stats["async"] is True
    with np.load(tmp_path / "async" / "ckpt_0_s4.npz") as f:
        assert not any("writer" in k for k in f.files)
    # and the JAX package reads it as its own step snapshot
    assert jax_ckpt.read_cursor(str(tmp_path / "async" / "ckpt_0_s4.npz"))["step"] == 4


def test_a_full_engine_skips_without_waiting(tmp_path, monkeypatch):
    """``inflight: 1`` with the writer wedged: a due snapshot is skipped,
    counted, and ``maybe`` returns at once."""
    model, opt = _toy()
    gate = threading.Event()
    real = ckpt.write_captured

    def slow(*args, **kwargs):
        gate.wait(timeout=30)
        return real(*args, **kwargs)

    monkeypatch.setattr(ckpt, "write_captured", slow)
    engine = snap.SnapshotEngine(str(tmp_path), snap.SnapshotConfig(every_steps=1, inflight=1))
    try:
        assert engine.maybe(_capture(model, opt), epoch=0, step=1, plan_key="pk")
        t0 = time.perf_counter()
        assert not engine.maybe(_capture(model, opt), epoch=0, step=2, plan_key="pk")
        assert time.perf_counter() - t0 < 1.0
        assert engine.stats["skipped_queue_full"] == 1
    finally:
        gate.set()
        engine.close()
    assert engine.stats["snapshots"] == 1 and engine.stats["last_step"] == 1


def test_peer_copies_restore_a_lost_or_corrupt_local_file(tmp_path, monkeypatch, caplog):
    """``peer_redundancy`` spills each snapshot into the ring neighbour's
    directory under the heartbeat channel; with the local file gone, or
    torn, the port and the JAX package restore the peer copy, and say so."""
    hb = tmp_path / "hb"
    monkeypatch.setenv("TPUDDP_HEARTBEAT_DIR", str(hb))
    model, opt = _toy()
    local = tmp_path / "run"
    engine = snap.SnapshotEngine(str(local), snap.SnapshotConfig(
        every_steps=2, async_writes=False, peer_redundancy=True))
    assert engine.maybe(_capture(model, opt), epoch=0, step=2, plan_key="pk", acc=_acc())
    engine.close()
    peer = hb / "peer_ckpt" / "ring_0" / "ckpt_0_s2.npz"
    assert peer.read_bytes() == (local / "ckpt_0_s2.npz").read_bytes()
    assert ckpt.peer_checkpoint_dirs(str(local)) == jax_ckpt.peer_checkpoint_dirs(str(local)) == [
        str(hb / "peer_ckpt" / "ring_0")]
    with open(local / "ckpt_0_s2.npz", "r+b") as f:  # torn: the manifest no longer matches
        f.write(b"\x00CHAOS\x00")
        f.truncate(64)
    assert ckpt._latest_any(str(local))[1:] == jax_ckpt._latest_any(str(local))[1:] == (
        0, 2, "peer:ring_0")
    os.remove(local / "ckpt_0_s2.npz")
    os.remove(local / "ckpt_0_s2.npz.sha256")
    want = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    cursors = []
    with caplog.at_level(logging.WARNING, logger="tpuddp"):
        assert ckpt.restore_latest(str(local), model, opt, cursor_out=cursors)[0] == 0
    assert cursors[0]["provenance"] == "peer:ring_0" and cursors[0]["step"] == 2
    assert any("provenance=peer:ring_0" in r.message for r in caplog.records)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_an_engine_at_world_2_disarms(tmp_path, caplog):
    with caplog.at_level(logging.WARNING, logger="tpuddp"):
        engine = snap.SnapshotEngine(str(tmp_path), snap.SnapshotConfig(every_steps=1),
                                     world_size=2)
    assert not engine.armed and "disarmed" in engine.describe()
    assert not engine.maybe(lambda: pytest.fail("no capture at world 2"), epoch=0, step=1, plan_key="k")
    engine.close()
    assert any("snapshot engine disarmed" in r.message for r in caplog.records)


def test_run_meta_and_the_preempt_event_validate_in_both_packages():
    engine = snap.SnapshotEngine("/nonexistent", snap.resolve_snapshot({"every_steps": 3}))
    meta = schema.make_run_meta(world_size=1, comm_hook="none", snapshot=engine.describe())
    off = schema.make_run_meta(world_size=1, comm_hook="none")
    assert meta["snapshot"] == {"every_steps": 3, "async": True, "inflight": 2,
                                "peer_redundancy": False, "prefix": "ckpt"}
    assert off["snapshot"] is False
    good = schema.stamp("event", {"event": "preempt", "epoch": 0, "completed": False, "step": 5,
                                  "snapshot_step": 5})
    bad = schema.stamp("event", {"event": "preempt", "epoch": 0})
    for validate in (schema.validate_history_records, jax_schema.validate_history_records):
        assert validate([meta, good]) == [] and validate([off]) == []
    errors = schema.validate_history_records([meta, bad])
    assert any("missing field(s) ['completed', 'step']" in e for e in errors), errors


# ------------------------------------------------ resume across packages --

TRAINING = dict(cfg_lib.TRAINING_DEFAULTS, model="toy_mlp", dataset="synthetic",
                synthetic_n=(96, 32), train_batch_size=8, test_batch_size=16, image_size=None,
                flip=False, seed=0, num_epochs=1, checkpoint_epoch=1, scan_steps=1,
                snapshot={"every_steps": 2})


def _jax_run(save_dir, cpu_devices, preempt_after=None, logs=None):
    """The JAX package's native toy_mlp run of :data:`TRAINING` (world 1),
    resuming from ``save_dir``; with ``preempt_after`` its drain is asked for
    as that train batch is drawn."""
    train, test = jax_synthetic_uint8(*TRAINING["synthetic_n"])
    mesh = make_mesh(cpu_devices[:1])
    ddp = JaxDDP(jax_load_model("toy_mlp", 10), jax_optim.Adam(TRAINING["learning_rate"]),
                 JaxCrossEntropyLoss(), mesh=mesh,
                 augment=jax_tf.make_train_augment(size=None, flip=False),
                 eval_transform=jax_tf.make_eval_transform(size=None))
    # a typed key: the template a port file restores into (its key leaf is typed)
    state = ddp.init_state(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    loader = JaxLoader(train, TRAINING["train_batch_size"], mesh, shuffle=True)

    class Preempting:
        def __init__(self, inner):
            self.inner = inner

        def __len__(self):
            return len(self.inner)

        def __getattr__(self, name):
            return getattr(self.inner, name)

        def __iter__(self):
            for i, batch in enumerate(self.inner):
                if i == preempt_after:
                    jax_preemption.request_preemption()
                yield batch

    return jax_run_training_loop(
        ddp, state, loader if preempt_after is None else Preempting(loader),
        JaxLoader(test, TRAINING["test_batch_size"], mesh, shuffle=True), save_dir,
        num_epochs=TRAINING["num_epochs"], checkpoint_epoch=1, auto_resume=True, scan_steps=1,
        snapshot=TRAINING["snapshot"], log=(lambda *a: logs.append(" ".join(map(str, a))))
        if logs is not None else (lambda *_: None),
    )


def _port_run(save_dir, **extra):
    return run_ddp_training(partial(basic_ddp_training_loop, training=dict(TRAINING, **extra),
                                    device="cpu"), 1, save_dir, {}, backend="cpu")


@pytest.fixture
def drains(monkeypatch):
    monkeypatch.setenv("TPUDDP_PREEMPT_GRACE", "3600")
    monkeypatch.delenv("TPUDDP_AUTO_RESUME", raising=False)
    preemption.reset_preemption()
    jax_preemption.reset_preemption()
    yield
    preemption.reset_preemption()
    jax_preemption.reset_preemption()


def _step_file(d):
    """The newest step snapshot of epoch 0 in ``d``."""
    names = [f for f in os.listdir(d) if f.startswith("ckpt_0_s") and f.endswith(".npz")]
    return os.path.join(d, max(names, key=lambda f: int(f[len("ckpt_0_s"):-4])))


def _assert_params_close(model_file, want_state, name="toy_mlp"):
    model = load_model(name, 10, input_shape=(32, 32, 3))
    ckpt.load(model_file, model)
    want = state_dict_from_jax(name, jax.tree_util.tree_map(np.asarray, want_state.params),
                               jax.tree_util.tree_map(np.asarray, want_state.model_state))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=P_RTOL, atol=P_ATOL, err_msg=k)


def test_the_port_resumes_a_jax_step_snapshot_at_its_step(tmp_path, cpu_devices, drains, capsys):
    """The JAX package drains mid-epoch into a step snapshot; the port and
    the JAX package each continue that epoch at the cursor's step (the plan
    keys match, zero batches replayed) and end alike."""
    first = str(tmp_path / "first")
    with pytest.raises(jax_preemption.TrainingPreempted):
        _jax_run(first, cpu_devices, preempt_after=5)
    jax_preemption.reset_preemption()
    step = ckpt.read_cursor(_step_file(first))["step"]
    assert 0 < step < 12
    by_jax, by_port = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(first, by_jax)
    shutil.copytree(first, by_port)
    logs = []
    state, jax_history = _jax_run(by_jax, cpu_devices, logs=logs)
    assert f"Exact resume: epoch 0 continues at step {step} (zero batches replayed)." in logs
    capsys.readouterr()
    history = _port_run(by_port, resume=True)
    assert f"Exact resume: epoch 0 continues at step {step} (zero batches replayed)." in \
        capsys.readouterr().out.splitlines()
    assert [r["epoch"] for r in history] == [r["epoch"] for r in jax_history] == [0]
    for a, b in zip(history, jax_history):
        for key in ("train_loss", "test_loss", "train_samples"):
            np.testing.assert_allclose(a[key], b[key], rtol=LOSS_RTOL, err_msg=key)
    _assert_params_close(os.path.join(by_port, "ckpt_0.npz"), state)


def test_the_jax_package_resumes_a_port_step_snapshot_at_its_step(tmp_path, cpu_devices, drains,
                                                                  monkeypatch):
    """The port drains mid-epoch (``preempt@step=7``) into a step snapshot;
    the JAX package continues that epoch at the cursor's step and ends as
    the port's own resume does."""
    first = str(tmp_path / "first")
    monkeypatch.setenv("TPUDDP_FAULT", "preempt@step=7")
    from tpuddp_torch.resilience import faults

    faults.reload_faults()
    try:
        with pytest.raises(SystemExit) as exit_:
            _port_run(first)
    finally:
        monkeypatch.delenv("TPUDDP_FAULT")
        faults.reload_faults()
        preemption.reset_preemption()
    assert exit_.value.code == preemption.EXIT_PREEMPTED
    step = ckpt.read_cursor(_step_file(first))["step"]
    assert 0 < step < 12
    by_jax, by_port = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(first, by_jax)
    shutil.copytree(first, by_port)
    logs = []
    state, jax_history = _jax_run(by_jax, cpu_devices, logs=logs)
    assert f"Exact resume: epoch 0 continues at step {step} (zero batches replayed)." in logs
    history = _port_run(by_port, resume=True)
    assert [r["epoch"] for r in history] == [r["epoch"] for r in jax_history] == [0]
    for a, b in zip(history, jax_history):
        for key in ("train_loss", "test_loss", "train_samples"):
            np.testing.assert_allclose(a[key], b[key], rtol=LOSS_RTOL, err_msg=key)
    _assert_params_close(os.path.join(by_port, "ckpt_0.npz"), state)
    with open(os.path.join(first, "history.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert records[-1]["event"] == "preempt" and records[-1]["snapshot_step"] == step
    assert jax_schema.validate_history_records(records) == []
