"""The numerical guard through the port's epoch drivers and checkpoints,
against the JAX package's (``tests/test_guard.py:420-733``), on the CPU at
world 1, from one JAX init:

- ``nan@step=N`` through the native loop: one skipped update, recorded in
  the history row (``skipped_steps``, ``skipped_steps_epoch``, a strict-JSON
  null train loss) and a ``skipped_updates`` event, as the JAX loop records
  it on the same stream;
- rollback to the last good checkpoint when ``max_consecutive_skips`` is
  exceeded (the epochs and events the JAX loop writes), the
  ``max_rollbacks`` bound, and the ``FloatingPointError`` without a
  checkpoint; the periodic audit tripping and a desync rollback
  recovering; the managed driver's rollback;
- the skip counters in both checkpoint kinds, crossing both packages both
  ways, a pre-guard file loading into a guarded run at zeros (with the JAX
  package's warning), an unguarded run not reading them;
- ``training.guard`` through both entry points' workers."""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuddp import nn as jax_nn
from tpuddp import optim as jax_optim
from tpuddp.accelerate import Accelerator as JaxAccelerator
from tpuddp.data import ShardedDataLoader as JaxLoader
from tpuddp.data import SyntheticClassification as JaxSynthetic
from tpuddp.models import ToyMLP as JaxToyMLP
from tpuddp.parallel import make_mesh
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP
from tpuddp.resilience import faults as jax_faults
from tpuddp.resilience import guard as jax_guard
from tpuddp.training import checkpoint as jax_ckpt
from tpuddp.training.loop import run_training_loop as jax_run_training_loop

from tpuddp_torch import config as cfg
from tpuddp_torch import optim
from tpuddp_torch import train_accelerate, train_native
from tpuddp_torch.accelerate import Accelerator
from tpuddp_torch.data import DataLoader, ShardedDataLoader, SyntheticClassification
from tpuddp_torch.models import ToyMLP
from tpuddp_torch.models.convert import state_dict_from_jax
from tpuddp_torch.nn import CrossEntropyLoss
from tpuddp_torch.parallel.ddp import DistributedDataParallel
from tpuddp_torch.resilience import faults
from tpuddp_torch.resilience import guard as guard_lib
from tpuddp_torch.training import checkpoint as ckpt
from tpuddp_torch.training.loop import run_training_loop
from tpuddp_torch.training.pipeline import StagedLoader

KEY = jax.random.key(0)
SHAPE = (8, 8, 3)


@pytest.fixture(autouse=True)
def _isolated_faults():
    torch.set_num_threads(2)
    faults.reload_faults()
    jax_faults.reload_faults()
    yield
    faults.reload_faults()
    jax_faults.reload_faults()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mesh():
    return make_mesh(jax.devices("cpu")[:1])


def jax_wrap(guard):
    ddp = JaxDDP(JaxToyMLP(hidden=(16,)), jax_optim.Adam(1e-2), jax_nn.CrossEntropyLoss(),
                 mesh=_mesh(), guard=guard)
    return ddp, ddp.init_state(KEY, jnp.zeros((1, *SHAPE)))


def port_wrap(jax_state, guard, **kw):
    model = ToyMLP(192, 10, hidden=(16,))
    model.load_state_dict(state_dict_from_jax("toy_mlp", _np(jax_state.params)))
    return DistributedDataParallel(model, optim.Adam(model.parameters(), lr=1e-2),
                                   CrossEntropyLoss(), device="cpu", guard=guard, **kw)


def loaders(n_train, batch=2):
    """tests/test_guard.py's loaders at one replica: synthetic 8x8x3 rows."""
    train = SyntheticClassification(n=n_train, shape=SHAPE, seed=0)
    test = SyntheticClassification(n=4, shape=SHAPE, seed=1)
    return (ShardedDataLoader(train, batch, 0, 1, shuffle=True),
            ShardedDataLoader(test, batch, 0, 1))


def jax_loaders(n_train, batch=2):
    train = JaxSynthetic(n=n_train, shape=SHAPE, seed=0)
    test = JaxSynthetic(n=4, shape=SHAPE, seed=1)
    return (JaxLoader(train, batch, _mesh(), shuffle=True), JaxLoader(test, batch, _mesh()))


def rows(save_dir):
    with open(os.path.join(save_dir, "history.jsonl")) as f:
        raw = f.read()

    def refuse(token):
        raise AssertionError(f"non-strict token {token!r} in history.jsonl")

    return raw, [json.loads(line, parse_constant=refuse) for line in raw.splitlines()]


def _epochs(lines):
    return [r["epoch"] for r in lines if "train_loss" in r]


def _events(lines, name):
    return [r for r in lines if r.get("event") == name]


def _both(monkeypatch, tmp_path, spec, n_train, guard, epochs, scan_steps=2):
    """The port's and the JAX package's loops on the same stream from one
    init, under ``$TPUDDP_FAULT=spec``: each one's history lines and the
    port's wrap."""
    out = {}
    for name in ("port", "jax"):
        monkeypatch.setenv("TPUDDP_FAULT", spec)
        faults.reload_faults()
        jax_faults.reload_faults()
        save_dir = str(tmp_path / name)
        jd, js = jax_wrap(guard)
        if name == "port":
            ddp = port_wrap(js, guard)
            train, test = loaders(n_train)
            run_training_loop(ddp, train, test, save_dir, num_epochs=epochs, checkpoint_epoch=1,
                              scan_steps=scan_steps, log=lambda *_: None)
            out[name] = (rows(save_dir), ddp)
        else:
            train, test = jax_loaders(n_train)
            jax_run_training_loop(jd, js, train, test, save_dir, num_epochs=epochs,
                                  checkpoint_epoch=1, scan_steps=scan_steps,
                                  per_replica_log=False, log=lambda *_: None)
            out[name] = (rows(save_dir), None)
    return out


def test_the_loop_records_a_nan_injection_as_the_jax_loop_does(monkeypatch, tmp_path):
    """tests/test_guard.py:537-571: exactly one skipped update, the row's
    counters, a null train loss, a finite later epoch."""
    out = _both(monkeypatch, tmp_path, "nan@step=3", 16, {"audit_every_n_epochs": 1}, 2)
    (raw, lines), ddp = out["port"]
    (_, jlines), _ = out["jax"]
    epoch_rows = [r for r in lines if "train_loss" in r]
    assert [(r["skipped_steps"], r["skipped_steps_epoch"]) for r in epoch_rows] == [(1, 1), (1, 0)]
    assert [(r["skipped_steps"], r["skipped_steps_epoch"]) for r in jlines if "train_loss" in r] \
        == [(1, 1), (1, 0)]
    assert epoch_rows[0]["train_loss"] is None and epoch_rows[1]["train_loss"] is not None
    assert "NaN" not in raw and "Infinity" not in raw
    assert [(e["epoch"], e["count"], e["total"]) for e in _events(lines, "skipped_updates")] \
        == [(e["epoch"], e["count"], e["total"]) for e in _events(jlines, "skipped_updates")] \
        == [(0, 1, 1)]
    assert all(torch.isfinite(p).all() for p in ddp.model.parameters())
    assert ddp.skip_counters() == (1, 0)


def test_the_loop_rolls_back_to_the_last_good_checkpoint(monkeypatch, tmp_path):
    """tests/test_guard.py:574-603: 4 batches an epoch at scan_steps 2, step
    7 is epoch 1's last update; the rollback redoes epoch 1 from ckpt_0,
    as the JAX loop does."""
    out = _both(monkeypatch, tmp_path, "nan@step=7", 8, {"max_consecutive_skips": 0}, 3)
    (_, lines), ddp = out["port"]
    (_, jlines), _ = out["jax"]
    assert _epochs(lines) == _epochs(jlines) == [0, 1, 1, 2]
    strip = lambda evs: [(e["epoch"], e["resume_epoch"], e["reason"]) for e in evs]  # noqa: E731
    assert strip(_events(lines, "rollback")) == strip(_events(jlines, "rollback")) == [
        (1, 1, "1 consecutive non-finite updates skipped")]
    assert ddp.skip_counters() == (0, 0)  # the restored counters (ckpt_0), then clean epochs


def test_the_rollback_is_logged(monkeypatch, tmp_path):
    monkeypatch.setenv("TPUDDP_FAULT", "nan@step=7")
    _, js = jax_wrap(True)
    ddp = port_wrap(js, {"max_consecutive_skips": 0})
    train, test = loaders(8)
    msgs = []
    run_training_loop(ddp, train, test, str(tmp_path), num_epochs=3, checkpoint_epoch=1,
                      scan_steps=2, log=msgs.append)
    assert any(m.startswith("Guard rollback (1 consecutive non-finite updates skipped): "
                            "restored last-good checkpoint, redoing from epoch 1.") for m in msgs)


def test_the_rollback_limit_raises(monkeypatch, tmp_path):
    """A poison that recurs after each restore: the second rollback is over
    ``max_rollbacks: 1``."""
    monkeypatch.setenv("TPUDDP_FAULT", "nan@step=7,nan@step=11")
    _, js = jax_wrap(True)
    ddp = port_wrap(js, {"max_consecutive_skips": 0, "max_rollbacks": 1})
    train, test = loaders(8)
    with pytest.raises(RuntimeError, match=r"guard rollback limit \(1\) exceeded"):
        run_training_loop(ddp, train, test, str(tmp_path), num_epochs=4, checkpoint_epoch=1,
                          scan_steps=2, log=lambda *_: None)
    _, lines = rows(str(tmp_path))
    assert len(_events(lines, "rollback")) == 1


def test_a_rollback_without_a_checkpoint_raises(monkeypatch):
    """tests/test_guard.py:606-625: one batch an epoch, step 3 poisons epoch
    3's only update and there is nothing to restore."""
    monkeypatch.setenv("TPUDDP_FAULT", "nan@step=3")
    _, js = jax_wrap(True)
    ddp = port_wrap(js, {"max_consecutive_skips": 0})
    train, test = loaders(2)
    with pytest.raises(FloatingPointError, match="no checkpoint"):
        run_training_loop(ddp, train, test, None, num_epochs=6, checkpoint_epoch=1,
                          scan_steps=1, log=lambda *_: None)
    assert ddp.skip_counters() == (1, 1)


def _poison_first_leaf(model):
    """A non-finite parameter: what one world's audit can see of a desync."""
    name, p = guard_lib.jax_leaf_names(model)[0]
    with torch.no_grad():
        p.view(-1)[0] = float("nan")
    return name


def test_the_periodic_audit_trips(tmp_path):
    """tests/test_guard.py:628-650: the epoch-start audit raises
    ReplicaDesync and records the desync event."""
    _, js = jax_wrap(True)
    ddp = port_wrap(js, {"audit_every_n_epochs": 1})
    leaf = _poison_first_leaf(ddp.model)
    train, test = loaders(8)
    with pytest.raises(guard_lib.ReplicaDesync, match="epoch 0 audit") as e:
        run_training_loop(ddp, train, test, str(tmp_path), num_epochs=2, checkpoint_epoch=1,
                          scan_steps=2, log=lambda *_: None)
    assert e.value.leaf == leaf == "[1]['bias']"
    _, lines = rows(str(tmp_path))
    assert [(d["epoch"], d["leaf"]) for d in _events(lines, "desync")] == [(0, leaf)]


def test_a_desync_rollback_recovers(tmp_path):
    """tests/test_guard.py:653-678: with ``on_desync: rollback`` and a
    checkpoint on disk, the audited state is thrown away for the restored
    one, and the run completes clean."""
    guard = {"audit_every_n_epochs": 1, "on_desync": "rollback"}
    _, js = jax_wrap(True)
    ddp = port_wrap(js, guard)
    train, test = loaders(8)
    run_training_loop(ddp, train, test, str(tmp_path), num_epochs=1, checkpoint_epoch=1,
                      scan_steps=2, log=lambda *_: None)
    _poison_first_leaf(ddp.model)
    run_training_loop(ddp, train, test, str(tmp_path), num_epochs=3, checkpoint_epoch=1,
                      scan_steps=2, log=lambda *_: None)
    _, lines = rows(str(tmp_path))
    assert [(e["epoch"], e["resume_epoch"]) for e in _events(lines, "rollback")] == [(0, 1)]
    assert guard_lib.audit_params(ddp.model) is None
    assert _epochs(lines) == [0, 1, 2]


class PoisonEpochOnce:
    """tests/test_guard.py:696-716: the first time epoch 1 starts, every
    sample goes NaN (every update of the epoch skips); the redo is clean."""

    def __init__(self, inner, dataset):
        self.inner, self.dataset = inner, dataset
        self.clean = dataset.images.copy()
        self.fired = False

    def set_epoch(self, e):
        self.inner.set_epoch(e)
        if e == 1 and not self.fired:
            self.fired = True
            self.dataset.images[:] = np.nan
        else:
            self.dataset.images[:] = self.clean

    def __len__(self):
        return len(self.inner)

    def __iter__(self):
        return iter(self.inner)


def test_the_managed_loop_rolls_back_to_the_last_good_state(tmp_path):
    """tests/test_guard.py:681-733 on the port's managed driver: a fully
    poisoned epoch restores ``state_0.npz`` through ``load_state``, records
    the rollback and redoes the epoch."""
    _, js = jax_wrap(True)
    acc = Accelerator(seed=0, device="cpu", guard={"max_consecutive_skips": 0})
    model = ToyMLP(192, 10, hidden=(16,))
    model.load_state_dict(state_dict_from_jax("toy_mlp", _np(js.params)))
    ds = SyntheticClassification(n=32, shape=SHAPE, seed=0)
    model, opt, loader = acc.prepare(model, optim.Adam(model.parameters(), lr=1e-2),
                                     DataLoader(ds, batch_size=8))
    train = StagedLoader(PoisonEpochOnce(loader, ds), acc.device)
    test = StagedLoader(DataLoader(SyntheticClassification(n=8, shape=SHAPE, seed=1),
                                   batch_size=8), acc.device)
    train_accelerate.run_training_loop(
        model, train, test, CrossEntropyLoss(), opt, str(tmp_path), acc, lambda x: x,
        num_epochs=3, checkpoint_epoch=1)
    _, lines = rows(str(tmp_path))
    assert [(e["epoch"], e["resume_epoch"]) for e in _events(lines, "rollback")] == [(1, 1)]
    assert _epochs(lines) == [0, 1, 1, 2]
    first_1 = [r for r in lines if r.get("epoch") == 1 and "train_loss" in r][0]
    assert first_1["skipped_steps_epoch"] == 4 and first_1["train_loss"] is None
    assert opt.skip_counters()[1] == 0
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_the_managed_loop_records_a_nan_injection(monkeypatch, tmp_path):
    """``nan@step=N`` through the managed driver (its staging poisons the
    host micro-batch; with ``fuse_steps`` 4 a flush carries it): one skip
    in epoch 0, a null train loss there, a clean epoch 1."""
    monkeypatch.setenv("TPUDDP_FAULT", "nan@step=2")
    _, js = jax_wrap(True)
    acc = Accelerator(seed=0, device="cpu", guard=True, fuse_steps=4)
    model = ToyMLP(192, 10, hidden=(16,))
    model.load_state_dict(state_dict_from_jax("toy_mlp", _np(js.params)))
    model, opt, loader = acc.prepare(
        model, optim.Adam(model.parameters(), lr=1e-2),
        DataLoader(SyntheticClassification(n=32, shape=SHAPE, seed=0), batch_size=4))
    test = StagedLoader(DataLoader(SyntheticClassification(n=8, shape=SHAPE, seed=1),
                                   batch_size=8), acc.device)
    train_accelerate.run_training_loop(
        model, StagedLoader(loader, acc.device), test, CrossEntropyLoss(), opt, str(tmp_path),
        acc, lambda x: x, num_epochs=2, checkpoint_epoch=5, deferred_metrics=True)
    raw, lines = rows(str(tmp_path))
    epoch_rows = [r for r in lines if "train_loss" in r]
    assert [(r["skipped_steps"], r["skipped_steps_epoch"]) for r in epoch_rows] == [(1, 1), (1, 0)]
    assert epoch_rows[0]["train_loss"] is None and epoch_rows[1]["train_loss"] is not None
    assert [(e["epoch"], e["count"]) for e in _events(lines, "skipped_updates")] == [(0, 1)]
    assert opt.skip_counters() == (1, 0) and "NaN" not in raw


def test_the_managed_loop_without_a_state_file_raises(tmp_path):
    _, js = jax_wrap(True)
    acc = Accelerator(seed=0, device="cpu", guard={"max_consecutive_skips": 0})
    model = ToyMLP(192, 10, hidden=(16,))
    ds = SyntheticClassification(n=16, shape=SHAPE, seed=0)
    ds.images[:] = np.nan
    model, opt, loader = acc.prepare(model, optim.Adam(model.parameters(), lr=1e-2),
                                     DataLoader(ds, batch_size=8))
    test = StagedLoader(DataLoader(SyntheticClassification(n=8, shape=SHAPE, seed=1),
                                   batch_size=8), acc.device)
    with pytest.raises(FloatingPointError, match="no saved state"):
        train_accelerate.run_training_loop(
            model, StagedLoader(loader, acc.device), test, CrossEntropyLoss(), opt,
            str(tmp_path), acc, lambda x: x, num_epochs=2, checkpoint_epoch=5)


# -------------------------------------------------------------- checkpoints --

def _skipped_jax_state(jd, js, skips):
    x = np.random.RandomState(0).randn(8, *SHAPE).astype(np.float32)
    y, w = np.zeros(8, np.int32), np.ones(8, np.float32)
    for bad in skips:
        xb = x.copy()
        if bad:
            xb[0, 0, 0, 0] = np.nan
        js, _ = jd.train_step(js, jd.shard((xb, y, w)))
    return js


def test_native_counters_cross_both_packages(tmp_path):
    """A JAX guarded file (skip, apply, skip, skip: counters (3, 2), one
    Adam step) restores into the port's guarded run, whose next update is
    the JAX package's at that count; the port's file restores into the JAX
    guarded template, counters and step count equal."""
    jd, js = jax_wrap(True)
    js = _skipped_jax_state(jd, js, [True, False, True, True])
    assert jax_guard.read_skip_counters(js) == (3, 2)
    jax_ckpt.save_on_main(str(tmp_path / "a"), 0, js, world_size=1)
    ddp = port_wrap(jax_wrap(True)[1], True)
    ckpt.restore_latest(str(tmp_path / "a"), ddp.model, ddp.optimizer,
                        skipped=ddp.firewall.counters)
    assert ddp.skip_counters() == (3, 2)
    x = np.random.RandomState(1).randn(8, *SHAPE).astype(np.float32)
    batch = (x, np.zeros(8, np.int64), np.ones(8, np.float32))
    ddp.train_step(batch)  # the restored count (1 update) keys the next step
    assert ddp.skip_counters() == (3, 0)
    js2, _ = jd.train_step(js, jd.shard((x, np.zeros(8, np.int32), np.ones(8, np.float32))))
    ref = state_dict_from_jax("toy_mlp", _np(js2.params))
    for k, v in ref.items():
        np.testing.assert_allclose(ddp.model.state_dict()[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    ckpt.save_on_main(str(tmp_path / "b"), 0, ddp.model, ddp.optimizer, 0, step=5,
                      skipped=ddp.firewall.counters)
    with np.load(tmp_path / "b" / "ckpt_0.npz") as z:
        assert int(z[".skipped_steps['total']"]) == 3 and int(z[".opt_state.step"]) == 2
    jd3, template = jax_wrap(True)
    restored, _ = jax_ckpt.restore_latest(str(tmp_path / "b"), template, world_size=1)
    assert jax_guard.read_skip_counters(restored) == (3, 0)
    assert int(restored.opt_state.step) == 2


def test_managed_counters_cross_both_packages(tmp_path):
    """``state_{epoch}.npz``: the JAX Accelerator's counters restore into the
    port's, and the port's into the JAX Accelerator (``load_state``)."""
    mesh = _mesh()
    jacc = JaxAccelerator(mesh=mesh, seed=3, guard=True)
    jmodel, jopt = jacc.prepare(JaxToyMLP(hidden=(16,)), jax_optim.Adam(1e-2))
    crit = jax_nn.CrossEntropyLoss()
    x = np.random.RandomState(0).randn(8, *SHAPE).astype(np.float32)
    y, w = np.zeros(8, np.int32), np.ones(8, np.float32)
    for bad in (False, True):
        xb = x.copy()
        if bad:
            xb[0, 0, 0, 0] = np.nan
        jacc.backward(crit(jmodel(xb), y, w))
        jopt.step()
    assert jopt.skip_counters() == (1, 1)
    jacc.save_state(jmodel, jopt, str(tmp_path / "a"), epoch=0)
    acc = Accelerator(seed=3, device="cpu", guard=True)
    model = ToyMLP(192, 10, hidden=(16,))
    model, opt = acc.prepare(model, optim.Adam(model.parameters(), lr=1e-2))
    assert acc.load_state(model, opt, str(tmp_path / "a")) == 1
    assert opt.skip_counters() == (1, 1)
    loss = CrossEntropyLoss()(model(x), y, w)
    acc.backward(loss)
    opt.step()
    assert opt.skip_counters() == (1, 0)
    acc.save_state(model, opt, str(tmp_path / "b"), epoch=0)
    jacc2 = JaxAccelerator(mesh=mesh, seed=3, guard=True)
    jmodel2, jopt2 = jacc2.prepare(JaxToyMLP(hidden=(16,)), jax_optim.Adam(1e-2))
    jmodel2(x[:1])
    assert jacc2.load_state(jmodel2, jopt2, str(tmp_path / "b")) == 1
    assert jopt2.skip_counters() == (1, 0)
    assert int(jopt2.opt_state.step) == 2


def test_a_pre_guard_file_loads_at_zero_counters(tmp_path, caplog):
    """tests/test_guard.py:435-452 on the port: a file without counters (the
    port's unguarded run, the JAX package's) into a guarded run: zeros, the
    JAX package's warning; the next poisoned step counts from there."""
    jd, js = jax_wrap(False)
    jax_ckpt.save_on_main(str(tmp_path / "jax"), 0, js, world_size=1)
    plain = port_wrap(js, False)
    ckpt.save_on_main(str(tmp_path / "port"), 0, plain.model, plain.optimizer, 0)
    for source in ("jax", "port"):
        with np.load(tmp_path / source / "ckpt_0.npz") as z:
            assert not any("skipped_steps" in k for k in z.files)
        ddp = port_wrap(js, True)
        ddp.firewall.load(5, 2)
        with caplog.at_level(logging.WARNING, logger="tpuddp"):
            ckpt.restore_latest(str(tmp_path / source), ddp.model, ddp.optimizer,
                                skipped=ddp.firewall.counters)
        assert "predates guard state: leaf \".skipped_steps['consecutive']\"" in caplog.text
        assert ddp.skip_counters() == (0, 0)
        x = np.random.RandomState(2).randn(4, *SHAPE).astype(np.float32)
        x[0, 0, 0, 0] = np.nan
        ddp.train_step((x, np.zeros(4, np.int64), np.ones(4, np.float32)))
        assert ddp.skip_counters() == (1, 1)


def test_an_unguarded_run_does_not_read_the_counters(tmp_path):
    jd, js = jax_wrap(True)
    js = _skipped_jax_state(jd, js, [True])
    jax_ckpt.save_on_main(str(tmp_path), 0, js, world_size=1)
    ddp = port_wrap(jax_wrap(False)[1], False)
    ckpt.restore_latest(str(tmp_path), ddp.model, ddp.optimizer)
    assert ddp.skip_counters() == (0, 0) and ddp.firewall is None


def test_the_loop_resumes_the_counters(monkeypatch, tmp_path):
    """A guarded native run's checkpoint carries its counters into a resumed
    run, whose rows continue the totals."""
    monkeypatch.setenv("TPUDDP_FAULT", "nan@step=1")
    _, js = jax_wrap(True)
    ddp = port_wrap(js, True)
    train, test = loaders(8)
    run_training_loop(ddp, train, test, str(tmp_path), num_epochs=1, checkpoint_epoch=1,
                      scan_steps=2, log=lambda *_: None)
    faults.reload_faults()
    monkeypatch.delenv("TPUDDP_FAULT")
    resumed = port_wrap(jax_wrap(True)[1], True)
    run_training_loop(resumed, train, test, str(tmp_path), num_epochs=2, checkpoint_epoch=1,
                      scan_steps=2, auto_resume=True, log=lambda *_: None)
    _, lines = rows(str(tmp_path))
    assert [(r["epoch"], r["skipped_steps"], r["skipped_steps_epoch"])
            for r in lines if "train_loss" in r] == [(0, 1, 1), (1, 1, 0)]


# ------------------------------------------------------------- entry points --

TRAINING = dict(cfg.TRAINING_DEFAULTS, model="toy_mlp", dataset="synthetic",
                synthetic_n=(32, 8), train_batch_size=8, test_batch_size=8, image_size=None,
                flip=False, seed=0, num_epochs=2, checkpoint_epoch=1, prefetch=False,
                guard={"max_consecutive_skips": 0, "audit_every_n_epochs": 1})


@pytest.mark.parametrize("path", ["native", "managed"])
def test_both_entry_points_take_the_guard(tmp_path, path):
    """``training.guard`` through each worker at world 1: the rows carry the
    counters; the managed run's state file carries them too."""
    training = cfg.training_config({"training": {k: v for k, v in TRAINING.items()
                                                 if v != cfg.TRAINING_DEFAULTS.get(k)}})
    worker = (train_native.basic_ddp_training_loop if path == "native"
              else train_accelerate.basic_accelerate_training)
    history = worker(0, 1, str(tmp_path), {}, training=training, device="cpu")
    assert [(r["skipped_steps"], r["skipped_steps_epoch"]) for r in history] == [(0, 0), (0, 0)]
    name = "ckpt_1.npz" if path == "native" else "state_1.npz"
    with np.load(tmp_path / name) as z:
        key = ".skipped_steps['total']" if path == "native" else "['skipped_steps']['total']"
        assert int(z[key]) == 0
