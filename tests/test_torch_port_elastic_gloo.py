"""The elastic restart of the port end to end, through its entry points on
Gloo processes on the CPU, with configs/digits_tpu.yaml's block (toy_cnn
with sync_bn on the 8 px digits, seed 0) and ``comm_hook: bf16_ef``:

- ``python -m tpuddp_torch.train_native`` at world 2 with
  ``preempt@epoch=1`` exits 75 with ``ckpt_1.npz`` (a world-2
  ``per_replica`` residual); resumed at world 1 (the per-replica batch
  doubled, the global batch kept) it writes a ``topology_change`` row
  (``redistributed``), a header with ``resumed_from_world`` 2, and each
  epoch once, its losses within the JAX chaos test's rtol = atol = 0.05
  (``tests/test_chaos.py:369-380``) of an uninterrupted world-2 run, epoch
  0 equal; resumed at world 3 instead, a ``comm_state_reset`` row; the
  history validates with the port's validator;
- the same file restored at world 1 by the JAX package's ``restore_latest``
  (a bf16_ef ``DistributedDataParallel`` on one CPU device) and by the
  port: the residual (the float32 sum of the file's rows), the parameters
  and the moments, bitwise;
- resumed at world 1 under the guard with epoch 1's last update poisoned,
  the rollback restores the world-2 file again and writes its
  ``topology_change`` row after the ``rollback`` row;
- ``python -m tpuddp_torch.train_accelerate`` with ZeRO-1 (11 classes: an
  odd parameter count, so the flat moments re-pad) at world 2, resumed at
  world 1: the ``['opt_state']`` moments in ``resharded_leaves``;
- ``python -m tpuddp_torch.supervise --world 1`` over the native entry
  point with ``corrupt@ckpt_1,crash@epoch=2`` on the first attempt (3
  epochs, toy_mlp): attempt 0 exits 113, attempt 1 resumes from
  ``ckpt_0.npz`` (``ckpt_1.npz`` torn, skipped) and the supervisor exits 0.

Tolerances: the resumed losses rtol = atol = 0.05 of the straight run's (the
world-1 epoch sums the same global batches in another order, with another
bf16 rounding); the restores bitwise."""

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

from tpuddp.nn import CrossEntropyLoss as JaxCrossEntropyLoss
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP
from tpuddp.training import checkpoint as jax_ckpt

from tpuddp_torch import config as cfg
from tpuddp_torch import train_native
from tpuddp_torch.observability import validate_history_file
from tpuddp_torch.training import checkpoint as ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from test_torch_port_zero1_gloo import BASE, _pieces  # noqa: E402

RUN_TIMEOUT_S = 300
NATIVE = dict(BASE, weight_update_sharding=False, learning_rate=1e-3, num_epochs=2,
              checkpoint_epoch=1, comm_hook="bf16_ef", bucket_cap_mb=0.002)
MANAGED = dict(BASE, num_classes=11, learning_rate=1e-3, num_epochs=1, checkpoint_epoch=1)
SUPERVISED = dict(NATIVE, model="toy_mlp", sync_bn=False, num_epochs=3)


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    for var in ("TPUDDP_WORLD_SIZE", "TPUDDP_FAULT", "TPUDDP_AUTO_RESUME",
                "TPUDDP_WATCHDOG_TIMEOUT", "TPUDDP_HEARTBEAT_DIR", "TPUDDP_MODEL_SIZE"):
        env.pop(var, None)
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _settings(path, out, training, world):
    with open(path, "w") as f:  # JSON is YAML
        json.dump({"out_dir": str(out), "local": {"device": "cpu", "gpu": {"num_gpus": world}},
                   "training": {k: v for k, v in training.items()
                                if v != cfg.TRAINING_DEFAULTS.get(k, object())}}, f)
    return str(path)


def _start(args, env, log):
    """The process, its output (stdout and stderr) going to the file ``log``."""
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, *args], cwd=ROOT, env=env, stdout=f,
                                stderr=subprocess.STDOUT)
    proc.log = log
    return proc


def _finish(procs, name):
    """Wait for ``procs[name]``: ``(output, exit code)``; on a failure to
    wait, every process is killed."""
    try:
        rc = procs[name].wait(timeout=RUN_TIMEOUT_S)
    except BaseException:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        raise
    with open(procs[name].log) as f:
        return f.read(), rc


def _records(d):
    with open(os.path.join(d, "history.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of the module, each group of processes side by side."""
    w = tmp_path_factory.mktemp("elastic_gloo")
    native = ["-m", "tpuddp_torch.train_native", "--settings_file"]
    managed = ["-m", "tpuddp_torch.train_accelerate", "--settings_file"]
    procs = {
        "elastic": _start(native + [_settings(w / "e.yaml", w / "elastic", NATIVE, 2)],
                          _env(TPUDDP_FAULT="preempt@epoch=1"), w / "elastic.log"),
        "straight": _start(native + [_settings(w / "s.yaml", w / "straight", NATIVE, 2)], _env(),
                           w / "straight.log"),
        "managed": _start(managed + [_settings(w / "m.yaml", w / "managed", MANAGED, 2)], _env(),
                          w / "managed.log"),
        "supervised": _start(
            ["-m", "tpuddp_torch.supervise", "--world", "1", "--backoff-base", "0.01",
             "--first-env", "TPUDDP_FAULT=corrupt@ckpt_1,crash@epoch=2", "--", sys.executable]
            + native + [_settings(w / "v.yaml", w / "supervised", SUPERVISED, 1)], _env(),
            w / "supervised.log"),
    }
    # both packages' world-1 templates, built while the runs train
    mesh, _, _, augment, eval_transform, model, opt = _pieces(NATIVE, jax.devices("cpu")[:1])
    jax_ddp = JaxDDP(model, opt, JaxCrossEntropyLoss(), mesh=mesh, augment=augment,
                     eval_transform=eval_transform, comm_hook="bf16_ef", bucket_cap_mb=0.002)
    torch.set_num_threads(2)
    templates = (jax_ddp.init_state(jax.random.key(0), jnp.zeros((1, 8, 8, 3))),
                 train_native.build_training(0, 1, NATIVE, "cpu")[0])
    done = {"elastic": _finish(procs, "elastic")}
    for d in ("to1", "to3", "guard", "file"):  # "file": the file as written, for the restores
        shutil.copytree(w / "elastic", w / d)
    double = dict(NATIVE, train_batch_size=64, test_batch_size=90)
    procs["to1"] = _start(native + [_settings(w / "1.yaml", w / "to1", double, 1)],
                          _env(TPUDDP_AUTO_RESUME=1), w / "to1.log")
    procs["to3"] = _start(native + [_settings(w / "3.yaml", w / "to3", NATIVE, 3)],
                          _env(TPUDDP_AUTO_RESUME=1), w / "to3.log")
    # epoch 1's last update (23 a world-1 epoch) poisoned: the guard rolls
    # back to the world-2 file again
    procs["guard"] = _start(
        native + [_settings(w / "g.yaml", w / "guard",
                            dict(double, guard={"max_consecutive_skips": 0}), 1)],
        _env(TPUDDP_AUTO_RESUME=1, TPUDDP_FAULT="nan@step=22"), w / "guard.log")
    done["managed"] = _finish(procs, "managed")
    procs["managed_to1"] = _start(
        managed + [_settings(w / "m1.yaml", w / "managed", dict(MANAGED, num_epochs=2), 1)],
        _env(TPUDDP_AUTO_RESUME=1), w / "managed_to1.log")
    for name in procs:
        if name not in done:
            done[name] = _finish(procs, name)
    return w, done, templates


def _ok(runs, name, rc=0):
    out, got = runs[1][name]
    assert got == rc, f"{name} exited {got}:\n{out[-4000:]}"
    return out


def test_a_preempted_world_2_run_resumes_at_world_1(runs):
    w = runs[0]
    _ok(runs, "elastic", 75)
    _ok(runs, "straight")
    out = _ok(runs, "to1")
    assert "Auto-resume: continuing from epoch 1." in out
    assert "restored onto world 1" in out  # the JAX package's "elastic resume" line
    topo = ckpt.read_topology(str(w / "file" / "ckpt_1.npz"))
    assert topo["world_size"] == 2 and topo["leaves"][".comm_state"]["kind"] == "per_replica"
    records = _records(w / "to1")
    events = [r for r in records if r.get("event") == "topology_change"]
    assert [(e["from_world"], e["to_world"], e["residual"], e["resharded_leaves"], e["checkpoint"])
            for e in events] == [(2, 1, "redistributed", [".comm_state"], "ckpt_1.npz")]
    assert not any(r.get("event") == "comm_state_reset" for r in records)
    metas = [r for r in records if r["type"] == "run_meta"]
    assert [(m["world_size"], m.get("resumed_from_world")) for m in metas] == [(2, None), (1, 2)]
    rows = {r["epoch"]: r for r in records if r["type"] == "epoch"}
    straight = {r["epoch"]: r for r in _records(w / "straight") if r["type"] == "epoch"}
    assert [r["epoch"] for r in records if r["type"] == "epoch"] == [0, 1]
    assert rows[0]["train_loss"] == straight[0]["train_loss"]
    for e in (0, 1):
        for k in ("train_loss", "test_loss"):
            np.testing.assert_allclose(rows[e][k], straight[e][k], rtol=0.05, atol=0.05,
                                       err_msg=f"epoch {e} {k}")
    assert validate_history_file(str(w / "to1" / "history.jsonl"))[0] == []


def test_a_guard_rollback_onto_the_world_2_file_logs_its_reshard(runs):
    """The rollback restores ``ckpt_1.npz`` (world 2) at world 1 again:
    its ``topology_change`` row follows the ``rollback`` row, as in
    ``tpuddp/training/loop.py:576-592``."""
    w = runs[0]
    _ok(runs, "guard")
    kinds = [(r.get("event") or r["type"], r.get("epoch")) for r in _records(w / "guard")]
    assert kinds[kinds.index(("run_meta", None), 1):] == [
        ("run_meta", None), ("topology_change", None), ("epoch", 1), ("skipped_updates", 1),
        ("rollback", 1), ("topology_change", None), ("epoch", 1)]
    assert validate_history_file(str(w / "guard" / "history.jsonl"))[0] == []


def test_resumed_at_world_3_the_residual_resets(runs):
    w = runs[0]
    _ok(runs, "to3")
    records = _records(w / "to3")
    topo = [r for r in records if r.get("event") == "topology_change"]
    reset = [r for r in records if r.get("event") == "comm_state_reset"]
    assert [(e["from_world"], e["to_world"], e["residual"]) for e in topo] == [(2, 3, "reset")]
    assert [(e["leaf"], e["from_world"], e["to_world"]) for e in reset] == [(".comm_state", 2, 3)]
    assert [r["epoch"] for r in records if r["type"] == "epoch"] == [0, 1]
    assert validate_history_file(str(w / "to3" / "history.jsonl"))[0] == []


def test_the_port_and_the_jax_package_restore_the_ports_file_alike(runs):
    """The port's world-2 file at world 1: the JAX package's restore_latest
    and the port's, bitwise."""
    w, _, (like, port) = runs
    jax_log = []
    restored, jax_next = jax_ckpt.restore_latest(str(w / "file"), like, world_size=1,
                                                 reshard_log=jax_log, model_size=1)
    log = []
    next_epoch, _ = ckpt.restore_latest(str(w / "file"), port.model, port.optimizer,
                                        comm_state=port.residual, reshard_log=log, model_size=1)
    assert (next_epoch, log) == (jax_next, jax_log) and next_epoch == 1
    rows = np.load(w / "file" / "ckpt_1.npz")[".comm_state"].reshape(2, -1)
    want = {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(restored)[0]
            if not jax.dtypes.issubdtype(v.dtype, jax.dtypes.prng_key)}
    np.testing.assert_array_equal(want[".comm_state"], rows[0] + rows[1])
    np.testing.assert_array_equal(port.residual.numpy(), want[".comm_state"])
    payload = ckpt.state_payload(ckpt.NATIVE, port.model, port.optimizer)
    assert any(k.startswith(".opt_state.m") for k in payload)
    for k, v in payload.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_a_managed_zero1_state_resumes_at_world_1(runs):
    w = runs[0]
    _ok(runs, "managed")
    _ok(runs, "managed_to1")
    records = _records(w / "managed")
    topo = [r for r in records if r.get("event") == "topology_change"]
    assert len(topo) == 1 and (topo[0]["from_world"], topo[0]["to_world"]) == (2, 1)
    assert topo[0]["resharded_leaves"] == ["['opt_state'].m", "['opt_state'].v"]
    assert topo[0]["residual"] is None and topo[0]["checkpoint"] == "state_0.npz"
    metas = [r for r in records if r["type"] == "run_meta"]
    assert [m.get("resumed_from_world") for m in metas] == [None, 2]
    assert [r["epoch"] for r in records if r["type"] == "epoch"] == [0, 1]
    assert validate_history_file(str(w / "managed" / "history.jsonl"))[0] == []


def test_the_supervisor_resumes_a_crashed_run_past_a_torn_checkpoint(runs):
    w = runs[0]
    out = _ok(runs, "supervised")
    assert "fault injection: corrupt@ckpt fired" in out
    assert "fault injection: crash@epoch fired" in out
    assert "supervisor: child exited 113 (crash); restart 1/8" in out
    assert "ckpt_1.npz (local) failed integrity verification" in out
    assert "Auto-resume: continuing from epoch 1." in out
    assert "supervisor: child finished cleanly" in out
    records = _records(w / "supervised")
    assert [r["epoch"] for r in records if r["type"] == "epoch"] == [0, 1, 1, 2]
    assert [r["world_size"] for r in records if r["type"] == "run_meta"] == [1, 1]
