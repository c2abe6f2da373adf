"""Step snapshots and the agreed drain at world 2 on one host (two Gloo
processes on the CPU), native path: a run drained mid-epoch by
``$TPUDDP_FAULT=preempt@step=N`` (exit 75 from the launcher, one final step
snapshot, one ``preempt`` row) and auto-resumed is bitwise an uninterrupted
run, with ``bf16_ef`` with and without ZeRO-1 (history rows, parameters,
moments, residual rows, every random stream); the JAX package's
``restore_latest`` on a 2-device mesh reads that snapshot, and its own
engine writes the same state and cursor from it; a SIGTERM to the launcher
stops both ranks after the same dispatch; an engine held full (a slowed
writer, ``inflight: 1``) makes both ranks skip the same steps; across two
hosts (a rendezvous) the engine disarms with the JAX text and the drain
waits for the epoch boundary; the peer ring is named after the host.
Mirrors ``tests/test_snapshot.py`` and ``tests/test_chaos.py``'s drains.

Tolerances: every comparison is bitwise or an exact count (the same
batches, random streams and arithmetic), as the JAX tests assert theirs."""

import json
import os
import re
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpuddp import optim as jax_optim
from tpuddp.data import ShardedDataLoader as JaxLoader
from tpuddp.data.synthetic import synthetic_uint8_datasets as jax_synthetic_uint8
from tpuddp.models import load_model as jax_load_model
from tpuddp.nn import CrossEntropyLoss as JaxCrossEntropyLoss
from tpuddp.parallel import make_mesh
from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP
from tpuddp.training import checkpoint as jax_ckpt
from tpuddp.training import snapshot as jax_snap

from tpuddp_torch.training import checkpoint as ckpt
from tpuddp_torch.training import snapshot as snap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPROCESS_S = 180
SYNTH = (96, 32)  # 48 rows a rank: 6 batches of 8 an epoch
# an epoch row's fields that are neither the run's clock nor its process's
# counters (a resumed epoch counts the dispatches and bytes it ran)
ROW = ("epoch", "train_loss", "test_loss", "test_accuracy", "train_samples", "test_samples",
       "weight_update_sharding", "comm_hook")


def _yaml(path, out, **training):
    base = dict(model="toy_cnn", data_root="/nonexistent", synthetic_n=list(SYNTH),
                train_batch_size=8, test_batch_size=16, num_epochs=2, checkpoint_epoch=1,
                image_size=None, seed=0, scan_steps=1, comm_hook="bf16_ef")
    base.update(training)
    text = (f"out_dir: {out}\nlocal: {{device: cpu, gpu: {{num_gpus: 2}}}}\n"
            f"training: {json.dumps(base)}\n")
    with open(path, "w") as f:
        f.write(text)
    return str(path)


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT, TPUDDP_PREEMPT_GRACE="3600")
    for var in ("TPUDDP_AUTO_RESUME", "TPUDDP_FAULT", "TPUDDP_WORLD_SIZE", "TPUDDP_HEARTBEAT_DIR"):
        env.pop(var, None)
    env.update(extra)
    return env


def _run(settings, api="train_native", **env):
    return subprocess.run([sys.executable, "-m", f"tpuddp_torch.{api}", "--settings_file",
                           settings], cwd=ROOT, env=_env(**env), capture_output=True, text=True,
                          timeout=SUBPROCESS_S)


def _records(out):
    with open(os.path.join(out, "history.jsonl")) as f:
        return [json.loads(line) for line in f]


def _epochs(out, row=ROW):
    return [{k: r[k] for k in row} for r in _records(out) if r["type"] == "epoch"]


def _arrays(path):
    with np.load(path) as data:
        return dict(data.items())


def _assert_files_equal(a, b):
    fa, fb = _arrays(a), _arrays(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _drain_lines(text):
    """Each rank's closing line (on stderr): ``{rank: line}``."""
    return {int(m.group(1)): m.group(0)
            for m in re.finditer(r"rank (\d+); (?:snapshot engine|agreed poll)[^\n]*", text)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per variant (bf16_ef, and bf16_ef with ZeRO-1): a straight 2-epoch
    run at world 2, the same run drained by ``preempt@step=8`` (epoch 1,
    step 1) and its auto-resume; ``{variant: (straight_dir, drained_dir,
    drained_proc, resumed_proc)}``."""
    root = tmp_path_factory.mktemp("snap_gloo")
    out = {}
    for name, extra in (("bf16_ef", {}), ("zero1", {"weight_update_sharding": True})):
        extra = dict(extra, snapshot={"every_steps": 3})
        straight, drained = str(root / f"{name}_straight"), str(root / f"{name}_drained")
        s = _run(_yaml(root / f"{name}_s.yaml", straight, **extra), TPUDDP_WORLD_SIZE="2")
        assert s.returncode == 0, s.stdout[-2000:] + s.stderr[-3000:]
        path = _yaml(root / f"{name}_d.yaml", drained, **extra)
        d = _run(path, TPUDDP_WORLD_SIZE="2", TPUDDP_FAULT="preempt@step=8")
        d.snapshots = sorted(f for f in os.listdir(drained) if re.fullmatch(r"ckpt_\d+_s\d+\.npz", f))
        r = _run(path, TPUDDP_WORLD_SIZE="2", TPUDDP_AUTO_RESUME="1")
        out[name] = (straight, drained, d, r)
    return out


@pytest.mark.parametrize("name", ["bf16_ef", "zero1"])
def test_a_world_2_drain_resumes_bitwise(runs, name):
    straight, drained, d, r = runs[name]
    assert d.returncode == 75, d.stdout[-2000:] + d.stderr[-3000:]
    assert d.stdout.count("exiting 75 (requeue+resume)") + d.stderr.count(
        "exiting 75 (requeue+resume)") == 2  # both ranks
    # the snapshots of the cadence (steps 3 and 6 of epoch 0, none due in
    # epoch 1 before step 3) and the drain's final one in epoch 1: the flag
    # rises as host batch 8 is staged, two batches ahead of its step, and
    # the pass stops after the dispatch the agreement follows (step 1)
    assert d.snapshots == ["ckpt_0_s3.npz", "ckpt_0_s6.npz", "ckpt_1_s1.npz"]
    assert ckpt.read_cursor(os.path.join(drained, "ckpt_1_s1.npz"))["step"] == 1
    rows = _records(drained)
    preempts = [row for row in rows if row.get("event") == "preempt"]
    assert len(preempts) == 1 and preempts[0]["epoch"] == 1 and preempts[0]["snapshot_step"] == 1
    # both ranks stopped after the same dispatch: as many agreements each
    lines = _drain_lines(d.stderr)
    assert sorted(lines) == [0, 1]
    assert len({re.search(r"(\d+) exchanges", line).group(1) for line in lines.values()}) == 1
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    assert "Exact resume: epoch 1 continues at step 1 (zero batches replayed)." in r.stdout
    assert _epochs(drained) == _epochs(straight)
    # parameters, moments (ZeRO-1's gathered data_flat vectors), the
    # residual's rows, the guard-free counters and every rank's streams
    _assert_files_equal(os.path.join(drained, "ckpt_1.npz"), os.path.join(straight, "ckpt_1.npz"))


def _jax_state(devices, zero1=False):
    mesh = make_mesh(devices)
    ddp = JaxDDP(jax_load_model("toy_cnn", 10), jax_optim.Adam(1e-3), JaxCrossEntropyLoss(),
                 mesh=mesh, comm_hook="bf16_ef", weight_update_sharding=zero1)
    return ddp, ddp.init_state(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))


def test_the_jax_package_restores_a_world_2_step_snapshot(runs, cpu_devices, tmp_path):
    """The port's world-2 snapshot opens in the JAX ``restore_latest`` on a
    2-device mesh at its step; the JAX engine, handed that state and
    cursor, writes the same params, moments, residual rows and cursor, and
    the plan key is the JAX package's for that world's loader."""
    _straight, drained, _d, _r = runs["bf16_ef"]
    src = tmp_path / "src"
    src.mkdir()
    for f in ("ckpt_1_s1.npz", "ckpt_1_s1.npz.sha256"):
        (src / f).write_bytes(open(os.path.join(drained, f), "rb").read())
    ddp, like = _jax_state(cpu_devices[:2])
    cursors = []
    state, epoch = jax_ckpt.restore_latest(str(src), like, world_size=2, cursor_out=cursors)
    assert epoch == 1 and cursors[0]["step"] == 1
    train, _ = jax_synthetic_uint8(*SYNTH)
    mesh = make_mesh(cpu_devices[:2])
    assert cursors[0]["plan_key"] == jax_snap.epoch_plan_key(JaxLoader(train, 8, mesh, shuffle=True), 1)
    acc = snap.acc_from_cursor(cursors[0])
    assert acc["loss_sum"].shape == acc["n"].shape == (2,)  # one entry a replica
    engine = jax_snap.SnapshotEngine(str(tmp_path / "jax"), jax_snap.SnapshotConfig(
        every_steps=3, async_writes=False), world_size=2)
    path = engine.final_snapshot(state, epoch=1, step=1, plan_key=cursors[0]["plan_key"],
                                 acc={k: jnp.asarray(v) for k, v in acc.items()})
    engine.close()
    ours, theirs = _arrays(os.path.join(src, "ckpt_1_s1.npz")), _arrays(path)
    keys = [k for k in theirs if k.startswith((".params", ".opt_state", ".comm_state", ".step"))]
    assert any(k.startswith(".comm_state") for k in keys) and any(".opt_state" in k for k in keys)
    for k in keys:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    mine, jax_cursor = ckpt.read_cursor(os.path.join(src, "ckpt_1_s1.npz")), ckpt.read_cursor(path)
    for k in ("epoch", "step", "plan_key"):
        assert mine[k] == jax_cursor[k], k
    for k, v in snap.acc_from_cursor(mine).items():
        np.testing.assert_array_equal(v, snap.acc_from_cursor(jax_cursor)[k], err_msg=k)


def test_sigterm_to_the_launcher_drains_both_ranks_at_one_step(tmp_path):
    out = tmp_path / "out"
    path = _yaml(tmp_path / "s.yaml", out, num_epochs=40, synthetic_n=[192, 32],
                 snapshot={"every_steps": 1000})
    proc = subprocess.Popen([sys.executable, "-m", "tpuddp_torch.train_native", "--settings_file",
                             path], cwd=ROOT, env=_env(TPUDDP_WORLD_SIZE="2"),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines, sent, deadline = [], False, time.time() + SUBPROCESS_S
    try:
        for line in proc.stdout:
            lines.append(line)
            if not sent and line.startswith("Process 0, Epoch 1"):
                proc.send_signal(signal.SIGTERM)
                sent = True
            assert time.time() < deadline, "the run did not drain in time"
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    text = "".join(lines)
    assert sent and rc == 75, text[-3000:]
    snaps = [f for f in os.listdir(out) if re.fullmatch(r"ckpt_\d+_s\d+\.npz", f)]
    assert len(snaps) == 1, snaps
    preempts = [r for r in _records(out) if r.get("event") == "preempt"]
    assert len(preempts) == 1 and preempts[0]["snapshot_step"] == int(
        re.search(r"_s(\d+)", snaps[0]).group(1))
    lines = _drain_lines(text)
    assert sorted(lines) == [0, 1]
    assert len({re.search(r"(\d+) exchanges", line).group(1) for line in lines.values()}) == 1


def test_a_full_engine_makes_every_rank_skip_alike(tmp_path):
    """``inflight: 1`` and a writer slowed by the worker: due snapshots are
    skipped, on both ranks at the same steps (equal counts taken and
    skipped, the agreed room), and the run ends."""
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "tests", "_torch_port_snap_worker.py"),
                           str(tmp_path)], cwd=ROOT, env=_env(), capture_output=True, text=True,
                          timeout=SUBPROCESS_S)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    lines = _drain_lines(proc.stderr)
    assert sorted(lines) == [0, 1], proc.stderr[-2000:]
    counts = [tuple(int(x) for x in re.search(r"(\d+) taken, (\d+) written, (\d+) skipped",
                                              lines[r]).groups()) for r in (0, 1)]
    (taken, written, skipped), (taken1, written1, skipped1) = counts
    assert skipped > 0 and taken > 0 and (taken, skipped) == (taken1, skipped1)
    assert written == taken and written1 == 0  # rank 0 writes every snapshot taken
    outcomes = []
    for r in (0, 1):
        with open(tmp_path / f"skips_{r}.json") as f:
            outcomes.append(json.load(f))
    assert outcomes[0] == outcomes[1] and len(outcomes[0]) == taken + skipped


def test_across_two_hosts_the_engine_disarms_and_the_drain_waits(tmp_path):
    """Two launchers of one rank each (world 2 = 2 hosts x 1): the engine
    disarms with the JAX package's text, no pass polls, and the drain asked
    for at step 3 is decided at epoch 1's start: ``ckpt_1.npz`` with
    ``completed: 0``, both exit 75."""
    out = tmp_path / "out"
    path = str(tmp_path / "mh.yaml")
    with open(path, "w") as f:
        f.write(f"out_dir: {out}\nlocal: {{device: cpu, gpu: {{num_gpus: 2}}, rendezvous: "
                f"{{coordinator_address: 127.0.0.1:{_free_port()}, num_processes: 2}}}}\n"
                "training: {model: toy_mlp, data_root: /nonexistent, synthetic_n: [64, 32], "
                "train_batch_size: 8, test_batch_size: 16, num_epochs: 3, checkpoint_epoch: 1, "
                "image_size: null, seed: 0, scan_steps: 1, snapshot: {every_steps: 2}}\n")
    procs = [subprocess.Popen([sys.executable, "-m", "tpuddp_torch.train_native",
                               "--settings_file", path], cwd=ROOT,
                              env=_env(TPUDDP_PROCESS_ID=str(i), TPUDDP_FAULT="preempt@step=3"),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    texts = [p.communicate(timeout=SUBPROCESS_S)[0] for p in procs]
    assert [p.returncode for p in procs] == [75, 75], texts[0][-2000:] + texts[1][-2000:]
    assert ckpt.read_meta(str(out / "ckpt_1.npz")) == {"epoch": 1, "completed": 0}
    assert not [f for f in os.listdir(out) if "_s" in f]
    assert [r["epoch"] for r in _records(out) if r["type"] == "epoch"] == [0]
    assert "snapshot engine disarmed: state holds cross-host-sharded leaves" in texts[0]


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("hosts,host,ring", [(1, 0, 0), (2, 0, 1), (2, 1, 0), (4, 3, 0)])
def test_the_peer_ring_is_named_after_the_host(tmp_path, monkeypatch, hosts, host, ring):
    """``(host + 1) % hosts``, the JAX package's ``(process_index + 1) %
    process_count``: on one host every rank's ring is ``ring_0``."""
    monkeypatch.setenv("TPUDDP_HEARTBEAT_DIR", str(tmp_path / "hb"))
    for rank in range(4 if hosts == 1 else 1):
        engine = snap.SnapshotEngine(str(tmp_path / "run"), snap.SnapshotConfig(every_steps=1),
                                     rank=rank, world_size=4, hosts=hosts, host=host)
        assert engine._peer_dir() == str(tmp_path / "hb" / "peer_ckpt" / f"ring_{ring}")
        engine.close()
