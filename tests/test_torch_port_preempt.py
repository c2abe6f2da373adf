"""The preemption drain of the port (``tpuddp_torch/resilience/
preemption.py``, the loops' poll, ``$TPUDDP_FAULT=preempt@...``, exit 75)
and its exact mid-epoch resume, on the CPU: the exit codes, the handler and
the auto-resume parser against the JAX package's; the second signal and the
grace failsafe (subprocesses); a poll that stops a pass mid-epoch at
staging depth 1 and 3 with no batch lost or applied twice; native and
managed runs preempted mid-epoch and auto-resumed, bitwise an uninterrupted
run of the same seed (rows and the final file, every random stream
included); a plan-key mismatch redoing the epoch; snapshots on and off
training alike; a drain in the eval pass; a real SIGTERM to the entry point
and its requeued run; a drain at world 2 over Gloo. Mirrors
``tests/test_resilience.py:296-400``, ``tests/test_pipeline.py:218-330``
and ``tests/test_chaos.py:104-170``.

Tolerances: every comparison is bitwise (the same batches and random
streams through the same arithmetic), as the JAX tests assert theirs; the
codes, texts and counts are equal."""

import contextlib
import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
from functools import partial

import numpy as np
import pytest
import torch

from tpuddp.resilience import preemption as jax_preemption

from tpuddp_torch import config as cfg_lib
from tpuddp_torch.parallel.spawn import run_ddp_training
from tpuddp_torch.resilience import faults, preemption
from tpuddp_torch.train_accelerate import basic_accelerate_training
from tpuddp_torch.train_native import basic_ddp_training_loop, build_training
from tpuddp_torch.training import checkpoint as ckpt
from tpuddp_torch.training.loop import dispatches, run_training_loop
from tpuddp_torch.training.pipeline import PipelineConfig, StagedLoader
from tpuddp_torch.training.snapshot import EpochTailLoader

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPROCESS_S = 240

TRAINING = dict(cfg_lib.TRAINING_DEFAULTS, model="toy_mlp", dataset="synthetic",
                synthetic_n=(96, 32), train_batch_size=8, test_batch_size=16, image_size=None,
                seed=0, num_epochs=2, checkpoint_epoch=1, scan_steps=1,
                snapshot={"every_steps": 3}, keep_last=2)


@pytest.fixture(autouse=True)
def drains(monkeypatch):
    monkeypatch.setenv("TPUDDP_PREEMPT_GRACE", "3600")
    for var in ("TPUDDP_AUTO_RESUME", "TPUDDP_FAULT", "TPUDDP_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    faults.reload_faults()
    preemption.reset_preemption()
    yield
    preemption.reset_preemption()
    faults.reload_faults()


@contextlib.contextmanager
def _env(**env):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    faults.reload_faults()
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        faults.reload_faults()


# ----------------------------------------------------------- the contract --

def test_exit_codes_and_parsers_are_the_jax_packages(monkeypatch):
    for name in ("EXIT_PREEMPTED", "EXIT_WATCHDOG", "EXIT_DESYNC", "EXIT_INJECTED_CRASH"):
        assert getattr(preemption, name) == getattr(jax_preemption, name), name
    assert preemption.EXIT_PREEMPTED == 75
    assert ckpt.auto_resume_requested is preemption.auto_resume_requested  # the re-export
    for value in ("", "0", "1", "yes", "false"):
        monkeypatch.setenv("TPUDDP_AUTO_RESUME", value)
        assert preemption.auto_resume_requested() == jax_preemption.auto_resume_requested()
    for value in ("", "7.5", "soon"):
        monkeypatch.setenv("TPUDDP_PREEMPT_GRACE", value)
        assert preemption.preemption_grace_seconds() == jax_preemption.preemption_grace_seconds()


def test_the_handler_only_sets_the_flag_and_installs_in_the_main_thread():
    before = signal.getsignal(signal.SIGTERM)
    assert preemption.install_preemption_handler()
    try:
        assert signal.getsignal(signal.SIGTERM) is preemption.request_preemption
        assert signal.getsignal(signal.SIGINT) is preemption.request_preemption
        assert preemption.install_preemption_handler()  # installed once
        assert preemption.preemption_deadline() is None
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(100):
            if preemption.preemption_requested():
                break
            time.sleep(0.01)
        assert preemption.preemption_requested()
        assert preemption.preemption_deadline() > time.monotonic() + 3000
    finally:
        preemption.uninstall_preemption_handler()
        preemption.reset_preemption()
    assert signal.getsignal(signal.SIGTERM) is before
    box = []
    t = threading.Thread(target=lambda: box.append(preemption.install_preemption_handler()))
    t.start()
    t.join()
    assert box == [False]


_EXITS = {
    "second signal": ("import os, signal, time\n"
                      "from tpuddp_torch.resilience import preemption\n"
                      "preemption.install_preemption_handler()\n"
                      "os.kill(os.getpid(), signal.SIGTERM)\n"
                      "time.sleep(0.2)\n"
                      "os.kill(os.getpid(), signal.SIGTERM)\n"
                      "time.sleep(60)\n", "3600"),
    "grace failsafe": ("import time\n"
                       "from tpuddp_torch.resilience import preemption\n"
                       "preemption.request_preemption()\n"
                       "time.sleep(60)\n", "0.3"),
}


@pytest.mark.parametrize("case", sorted(_EXITS))
def test_the_second_signal_and_the_grace_failsafe_exit_75(case):
    """A second signal exits at once; a drain that outlives
    ``$TPUDDP_PREEMPT_GRACE`` is forced out; both with 75."""
    script, grace = _EXITS[case]
    env = dict(os.environ, PYTHONPATH=ROOT, TPUDDP_PREEMPT_GRACE=grace)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True, text=True,
                          timeout=SUBPROCESS_S)
    assert proc.returncode == 75, proc.stderr[-2000:]
    assert time.perf_counter() - t0 < 30
    assert ("second preemption signal" if case == "second signal" else "grace window") in proc.stderr


# ------------------------------------------------------------- the poll --

class _Numbered:
    """12 host batches whose labels carry their index; the flag is raised
    as batch ``at`` is drawn."""

    def __init__(self, at=None, n=12):
        self.at, self.n = at, n

    def __len__(self):
        return self.n

    def make_batch_plan(self):
        def fetch(s):
            if s == self.at:
                preemption.request_preemption()
            return (np.zeros((2, 4, 4, 3), np.uint8), np.full(2, s), np.ones(2, np.float32))
        return self.n, fetch

    def __iter__(self):
        steps, fetch = self.make_batch_plan()
        return (fetch(s) for s in range(steps))


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("k,accum", [(1, 1), (4, 1), (2, 2)])
def test_a_mid_epoch_poll_loses_no_batch_and_applies_none_twice(depth, k, accum):
    """The pass stops after the last dispatch issued (the staged batches and
    a partial chunk are dropped); the tail from the dispatched count holds
    the rest: every batch of the epoch exactly once."""
    loader = StagedLoader(_Numbered(at=7), "cpu", PipelineConfig(depth=depth, host_workers=0),
                          poll=preemption.preemption_requested)
    done = []
    for _many, chunk in dispatches(loader, k, accum):
        done += [int(y[0]) for _x, y, w in chunk if float(w.sum())]
    assert loader.interrupted
    assert done == list(range(len(done))) and 0 < len(done) < 7
    assert len(done) % accum == 0 and (k == 1 or len(done) % k == 0)
    preemption.reset_preemption()
    tail = StagedLoader(EpochTailLoader(_Numbered(), len(done)), "cpu",
                        PipelineConfig(depth=depth, host_workers=0),
                        poll=preemption.preemption_requested)
    rest = [int(y[0]) for _many, chunk in dispatches(tail, k, accum) for _x, y, w in chunk
            if float(w.sum())]
    assert not tail.interrupted
    assert done + rest == list(range(12))


# ---------------------------------------------------- the exact resume --

def _run(kind, save_dir, **extra):
    worker = basic_ddp_training_loop if kind == "native" else basic_accelerate_training
    return run_ddp_training(partial(worker, training=dict(TRAINING, **extra), device="cpu"), 1,
                            str(save_dir), {}, backend="cpu")


def _arrays(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _rows(history):
    return [(r["epoch"], r["train_loss"], r["test_loss"], r["train_samples"]) for r in history]


def _newest_step_file(d, prefix):
    names = [f for f in os.listdir(d) if f.startswith(f"{prefix}_0_s") and f.endswith(".npz")]
    return os.path.join(d, max(names, key=lambda f: int(f[len(prefix) + 4:-4])))


def _cycle(kind, tmp_path, at, **extra):
    """Straight; preempted at global train micro-batch ``at`` (exit 75, a
    step snapshot); auto-resumed. Returns ``(straight, resumed, cursor)``."""
    prefix = "ckpt" if kind == "native" else "state"
    straight = _run(kind, tmp_path / "straight", **extra)
    with _env(TPUDDP_FAULT=f"preempt@step={at}"), pytest.raises(SystemExit) as exit_:
        _run(kind, tmp_path / "cut", **extra)
    preemption.reset_preemption()
    assert exit_.value.code == preemption.EXIT_PREEMPTED
    newest = _newest_step_file(tmp_path / "cut", prefix)
    assert ckpt.verify_file(newest)
    cursor = ckpt.read_cursor(newest)
    with _env(TPUDDP_AUTO_RESUME="1"):
        resumed = _run(kind, tmp_path / "cut", **extra)
    final = f"{prefix}_1.npz"
    a, b = _arrays(tmp_path / "straight" / final), _arrays(tmp_path / "cut" / final)
    assert sorted(a) == sorted(b)
    for key in a:  # parameters, buffers, moments, steps, keys, every random stream
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert _rows(resumed) == _rows(straight)
    with open(tmp_path / "cut" / "history.jsonl") as f:
        records = [json.loads(line) for line in f]
    preempt = [r for r in records if r.get("event") == "preempt"]
    assert len(preempt) == 1 and preempt[0]["snapshot_step"] == cursor["step"]
    return straight, resumed, cursor


@pytest.mark.parametrize("extra", [
    {"pipeline": {"depth": 1}}, {"pipeline": {"depth": 3}},
    {"scan_steps": 4}, {"gradient_accumulation_steps": 2, "scan_steps": 2},
], ids=["depth1", "depth3", "scan4", "accum2"])
def test_a_native_run_resumes_bitwise(tmp_path, extra):
    _, _, cursor = _cycle("native", tmp_path, 7, **extra)
    assert cursor["epoch"] == 0 and 0 < cursor["step"] < 12 and cursor["plan_key"]


@pytest.mark.parametrize("extra", [
    {}, {"pipeline": {"device_augment": False}}, {"gradient_accumulation_steps": 2},
], ids=["in_step_augment", "device_augment_false", "accum2"])
def test_a_managed_run_resumes_bitwise(tmp_path, extra):
    """The managed drain at a cycle boundary (``state_0_s{N}.npz``, the
    cursor's sums with the pass's per-step losses), resumed bitwise."""
    _, _, cursor = _cycle("managed", tmp_path, 7, **extra)
    assert cursor["epoch"] == 0 and cursor["plan_key"]
    assert cursor["step"] % extra.get("gradient_accumulation_steps", 1) == 0
    assert sorted(cursor["acc"]) == ["['loss_total']", "['losses']", "['n_seen']"]
    assert len(cursor["acc"]["['losses']"]) == cursor["step"]


def test_device_augment_false_is_the_in_step_augment_bitwise(tmp_path):
    """The managed augment as its own op before each step draws the same
    flips from the same stream as the step's own: the same run."""
    a = _run("managed", tmp_path / "in_step", num_epochs=1)
    b = _run("managed", tmp_path / "own_op", num_epochs=1, pipeline={"device_augment": False})
    assert _rows(a) == _rows(b)


def test_a_plan_key_mismatch_redoes_the_epoch(tmp_path, caplog):
    """A cursor cut on another batch order (here: another batch size) is
    not continued: the epoch is redone from the restored state."""
    with _env(TPUDDP_FAULT="preempt@step=5"), pytest.raises(SystemExit):
        _run("native", tmp_path, num_epochs=1)
    preemption.reset_preemption()
    with _env(TPUDDP_AUTO_RESUME="1"), caplog.at_level(logging.WARNING, logger="tpuddp"):
        history = _run("native", tmp_path, num_epochs=1, train_batch_size=16)
    assert any("plan key mismatch" in r.message for r in caplog.records)
    assert [(r["epoch"], r["train_samples"]) for r in history] == [(0, 96.0)]  # redone whole


@pytest.mark.parametrize("kind", ["native", "managed"])
def test_snapshots_on_and_off_train_alike(tmp_path, kind):
    on = _run(kind, tmp_path / "on", num_epochs=1)
    off = _run(kind, tmp_path / "off", num_epochs=1, snapshot=None)
    assert _rows(on) == _rows(off)
    prefix = "ckpt" if kind == "native" else "state"
    a, b = _arrays(tmp_path / "on" / f"{prefix}_0.npz"), _arrays(tmp_path / "off" / f"{prefix}_0.npz")
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    with open(tmp_path / "on" / "history.jsonl") as f:
        meta = json.loads(f.readline())
    assert meta["snapshot"]["every_steps"] == 3
    assert meta["snapshot"].get("mode") == (None if kind == "native" else "drain")


def test_a_drain_in_the_eval_pass_saves_the_epoch_done(tmp_path):
    """Every update of the epoch is in: its row lands with null eval
    metrics, the file counts the epoch done, the resume starts at the next."""
    ddp, train_loader, test_loader, seed = build_training(0, 1, dict(TRAINING), "cpu")

    class Preempting:
        def __init__(self, inner):
            self.inner = inner

        def __len__(self):
            return len(self.inner)

        def __getattr__(self, name):
            return getattr(self.inner, name)

        def __iter__(self):
            preemption.request_preemption()
            return iter(self.inner)

    with pytest.raises(preemption.TrainingPreempted) as e:
        run_training_loop(ddp, train_loader, Preempting(test_loader), str(tmp_path), num_epochs=2,
                          checkpoint_epoch=1, base_seed=seed, scan_steps=1, log=lambda *_: None)
    assert e.value.epoch == 0 and e.value.checkpoint.endswith("ckpt_0.npz")
    assert ckpt.read_meta(str(tmp_path / "ckpt_0.npz")) == {"epoch": 0, "completed": 1}
    with open(tmp_path / "history.jsonl") as f:
        records = [json.loads(line) for line in f]
    row = [r for r in records if r["type"] == "epoch"][0]
    assert row["test_loss"] is None and row["test_accuracy"] is None and row["test_samples"] == 0
    assert records[-1]["event"] == "preempt" and records[-1]["completed"] is True
    preemption.reset_preemption()
    with _env(TPUDDP_AUTO_RESUME="1"):
        assert [r["epoch"] for r in _run("native", tmp_path)] == [1]


# --------------------------------------------------- processes of its own --

def _settings(tmp_path, **training):
    path = tmp_path / "s.yaml"
    out = tmp_path / "out"
    with open(path, "w") as f:  # JSON is YAML
        json.dump({"out_dir": str(out), "local": {"device": "cpu"},
                   "training": {k: v for k, v in dict(TRAINING, **training).items()
                                if k in ("model", "dataset", "synthetic_n", "train_batch_size",
                                         "test_batch_size", "image_size", "seed", "num_epochs",
                                         "checkpoint_epoch", "scan_steps", "snapshot",
                                         "learning_rate")}}, f)
    return str(path), out


def _env_for(**extra):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2", TPUDDP_PREEMPT_GRACE="60")
    for var in ("TPUDDP_AUTO_RESUME", "TPUDDP_FAULT", "TPUDDP_WORLD_SIZE"):
        env.pop(var, None)
    env.update(extra)
    return env


def test_sigterm_to_the_entry_point_drains_and_the_requeued_run_resumes(tmp_path):
    """A scheduler's SIGTERM mid-training: the entry point drains into an
    intact file and exits 75; the same command with
    ``$TPUDDP_AUTO_RESUME=1`` continues, no epoch lost or repeated."""
    path, out = _settings(tmp_path, num_epochs=40, snapshot=None,
                          synthetic_n=[192, 16])
    cmd = [sys.executable, "-u", "-m", "tpuddp_torch.train_native", "--settings_file", path]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=_env_for(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines, sent = [], False
    deadline = time.time() + SUBPROCESS_S
    for line in proc.stdout:
        lines.append(line)
        if not sent and line.startswith("Process 0, Epoch 1"):
            proc.send_signal(signal.SIGTERM)
            sent = True
        assert time.time() < deadline, "the run did not drain in time"
    rc = proc.wait(timeout=60)
    text = "".join(lines)
    assert sent and rc == 75, text[-3000:]
    assert "exiting 75 (requeue+resume)" in text
    path_, epoch = ckpt.latest(str(out))
    assert ckpt.verify_file(path_) and ckpt.read_meta(path_)["completed"] == 0
    with open(out / "history.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert records[-1]["event"] == "preempt" and records[-1]["epoch"] == epoch
    path6, _ = _settings(tmp_path, num_epochs=epoch + 2, snapshot=None, synthetic_n=[192, 16])
    again = subprocess.run([*cmd[:-1], path6], cwd=ROOT, env=_env_for(TPUDDP_AUTO_RESUME="1"),
                           capture_output=True, text=True, timeout=SUBPROCESS_S)
    assert again.returncode == 0, again.stdout[-2000:] + again.stderr[-2000:]
    assert f"Auto-resume: continuing from epoch {epoch}." in again.stdout
    with open(out / "history.jsonl") as f:
        epochs = [r["epoch"] for r in map(json.loads, f) if r["type"] == "epoch"]
    assert epochs == list(range(epoch + 2))


def test_a_drain_at_world_2_stops_both_ranks_at_the_epoch_boundary(tmp_path):
    """Two Gloo ranks on one host (the JAX package's one process with two
    devices, ``tpuddp/training/loop.py:625-630``): ``preempt@step=3`` fires
    on each inside epoch 0, and the drain lands mid-pass at the boundary
    the ranks agree on (rank 0's flag, exchanged after every dispatch), not
    at the next epoch's start, which stays the rule across hosts
    (tests/test_torch_port_snapshot_gloo.py). The native poll is armed
    whatever ``training.snapshot`` says: without it the drain writes the
    JAX package's mid-pass epoch file (``completed: 0``), with it a step
    snapshot. Both ranks exit 75, so does the launcher, with one
    ``preempt`` row."""
    for snapshot in (None, {"every_steps": 3}):
        case = tmp_path / ("snap" if snapshot else "plain")
        case.mkdir()
        path, out = _settings(case, num_epochs=3, snapshot=snapshot)
        proc = subprocess.run(
            [sys.executable, "-m", "tpuddp_torch.train_native", "--settings_file", path],
            cwd=ROOT, env=_env_for(TPUDDP_WORLD_SIZE="2", TPUDDP_FAULT="preempt@step=3"),
            capture_output=True, text=True, timeout=SUBPROCESS_S)
        assert proc.returncode == 75, proc.stdout[-2000:] + proc.stderr[-3000:]
        text = proc.stdout + proc.stderr
        assert text.count("exiting 75 (requeue+resume)") == 2  # both ranks
        assert "snapshot engine disarmed" not in text
        with open(out / "history.jsonl") as f:
            records = [json.loads(line) for line in f]
        assert [r["epoch"] for r in records if r["type"] == "epoch"] == []
        preempts = [r for r in records if r.get("event") == "preempt"]
        assert len(preempts) == 1 and preempts[0]["epoch"] == 0
        steps = [f for f in os.listdir(out) if "_s" in f and f.endswith(".npz")]
        if snapshot is None:
            assert ckpt.read_meta(str(out / "ckpt_0.npz")) == {"epoch": 0, "completed": 0}
            assert not steps
        else:
            assert len(steps) == 1 and steps[0].startswith("ckpt_0_s"), steps
            step = ckpt.read_cursor(str(out / steps[0]))["step"]
            assert 0 < step < 6 and preempts[0]["snapshot_step"] == step
