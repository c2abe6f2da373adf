"""The multi-host rendezvous (``local.rendezvous``) of the port, on the CPU:

- ``config.rendezvous_from`` against ``tpuddp/config.py``'s (the cases of
  ``tests/test_config.py``), with its ``ValueError``s, and the launch's
  own checks (``spawn.resolve_world``: hosts must tile the world); with
  ``$TPUDDP_WATCHDOG_TIMEOUT`` a host's local rank 0 arms the watchdog
  beside a rendezvous (its beat as ``hb_<process_id>``), and one host
  arms none;
- ``$TPUDDP_BACKEND``, the preferred rung of the backend ladder;
- two launcher processes (two "hosts", ``$TPUDDP_PROCESS_ID`` 0 and 1)
  of 2 Gloo ranks each, meeting at a coordinator through ``python -m
  tpuddp_torch.train_native`` and ``train_accelerate``: the final
  checkpoints bitwise the single-launcher world-4 run's, flat and
  hierarchical (whose 2 hosts come from the rendezvous); only global rank
  0 (host 0) writes checkpoints, history rows and epoch lines;
- a coordinator nobody serves: the rendezvous's retries end in their
  terminal error, naming the address, within the policy's time; the
  retry itself against ``tpuddp/resilience/retry.py`` (``tests/
  test_resilience.py``'s cases).

Tolerance: bitwise (the same ranks run the same steps; only the launch
differs).
"""

import importlib
import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import yaml

from tpuddp import config as jax_cfg

from tpuddp_torch import config as cfg
from tpuddp_torch.parallel import backend, spawn

# the modules (the JAX package re-exports its retry function under the name)
jax_retry = importlib.import_module("tpuddp.resilience.retry")
port_retry = importlib.import_module("tpuddp_torch.resilience.retry")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RDV_ENV = ("TPUDDP_COORDINATOR", "TPUDDP_NUM_PROCESSES", "TPUDDP_PROCESS_ID")
TIMEOUT_S = 300
TRAINING = dict(model="toy_mlp", data_root="/nonexistent", synthetic_n=[64, 32],
                train_batch_size=8, test_batch_size=8, num_epochs=1, checkpoint_epoch=1,
                image_size=None, seed=0)


@pytest.fixture
def no_rdv_env(monkeypatch):
    for var in RDV_ENV + ("TPUDDP_WATCHDOG_TIMEOUT",):
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


# ------------------------------------------------------------- the settings --

RDV = {"coordinator_address": "10.0.0.1:8476", "num_processes": 4, "process_id": 2}


@pytest.mark.parametrize("settings", [
    {}, {"local": {}}, {"local": {"rendezvous": RDV}},
    {"local": {"rendezvous": {"coordinator_address": "h:1", "num_processes": 1}}},
    {"local": {"device": "cpu", "rendezvous": dict(RDV, num_processes="2", process_id="1")}},
])
def test_the_rendezvous_block_parses_as_the_jax_package_parses_it(no_rdv_env, settings):
    assert cfg.rendezvous_from(settings) == jax_cfg.rendezvous_from(settings)


def test_the_environment_overrides_the_block(no_rdv_env):
    s = {"local": {"device": "cpu", "rendezvous": {"coordinator_address": "10.0.0.1:8476",
                                                   "num_processes": 2}}}
    for c in (cfg, jax_cfg):
        with pytest.raises(ValueError, match="process_id"):
            c.rendezvous_from(s)
    no_rdv_env.setenv("TPUDDP_PROCESS_ID", "1")
    assert cfg.rendezvous_from(s) == jax_cfg.rendezvous_from(s) == {
        "coordinator_address": "10.0.0.1:8476", "num_processes": 2, "process_id": 1}
    no_rdv_env.setenv("TPUDDP_COORDINATOR", "10.0.0.9:9999")
    no_rdv_env.setenv("TPUDDP_NUM_PROCESSES", "8")
    assert cfg.rendezvous_from({}) == jax_cfg.rendezvous_from({}) == {
        "coordinator_address": "10.0.0.9:9999", "num_processes": 8, "process_id": 1}


@pytest.mark.parametrize("rdv,match", [
    ({"master_addr": "x"}, "unknown local.rendezvous keys"),
    ({"num_processes": 2, "process_id": 0}, "needs a coordinator_address"),
    ({"coordinator_address": "h:1", "num_processes": 2}, "needs a process_id"),
])
def test_a_malformed_block_is_the_jax_value_error(no_rdv_env, rdv, match):
    settings = {"local": {"device": "cpu", "rendezvous": rdv}}
    with pytest.raises(ValueError, match=match) as want:
        jax_cfg.rendezvous_from(settings)
    with pytest.raises(ValueError) as got:
        cfg.rendezvous_from(dict(settings, local={"device": "cuda", "rendezvous": rdv}))
    # the port has no pod auto-discovery: the texts agree but for the JAX
    # package's pointer to it
    assert str(want.value).startswith(str(got.value).rstrip(")"))


def test_a_process_id_past_the_hosts_is_refused(no_rdv_env):
    with pytest.raises(ValueError, match="not one of the 2 hosts"):
        cfg.rendezvous_from({"local": {"rendezvous": {"coordinator_address": "h:1",
                                                      "num_processes": 2, "process_id": 2}}})


def test_the_hosts_must_tile_the_world(no_rdv_env):
    rdv = {"coordinator_address": "h:1", "num_processes": 2, "process_id": 0}
    assert spawn.resolve_world(4, "cpu", **rdv) == (4, 2)
    assert spawn.resolve_world(None, "cpu", **rdv) == (2, 2)  # one process a host
    assert spawn.resolve_world(None, "cpu", num_processes=2) == (1, 1)  # no coordinator
    with pytest.raises(ValueError, match="does not tile"):
        spawn.resolve_world(3, "cpu", **rdv)


def test_the_watchdog_is_refused_beside_a_rendezvous(no_rdv_env, tmp_path):
    """...as a refusal no more: beside a rendezvous of 2 hosts the rank arms the heartbeat and the
    watchdog (``tpuddp/parallel/spawn.py:157``: id process_id of 2 hosts)
    while it trains, and stops them after; at one host none is armed, as
    in the JAX package. The process group itself is not made here."""
    rdv = {"coordinator_address": "h:1", "num_processes": 2, "process_id": 1}
    no_rdv_env.setenv("TPUDDP_WATCHDOG_TIMEOUT", "30")
    assert spawn.resolve_world(2, "cpu", **rdv) == (2, 2)
    no_rdv_env.setattr(spawn._backend, "setup", lambda *a, **k: None)
    no_rdv_env.setattr(spawn._backend, "cleanup", lambda: None)
    seen = {}

    def demo(rank, world, save_dir, _args):
        seen[save_dir] = sorted(os.listdir(os.path.join(save_dir, ".heartbeats"))) \
            if os.path.isdir(os.path.join(save_dir, ".heartbeats")) else None
        seen["threads"] = sorted(t.name for t in threading.enumerate()
                                 if t.name.startswith("tpuddp-"))
        return rank, world

    hosts, alone = str(tmp_path / "hosts"), str(tmp_path / "alone")
    assert spawn._worker(0, demo, 2, hosts, {}, "cpu", None, ("h:1", 1, 1)) == (1, 2)
    assert seen[hosts] == ["hb_1"]
    assert seen["threads"] == ["tpuddp-heartbeat", "tpuddp-watchdog"]
    assert not any(t.name in seen["threads"] for t in threading.enumerate())  # stopped
    assert spawn._worker(0, demo, 1, alone, {}, "cpu", None) == (0, 1)
    assert seen[alone] is None and seen["threads"] == []


def test_the_multihost_file_parses(no_rdv_env):
    settings = cfg.load_settings(os.path.join(ROOT, "tpuddp_torch", "configs", "multihost_h100.yaml"))
    jax_settings = cfg.load_settings(os.path.join(ROOT, "configs", "multihost.yaml"))
    assert settings["training"] == jax_settings["training"]
    assert settings["local"]["rendezvous"] == jax_settings["local"]["rendezvous"]
    no_rdv_env.setenv("TPUDDP_PROCESS_ID", "1")
    assert cfg.rendezvous_from(settings) == {"coordinator_address": "host0:8476",
                                             "num_processes": 2, "process_id": 1}
    world, hosts = spawn.resolve_world(cfg.world_size_from(settings), "cuda",
                                       **cfg.rendezvous_from(settings))
    cfg.check_settings(settings, world)
    assert hosts == 2 and world % 2 == 0 and cfg.training_config(settings)["model"] == "resnet18_small"


# ----------------------------------------------------------- $TPUDDP_BACKEND --

@pytest.mark.parametrize("value,want", [(None, "gloo"), ("gloo", "gloo"), ("GLOO", "gloo"),
                                        ("cpu", "gloo")])
def test_the_preferred_rung_is_tried_first(monkeypatch, value, want):
    if value is None:
        monkeypatch.delenv(backend.BACKEND_ENV, raising=False)
    else:
        monkeypatch.setenv(backend.BACKEND_ENV, value)
    assert backend.detect_backend("cpu") == want


@pytest.mark.parametrize("value", ["nccl", "tpu", "mpi"])
def test_a_rung_the_device_does_not_have_is_a_value_error(monkeypatch, value):
    monkeypatch.setenv(backend.BACKEND_ENV, value)
    with pytest.raises(ValueError, match="is not a rung of the cpu backend ladder"):
        backend.detect_backend("cpu")


def test_the_cuda_ladder_takes_nccl_or_gloo(monkeypatch):
    for value, want in (("nccl", "nccl"), ("gloo", "gloo")):
        monkeypatch.setenv(backend.BACKEND_ENV, value)
        assert backend.preferred_backend("cuda", ("nccl", "gloo")) == want
    monkeypatch.setenv(backend.BACKEND_ENV, "cpu")
    with pytest.raises(ValueError, match="cuda backend ladder"):
        backend.preferred_backend("cuda", ("nccl", "gloo"))


# --------------------------------------------------------- the coordinator --

def test_a_dead_coordinator_ends_in_the_retrys_terminal_error(monkeypatch):
    port = _free_port()
    monkeypatch.setattr(backend, "RENDEZVOUS_TIMEOUT_S", 1.0)
    policy = port_retry.RetryPolicy(**backend.RENDEZVOUS_RETRY)
    t0 = time.perf_counter()
    with pytest.raises(port_retry.RetryError) as err:
        backend.setup(1, 2, "cpu", coordinator_address=f"127.0.0.1:{port}", local_rank=0,
                      local_world=1)
    elapsed = time.perf_counter() - t0
    assert f"coordinator 127.0.0.1:{port}" in str(err.value)
    assert f"after {policy.max_attempts} attempt(s)" in str(err.value)
    # the sleeps between attempts (every jitter at its top), each attempt's
    # wait, and slack for the host
    sleeps = sum(min(policy.max_delay, policy.base_delay * 2.0 ** (a - 1)) * (1.0 + policy.jitter)
                 for a in range(1, policy.max_attempts))
    assert elapsed <= sleeps + policy.max_attempts * (1.0 + 2.0), elapsed
    assert backend.num_hosts() is None


@pytest.mark.parametrize("address", ["host0", "host0:", ":8476", "host0:port"])
def test_a_malformed_address_is_refused(address):
    with pytest.raises(ValueError, match="host:port"):
        backend.split_address(address)


# ---------------------------------------------------- two launchers, 2 x 2 --

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(process_id=None):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    for var in RDV_ENV + ("TPUDDP_WORLD_SIZE",):
        env.pop(var, None)
    if process_id is not None:
        env["TPUDDP_PROCESS_ID"] = str(process_id)
    return env


def _settings(path, out_dir, training, port=None):
    local = {"device": "cpu", "gpu": {"num_gpus": 4}}
    if port is not None:
        local["rendezvous"] = {"coordinator_address": f"127.0.0.1:{port}", "num_processes": 2}
    path.write_text(yaml.dump({"out_dir": str(out_dir), "optional_args": {"set_epoch": True},
                               "local": local, "training": training}))
    return str(path)


RUNS = {
    "flat": ("train_native", dict(TRAINING)),
    "hierarchical": ("train_native", dict(TRAINING, comm_topology="hierarchical")),
    "managed": ("train_accelerate", dict(TRAINING, fuse_steps=1)),
}


def _start(module, settings, env):
    return subprocess.Popen([sys.executable, "-m", f"tpuddp_torch.{module}", "--settings_file",
                             settings], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """Per run: the single launcher's world of 4, and two launchers of 2
    ranks each meeting at a coordinator; ``{run: {"single", "host0",
    "host1": (out_dir, stdout)}}``."""
    work = tmp_path_factory.mktemp("multihost")
    out = {}
    for wave in (("flat", "hierarchical"), ("managed",)):
        procs = {}
        for run in wave:
            module, training = RUNS[run]
            port = _free_port()
            for who, pid in (("single", None), ("host0", 0), ("host1", 1)):
                d = work / run / who
                settings = _settings(work / f"{run}_{who}.yaml", d, training,
                                     None if pid is None else port)
                procs[run, who] = (d, _start(module, settings, _env(pid)))
        for (run, who), (d, p) in procs.items():
            stdout, stderr = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, f"{run} {who}:\n{stdout[-2000:]}\n{stderr[-3000:]}"
            out.setdefault(run, {})[who] = (d, stdout)
    return out


def _arrays(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


FILES = {"flat": ("ckpt_0.npz",), "hierarchical": ("ckpt_0.npz",),
         "managed": ("model.npz", "state_0.npz")}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_two_launchers_train_bitwise_the_single_launcher(launches, run):
    single, host0 = launches[run]["single"][0], launches[run]["host0"][0]
    for name in FILES[run]:
        a, b = _arrays(single / name), _arrays(host0 / name)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {k}")
    rows = [[r for r in map(json.loads, open(d / "history.jsonl")) if r["type"] == "epoch"]
            for d in (single, host0)]
    assert len(rows[0]) == len(rows[1]) > 0
    for a, b in zip(*rows):
        for key in ("train_loss", "test_loss", "test_accuracy", "world_size"):
            assert a[key] == b[key], key


@pytest.mark.parametrize("run", sorted(RUNS))
def test_only_host_0_writes(launches, run):
    host0, out0 = launches[run]["host0"]
    host1, out1 = launches[run]["host1"]
    assert any(l.startswith("Epoch 1/1, ") for l in out0.splitlines())
    assert not any(l.startswith("Epoch ") for l in out1.splitlines())
    assert sorted(os.listdir(host1)) == [f"{run}_host1.yaml"]  # the settings' copy alone
    assert all((host0 / name).exists() for name in FILES[run])


@pytest.mark.parametrize("run", sorted(RUNS))
def test_every_rank_met_at_the_coordinator(launches, run):
    for pid in (0, 1):
        out = launches[run][f"host{pid}"][1]
        for local in (0, 1):
            rank = 2 * pid + local
            assert (f"global rank {rank} of a 4-process world, host {pid} of 2, local rank "
                    f"{local} of 2.") in out, out[-2000:]


def test_the_hierarchical_run_takes_its_hosts_from_the_rendezvous(launches):
    for who in ("host0", "host1"):
        out = launches["hierarchical"][who][1]
        assert out.count("comm_topology hierarchical on process ") == 2
        assert "2 hosts x 2 local (4-process world)." in out
    row = json.loads(open(launches["hierarchical"]["host0"][0] / "history.jsonl").readline())
    assert row["comm_topology"] == "hierarchical" and row["grad_comm_bytes_intra_host"] > 0


# ------------------------------------------------------ resume across hosts --

def test_a_resume_across_hosts_restores_process_0s_file(launches, tmp_path):
    """Every process resumes from the file process 0 finds: two launchers
    sharing host 0's out_dir continue bitwise as one launcher does from the
    same file; with host 1 on an out_dir of its own, where that file is
    not, every host stops with ``FileNotFoundError``."""
    flat = launches["flat"]
    training = dict(TRAINING, num_epochs=2)
    for name, who in (("alone", "single"), ("shared", "host0"), ("own0", "host0"),
                      ("own1", "host1")):
        shutil.copytree(flat[who][0], tmp_path / name)
    ports = set()
    while len(ports) < 2:
        ports.add(_free_port())
    shared_port, own_port = sorted(ports)
    runs = {"alone": ("alone", None, None), "shared0": ("shared", shared_port, 0),
            "shared1": ("shared", shared_port, 1), "own0": ("own0", own_port, 0),
            "own1": ("own1", own_port, 1)}
    procs = {}
    for run, (d, port, pid) in runs.items():
        settings = _settings(tmp_path / f"{run}.yaml", tmp_path / d, training, port)
        procs[run] = _start("train_native", settings, dict(_env(pid), TPUDDP_AUTO_RESUME="1"))
    out = {run: p.communicate(timeout=TIMEOUT_S) + (p.returncode,) for run, p in procs.items()}
    for run in ("alone", "shared0", "shared1"):
        assert out[run][2] == 0, f"{run}:\n{out[run][0][-2000:]}\n{out[run][1][-3000:]}"
    assert "Auto-resume: continuing from epoch 1." in out["shared0"][0]
    a, b = _arrays(tmp_path / "alone" / "ckpt_1.npz"), _arrays(tmp_path / "shared" / "ckpt_1.npz")
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for run in ("own0", "own1"):
        stdout, stderr, rc = out[run]
        assert rc != 0, stdout[-2000:]
        assert "FileNotFoundError: process 0 resumes from ckpt_0.npz" in stderr, stderr[-3000:]
        assert "shared filesystem" in stderr
    assert not (tmp_path / "own0" / "ckpt_1.npz").exists()


# ------------------------------------------------------------------ retry --



def _flaky(fails, exc=OSError):
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] <= fails:
            raise exc(f"transient {calls['n']}")
        return calls["n"]
    return fn, calls


@pytest.mark.parametrize("fails", [0, 2, 5])
def test_retry_attempts_and_backoff_are_the_jax_packages(fails):
    """``tests/test_resilience.py``'s retry cases on both packages: the same
    attempts, the same sleeps (jitter off), the same terminal error."""
    out = []
    for mod in (jax_retry, port_retry):
        sleeps = []
        fn, calls = _flaky(fails)
        policy = mod.RetryPolicy(max_attempts=4, base_delay=1.0, max_delay=3.0, jitter=0.0)
        try:
            got = mod.retry(fn, policy, describe="the-op", sleep=sleeps.append)
        except mod.RetryError as e:
            assert isinstance(e.__cause__, OSError)
            got = str(e)
        out.append((got, sleeps, calls["n"]))
    assert out[0] == out[1]
    assert out[1][1] == [1.0, 2.0, 3.0][:min(fails, 3)]


def test_retry_lets_an_interrupt_through_at_once():
    for mod in (jax_retry, port_retry):
        fn, calls = _flaky(1, KeyboardInterrupt)
        with pytest.raises(KeyboardInterrupt):
            mod.retry(fn, mod.RetryPolicy(max_attempts=5), sleep=lambda _: None)
        assert calls["n"] == 1


def test_retry_delays_are_the_jax_packages():
    import random

    jp = jax_retry.RetryPolicy(max_attempts=10, base_delay=1.0, max_delay=4.0, jitter=0.5)
    pp = port_retry.RetryPolicy(max_attempts=10, base_delay=1.0, max_delay=4.0, jitter=0.5)
    a, b = random.Random(0), random.Random(0)
    for attempt in (1, 2, 3, 6, 9):
        assert pp.delay(attempt, b) == jp.delay(attempt, a)


@pytest.mark.parametrize("kw", [dict(max_attempts=0), dict(jitter=1.5)])
def test_a_malformed_policy_is_the_jax_value_error(kw):
    with pytest.raises(ValueError) as want:
        jax_retry.RetryPolicy(**kw)
    with pytest.raises(ValueError) as got:
        port_retry.RetryPolicy(**kw)
    assert str(got.value) == str(want.value)
