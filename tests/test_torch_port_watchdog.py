"""The multi-host watchdog of the port (``tpuddp_torch/resilience/
watchdog.py``) against the JAX package's (``tpuddp/resilience/
watchdog.py``), on the CPU:

- heartbeat files: each package's writer read by the other's reader, the
  timestamp and the payload line, both ways, a torn payload skipped;
- ``check_once`` on one directory gives the JAX ``Watchdog``'s stale list
  at the same clock: live peers, a stale peer, no file within and past the
  startup grace, a previous run's leftover beat, a world's ids after
  ``purge_stale_peers`` (which removes the same files);
- ``start`` arms nothing where the JAX package's arms nothing; a fired
  watchdog with a callable action gets the stale list and writes the
  ``watchdog_stale`` row (a header first);
- two processes of ``tests/_torch_port_hang_worker.py`` on one heartbeat
  directory, ``$TPUDDP_WATCHDOG_TIMEOUT=3``, ``hang@barrier`` in the peer:
  the survivor exits 76 within the timeout and 15 s of slack (two process
  starts and the startup grace), and its history, a ``watchdog_stale`` row
  naming process 1 with ``lag_s`` >= 3, validates with
  ``tools/tpuddp_inspect.py --validate``.

Tolerance: exact (the same arithmetic on the same timestamps)."""

import json
import os
import subprocess
import sys
import time

import pytest

from tpuddp.resilience import watchdog as jax_wd

from tpuddp_torch.resilience import watchdog as wd
from tpuddp_torch.resilience.preemption import EXIT_WATCHDOG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_port_hang_worker.py")
T0 = 1_700_000_000.0


@pytest.mark.parametrize("writer,reader", [(wd, jax_wd), (jax_wd, wd)])
def test_heartbeat_files_cross_both_ways(tmp_path, writer, reader):
    payload = {"window": 3, "step_time_ms_p50": 12.5, "host": "h0"}
    writer.write_heartbeat(str(tmp_path), 0, now=T0 + 0.123456)
    writer.write_heartbeat(str(tmp_path), 1, now=T0 + 2.5, payload=payload)
    assert (tmp_path / "hb_0").read_bytes() == (
        f"{T0 + 0.123456:.6f}\n".encode())
    for lib in (reader, writer):
        assert lib.read_heartbeat(str(tmp_path), 0) == round(T0 + 0.123456, 6)
        assert lib.read_heartbeat(str(tmp_path), 1) == T0 + 2.5
        assert lib.read_heartbeat_payload(str(tmp_path), 0) is None
        assert lib.read_heartbeat_payload(str(tmp_path), 1) == payload
        assert lib.read_heartbeat(str(tmp_path), 7) is None
    (tmp_path / "hb_2").write_text(f"{T0}\n{{\"torn\": \n")
    assert reader.read_heartbeat_payload(str(tmp_path), 2) is None
    assert reader.read_heartbeat(str(tmp_path), 2) == T0


def _files(directory, beats):
    for pid, at in beats.items():
        jax_wd.write_heartbeat(str(directory), pid, now=at)


# name -> (beats by process id, the watchdog's start, the clock, world)
SCENARIOS = {
    "all live": ({0: T0 + 9, 1: T0 + 9.5, 2: T0 + 8}, T0, T0 + 10, 3),
    "one stale": ({0: T0 + 9, 1: T0 + 1, 2: T0 + 8}, T0, T0 + 10, 3),
    "no file, within the grace": ({0: T0 + 1}, T0, T0 + 4, 3),
    "no file, past the grace": ({0: T0 + 6}, T0, T0 + 6, 3),
    "a leftover beat, within the grace": ({0: T0 + 1, 1: T0 - 100}, T0, T0 + 4, 2),
    "a leftover beat, past the grace": ({0: T0 + 9, 1: T0 - 100}, T0, T0 + 10, 2),
    "every peer stale": ({0: T0 + 9, 1: T0 + 2, 2: T0 + 3, 3: T0 + 4}, T0, T0 + 20, 4),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_check_once_is_the_jax_watchdogs(tmp_path, name):
    beats, started, now, world = SCENARIOS[name]
    _files(tmp_path, beats)
    got = []
    for lib in (wd, jax_wd):
        dog = lib.Watchdog(str(tmp_path), 0, world, timeout=5.0)
        dog._started_at = started
        got.append((dog.check_once(now=now), dog.max_observed_lag, dog.interval))
    assert got[0] == got[1]


def test_purged_ids_are_the_jax_packages(tmp_path):
    """A previous world of 6 leaves hb_0..hb_5 (and other files); a world
    of 3 purges ids 3-5 in both packages and then watches 0-2 alike."""
    dirs = [tmp_path / "port", tmp_path / "jax"]
    for d in dirs:
        d.mkdir()
        _files(d, {i: T0 - 50 + i for i in range(6)})
        (d / "hb_x").write_text("1\n")
        (d / "notes").write_text("kept\n")
    assert wd.purge_stale_peers(str(dirs[0]), 3) == jax_wd.purge_stale_peers(str(dirs[1]), 3) == 3
    assert sorted(os.listdir(dirs[0])) == sorted(os.listdir(dirs[1])) == [
        "hb_0", "hb_1", "hb_2", "hb_x", "notes"]
    assert wd.purge_stale_peers(str(tmp_path / "missing"), 3) == 0
    lists = []
    for lib, d in zip((wd, jax_wd), dirs):
        dog = lib.Watchdog(str(d), 1, 3, timeout=5.0)
        dog._started_at = T0
        lists.append([dog.check_once(now=T0 + t) for t in (2.0, 6.0)])
    assert lists[0] == lists[1] and lists[0][0] == [] and [p for p, _ in lists[0][1]] == [0, 2]


def test_start_arms_where_the_jax_package_arms(monkeypatch, tmp_path):
    monkeypatch.delenv("TPUDDP_HEARTBEAT_DIR", raising=False)
    for raw in ("", "0", "-1", "abc"):
        monkeypatch.setenv("TPUDDP_WATCHDOG_TIMEOUT", raw)
        assert wd.watchdog_timeout_seconds() == jax_wd.watchdog_timeout_seconds()
        assert wd.start(str(tmp_path), 0, 2) is None
    monkeypatch.setenv("TPUDDP_WATCHDOG_TIMEOUT", "30")
    assert wd.watchdog_timeout_seconds() == jax_wd.watchdog_timeout_seconds() == 30.0
    assert wd.start(str(tmp_path), 0, 1) is None  # one process: no peers to watch
    assert wd.start(None, 0, 2) is None  # no directory
    assert wd.heartbeat_dir(None) is jax_wd.heartbeat_dir(None) is None
    monkeypatch.setenv("TPUDDP_HEARTBEAT_DIR", str(tmp_path / "hb"))
    assert wd.heartbeat_dir("x") == jax_wd.heartbeat_dir("x") == str(tmp_path / "hb")
    pair = wd.start(None, 1, 2)
    try:
        assert pair is not None and (tmp_path / "hb" / "hb_1").exists()
    finally:
        wd.stop(pair)
    wd.stop(None)


def test_a_fired_watchdog_acts_and_writes_its_row(tmp_path):
    from tpuddp_torch.observability import MetricsWriter, validate_history_file

    hb = tmp_path / ".heartbeats"
    hb.mkdir()
    wd.write_heartbeat(str(hb), 0, now=time.time() - 60)  # a peer long gone
    seen = []
    writer = MetricsWriter(str(tmp_path), main_only=False)
    dog = wd.Watchdog(str(hb), 1, 2, timeout=0.5, action=seen.append, interval=0.05,
                      event_writer=writer)
    dog.start()
    deadline = time.time() + 10
    while not seen and time.time() < deadline:
        time.sleep(0.05)
    dog.stop()
    writer.close()
    assert [p for p, _ in seen[0]] == [0]
    rows = [json.loads(line) for line in open(tmp_path / "history.jsonl")]
    assert [r["type"] for r in rows] == ["run_meta", "event"]
    assert rows[0]["api"] == "watchdog" and rows[0]["world_size"] is None
    assert rows[1]["event"] == "watchdog_stale" and rows[1]["stale_peers"][0]["process"] == 0
    assert validate_history_file(str(tmp_path / "history.jsonl"))[0] == []


def test_a_hung_peer_makes_the_survivor_exit_76(tmp_path):
    timeout_s = 3.0
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               TPUDDP_WATCHDOG_TIMEOUT=str(timeout_s))
    for var in ("TPUDDP_FAULT", "TPUDDP_HEARTBEAT_DIR"):
        env.pop(var, None)
    t0 = time.time()
    survivor = subprocess.Popen([sys.executable, "-u", WORKER, "0", "2", str(tmp_path)], env=env,
                                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    hanger = subprocess.Popen([sys.executable, "-u", WORKER, "1", "2", str(tmp_path)],
                              env=dict(env, TPUDDP_FAULT="hang@barrier"), cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = survivor.communicate(timeout=120)
        wall = time.time() - t0
        assert survivor.returncode == EXIT_WATCHDOG, f"{out[-1000:]}\n{err[-2000:]}"
        assert hanger.poll() is None  # hung, not dead
        assert "WORKER 0 armed" in out and "process 1" in err and "stale" in err
        assert wall < timeout_s + 15.0
    finally:
        hanger.kill()
        hanger.communicate(timeout=30)
    rows = [json.loads(line) for line in open(tmp_path / "history.jsonl")]
    stale = [r for r in rows if r.get("event") == "watchdog_stale"]
    assert rows[0]["type"] == "run_meta" and len(stale) == 1
    assert stale[0]["process"] == 0 and stale[0]["timeout_s"] == timeout_s
    assert [p["process"] for p in stale[0]["stale_peers"]] == [1]
    assert stale[0]["stale_peers"][0]["lag_s"] >= timeout_s
    inspect = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "tpuddp_inspect.py"),
         str(tmp_path / "history.jsonl"), "--validate"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert inspect.returncode == 0, inspect.stdout + inspect.stderr
