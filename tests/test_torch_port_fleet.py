"""The fleet control plane of the port (``tpuddp_torch/fleet/``) against the
JAX package's ``tpuddp/fleet/``.

- Every case of ``tests/test_fleet.py`` but the ``bench_trend`` ones (which
  belong to the benchmark) runs on the port: the file's source with its
  ``tpuddp`` imports pointed at ``tpuddp_torch``, so each assertion the JAX
  suite holds its package to holds the port too.
- ``plan_fleet`` of both packages gives equal plans over a seeded random
  matrix of job views, and both autoscalers propose the same worlds for the
  same observation sequences.
- A serving job of the port (``python -m tpuddp_torch.serving`` on the CPU,
  exporter on) under the port's controller: both packages' ``scrape_job``
  and ``parse_prometheus`` read its live ``/metrics`` alike, and the
  autoscaler's p99 breach relaunches it at 2 replicas through
  ``$TPUDDP_SERVING_REPLICAS``.
- A port training job at world 2 (Gloo) that the controller drains and
  relaunches at world 1 when a higher-priority job arrives: exit 75, a
  ``topology_change`` 2 -> 1 row and every epoch once.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import yaml

from tpuddp.fleet import autoscale as jax_autoscale
from tpuddp.fleet import scheduler as jax_scheduler
from tpuddp_torch.fleet import autoscale, scheduler
from tpuddp_torch.fleet.controller import FleetController
from tpuddp_torch.fleet.spec import JobSpec
from tpuddp_torch.observability import schema
from tpuddp_torch.resilience.supervisor import SupervisorPolicy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SUITE = os.path.join(ROOT, "tests", "test_fleet.py")
TIMEOUT_S = 240


def _mirror(path, skip=()):
    """The test functions of ``path`` compiled against the port: its
    ``tpuddp`` imports pointed at ``tpuddp_torch``, nothing else changed."""
    with open(path) as f:
        src = f.read()
    src = re.sub(r"^(\s*)(from|import) tpuddp(\.|\s)", r"\1\2 tpuddp_torch\3", src, flags=re.M)
    ns = {"__file__": path, "__name__": "port_mirror_" + os.path.basename(path)[:-3]}
    exec(compile(src, path, "exec"), ns)
    return {k: v for k, v in ns.items()
            if k.startswith("test_") and callable(v) and not any(s in k for s in skip)}


globals().update(_mirror(JAX_SUITE, skip=("bench_trend",)))


def _env(**more):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2", TPUDDP_BACKEND="cpu")
    for var in ("TPUDDP_FAULT", "TPUDDP_AUTO_RESUME", "TPUDDP_WORLD_SIZE", "TPUDDP_MODEL_SIZE",
                "TPUDDP_SERVING_REPLICAS", "TPUDDP_TUNE_OVERLAY", "TPUDDP_SPAWNED"):
        env.pop(var, None)
    env.update({k: str(v) for k, v in more.items()})
    return env


def _records(run_dir):
    path = os.path.join(run_dir, "history.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _wait(controller, cond, what, timeout=TIMEOUT_S, poll=0.2):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        controller.step()
        if cond():
            return
        time.sleep(poll)
    raise AssertionError(f"timed out waiting for {what}: {controller.status()}")


# ------------------------------------------------------------ the planner --

def _random_views(rng, n_jobs, pool):
    views = []
    for i in range(n_jobs):
        lo = int(rng.integers(1, pool + 2))
        hi = lo + int(rng.integers(0, 3))
        running = bool(rng.integers(0, 2))
        views.append(dict(
            name=f"j{i}", priority=int(rng.integers(0, 4)), arrival=int(rng.integers(0, 6)),
            min_world=lo, max_world=hi,
            desired=None if rng.integers(0, 3) == 0 else int(rng.integers(0, hi + 3)),
            running=running, current_world=int(rng.integers(1, hi + 1)) if running else 0,
            kind=("training", "serving")[int(rng.integers(0, 2))]))
    return views


@pytest.mark.parametrize("seed", range(4))
def test_plan_fleet_matches_jax_on_a_seeded_matrix(seed):
    rng = np.random.default_rng(seed)
    for _ in range(100):
        pool = int(rng.integers(1, 9))
        views = _random_views(rng, int(rng.integers(1, 7)), pool)
        order = rng.permutation(len(views))
        jax_plan = jax_scheduler.plan_fleet(pool, [jax_scheduler.JobView(**views[i]) for i in order])
        plan = scheduler.plan_fleet(pool, [scheduler.JobView(**views[i]) for i in order])
        assert dataclasses.astuple(plan) == dataclasses.astuple(jax_plan), (pool, views)
        assert (plan.alloc, plan.slices) == (jax_plan.alloc, jax_plan.slices)
    with pytest.raises(ValueError) as jax_err:
        jax_scheduler.plan_fleet(2, [jax_scheduler.JobView("a"), jax_scheduler.JobView("a")])
    with pytest.raises(ValueError) as err:
        scheduler.plan_fleet(2, [scheduler.JobView("a"), scheduler.JobView("a")])
    assert str(err.value) == str(jax_err.value)


# --------------------------------------------------------- the autoscaler --

@pytest.mark.parametrize("seed", range(3))
def test_autoscalers_propose_alike_for_equal_scrape_sequences(seed):
    rng = np.random.default_rng(100 + seed)
    for _ in range(20):
        policy = dict(slo_p99_ms=float(rng.choice([5.0, 50.0])),
                      occupancy_high=None if rng.integers(0, 2) else 0.8,
                      shed_high=None if rng.integers(0, 2) else int(rng.integers(1, 4)),
                      hysteresis=int(rng.integers(1, 3)), cooldown_s=float(rng.choice([0, 5])),
                      shrink_factor=int(rng.integers(2, 4)))
        ours = autoscale.Autoscaler(autoscale.AutoscalePolicy(**policy))
        theirs = jax_autoscale.Autoscaler(jax_autoscale.AutoscalePolicy(**policy))
        kind = ("serving", "training")[int(rng.integers(0, 2))]
        current, lo, hi, cursor, shed, strag = 2, 1, 4, 0, 0, 0
        for t in range(30):
            cursor += int(rng.integers(0, 2))
            shed += int(rng.integers(0, 4))
            strag += int(rng.integers(0, 10) == 0)
            obs = None if rng.integers(0, 10) == 0 else {
                "p99_ms": float(rng.uniform(0.5, 100)), "occupancy": float(rng.uniform(0, 1)),
                "straggler_events": float(strag), "shed_total": float(shed),
                "fresh_cursor": float(cursor)}
            got = ours.propose("j", kind, current, lo, hi, obs, float(t))
            want = theirs.propose("j", kind, current, lo, hi, obs, float(t))
            assert got == want, (policy, kind, t)
            if got is not None:
                current = got
        assert ours.actions == theirs.actions


# ----------------------------------------------- a live serving job (CPU) --

SERVE_DEMO = 24


def _idle(scraped):
    """The scrape pairs taken with the demo's traffic served and the engine
    idle: both packages' scrapes then read one state."""
    return [(p, j) for p, j in scraped if p and j and p["fresh_cursor"] == SERVE_DEMO
            and j["fresh_cursor"] == SERVE_DEMO]


def test_a_serving_job_is_scraped_alike_and_autoscaled_to_two_replicas(tmp_path):
    run_dir = str(tmp_path / "jobs" / "serve")
    settings = str(tmp_path / "serve.yaml")
    with open(settings, "w") as f:
        yaml.safe_dump({"out_dir": run_dir,
                        "local": {"device": "cpu", "gpu": {"serving_devices": [0, 0]}},
                        "serving": {"model": "toy_mlp", "num_replicas": 1, "max_batch_size": 8,
                                    "stats_window": 8},
                        "observability": {"exporter": True}}, f)
    autoscaler = autoscale.Autoscaler(autoscale.AutoscalePolicy(slo_p99_ms=0.001, hysteresis=1,
                                                                cooldown_s=0.0))
    scraped = []

    def scraper(path):  # both packages read the live endpoint, the port's verdict acts
        port_obs, jax_obs = autoscale.scrape_job(path), jax_autoscale.scrape_job(path)
        scraped.append((port_obs, jax_obs))
        return port_obs

    autoscaler.scraper = scraper
    c = FleetController(2, fleet_dir=str(tmp_path), autoscaler=autoscaler, env=_env(),
                        supervisor_policy=SupervisorPolicy(backoff_base=0.1, backoff_cap=0.5))
    job = c.submit(JobSpec(
        name="serve", kind="serving", min_world=1, max_world=2,
        argv=(sys.executable, "-u", "-m", "tpuddp_torch.serving", "--settings", settings,
              "--demo", str(SERVE_DEMO), "--serve", "0")))
    try:
        _wait(c, lambda: job.world == 2, "the scale-up to 2 replicas")
        _wait(c, lambda: any(r.get("num_replicas") == 2 for r in _records(run_dir)),
              "the relaunched header at 2 replicas")
        from tpuddp_torch.observability.exporter import read_live_port

        _wait(c, lambda: read_live_port(run_dir) is not None, "the relaunched endpoint")
        _wait(c, lambda: _idle(scraped), "a scrape of the engine idle after its demo")
        with urllib.request.urlopen(f"http://127.0.0.1:{read_live_port(run_dir)}/metrics",
                                    timeout=5) as resp:
            page = resp.read().decode()
    finally:
        c.stop_job("serve")
        c.shutdown(timeout=60)
    live = [(p, j) for p, j in scraped if p is not None]
    assert live, "no scrape of the live endpoint"
    for port_obs, jax_obs in _idle(scraped):
        assert port_obs == jax_obs
    assert any(p["p99_ms"] is not None and p["p99_ms"] > 0 for p, _ in live)
    assert autoscale.parse_prometheus(page) == jax_autoscale.parse_prometheus(page)
    families = autoscale.parse_prometheus(page)
    for name in ("tpuddp_serving_completed_total", "tpuddp_serving_shed_total",
                 "tpuddp_serving_batch_occupancy"):
        assert name in families, name
    assert autoscale.metric_value(families, "tpuddp_serving_e2e_ms", quantile="0.99") is not None
    assert [a["action"] for a in autoscaler.actions][:1] == ["scale_up"]
    assert [h for _, h, w in job.supervisor.history] == [75, 75] and \
        [w for _, _, w in job.supervisor.history] == [1, 2]
    headers = [r for r in _records(run_dir) if r.get("type") == "run_meta"]
    assert [h["num_replicas"] for h in headers] == [1, 2]
    errors, n = schema.validate_history_file(os.path.join(run_dir, "history.jsonl"))
    assert not errors and n > 2


# ---------------------------------- a training job resized 2 -> 1 (Gloo) --

EPOCHS = 4


def test_a_world_2_training_job_is_drained_and_relaunched_at_world_1(tmp_path):
    """The fleet's elastic resize on the port: a ``toy_mlp`` job of the
    native entry point at world 2 (Gloo, ``min_world`` 1) is displaced by a
    higher-priority arrival on a pool of 2: SIGTERM, exit 75 with its
    emergency checkpoint, relaunched at ``$TPUDDP_WORLD_SIZE=1`` where the
    elastic restore refits the file (a ``topology_change`` 2 -> 1 row, the
    header's ``resumed_from_world``); every epoch lands once."""
    run_dir = str(tmp_path / "jobs" / "train")
    settings = str(tmp_path / "train.yaml")
    with open(settings, "w") as f:
        yaml.safe_dump({"out_dir": run_dir, "local": {"device": "cpu"},
                        "training": {"model": "toy_mlp", "data_root": "/nonexistent",
                                     "synthetic_n": [256, 32], "train_batch_size": 8,
                                     "test_batch_size": 16, "num_epochs": EPOCHS,
                                     "checkpoint_epoch": 1, "image_size": None, "seed": 0,
                                     "scan_steps": 1}}, f)
    c = FleetController(2, fleet_dir=str(tmp_path), env=_env(),
                        supervisor_policy=SupervisorPolicy(backoff_base=0.1, backoff_cap=0.5))
    job = c.submit(JobSpec(name="train", kind="training", priority=0, min_world=1, max_world=2,
                           argv=(sys.executable, "-u", "-m", "tpuddp_torch.train_native",
                                 "--settings_file", settings)))
    try:
        c.step()
        assert job.supervisor.world_size == 2
        _wait(c, lambda: any(r.get("type") == "epoch" for r in _records(run_dir)),
              "the first epoch at world 2")
        filler = c.submit(JobSpec(name="filler", kind="training", priority=1, min_world=1,
                                  max_world=1,
                                  argv=(sys.executable, "-c", "import time; time.sleep(600)")))
        _wait(c, lambda: job.state in ("done", "failed"), "the resized job to finish")
        assert job.state == "done", (job.state, job.exit_code)
        assert filler.state == "running" and job.resizes >= 1
    finally:
        c.shutdown(timeout=60)
    assert [(rc, w) for _, rc, w in job.supervisor.history] == [(75, 2), (0, 1)]
    records = _records(run_dir)
    assert sorted({r["epoch"] for r in records if r.get("type") == "epoch"}) == list(range(EPOCHS))
    topo = [r for r in records if r.get("event") == "topology_change"]
    assert topo and (topo[0]["from_world"], topo[0]["to_world"]) == (2, 1)
    metas = [r for r in records if r.get("type") == "run_meta"]
    assert [m["world_size"] for m in metas] == [2, 1] and metas[1]["resumed_from_world"] == 2
    preempt = [r for r in records if r.get("event") == "preempt"]
    assert len(preempt) == 1 and preempt[0]["completed"] == 0
    errors, _ = schema.validate_history_file(os.path.join(run_dir, "history.jsonl"))
    assert not errors
