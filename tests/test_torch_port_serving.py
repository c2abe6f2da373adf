"""The port's request engine (``tpuddp_torch/serving``) against the JAX
package's (``tpuddp/serving``), on the CPU: the queue's verdicts and
round-robin order, the scheduler's buckets and padding, the shared batching
helpers, a ``toy_mlp`` at 32x32x3 restored from a JAX native checkpoint
served by two replicas of each package (logits to rtol 1e-4 / atol 1e-5;
the port's bitwise a direct forward of each padded batch), the fault path's
event rows and verdicts, the restores of both file families both ways, the
``serving_stats`` rows under both validators, mark/since, and the entry
point in process (the SIGTERM leg in a subprocess is ``slow`` and
``chaos``, as the JAX package's own)."""

import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tpuddp import config as jax_cfg
from tpuddp.models import load_model as jax_load_model
from tpuddp.observability import schema as jax_schema
from tpuddp.serving import BatchScheduler as JaxBatchScheduler
from tpuddp.serving import Request as JaxRequest
from tpuddp.serving import RequestQueue as JaxRequestQueue
from tpuddp.serving import ServingEngine as JaxServingEngine
from tpuddp.serving import ServingStats as JaxServingStats
from tpuddp.serving.replica import _restore_variables as jax_restore
from tpuddp.training import checkpoint as jax_ckpt
from tpuddp.training.train_state import TrainState
from tpuddp.utils import batching as jax_batching

from tpuddp_torch import config as cfg
from tpuddp_torch.models.convert import state_dict_from_jax
from tpuddp_torch.observability import schema
from tpuddp_torch.resilience.preemption import EXIT_PREEMPTED
from tpuddp_torch.serving import (
    AdmissionError, BatchScheduler, NoHealthyReplicaError, Request, RequestQueue, ServingEngine,
    ServingStats,
)
from tpuddp_torch.serving import __main__ as entry
from tpuddp_torch.serving.replica import _restore_variables, seeded_model
from tpuddp_torch.training import checkpoint as ckpt
from tpuddp_torch.utils import batching

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (32, 32, 3)
RTOL, ATOL = 1e-4, 1e-5
CPU2 = [torch.device("cpu"), torch.device("cpu")]


def _overrides(**kw):
    out = dict(model="toy_mlp", input_shape=list(SHAPE), num_replicas=2, max_batch_size=8,
               batch_timeout_ms=1.0, stats_window=8, seed=0, recovery_backoff_s=0.0)
    out.update(kw)
    return out


def _jax_cfg(**kw):
    return jax_cfg._merge_refusing_unknown(jax_cfg.SERVING_DEFAULTS, _overrides(**kw), "serving")


def _port_cfg(**kw):
    return cfg.serving_config({"serving": _overrides(**kw)})


def _jax_vars(seed):
    module = jax_load_model("toy_mlp", num_classes=10)
    params, mstate = module.init(jax.random.key(seed), jnp.zeros((1,) + SHAPE, jnp.float32))
    return jax.tree_util.tree_map(np.asarray, params), jax.tree_util.tree_map(np.asarray, mstate)


def _jax_native(path_dir, epoch, params, mstate):
    os.makedirs(path_dir, exist_ok=True)
    state = TrainState(params=params, model_state=mstate,
                       opt_state={"m": jax.tree_util.tree_map(np.zeros_like, params)},
                       step=jnp.zeros((), jnp.int32), rng=jax.random.key(9))
    jax_ckpt.save(jax_ckpt.checkpoint_path(str(path_dir), epoch), state,
                  meta={"epoch": epoch, "completed": 1})


def _jax_managed(path_dir, epoch, params, mstate):
    os.makedirs(path_dir, exist_ok=True)
    jax_ckpt.save(jax_ckpt.checkpoint_path(str(path_dir), epoch, prefix="state"),
                  {"params": params, "model_state": mstate}, meta={"epoch": epoch, "completed": 1})


def _assert_holds(model, params, mstate):
    want = state_dict_from_jax("toy_mlp", params, mstate)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def _rows(seed, n=16, max_rows=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(int(rng.randint(1, max_rows + 1)), *SHAPE).astype(np.float32) for _ in range(n)]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_native")
    params, mstate = _jax_vars(123)
    _jax_native(d, 3, params, mstate)
    return str(d), params, mstate


@pytest.fixture(scope="module")
def engines(weights, cpu_devices, tmp_path_factory):
    """The pair every test of this module shares: the JAX engine on two CPU
    devices and the port's on ``[cpu, cpu]``, both restored from one JAX
    native file; the port's writes ``history.jsonl``."""
    out = str(tmp_path_factory.mktemp("port_serving"))
    jax_eng = JaxServingEngine.from_config(_jax_cfg(checkpoint_dir=weights[0]),
                                           devices=cpu_devices[:2]).start()
    port = ServingEngine.from_config(_port_cfg(checkpoint_dir=weights[0]), out_dir=out,
                                     devices=CPU2).start()
    yield jax_eng, port, out
    jax_eng.drain()
    port.drain()


# ------------------------------------------------------------ shared helpers --


@pytest.mark.parametrize("n,max_batch", [(1, 1), (3, 8), (8, 8), (5, 6), (6, 6), (17, 32)])
def test_buckets_and_padding_are_the_jax_helpers(n, max_batch):
    x = np.random.RandomState(n).randn(n, 2, 3).astype(np.float32)
    y = np.arange(n, dtype=np.int32)
    assert batching.bucket_for(n, max_batch) == jax_batching.bucket_for(n, max_batch)
    assert batching.shape_key(x) == jax_batching.shape_key(x)
    bucket = batching.bucket_for(n, max_batch)
    for got, want in zip(batching.pad_batch(x, y, bucket), jax_batching.pad_batch(x, y, bucket)):
        np.testing.assert_array_equal(got, want)
    assert batching.pad_batch(x, None, bucket)[1] is None
    for fn in (batching.bucket_for, jax_batching.bucket_for):
        with pytest.raises(ValueError):
            fn(max_batch + 1, max_batch)


def test_the_serving_blocks_are_the_jax_packages(monkeypatch):
    assert cfg.SERVING_DEFAULTS == jax_cfg.SERVING_DEFAULTS
    assert cfg.DECODE_DEFAULTS == jax_cfg.DECODE_DEFAULTS
    settings = {"serving": {"model": "alexnet", "decode": {"max_slots": 4}}}
    assert cfg.serving_config(settings) == jax_cfg.serving_config(settings)
    assert cfg.decode_config(cfg.serving_config(settings)) == jax_cfg.decode_config(
        jax_cfg.serving_config(settings))
    for block in (True, None, False):
        assert cfg.decode_config({"decode": block}) == jax_cfg.decode_config({"decode": block})
    for bad in ({"serving": {"max_batch": 4}}, {"serving": {"decode": {"max_slot": 4}}}):
        with pytest.raises(ValueError) as jax_err:
            jax_cfg.decode_config(jax_cfg.serving_config(bad))
        with pytest.raises(ValueError) as err:
            cfg.decode_config(cfg.serving_config(bad))
        assert str(err.value) == str(jax_err.value)
    monkeypatch.setenv("TPUDDP_SERVING_REPLICAS", "3")
    assert cfg.serving_config({})["num_replicas"] == jax_cfg.serving_config({})["num_replicas"] == 3
    # the tune overlay's serving and decode sections merge last, as in the
    # JAX package; an empty overlay changes nothing
    monkeypatch.setenv("TPUDDP_TUNE_OVERLAY", "{}")
    assert cfg.serving_config({}) == jax_cfg.serving_config({})
    monkeypatch.setenv("TPUDDP_TUNE_OVERLAY", '{"serving": {"batch_timeout_ms": 1}, '
                       '"decode": {"max_slots": 4}}')
    assert cfg.serving_config(settings) == jax_cfg.serving_config(settings)
    assert cfg.serving_config(settings)["batch_timeout_ms"] == 1
    assert cfg.decode_config(cfg.serving_config(settings)) == jax_cfg.decode_config(
        jax_cfg.serving_config(settings))


# ------------------------------------------------------ queue and scheduler --


def _queue_script(queue_cls, request_cls):
    """One submission script: verdicts of every put, then the order groups
    are taken in (request indices)."""
    q = queue_cls(max_depth=7, per_tenant_quota=3)
    reqs, verdicts = [], []
    plan = [("a", 1), ("a", 2), ("b", 1), ("a", 1), ("a", 1), ("c", 3), ("b", 2), ("b", 1),
            ("c", 1), ("d", 1), ("b", 1)]
    for tenant, rows in plan:
        r = request_cls(tenant, np.zeros((rows, 2), np.float32))
        reqs.append(r)
        try:
            q.put(r)
            verdicts.append("ok")
        except Exception as e:  # noqa: BLE001 — the verdict is compared
            verdicts.append(getattr(e, "reason", repr(e)))
    q.close()
    try:
        q.put(request_cls("e", np.zeros((1, 2), np.float32)))
    except Exception as e:  # noqa: BLE001
        verdicts.append(e.reason)
    groups = []
    while True:
        g = q.take_group(4)
        if g is None:
            break
        groups.append([reqs.index(r) for r in g])
    return verdicts, groups


def test_the_queue_gives_the_jax_verdicts_and_round_robin_order():
    got = _queue_script(RequestQueue, Request)
    assert got == _queue_script(JaxRequestQueue, JaxRequest)
    assert {"queue_full", "tenant_quota", "draining"} <= set(got[0])


@pytest.mark.parametrize("rows", [[1], [1, 2], [3, 2, 2], [4, 4], [1, 1, 1, 1, 1]])
def test_the_scheduler_forms_the_jax_batches(rows):
    rng = np.random.RandomState(len(rows))
    xs = [rng.randn(n, 2, 2).astype(np.float32) for n in rows]
    got = BatchScheduler(RequestQueue(16), 8).form([Request("t", x) for x in xs])
    want = JaxBatchScheduler(JaxRequestQueue(16), 8).form([JaxRequest("t", x) for x in xs])
    assert (got.slices, got.rows, got.bucket, got.occupancy) == (
        want.slices, want.rows, want.bucket, want.occupancy)
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_array_equal(got.w, want.w)
    assert BatchScheduler(RequestQueue(4), 32).buckets == JaxBatchScheduler(JaxRequestQueue(4), 32).buckets


# -------------------------------------------------------------- the engines --


def test_two_replicas_serve_the_jax_logits_and_bitwise_their_batches(engines):
    jax_eng, port, _ = engines
    assert [r.device for r in port.pool.replicas] == CPU2
    batches = []
    form = port.scheduler.form
    port.scheduler.form = lambda reqs: batches.append(form(reqs)) or batches[-1]
    try:
        xs = _rows(0)
        got = [port.submit(f"t{i % 3}", x) for i, x in enumerate(xs)]
        want = [jax_eng.submit(f"t{i % 3}", x) for i, x in enumerate(xs)]
        for g, w, x in zip(got, want, xs):
            out = g.result(timeout=60)
            assert out.shape == (len(x), 10) and out.dtype == np.float32
            np.testing.assert_allclose(out, w.result(timeout=60), rtol=RTOL, atol=ATOL)
    finally:
        port.scheduler.form = form
    direct = port.pool.replicas[1].model
    with torch.inference_mode():
        for b in batches:
            ref = direct(torch.from_numpy(b.x)).numpy()
            for r, (lo, hi) in zip(b.requests, b.slices):
                np.testing.assert_array_equal(r.result.result(), ref[lo:hi])
    assert sum(b.rows for b in batches) == sum(len(x) for x in xs)


def test_admission_refusals_are_the_jax_ones(engines):
    jax_eng, port, _ = engines
    cases = [np.zeros((9,) + SHAPE, np.float32), np.zeros((1, 8, 8, 3), np.float32),
             np.zeros((1,) + SHAPE, np.float64), np.zeros((0,) + SHAPE, np.float32)]
    for x in cases:
        with pytest.raises(AdmissionError) as err:
            port.submit("t", x)
        with pytest.raises(Exception) as jax_err:
            jax_eng.submit("t", x)
        assert (err.value.reason, str(err.value)) == (jax_err.value.reason, str(jax_err.value))


def test_a_dispatch_error_fails_its_requests_not_the_engine(engines):
    _, port, _ = engines
    replicas = port.pool.replicas
    real = [r.infer for r in replicas]

    def boom(x):
        raise RuntimeError("injected dispatch failure")

    for r in replicas:
        r.infer = boom
    try:
        with pytest.raises(RuntimeError, match="injected dispatch failure"):
            port.submit("a", np.zeros((1,) + SHAPE, np.float32)).result(timeout=60)
    finally:
        for r, f in zip(replicas, real):
            r.infer = f
    assert port.submit("a", np.zeros((2,) + SHAPE, np.float32)).result(timeout=60).shape == (2, 10)
    assert all(r.healthy for r in replicas)  # one error each at most: under unhealthy_after


def _fault_script(engine_cls, config, devices, out_dir):
    """One replica whose forward always raises, ``unhealthy_after: 2`` and
    no recovery: 4 sequential requests. Each request's error type and
    reason, and the event rows (time-free fields)."""
    eng = engine_cls.from_config(config, out_dir=out_dir, devices=devices).start()
    replica = eng.pool.replicas[0]

    def dead(x):
        raise RuntimeError("replica dead")

    replica.infer = dead
    outcomes = []
    for _ in range(4):
        with pytest.raises(RuntimeError) as e:
            eng.submit("t", np.zeros((1,) + SHAPE, np.float32)).result(timeout=60)
        outcomes.append((type(e.value).__name__, getattr(e.value, "reason", None)))
    summary = eng.drain()
    with open(os.path.join(out_dir, "history.jsonl")) as f:
        events = [r for r in map(json.loads, f) if r["type"] == "event"]
    drop = ("schema_version", "throughput_rps")
    return outcomes, [{k: v for k, v in e.items() if k not in drop} for e in events], summary, replica


def test_unhealthy_after_k_errors_then_no_healthy_replica_as_the_jax_engine(cpu_devices, tmp_path):
    kw = dict(num_replicas=1, unhealthy_after=2, max_recoveries=0)
    got, events, summary, replica = _fault_script(
        ServingEngine, _port_cfg(**kw), CPU2[:1], str(tmp_path / "port"))
    want, jax_events, _, _ = _fault_script(
        JaxServingEngine, _jax_cfg(**kw), cpu_devices[:1], str(tmp_path / "jax"))
    assert got == want
    assert got[-1] == ("NoHealthyReplicaError", "no_healthy_replica")
    assert events == jax_events
    assert [e["event"] for e in events] == [
        "serving_dispatch_error", "serving_dispatch_error", "replica_unhealthy", "replica_removed",
        "no_healthy_replica", "serving_drain"]
    assert events[2] == {"type": "event", "event": "replica_unhealthy", "replica": 0,
                         "consecutive_errors": 2}
    assert replica.state == "removed" and summary["completed"] == 0
    assert issubclass(NoHealthyReplicaError, RuntimeError)


# ----------------------------------------------------------------- restores --


def test_restores_both_families_both_ways(tmp_path):
    params, mstate = _jax_vars(5)
    newer_p, newer_m = _jax_vars(6)
    d = tmp_path / "both"
    _jax_native(d, 3, params, mstate)
    _jax_managed(d, 5, newer_p, newer_m)
    for prefix, (p, m), epoch in (("ckpt", (params, mstate), 3), ("state", (newer_p, newer_m), 5),
                                  ("auto", (newer_p, newer_m), 5)):
        model = seeded_model("toy_mlp", 10, SHAPE, 7)
        assert _restore_variables(str(d), prefix, model) == epoch
        _assert_holds(model, p, m)
        t_p, t_m = _jax_vars(7)
        assert jax_restore(str(d), prefix, t_p, t_m)[2] == epoch
    # a file the port wrote, read by both packages' restores
    port_dir = tmp_path / "port"
    model = seeded_model("toy_mlp", 10, SHAPE, 11)
    ckpt.save_on_main(str(port_dir), 4, model, None, 0)
    r_p, r_m, epoch = jax_restore(str(port_dir), "auto", *_jax_vars(7))
    assert epoch == 4
    want = model.state_dict()
    for k, v in state_dict_from_jax("toy_mlp", r_p, r_m).items():
        assert torch.equal(v, want[k]), k
    other = seeded_model("toy_mlp", 10, SHAPE, 12)
    assert _restore_variables(str(port_dir), "ckpt", other) == 4
    for k, v in other.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_a_missing_checkpoint_is_the_jax_error(tmp_path):
    with pytest.raises(FileNotFoundError) as jax_err:
        jax_restore(str(tmp_path / "none"), "auto", *_jax_vars(7))
    with pytest.raises(FileNotFoundError) as err:
        _restore_variables(str(tmp_path / "none"), "auto", seeded_model("toy_mlp", 10, SHAPE, 0))
    assert str(err.value) == str(jax_err.value)


def test_the_pool_serves_the_restored_weights(engines, weights):
    _, port, _ = engines
    assert port.pool.restored_epoch == 3
    for r in port.pool.replicas:
        _assert_holds(r.model, weights[1], weights[2])


# ---------------------------------------------------------- stats and rows --


def test_serving_stats_rows_validate_under_both_validators(engines):
    _, port, out = engines
    for x in _rows(1, n=9):
        port.submit("v", x).result(timeout=60)
    port.stats.flush_window()
    path = os.path.join(out, "history.jsonl")
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    assert rows[0]["type"] == "run_meta" and rows[0]["api"] == "serving"
    assert rows[0]["survivability"] == port.survive.meta() and rows[0]["decode"] is None
    assert rows[0]["world_size"] == 2 and rows[0]["mesh"] is None
    assert any(r["type"] == "serving_stats" for r in rows)
    assert schema.validate_history_file(path)[0] == []
    assert jax_schema.validate_history_file(path)[0] == []
    drifted = [dict(r) for r in rows]
    for r in drifted:
        if r["type"] == "serving_stats":
            del r["shed"]
    assert schema.validate_history_records(drifted) == jax_schema.validate_history_records(drifted) != []


class _Batch:
    def __init__(self, requests, bucket):
        self.requests, self.bucket = requests, bucket
        self.rows = sum(r.rows for r in requests)


def test_mark_and_since_count_as_the_jax_stats():
    port, ref = ServingStats(window=0), JaxServingStats(window=0)
    for stats, req in ((port, Request), (ref, JaxRequest)):
        for _ in range(3):
            stats.record_submit()
        stats.record_batch(_Batch([req("a", np.zeros((2, 1), np.float32))], 2), 0.0, 0.0)
        mark = stats.mark()
        for _ in range(5):
            stats.record_submit()
        stats.record_reject("b", "queue_full")
        stats.record_batch(_Batch([req("a", np.zeros((3, 1), np.float32)),
                                   req("b", np.zeros((1, 1), np.float32))], 8), 0.0, 0.0)
        stats.since_result = stats.since(mark)
    keys = ("completed", "submitted", "rejected", "batches", "rows", "batch_occupancy")
    assert {k: port.since_result[k] for k in keys} == {k: ref.since_result[k] for k in keys} == {
        "completed": 2, "submitted": 5, "rejected": 1, "batches": 1, "rows": 4, "batch_occupancy": 0.5}
    assert set(port.since_result) == set(ref.since_result)
    assert set(port.summary()) == set(ref.summary())


# -------------------------------------------------------------- entry point --


def _settings(tmp_path, device="cpu", **serving):
    path = tmp_path / "serve.yaml"
    path.write_text(yaml.dump({"out_dir": str(tmp_path / "out"), "local": {"device": device},
                               "serving": _overrides(num_replicas=1, **serving)}))
    return str(path)


def test_the_entry_point_demo_prints_the_jax_summary_keys(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert entry.main(["--settings", _settings(tmp_path), "--demo", "6", "--tenants", "2"]) == 0
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert set(summary) == set(JaxServingStats().summary())
    assert summary["completed"] == 6 and summary["rejected"] == {}
    assert schema.validate_history_file(str(tmp_path / "out" / "history.jsonl"))[0] == []


def test_the_entry_point_never_serves_on_the_cpu_in_place_of_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="do not fall back to the CPU"):
        entry.main(["--settings", _settings(tmp_path, device="cuda"), "--demo", "1"])


@pytest.mark.slow
@pytest.mark.chaos
def test_sigterm_drains_and_exits_75(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    env.pop("TPUDDP_FAULT", None)
    p = subprocess.Popen([sys.executable, "-u", "-m", "tpuddp_torch.serving", "--settings",
                          _settings(tmp_path), "--demo", "8", "--serve", "60"],
                         cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        for line in p.stdout:
            lines.append(line)
            if line.startswith("serving: ready"):
                time.sleep(0.2)
                p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=60) == EXIT_PREEMPTED, "".join(lines)
    finally:
        if p.poll() is None:
            p.kill()
    summary = json.loads(lines[-1])
    assert summary["completed"] == 8
    with open(tmp_path / "out" / "history.jsonl") as f:
        events = [r["event"] for r in map(json.loads, f) if r["type"] == "event"]
    assert events[-1] == "serving_drain"
