"""The port's serving survivability layer (``tpuddp_torch/serving/survive.py``
and the engines' incident paths) against the JAX package's, on the CPU.

The policy pieces (``SurvivePolicy``, ``admission_deadline``,
``RetryBudget``, ``run_probation`` with a patched sleep), queue shedding and
requeue, and the serving fault kinds are compared call for call. The
engines run one fault script each in both packages, restored from one JAX
checkpoint: with one replica the loop is deterministic (every request is
queued before ``start()``), so the event rows (time-free fields), the
clients' verdicts and the streams must be equal, and every stream bitwise
the undisturbed run. Two replicas (the port on ``[cpu, cpu]``, the JAX
engine on one CPU device twice) share the work by timing, so there the
streams are compared bitwise and the events by kind. The JAX engines of a module share one set of jitted programs, so
that no test compiles them again."""

import dataclasses
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuddp import config as jax_cfg
from tpuddp.models import load_model as jax_load_model
from tpuddp.observability import schema as jax_schema
from tpuddp.resilience import faults as jax_faults
from tpuddp.serving import Request as JaxRequest
from tpuddp.serving import RequestQueue as JaxRequestQueue
from tpuddp.serving import ServingEngine as JaxServingEngine
from tpuddp.serving import survive as jax_survive
from tpuddp.serving.decode import DecodeEngine as JaxDecodeEngine
from tpuddp.training import checkpoint as jax_ckpt
from tpuddp.training.train_state import TrainState

from tpuddp_torch import config as cfg
from tpuddp_torch.observability import schema
from tpuddp_torch.resilience import faults
from tpuddp_torch.serving import NoHealthyReplicaError, Request, RequestQueue
from tpuddp_torch.serving import ServingEngine
from tpuddp_torch.serving import survive
from tpuddp_torch.serving.decode import DecodeEngine

from test_torch_port_imports import ROOT, forbidden, imported_names

torch.set_num_threads(2)

NAME, VOCAB = "transformer_tiny", 32
SHAPE = (4, 4, 1)
CPU = torch.device("cpu")
PORT, JAX = "port", "jax"


def _decode_overrides(**kw):
    out = dict(model=NAME, vocab_size=VOCAB, num_replicas=1, max_slots=4, kv_blocks=17,
               kv_block_size=8, max_seq_len=32, max_new_tokens=8, stats_window=16,
               max_queue_depth=64, recovery_backoff_s=0.0)
    out.update(kw)
    return out


def _serving_overrides(**kw):
    out = dict(model="toy_mlp", num_classes=10, input_shape=list(SHAPE), num_replicas=1,
               max_batch_size=8, max_queue_depth=64, batch_timeout_ms=0.0, stats_window=16,
               recovery_backoff_s=0.0)
    out.update(kw)
    return out


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, size=n).astype(np.int32) for n in lens]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_tf"))
    params, mstate = jax_load_model(NAME, num_classes=VOCAB).init(
        jax.random.key(31), jnp.zeros((1, 2), jnp.int32))
    state = TrainState(params=params, model_state=mstate, opt_state=(),
                       step=jnp.zeros((), jnp.int32), rng=jax.random.key(1))
    jax_ckpt.save(jax_ckpt.checkpoint_path(d, 0), state, meta={"epoch": 0, "completed": 1})
    return d


@pytest.fixture(scope="module")
def donors(weights, cpu_devices):
    """One warm engine of each JAX kind: the jitted programs every JAX
    engine of this module takes over before its start."""
    dec = JaxDecodeEngine.from_config(
        jax_cfg._merge_refusing_unknown(jax_cfg.DECODE_DEFAULTS, _decode_overrides(
            checkpoint_dir=weights), "serving.decode"), devices=cpu_devices[:1]).start()
    srv = JaxServingEngine.from_config(
        jax_cfg._merge_refusing_unknown(jax_cfg.SERVING_DEFAULTS, _serving_overrides(), "serving"),
        devices=cpu_devices[:1]).start()
    yield dec.replicas[0], srv.pool.replicas[0]
    dec.drain()
    srv.drain()


@pytest.fixture(scope="module")
def twins(weights):
    """The undisturbed streams: each prompt alone through a port engine of
    the scenario's geometry (the step's shapes are the geometry's, so a
    stream is bitwise only within one)."""
    engines = {}

    def twin(prompt, seed=0, temperature=None, **geometry):
        key = tuple(sorted(geometry.items()))
        if key not in engines:
            engines[key] = DecodeEngine.from_config(cfg.decode_config({"decode": _decode_overrides(
                checkpoint_dir=weights, **geometry)}), devices=[CPU]).start()
        return np.asarray(engines[key].submit("twin", prompt, seed=seed, temperature=temperature)
                          .result(timeout=120))

    yield twin
    for eng in engines.values():
        eng.drain()


def _decode_engine(pkg, out, weights, donors, devices, replicas=1, **kw):
    over = _decode_overrides(checkpoint_dir=weights, num_replicas=replicas, **kw)
    if pkg == PORT:
        return DecodeEngine.from_config(cfg.decode_config({"decode": over}), out_dir=out,
                                        devices=[CPU] * replicas)
    eng = JaxDecodeEngine.from_config(
        jax_cfg._merge_refusing_unknown(jax_cfg.DECODE_DEFAULTS, over, "serving.decode"),
        out_dir=out, devices=devices[:1] * replicas)  # one device twice: no second compile
    for r in eng.replicas:
        r._prefill, r._step = donors[0]._prefill, donors[0]._step
    return eng


def _serving_engine(pkg, out, donors, devices, **kw):
    over = _serving_overrides(**kw)
    if pkg == PORT:
        return ServingEngine.from_config(cfg.serving_config({"serving": over}), out_dir=out,
                                         devices=[CPU])
    eng = JaxServingEngine.from_config(
        jax_cfg._merge_refusing_unknown(jax_cfg.SERVING_DEFAULTS, over, "serving"), out_dir=out,
        devices=devices[:1])
    eng.pool.replicas[0]._fwd = donors[1]._fwd
    return eng


_TIMING = ("schema_version", "tokens_per_sec", "throughput_rps", "request")


def _events(out):
    path = os.path.join(out, "history.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return [{k: v for k, v in r.items() if k not in _TIMING} for r in rows if r["type"] == "event"]


def _verdict(result, timeout=120):
    """A stream's tokens, or its error's type and reason."""
    try:
        return np.asarray(result.result(timeout=timeout)).tolist()
    except Exception as e:  # noqa: BLE001 — the verdict is compared
        return (type(e).__name__, getattr(e, "reason", None), str(e))


def _both(fn, tmp_path, *args):
    """``fn(pkg, out_dir, *args)`` in both packages: ``{pkg: (result, events)}``."""
    out = {}
    for pkg in (PORT, JAX):
        d = str(tmp_path / pkg)
        out[pkg] = (fn(pkg, d, *args), _events(d))
    return out


def _kill_step(replica, pkg, after):
    """``replica``'s step raises once after ``after`` successful calls."""
    real = replica._step
    state = {"calls": 0, "fired": False}

    def step(*a, **k):
        if not state["fired"] and state["calls"] >= after:
            state["fired"] = True
            raise RuntimeError("injected replica death")
        state["calls"] += 1
        return real(*a, **k)

    replica._step = step
    return state


# ------------------------------------------------------------------ policy --


@pytest.mark.parametrize("bad", [dict(request_ttl_s=0), dict(max_recoveries=-1),
                                 dict(recovery_attempts=0), dict(recovery_backoff_s=-0.1),
                                 dict(retry_budget=-1), dict(max_failovers=-1)])
def test_the_policy_refuses_as_the_jax_policy(bad):
    with pytest.raises(ValueError) as jax_err:
        jax_survive.SurvivePolicy(**bad)
    with pytest.raises(ValueError) as err:
        survive.SurvivePolicy(**bad)
    assert str(err.value) == str(jax_err.value)


def test_from_config_deadlines_and_the_budget_are_the_jax_ones():
    for block in ({}, {"request_ttl_s": 1.5, "max_recoveries": 0, "retry_budget": 3},
                  {"retry_budget": None, "max_failovers": 4}):
        assert survive.SurvivePolicy.from_config(block).meta() == \
            jax_survive.SurvivePolicy.from_config(block).meta()
    for args in ((10.0, None, None), (10.0, 5.0, None), (10.0, None, 2.0), (10.0, 5.0, 2.0),
                 (10.0, 1.0, 2.0)):
        assert survive.admission_deadline(*args) == jax_survive.admission_deadline(*args)
    for mod in (survive, jax_survive):
        with pytest.raises(ValueError):
            mod.admission_deadline(10.0, None, -1.0)
    logs = []
    for mod in (survive, jax_survive):
        b, log = mod.RetryBudget(2), []
        for op, tenant in (("c", "a"), ("c", "a"), ("c", "a"), ("c", "b"), ("r", "a"), ("c", "a"),
                           ("R", "a"), ("u", "a"), ("u", "b")):
            log.append(b.try_consume(tenant) if op == "c" else b.used(tenant) if op == "u" else
                       b.refund(tenant, 10 if op == "R" else 1))
        log.append(mod.RetryBudget(0).try_consume("a"))
        logs.append(log)
    assert logs[0] == logs[1]


@pytest.mark.parametrize("fails", [0, 1, 2, 3])
def test_run_probation_retries_as_the_jax_probation(fails):
    """Attempts, verdict and the backoff's number of sleeps, with the sleep
    patched (no test sleeps through a real backoff)."""
    outcomes = []
    for mod in (survive, jax_survive):
        calls, sleeps = [], []

        def recover():
            calls.append(1)
            if len(calls) <= fails:
                raise RuntimeError("not yet")

        pol = mod.SurvivePolicy(recovery_attempts=3, recovery_backoff_s=0.5)
        ok = mod.run_probation(name="r0", recover=recover, policy=pol, sleep=sleeps.append)
        outcomes.append((ok, len(calls), len(sleeps), all(0.25 <= s <= 0.75 * 2 ** 2 for s in sleeps)))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == (fails < 3)


def test_a_probation_episode_is_the_jax_episode():
    for allowed, passes, count in ((True, True, True), (True, True, False), (True, False, True),
                                   (False, True, True)):
        rows = []
        for mod in (survive, jax_survive):
            rep = type("R", (), {})()
            rep.index, rep.state, rep.recoveries = 3, "recovering", 0 if allowed else 2

            def recover():
                if not passes:
                    raise RuntimeError("dead")

            pol = mod.SurvivePolicy(max_recoveries=2, recovery_attempts=1)
            ok, event = mod.probation_episode(rep, name="r3", recover=recover, policy=pol,
                                              count_recovery=count, lock=threading.Lock())
            rows.append((ok, event, rep.state, rep.recoveries))
        assert rows[0] == rows[1]


# ----------------------------------------------------------- queue shedding --


def _shed_script(queue_cls, request_cls):
    log = []
    q = queue_cls(max_depth=16)
    shed = []
    q.shed_handler = shed.append
    now = time.perf_counter()
    x = np.zeros((1,) + SHAPE, np.float32)
    expired, live = request_cls("a", x, deadline=now - 1), request_cls("a", x, deadline=now + 60)
    journal = request_cls("b", x, deadline=now - 1)
    journal.resume_tokens = [3, 4]
    for r in (expired, live, journal):
        q.put(r)
    group = q.take_group(8, wait=False)
    log.append([[expired, live, journal].index(r) for r in group])
    log.append(len(shed) == 1 and shed[0] is expired)
    try:
        expired.result.result(timeout=1)
    except Exception as e:  # noqa: BLE001 — each package's AdmissionError
        log.append(e.reason)
    q2 = queue_cls(max_depth=16)
    for _ in range(3):
        q2.put(request_cls("a", x, deadline=now - 1))
    log.append((q2.take_group(8, wait=False), q2.depth()))
    q3 = queue_cls(max_depth=16)
    a, b, c = (request_cls("t", x) for _ in range(3))
    q3.put(a)
    q3.put(b)
    q3.close()
    try:
        q3.put(request_cls("t", x))
    except Exception as e:  # noqa: BLE001
        log.append(e.reason)
    q3.requeue(c)
    log.append([[a, b, c].index(r) for r in q3.take_group(8, wait=False)])
    log.append(q3.take_group(8))
    return log


def test_queue_shedding_and_requeue_are_the_jax_queues():
    got = _shed_script(RequestQueue, Request)
    assert got == _shed_script(JaxRequestQueue, JaxRequest)
    assert got[0] == [1, 2] and got[-2] == [2, 0, 1] and got[-1] is None


# ------------------------------------------------------------- fault kinds --


def test_serving_fault_specs_parse_as_the_jax_specs():
    raw = "replica_kill@step=4,pool_poison@step=7,dispatch_wedge@batch=2,replica_kill@batch=9"
    assert [(s.kind, s.site, s.arg) for s in faults.parse_fault_specs(raw)] == \
        [(s.kind, s.site, s.arg) for s in jax_faults.parse_fault_specs(raw)]
    for bad in ("pool_poison@batch=1", "replica_kill@epoch=1", "nan@batch=1", "hang@batch=1"):
        with pytest.raises(ValueError) as jax_err:
            jax_faults.parse_fault_specs(bad)
        with pytest.raises(ValueError) as err:
            faults.parse_fault_specs(bad)
        assert str(err.value) == str(jax_err.value)


def test_serving_faults_are_invisible_to_the_training_hooks(monkeypatch):
    monkeypatch.setenv("TPUDDP_FAULT", "replica_kill@step=1,dispatch_wedge@batch=2")
    faults.reload_faults()
    try:
        assert not faults.has_step_fault()
        faults.maybe_fire("step", step=1)
        assert not any(s.fired for s in faults.active_faults())
        assert faults.maybe_serving_fault("batch", batch=1) is None
        assert faults.maybe_serving_fault("step", step=1) == "replica_kill"
        assert faults.maybe_serving_fault("step", step=1) is None
        assert faults.maybe_serving_fault("batch", batch=2) == "dispatch_wedge"
    finally:
        monkeypatch.delenv("TPUDDP_FAULT")
        faults.reload_faults()


@pytest.fixture
def fault_env(monkeypatch):
    """Set ``$TPUDDP_FAULT`` afresh for each package's run of a script."""

    def arm(spec):
        monkeypatch.setenv("TPUDDP_FAULT", spec)
        faults.reload_faults()
        jax_faults.reload_faults()

    yield arm
    monkeypatch.delenv("TPUDDP_FAULT", raising=False)
    faults.reload_faults()
    jax_faults.reload_faults()


# ------------------------------------------------ decode failover (1 replica) --


@pytest.mark.parametrize("lens,temperature,after", [
    ((3, 5, 12), None, 2),  # mid-decode, prompts inside their buckets
    ((8, 9), None, 1),  # an exact bucket fit and the next bucket's first length
    ((4, 6), 0.9, 2),  # the (seed, index) draws survive the failover
])
def test_failover_mid_decode(tmp_path, weights, donors, twins, cpu_devices, lens, temperature, after):
    prompts = _prompts(0, lens)

    def script(pkg, out):
        eng = _decode_engine(pkg, out, weights, donors, cpu_devices)
        results = [eng.submit("t", p, seed=7 + i, temperature=temperature) for i, p in enumerate(prompts)]
        state = _kill_step(eng.replicas[0], pkg, after)
        eng.start()
        streams = [list(r.stream(timeout=120)) for r in results]
        out_ = [_verdict(r) for r in results]
        summary = eng.drain()
        return out_, streams, state["fired"], summary["failovers"], eng.replicas[0].recoveries

    runs = _both(script, tmp_path)
    (got, streams, fired, failovers, recoveries), events = runs[PORT]
    assert fired and failovers >= 1 and recoveries == 1
    for i, p in enumerate(prompts):
        assert got[i] == streams[i] == twins(p, 7 + i, temperature).tolist()
    assert (got, failovers, recoveries) == (runs[JAX][0][0], runs[JAX][0][3], runs[JAX][0][4])
    assert events == runs[JAX][1]
    kinds = [e["event"] for e in events]
    assert kinds[:2] == ["replica_unhealthy", "replica_recovered"]
    assert kinds.count("session_failover") == failovers and kinds[-1] == "decode_drain"


def test_failover_during_prefill(tmp_path, weights, donors, twins, cpu_devices):
    p = _prompts(1, (5,))[0]

    def script(pkg, out):
        eng = _decode_engine(pkg, out, weights, donors, cpu_devices).start()
        rep, state = eng.replicas[0], {"fired": False}
        real = rep._prefill

        def prefill(*a, **k):
            if not state["fired"]:
                state["fired"] = True
                raise RuntimeError("injected prefill death")
            return real(*a, **k)

        rep._prefill = prefill
        res = eng.submit("t", p, seed=3)
        return _verdict(res), eng.drain()["failovers"]

    runs = _both(script, tmp_path)
    assert runs[PORT][0] == runs[JAX][0] == (twins(p, 3).tolist(), 1)
    assert runs[PORT][1] == runs[JAX][1]
    assert [e["event"] for e in runs[PORT][1]] == [
        "replica_unhealthy", "replica_recovered", "session_failover", "decode_drain"]


@pytest.mark.parametrize("kind", ["replica_kill", "pool_poison"])
def test_the_fault_env_kinds_fail_over_bitwise(tmp_path, weights, donors, twins, cpu_devices, fault_env, kind):
    prompts = _prompts(2, (4, 7))

    def script(pkg, out):
        fault_env(f"{kind}@step=3")
        eng = _decode_engine(pkg, out, weights, donors, cpu_devices)
        results = [eng.submit("t", p, seed=40 + i) for i, p in enumerate(prompts)]
        eng.start()
        got = [_verdict(r) for r in results]
        fired = all(s.fired for s in (faults if pkg == PORT else jax_faults).active_faults())
        summary = eng.drain()
        rep = eng.replicas[0]
        return got, fired, rep.recoveries, rep.broken, summary["failovers"]

    runs = _both(script, tmp_path)
    got, fired, recoveries, broken, failovers = runs[PORT][0]
    assert got == [twins(p, 40 + i).tolist() for i, p in enumerate(prompts)]
    assert fired and recoveries == 1 and not broken and failovers == 2
    assert runs[PORT][0] == runs[JAX][0]
    assert runs[PORT][1] == runs[JAX][1]


def test_a_poisoned_replica_never_steps_over_stale_pools(weights):
    """``pool_poison`` drops the pools (and on a card the graph bound to
    them): the next dispatch raises until ``rebuild()``; rebuilt, the canary
    passes and the replica serves."""
    eng = DecodeEngine.from_config(cfg.decode_config({"decode": _decode_overrides(
        checkpoint_dir=weights)}), devices=[CPU]).start()
    rep = eng.replicas[0]
    eng.drain()
    rep.poison()
    s, mb = rep.cache.max_slots, rep.cache.max_blocks
    zeros = np.zeros((s,), np.int32)
    with pytest.raises(RuntimeError, match="lost to pool_poison"):
        rep._step(rep.kpool, rep.vpool, np.zeros((s, mb), np.int32), zeros, zeros)
    with pytest.raises(RuntimeError, match="lost to pool_poison"):
        rep._prefill(rep.kpool, rep.vpool, np.zeros((mb,), np.int32), np.zeros((1, 1), np.int32), 1)
    rep.rebuild()
    rep.canary(eng.buckets)
    assert rep.kpool is not None and rep.cache.occupancy() == 0.0


def _poison_prefill(rep, poison):
    real = rep._prefill

    def prefill(*a, **k):
        buf, n = np.asarray(a[-2])[0], int(a[-1])
        if n == len(poison) and np.array_equal(buf[:n], poison):
            raise RuntimeError("this request kills the dispatch")
        return real(*a, **k)

    rep._prefill = prefill


def test_the_culprit_fails_through_max_failovers_innocents_ride_free(tmp_path, weights, donors, twins,
                                                                      cpu_devices):
    innocent, poison, clean = _prompts(10, (4, 6, 7))

    def script(pkg, out):
        eng = _decode_engine(pkg, out, weights, donors, cpu_devices, max_recoveries=5)
        live = eng.submit("t", innocent, seed=5)
        poisons = [eng.submit("t", poison), eng.submit("t", poison)]
        _poison_prefill(eng.replicas[0], poison)
        eng.start()
        got = [_verdict(r) for r in [live] + poisons]
        rep = eng.replicas[0]
        deadline = time.perf_counter() + 60
        while not rep.healthy and time.perf_counter() < deadline:
            time.sleep(0.01)
        got.append(_verdict(eng.submit("t", clean)))
        summary = eng.drain()
        return got, rep.recoveries, summary["completed"]

    runs = _both(script, tmp_path)
    got, recoveries, completed = runs[PORT][0]
    assert got[0] == twins(innocent, 5).tolist()
    assert got[1] == got[2] == ("RuntimeError", None, "this request kills the dispatch")
    assert recoveries == 0 and completed == 2
    assert runs[PORT][0] == runs[JAX][0]
    assert runs[PORT][1] == runs[JAX][1]


def test_probation_relapse_then_removal_at_max_recoveries(tmp_path, weights, donors, cpu_devices):
    prompts = _prompts(5, (5, 9, 3, 11))

    def script(pkg, out):
        eng = _decode_engine(pkg, out, weights, donors, cpu_devices, max_recoveries=2)
        rep = eng.replicas[0]
        eng.start()
        got = []
        for p in prompts[:3]:
            _kill_step(rep, pkg, 1)
            got.append(_verdict(eng.submit("t", p)))
            got.append((rep.recoveries, rep.state))
        got.append(_verdict(eng.submit("t", prompts[3])))
        got.append(eng.kv_occupancy())
        summary = eng.drain()
        return got, summary["completed"]

    runs = _both(script, tmp_path)
    got, completed = runs[PORT][0]
    assert got[1] == (1, "healthy") and got[3] == (2, "healthy") and got[5] == (2, "removed")
    assert got[4][:2] == got[6][:2] == ("NoHealthyReplicaError", "no_healthy_replica")
    assert completed == 2 and got[7] == 0.0
    assert runs[PORT][0] == runs[JAX][0]
    events = runs[PORT][1]
    assert events == runs[JAX][1]
    assert [e["recoveries"] for e in events if e["event"] == "replica_recovered"] == [1, 2]
    assert [e["reason"] for e in events if e["event"] == "replica_removed"] == ["max_recoveries"]
    assert schema.validate_history_file(str(tmp_path / PORT / "history.jsonl"))[0] == []


# ------------------------------------------------------------ two replicas --


def test_a_killed_replica_of_two_hands_its_sessions_over_bitwise(tmp_path, weights, donors, twins,
                                                                 cpu_devices, fault_env):
    prompts = _prompts(3, (3, 9, 5, 12, 1, 7, 4, 10))

    def script(pkg, out):
        fault_env("replica_kill@step=4")
        eng = _decode_engine(pkg, out, weights, donors, cpu_devices, replicas=2)
        results = [eng.submit("t", p, seed=20 + i) for i, p in enumerate(prompts)]
        eng.start()
        got = [_verdict(r) for r in results]
        summary = eng.drain()
        return got, summary["failovers"], [r.healthy for r in eng.replicas]

    runs = _both(script, tmp_path)
    for pkg in (PORT, JAX):
        got, failovers, healthy = runs[pkg][0]
        assert got == [twins(p, 20 + i).tolist() for i, p in enumerate(prompts)], pkg
        assert failovers >= 1 and all(healthy)
        kinds = [e["event"] for e in runs[pkg][1]]
        assert kinds.count("replica_unhealthy") == kinds.count("replica_recovered") == 1
        assert kinds.count("session_failover") == failovers and kinds[-1] == "decode_drain"


def test_the_last_replica_dying_during_drain_fails_typed_never_hangs(tmp_path, weights, donors, cpu_devices):
    p = _prompts(9, (3,))[0]

    def script(pkg, out):
        eng = _decode_engine(pkg, out, weights, donors, cpu_devices, replicas=2)
        armed = threading.Event()
        for rep in eng.replicas:
            real = rep._step

            def step(*a, _real=real, **k):
                if armed.is_set():
                    raise RuntimeError("device is gone")
                time.sleep(0.05)  # the stream outlives the idle loop's exit
                return _real(*a, **k)

            rep._step = step
        eng.start()
        res = eng.submit("t", p)
        assert next(res.stream(timeout=120)) is not None
        eng.queue.close()
        deadline = time.perf_counter() + 60
        while sum(r.loop_alive for r in eng.replicas) > 1 and time.perf_counter() < deadline:
            time.sleep(0.01)
        alive = sum(r.loop_alive for r in eng.replicas)
        armed.set()
        got = _verdict(res)[:2]
        return got, alive, eng.drain()["completed"]

    runs = _both(script, tmp_path)
    assert runs[PORT][0] == runs[JAX][0] == (("NoHealthyReplicaError", "no_healthy_replica"), 1, 0)
    kinds = [[e["event"] for e in runs[pkg][1]] for pkg in (PORT, JAX)]
    assert kinds[0] == kinds[1] == ["replica_unhealthy", "replica_removed", "no_healthy_replica",
                                    "decode_drain"]
    assert issubclass(NoHealthyReplicaError, RuntimeError)


# ---------------------------------------------------------------- deadlines --


def test_decode_deadlines_shed_queued_never_in_flight(tmp_path, weights, donors, cpu_devices):
    a_prompt, b_prompt = _prompts(7, (3, 3))

    def script(pkg, out):
        eng = _decode_engine(pkg, out, weights, donors, cpu_devices, max_slots=1, stats_window=4)
        rep = eng.replicas[0]
        real = rep._step

        def slow(*a, **k):
            time.sleep(0.04)  # A's 8 steps outlive its deadline; B waits behind them
            return real(*a, **k)

        rep._step = slow
        eng.start()
        a = eng.submit("t", a_prompt, deadline_s=0.15)
        next(a.stream(timeout=120))
        b = eng.submit("t", b_prompt, deadline_s=0.1)
        got = [_verdict(b)[:2], len(_verdict(a))]
        summary = eng.drain()
        return got, {k: summary[k] for k in ("completed", "shed", "rejected")}

    runs = _both(script, tmp_path)
    assert runs[PORT][0] == runs[JAX][0] == (
        [("AdmissionError", "deadline_exceeded"), 8],
        {"completed": 1, "shed": 1, "rejected": {"deadline_exceeded": 1}})
    path = str(tmp_path / PORT / "history.jsonl")
    assert schema.validate_history_file(path)[0] == jax_schema.validate_history_file(path)[0] == []
    with open(path) as f:
        assert sum(r["shed"] for r in map(json.loads, f) if r["type"] == "decode_stats") == 1


def test_the_request_ttl_sheds_a_backlog(tmp_path, donors, cpu_devices):
    def script(pkg, out):
        eng = _serving_engine(pkg, out, donors, cpu_devices, max_batch_size=1, request_ttl_s=0.05).start()
        rep = eng.pool.replicas[0]
        real = rep.infer
        rep.infer = lambda x: (time.sleep(0.25), real(x))[1]
        results = [eng.submit("t", np.zeros((1,) + SHAPE, np.float32)) for _ in range(3)]
        got = [np.shape(results[0].result(timeout=60))] + [_verdict(r)[:2] for r in results[1:]]
        summary = eng.drain()
        return got, {k: summary[k] for k in ("completed", "shed", "rejected")}

    runs = _both(script, tmp_path)
    assert runs[PORT][0] == runs[JAX][0] == (
        [(1, 10)] + [("AdmissionError", "deadline_exceeded")] * 2,
        {"completed": 1, "shed": 2, "rejected": {"deadline_exceeded": 2}})


# ---------------------------------------------------- retries and probation --


@pytest.mark.parametrize("fails", [1, 10])
def test_the_retry_budget_is_the_jax_budget(tmp_path, donors, cpu_devices, fails):
    """retry_budget 2: one transient failure is retried and refunded, the
    client sees a result; a persistent one spends both tokens, fails through
    and refunds them, so the next request gets its own."""

    def script(pkg, out):
        eng = _serving_engine(pkg, out, donors, cpu_devices, retry_budget=2, unhealthy_after=0).start()
        rep = eng.pool.replicas[0]
        real, state = rep.infer, {"n": 0}

        def flaky(x):
            if state["n"] < fails:
                state["n"] += 1
                raise RuntimeError("transient")
            return real(x)

        rep.infer = flaky
        got = []
        for _ in range(2):
            v = _verdict(eng.submit("t", np.ones((2,) + SHAPE, np.float32)))
            got.append(np.shape(v) if isinstance(v, list) else v)
            got.append((eng.stats.retries, eng.retry_budget.used("t")))
        summary = eng.drain()
        return got, summary["retries"], summary["completed"]

    runs = _both(script, tmp_path)
    assert runs[PORT][0] == runs[JAX][0]
    assert runs[PORT][1] == runs[JAX][1]
    got = runs[PORT][0][0]
    if fails == 1:
        assert got == [(2, 10), (1, 0), (2, 10), (1, 0)]
    else:
        assert got[0] == ("RuntimeError", None, "transient") and got[1] == (2, 0) and got[3] == (4, 0)


def test_a_serving_replica_rejoins_after_probation(tmp_path, donors, cpu_devices):
    def script(pkg, out):
        eng = _serving_engine(pkg, out, donors, cpu_devices, unhealthy_after=2).start()
        rep = eng.pool.replicas[0]
        real, state = rep.infer, {"n": 0}

        def flaky(x):
            if state["n"] < 2:
                state["n"] += 1
                raise RuntimeError("transient device blip")
            return real(x)

        rep.infer = flaky
        got = [_verdict(eng.submit("t", np.zeros((1,) + SHAPE, np.float32))) for _ in range(2)]
        got.append(np.shape(eng.submit("t", np.zeros((2,) + SHAPE, np.float32)).result(timeout=60)))
        got.append((rep.healthy, rep.recoveries))
        eng.drain()
        return got

    runs = _both(script, tmp_path)
    assert runs[PORT][0] == runs[JAX][0]
    assert runs[PORT][0][-2:] == [(2, 10), (True, 1)]
    assert runs[PORT][1] == runs[JAX][1]
    assert [e["event"] for e in runs[PORT][1]] == [
        "serving_dispatch_error", "serving_dispatch_error", "replica_unhealthy", "replica_recovered",
        "serving_drain"]


# ---------------------------------------------------------------- schema v7 --


def test_the_v7_survivability_header(tmp_path, donors, cpu_devices):
    meta = schema.make_run_meta(world_size=1)
    assert meta["survivability"] is None and schema.validate_record(meta) == []
    drifted = {k: v for k, v in meta.items() if k != "survivability"}
    assert schema.validate_record(drifted) == jax_schema.validate_record(drifted) != []
    v6 = dict(drifted, schema_version=6)
    assert schema.validate_record(v6) == jax_schema.validate_record(v6) == []
    out = str(tmp_path / "port")
    eng = _serving_engine(PORT, out, donors, cpu_devices, request_ttl_s=30.0, retry_budget=1).start()
    eng.submit("t", np.zeros((1,) + SHAPE, np.float32)).result(timeout=60)
    eng.drain()
    path = os.path.join(out, "history.jsonl")
    assert schema.validate_history_file(path)[0] == jax_schema.validate_history_file(path)[0] == []
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    pol = rows[0]["survivability"]
    assert pol == dataclasses.asdict(jax_survive.SurvivePolicy(
        request_ttl_s=30.0, retry_budget=1, recovery_backoff_s=0.0))
    windows = [r for r in rows if r["type"] == "serving_stats"]
    assert windows and all("shed" in w and "retries" in w for w in windows)


# ------------------------------------------------------------ import guard --


SERVING_FILES = sorted(
    os.path.relpath(os.path.join(d, n), ROOT)
    for d, _, names in os.walk(os.path.join(ROOT, "tpuddp_torch", "serving"))
    for n in names if n.endswith(".py")
)


def test_the_serving_package_imports_neither_jax_nor_the_jax_package():
    assert len(SERVING_FILES) == 12
    for path in SERVING_FILES + ["tpuddp_torch/utils/batching.py", "tpuddp_torch/resilience/faults.py",
                                 "tpuddp_torch/observability/trace.py", "tpuddp_torch/config.py"]:
        with open(os.path.join(ROOT, path)) as f:
            src = f.read()
        assert not [n for n in imported_names(src, path) if forbidden(n)], path
        assert "import jax" not in src and "import tpuddp\n" not in src and "from tpuddp." not in src, path
