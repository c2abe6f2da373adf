"""The port's live telemetry plane (``tpuddp_torch/observability/{flight,
exporter,aggregate}.py``, the ``observability`` block) against the JAX
package's, on the CPU, mirroring ``tests/test_observability.py:662-1435``:

- ``resolve_observability`` is the JAX one on a set of blocks, its
  ``ValueError`` texts included; ``advisor: true`` is refused naming "fleet
  and tune";
- with no block, ``true``, ``false`` or a mapping, a port run's ``run_meta``
  ``observability`` field and the flight, trace and port files its drain
  leaves are the JAX loop's, on both paths;
- both exporters render the same ``/metrics`` bytes and ``/snapshot``
  series for the same sources; the endpoints, the port file per host and
  the scrape of a recorder's last window;
- the heartbeat shard channel reads across the packages; both pod
  aggregators give the same pod view and the same ``straggler`` rows at the
  exact ratio and window;
- flight recordings: the ring bound, the validators of both packages
  (drift refused with the same texts), the JAX inspector's ``--validate``
  and summary, names per host; dumps on an exception, a desync, a drain
  (exit 75), the drain's forced exit and the watchdog's exit 76 (in
  subprocesses); the supervisor's summary before a restart.
"""

import json
import logging
import os
import subprocess
import sys
import textwrap
import time
import urllib.error
import urllib.request
from functools import partial

import jax
import numpy as np
import pytest
import torch

from tpuddp import config as jax_config
from tpuddp.observability import aggregate as jax_aggregate
from tpuddp.observability import exporter as jax_exporter
from tpuddp.observability import schema as jax_schema
from tpuddp.resilience import faults as jax_faults
from tpuddp.resilience import preemption as jax_preemption

from tpuddp_torch import config as cfg
from tpuddp_torch.observability import aggregate, exporter, flight, schema
from tpuddp_torch.observability.flight import FlightRecorder, find_recordings
from tpuddp_torch.observability.telemetry import RunTelemetry
from tpuddp_torch.parallel.spawn import run_ddp_training
from tpuddp_torch.resilience import faults, preemption, supervisor, watchdog
from tpuddp_torch.train_accelerate import basic_accelerate_training
from tpuddp_torch.train_native import basic_ddp_training_loop
from tpuddp_torch.training.loop import StepClock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSPECT = os.path.join(ROOT, "tools", "tpuddp_inspect.py")
TRAINING = {"model": "toy_mlp", "data_root": "/nonexistent", "synthetic_n": [64, 16],
            "train_batch_size": 8, "test_batch_size": 16, "num_epochs": 2, "checkpoint_epoch": 1,
            "image_size": None, "seed": 0, "prefetch": False, "step_stats_every": 4}

torch.set_num_threads(2)


def _stamp(rtype, record):
    return schema.stamp(rtype, record)


# ------------------------------------------------------------ the config --

BLOCKS = [
    None, True, False, {}, {"exporter": True}, {"exporter": {"host": "0.0.0.0", "port": 9100}},
    {"exporter": {"port": 7}, "exporter_port": 5}, {"tracing": True, "trace_capacity": 8},
    {"straggler_ratio": 2.0, "straggler_windows": 5, "aggregate": False},
    {"flight_recorder": False, "flight_capacity": 3},
    {"straggler_ration": 2.0}, {"exporter": {"prot": 1}}, {"tracing": True, "trace_capacty": 1},
    "yes", 3,
]


@pytest.mark.parametrize("block", BLOCKS, ids=[f"b{i}" for i in range(len(BLOCKS))])
def test_resolve_observability_is_the_jax_one(block):
    results = []
    for resolve in (cfg.resolve_observability, jax_config.resolve_observability):
        try:
            results.append(("ok", resolve(block)))
        except ValueError as e:
            results.append(("ValueError", str(e)))
    assert results[0] == results[1]
    assert cfg.OBSERVABILITY_DEFAULTS == jax_config.OBSERVABILITY_DEFAULTS


def test_the_advisor_is_refused_naming_fleet_and_tune():
    """``observability.advisor: true`` is ported (the flight recorder's
    ``pending_tune`` context): the block resolves as the JAX package's does
    and the settings check takes it."""
    for block in ({"advisor": True}, {"advisor": 1, "exporter": True}):
        assert cfg.resolve_observability(block) == jax_config.resolve_observability(block)
        assert cfg.observability_config({"observability": block}) == \
            jax_config.observability_config({"observability": block})
        cfg.check_settings({"observability": block})
    assert cfg.resolve_observability({"advisor": True})["advisor"] is True
    assert cfg.observability_config({}) == jax_config.observability_config({})
    cfg.check_settings({"observability": {"exporter": True, "tracing": True}})


# ------------------------------------------- the header and the run dir --

def _reset():
    for lib in (faults, jax_faults):
        lib.reload_faults()
    for lib in (preemption, jax_preemption):
        lib.reset_preemption()


def _drained(fn):
    """``fn()`` under ``preempt@epoch=1``: trains epoch 0, then drains (the
    grace failsafe's window made longer than the test, as the JAX
    failsafe's thread is not cancelled by its reset)."""
    os.environ.update(TPUDDP_FAULT="preempt@epoch=1", TPUDDP_PREEMPT_GRACE="3600")
    _reset()
    try:
        fn()
    except (SystemExit, preemption.TrainingPreempted, jax_preemption.TrainingPreempted):
        pass
    finally:
        os.environ.pop("TPUDDP_FAULT", None)
        os.environ.pop("TPUDDP_PREEMPT_GRACE", None)
        _reset()


def _port_run(path, out, block):
    worker = basic_ddp_training_loop if path == "native" else basic_accelerate_training
    run_ddp_training(partial(worker, training=cfg.training_config({"training": TRAINING}),
                             device="cpu", observability=cfg.resolve_observability(block)),
                     1, str(out), {}, backend="cpu")


def _jax_run(path, out, block):
    # the JAX preempt fault signals the process: its handler sets the flag
    jax_preemption.install_preemption_handler()
    try:
        _jax_loop(path, out, block)
    finally:
        jax_preemption.uninstall_preemption_handler()


def _jax_loop(path, out, block):
    training = jax_config.training_config({"training": TRAINING})
    if path == "managed":
        import train_accelerate as jax_entry

        jax_entry.basic_accelerate_training(str(out), training, num_chips=1, observability=block)
        return
    from tpuddp import optim as jax_optim
    from tpuddp.data import ShardedDataLoader, load_datasets_for
    from tpuddp.models import ToyMLP
    from tpuddp.nn import CrossEntropyLoss
    from tpuddp.parallel import make_mesh
    from tpuddp.parallel.ddp import DistributedDataParallel
    from tpuddp.training.loop import run_training_loop

    mesh = make_mesh(jax.devices("cpu")[:1])
    train, test = load_datasets_for(training)
    ddp = DistributedDataParallel(ToyMLP(), jax_optim.Adam(1e-3), CrossEntropyLoss(), mesh=mesh)
    state = ddp.init_state(jax.random.key(0), jax.numpy.zeros((1, *train.images.shape[1:])))
    run_training_loop(ddp, state, ShardedDataLoader(train, 8, mesh, shuffle=True),
                      ShardedDataLoader(test, 16, mesh), str(out), num_epochs=2,
                      checkpoint_epoch=1, step_stats_every=4, log=lambda *_: None,
                      observability=block)


def _plane_files(out):
    return sorted(f for f in os.listdir(out)
                  if f.startswith(("flightrec_", "trace_", "exporter")))


def _header_obs(out):
    with open(out / "history.jsonl") as f:
        obs = json.loads(f.readline())["observability"]
    if obs["exporter"]:
        assert obs["exporter"]["port"] > 0  # the bound port
        obs = dict(obs, exporter=dict(obs["exporter"], port="bound"))
    return obs


HEADER_BLOCKS = [None, True, False, {"exporter": True, "flight_capacity": 8, "tracing": True,
                                     "straggler_windows": 2}]


@pytest.mark.parametrize("path", ["native", "managed"])
def test_the_header_and_the_drained_run_dir_are_the_jax_loops(tmp_path, path):
    """The repair of the port's header: the same settings give the JAX
    loop's ``observability`` field and the same flight/trace/port files
    after a drain; the default drain leaves ``flightrec_preempt.json``."""
    for i, block in enumerate(HEADER_BLOCKS):
        ours, theirs = tmp_path / f"port{i}", tmp_path / f"jax{i}"
        _drained(lambda: _port_run(path, ours, block))
        _drained(lambda: _jax_run(path, theirs, block))
        assert _header_obs(ours) == _header_obs(theirs), block
        assert _plane_files(ours) == _plane_files(theirs), block
        if block in (None, True):
            assert _plane_files(ours) == ["flightrec_preempt.json"]
        for name in _plane_files(ours):
            if name.startswith("flightrec_"):
                _check_preempt_recording(ours / name)


def _check_preempt_recording(path):
    errors, _ = schema.validate_flight_file(str(path))
    assert errors == [] and jax_schema.validate_flight_file(str(path))[0] == []
    with open(path) as f:
        payload = json.load(f)
    assert payload["reason"] == "preempt" and payload["process_index"] == 0
    preempts = [e for e in payload["records"]["event"] if e["event"] == "preempt"]
    assert len(preempts) == 1
    assert payload["notes"]["emergency_step"] == preempts[0]["step"]
    assert payload["records"]["epoch"] and payload["run_meta"]["api"] in ("native", "managed")
    if payload["run_meta"]["api"] == "native":
        assert os.path.exists(payload["notes"]["emergency_checkpoint"])


def test_loop_dumps_on_an_exception_and_on_a_desync(tmp_path, monkeypatch):
    class Poisoned:
        def __init__(self, inner):
            self.inner = inner

        def __getattr__(self, name):
            return getattr(self.inner, name)

        def __len__(self):
            return len(self.inner)

        def __iter__(self):
            it = iter(self.inner)
            yield next(it)
            raise RuntimeError("injected loader failure")

    from tpuddp_torch import train_native
    from tpuddp_torch.training import loop

    training = cfg.training_config({"training": TRAINING})
    ddp, train_loader, test_loader, seed = train_native.build_training(0, 1, training, "cpu")
    with pytest.raises(RuntimeError, match="injected loader failure"):
        loop.run_training_loop(ddp, Poisoned(train_loader), test_loader, str(tmp_path / "exc"),
                               num_epochs=2, step_stats_every=2, base_seed=seed,
                               log=lambda *_: None)
    path = tmp_path / "exc" / "flightrec_exception.json"
    assert schema.validate_flight_file(str(path))[0] == []
    with open(path) as f:
        payload = json.load(f)
    assert payload["reason"] == "exception" and payload["run_meta"]["api"] == "native"
    assert flight._registry == []  # the loop's finally uninstalled it

    ddp.guard = ddp.guard.__class__(**dict(vars(ddp.guard), enabled=True,
                                          audit_every_n_epochs=1))
    monkeypatch.setattr(loop.guard_lib, "audit_params", lambda model: "['fc'].w")
    with pytest.raises(loop.guard_lib.ReplicaDesync):
        loop.run_training_loop(ddp, train_loader, test_loader, str(tmp_path / "desync"),
                               num_epochs=1, base_seed=seed, log=lambda *_: None)
    with open(tmp_path / "desync" / "flightrec_desync.json") as f:
        payload = json.load(f)
    assert payload["reason"] == "desync"
    assert [e["event"] for e in payload["records"]["event"]] == ["desync"]
    assert not (tmp_path / "desync" / "flightrec_exception.json").exists()


def _subprocess(code, tmp_path, env=None, timeout=60):
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout,
                          env=dict(os.environ, PYTHONPATH=ROOT, **(env or {})))


def test_the_watchdog_exits_76_after_its_dump(tmp_path):
    code = f"""
        import os, time
        from tpuddp_torch.observability import flight, schema
        from tpuddp_torch.resilience import watchdog
        rec = flight.install(flight.FlightRecorder({str(tmp_path)!r}, capacity=4,
                                                   process_index=1))
        rec.observe(schema.stamp("event", {{"event": "skipped_updates", "epoch": 0}}))
        hb = os.path.join({str(tmp_path)!r}, ".heartbeats")
        os.makedirs(hb)
        watchdog.write_heartbeat(hb, 0, now=time.time() - 60)  # a peer long gone
        dog = watchdog.Watchdog(hb, 1, 2, timeout=0.3, interval=0.05).start()
        time.sleep(30)
    """
    proc = _subprocess(code, tmp_path)
    assert proc.returncode == watchdog.EXIT_WATCHDOG, proc.stderr[-2000:]
    path = tmp_path / "flightrec_watchdog_p1.json"  # host 1's name
    assert schema.validate_flight_file(str(path)) == jax_schema.validate_flight_file(str(path))
    with open(path) as f:
        assert json.load(f)["reason"] == "watchdog"


def test_the_forced_drain_dumps_and_a_wedged_dump_does_not_hold_the_exit(tmp_path):
    code = f"""
        import time
        from tpuddp_torch.observability import flight
        from tpuddp_torch.resilience import preemption
        flight.install(flight.FlightRecorder({str(tmp_path / "ok")!r}, process_index=0))
        class Wedged(flight.FlightRecorder):
            def dump(self, reason):
                time.sleep(600)
        if WEDGE:
            flight.install(Wedged(None))
        preemption.request_preemption()
        time.sleep(60)
    """
    for wedge in (False, True):
        t0 = time.monotonic()
        proc = _subprocess(code.replace("WEDGE", str(wedge)), tmp_path,
                           env={"TPUDDP_PREEMPT_GRACE": "0.2"})
        assert proc.returncode == preemption.EXIT_PREEMPTED, proc.stderr[-2000:]
        assert time.monotonic() - t0 < 45
    path = tmp_path / "ok" / "flightrec_preempt_forced.json"
    assert schema.validate_flight_file(str(path))[0] == []


# -------------------------------------------------------------- exporter --

def _scrape(port, path="/metrics"):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10).read()


def _prom_value(text, name, labels=""):
    needle = f"{name}{labels} " if labels else f"{name} "
    for line in text.splitlines():
        if line.startswith(needle):
            return float(line.split()[-1])
    return None


def test_exporter_ephemeral_bind_and_endpoints(tmp_path):
    a = exporter.MetricsExporter(port=0, run_dir=str(tmp_path)).start()
    b = exporter.MetricsExporter(port=0).start()
    try:
        assert a.port and b.port and a.port != b.port
        assert int((tmp_path / exporter.PORT_FILENAME).read_text().splitlines()[0]) == a.port
        assert exporter.read_live_port(str(tmp_path)) == a.port
        a.register_source("t", lambda: {"x_total": exporter.counter(3, "x")})
        assert _prom_value(_scrape(a.port).decode(), "tpuddp_x_total") == 3
        health = json.loads(_scrape(a.port, "/healthz"))
        assert health["status"] == "ok" and health["uptime_s"] >= 0
        assert json.loads(_scrape(a.port, "/snapshot"))["series"]["x_total"]["value"] == 3
        with pytest.raises(Exception):
            _scrape(a.port, "/nope")
        a.register_source("bad", lambda: 1 / 0)  # a failing source is left out
        assert b"tpuddp_x_total 3" in _scrape(a.port)
    finally:
        a.stop()
        b.stop()
    assert not (tmp_path / exporter.PORT_FILENAME).exists()
    assert exporter.read_live_port(str(tmp_path)) is None
    (tmp_path / exporter.PORT_FILENAME).write_text(f"{a.port}\n127.0.0.1\n")  # a dead one
    assert exporter.read_live_port(str(tmp_path)) is None
    a.stop()  # idempotent


def _sources():
    return {
        "training": lambda: {
            "train_steps_total": exporter.counter(12, "train steps since loop entry"),
            "epoch": exporter.gauge(1, "current epoch"),
            "step_time_ms": exporter.summary({"0.5": 1.25, "0.95": None, "0.99": 3.0, "1.0": 7},
                                             "last-window per-step wall time", count=4),
            "mfu": exporter.gauge(None, "null samples are left out"),
            "train_loss": exporter.gauge(0.125, "last completed epoch train loss"),
        },
        "tenants": lambda: {
            "serving_tenant_completed_total": {
                "type": "counter", "help": "h",
                "values": [({"tenant": 'acme"prod\\x\ny'}, 3), ({"tenant": "b"}, 2.5)]},
            "pod_hosts": {"type": "gauge", "value": 2, "labels": {"pod": "a", "az": "1"}},
        },
    }


def test_prometheus_bytes_and_snapshot_series_are_the_jax_exporters():
    ours, theirs = exporter.MetricsExporter(port=0), jax_exporter.MetricsExporter(port=0)
    for e in (ours, theirs):
        for name, fn in _sources().items():
            e.register_source(name, fn)
    assert ours.render_prometheus() == theirs.render_prometheus()
    assert json.dumps(ours.snapshot()["series"]) == json.dumps(theirs.snapshot()["series"])
    ours.start()
    theirs.start()
    try:
        assert _scrape(ours.port) == _scrape(theirs.port)
        snaps = [json.loads(_scrape(e.port, "/snapshot")) for e in (ours, theirs)]
        assert snaps[0]["series"] == snaps[1]["series"] and snaps[0]["scrapes"] == 1
    finally:
        ours.stop()
        theirs.stop()
    line = [x for x in ours.render_prometheus().splitlines()
            if x.startswith("tpuddp_serving_tenant_completed_total{tenant=\"acme")][0]
    assert line == 'tpuddp_serving_tenant_completed_total{tenant="acme\\"prod\\\\x\\ny"} 3'
    # a non-finite gauge (a blown-up epoch's loss) fails the rendering in
    # both packages alike: /metrics answers a whole 500, /snapshot a null
    for e in (ours, theirs):
        e.register_source("nan", lambda: {"test_loss": exporter.gauge(float("nan"))})
        with pytest.raises(ValueError, match="NaN"):
            e.render_prometheus()
        assert e.snapshot()["series"]["test_loss"]["value"] is None
    ours.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _scrape(ours.port)
        assert err.value.code == 500 and err.value.read().decode().endswith("\n")
    finally:
        ours.stop()


def test_exporter_port_file_per_host_name(tmp_path, monkeypatch):
    monkeypatch.setattr(jax, "process_index", lambda: 2)
    block = {"exporter": True, "exporter_port": 0}
    assert exporter.exporter_from_config({"exporter": False}) is None
    e = exporter.exporter_from_config(block, run_dir=str(tmp_path), process_index=2)
    assert e.port_filename == jax_exporter.exporter_from_config(block).port_filename \
        == "exporter_p2.port"
    assert exporter.exporter_from_config(block).port_filename == "exporter.port"  # host 0
    e.start()
    try:
        assert int((tmp_path / "exporter_p2.port").read_text().splitlines()[0]) == e.port
        assert not (tmp_path / "exporter.port").exists()
    finally:
        e.stop()
    assert not (tmp_path / "exporter_p2.port").exists()


def test_exporter_scrape_matches_recorder_state():
    """/metrics holds the recorder's last window exactly, and the gauges
    the loop adds (``update_live``)."""
    tel = RunTelemetry(writer=None, step_stats_every=4)
    e = exporter.MetricsExporter(port=0).start()
    try:
        tel.attach_live(exporter=e)
        clock = StepClock(torch.device("cpu"))
        tel.start_epoch(0, clock)
        for _ in range(4):
            clock.mark()
            tel.post_dispatch(1, 8)
        tel.update_live(skipped_steps=2, train_loss=0.5)
        text = _scrape(e.port).decode()
        win = tel.recorder.last_window
        assert win is not None and tel.recorder.windows_emitted == 1
        assert _prom_value(text, "tpuddp_train_steps_total") == 4
        assert _prom_value(text, "tpuddp_train_samples_total") == 32
        for q, key in (("0.5", "step_time_ms_p50"), ("0.99", "step_time_ms_p99")):
            assert _prom_value(text, "tpuddp_step_time_ms", f'{{quantile="{q}"}}') == \
                pytest.approx(win[key])
        assert _prom_value(text, "tpuddp_train_samples_per_sec") == pytest.approx(
            win["samples_per_sec"])
        assert _prom_value(text, "tpuddp_skipped_steps") == 2
        assert _prom_value(text, "tpuddp_train_loss") == 0.5
    finally:
        e.stop()
        tel.finish()
    assert tel.exporter is None and not e._sources


# ---------------------------------------------- shards and the aggregator --

def test_the_shard_channel_reads_across_the_packages(tmp_path):
    shard = {"window_index": 3, "step_time_ms_p50": 1.5, "skipped_steps": 0}
    aggregate.publish_shard(str(tmp_path), 1, shard)
    assert jax_aggregate.read_shard(str(tmp_path), 1) == aggregate.read_shard(str(tmp_path), 1) \
        == shard
    jax_aggregate.publish_shard(str(tmp_path), 2, dict(shard, window_index=4))
    assert aggregate.read_shard(str(tmp_path), 2)["window_index"] == 4
    assert watchdog.read_heartbeat(str(tmp_path), 1) is not None
    watchdog.write_heartbeat(str(tmp_path), 3, now=123.0)  # a beat with no payload
    assert aggregate.read_shard(str(tmp_path), 3) is None
    with open(tmp_path / "hb_4", "w") as f:
        f.write('456.0\n{"window_index": 9, "step_time')  # torn mid-write
    assert watchdog.read_heartbeat(str(tmp_path), 4) == 456.0
    assert aggregate.read_shard(str(tmp_path), 4) is None and \
        jax_aggregate.read_shard(str(tmp_path), 4) is None
    assert aggregate.read_shard(str(tmp_path), 7) is None
    live = {"windows_emitted": 5, "epoch": 1, "step": 20, "step_time_ms_p50": 2.0,
            "host_stall_ms_total": 3.0, "samples_per_sec": 10.0}
    ours, theirs = aggregate.make_shard(live, 2), jax_aggregate.make_shard(live, 2)
    assert sorted(ours) == sorted(theirs)
    assert {k: ours[k] for k in aggregate.SHARD_FIELDS} == \
        {k: theirs[k] for k in aggregate.SHARD_FIELDS}
    # the elastic purge keeps the live world's shards
    (tmp_path / "p").mkdir()
    for pid in range(4):
        aggregate.publish_shard(str(tmp_path / "p"), pid, {"window_index": pid})
    assert watchdog.purge_stale_peers(str(tmp_path / "p"), 2) == 2
    assert [aggregate.read_shard(str(tmp_path / "p"), pid)["window_index"] for pid in (0, 1)] \
        == [0, 1]


def _publish(directory, p50s, window, lib=aggregate):
    for pid, p50 in enumerate(p50s):
        lib.publish_shard(str(directory), pid, {
            "window_index": window, "epoch": 0, "step": window * 4, "step_time_ms_p50": p50,
            "host_stall_ms": 1.0, "skipped_steps": pid, "samples_per_sec": 100.0})


SEQUENCE = ([(w, [1.0, 1.0, 1.1, 0.9]) for w in range(1, 5)]
            + [(w, [1.0, 1.0, 1.0, 2.0]) for w in range(5, 9)]
            + [(8, [1.0, 1.0, 1.0, 2.0])] * 2  # a stalled window: no streak
            + [(9, [1.0, 1.0, 1.0, 1.0])]
            + [(w, [1.0, 1.0, 1.0, 3.0]) for w in range(10, 13)]
            + [(13, [1.0, 1.0, 1.5, 1.0]), (14, [1.0, 1.0, 1.5001, 1.0]),
               (15, [1.0, 1.0, 1.6, 1.0]), (16, [1.0, 1.0, 1.6, 1.0])])


@pytest.mark.parametrize("ratio,windows", [(1.5, 3), (1.5, 1), (2.5, 2)])
def test_pod_view_and_straggler_rows_are_the_jax_aggregators(tmp_path, ratio, windows):
    rows = {"port": [], "jax": []}

    class W:
        def __init__(self, key):
            self.key = key

        def write(self, record):
            rows[self.key].append(record)

    ours = aggregate.PodAggregator(str(tmp_path), 4, writer=W("port"), straggler_ratio=ratio,
                                   straggler_windows=windows)
    theirs = jax_aggregate.PodAggregator(str(tmp_path), 4, writer=W("jax"),
                                         straggler_ratio=ratio, straggler_windows=windows)
    assert ours.update() is None and theirs.update() is None  # nothing published yet
    for window, p50s in SEQUENCE:
        _publish(tmp_path, p50s, window)
        a, b = ours.update(), theirs.update()
        assert a == b
        assert a["pod_step_time_ms_p50"] == pytest.approx(np.median(p50s))
        assert a["pod_step_time_ms_p95"] == pytest.approx(np.percentile(p50s, 95), abs=1e-4)
        assert a["pod_host_stall_ms"] == 4.0 and a["pod_skipped_steps"] == 6
    assert rows["port"] == rows["jax"]
    assert rows["port"], "no straggler row"
    assert all(r["type"] == "event" and r["event"] == "straggler" and r["windows"] >= windows
               for r in rows["port"])
    assert schema.validate_history_records([schema.make_run_meta(world_size=4)] + rows["port"]) \
        == []
    assert ours.export_source()() == theirs.export_source()()
    for lib in (aggregate, jax_aggregate):
        with pytest.raises(ValueError, match="straggler_ratio"):
            lib.PodAggregator(str(tmp_path), 2, straggler_ratio=1.0)
        with pytest.raises(ValueError, match="straggler_windows"):
            lib.PodAggregator(str(tmp_path), 2, straggler_windows=0)


# ---------------------------------------------------------- flight files --

def _step_stats(i):
    return _stamp("step_stats", {
        "epoch": 0, "step_start": i * 2, "steps": 2, "step_time_ms_p50": 1.0,
        "step_time_ms_p95": 1.0, "step_time_ms_p99": 1.0, "step_time_ms_max": 1.0,
        "samples_per_sec": 10.0, "host_stall_ms": 0.0, "inflight_depth": 0,
        "staging_queue_depth": 0})


def test_flight_ring_bound_and_dump_validates_in_both_packages(tmp_path):
    rec = FlightRecorder(str(tmp_path), capacity=3, process_index=0)
    rec.observe(schema.make_run_meta(world_size=1, comm_hook="none", extra={"api": "native"}))
    for i in range(7):
        rec.observe(_step_stats(i))
    rec.observe(_stamp("event", {"event": "preempt", "epoch": 0, "completed": False,
                                 "step": 14}))
    rec.note(emergency_step=14)
    path = rec.dump("preempt")
    assert os.path.basename(path) == "flightrec_preempt.json"
    assert schema.validate_flight_file(path) == jax_schema.validate_flight_file(path) == ([], 4)
    with open(path) as f:
        payload = json.load(f)
    assert payload["counts"]["step_stats"] == 3
    assert payload["records"]["step_stats"][-1]["step_start"] == 12
    assert payload["notes"]["emergency_step"] == 14 and payload["observed_records"] == 9
    assert rec.dump("preempt") == path  # one dump a reason
    assert FlightRecorder(None).dump("exception") is None
    ok = subprocess.run([sys.executable, INSPECT, "--validate", path], capture_output=True,
                        text=True, cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert ok.returncode == 0, ok.stdout + ok.stderr
    summary = subprocess.run([sys.executable, INSPECT, path], capture_output=True, text=True,
                             cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert summary.returncode == 0 and "reason=preempt" in summary.stdout
    assert flight.summarize_recording(path)[0] == \
        "flight recording: reason=preempt process=0 capacity=3"


def test_flight_payload_drift_rejected_as_jax():
    rec = FlightRecorder(None, capacity=4, process_index=0)
    rec.observe(_stamp("event", {"event": "x"}))
    good = rec.payload("exception")
    bad_ring = json.loads(json.dumps(good))
    bad_ring["records"]["step_stats"] = [_stamp("event", {"event": "y"})]
    cases = [good, dict(good, reason="mystery"), {k: v for k, v in good.items() if k != "counts"},
             bad_ring, dict(good, schema_version=schema.SCHEMA_VERSION + 1),
             dict(good, type="history"), dict(good, records=[]), [], dict(good, run_meta={})]
    for case in cases:
        assert schema.validate_flight_payload(case) == jax_schema.validate_flight_payload(case)
    assert schema.validate_flight_payload(good) == []
    assert schema.FLIGHT_REASONS == jax_schema.FLIGHT_REASONS


def test_flight_dump_names_are_per_host(tmp_path):
    for pid in (0, 1, 2):
        rec = FlightRecorder(str(tmp_path), capacity=2, process_index=pid)
        rec.observe(_stamp("event", {"event": "watchdog_stale", "process": pid, "timeout_s": 1.0,
                                     "stale_peers": [], "max_observed_lag_s": 0.0}))
        rec.dump("watchdog")
    names = sorted(os.path.basename(p) for p in find_recordings(str(tmp_path)))
    assert names == ["flightrec_watchdog.json", "flightrec_watchdog_p1.json",
                     "flightrec_watchdog_p2.json"]
    assert all(schema.validate_flight_file(p)[0] == [] for p in find_recordings(str(tmp_path)))
    assert FlightRecorder(None).process_index == 0  # no process group: host 0
    assert flight.dump_all("watchdog") == []  # nothing installed


def test_the_supervisor_summarizes_a_recording_before_the_restart(tmp_path, caplog):
    calls = {"n": 0}

    def runner(argv, env):
        calls["n"] += 1
        if calls["n"] == 1:
            rec = FlightRecorder(str(tmp_path), capacity=4, process_index=0)
            rec.observe(schema.make_run_meta(world_size=1, comm_hook="none",
                                             extra={"api": "native"}))
            rec.observe(_stamp("event", {"event": "preempt", "epoch": 0, "completed": True,
                                         "step": 3}))
            rec.dump("preempt")
            return preemption.EXIT_PREEMPTED
        return 0

    sup = supervisor.RestartSupervisor(["cmd"], policy=supervisor.SupervisorPolicy(max_restarts=3),
                                       runner=runner, sleep=lambda s: None,
                                       flight_dir=str(tmp_path))
    with caplog.at_level(logging.WARNING, logger="tpuddp"):
        assert sup.run() == 0
    assert calls["n"] == 2
    lines = [r.message for r in caplog.records if r.message.startswith("supervisor: flight")]
    assert len([m for m in lines if "reason=preempt" in m]) == 1
    assert lines[0] == "supervisor: flight recording: reason=preempt process=0 capacity=4"
    assert sup.summarize_flight() == 0  # not again


# ------------------------------------------------ two hosts, one machine --

def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_hosts_publish_shards_and_host_0_merges_them(tmp_path):
    """Two launchers of one rank each (hosts 0 and 1) sharing out_dir:
    each host's leader binds its exporter (``exporter.port``,
    ``exporter_p1.port``) and publishes its shard into ``.heartbeats``;
    host 0's pod source reports both hosts while the run lives. The shards
    are what the JAX aggregator reads."""
    import yaml

    out = tmp_path / "out"
    settings = tmp_path / "s.yaml"
    settings.write_text(yaml.dump({
        "out_dir": str(out),
        "local": {"device": "cpu", "gpu": {"num_gpus": 2},
                  "rendezvous": {"coordinator_address": f"127.0.0.1:{_free_port()}",
                                 "num_processes": 2}},
        "training": dict(TRAINING, synthetic_n=[256, 16], num_epochs=3, step_stats_every=1,
                         scan_steps=1),
        "observability": {"exporter": True}}))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    for var in ("TPUDDP_WORLD_SIZE", "TPUDDP_COORDINATOR", "TPUDDP_NUM_PROCESSES"):
        env.pop(var, None)
    procs = [subprocess.Popen([sys.executable, "-m", "tpuddp_torch.train_native",
                               "--settings_file", str(settings)], cwd=ROOT,
                              env=dict(env, TPUDDP_PROCESS_ID=str(pid)), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for pid in (0, 1)]
    seen = {"hosts": 0, "files": set()}
    while any(p.poll() is None for p in procs):
        if out.is_dir():
            seen["files"] |= {f for f in os.listdir(out) if f.startswith("exporter")}
        port = exporter.read_live_port(str(out)) if out.is_dir() else None
        if port is not None:
            try:
                series = json.loads(_scrape(port, "/snapshot"))["series"]
                seen["hosts"] = max(seen["hosts"],
                                    series.get("pod_hosts_reporting", {}).get("value") or 0)
            except Exception:  # noqa: BLE001 — the run may end between the probe and the scrape
                pass
        time.sleep(0.05)
    for p in procs:
        stdout, stderr = p.communicate(timeout=120)
        assert p.returncode == 0, stdout[-2000:] + stderr[-3000:]
    assert seen["hosts"] == 2
    assert {"exporter.port", "exporter_p1.port"} <= seen["files"]
    assert not [f for f in os.listdir(out) if f.startswith("exporter")]  # stopped, removed
    hb = str(out / ".heartbeats")
    for pid in (0, 1):
        shard = jax_aggregate.read_shard(hb, pid)
        assert shard is not None and shard["window_index"] > 0 and shard["epoch"] == 2
        assert sorted(shard) == sorted(aggregate.make_shard({}))
    with open(out / "history.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert records[0]["observability"]["aggregate"] is True
    assert jax_schema.validate_history_records(records) == []
