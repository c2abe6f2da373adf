"""The port's causal tracing plane (``tpuddp_torch/observability/trace.py``)
against the JAX package's (``tpuddp/observability/trace.py``), on the CPU,
mirroring ``tests/test_trace.py:36-255, 560-710``:

- the span ring, its drop accounting, the open spans, the null tracer and
  the config gate behave as the JAX tracer's, and the same operations give
  the same Chrome payload (timestamps aside), which both packages'
  validators accept (and both reject the same drift with the same texts);
- a traced native run on 2 Gloo processes (toy_cnn with sync_bn,
  ``bf16_ef``, ``scan_steps: 4``, 2 epochs) has the JAX loop's counts of
  epoch, stage, dispatch, readback and collective spans on a 2-device mesh,
  with the same attribute keys and wire bytes, and is bitwise the
  untraced run; the JAX inspector reads its artifact;
- the exporter serves only whole responses while a writer hammers the
  recorder, the live gauges and the tracer; a failing trace source gives a
  whole 500, no tracer a 404; a flight dump embeds the open spans.
"""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuddp import config as jax_config
from tpuddp.observability import schema as jax_schema
from tpuddp.observability import trace as jax_trace

from tpuddp_torch import config as cfg
from tpuddp_torch.observability import schema
from tpuddp_torch.observability import trace as trace_mod
from tpuddp_torch.observability.exporter import MetricsExporter
from tpuddp_torch.observability.flight import FlightRecorder
from tpuddp_torch.observability.telemetry import RunTelemetry
from tpuddp_torch.observability.trace import NULL, Tracer, tracer_from_config
from tpuddp_torch.training.loop import StepClock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSPECT = os.path.join(ROOT, "tools", "tpuddp_inspect.py")
sys.path.insert(0, os.path.join(ROOT, "tests"))
import _torch_port_live_worker as live_worker  # noqa: E402
import _torch_port_scan_worker as scan_cfg  # noqa: E402

SPAWN_TIMEOUT_S = 240
KINDS = ("epoch", "stage", "dispatch", "readback", "collective")

torch.set_num_threads(2)


# ------------------------------------------------------------- span model --

def test_ring_bound_and_drop_accounting(tmp_path):
    t = Tracer("train", capacity=4, run_dir=str(tmp_path), process_index=0)
    root = t.start_span("epoch 0", trace_mod.KIND_EPOCH)
    for _ in range(8):
        t.end_span(t.start_span("d", trace_mod.KIND_DISPATCH, parent=root))
    t.end_span(root)
    assert (t.completed, t.dropped) == (9, 5)
    assert t.kind_counts["dispatch"] == 8 and t.kind_counts["epoch"] == 1
    rec = t.summary_record()
    assert rec["spans"] == 9 and rec["dropped"] == 5 and rec["open_spans"] == 0
    assert rec["slowest"] and rec["slowest"][0]["duration_ms"] >= 0
    row = schema.stamp("trace_summary", rec)
    assert schema.validate_record(row) == jax_schema.validate_record(row) == []


def test_open_spans_surface_for_flight_embed():
    t = Tracer("train", process_index=0)
    root = t.start_span("epoch 3", trace_mod.KIND_EPOCH)
    child = t.start_span("dispatch", trace_mod.KIND_DISPATCH, parent=root)
    opens = t.open_span_summaries()
    assert [s["name"] for s in opens] == ["epoch 3", "dispatch"]
    assert opens[1]["parent_id"] == root.span_id and opens[0]["duration_ms"] is None
    t.end_span(child)
    t.end_span(root)
    assert t.open_span_summaries() == []


def test_end_span_idempotent_and_unknown_kind_refused_as_jax():
    assert trace_mod.SPAN_KINDS == jax_trace.SPAN_KINDS
    texts = []
    for lib in (trace_mod, jax_trace):
        with pytest.raises(ValueError) as e:
            lib.Tracer("train", process_index=0).start_span("x", "not_a_kind")
        texts.append(str(e.value))
    assert texts[0] == texts[1]
    t = Tracer("train", process_index=0)
    s = t.start_span("x", trace_mod.KIND_STAGE)
    t.end_span(s)
    t.end_span(s)  # a second end is a no-op
    t.end_span(trace_mod.NULL_SPAN)
    assert t.completed == 1


def test_null_tracer_and_config_gate(tmp_path):
    assert tracer_from_config({"tracing": False}, "train") is NULL
    assert tracer_from_config(None, "train") is NULL
    assert not NULL.enabled
    NULL.end_span(NULL.start_span("x", "anything"))
    assert NULL.describe() is None and NULL.export(str(tmp_path / "t.json")) is None
    assert not (tmp_path / "t.json").exists()
    for block in ({"tracing": True}, {"tracing": True, "trace_capacity": 16}):
        live = tracer_from_config(cfg.resolve_observability(block), "train", run_dir=str(tmp_path))
        theirs = jax_trace.tracer_from_config(jax_config.resolve_observability(block), "train",
                                              run_dir=str(tmp_path))
        assert live.enabled and live.capacity == theirs.capacity
        assert live.describe() == theirs.describe()


def _same_ops(lib, run_dir):
    """One request tree with a follows_from link, one span left open."""
    t = lib.Tracer("decode", capacity=64, run_dir=run_dir, process_index=0)
    root = t.start_span("request", lib.KIND_REQUEST, tid="client", attrs={"tenant": "a"})
    q = t.start_span("queue_wait", lib.KIND_QUEUE_WAIT, parent=root)
    t.end_span(q)
    pre = t.start_span("prefill", lib.KIND_PREFILL, parent=root, follows_from=q.span_id)
    t.end_span(pre, tokens=3)
    t.end_span(root)
    t.start_span("serve", lib.KIND_SERVE, parent=root)
    return t


def _timeless(payload):
    """A Chrome payload with its clocks and durations taken out."""
    out = json.loads(json.dumps(payload))
    for e in out["traceEvents"]:
        e.pop("ts", None)
        e.pop("dur", None)
    out["tpuddp"].pop("clock_sync")
    for row in out["tpuddp"]["slowest"]:
        row.pop("duration_ms")
    out["tpuddp"]["slowest"].sort(key=lambda r: r["span_id"])  # ranked by time: the order varies
    return out


def test_export_is_the_jax_payload_and_validates(tmp_path):
    ours = _same_ops(trace_mod, str(tmp_path / "port"))
    theirs = _same_ops(jax_trace, str(tmp_path / "jax"))
    assert _timeless(ours.chrome_payload()) == _timeless(theirs.chrome_payload())
    path = ours.export()
    assert path == str(tmp_path / "port" / "trace_decode.json")
    assert schema.validate_trace_file(path) == jax_schema.validate_trace_file(path) == ([], 4)
    assert Tracer("train", process_index=3).artifact_name() == \
        jax_trace.Tracer("train", process_index=3).artifact_name() == "trace_train_p3.json"
    assert Tracer("train", process_index=3).new_trace() == "train-p3-000001"


def test_trace_payload_drift_rejected_as_jax(tmp_path):
    t = Tracer("train", run_dir=str(tmp_path), process_index=0)
    t.end_span(t.start_span("e", trace_mod.KIND_EPOCH))
    payload = t.chrome_payload()
    newer = json.loads(json.dumps(payload))
    newer["tpuddp"]["schema_version"] = schema.SCHEMA_VERSION + 1
    orphan = json.loads(json.dumps(payload))
    orphan["traceEvents"][-1]["args"]["parent_id"] = 999999
    dropped = json.loads(json.dumps(orphan))
    dropped["tpuddp"]["dropped"] = 3
    no_clock = json.loads(json.dumps(payload))
    del no_clock["tpuddp"]["clock_sync"]
    cases = [payload, {"traceEvents": []}, newer, orphan, dropped, no_clock, [], {"tpuddp": {}}]
    for case in cases:
        assert schema.validate_trace_payload(case) == jax_schema.validate_trace_payload(case)
    assert schema.validate_trace_payload(payload) == []
    assert any("orphan" in e for e in schema.validate_trace_payload(orphan))
    assert not any("orphan" in e for e in schema.validate_trace_payload(dropped))
    assert any("newer" in e for e in schema.validate_trace_payload(newer))


def test_schema_v9_requires_tracing_field():
    good = schema.make_run_meta(world_size=1, comm_hook=None, guard=None)
    assert good["tracing"] is None and good["observability"] is None
    assert schema.validate_record(good) == []
    dropped = {k: v for k, v in good.items() if k != "tracing"}
    assert schema.validate_record(dropped) == jax_schema.validate_record(dropped) != []
    v8 = dict(dropped, schema_version=8)
    assert schema.validate_record(v8) == []
    bad = schema.stamp("trace_summary", {"role": "train"})
    assert schema.validate_record(bad) == jax_schema.validate_record(bad) != []


# ------------------------------------------------- the traced native run --

@pytest.fixture(scope="module")
def traced(tmp_path_factory, cpu_devices):
    """The JAX loop's traced run on a 2-device mesh, and the port's traced
    and untraced runs on 2 Gloo processes, from one init."""
    from tpuddp import nn as jax_nn
    from tpuddp import optim as jax_optim
    from tpuddp.data import ShardedDataLoader as JaxLoader
    from tpuddp.data.synthetic import SyntheticClassification as JaxSynthetic
    from tpuddp.models import ToyCNN as JaxToyCNN
    from tpuddp.nn import CrossEntropyLoss as JaxCrossEntropyLoss
    from tpuddp.parallel import make_mesh
    from tpuddp.parallel.ddp import DistributedDataParallel as JaxDDP
    from tpuddp.training.loop import run_training_loop as jax_run_training_loop

    from tpuddp_torch.models.convert import state_dict_from_jax

    work = tmp_path_factory.mktemp("traced")
    params, mstate = JaxToyCNN(num_classes=10, widths=scan_cfg.WIDTHS).init(
        jax.random.key(11), jnp.zeros((1, *scan_cfg.SHAPE)))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    init = state_dict_from_jax("toy_cnn", as_np(params), as_np(mstate))
    np.savez(work / "init.npz", **{k: v.numpy() for k, v in init.items()})
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_port_live_worker.py"), str(work)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT),
    )
    mesh = make_mesh(cpu_devices[:2])
    model = jax_nn.convert_sync_batchnorm(JaxToyCNN(num_classes=10, widths=scan_cfg.WIDTHS))
    ddp = JaxDDP(model, jax_optim.Adam(scan_cfg.LR), JaxCrossEntropyLoss(), mesh=mesh,
                 comm_hook=live_worker.HOOK)
    state = ddp.init_state(jax.random.key(0), jnp.zeros((1, *scan_cfg.SHAPE)),
                           params=params, model_state=mstate)
    train, test = JaxSynthetic(n=scan_cfg.DATA_N, shape=scan_cfg.SHAPE,
                               seed=scan_cfg.DATA_SEED).split(scan_cfg.DATA_TEST)
    jax_run_training_loop(
        ddp, state, JaxLoader(train, scan_cfg.BATCH, mesh, shuffle=True),
        JaxLoader(test, scan_cfg.BATCH, mesh, shuffle=True), save_dir=str(work / "jax"),
        num_epochs=scan_cfg.EPOCHS, checkpoint_epoch=scan_cfg.EPOCHS, scan_steps=scan_cfg.SCAN,
        log=lambda *_: None, observability={"tracing": True},
    )
    _, err = proc.communicate(timeout=SPAWN_TIMEOUT_S)
    assert proc.returncode == 0, err[-3000:]
    return work


def _spans(path):
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _by_kind(spans):
    out = {}
    for e in spans:
        out.setdefault(e["cat"], []).append(e)
    return out


def test_span_counts_and_attribute_keys_are_the_jax_loops(traced):
    ours = _by_kind(_spans(traced / "traced" / "trace_train.json"))
    theirs = _by_kind(_spans(traced / "jax" / "trace_train.json"))
    assert {k: len(ours.get(k, ())) for k in KINDS} == {k: len(theirs.get(k, ())) for k in KINDS}
    assert all(ours[k] for k in KINDS)
    for kind in KINDS:
        keys = lambda spans: {frozenset(e["args"]) for e in spans}  # noqa: E731
        assert keys(ours[kind]) == keys(theirs[kind]), kind
    wire = lambda spans: sorted(  # noqa: E731
        (e["args"]["hook"], e["args"]["wire_bytes_per_update"],
         e["args"]["wire_bytes_per_update_f32"], e["args"]["updates"]) for e in spans)
    assert wire(ours["collective"]) == wire(theirs["collective"])
    steps = lambda spans: sorted((e["args"]["steps"], e["args"]["samples"]) for e in spans)  # noqa: E731
    assert steps(ours["dispatch"]) == steps(theirs["dispatch"])
    # every child under an epoch of the one run trace, every collective in a dispatch
    epochs = {e["args"]["span_id"] for e in ours["epoch"]}
    assert len({e["args"]["trace_id"] for e in ours["epoch"]}) == 1
    assert all(e["args"]["parent_id"] in epochs
               for k in ("stage", "dispatch", "readback") for e in ours[k])
    dispatches = {e["args"]["span_id"] for e in ours["dispatch"]}
    assert all(e["args"]["parent_id"] in dispatches for e in ours["collective"])
    assert all(e["dur"] >= 0 and not e["args"].get("open") for kind in KINDS for e in ours[kind])


def test_the_traced_run_is_bitwise_the_untraced_one(traced):
    histories = []
    for name in ("traced", "plain"):
        with open(traced / f"{name}_history.json") as f:
            histories.append([(r["epoch"], r["train_loss"], r["test_loss"], r["test_accuracy"])
                              for r in json.load(f)])
    assert histories[0] == histories[1]
    for rank in range(2):
        a, b = (np.load(traced / f"{name}_{rank}.npz") for name in ("traced", "plain"))
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert not (traced / "plain" / "trace_train.json").exists()
    assert not (traced / "traced" / "trace_train_p1.json").exists()  # one tracer a host


def test_the_traced_history_and_artifact_validate_in_both_packages(traced):
    art = str(traced / "traced" / "trace_train.json")
    errors, n = schema.validate_trace_file(art)
    assert errors == [] and n == jax_schema.validate_trace_file(art)[1] > 0
    with open(traced / "traced" / "history.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert schema.validate_history_records(records) == []
    assert jax_schema.validate_history_records(records) == []
    assert records[0]["tracing"] == {"capacity": 4096, "artifact": "trace_train.json"}
    with open(traced / "plain" / "history.jsonl") as f:
        assert json.loads(f.readline())["tracing"] is None
    summary = [r for r in records if r["type"] == "trace_summary"]
    with open(traced / "jax" / "history.jsonl") as f:
        jax_summary = [r for r in map(json.loads, f) if r["type"] == "trace_summary"]
    assert len(summary) == len(jax_summary) == 1
    assert summary[0]["by_kind"] == jax_summary[0]["by_kind"]
    out = subprocess.run([sys.executable, INSPECT, "trace", art], capture_output=True, text=True,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "role=train" in out.stdout and "slowest spans" in out.stdout


# ------------------------------------------------- exporter concurrency --

def test_exporter_never_serves_torn_payloads_under_writer_hammer():
    """A writer hammering the recorder, the live gauges and the tracer while
    /metrics, /snapshot and /trace are scraped: every response whole."""
    tel = RunTelemetry(writer=None, step_stats_every=4)
    tracer = Tracer("train", capacity=128, process_index=0)
    exporter = MetricsExporter(port=0).start()
    exporter.set_trace_source(tracer.endpoint_payload)
    tel.attach_live(exporter=exporter)
    stop = threading.Event()
    writer_errors, scrape_errors = [], []

    def writer():
        try:
            clock = StepClock(torch.device("cpu"))
            tel.start_epoch(0, clock)
            i = 0
            while not stop.is_set():
                i += 1
                clock.mark()
                tel.post_dispatch(1, 8)
                tel.update_live(train_loss=float(i), skipped_steps=i)
                tracer.end_span(tracer.start_span(f"dispatch {i}", trace_mod.KIND_DISPATCH,
                                                  attrs={"i": i}))
        except Exception as e:  # noqa: BLE001 — surfaced below
            writer_errors.append(e)

    def check_metrics(body):
        text = body.decode()
        assert text.endswith("\n")
        for line in text.splitlines():
            if line and not line.startswith("#"):
                parts = line.rsplit(" ", 1)
                assert len(parts) == 2, f"torn line {line!r}"
                float(parts[1])

    def scraper(path, check):
        try:
            for _ in range(40):
                with urllib.request.urlopen(f"http://127.0.0.1:{exporter.port}{path}",
                                            timeout=10) as resp:
                    assert resp.status == 200
                    check(resp.read())
        except Exception as e:  # noqa: BLE001 — surfaced below
            scrape_errors.append((path, e))

    w = threading.Thread(target=writer, daemon=True)
    w.start()
    threads = [threading.Thread(target=scraper, args=a, daemon=True) for a in (
        ("/metrics", check_metrics), ("/snapshot", json.loads), ("/trace", json.loads),
        ("/metrics", check_metrics))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    stop.set()
    w.join(timeout=30)
    exporter.stop()
    tel.finish()
    assert not writer_errors, writer_errors
    assert not scrape_errors, scrape_errors
    assert tel.recorder.windows_emitted > 0


def test_exporter_rendering_error_returns_whole_500():
    exporter = MetricsExporter(port=0).start()
    exporter.set_trace_source(lambda: (_ for _ in ()).throw(RuntimeError("broken trace feeder")))
    try:
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            urllib.request.urlopen(f"http://127.0.0.1:{exporter.port}/trace", timeout=10)
        assert exc_info.value.code == 500
        body = exc_info.value.read().decode()
        assert "broken trace feeder" in body and body.endswith("\n")
        health = json.load(urllib.request.urlopen(f"http://127.0.0.1:{exporter.port}/healthz",
                                                  timeout=10))
        assert health["status"] == "ok"
    finally:
        exporter.stop()


def test_trace_endpoint_404_without_tracing():
    exporter = MetricsExporter(port=0).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            urllib.request.urlopen(f"http://127.0.0.1:{exporter.port}/trace", timeout=10)
        assert exc_info.value.code == 404
    finally:
        exporter.stop()


def test_flight_dump_embeds_open_spans(tmp_path):
    flight = FlightRecorder(str(tmp_path), process_index=0)
    tracer = Tracer("train", process_index=0)
    flight.add_context("open_spans", tracer.open_span_summaries)
    root = tracer.start_span("epoch 1", trace_mod.KIND_EPOCH)
    tracer.start_span("dispatch", trace_mod.KIND_DISPATCH, parent=root)
    path = flight.dump("exception")
    with open(path) as f:
        payload = json.load(f)
    assert [s["name"] for s in payload["notes"]["open_spans"]] == ["epoch 1", "dispatch"]
    assert schema.validate_flight_payload(payload) == jax_schema.validate_flight_payload(payload) == []
    flight2 = FlightRecorder(str(tmp_path / "b"), process_index=0)
    flight2.add_context("boom", lambda: 1 / 0)
    with open(flight2.dump("exception")) as f:
        assert "failed" in json.load(f)["notes"]["boom"]
