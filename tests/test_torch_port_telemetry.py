"""The port's typed telemetry (``tpuddp_torch/observability/``) against the
JAX package's (``tpuddp/observability/``), on the CPU:

- a port run's ``history.jsonl`` passes the JAX package's
  ``tools/tpuddp_inspect.py --validate``, on both paths, a resumed run (a
  second ``run_meta`` header) included, and carries ``step_stats`` windows
  and a ``profile`` event naming a Chrome trace;
- the port's validator accepts and rejects what the JAX package's does,
  with the same messages, on the same records;
- ``config_hash``, ``percentiles`` and ``step_time_fields`` equal the JAX
  package's, and ``$TPUDDP_PROFILE_STEPS``' errors are its texts;
- the FLOPs of toy_mlp's update are the analytic matmul count; ``mfu_*``
  are null on the CPU;
- a run with ``step_stats_every: 4`` and profiling on is bitwise the run
  with both off; SIGUSR1 and ``$TPUDDP_PROFILE=1`` trace an epoch; a
  managed step window inside a queued fuse group is traced
  (``tests/test_observability.py:565``).
"""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from tpuddp.config import resolve_observability as jax_resolve_observability
from tpuddp.config import training_config as jax_training_config
from tpuddp.observability import profiling as jax_profiling
from tpuddp.observability import recorder as jax_recorder
from tpuddp.observability import schema as jax_schema

from tpuddp_torch import config as cfg
from tpuddp_torch import train_accelerate, train_native
from tpuddp_torch.models import ToyMLP
from tpuddp_torch.observability import profiling, recorder, schema

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSPECT = os.path.join(ROOT, "tools", "tpuddp_inspect.py")
TRAINING = {"model": "toy_mlp", "data_root": "/nonexistent", "synthetic_n": [96, 32],
            "train_batch_size": 8, "test_batch_size": 16, "num_epochs": 2, "checkpoint_epoch": 1,
            "image_size": None, "seed": 0, "prefetch": False}

torch.set_num_threads(2)


def _run(entry, tmp_path, name, env=None, sigusr1=False, **training):
    """One in-process CPU run of ``entry`` (world 1) on ``TRAINING`` updated
    by ``training``; ``env`` is set for its duration, ``sigusr1`` a pending
    SIGUSR1 request at its start. Returns out_dir."""
    out = tmp_path / name
    sf = tmp_path / f"{name}.yaml"
    sf.write_text(yaml.dump({"out_dir": str(out), "local": {"device": "cpu"},
                             "training": {**TRAINING, **training}}))
    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    profiling.reset_profiling_state()
    profiling._sigusr1["requested"] = sigusr1  # as the signal handler would
    try:
        entry.main(["--settings_file", str(sf)])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        profiling.reset_profiling_state()
    return out


def _records(out):
    with open(out / "history.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("telemetry")
    out = {
        "plain": _run(train_native, tmp, "plain", scan_steps=1),
        "native": _run(train_native, tmp, "native", {"TPUDDP_PROFILE_STEPS": "3:7"},
                       scan_steps=1, step_stats_every=4),
        "managed": _run(train_accelerate, tmp, "managed", {"TPUDDP_PROFILE_STEPS": "2:3"},
                        step_stats_every=3, deferred_metrics=True, fuse_steps=4),
    }
    # each resumed for a third epoch: a second header in the same file
    _run(train_native, tmp, "native", num_epochs=3, resume=True, scan_steps=1, step_stats_every=4)
    _run(train_accelerate, tmp, "managed", num_epochs=3, resume=True, step_stats_every=3,
         deferred_metrics=True, fuse_steps=4)
    return out


@pytest.mark.parametrize("path", ["native", "managed"])
def test_jax_inspect_validates_a_port_history(runs, path):
    proc = subprocess.run([sys.executable, INSPECT, str(runs[path] / "history.jsonl"), "--validate"],
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    records = _records(runs[path])
    assert [r["type"] for r in records].count("run_meta") == 2  # the resume's header
    assert all("schema_version" in r and "type" in r for r in records)
    assert schema.validate_history_records(records) == []


@pytest.mark.parametrize("path", ["native", "managed"])
def test_header_fields(runs, path):
    header = _records(runs[path])[0]
    assert header["jax_version"] is None and header["torch_version"] == torch.__version__
    assert header["device_kind"] is None and header["cuda_version"] == torch.version.cuda
    assert (header["world_size"], header["process_count"], header["process_index"]) == (1, 1, 0)
    assert header["mesh"] == {"data": 1, "model": 1, "tp_rules_hash": None}
    assert header["comm"]["overlap"]["enabled"] is False
    assert header["snapshot"] is False and header["tracing"] is None and header["tuning"] is None
    # no observability block: the JAX loop's header from its defaults
    # (tpuddp/training/loop.py:452-460): no exporter, aggregation and the
    # flight recorder on
    obs = jax_resolve_observability(None)
    assert header["observability"] == {
        "exporter": False, "aggregate": obs["aggregate"],
        "straggler_ratio": obs["straggler_ratio"], "straggler_windows": obs["straggler_windows"],
        "flight_recorder": {"capacity": obs["flight_capacity"]}}
    assert header["api"] == path and header["model"] == "toy_mlp"
    more = {"deferred_metrics": True, "fuse_steps": 4} if path == "managed" else {"scan_steps": 1}
    training = cfg.training_config({"training": {**TRAINING, **more,
                                                 "step_stats_every": header["step_stats_every"]}})
    assert header["config_hash"] == schema.config_hash(training)
    if path == "native":
        for key in ("grad_comm_bytes_per_update", "grad_comm_bytes_inter_host",
                    "grad_comm_bytes_intra_host", "comm_density"):
            assert key in header


def test_step_stats_windows_and_profile_events(runs):
    native = _records(runs["native"])
    windows = [r for r in native if r["type"] == "step_stats"]
    # 12 updates an epoch, one step per batch: three windows of 4 an epoch
    assert [(w["epoch"], w["step_start"], w["steps"]) for w in windows] == [
        (e, 12 * e + 4 * i if e < 2 else 4 * i, 4) for e in range(3) for i in range(3)]
    for w in windows:
        assert w["staging_queue_depth"] >= 0 and w["inflight_depth"] >= 1 and w["samples_per_sec"] > 0
    profiles = [r for r in native if r["type"] == "event" and r["event"] == "profile"]
    assert len(profiles) == 1 and profiles[0]["trigger"] == "steps" and profiles[0]["steps"] == [3, 7]
    with open(profiles[0]["path"]) as f:
        trace = json.load(f)
    assert isinstance(trace["traceEvents"], list) and trace["traceEvents"]
    managed = _records(runs["managed"])
    assert [w["steps"] for w in managed if w["type"] == "step_stats" and w["epoch"] == 0] == [4, 4, 4]
    assert (runs["managed"] / "trace_steps_2_3" / "trace_rank0.json").exists()  # inside a queued group


@pytest.mark.parametrize("path", ["plain", "native", "managed"])
def test_epoch_rows_carry_the_jax_fields_and_null_mfu(runs, path):
    rows = [r for r in _records(runs[path]) if r["type"] == "epoch"]
    for row in rows:
        for key in jax_schema._REQUIRED["epoch"] + ("mfu_p95", "train_steps", "step_ms", "host_stall_s"):
            assert key in row, key
        assert row["mfu_p50"] is None and row["mfu_p95"] is None  # no peak on the CPU
        assert row["step_time_ms_p50"] > 0 and len(row["step_ms"]) == row["train_steps"]


def test_telemetry_on_is_bitwise_telemetry_off(runs):
    plain, native = (_records(runs[k]) for k in ("plain", "native"))
    rows = [[r for r in recs if r["type"] == "epoch"][:2] for recs in (plain, native)]
    for a, b in zip(*rows):
        for key in ("train_loss", "test_loss", "test_accuracy", "train_samples"):
            assert a[key] == b[key]
    with np.load(runs["plain"] / "ckpt_1.npz") as a, np.load(runs["native"] / "ckpt_1.npz") as b:
        arrays = [k for k in a.files if not k.startswith("__")]
        assert arrays
        for key in arrays:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_sigusr1_and_first_epoch_traces(tmp_path):
    out = _run(train_native, tmp_path, "sig", sigusr1=True, num_epochs=1)
    assert (out / "trace_sigusr1_e0" / "trace_rank0.json").exists()
    events = [r for r in _records(out) if r["type"] == "event"]
    assert [e["event"] for e in events] == ["profile_epoch", "profile"]
    assert events[1]["trigger"] == "sigusr1" and events[1]["epoch"] == 0
    out = _run(train_accelerate, tmp_path, "first", {"TPUDDP_PROFILE": "1"}, num_epochs=2)
    assert (out / "trace" / "trace_rank0.json").exists()
    events = [r for r in _records(out) if r["type"] == "event"]
    assert [(e["event"], e["trigger"], e["epoch"]) for e in events] == [("profile", "first_epoch", 0)]


# ---------------------------------------------------------- the schema --

def _variants(record):
    """Valid and broken forms of one record."""
    out = [record, {**record, "schema_version": 99}, {**record, "schema_version": 0},
           {**record, "type": "nope"}, "not a record"]
    for key in list(record)[2:6]:
        out.append({k: v for k, v in record.items() if k != key})
    if record.get("type") == "run_meta":
        out += [{**record, "comm": {"x": 1}}, {**record, "comm": None}, {**record, "mesh_shape": [1]},
                {**record, "schema_version": 3}]
    if record.get("type") == "event":
        out.append({**record, "event": 3})
    if record.get("type") == "step_stats":
        out.append({k: v for k, v in record.items() if k != "inflight_depth"} | {"schema_version": 2})
    return out


def test_the_validators_agree_with_the_jax_package(runs):
    records = _records(runs["native"]) + _records(runs["managed"])
    cases = [v for r in records for v in _variants(copy.deepcopy(r))]
    assert any(jax_schema.validate_record(c) for c in cases) and any(
        not jax_schema.validate_record(c) for c in cases)
    for i, case in enumerate(cases):
        assert schema.validate_record(case, i) == jax_schema.validate_record(case, i)
    for history in (records, records[1:], [], ["x"] + records):
        assert schema.validate_history_records(history) == jax_schema.validate_history_records(history)
    assert schema.SCHEMA_VERSION == jax_schema.SCHEMA_VERSION
    assert schema.RECORD_TYPES == jax_schema.RECORD_TYPES


def test_history_file_validation_agrees(tmp_path, runs):
    bad = tmp_path / "bad.jsonl"
    bad.write_text(open(runs["native"] / "history.jsonl").read() + '{"type": "epoch", "x": NaN}\n')
    for path in (runs["native"] / "history.jsonl", bad, tmp_path / "missing.jsonl"):
        assert schema.validate_history_file(str(path)) == jax_schema.validate_history_file(str(path))


def test_config_hash_equals_the_jax_packages():
    for block in ({}, {"model": "toy_cnn", "sync_bn": True, "remat": True}, {"step_stats_every": 8}):
        ours = cfg.training_config({"training": dict(block)})
        theirs = jax_training_config({"training": dict(block)})
        assert schema.config_hash(ours) == jax_schema.config_hash(theirs)
    assert schema.config_hash(None) is None and schema.config_hash({}) is None


@pytest.mark.parametrize("times", [[], [0.01], [0.02, 0.01, 0.05, 0.03], list(np.linspace(0.001, 0.2, 37))])
def test_percentiles_and_step_time_fields_equal_the_jax_packages(times):
    assert recorder.percentiles(times) == jax_recorder.percentiles(times)
    for flops, peak in ((None, None), (1e9, None), (1e9, 989e12)):
        assert recorder.step_time_fields(times, flops, peak) == jax_recorder.step_time_fields(times, flops, peak)


@pytest.mark.parametrize("raw", ["x", "1", "1:2:3", "a:b", "5:5", "-1:3", "7:2"])
def test_profile_steps_errors_are_the_jax_texts(raw):
    with pytest.raises(ValueError) as theirs:
        jax_profiling.parse_profile_steps(raw)
    with pytest.raises(ValueError) as ours:
        profiling.parse_profile_steps(raw)
    assert str(ours.value) == str(theirs.value)


def test_profile_steps_parse():
    assert profiling.parse_profile_steps("100:110") == jax_profiling.parse_profile_steps("100:110")
    assert profiling.parse_profile_steps("") is None


def test_toy_mlp_flops_are_the_analytic_matmul_count():
    """Forward 2BKN per layer; backward 2BKN for each weight gradient and,
    past the first layer, 2BKN for the input gradient."""
    shape, hidden, batch = (8, 8, 3), (16, 12), 4
    model = ToyMLP(int(np.prod(shape)), 10, hidden)
    sizes = [int(np.prod(shape)), *hidden, 10]
    layers = [2 * batch * k * n for k, n in zip(sizes, sizes[1:])]
    expected = 2 * sum(layers) + sum(layers[1:])
    assert recorder.count_step_flops(model, (batch, *shape)) == expected
    assert all(p.device.type == "cpu" for p in model.parameters())  # nothing moved or run on it


def test_the_native_entry_counts_flops_on_its_train_batch():
    """The native entry hands the loop one train batch's shape and dtype
    (after the augment); the count on it is the model's, run on a meta copy."""
    ddp, train_loader, _, _ = train_native.build_training(0, 1, {**cfg.TRAINING_DEFAULTS, **TRAINING}, "cpu")
    shape, dtype = train_native.model_input_for(TRAINING, train_loader)
    assert shape == (8, *train_loader.dataset.images.shape[1:]) and dtype == torch.float32
    assert train_native.model_input_for({**TRAINING, "image_size": 16}, train_loader)[0] == (8, 16, 16, 3)
    assert recorder.count_step_flops(ddp.model, shape, dtype) > 0


def test_peak_table():
    assert recorder.device_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert recorder.device_peak_flops("NVIDIA H100 PCIe") == 756e12
    assert recorder.device_peak_flops(None) is None and recorder.device_peak_flops("Some GPU") is None
