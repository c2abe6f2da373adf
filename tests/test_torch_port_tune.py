"""The autotuning plane of the port (``tpuddp_torch/observability/
advisor.py``, ``tpuddp_torch/tune/``, the ``$TPUDDP_TUNE_OVERLAY`` functions
of ``tpuddp_torch/config.py`` and the schema's tune validators) against the
JAX package.

- Every case of ``tests/test_tune.py`` runs on the port: the file's source
  with its ``tpuddp`` imports pointed at ``tpuddp_torch``.
- Each rule's crafted evidence (the JAX suite's own builders) gives equal
  reports from both advisors: rule ids, predicted deltas, diffs, evidence,
  overlay, the pending summary.
- Both advisors give the same report, measurements and pending summary on a
  run dir the port's native entry point wrote.
- ``apply_tune_overlay`` and ``tuning_provenance_from_env`` give equal
  results and equal refusal texts; a TUNE report of either package passes
  the other's validator, and broken ones get the same errors.
- ``FleetTuner`` makes the same decisions from the same histories: keep,
  revert, cooldown, gating, with the same ``tune_action`` rows.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import yaml

from tpuddp import config as jax_cfg
from tpuddp.observability import advisor as jax_advisor
from tpuddp.observability import schema as jax_schema
from tpuddp.tune import online as jax_online
from tpuddp.tune import probe as jax_probe
from tpuddp_torch import config as cfg
from tpuddp_torch.observability import advisor, schema
from tpuddp_torch.tune import online, probe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SUITE = os.path.join(ROOT, "tests", "test_tune.py")


def _mirror(path):
    """The test functions of ``path`` compiled against the port: its
    ``tpuddp`` imports pointed at ``tpuddp_torch``, nothing else changed."""
    with open(path) as f:
        src = f.read()
    src = re.sub(r"^(\s*)(from|import) tpuddp(\.|\s)", r"\1\2 tpuddp_torch\3", src, flags=re.M)
    ns = {"__file__": path, "__name__": "port_mirror_" + os.path.basename(path)[:-3]}
    exec(compile(src, path, "exec"), ns)
    return {k: v for k, v in ns.items() if k.startswith("test_") and callable(v)}


globals().update(_mirror(JAX_SUITE))


def _jax_suite():
    """The JAX suite itself, for its run-dir builders."""
    spec = importlib.util.spec_from_file_location("jax_tune_suite", JAX_SUITE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SUITE = _jax_suite()


# ------------------------------------------------------------ the advisor --

@pytest.mark.parametrize("rule_id", sorted(SUITE._RULE_BUILDERS))
def test_each_rule_reports_alike_on_its_crafted_evidence(tmp_path, rule_id):
    d = str(tmp_path / rule_id)
    os.makedirs(d)
    SUITE._RULE_BUILDERS[rule_id](d)
    ours, theirs = advisor.advise(d), jax_advisor.advise(d)
    assert ours == theirs
    assert rule_id in [r["rule"] for r in ours["recommendations"]]
    assert advisor.overlay_from(ours["recommendations"]) == \
        jax_advisor.overlay_from(theirs["recommendations"])
    assert advisor.pending_summary(d) == jax_advisor.pending_summary(d)
    assert advisor.format_report(ours) == jax_advisor.format_report(theirs)
    for mode in ("train", "serving"):
        assert advisor.measure_run(d, mode) == jax_advisor.measure_run(d, mode)


def test_the_rule_table_and_thresholds_are_the_jax_ones():
    assert [r[:3] for r in advisor.RULES] == [r[:3] for r in jax_advisor.RULES]
    for name in ("RULE_CLASSES", "HOST_STALL_SHARE_THRESHOLD", "READBACK_SHARE_THRESHOLD",
                 "DISPATCH_SHARE_THRESHOLD", "SNAPSHOT_HOT_EVERY_STEPS",
                 "SNAPSHOT_WRITE_SHARE_FLOOR", "OCCUPANCY_FLOOR", "KV_PRESSURE_THRESHOLD",
                 "COMM_BYTES_FLOOR"):
        assert getattr(advisor, name) == getattr(jax_advisor, name), name
    assert (probe.HIGHER_BETTER, probe.LOWER_BETTER) == (jax_probe.HIGHER_BETTER,
                                                         jax_probe.LOWER_BETTER)
    assert online.ROW_METRIC_TYPES == jax_online.ROW_METRIC_TYPES


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A run dir the port's native entry point wrote on the CPU: toy_mlp on
    the synthetic stand-in with the probe's bad knobs (the synchronous
    pipeline, a snapshot every step), tracing and step_stats on."""
    out = str(tmp_path_factory.mktemp("tune") / "run")
    settings = out + ".yaml"
    with open(settings, "w") as f:
        yaml.safe_dump({"out_dir": out, "local": {"device": "cpu"},
                        "observability": {"tracing": True},
                        "training": {"model": "toy_mlp", "data_root": "/nonexistent",
                                     "synthetic_n": [128, 32], "train_batch_size": 8,
                                     "test_batch_size": 8, "num_epochs": 2, "checkpoint_epoch": 1,
                                     "image_size": None, "seed": 0, "pipeline": False,
                                     "snapshot": {"every_steps": 1, "inflight": 1},
                                     "step_stats_every": 4}}, f)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    for var in ("TPUDDP_TUNE_OVERLAY", "TPUDDP_FAULT", "TPUDDP_AUTO_RESUME", "TPUDDP_WORLD_SIZE"):
        env.pop(var, None)
    proc = subprocess.run([sys.executable, "-m", "tpuddp_torch.train_native", "--settings_file",
                           settings], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return out


def test_both_advisors_read_a_port_run_alike(port_run):
    ours, theirs = advisor.advise(port_run), jax_advisor.advise(port_run)
    assert ours == theirs
    fired = {r["rule"] for r in ours["recommendations"]}
    assert {"pipeline_sync_readback", "snapshot_cadence_hot"} <= fired, fired
    assert not ours["insufficient"], "the run carries a trace: the span rules had evidence"
    assert ours["evidence"]["spans"]["available"] and ours["evidence"]["snapshot"]["sidecars"]
    assert advisor.measure_run(port_run) == jax_advisor.measure_run(port_run)
    assert advisor.pending_summary(port_run) == jax_advisor.pending_summary(port_run)
    assert advisor.format_report(ours) == jax_advisor.format_report(theirs)


# ------------------------------------------------------------ the overlay --

OVERLAYS = [
    None,
    {"source": "fleet", "rule": "pipeline_sync_readback", "generation": 2,
     "training": {"pipeline": True, "scan_steps": 8}},
    {"training": {"pipeline": {"depth": 4}, "snapshot": {"inflight": 4}}},
    {"serving": {"batch_timeout_ms": 1, "max_queue_depth": 128}},
    {"decode": {"max_slots": 6}, "rule": "decode_kv_pressure"},
    {"training": {"not_a_knob": 1}},
    {"serving": {"batch_window": 1}},
    {"training": [1, 2]},
    {"sections": {}},
    [1, 2],
    "{not json",
    {},
]


def _resolve(lib, raw, monkeypatch):
    if raw is None:
        monkeypatch.delenv(lib.TUNE_OVERLAY_ENV, raising=False)
    else:
        monkeypatch.setenv(lib.TUNE_OVERLAY_ENV, raw if isinstance(raw, str) else json.dumps(raw))
    out = {}
    settings = {"training": {"num_epochs": 3, "pipeline": {"depth": 2}, "snapshot": True},
                "serving": {"decode": {"max_slots": 8}}}
    calls = {
        "training": lambda: lib.training_config(settings),
        "apply": lambda: lib.apply_tune_overlay({"num_epochs": 3, "pipeline": {"depth": 3}}),
        "serving": lambda: lib.serving_config(settings),
        "decode": lambda: lib.decode_config(lib.serving_config(settings)),
        "provenance": lambda: [lib.tuning_provenance_from_env(s)
                               for s in ("training", "serving", "decode")],
    }
    for name, call in calls.items():
        try:
            out[name] = ("ok", call())
        except ValueError as e:
            out[name] = ("ValueError", str(e))
    return out


@pytest.mark.parametrize("raw", OVERLAYS, ids=[f"o{i}" for i in range(len(OVERLAYS))])
def test_the_overlay_resolves_and_refuses_as_the_jax_one(raw, monkeypatch):
    assert cfg.TUNE_OVERLAY_ENV == jax_cfg.TUNE_OVERLAY_ENV
    ours = _resolve(cfg, raw, monkeypatch)
    theirs = _resolve(jax_cfg, raw, monkeypatch)
    # the port's training defaults hold its own keys too (the CUDA knobs):
    # compare the knobs the JAX block has, and every refusal text whole
    for name in ours:
        if name == "training" and ours[name][0] == "ok":
            assert theirs[name][0] == "ok"
            assert {k: ours[name][1][k] for k in theirs[name][1] if k in ours[name][1]} == \
                {k: v for k, v in theirs[name][1].items() if k in ours[name][1]}
        else:
            assert ours[name] == theirs[name], name


# ------------------------------------------------------- the tune reports --

def _report(lib_probe, lib_advisor, measured):
    rec = {"rule": "comm_hook_uncompressed", "rule_class": "comm", "section": "training",
           "knob": "comm_hook", "diff": {"comm_hook": "bf16_ef"}, "metric": "samples_per_sec",
           "predicted_delta_pct": 50.0, "reason": "test",
           "evidence": [lib_advisor.cite("history.jsonl#run_meta", "comm_hook", None)]}
    row = lib_probe.make_result_row(rec, {"samples_per_sec": 100.0},
                                    {"samples_per_sec": measured})
    return lib_probe.build_tune_report(device="cpu", mode="train",
                                       baseline_metrics={"samples_per_sec": 100.0}, results=[row])


BROKEN = [
    {"type": "tune_report"},
    {"type": "bench", "schema_version": 13, "device": "cpu", "mode": "decode",
     "baseline_metrics": [], "results": {}},
    {"type": "tune_report", "schema_version": 12, "device": "cpu", "mode": "train",
     "baseline_metrics": {}, "results": [
         {"rule": "x", "rule_class": "bogus", "knob": "k", "diff": [], "metric": "m",
          "predicted_delta_pct": 1.0, "measured_delta_pct": -4.0, "endorsed": True,
          "evidence": {}},
         "not a row", {"rule": "y"}]},
]


def test_tune_reports_pass_each_others_validators(tmp_path):
    for measured in (120.0, 90.0):
        ours, theirs = _report(probe, advisor, measured), _report(jax_probe, jax_advisor, measured)
        assert ours == theirs
        assert jax_schema.validate_tune_payload(ours) == [] == schema.validate_tune_payload(theirs)
    for i, payload in enumerate(BROKEN):
        assert schema.validate_tune_payload(payload) == jax_schema.validate_tune_payload(payload)
        path = str(tmp_path / f"TUNE_r{i + 1:02d}.json")
        with open(path, "w") as f:
            json.dump(payload, f)
        assert schema.validate_tune_file(path) == jax_schema.validate_tune_file(path)
    assert probe.next_tune_path(str(tmp_path)) == jax_probe.next_tune_path(str(tmp_path))
    for rng_seed in range(3):
        rng = np.random.default_rng(rng_seed)
        for metric in sorted(probe.HIGHER_BETTER | probe.LOWER_BETTER) + ["unknown"]:
            base, tuned = (float(v) for v in rng.choice([0.0, 1.0, 3.5, 100.0], 2))
            assert probe.delta_pct(metric, base, tuned) == jax_probe.delta_pct(metric, base, tuned)


def test_the_tune_cli_writes_a_report_the_jax_validator_takes(tmp_path):
    """``python -m tpuddp_torch.tune --quick`` on the CPU: a baseline and a
    tuned run of the native entry point, the report valid for both
    packages and naming where it ran."""
    out = str(tmp_path / "TUNE_r01.json")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    env.pop("TPUDDP_TUNE_OVERLAY", None)
    proc = subprocess.run([sys.executable, "-m", "tpuddp_torch.tune", "--quick", "--epochs", "1",
                           "--out", out, "--keep", str(tmp_path / "runs")], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert jax_schema.validate_tune_file(out) == ([], 3) == schema.validate_tune_file(out)
    with open(out) as f:
        payload = json.load(f)
    assert payload["device"] == "cpu" and payload["mode"] == "train"
    tuned = [json.loads(line) for line in open(tmp_path / "runs" / "tuned" / "history.jsonl")]
    assert tuned[0]["tuning"]["source"] == "autotune"
    assert tuned[0]["pipeline"]["sync_readback"] is False


# ---------------------------------------------------------- the fleet tuner --

def _histories(seed):
    """A seeded script of epoch rows the job's history grows by, tick by tick."""
    rng = np.random.default_rng(seed)
    return [[{"type": "epoch", "samples_per_sec": float(rng.uniform(50, 150))}
             for _ in range(int(rng.integers(0, 3)))] for _ in range(40)]


def _recs(seed):
    rng = np.random.default_rng(1000 + seed)
    out = []
    for rule, knob, diff, metric in (
            ("comm_hook_uncompressed", "comm_hook", {"comm_hook": "bf16_ef"}, "grad_comm_bytes"),
            ("span_dispatch_share", "scan_steps", {"scan_steps": 16}, "step_time_ms_p50"),
            ("pipeline_sync_readback", "pipeline", {"pipeline": True}, "samples_per_sec"),
            ("snapshot_cadence_hot", "snapshot", {"snapshot": {"every_steps": 16}},
             "samples_per_sec")):
        out.append({"rule": rule, "rule_class": "comm", "section": "training", "knob": knob,
                    "diff": diff, "metric": metric,
                    "predicted_delta_pct": float(rng.choice([0.5, 5.0, 30.0])), "reason": "r",
                    "evidence": []})
    return out


@pytest.mark.parametrize("seed", range(4))
def test_fleet_tuners_decide_alike_from_equal_histories(seed, tmp_path):
    rng = np.random.default_rng(seed)
    policy = dict(cooldown_s=float(rng.choice([0.0, 3.0])), baseline_rows=int(rng.integers(1, 3)),
                  measure_rows=int(rng.integers(1, 3)),
                  revert_threshold_pct=float(rng.choice([0.0, 5.0])),
                  min_improvement_pct=float(rng.choice([1.0, 10.0])))
    endorsed = [None, {"span_dispatch_share", "pipeline_sync_readback"}, set()][seed % 3]
    recs, script = _recs(seed), _histories(seed)
    runs = {}
    for name, lib in (("port", online), ("jax", jax_online)):
        run_dir = str(tmp_path / name)
        os.makedirs(run_dir)
        rows = []
        tuner = lib.FleetTuner(lib.TunePolicy(**policy), endorsed_rules=endorsed,
                               advise=lambda _d: {"recommendations": [dict(r) for r in recs],
                                                  "insufficient": []},
                               reader=lambda _d: list(rows))
        decisions = []
        for t, grow in enumerate(script):
            rows += grow
            d = tuner.observe_and_decide("job", "training", run_dir, now=float(t))
            decisions.append(d)
            if d is not None:
                tuner.mark_applied("job", run_dir, d, float(t))
        path = os.path.join(run_dir, "history.jsonl")
        events = [json.loads(line) for line in open(path)] if os.path.exists(path) else []
        runs[name] = (decisions, dict(tuner.counters), tuner.actions, tuner.export_source(),
                      events)
    assert runs["port"] == runs["jax"]
    for e in runs["port"][4]:
        assert schema.validate_record(e) == [] == jax_schema.validate_record(e)
    assert online.endorsed_rules_from_report(os.devnull) == \
        jax_online.endorsed_rules_from_report(os.devnull) == set()
