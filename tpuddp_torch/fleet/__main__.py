"""``python -m tpuddp_torch.fleet`` — the fleet controller's CLI, the
counterpart of ``tools/fleet.py``: gang-schedule many of the port's jobs
over one pool of device slots.

Subcommands:

``run --spec fleet.yaml``
    Run a declared fleet until every training job reaches a terminal state,
    then drain the serving jobs and exit (0 iff nothing FAILED). The spec
    file::

        pool: 4                       # device slots
        fleet_dir: ./fleet            # run-dir namespace root (jobs/<name>/)
        poll: 1.0                     # controller tick seconds
        autoscale:                    # optional (fleet/autoscale.py knobs)
          slo_p99_ms: 50.0
          hysteresis: 2
          cooldown_s: 30.0
        tune:                         # optional online tuner (tune/online.py)
          report: TUNE_r01.json       # the offline probe's endorsement list
          cooldown_s: 300.0           # ... any TunePolicy knob
          # trust_advisor: true       # act on unprobed predictions (opt-in)
        jobs:
          - name: digits-a
            kind: training            # training | serving
            priority: 1
            min_world: 1
            max_world: 1
            argv: [python, -m, tpuddp_torch.train_native, --settings_file, a.yaml]

    ``{run_dir}`` inside argv/env expands to the job's namespaced run dir.
    A relative ``tune.report`` is read from the directory of the spec file.

``chaos-demo --out DIR [--device cuda|cpu]``
    The pool-level chaos proof on one host: four jobs share a pool of three
    slots (two training jobs on the ``digits_h100.yaml`` block cut to short
    epochs with a checkpoint each epoch, one serving job of up to two
    replicas on one device, one late arrival of higher priority). One
    training job is SIGKILLed, resumes and finishes; the online tuner
    applies one endorsed knob change to the other through drain and
    relaunch (its new header carries ``tuning``); the late arrival, with
    four jobs then wanting the three slots, displaces that job through the
    drain (SIGTERM, exit 75 with its emergency checkpoint, never SIGKILL
    first); the serving job breaches an SLO no run can meet and, once the
    late arrival has finished, is autoscaled from 1 to 2 replicas through
    ``$TPUDDP_SERVING_REPLICAS``.
    Every job's ``history.jsonl`` must pass the port's validator and every
    job keeps its own run dir, port file and checkpoints. Exit 0 only when
    every check holds; the last line of stdout is a JSON summary.

    The port's launcher takes one process per GPU on a host, so on one card
    every job runs at world 1 on ``cuda:0`` and the pool counts slots, not
    cards (``--device cuda``, the default, raises without a GPU;
    ``--device cpu`` runs the same scenario on the host). Each training job
    appends the Adam kernel's launches of each of its attempts to
    ``<run_dir>/adam_launches.jsonl`` (none from a SIGKILLed attempt).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import time

logger = logging.getLogger("tpuddp")

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# a training job's command: the native entry point as `python -m
# tpuddp_torch.train_native` runs it, the Adam kernel's launches of this
# attempt printed and appended to <run_dir>/adam_launches.jsonl however it
# ends (the drain ends it with SystemExit(75))
JOB_SCRIPT = (
    "import json, os, sys\n"
    "from tpuddp_torch import train_native\n"
    "from tpuddp_torch.ops import fused_adam\n"
    "try:\n"
    "    train_native.main(['--settings_file', sys.argv[1]])\n"
    "finally:\n"
    "    line = json.dumps({'pid': os.getpid(), 'launches': {\n"
    "        k.symbol: k.launches for k in fused_adam.kernels.values()}})\n"
    "    print('LAUNCHES ' + line, flush=True)\n"
    "    with open(os.path.join(sys.argv[2], 'adam_launches.jsonl'), 'a') as f:\n"
    "        f.write(line + '\\n')\n"
)


def _load_yaml(path):
    import yaml

    with open(path) as f:
        obj = yaml.safe_load(f)
    if not isinstance(obj, dict):
        raise SystemExit(f"fleet spec {path} did not parse to a mapping")
    return obj


def cmd_run(args) -> int:
    from tpuddp_torch.fleet.autoscale import Autoscaler, AutoscalePolicy
    from tpuddp_torch.fleet.controller import FleetController
    from tpuddp_torch.fleet.spec import spec_from_dict
    from tpuddp_torch.tune.online import FleetTuner, TunePolicy, endorsed_rules_from_report

    spec = _load_yaml(args.spec)
    pool = int(spec.get("pool") or 0)
    if pool < 1:
        raise SystemExit("fleet spec needs a positive 'pool' size")
    fleet_dir = args.fleet_dir or spec.get("fleet_dir") or "./fleet"
    autoscaler = Autoscaler(AutoscalePolicy(**spec["autoscale"])) if spec.get("autoscale") else None
    # without 'report' the tuner stays inert (nothing is endorsed) unless
    # 'trust_advisor: true' opts into unprobed predictions
    tuner = None
    if spec.get("tune"):
        tune_cfg = dict(spec["tune"])
        report = tune_cfg.pop("report", None)
        if tune_cfg.pop("trust_advisor", False):
            endorsed = None
        elif report:
            endorsed = endorsed_rules_from_report(
                os.path.join(os.path.dirname(os.path.abspath(args.spec)), report))
        else:
            endorsed = set()
        tuner = FleetTuner(policy=TunePolicy(**tune_cfg), endorsed_rules=endorsed)
    controller = FleetController(pool, fleet_dir=fleet_dir, autoscaler=autoscaler, tuner=tuner,
                                 observability=spec.get("observability"))
    for entry in spec.get("jobs") or []:
        controller.submit(spec_from_dict(entry))
    if not controller.jobs:
        raise SystemExit("fleet spec declares no jobs")
    poll = float(args.poll or spec.get("poll") or 1.0)
    completed = False
    try:
        completed = controller.run_until(lambda c: c.training_complete(), poll=poll,
                                         timeout=args.timeout)
    finally:
        controller.shutdown()
    for s in controller.status():
        print(f"fleet: {s['name']}: {s['state']} (world {s['world']}, rc {s['exit_code']})")
    if not completed:
        # the shutdown preempts the stuck jobs (state 'preempted', not
        # 'failed'), so a hung fleet must say so itself
        print("fleet: timed out before every training job finished", file=sys.stderr)
        return 1
    return 1 if any(s["state"] == "failed" for s in controller.status()) else 0


# --------------------------------------------------------------- chaos demo --
def history_records(run_dir):
    path = os.path.join(run_dir, "history.jsonl")
    if not os.path.exists(path):
        return []
    records = []
    with open(path) as f:
        for line in f:
            if line.strip():
                try:
                    records.append(json.loads(line))
                except ValueError:
                    records.append({"type": "<unparseable>"})
    return records


def epoch_rows(run_dir):
    return [r for r in history_records(run_dir) if r.get("type") == "epoch"]


def _headers(run_dir):
    return [r for r in history_records(run_dir) if r.get("type") == "run_meta"]


def _epochs_after_tuned_header(run_dir) -> int:
    """Epoch rows written after the first header that carries ``tuning``."""
    records = history_records(run_dir)
    first = next((i for i, r in enumerate(records)
                  if r.get("type") == "run_meta" and r.get("tuning")), None)
    return 0 if first is None else sum(1 for r in records[first:] if r.get("type") == "epoch")


def adam_launches(run_dir):
    """Each finished attempt's Adam launches, by kernel symbol."""
    path = os.path.join(run_dir, "adam_launches.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line)["launches"] for line in f if line.strip()]


class ChaosCheckFailure(AssertionError):
    pass


def _check(cond, message):
    if not cond:
        raise ChaosCheckFailure(message)


# the demo's jobs: the training block of tpuddp_torch/configs/digits_h100.yaml
# (toy_cnn, sync_bn, the 1,797 digit scans at 8 px) cut to short runs with a
# checkpoint each epoch and no step_stats rows (the tuner judges a change on
# epoch rows, none of which the drained attempt writes); the tuned job
# starts on the synchronous pipeline, the evidence the advisor's
# pipeline_sync_readback rule acts on
# train-b must still run when train-d arrives (then four jobs want the three
# slots and the lowest, train-a, is displaced); train-a never finishes
DEMO_EPOCHS = {"train-b": 300, "train-a": 1000, "train-d": 2}
DEMO_MEASURE_ROWS = 1000
DEMO_TRAINING = dict(model="toy_cnn", dataset="digits", train_batch_size=32, test_batch_size=45,
                     learning_rate=0.001, checkpoint_epoch=1, image_size=None, seed=0,
                     sync_bn=True, keep_last=3)
DEMO_TUNED_RULE = "pipeline_sync_readback"
DEMO_SERVING = dict(model="toy_mlp", num_replicas=1, max_batch_size=8, stats_window=8)
DEMO_SLO_P99_MS = 0.05  # no batch meets it: a p99 breach on the first window
DEMO_REQUESTS = 32


def _settings(path, out_dir, device, **blocks):
    import yaml

    # one training process; up to two serving replicas on the one card
    local = {"device": device, "gpu": {"num_gpus": 1, "serving_devices": [0, 0]}}
    with open(path, "w") as f:
        yaml.safe_dump({"out_dir": out_dir, "optional_args": {"set_epoch": True},
                        "local": local, **blocks}, f, sort_keys=False)
    return path


def run_chaos_demo(out_dir: str, device: str = "cuda", pool: int = 3,
                   timeout: float = 600.0) -> dict:
    """The scripted multi-job chaos scenario (module doc); returns its
    figures, raises :class:`ChaosCheckFailure` on the first failed check."""
    from tpuddp_torch.fleet.autoscale import Autoscaler, AutoscalePolicy, scrape_job
    from tpuddp_torch.fleet.controller import FleetController
    from tpuddp_torch.fleet.spec import JobSpec
    from tpuddp_torch.observability import schema
    from tpuddp_torch.observability.exporter import read_live_port
    from tpuddp_torch.resilience.supervisor import SupervisorPolicy
    from tpuddp_torch.tune.online import FleetTuner, TunePolicy

    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("chaos-demo --device cuda needs a GPU (torch.cuda.is_available() is "
                               "False); pass --device cpu to run it on the host")
    t0 = time.monotonic()
    marks = {}

    def mark(name):
        marks[name] = round(time.monotonic() - t0, 3)

    def remaining():
        left = timeout - (time.monotonic() - t0)
        _check(left > 0, "chaos demo exceeded its overall timeout")
        return left

    out_dir = os.path.abspath(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    base_env = dict(os.environ)
    for var in ("TPUDDP_FAULT", "TPUDDP_AUTO_RESUME", "TPUDDP_WORLD_SIZE", "TPUDDP_MODEL_SIZE",
                "TPUDDP_SERVING_REPLICAS", "TPUDDP_TUNE_OVERLAY", "TPUDDP_SPAWNED"):
        base_env.pop(var, None)
    base_env["PYTHONPATH"] = ROOT + os.pathsep + base_env.get("PYTHONPATH", "")
    if device == "cpu":
        base_env.setdefault("OMP_NUM_THREADS", "2")

    def run_dir(name):
        return os.path.join(out_dir, "jobs", name)

    py = sys.executable

    def training_job(name, priority, **more):
        settings = _settings(os.path.join(out_dir, f"{name}.yaml"), run_dir(name), device,
                             training=dict(DEMO_TRAINING, num_epochs=DEMO_EPOCHS[name], **more),
                             observability={"exporter": True})
        return JobSpec(name=name, kind="training", priority=priority, min_world=1, max_world=1,
                       argv=(py, "-u", "-c", JOB_SCRIPT, settings, "{run_dir}"))

    serve_settings = _settings(os.path.join(out_dir, "serve-c.yaml"), run_dir("serve-c"), device,
                               serving=DEMO_SERVING,
                               observability={"exporter": True, "exporter_port": 0})
    # one fresh breached window is enough evidence here (the hysteresis
    # matrix is unit-tested); the tuner acts on the one endorsed rule after
    # one baseline epoch and holds its verdict past the displacement (its
    # keep and revert legs are unit-tested): a revert's relaunch would race
    # the displacing SIGTERM
    autoscaler = Autoscaler(AutoscalePolicy(slo_p99_ms=DEMO_SLO_P99_MS, hysteresis=1,
                                            cooldown_s=10.0))
    scrapes = {"tried": 0, "live": 0}

    def counted_scrape(path):
        obs = scrape_job(path)
        scrapes["tried"] += 1
        scrapes["live"] += obs is not None
        return obs

    autoscaler.scraper = counted_scrape
    tuner = FleetTuner(TunePolicy(cooldown_s=0.0, baseline_rows=1, measure_rows=DEMO_MEASURE_ROWS),
                       endorsed_rules={DEMO_TUNED_RULE})
    controller = FleetController(
        pool, fleet_dir=out_dir, autoscaler=autoscaler, tuner=tuner, env=base_env,
        supervisor_policy=SupervisorPolicy(backoff_base=0.3, backoff_cap=2.0))

    # events timed at the first tick that sees them, whichever wait is
    # running then (the tuner acts during the kill phase's waits)
    watch = {}

    def wait_for(cond, what, poll=0.1):
        deadline = time.monotonic() + remaining()
        while time.monotonic() < deadline:
            controller.step()
            for name, seen in list(watch.items()):
                if name not in marks and seen():
                    mark(name)
            if cond():
                return
            time.sleep(poll)
        raise ChaosCheckFailure(f"timed out waiting for {what}")

    try:
        job_b = controller.submit(training_job("train-b", 1))
        job_a = controller.submit(training_job("train-a", 1, pipeline=False))
        job_c = controller.submit(JobSpec(
            name="serve-c", kind="serving", priority=2, min_world=1, max_world=2,
            argv=(py, "-u", "-m", "tpuddp_torch.serving", "--settings", serve_settings,
                  "--demo", str(DEMO_REQUESTS), "--serve", "0")))

        watch.update(
            tune_sigterm=lambda: any(a["action"] == "apply" for a in tuner.actions),
            tune_exit=lambda: any(rc == 75 for _, rc, _ in job_a.supervisor.history),
            tuned_header=lambda: any(h.get("tuning") for h in _headers(job_a.run_dir)),
            tuned_epoch=lambda: _epochs_after_tuned_header(job_a.run_dir) >= 1,
            displace_sigterm=lambda: job_a.stopping,
            displaced_exit=lambda: job_a.state == "preempted",
            scale_up=lambda: job_c.world == 2,
            scaled_header=lambda: any(h.get("num_replicas") == 2
                                      for h in _headers(job_c.run_dir)))
        print("fleet chaos: phase 1 — three jobs share the pool", flush=True)
        wait_for(lambda: all(j.state == "running" for j in (job_a, job_b, job_c)),
                 "the initial placement (train-b, train-a, serve-c at world 1)")
        alloc = controller.last_plan.alloc
        _check(alloc == {"train-b": 1, "train-a": 1, "serve-c": 1},
               f"unexpected initial allocation: {alloc}")

        print("fleet chaos: phase 2 — SIGKILL train-b mid-run", flush=True)
        wait_for(lambda: len(epoch_rows(job_b.run_dir)) >= 1, "train-b's first epoch row")
        child = job_b.supervisor.child
        _check(child is not None and child.poll() is None, "train-b has no live child to kill")
        os.kill(child.pid, signal.SIGKILL)
        mark("sigkill")
        wait_for(lambda: any(rc == -signal.SIGKILL for _, rc, _ in job_b.supervisor.history),
                 "train-b's supervisor to observe the signal death")
        kill_epochs, kill_headers = len(epoch_rows(job_b.run_dir)), len(_headers(job_b.run_dir))
        watch.update(resumed_header=lambda: len(_headers(job_b.run_dir)) > kill_headers,
                     resumed_epoch=lambda: len(epoch_rows(job_b.run_dir)) > kill_epochs)
        wait_for(lambda: "resumed_epoch" in marks, "train-b's first epoch after the resume")

        # per-job live endpoints, each found through its own run dir
        ports = {}
        wait_for(lambda: read_live_port(job_c.run_dir, probe_timeout=2.0) is not None
                 and read_live_port(job_a.run_dir, probe_timeout=2.0) is not None,
                 "train-a's and serve-c's exporters")
        for job in (job_a, job_c):
            ports[job.spec.name] = read_live_port(job.run_dir, probe_timeout=2.0)
        _check(len(set(ports.values())) == len(ports) == 2,
               f"expected distinct live per-job exporter ports, got {ports}")

        print("fleet chaos: phase 3 — the tuner's endorsed change on train-a", flush=True)
        wait_for(lambda: "tuned_epoch" in marks,
                 f"the tuner's {DEMO_TUNED_RULE} on train-a: the drain, the relaunched header "
                 "carrying tuning, its first epoch")

        print("fleet chaos: phase 4 — a high-priority arrival displaces train-a", flush=True)
        _check(job_b.state == "running", "train-b finished before the arrival; nothing to displace")
        job_d = controller.submit(training_job("train-d", 100))
        mark("arrival")
        wait_for(lambda: "displaced_exit" in marks, "train-a displaced through the drain")
        wait_for(lambda: job_d.state == "running", "train-d placed")

        print("fleet chaos: phase 5 — serve-c autoscaled on the p99 breach", flush=True)
        wait_for(lambda: job_d.state == "done", "train-d to finish")
        wait_for(lambda: "scaled_header" in marks,
                 "serve-c autoscaled to 2 replicas, its run_meta header at num_replicas=2")
        _check(any(a["action"] == "scale_up" and a["job"] == "serve-c" for a in autoscaler.actions),
               f"no scale_up action recorded: {autoscaler.actions}")

        print("fleet chaos: phase 6 — drain the fleet", flush=True)
        wait_for(lambda: job_b.state == "done", "train-b to finish")
        # the entry point takes SIGTERM as a drain once its demo traffic is
        # served (its handler comes right after the demo, as the JAX one's)
        wait_for(lambda: (scrape_job(job_c.run_dir) or {}).get("fresh_cursor") == DEMO_REQUESTS,
                 "the 2-replica serve-c's demo traffic served")
        wait_for(lambda: True, "one more tick")
        controller.stop_job("serve-c")
        wait_for(lambda: job_c.state == "preempted", "serve-c to drain out")
    finally:
        controller.shutdown()
    mark("done")

    print("fleet chaos: phase 7 — verify the artifacts", flush=True)
    jobs = (job_a, job_b, job_c, job_d)
    for job in jobs:
        errors, n = schema.validate_history_file(os.path.join(job.run_dir, "history.jsonl"))
        _check(not errors and n > 0, f"{job.spec.name}: history.jsonl invalid: {errors[:5]}")
    # train-b: SIGKILLed, resumed at its own world with every epoch whole
    b_metas = _headers(job_b.run_dir)
    _check(len(b_metas) >= 2, "train-b: expected a resumed (second) header")
    _check(not any(r.get("resumed_from_world") for r in b_metas),
           "train-b resumed on its own world; resumed_from_world must be unset")
    b_epochs = sorted({r["epoch"] for r in epoch_rows(job_b.run_dir)})
    _check(b_epochs == list(range(DEMO_EPOCHS["train-b"])),
           f"train-b epochs incomplete: {b_epochs}")
    # train-a: one tuned relaunch, then displaced through the drain: exit 75
    # with its emergency checkpoint, never a SIGKILL
    a_hist = job_a.supervisor.history
    a_rcs = [rc for _, rc, _ in a_hist]
    _check(a_rcs.count(75) >= 2 and all(rc >= 0 for rc in a_rcs),
           f"train-a: expected drains (75) and no signal death, got {a_rcs}")
    a_metas = _headers(job_a.run_dir)
    tuned = [h for h in a_metas if h.get("tuning")]
    _check(a_metas[0].get("tuning") is None and tuned
           and tuned[0]["tuning"]["rule"] == DEMO_TUNED_RULE
           and tuned[0]["tuning"]["applied"] == {"training": {"pipeline": True}}
           and tuned[0]["pipeline"]["sync_readback"] is False,
           f"train-a: tuned header wrong: {[h.get('tuning') for h in a_metas]}")
    a_events = [r for r in history_records(job_a.run_dir) if r.get("event") == "tune_action"]
    _check(a_events and a_events[0]["action"] == "apply" and a_events[0]["rule"] == DEMO_TUNED_RULE,
           f"train-a: no tune_action apply event: {a_events}")
    preempts = [r for r in history_records(job_a.run_dir) if r.get("event") == "preempt"]
    _check(len(preempts) >= 2, f"train-a: expected two drain events, got {preempts}")
    emergency = os.path.join(job_a.run_dir, f"ckpt_{preempts[-1]['epoch']}.npz")
    _check(any(f.startswith("ckpt_") and f.endswith(".npz") for f in os.listdir(job_a.run_dir))
           and preempts[-1].get("completed") == 0,
           f"train-a: no emergency checkpoint of the displacement ({emergency})")
    # serve-c: 1 -> 2 replicas, each attempt ended by a drain
    _check([rc for _, rc, _ in job_c.supervisor.history] == [75, 75],
           f"serve-c: expected two drains (75), got {job_c.supervisor.history}")
    c_metas = _headers(job_c.run_dir)
    _check(c_metas and c_metas[0].get("num_replicas") == 1
           and any(r.get("num_replicas") == 2 for r in c_metas),
           f"serve-c replica headers wrong: {[r.get('num_replicas') for r in c_metas]}")
    # train-d: ran once, gang-placed at its min = max = 1
    d_metas = _headers(job_d.run_dir)
    _check(len(d_metas) == 1 and d_metas[0].get("world_size") == 1, f"train-d headers: {d_metas}")
    # namespacing: each job's channels live under its own run dir
    for job in (job_a, job_b, job_d):
        _check(any(f.startswith("ckpt_") for f in os.listdir(job.run_dir)),
               f"{job.spec.name}: no namespaced checkpoints")
    _check(len({os.path.realpath(j.run_dir) for j in jobs}) == 4, "run dirs are not disjoint")
    launches = {j.spec.name: adam_launches(j.run_dir) for j in (job_a, job_b, job_d)}
    if device == "cuda":
        _check(all(launches[n] and all(sum(a.values()) > 0 for a in launches[n]) for n in launches),
               f"a training attempt launched no Adam kernel: {launches}")
    summary = {
        "device": device, "pool": pool, "marks_s": marks,
        "sigkill_to_resumed_header_s": round(marks["resumed_header"] - marks["sigkill"], 3),
        "sigkill_to_resumed_epoch_s": round(marks["resumed_epoch"] - marks["sigkill"], 3),
        "tune_sigterm_to_exit_75_s": round(marks["tune_exit"] - marks["tune_sigterm"], 3),
        "tune_sigterm_to_relaunched_header_s": round(marks["tuned_header"] - marks["tune_sigterm"],
                                                     3),
        "tune_sigterm_to_relaunched_epoch_s": round(marks["tuned_epoch"] - marks["tune_sigterm"],
                                                    3),
        "displace_sigterm_to_exit_75_s": round(marks["displaced_exit"] - marks["displace_sigterm"],
                                               3),
        "scale_up_to_scaled_header_s": round(marks["scaled_header"] - marks["scale_up"], 3),
        "scrapes": scrapes, "proposals": len(autoscaler.actions),
        "supervisor_history": {j.spec.name: [list(h) for h in j.supervisor.history] for j in jobs},
        "autoscaler_actions": autoscaler.actions, "tuner_actions": tuner.actions,
        "tuner_counters": dict(tuner.counters), "ports": ports,
        "epochs": {j.spec.name: len(epoch_rows(j.run_dir)) for j in (job_a, job_b, job_d)},
        "adam_launches": launches,
    }
    print("fleet chaos: PASS — kill/tune/preempt/autoscale survived with every history valid and "
          "namespaced", flush=True)
    return summary


def cmd_chaos_demo(args) -> int:
    try:
        summary = run_chaos_demo(args.out, device=args.device, pool=args.pool,
                                 timeout=args.timeout)
    except ChaosCheckFailure as e:
        print(f"fleet chaos: FAIL — {e}", file=sys.stderr)
        return 1
    print(json.dumps(summary, sort_keys=True))
    return 0


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    parser = argparse.ArgumentParser(
        prog="python -m tpuddp_torch.fleet",
        description="tpuddp_torch fleet controller (gang scheduling + priority preemption + "
        "metric-driven autoscaling + online tuning over one pool of device slots)",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_run = sub.add_parser("run", help="run a declared fleet spec file")
    p_run.add_argument("--spec", required=True, help="fleet YAML file")
    p_run.add_argument("--fleet-dir", default=None, help="override the spec's fleet_dir")
    p_run.add_argument("--poll", type=float, default=None, help="controller tick seconds")
    p_run.add_argument("--timeout", type=float, default=None,
                       help="give up after this many seconds")
    p_run.set_defaults(fn=cmd_run)
    p_demo = sub.add_parser("chaos-demo", help="the pool-level chaos proof "
                            "(kill/tune/preempt/autoscale, four jobs)")
    p_demo.add_argument("--out", required=True, help="fleet dir for the demo")
    p_demo.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the jobs run (default cuda: raises without a GPU)")
    p_demo.add_argument("--pool", type=int, default=3)
    p_demo.add_argument("--timeout", type=float, default=600.0)
    p_demo.set_defaults(fn=cmd_chaos_demo)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
