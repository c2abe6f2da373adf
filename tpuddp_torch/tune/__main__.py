"""``python -m tpuddp_torch.tune`` — the A/B probe: the advisor's
predictions against measured runs; the counterpart of ``tools/autotune.py``.

The offline advisor (``python -m tpuddp_torch.inspect tune``) predicts;
this command makes it answer for the prediction. It runs the port's native
entry point twice, a baseline on the given knobs and then a tuned run
launched under the advisor's ``$TPUDDP_TUNE_OVERLAY``, measures both from
their own histories (``observability.advisor.measure_run``) and writes each
recommendation's predicted and measured delta into a schema-v12
``TUNE_rNN.json`` (``tune/probe.py`` builds and validates it). A rule whose
measured delta regresses ships ``endorsed: false``, whatever the
prediction; the fleet tuner acts on endorsed rules only.

Both runs go to the card (``local.device: cuda``: raises without a GPU)
unless ``--quick`` asks for the CPU; the report's ``device`` names the card
(the header's ``device_kind``) or ``cpu``. On the CPU the deltas calibrate
the rules' direction; byte and counter metrics (``grad_comm_bytes``,
snapshot skips) carry over to the card, wall-clock ratios do not.

Usage::

    python -m tpuddp_torch.tune --quick                  # the CPU probe, 2 epochs
    python -m tpuddp_torch.tune --out out/TUNE_r01.json  # on the card
    python -m tpuddp_torch.tune --baseline-dir RUN_DIR   # reuse a run as A
    python -m tpuddp_torch.tune --training '{"snapshot": {"every_steps": 1}}'

Exit: 0 on a written report (even when nothing is endorsed: the artifact is
the result), nonzero when a run or the validation fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import yaml

from tpuddp_torch.observability import advisor as advisor_lib
from tpuddp_torch.tune import probe

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the probe's job: tools/autotune.py's (the chaos worker's toy_mlp block on
# the synthetic stand-in, 8 batches an epoch) with deliberately bad knobs,
# each arming a rule of another class (pipeline_sync_readback,
# snapshot_cadence_hot)
TRAINING = dict(model="toy_mlp", dataset="cifar10", data_root="/nonexistent", train_batch_size=8,
                test_batch_size=8, learning_rate=0.01, checkpoint_epoch=1, image_size=None, seed=0,
                synthetic_n=[256, 64])
QUICK_BASELINE = {"pipeline": False, "snapshot": {"every_steps": 1, "inflight": 1},
                  "step_stats_every": 4}


def _run(out_dir, *, training, epochs, world, device, overlay=None) -> int:
    """One run of the native entry point (drain handlers, snapshots and
    tracing live); ``overlay`` rides ``$TPUDDP_TUNE_OVERLAY`` as a fleet
    relaunch would."""
    os.makedirs(out_dir, exist_ok=True)
    settings = os.path.join(out_dir, "settings.yaml")
    with open(settings, "w") as f:
        yaml.safe_dump({"out_dir": out_dir, "local": {"device": device},
                        "observability": {"tracing": True},
                        "training": dict(training, num_epochs=epochs)}, f, sort_keys=False)
    env = dict(os.environ, TPUDDP_WORLD_SIZE=str(world),
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for var in ("TPUDDP_TUNE_OVERLAY", "TPUDDP_FAULT", "TPUDDP_AUTO_RESUME", "TPUDDP_SPAWNED"):
        env.pop(var, None)
    if overlay is not None:
        env["TPUDDP_TUNE_OVERLAY"] = json.dumps(overlay)
    return subprocess.call([sys.executable, "-u", "-m", "tpuddp_torch.train_native",
                            "--settings_file", settings], cwd=ROOT, env=env)


def _device_of(run_dir):
    try:
        with open(os.path.join(run_dir, "history.jsonl")) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("type") == "run_meta":
                    return rec.get("device_kind")
    except (OSError, ValueError):
        pass
    return None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m tpuddp_torch.tune",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--quick", action="store_true",
                        help="run both legs on the CPU (default: on the card)")
    parser.add_argument("--training", default=None, metavar="JSON",
                        help="baseline training-block overrides (a JSON object) over the "
                        "deliberately bad baseline knobs")
    parser.add_argument("--baseline-dir", default=None, metavar="RUN_DIR",
                        help="reuse a finished run dir as the baseline (its history must carry "
                        "the knobs the advisor should see)")
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--world", type=int, default=1)
    parser.add_argument("--out", default=None, metavar="PATH",
                        help="report path (default: the next TUNE_rNN.json in ./out/)")
    parser.add_argument("--min-improvement", type=float, default=0.0, metavar="PCT",
                        help="endorsement floor on the measured delta (default 0.0: any "
                        "regression refuses endorsement)")
    parser.add_argument("--keep", default=None, metavar="DIR",
                        help="keep the probe's run dirs under DIR (default: a temporary one)")
    args = parser.parse_args(argv)
    device = "cpu" if args.quick else "cuda"
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("python -m tpuddp_torch.tune runs on the card by default and "
                               "torch.cuda.is_available() is False; pass --quick for the CPU")

    training = dict(TRAINING, **QUICK_BASELINE)
    if args.training:
        training.update(json.loads(args.training))

    with tempfile.TemporaryDirectory(prefix="tpuddp_torch_tune_") as tmp:
        work = args.keep or tmp
        os.makedirs(work, exist_ok=True)
        baseline_dir = args.baseline_dir
        if baseline_dir is None:
            baseline_dir = os.path.join(work, "baseline")
            print(f"tune: baseline run on {device} -> {baseline_dir}", flush=True)
            rc = _run(baseline_dir, training=training, epochs=args.epochs, world=args.world,
                      device=device)
            if rc != 0:
                print(f"tune: the baseline run exited {rc}", file=sys.stderr)
                return rc

        report = advisor_lib.advise(baseline_dir)
        recs = report["recommendations"]
        if not recs:
            print("tune: the advisor found nothing to recommend on the baseline; no probe to "
                  "run, no report written")
            return 0
        overlay = advisor_lib.overlay_from(recs)
        overlay["source"] = "autotune"
        print(f"tune: {len(recs)} recommendation(s); overlay = "
              + json.dumps(overlay, sort_keys=True), flush=True)

        tuned_dir = os.path.join(work, "tuned")
        print(f"tune: tuned run on {device} -> {tuned_dir}", flush=True)
        rc = _run(tuned_dir, training=training, epochs=args.epochs, world=args.world,
                  device=device, overlay=overlay)
        if rc != 0:
            print(f"tune: the tuned run exited {rc}", file=sys.stderr)
            return rc

        baseline_metrics = advisor_lib.measure_run(baseline_dir)
        tuned_metrics = advisor_lib.measure_run(tuned_dir)
        results = [probe.make_result_row(rec, baseline_metrics, tuned_metrics,
                                         min_improvement_pct=args.min_improvement)
                   for rec in recs]
        payload = probe.build_tune_report(
            device=_device_of(baseline_dir) or device, mode="train",
            baseline_metrics=baseline_metrics, results=results,
            extra={"tuned_metrics": tuned_metrics, "overlay": overlay, "epochs": args.epochs,
                   "world_size": args.world, "baseline_training": training})
        if args.out:
            out = args.out
        else:
            os.makedirs("out", exist_ok=True)
            out = probe.next_tune_path("out")
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out + ".tmp", "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(out + ".tmp", out)

        print(f"\ntune: wrote {out}")
        for r in results:
            meas = r["measured_delta_pct"]
            print(f"  [{'endorsed' if r['endorsed'] else 'REFUSED'}] {r['rule']} ({r['metric']}): "
                  f"predicted {r['predicted_delta_pct']:+.1f}%, measured "
                  f"{f'{meas:+.1f}%' if meas is not None else 'unmeasured'}")
        print(f"tune: {sum(r['endorsed'] for r in results)}/{len(results)} endorsed")
        return 0


if __name__ == "__main__":
    sys.exit(main())
