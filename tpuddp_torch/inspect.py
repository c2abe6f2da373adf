"""``python -m tpuddp_torch.inspect`` — the port's inspector: the
``reshard`` and ``tune`` modes of ``tools/tpuddp_inspect.py``.

- ``reshard <src> --to data=D,model=M [--out PATH]`` — the offline
  cross-topology reshaper (:func:`tpuddp_torch.training.reshard.
  reshard_checkpoint`): rewrite a checkpoint saved on one ``(data, model)``
  mesh for another, atomically, with a fresh ``.sha256`` manifest. It is
  what ``training.reshard_on_mismatch: true`` does at load time, run before
  the relaunch instead. Exit 0 on a written file, 1 with ``REFUSED: ...``
  on stderr when the reshaper refuses the file, 2 for a missing source;
  argument errors are argparse's (exit 2).
- ``tune <run_dir> [--emit PATH] [--json]`` — the offline advisor
  (:mod:`tpuddp_torch.observability.advisor`): read the run's history,
  traces and writer sidecars and print knob recommendations with their
  evidence and predicted deltas. ``--emit PATH`` writes the merged
  ``$TPUDDP_TUNE_OVERLAY`` payload; ``--json`` prints the whole report.
  Read-only: inspecting a run never changes it. Exit 2 for a missing dir.

The output, exit codes and refusal texts are the JAX inspector's. Both
modes read files only and run on any host; neither touches a device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def reshard_main(argv) -> int:
    from tpuddp_torch.training import reshard

    parser = argparse.ArgumentParser(
        prog="python -m tpuddp_torch.inspect reshard",
        description="Offline cross-topology checkpoint reshaper: rewrite a format-v3 checkpoint "
        "saved on one (data, model) mesh for another (atomic publish + fresh sha256 manifest). "
        "The load-time equivalent is training.reshard_on_mismatch: true.",
    )
    parser.add_argument("src", help="source ckpt_<epoch>.npz")
    parser.add_argument("--to", required=True, metavar="data=D,model=M",
                        help="target mesh shape, e.g. --to data=2,model=1")
    parser.add_argument("--out", default=None, metavar="PATH",
                        help="output file (default: <src stem>.d<D>m<M>.npz alongside src; pass "
                        "the src path itself to reshape in place)")
    args = parser.parse_args(argv)
    if not os.path.isfile(args.src):
        print(f"no such file: {args.src}", file=sys.stderr)
        return 2
    shape = {}
    for part in args.to.split(","):
        if "=" not in part:
            parser.error(f"--to expects data=D,model=M, got {args.to!r}")
        k, v = part.split("=", 1)
        shape[k.strip()] = v.strip()
    if set(shape) - {"data", "model"} or "data" not in shape:
        parser.error(f"--to expects data=D,model=M, got {args.to!r}")
    try:
        data = int(shape["data"])
        model = int(shape.get("model", 1))
    except ValueError:
        parser.error(f"--to expects integer widths, got {args.to!r}")
    out = args.out
    if out is None:
        stem = args.src[:-len(".npz")] if args.src.endswith(".npz") else args.src
        out = f"{stem}.d{data}m{model}.npz"
    try:
        report = reshard.reshard_checkpoint(args.src, out, data, model)
    except reshard.ReshardError as e:
        print(f"REFUSED: {e}", file=sys.stderr)
        return 1
    f, t = report["from"], report["to"]
    print(f"resharded {report['src']} -> {report['dst']}")
    print(f"  mesh: (data={f['data']}, model={f['model']}) -> "
          f"(data={t['data']}, model={t['model']}), {report['leaves']} leaves")
    for a in report["actions"]:
        detail = {k: v for k, v in a.items() if k not in ("leaf", "action")}
        print(f"  {a['action']}: {a['leaf']} {detail}")
    if not report["actions"]:
        print("  (no per-leaf surgery needed: payloads are mesh-shape-independent at these "
              "shapes)")
    return 0


def tune_main(argv) -> int:
    from tpuddp_torch.observability import advisor

    parser = argparse.ArgumentParser(
        prog="python -m tpuddp_torch.inspect tune",
        description="Offline advisor: read a run dir's history.jsonl, trace_*.json, and writer "
        "sidecars, and print knob recommendations with evidence citations + predicted deltas. "
        "Read-only — nothing is applied unless you --emit an overlay and launch with it.",
    )
    parser.add_argument("run_dir", help="run directory (holds history.jsonl)")
    parser.add_argument("--emit", metavar="PATH", default=None,
                        help="write the tuned config overlay (the $TPUDDP_TUNE_OVERLAY payload) "
                        "for the recommendations to PATH")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="print the full report as JSON (machine-readable)")
    args = parser.parse_args(argv)
    if not os.path.isdir(args.run_dir):
        print(f"no such run dir: {args.run_dir}", file=sys.stderr)
        return 2
    report = advisor.advise(args.run_dir)
    if args.as_json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(advisor.format_report(report))
    if args.emit:
        overlay = advisor.overlay_from(report["recommendations"])
        overlay["source"] = "advisor"
        with open(args.emit + ".tmp", "w") as f:
            json.dump(overlay, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(args.emit + ".tmp", args.emit)
        print(f"\noverlay written: {args.emit} "
              f"(launch with TPUDDP_TUNE_OVERLAY=\"$(cat {args.emit})\")")
    return 0


MODES = {"reshard": reshard_main, "tune": tune_main}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in MODES:
        print("usage: python -m tpuddp_torch.inspect {reshard,tune} ...\n"
              "  reshard <src> --to data=D,model=M [--out PATH]\n"
              "  tune <run_dir> [--emit PATH] [--json]", file=sys.stderr)
        return 2
    return MODES[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
