"""Run a training command under the restart supervisor — the counterpart of
``tools/supervise.py``.

The supervisor (:mod:`tpuddp_torch.resilience.supervisor`) reads the exit
codes that the training processes speak:

    0   done                         -> exit 0
    75  preemption drain             -> resume at once ($TPUDDP_AUTO_RESUME=1)
    76  stale peer (the watchdog)    -> jittered-backoff restart; after
                                        --shrink-after 76s in a row the world
                                        shrinks ($TPUDDP_WORLD_SIZE) and the
                                        run resumes through the elastic restore
    77  replica desync               -> jittered-backoff restart and resume
    *   any other non-zero code      -> jittered-backoff restart and resume,
                                        at most --max-restarts in all

Usage::

    python -m tpuddp_torch.supervise [options] -- <command> [args...]

    # a native run on 4 GPUs, allowed to shrink to 2 after repeated peer deaths
    python -m tpuddp_torch.supervise --world 4 --min-world 2 -- \\
        python -m tpuddp_torch.train_native --settings_file settings.yaml

The options are the policy's (:class:`~tpuddp_torch.resilience.supervisor.
SupervisorPolicy`) and ``tools/supervise.py``'s; ``--first-env KEY=VAL``
applies to the first attempt only (a fault injected there must not fire
again in the resumed run); ``--world`` pins ``$TPUDDP_WORLD_SIZE`` and arms
the shrink; ``--flight-dir DIR`` logs a summary of each flight recording
the child leaves in DIR (usually its ``out_dir``) before each restart.
``--model`` pins ``$TPUDDP_MODEL_SIZE``; the native entry point then
derives ``data = world / model`` and, with ``training.reshard_on_mismatch``,
reshapes a checkpoint of another width on load.
"""

from __future__ import annotations

import argparse
import logging
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Restart supervisor for tpuddp training commands "
        "(exit-code contract interpreter + elastic world shrink).",
    )
    parser.add_argument("--world", type=int, default=None,
                        help="initial world size (pins $TPUDDP_WORLD_SIZE; "
                        "required for elastic shrink)")
    parser.add_argument("--model", type=int, default=None,
                        help="tensor-parallel width (pins $TPUDDP_MODEL_SIZE); "
                        "arms MESH-aware shrink: data axis halves first, the "
                        "model axis shrinks only once data=1")
    parser.add_argument("--max-restarts", type=int, default=8,
                        help="total restart budget across all causes")
    parser.add_argument("--backoff-base", type=float, default=1.0,
                        help="first-failure backoff seconds")
    parser.add_argument("--backoff-cap", type=float, default=60.0,
                        help="backoff ceiling seconds")
    parser.add_argument("--jitter", type=float, default=0.5,
                        help="backoff jitter fraction in [0, 1]")
    parser.add_argument("--shrink-after", type=int, default=2,
                        help="consecutive peer-death exits (76) before the "
                        "world shrinks")
    parser.add_argument("--shrink-factor", type=int, default=2,
                        help="world divisor per shrink step")
    parser.add_argument("--min-world", type=int, default=1,
                        help="never shrink below this world size")
    parser.add_argument("--auto-resume", action="store_true",
                        help="set $TPUDDP_AUTO_RESUME=1 on the FIRST attempt "
                        "too (restarts always resume)")
    parser.add_argument("--flight-dir", default=None, metavar="DIR",
                        help="summarize flightrec_<reason>.json crash recordings "
                        "from DIR (usually the run's out_dir) before each restart")
    parser.add_argument("--first-env", action="append", default=[],
                        metavar="KEY=VAL",
                        help="env applied to attempt 0 only (repeatable; "
                        "e.g. --first-env TPUDDP_FAULT=preempt@epoch=1)")
    return parser


def parse_args(argv=None):
    """``(options, command)``: the options before ``--``, the command after
    it (``tools/supervise.py``'s rule: both are required)."""
    parser = build_parser()
    if argv is None:
        argv = sys.argv[1:]
    if "--" not in argv:
        parser.error("separate the supervised command with '--': "
                     "supervise.py [options] -- <command> [args...]")
    split = argv.index("--")
    args = parser.parse_args(argv[:split])
    command = argv[split + 1:]
    if not command:
        parser.error("no command after '--'")
    return args, command


def main(argv=None) -> int:
    args, command = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    first_env = {}
    for kv in args.first_env:
        if "=" not in kv:
            raise SystemExit(f"--first-env expects KEY=VAL, got {kv!r}")
        k, v = kv.split("=", 1)
        first_env[k] = v

    from tpuddp_torch.resilience.supervisor import RestartSupervisor, SupervisorPolicy

    policy = SupervisorPolicy(
        max_restarts=args.max_restarts,
        backoff_base=args.backoff_base,
        backoff_cap=args.backoff_cap,
        jitter=args.jitter,
        shrink_after=args.shrink_after,
        shrink_factor=args.shrink_factor,
        min_world=args.min_world,
    )
    return RestartSupervisor(
        command,
        policy=policy,
        world_size=args.world,
        model_size=args.model,
        first_attempt_env=first_env,
        auto_resume_first=args.auto_resume,
        flight_dir=args.flight_dir,
    ).run()


if __name__ == "__main__":
    sys.exit(main())
