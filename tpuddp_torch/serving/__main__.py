"""``python -m tpuddp_torch.serving`` — the counterpart of the JAX package's
serving entry point: stand an engine up from a settings file.

Reads the same YAML settings file the training entry points use; the
``serving`` block (:data:`tpuddp_torch.config.SERVING_DEFAULTS`, unknown
keys refused) configures the engine, ``out_dir`` receives ``history.jsonl``
(run_meta + serving_stats + events). The replicas' devices come from
``local.device`` (:func:`tpuddp_torch.config.device_from`): ``cuda``, the
default, gives every visible card (``num_replicas`` takes the first N), or
the cards ``local.gpu.serving_devices`` lists (``[0, 0]``: up to two
replicas on ``cuda:0``), and raises without one; ``cpu`` gives one replica
on the host.

Modes:

- ``--demo N``  — drive N synthetic requests from ``--tenants`` tenants
  in-process, wait for every result, print the SLO summary, exit 0.
- ``--decode``  — stand the TOKEN-level engine up instead
  (:mod:`tpuddp_torch.serving.decode`, configured by the ``serving.decode``
  block; the settings file must carry one). Demo traffic becomes synthetic token
  prompts; with ``--serve`` the demo prompts are submitted WITHOUT waiting,
  so a SIGTERM lands mid-decode and the drain must let every in-flight
  sequence finish streaming before exit 75.
- ``--serve S`` — serve until SIGTERM/SIGINT or S seconds (0 = forever).
  SIGTERM drains: admission closes (new submits rejected with reason
  "draining"), in-flight and queued work completes, stats flush, and the
  process exits 75 (``EXIT_PREEMPTED``) — the resilience exit-code contract,
  so schedulers requeue a drained server exactly like a drained trainer.
  Combined with ``--demo N``, the demo traffic runs FIRST and the engine
  then stays up for the serve window — the live-ops shape: populate the SLO
  windows, then scrape ``/metrics`` against a running engine (the
  ``observability.exporter`` block arms the endpoint; the bound port lands
  in ``<out_dir>/exporter.port``).

Stdout contract: the LAST line is one compact JSON object (the SLO
summary). A ``$TPUDDP_TUNE_OVERLAY`` merges its ``serving`` and ``decode``
sections over the settings file's blocks, and the request engine's header
records it under ``tuning``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from tpuddp_torch import config as config_lib
from tpuddp_torch.observability import json_sanitize
from tpuddp_torch.resilience import preemption
from tpuddp_torch.serving.engine import ServingEngine
from tpuddp_torch.serving.replica import serving_devices


def _demo_prompts(engine, n: int, tenants: int, seed: int = 0):
    """N variable-length synthetic token prompts round-robin over tenants;
    returns the streaming results in submission order (not waited)."""
    rng = np.random.RandomState(seed)
    max_prompt = min(16, engine.max_prompt_len)
    results = []
    for i in range(n):
        prompt = rng.randint(
            0, engine.vocab_size, size=int(rng.randint(1, max_prompt + 1))
        ).astype(np.int32)
        results.append(engine.submit(f"tenant{i % tenants}", prompt))
    return results


def _demo_requests(engine: ServingEngine, n: int, tenants: int, seed: int = 0):
    """N variable-size requests round-robin over synthetic tenants; returns
    (results, rows) in submission order."""
    rng = np.random.RandomState(seed)
    shape = engine.pool.sample_shape
    max_rows = max(1, min(4, engine.scheduler.max_batch_size))
    results = []
    for i in range(n):
        rows = int(rng.randint(1, max_rows + 1))
        x = rng.randn(rows, *shape).astype(np.float32)
        results.append(engine.submit(f"tenant{i % tenants}", x))
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tpuddp_torch.serving",
        description="tpuddp_torch continuous-batching inference engine",
    )
    parser.add_argument("--settings", required=True, help="YAML settings file")
    parser.add_argument(
        "--demo", type=int, default=None, metavar="N",
        help="drive N synthetic requests, print the summary, exit",
    )
    parser.add_argument(
        "--serve", type=float, default=None, metavar="S",
        help="serve until SIGTERM or S seconds (0 = forever)",
    )
    parser.add_argument(
        "--tenants", type=int, default=2, help="demo-mode tenant count",
    )
    parser.add_argument(
        "--decode", action="store_true",
        help="token-level autoregressive engine (the serving.decode block)",
    )
    args = parser.parse_args(argv)
    if args.demo is None and args.serve is None:
        parser.error("at least one of --demo N / --serve S is required")

    settings = config_lib.load_settings(args.settings)
    serving = config_lib.serving_config(settings)
    observability = config_lib.observability_config(settings)
    devices = serving_devices(config_lib.device_from(settings),
                              ((settings.get("local") or {}).get("gpu") or {}).get("serving_devices"))
    out_dir = settings.get("out_dir")
    if out_dir:
        out_dir = config_lib.prepare_out_dir(settings, args.settings)

    if args.decode:
        from tpuddp_torch.serving.decode import DecodeEngine

        decode_cfg = config_lib.decode_config(serving)
        if decode_cfg is None:
            parser.error("--decode needs a serving.decode block in the settings")
        engine = DecodeEngine.from_config(
            decode_cfg, out_dir=out_dir, devices=devices, observability=observability
        )
    else:
        engine = ServingEngine.from_config(
            serving, out_dir=out_dir, devices=devices, observability=observability
        )
    engine.start()

    if args.demo is not None:
        if args.decode:
            results = _demo_prompts(engine, args.demo, max(1, args.tenants))
        else:
            results = _demo_requests(engine, args.demo, max(1, args.tenants))
        if args.serve is None:
            for r in results:
                r.result(timeout=120)
            summary = engine.drain(reason="demo_complete")
            print(json.dumps(json_sanitize(summary), allow_nan=False))
            return 0
        # --demo + --serve: keep the warm, traffic-populated engine up for
        # the serve window (the live-ops scrape target). Decode demo traffic
        # is deliberately NOT waited on — a SIGTERM in the serve window
        # lands mid-decode, and the drain contract (in-flight sequences
        # finish streaming) is what the drain leg checks.
        if not args.decode:
            for r in results:
                r.result(timeout=120)
        print("demo traffic complete; serving", flush=True)

    # --serve: SIGTERM/SIGINT -> resilience drain contract (exit 75)
    preemption.install_preemption_handler()
    print("serving: ready", flush=True)
    deadline = time.monotonic() + args.serve if args.serve else None
    while not preemption.preemption_requested():
        if deadline is not None and time.monotonic() >= deadline:
            summary = engine.drain(reason="serve_window_elapsed")
            print(json.dumps(json_sanitize(summary), allow_nan=False))
            return 0
        time.sleep(0.05)
    summary = engine.drain(reason="sigterm_drain")
    print(json.dumps(json_sanitize(summary), allow_nan=False))
    return preemption.EXIT_PREEMPTED


if __name__ == "__main__":
    sys.exit(main())
