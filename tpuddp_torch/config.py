"""YAML settings for the port — the counterpart of ``tpuddp/config.py``.

Same settings-file schema as the JAX package (``script_path``, ``out_dir``,
``optional_args``, ``local``, ``training``), retargeted at GPUs:

- ``local.device`` is ``cuda`` (the default) or ``cpu``;
- the world size comes from ``$TPUDDP_WORLD_SIZE``, ``local.gpu.num_gpus`` or
  the reference tutorial's ``local.condor.num_gpus``, in that order;
- ``training`` merges over :data:`TRAINING_DEFAULTS` and refuses unknown keys.

The port implements the native DDP main path and the managed
(``Accelerator``) path, with ``sync_bn``, ``compute_dtype``, ``optimizer``
(:data:`OPTIMIZERS`, with ``weight_decay``, ``momentum`` and
``trust_coefficient``), ``clip_grad_norm``, ``optimizer_state_dtype``,
``gradient_accumulation_steps``, ``deferred_metrics``, ``prefetch``
(``PrefetchLoader`` threads), ``comm_hook`` (``bf16``, ``bf16_ef``,
``int8_ef``, ``topk_ef``, with ``bucket_cap_mb`` and ``topk_density``;
:mod:`tpuddp_torch.parallel.comm`), ``comm_overlap`` (the native path's
segmented-overlap step; the managed path keeps the barrier step),
``guard`` (the numerical guard, :func:`tpuddp_torch.resilience.guard.
resolve_guard`), ``pretrained_path`` (a torchvision checkpoint on disk,
:func:`tpuddp_torch.models.pretrained.pretrained_from_config`),
``pipeline`` (staged host-to-device copies,
:func:`tpuddp_torch.training.pipeline.resolve_pipeline`; ``device_augment:
false`` is refused there), ``resume``, ``auto_resume``, ``keep_last``
(checkpoints in the JAX package's layout, restored across world sizes) and
``reshard_on_mismatch`` (the cross-width reshaper of a model-sharded
file, :mod:`tpuddp_torch.training.reshard`), the managed path's ``fuse_steps`` (K queued steps per flush, one CUDA-graph replay on the card;
:func:`resolve_fuse_steps`), ``comm_topology: hierarchical`` (the native
path's three-hop exchange, :meth:`tpuddp_torch.parallel.comm.GradComm.
reduce_hierarchical`; the managed path refuses it as the JAX package's
does), the multi-host ``local.rendezvous`` block (:func:`rendezvous_from`),
``remat`` (the native path recomputes each train forward in its backward,
:mod:`tpuddp_torch.nn.remat`; the managed path accepts the key and runs
as without it, as the JAX package's does) and ``step_stats_every`` (one
``step_stats`` row of ``history.jsonl`` per N updates, both paths,
:mod:`tpuddp_torch.observability`), and the top-level ``observability``
block (the live plane: flight recorder, exporter, pod shards, tracing;
:func:`resolve_observability`), and the top-level ``parallel`` block (the
``(data, model)`` world of tensor parallelism, :func:`resolve_parallel`,
:func:`mesh_from`; ``$TPUDDP_MODEL_SIZE`` overrides its width), and the
top-level ``serving`` block with its ``decode`` sub-block (the serving
engines of :mod:`tpuddp_torch.serving`, :func:`serving_config`,
:func:`decode_config`; ``$TPUDDP_SERVING_REPLICAS`` overrides the replica
count). ``$TPUDDP_TUNE_OVERLAY`` (the fleet tuner's lever) merges its
``training``, ``serving`` and ``decode`` sections over the resolved blocks
last (:func:`apply_tune_overlay`; :func:`tuning_provenance_from_env` is the
header's ``tuning``). Every knob whose non-default value needs a part
of the JAX package that is not ported yet is refused with
``NotImplementedError`` naming its ROADMAP item (:func:`check_supported`),
never ignored. The native path's ``scan_steps`` (K batches per dispatch,
``auto`` or an integer >= 1; :func:`tpuddp_torch.training.loop.
resolve_scan_steps`) runs each chunk of K train steps and each group of K
eval batches as one CUDA-graph replay on the card, and the same steps one
after another on the CPU.
"""

from __future__ import annotations

import difflib
import os
from typing import Any, Dict, Optional

import yaml

# The JAX package's knob set and defaults (tpuddp/config.py TRAINING_DEFAULTS),
# so one settings file drives either package.
TRAINING_DEFAULTS = {
    "model": "alexnet",
    "dataset": "cifar10",
    "data_root": "./data",
    "train_batch_size": 128,  # per replica
    "test_batch_size": 100,  # per replica
    "learning_rate": 0.001,
    "num_epochs": 20,
    "checkpoint_epoch": 5,
    "image_size": 224,
    "flip": None,  # None -> on except for digits
    "compute_dtype": "float32",
    "seed": None,  # None -> fresh per run
    "mode": "shard_map",
    "sync_bn": False,
    "scan_steps": "auto",
    "clip_grad_norm": None,
    "remat": False,
    "weight_update_sharding": False,
    "comm_hook": "none",
    "bucket_cap_mb": 25,
    "comm_topology": "flat",
    "comm_overlap": "auto",
    "topk_density": 0.1,
    "optimizer": "adam",
    "weight_decay": 0.0,  # Adam: L2 added to the gradient (torch rule)
    "momentum": 0.9,
    "trust_coefficient": 0.001,
    "prefetch": True,
    "pipeline": None,
    "deferred_metrics": False,
    "fuse_steps": "auto",
    "gradient_accumulation_steps": 1,
    "optimizer_state_dtype": None,
    "pretrained_path": None,
    "num_classes": None,  # None -> derived from training.dataset
    "resume": False,
    "auto_resume": False,
    "reshard_on_mismatch": False,
    "keep_last": None,
    "snapshot": None,
    "guard": None,
    "synthetic_n": None,  # (train, test) sizes of the synthetic stand-in
    "step_stats_every": 0,
}

DATASET_NUM_CLASSES = {"cifar10": 10, "synthetic": 10, "digits": 10}

DEVICES = ("cuda", "cpu")

# training.reshard_on_mismatch reshapes a checkpoint of another (data,
# model) shape on load, as the JAX package's loader does
# (training/checkpoint.py, training/reshard.py). training.mode takes
# shard_map and auto (parallel/ddp.py), as the JAX package's does.

# local.rendezvous's keys and the variables that override them
_RENDEZVOUS_ENV = {"coordinator_address": "TPUDDP_COORDINATOR",
                   "num_processes": "TPUDDP_NUM_PROCESSES", "process_id": "TPUDDP_PROCESS_ID"}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not implemented in tpuddp_torch yet (ROADMAP.md {item})"
    )


def _merge_refusing_unknown(defaults, overrides, block: str) -> Dict[str, Any]:
    """Defaults + overrides, refusing unknown keys with a did-you-mean hint:
    a typo'd knob silently ignored would run another configuration than the
    file says."""
    unknown = set(overrides) - set(defaults)
    if unknown:
        hints = []
        for k in sorted(unknown):
            close = difflib.get_close_matches(k, defaults, n=1)
            hints.append(f"{k!r}" + (f" (did you mean {close[0]!r}?)" if close else ""))
        raise ValueError(
            f"unknown {block} key(s): {', '.join(hints)}. Known keys: "
            f"{sorted(defaults)}"
        )
    cfg = dict(defaults)
    cfg.update(overrides)
    return cfg


def resolve_fuse_steps(fuse_steps, accum: int = 1, deferred_metrics: bool = True):
    """The managed path's fuse depth as the JAX package resolves it
    (``train_accelerate.py:795-826``, ``tpuddp/accelerate.py:1381-1384,
    :1452-1460``): ``auto`` (or None) is 1 under gradient accumulation or
    without deferred metrics, else the string ``"auto"``, which the first
    ``optimizer.step()`` resolves over its batch's bytes; an explicit depth is
    that depth (at least 1). An explicit depth over 1 with accumulation is
    the JAX package's ``ValueError``."""
    if fuse_steps in (None, "auto"):
        return 1 if accum > 1 or not deferred_metrics else "auto"
    fuse = max(1, int(fuse_steps))
    if fuse > 1 and accum > 1:
        raise ValueError(
            "gradient_accumulation_steps and fuse_steps are mutually exclusive "
            "(fused scan steps each apply an update)"
        )
    return fuse


def check_weight_update_sharding(training: Dict[str, Any], model_size: int = 1) -> None:
    """``ValueError`` for the combinations with ``weight_update_sharding``
    that the JAX package refuses (``tpuddp/parallel/ddp.py:195-300``):
    ``mode: auto``, ``comm_topology: hierarchical`` and a model axis
    (``parallel.model > 1``)."""
    if not training.get("weight_update_sharding"):
        return
    if training.get("mode", "shard_map") != "shard_map":
        raise ValueError(
            "weight_update_sharding requires mode='shard_map' (the reduce-scatter/"
            "all-gather exchange is expressed over the explicit per-replica step's "
            "named axis)"
        )
    if (training.get("comm_topology") or "flat") == "hierarchical":
        raise ValueError(
            "comm_topology='hierarchical' and weight_update_sharding are mutually "
            "exclusive: the reduce-scatter/all-gather exchange already factors the "
            "reduction; pick one"
        )
    if int(model_size) > 1:
        raise ValueError(
            "parallel.model > 1 with weight_update_sharding is refused: the WUS flat "
            "layout spans the whole replicated parameter vector, which a model-sharded "
            "state no longer has"
        )


def check_comm_hook(training: Dict[str, Any]) -> None:
    """The JAX package's ``ValueError`` for an unknown ``comm_hook``, a
    ``bucket_cap_mb`` not above 0, a ``topk_density`` outside (0, 1]
    (``tpuddp/parallel/comm.py:138-175``; a null knob is its default) or a
    ``comm_overlap`` other than true, false or auto
    (``tpuddp/parallel/ddp.py:44-61``)."""
    from tpuddp_torch.parallel import comm

    comm.validate_hook(str(training.get("comm_hook") or "none"))
    comm.validate_topology(str(training.get("comm_topology") or "flat"))
    comm.normalize_overlap(training.get("comm_overlap", "auto"))
    cap = training.get("bucket_cap_mb")
    comm.validate_bucket_cap(comm.DEFAULT_BUCKET_CAP_MB if cap is None else cap)
    density = training.get("topk_density")
    comm.bucket_topk(1, comm.DEFAULT_TOPK_DENSITY if density is None else float(density))


def check_supported(training: Dict[str, Any]) -> None:
    """Raise ``NotImplementedError`` for any knob set to a value this slice
    does not implement (a ``transformer*`` model's ``compute_dtype`` other
    than float32 among them; ``ValueError`` for a malformed ``pipeline`` block, a
    malformed comm hook (:func:`check_comm_hook`), a
    ``scan_steps`` under 1, a gradient accumulation depth under 1, or one
    together with an explicit ``fuse_steps`` over 1, and for the
    combinations with ``weight_update_sharding`` that the JAX package
    refuses)."""
    check_weight_update_sharding(training)
    check_comm_hook(training)
    from tpuddp_torch.resilience.guard import resolve_guard

    resolve_guard(training.get("guard"))  # its ValueErrors, before anything runs
    from tpuddp_torch.training.loop import resolve_scan_steps
    from tpuddp_torch.training.pipeline import resolve_pipeline
    from tpuddp_torch.training.snapshot import resolve_snapshot

    resolve_pipeline(training.get("pipeline"))
    resolve_snapshot(training.get("snapshot"))
    resolve_scan_steps(training.get("scan_steps", "auto"), 1)
    accum = int(training.get("gradient_accumulation_steps") or 1)
    if accum < 1:
        raise ValueError(f"training.gradient_accumulation_steps must be >= 1, got {accum}")
    resolve_fuse_steps(
        training.get("fuse_steps", "auto"), accum, bool(training.get("deferred_metrics"))
    )
    if str(training.get("model") or "").startswith("transformer") and \
            str(training.get("compute_dtype") or "float32") != "float32":
        # the token branch has no augment to cast the activations
        raise _not_ported(f"compute_dtype={training['compute_dtype']!r} for a token model",
                          "Queue 1 item 8: bf16 compute of token models")


def training_config(settings: Dict[str, Any]) -> Dict[str, Any]:
    """Merge the settings file's ``training`` block over the defaults,
    refusing unknown keys and unported values; a ``training`` section of
    ``$TPUDDP_TUNE_OVERLAY`` merges last (:func:`apply_tune_overlay`,
    ``tpuddp/config.py:791-800``)."""
    cfg = _merge_refusing_unknown(
        TRAINING_DEFAULTS, settings.get("training") or {}, "training"
    )
    cfg, _ = apply_tune_overlay(cfg, section="training")
    check_supported(cfg)
    return cfg


def check_settings(settings: Dict[str, Any], world_size: Optional[int] = None) -> Dict[str, Any]:
    """Refuse the settings blocks outside ``training`` that this slice does
    not implement and the malformed ones: the ``parallel`` block's
    ``ValueError``s (:func:`resolve_parallel`; ``data * model`` must tile
    ``world_size``, and ``comm_topology: hierarchical`` takes no model axis,
    :func:`mesh_from`'s texts), ZeRO-1 with a model axis, and an
    ``observability`` block's ``ValueError`` texts
    (:func:`resolve_observability`). Returns the
    resolved ``parallel`` block, the one the run goes on with."""
    parallel = resolve_parallel(settings.get("parallel"))
    training = settings.get("training") or {}
    check_weight_update_sharding(training, parallel["model"])
    if world_size is not None:
        check_tiling(parallel, world_size, str(training.get("comm_topology") or "flat"))
    observability_config(settings)  # its ValueErrors, before a run
    return parallel


# The serving engines' knobs (tpuddp/config.py:145-250): the ``serving``
# block of a settings file, read by ``python -m tpuddp_torch.serving``, and
# its ``decode`` sub-block (the token engine). Same unknown-key refusal as
# every block; the defaults are the JAX package's.
SERVING_DEFAULTS = {
    "model": "toy_mlp",  # zoo name (tpuddp_torch/models)
    "num_classes": 10,
    "input_shape": [32, 32, 3],  # one sample's NHWC shape, no batch axis
    "checkpoint_dir": None,  # restore the newest intact checkpoint from here; None: seeded init
    "checkpoint_prefix": "auto",  # "ckpt" (native), "state" (managed) or "auto": the newest
    "num_replicas": "auto",  # one replica per device; "auto": every visible device
    "max_batch_size": 32,  # rows coalesce into power-of-two buckets up to this
    "max_queue_depth": 256,  # queued requests beyond this are rejected (queue_full)
    "per_tenant_quota": None,  # queued requests per tenant (tenant_quota); None: unbounded
    "batch_timeout_ms": 2.0,  # how long a loop lingers for more rows while the queue is empty
    "stats_window": 64,  # completed requests per serving_stats row
    "unhealthy_after": 3,  # K consecutive dispatch errors send a replica to probation; 0: never
    # survivability (tpuddp_torch/serving/survive.py)
    "request_ttl_s": None,  # shed requests still queued this long after submit
    "max_recoveries": 2,  # lifetime probation rejoins per replica
    "recovery_attempts": 2,  # rebuild + canary tries per probation episode
    "recovery_backoff_s": 0.1,  # base of the jittered backoff between tries
    "retry_budget": 0,  # per-tenant retries of a failed dispatch's requests; 0: off
    "seed": 0,  # seed of a fresh init (ignored with a checkpoint)
    "decode": None,  # the token engine's block (DECODE_DEFAULTS); true: all defaults
}

DECODE_DEFAULTS = {
    "model": "transformer_tiny",  # a TransformerLM (prefill and decode_step)
    "vocab_size": 256,  # the model's num_classes
    "checkpoint_dir": None,
    "checkpoint_prefix": "auto",
    "num_replicas": 1,  # "auto": every visible device
    "max_slots": 8,  # the fixed decode batch: every step is one (max_slots, 1) program
    "kv_blocks": 64,  # KV-pool blocks per replica, garbage block 0 included
    "kv_block_size": 16,  # tokens per block
    "max_seq_len": 128,  # prompt + generated tokens per sequence
    "max_new_tokens": 32,  # per-request generation cap
    "stop_token": None,  # sampled, it ends the sequence (consumed, not emitted)
    "temperature": 0.0,  # 0: greedy; > 0: softmax draws keyed by (seed, token index)
    "max_queue_depth": 256,
    "per_tenant_quota": None,
    "stats_window": 64,  # generated tokens per decode_stats row
    "request_ttl_s": None,
    "max_recoveries": 2,
    "recovery_attempts": 2,
    "recovery_backoff_s": 0.1,
    "max_failovers": 1,  # failover episodes charged to a culprit request before it fails
    "seed": 0,
}

SERVING_REPLICAS_ENV = "TPUDDP_SERVING_REPLICAS"


def serving_config(settings: Dict[str, Any]) -> Dict[str, Any]:
    """The settings file's ``serving`` block over :data:`SERVING_DEFAULTS`,
    unknown keys refused; ``$TPUDDP_SERVING_REPLICAS`` overrides
    ``num_replicas`` (``tpuddp/config.py:487-502``) and a ``serving``
    section of ``$TPUDDP_TUNE_OVERLAY`` merges last."""
    cfg = _merge_refusing_unknown(SERVING_DEFAULTS, settings.get("serving") or {}, "serving")
    env = os.environ.get(SERVING_REPLICAS_ENV)
    if env:
        cfg["num_replicas"] = int(env)
    cfg, _ = apply_tune_overlay(cfg, section="serving")
    return cfg


# The fleet tuner's knob lever (tpuddp/config.py:506-600;
# tpuddp_torch/tune/online.py): a JSON object in this env var carries
# per-section config diffs plus the provenance fields that land in the
# run_meta header's ``tuning``. It rides the drain-and-relaunch contract
# the way $TPUDDP_WORLD_SIZE does: the controller mutates the supervisor's
# env and SIGTERMs the child; the relaunch resolves its config through the
# overlay. Unset, config resolution is what it was without it.
TUNE_OVERLAY_ENV = "TPUDDP_TUNE_OVERLAY"
_TUNE_OVERLAY_SECTIONS = ("training", "serving", "decode")


def _tune_overlay() -> Optional[Dict[str, Any]]:
    """``$TPUDDP_TUNE_OVERLAY`` parsed; None when unset. A garbled overlay
    is refused: training the baseline config while the header claims a
    tuned one would spoil every A/B comparison after it."""
    raw = os.environ.get(TUNE_OVERLAY_ENV)
    if not raw:
        return None
    import json

    try:
        overlay = json.loads(raw)
    except ValueError as e:
        raise ValueError(f"${TUNE_OVERLAY_ENV} is not valid JSON: {e}")
    if not isinstance(overlay, dict):
        raise ValueError(
            f"${TUNE_OVERLAY_ENV} must be a JSON object, got {overlay!r}"
        )
    unknown = set(overlay) - set(_TUNE_OVERLAY_SECTIONS) - {
        "source", "rule", "generation"
    }
    if unknown:
        raise ValueError(
            f"unknown ${TUNE_OVERLAY_ENV} key(s) {sorted(unknown)}; expected "
            f"sections {_TUNE_OVERLAY_SECTIONS} plus source/rule/generation"
        )
    return overlay


def apply_tune_overlay(cfg: Dict[str, Any], section: str = "training") -> tuple:
    """``$TPUDDP_TUNE_OVERLAY``'s ``section`` diff merged over a resolved
    config dict: ``(config, tuning_provenance)``. With no overlay set the
    input dict itself comes back with provenance None. Knob names are
    checked against the section's defaults and the dict's own keys (the
    JAX package's refusal texts); dict-valued knobs (``pipeline``,
    ``snapshot``, ``guard``) merge one level deep."""
    overlay = _tune_overlay()
    if overlay is None:
        return cfg, None
    diff = overlay.get(section) or {}
    if not isinstance(diff, dict):
        raise ValueError(
            f"${TUNE_OVERLAY_ENV}.{section} must be an object, got {diff!r}"
        )
    merged = dict(cfg)
    if diff:
        defaults = {
            "training": TRAINING_DEFAULTS,
            "serving": SERVING_DEFAULTS,
            "decode": DECODE_DEFAULTS,
        }.get(section) or {}
        known = set(defaults) | set(cfg)
        unknown = set(diff) - known
        if unknown:
            raise ValueError(
                f"${TUNE_OVERLAY_ENV}.{section} carries unknown knob(s) "
                f"{sorted(unknown)}; known: {sorted(known)}"
            )
        for knob, value in diff.items():
            if isinstance(value, dict) and isinstance(merged.get(knob), dict):
                merged[knob] = {**merged[knob], **value}
            else:
                merged[knob] = value
    return merged, tuning_provenance_from_env(section=section)


def tuning_provenance_from_env(section: str = "training") -> Optional[dict]:
    """The run_meta header's ``tuning`` block (schema v12): the overlay
    this run's knobs came from, or None with no overlay set."""
    overlay = _tune_overlay()
    if overlay is None:
        return None
    return {
        "source": overlay.get("source") or "overlay",
        "rule": overlay.get("rule"),
        "generation": overlay.get("generation"),
        "applied": {
            sec: overlay[sec]
            for sec in _TUNE_OVERLAY_SECTIONS
            if isinstance(overlay.get(sec), dict) and overlay[sec]
        },
        "section": section,
    }


def decode_config(serving: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """A resolved ``serving`` block's ``decode`` sub-block
    (``tpuddp/config.py:252-269``): None or False give None (no token
    engine), True the defaults, a mapping the defaults with its keys,
    unknown ones refused; a ``decode`` section of ``$TPUDDP_TUNE_OVERLAY``
    merges last."""
    block = serving.get("decode")
    if block is None or block is False:
        return None
    if block is True:
        block = {}
    if not isinstance(block, dict):
        raise ValueError(f"serving.decode must be a mapping or bool, got {block!r}")
    cfg = _merge_refusing_unknown(DECODE_DEFAULTS, block, "serving.decode")
    cfg, _ = apply_tune_overlay(cfg, section="decode")
    return cfg


# 2-D mesh knobs (tpuddp/config.py:317-330): the top-level ``parallel``
# block of a settings file, how the world factors into the ("data",
# "model") grid. Same unknown-key refusal as every block.
PARALLEL_DEFAULTS = {
    "data": "auto",  # data-parallel width; "auto" -> world_size / model
    "model": 1,  # tensor-parallel width (1 = plain DDP: today's code path)
}

MODEL_SIZE_ENV = "TPUDDP_MODEL_SIZE"


def resolve_parallel(block) -> Dict[str, Any]:
    """A ``parallel`` block (None or a mapping) as the full knob dict
    (``tpuddp/config.py:333-363``). ``$TPUDDP_MODEL_SIZE`` overrides the
    model width as ``$TPUDDP_WORLD_SIZE`` overrides the world (the restart
    supervisor's lever) and resets an explicit ``data`` to ``auto``."""
    if block is None:
        cfg = dict(PARALLEL_DEFAULTS)
    elif not isinstance(block, dict):
        raise ValueError(f"parallel block must be a mapping, got {block!r}")
    else:
        cfg = _merge_refusing_unknown(PARALLEL_DEFAULTS, block, "parallel")
    env_model = os.environ.get(MODEL_SIZE_ENV)
    if env_model:
        cfg["model"] = int(env_model)
        cfg["data"] = "auto"
    model = int(cfg["model"])
    if model < 1:
        raise ValueError(f"parallel.model must be >= 1, got {cfg['model']!r}")
    cfg["model"] = model
    if cfg["data"] != "auto":
        data = int(cfg["data"])
        if data < 1:
            raise ValueError(f"parallel.data must be >= 1 or 'auto', got {cfg['data']!r}")
        cfg["data"] = data
    return cfg


def check_tiling(cfg: Dict[str, Any], world: int, comm_topology: str = "flat") -> int:
    """The data width of a resolved ``parallel`` block over ``world``
    processes, with :func:`mesh_from`'s refusals in the JAX order and
    texts (``tpuddp/config.py:366-420``)."""
    model = cfg["model"]
    if comm_topology == "hierarchical" and model > 1:
        raise ValueError(
            "parallel.model > 1 with comm_topology='hierarchical' is "
            "refused: pick the 2-D ('data', 'model') mesh OR the factored "
            "('host', 'local') data axis, not both"
        )
    data = cfg["data"]
    if data == "auto":
        if world % model:
            raise ValueError(
                f"parallel.model={model} does not tile the {world}-device "
                "world; data * model must equal the device count"
            )
        data = world // model
    if data * model != world:
        raise ValueError(
            f"parallel: data={data} x model={model} != device count {world}; "
            "the mesh must tile the world exactly (set data: auto to derive it)"
        )
    return data


def mesh_from(parallel: Dict[str, Any], world_size: int, comm_topology: str = "flat"):
    """The run's world from the resolved ``parallel`` block
    (:func:`resolve_parallel`'s; ``tpuddp/config.py:366-420``): None, the
    flat data world (today's path, the hierarchical split included), at
    ``model == 1``; else the ``(data, model)`` grid of
    :func:`tpuddp_torch.parallel.mesh2d.mesh2d`, its process groups created
    here (a collective of the default group: every rank calls it). A block
    that does not tile the world, or a model axis under ``hierarchical``,
    is the JAX package's ``ValueError``."""
    data = check_tiling(parallel, int(world_size), comm_topology)
    if parallel["model"] == 1:
        return None
    from tpuddp_torch.parallel.mesh2d import mesh2d

    return mesh2d(data, parallel["model"])


# The live telemetry plane's knobs (tpuddp/config.py:272-314): the
# ``observability`` block of a settings file, read by both entry points.
OBSERVABILITY_DEFAULTS = {
    "exporter": False,  # the /metrics /healthz /snapshot /trace endpoint
    # (observability/exporter.py)
    "exporter_host": "127.0.0.1",  # bind address (0.0.0.0 to scrape off-host)
    "exporter_port": 0,  # 0 binds ephemerally; the bound port lands in <out_dir>/exporter.port
    # and the run_meta header's observability field
    "aggregate": True,  # per-host telemetry shards through the heartbeat files, merged by
    # process 0 (observability/aggregate.py); inert on one host
    "straggler_ratio": 1.5,  # a host straggles when its window p50 exceeds ratio x the pod
    # median ...
    "straggler_windows": 3,  # ... for this many consecutive fresh windows: one straggler event
    "flight_recorder": True,  # the last N history records per kind, dumped to
    # flightrec_<reason>.json on abnormal exits (observability/flight.py)
    "flight_capacity": 64,  # ring length per record kind
    "tracing": False,  # span trees of the native loop (observability/trace.py), exported as
    # trace_train.json and served on /trace; host bracketing only
    "trace_capacity": 4096,  # completed-span ring length per process
    "advisor": False,  # the autotuning advisor's crash hook: a flight dump carries its
    # top pending recommendation (observability/advisor.py)
}


def observability_config(settings: Dict[str, Any]) -> Dict[str, Any]:
    """The settings file's ``observability`` block over
    :data:`OBSERVABILITY_DEFAULTS` (:func:`resolve_observability`)."""
    return resolve_observability(settings.get("observability"))


def resolve_observability(block) -> Dict[str, Any]:
    """An ``observability`` block (None, a bool or a mapping) as the whole
    knob dict (``tpuddp/config.py:431-463``): None or True give the
    defaults (exporter off, aggregation and the flight recorder on); False
    turns the plane off; a mapping overrides the defaults, unknown keys
    refused with a did-you-mean hint. ``exporter`` also takes ``{host,
    port}`` for the three exporter knobs."""
    if block is None or block is True:
        return dict(OBSERVABILITY_DEFAULTS)
    if block is False:
        off = dict(OBSERVABILITY_DEFAULTS)
        off.update(exporter=False, aggregate=False, flight_recorder=False)
        return off
    if not isinstance(block, dict):
        raise ValueError(f"observability block must be a mapping or bool, got {block!r}")
    block = dict(block)
    exporter = block.get("exporter")
    if isinstance(exporter, dict):
        unknown = set(exporter) - {"host", "port"}
        if unknown:
            raise ValueError(
                f"unknown observability.exporter key(s) {sorted(unknown)}; expected host, port"
            )
        if "host" in exporter:
            block.setdefault("exporter_host", exporter["host"])
        if "port" in exporter:
            block.setdefault("exporter_port", exporter["port"])
        block["exporter"] = True
    return _merge_refusing_unknown(OBSERVABILITY_DEFAULTS, block, "observability")


def rendezvous_from(settings: Dict[str, Any]) -> Dict[str, Any]:
    """The ``local.rendezvous`` block as ``run_ddp_training``'s keyword
    arguments (``tpuddp/config.py:684-740``): ``coordinator_address``
    (``host:port`` of global rank 0), ``num_processes`` (the number of
    HOSTS, each launching its share of the world) and ``process_id`` (this
    host's index). ``$TPUDDP_COORDINATOR``, ``$TPUDDP_NUM_PROCESSES`` and
    ``$TPUDDP_PROCESS_ID`` override the keys, so one settings file serves
    every host. Unknown keys, and more than one host without a coordinator
    or without a ``process_id``, are the JAX package's ``ValueError``s; the
    port has no pod auto-discovery, so a coordinator is always needed."""
    rdv = dict((settings.get("local") or {}).get("rendezvous") or {})
    for key, env in _RENDEZVOUS_ENV.items():
        if os.environ.get(env):
            rdv[key] = os.environ[env]
    out: Dict[str, Any] = {}
    if rdv.get("coordinator_address"):
        out["coordinator_address"] = str(rdv["coordinator_address"])
    if rdv.get("num_processes") is not None:
        out["num_processes"] = int(rdv["num_processes"])
    if rdv.get("process_id") is not None:
        out["process_id"] = int(rdv["process_id"])
    unknown = set(rdv) - set(_RENDEZVOUS_ENV)
    if unknown:
        raise ValueError(
            f"unknown local.rendezvous keys {sorted(unknown)}; expected coordinator_address, "
            "num_processes, process_id"
        )
    if out.get("num_processes", 1) > 1:
        if not out.get("coordinator_address"):
            raise ValueError(
                "local.rendezvous with num_processes > 1 needs a coordinator_address (host:port "
                "of process 0; set TPUDDP_COORDINATOR or the YAML key)"
            )
        if "process_id" not in out:
            raise ValueError(
                "local.rendezvous with num_processes > 1 needs a process_id (set "
                "TPUDDP_PROCESS_ID per host, or the YAML key)"
            )
        if not 0 <= out["process_id"] < out["num_processes"]:
            raise ValueError(
                f"local.rendezvous process_id={out['process_id']} is not one of the "
                f"{out['num_processes']} hosts (0 .. {out['num_processes'] - 1})"
            )
    return out


def num_classes_from(training: Dict[str, Any]) -> int:
    """Head size: explicit ``training.num_classes`` wins, else derived from
    ``training.dataset``."""
    nc = training.get("num_classes")
    if nc is not None:
        return int(nc)
    ds = str(training.get("dataset") or "cifar10")
    if ds not in DATASET_NUM_CLASSES:
        raise ValueError(
            f"cannot derive num_classes for dataset {ds!r}; set "
            "training.num_classes explicitly"
        )
    return DATASET_NUM_CLASSES[ds]


def load_settings(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        settings = yaml.safe_load(f)
    if not isinstance(settings, dict):
        raise ValueError(f"settings file {path} did not parse to a mapping")
    return settings


def prepare_out_dir(settings: Dict[str, Any], settings_file: str) -> str:
    """mkdir ``out_dir`` and copy the settings into it for provenance."""
    out_dir = settings["out_dir"]
    os.makedirs(out_dir, exist_ok=True)
    dest = os.path.join(out_dir, os.path.basename(settings_file))
    if os.path.abspath(dest) != os.path.abspath(settings_file):
        with open(dest, "w") as f:
            yaml.dump(settings, f)
    return out_dir


def world_size_from(settings: Dict[str, Any]) -> Optional[int]:
    """World size: ``$TPUDDP_WORLD_SIZE``, else ``local.gpu.num_gpus``, else
    the reference's ``local.condor.num_gpus``. None -> every visible GPU
    (one process on the CPU), on each host. Under ``local.rendezvous`` it
    is the GLOBAL world, every host's processes together, as the JAX
    package's ``local.tpu.num_chips`` is."""
    env = os.environ.get("TPUDDP_WORLD_SIZE")
    if env:
        return int(env)
    local = settings.get("local") or {}
    for block in ("gpu", "condor"):
        if "num_gpus" in (local.get(block) or {}):
            return int(local[block]["num_gpus"])
    return None


def device_from(settings: Dict[str, Any]) -> str:
    """``local.device``: ``cuda`` (the default) or ``cpu``."""
    dev = (settings.get("local") or {}).get("device") or "cuda"
    if dev not in DEVICES:
        raise ValueError(f"unsupported local.device {dev!r} (expected cuda or cpu)")
    return dev


def optional_args_from(settings: Dict[str, Any]) -> Dict[str, Any]:
    return dict(settings.get("optional_args") or {})


OPTIMIZERS = ("adam", "sgd", "sgdw", "lars", "lamb")


def optimizer_from(training: Dict[str, Any], params, leaf_index=None):
    """Build ``training.optimizer`` over ``params``, as
    ``tpuddp/config.py:743-788`` builds it, quirks included: ``momentum``
    None is 0.9, a ``trust_coefficient`` of 0 (or None) is 0.001, LAMB takes
    neither, and ``optimizer_state_dtype`` with anything but Adam is a
    ``ValueError``, as is an unknown name. ``leaf_index`` gives each
    parameter's index in the JAX package's flattened parameter tree, which
    keys the rounding of Adam's bf16 moments
    (``models.convert.jax_leaf_index``); bf16 moments require it."""
    from tpuddp_torch import optim

    name = str(training.get("optimizer") or "adam").lower()
    lr = float(training["learning_rate"])
    wd = float(training.get("weight_decay") or 0.0)
    momentum = float(training["momentum"] if training.get("momentum") is not None else 0.9)
    if name == "adam":
        return optim.Adam(
            params, lr=lr, weight_decay=wd,
            state_dtype=training.get("optimizer_state_dtype"), leaf_index=leaf_index,
        )
    if training.get("optimizer_state_dtype"):
        raise ValueError(
            "training.optimizer_state_dtype is an Adam knob (bf16 moment "
            f"storage); optimizer {name!r} stores its state in f32"
        )
    if name == "sgd":
        return optim.SGD(params, lr, momentum=momentum, weight_decay=wd)
    if name == "sgdw":
        return optim.SGDW(params, lr, momentum=momentum, weight_decay=wd)
    if name == "lars":
        return optim.LARS(
            params, lr, momentum=momentum, weight_decay=wd,
            trust_coefficient=float(training.get("trust_coefficient") or 0.001),
        )
    if name == "lamb":
        return optim.LAMB(params, lr, weight_decay=wd)
    raise ValueError(f"unknown training.optimizer {name!r}; one of {OPTIMIZERS}")
