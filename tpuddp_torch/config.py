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
false`` is refused there), ``resume``, ``auto_resume`` and ``keep_last``
(checkpoints in the JAX package's layout) and the managed path's
``fuse_steps`` (K queued steps per flush, one CUDA-graph replay on the card;
:func:`resolve_fuse_steps`), ``comm_topology: hierarchical`` (the native
path's three-hop exchange, :meth:`tpuddp_torch.parallel.comm.GradComm.
reduce_hierarchical`; the managed path refuses it as the JAX package's
does) and the multi-host ``local.rendezvous`` block (:func:`rendezvous_from`). Every knob whose non-default value needs a part
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

# knob -> (is the value one the port implements?, ROADMAP.md item)
_UNSUPPORTED = {
    "reshard_on_mismatch": (lambda v: not v, "Queue 1 item 8: elastic reshard"),
    "mode": (lambda v: v == "shard_map", "Queue 1 item 8: mode auto"),
    "remat": (lambda v: not v, "Queue 1 item 8: remat"),
    "snapshot": (lambda v: not v, "Queue 1 item 8: step snapshots"),
    "step_stats_every": (lambda v: not v, "Queue 1 item 8: observability"),
}

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
    does not implement (``ValueError`` for a malformed ``pipeline`` block, a
    malformed comm hook (:func:`check_comm_hook`), a
    ``scan_steps`` under 1, a gradient accumulation depth under 1, or one
    together with an explicit ``fuse_steps`` over 1, and for the
    combinations with ``weight_update_sharding`` that the JAX package
    refuses)."""
    check_weight_update_sharding(training)
    check_comm_hook(training)
    from tpuddp_torch.resilience.guard import resolve_guard

    resolve_guard(training.get("guard"))  # its ValueErrors, before anything runs
    for knob, (ok, item) in _UNSUPPORTED.items():
        value = training.get(knob, TRAINING_DEFAULTS[knob])
        if not ok(value):
            raise _not_ported(f"training.{knob}={value!r}", item)
    from tpuddp_torch.training.loop import resolve_scan_steps
    from tpuddp_torch.training.pipeline import resolve_pipeline

    resolve_pipeline(training.get("pipeline"))
    resolve_scan_steps(training.get("scan_steps", "auto"), 1)
    accum = int(training.get("gradient_accumulation_steps") or 1)
    if accum < 1:
        raise ValueError(f"training.gradient_accumulation_steps must be >= 1, got {accum}")
    resolve_fuse_steps(
        training.get("fuse_steps", "auto"), accum, bool(training.get("deferred_metrics"))
    )


def training_config(settings: Dict[str, Any]) -> Dict[str, Any]:
    """Merge the settings file's ``training`` block over the defaults,
    refusing unknown keys and unported values."""
    if os.environ.get("TPUDDP_TUNE_OVERLAY"):
        raise _not_ported("$TPUDDP_TUNE_OVERLAY", "Queue 1 item 8: fleet and tune")
    cfg = _merge_refusing_unknown(
        TRAINING_DEFAULTS, settings.get("training") or {}, "training"
    )
    check_supported(cfg)
    return cfg


def check_settings(settings: Dict[str, Any], world_size: Optional[int] = None) -> None:
    """Refuse the settings blocks outside ``training`` that this slice does
    not implement: a tensor-parallel ``parallel`` block and an
    ``observability`` block. An explicit ``parallel.data`` must equal
    ``world_size`` (the hosts of a ``local.rendezvous`` block tile it, as
    :func:`tpuddp_torch.parallel.spawn.resolve_world` checks)."""
    parallel = settings.get("parallel") or {}
    unknown = set(parallel) - {"data", "model"}
    if unknown:
        raise ValueError(f"unknown parallel key(s) {sorted(unknown)}")
    check_weight_update_sharding(settings.get("training") or {}, int(parallel.get("model", 1)))
    if int(parallel.get("model", 1)) != 1:
        raise _not_ported(
            f"parallel.model={parallel['model']!r}", "Queue 1 item 8: tensor parallel"
        )
    data = parallel.get("data", "auto")
    if data != "auto" and world_size is not None and int(data) != world_size:
        raise ValueError(
            f"parallel.data={data!r} != world size {world_size}; the data axis "
            "must tile the world exactly (set data: auto to derive it)"
        )
    if settings.get("observability") is not None:
        raise _not_ported("the observability block", "Queue 1 item 8: observability")


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
