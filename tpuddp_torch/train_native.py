"""Explicit (native) DDP training entry point of the port — the counterpart of
``train_native.py`` and of the reference's ``multi-GPU-training-torch.py``.

    python -m tpuddp_torch.train_native --settings_file F

One process per GPU (``local.gpu.num_gpus``, ``local.condor.num_gpus`` or
``$TPUDDP_WORLD_SIZE``), NCCL between them; ``local.device: cpu`` runs the
same path on the CPU with Gloo. Under ``prefetch: true`` (the default) both
loaders are wrapped in ``PrefetchLoader(workers=pipeline.host_workers)``, as
``train_native.py:80-90`` does; ``training.resume`` or ``auto_resume``
continues from the newest intact checkpoint in ``out_dir``. ``scan_steps``
(``auto`` by default) sets the batches of one dispatch: on a GPU each chunk
of K steps is one CUDA-graph replay, on the CPU the same steps run one
after another (``training/loop.py``). ``weight_update_sharding: true``
shards the optimizer's update and state across the processes (ZeRO-1,
``parallel/ddp.py``); ``comm_hook`` compresses the gradient exchange, with
an error-feedback residual for the ``_ef`` hooks (``parallel/comm.py``);
``guard`` turns on the numerical guard (a non-finite update skipped as a
bitwise no-op, the replicas audited, rollback to the last good checkpoint:
``resilience/guard.py``, ``training/loop.py``); a divergent replica exits
77. ``pretrained_path`` fine-tunes from a torchvision checkpoint on disk
(``models/pretrained.py``; nothing is downloaded). ``comm_topology:
hierarchical`` exchanges the gradient in three hops, within each host and
then between the hosts (``parallel/comm.py``). ``mode: auto`` trains the
global batch's step (its loss mean, BatchNorm statistics, flip and dropout
masks; ``parallel/ddp.py``) where ``shard_map``, the default, averages the
replicas' own steps. ``remat: true`` recomputes
each train forward in its backward (``nn/remat.py``), bitwise the plain
run. Process 0 writes ``out_dir/history.jsonl``: a ``run_meta`` header,
one ``epoch`` row per epoch (with the step-time percentiles and MFU),
``step_stats`` rows every ``step_stats_every`` updates and event rows;
``$TPUDDP_PROFILE``, ``$TPUDDP_PROFILE_STEPS`` and SIGUSR1 write
``torch.profiler`` traces (``observability/``). The settings file's
``observability`` block sets the live plane: the flight recorder (on by
default: ``flightrec_<reason>.json`` on a drain, a watchdog exit, a desync
or an exception), the ``/metrics`` exporter (``out_dir/exporter.port``),
the hosts' telemetry shards and the straggler detector, and the span trees
(``tracing: true``: ``out_dir/trace_train.json``). The top-level
``parallel`` block (``model: M``, or ``$TPUDDP_MODEL_SIZE``) trains a
transformer tensor-parallel over a ``(data, model)`` world of processes
(``parallel/tensor.py``): ``rank = data_index * M + model_index``, the
loaders split over the data indices only.

Across hosts, one settings file with a ``local.rendezvous`` block
(``coordinator_address``, ``num_processes`` = the hosts) serves every host;
each host runs the same command with its ``$TPUDDP_PROCESS_ID`` and starts
its share of the world (``local.gpu.num_gpus`` is the global world).
Two hosts on one machine with one GPU each share it over Gloo::

    TPUDDP_BACKEND=gloo TPUDDP_PROCESS_ID=0 python -m tpuddp_torch.train_native --settings_file F &
    TPUDDP_BACKEND=gloo TPUDDP_PROCESS_ID=1 python -m tpuddp_torch.train_native --settings_file F
"""

from __future__ import annotations

import argparse
import logging
from functools import partial
from typing import Callable, Optional

import torch

from tpuddp_torch import config as cfg_lib
from tpuddp_torch import seeding
from tpuddp_torch.data import (
    PrefetchLoader, ShardedDataLoader, compute_dtype_for, flip_for, load_datasets_for,
    norm_stats_for,
)
from tpuddp_torch.data.transforms import make_eval_transform, make_train_augment
from tpuddp_torch.models import load_model
from tpuddp_torch.models.convert import jax_leaf_index
from tpuddp_torch.models.pretrained import pretrained_from_config
from tpuddp_torch.nn import CrossEntropyLoss
from tpuddp_torch.nn.norm import convert_sync_batchnorm
from tpuddp_torch.observability import config_hash
from tpuddp_torch.parallel import comm
from tpuddp_torch.parallel.ddp import DistributedDataParallel
from tpuddp_torch.parallel.spawn import resolve_world, run_ddp_training
from tpuddp_torch.training.loop import run_training_loop
from tpuddp_torch.training.pipeline import resolve_pipeline


def set_numerics() -> None:
    """Full float32 where the work is float32: matrix products and cuDNN
    convolutions both off TF32 (cuDNN's default is on). Under
    ``compute_dtype: bfloat16`` the convolutions and products take bfloat16
    inputs and TF32 does not apply. And cuDNN's deterministic algorithms
    only, so that a run repeats bit for bit, as the JAX package's does: with
    cuDNN's default choice two identical native toy_cnn runs on an H100
    parted after 2 steps, and a CUDA-graph replay could not be held bitwise
    against its eager steps. Printed so a run's log states both."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    print(
        f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}"
    )
    print(f"torch.backends.cudnn.deterministic={torch.backends.cudnn.deterministic}")


def load_model_for(training: dict, input_shape) -> torch.nn.Module:
    """``training.model`` on the CPU: fresh, or, with ``pretrained_path``,
    the checkpoint on disk with its head swapped for the dataset's classes
    (the reference's pretrained-AlexNet workflow), as both JAX entry points
    load it (``train_native.py:112-122``, ``train_accelerate.py:949-962``).
    Every rank draws the same head (its generator is seeded from
    ``training.seed``)."""
    if not training.get("pretrained_path"):
        return load_model(training["model"], cfg_lib.num_classes_from(training),
                          input_shape=input_shape)
    model = pretrained_from_config(training)
    print(f"Loaded pretrained {training['model']} weights from {training['pretrained_path']}.")
    return model


def is_token_model(training: dict) -> bool:
    """A ``transformer*`` model: int token sequences in, no image augment
    (``train_native.py:98-103``)."""
    return str(training.get("model") or "").startswith("transformer")


def model_input_for(training: dict, train_loader):
    """One train batch as the model takes it (after the augment):
    ``(shape, dtype)``, what the telemetry counts one update's FLOPs on; a
    token model's ``(rows, seq_len)`` int32 tokens."""
    if is_token_model(training):
        return (int(train_loader.batch_size), int(train_loader.seq_len)), torch.int32
    in_hw = training.get("image_size") or train_loader.dataset.images.shape[1]
    return (int(training["train_batch_size"]), in_hw, in_hw, 3), compute_dtype_for(training)


def build_training(rank: int, world_size: int, training: dict, device: str = "cuda",
                   loaders: Optional[Callable] = None, parallel: Optional[dict] = None):
    """Everything a rank trains with: seeds, loaders, transforms, model,
    optimizer and the DDP wrap. Returns ``(ddp, train_loader, test_loader,
    base_seed)``. ``loaders(rank, world_size)``, when given, makes the
    ``(train, test)`` loaders in place of ``training.dataset``'s (a token
    model's stream: :func:`tpuddp_torch.data.tokens.token_loaders`).
    ``parallel`` is the resolved ``parallel`` block
    (:func:`~tpuddp_torch.config.resolve_parallel`'s; None: its defaults,
    ``$TPUDDP_MODEL_SIZE`` applied): at ``model > 1`` the ranks
    form the ``(data, model)`` world (``config.mesh_from``, a collective),
    the loaders take ``(data_index, data_size)`` in place of ``(rank,
    world_size)`` (model-axis neighbours get the same rows) and the wrap is
    tensor-parallel."""
    cfg_lib.check_supported(training)
    if parallel is None:
        parallel = cfg_lib.resolve_parallel(None)
    mesh = cfg_lib.mesh_from(parallel, world_size, str(training.get("comm_topology") or "flat"))
    # the loaders' replica: the data index of the (data, model) world
    replica, replicas = (rank, world_size) if mesh is None else (mesh.data_index, mesh.data)
    set_numerics()
    # the GPU the process group pinned (the local rank's, rank on one host)
    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else torch.device("cpu")

    # mode auto draws one flip mask and one dropout mask per step for the
    # global batch, each rank keeping its rows: every rank's streams alike
    mode = training.get("mode") or "shard_map"
    generator, base_seed = seeding.set_seed_based_on_rank(
        0 if mode == "auto" else rank, training.get("seed"))

    if loaders is not None:
        train_loader, test_loader = loaders(replica, replicas)
    else:
        train_ds, test_ds = load_datasets_for(training)
        # the data order is shared across ranks and independent of the model seed
        train_loader = ShardedDataLoader(
            train_ds, training["train_batch_size"], replica, replicas, shuffle=True
        )
        test_loader = ShardedDataLoader(
            test_ds, training["test_batch_size"], replica, replicas, shuffle=True
        )
    input_shape = model_input_for(training, train_loader)[0][1:]
    pipeline = resolve_pipeline(training.get("pipeline"))
    if training.get("prefetch", True) and pipeline.host_workers > 0:
        # host batch assembly overlaps the device's work (the reference's
        # num_workers); workers > 1 share out the loaders' batch plans
        train_loader = PrefetchLoader(train_loader, workers=pipeline.host_workers)
        test_loader = PrefetchLoader(test_loader, workers=pipeline.host_workers)

    if is_token_model(training):
        # token models take int sequences: the image augment and
        # normalisation do not apply (train_native.py:98-103)
        augment = eval_transform = None
    else:
        size = training.get("image_size")
        mean, std = norm_stats_for(training)
        cdtype = compute_dtype_for(training)
        augment = make_train_augment(
            size=size, flip=flip_for(training), mean=mean, std=std, generator=generator,
            compute_dtype=cdtype,
        )
        eval_transform = make_eval_transform(size=size, mean=mean, std=std, compute_dtype=cdtype)

    model = load_model_for(training, input_shape).to(dev)
    if training.get("sync_bn"):
        convert_sync_batchnorm(model)
    leaf = jax_leaf_index(training["model"], model)
    optimizer = cfg_lib.optimizer_from(
        training, model.parameters(), leaf_index=[leaf[n] for n, _ in model.named_parameters()]
    )
    ddp = DistributedDataParallel(
        model, optimizer, CrossEntropyLoss(), augment=augment,
        eval_transform=eval_transform, device=dev,
        grad_accumulation=int(training.get("gradient_accumulation_steps") or 1),
        generator=generator, clip_grad_norm=training.get("clip_grad_norm"),
        # reduce-scatter + the update of this rank's shard + all-gather
        # (ZeRO-1) in place of the all-reduce and the replicated update
        weight_update_sharding=bool(training.get("weight_update_sharding")),
        # the gradient comm hook (bf16, bf16_ef, int8_ef, topk_ef) and its
        # bucket cap and top-k density; null knobs are their defaults
        comm_hook=str(training.get("comm_hook") or "none"),
        bucket_cap_mb=float(training.get("bucket_cap_mb") or comm.DEFAULT_BUCKET_CAP_MB),
        topk_density=float(training.get("topk_density") or comm.DEFAULT_TOPK_DENSITY),
        # each backward segment's exchange issued as its gradients land
        comm_overlap=training.get("comm_overlap", "auto"),
        # the numerical guard: non-finite updates skipped, replicas audited
        guard=training.get("guard"),
        # flat, or the three-hop exchange over hosts x local processes
        comm_topology=str(training.get("comm_topology") or "flat"),
        # the forward recomputed in the backward (train_native.py:149)
        remat=bool(training.get("remat", False)),
        # shard_map (the per-replica step) or auto (the global batch's step)
        mode=mode,
        # the (data, model) world of tensor parallelism (None: the flat one)
        mesh=mesh,
    )
    if ddp.hierarchy is not None:
        hosts, local = ddp.hierarchy
        print(f"comm_topology hierarchical on process {rank}: {hosts} hosts x {local} local "
              f"({world_size}-process world).")
    return ddp, train_loader, test_loader, base_seed


def basic_ddp_training_loop(
    rank: int,
    world_size: int,
    save_dir: Optional[str],
    optional_args: dict,
    training: Optional[dict] = None,
    device: str = "cuda",
    observability: Optional[dict] = None,
    loaders: Optional[Callable] = None,
    parallel: Optional[dict] = None,
):
    """Per-process worker (reference ``basic_DDP_training_loop``,
    multi-GPU-training-torch.py:228-266); the process group is already up.
    ``observability`` is the settings file's resolved block (the live
    plane; None: its defaults); ``loaders`` and ``parallel`` as
    :func:`build_training` takes them. Returns the epoch history.

    A token job runs as the JAX package runs one (``tools/bench_mesh.py:
    108-135``): ``run_ddp_training`` -> this worker with a ``transformer*``
    model, ``num_classes`` its vocabulary and ``loaders`` a
    :func:`~tpuddp_torch.data.tokens.token_loaders` partial."""
    unit = "GPU" if device == "cuda" else "process"
    print(f"Running DDP training on process {rank} ({world_size}-{unit} world).")
    # a worker handed a resolved training dict picks up $TPUDDP_TUNE_OVERLAY
    # here too (train_native.py:54-57); over training_config's result the
    # merge is idempotent
    training, _ = cfg_lib.apply_tune_overlay(dict(training or cfg_lib.TRAINING_DEFAULTS))
    ddp, train_loader, test_loader, base_seed = build_training(
        rank, world_size, training, device, loaders, parallel
    )
    return run_training_loop(
        ddp,
        train_loader,
        test_loader,
        save_dir,
        num_epochs=training["num_epochs"],
        checkpoint_epoch=training["checkpoint_epoch"],
        set_epoch=optional_args.get("set_epoch", True),
        print_rand=optional_args.get("print_rand", False),
        # shard-disjointness probe (reference :112-115) of the image loaders
        data_probe_every=None if loaders is not None else 100,
        per_replica_log=True,  # reference's per-replica loss lines (:186-191)
        base_seed=base_seed,
        auto_resume=bool(training.get("auto_resume") or training.get("resume")),
        keep_last=int(training["keep_last"]) if training.get("keep_last") else None,
        pipeline=training.get("pipeline"),
        scan_steps=training.get("scan_steps", "auto"),
        # one step_stats row per N updates (0: none)
        step_stats_every=int(training.get("step_stats_every") or 0),
        # the run_meta header's provenance (train_native.py:217-221)
        run_meta={
            "config_hash": config_hash(training),
            "model": training.get("model"),
            "dataset": training.get("dataset"),
        },
        model_input=model_input_for(training, train_loader),
        # step snapshots and the exact mid-epoch resume (training/snapshot.py)
        snapshot=training.get("snapshot"),
        # the live plane (train_native.py:213, :252): flight recorder,
        # exporter, pod shards, tracing
        observability=observability,
        # a checkpoint of another (data, model) shape reshaped on load
        reshard_on_mismatch=bool(training.get("reshard_on_mismatch")),
    )


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="tpuddp_torch explicit DDP training (ShardedDataLoader + "
        "DistributedDataParallel over NCCL, Gloo on the CPU).",
    )
    parser.add_argument(
        "--settings_file", type=str, required=True,
        help="YAML settings: out_dir, local.{device,gpu}, optional_args, training.",
    )
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    settings = cfg_lib.load_settings(args.settings_file)
    device = cfg_lib.device_from(settings)
    rendezvous = cfg_lib.rendezvous_from(settings)
    world_size, _ = resolve_world(cfg_lib.world_size_from(settings), device, **rendezvous)
    parallel = cfg_lib.check_settings(settings, world_size)
    training = cfg_lib.training_config(settings)
    out_dir = cfg_lib.prepare_out_dir(settings, args.settings_file)
    return run_ddp_training(
        partial(basic_ddp_training_loop, training=training, device=device,
                observability=cfg_lib.observability_config(settings), parallel=parallel),
        world_size,
        out_dir,
        cfg_lib.optional_args_from(settings),
        backend=device,
        **rendezvous,
    )


if __name__ == "__main__":
    main()
