"""DistributedDataParallel — the counterpart of ``tpuddp/parallel/ddp.py``
for the native path.

It does not use ``torch.nn.parallel.DistributedDataParallel``: like the JAX
package, which computes its own ``pmean``, it makes one explicit all-reduce
per step, which is what the parity tests pin:

- at wrap time, parameters and buffers are broadcast from rank 0
  (``tpuddp/parallel/ddp.py:443``), so every replica starts identical;
- after every train forward, the model's buffers (BatchNorm running
  statistics) are broadcast from rank 0, as the JAX step does with its
  ``sync_buffers="broadcast"`` default (``tpuddp/training/step.py:216-223``).
  torch DDP broadcasts before the forward instead, which leaves other
  buffers at epoch end;
- after backward, all gradients go into one flat buffer, one all-reduce SUM,
  then a division by the world size. Each replica's gradient is the gradient
  of its own weighted-mean loss, so the result is the MEAN OF PER-REPLICA
  WEIGHTED-MEAN GRADIENTS, as ``pmean`` gives it
  (``tpuddp/training/step.py:197-225``) — not a global weighted mean, which
  differs when padded tails give replicas different real-row counts.

``clip_grad_norm`` clips the averaged gradient to that global L2 norm
before each update, on every replica alike (``tpuddp/training/step.py:
406-413``); under accumulation once per cycle, after its division.

``step`` counts the micro-batches trained, as the JAX ``TrainState.step``
does (1 per step, A per cycle, padding micro-batches included); checkpoints
carry it as ``.step``.

``grad_accumulation=A > 1`` makes one update per A micro-batches
(:meth:`DistributedDataParallel.train_cycle`, ``tpuddp/parallel/ddp.py:100-106``):
each replica's gradient is the n-weighted mean over its cycle, and the
all-reduce runs once, at the cycle boundary. The per-batch
:meth:`~DistributedDataParallel.train_step` is refused then: a full-scale
update per micro-batch would be an A-fold learning rate.

The wrap runs on ``cuda`` unless ``device`` asks for the CPU; without a
visible GPU it raises. Batches may arrive already on the device (the epoch
loop stages them, ``training/pipeline.py``); a host batch is staged here
the same way, from pinned memory with ``non_blocking=True``. ``generator`` is
the rank's host random stream (the flip masks), which checkpoints save and
restore.

A one-process world skips the collectives: a sum over one replica divided by
one is the identity, and so is a broadcast.

``scan_steps`` (:meth:`~DistributedDataParallel.train_step_many`,
:meth:`~DistributedDataParallel.eval_step_many`, ``tpuddp/parallel/ddp.py:
812-905``): K steps (K / A cycles) or K eval batches as one dispatch. The
chunk's K flip masks are drawn on the host from the augment's generator, in
step order, before the dispatch; ``step`` advances by K. On a GPU each
chunk is one group of the CUDA-graph engine (``training/graphs.py``):
eager at its signature's first chunk, captured at the second, replayed
after; a failed capture raises. On the CPU the chunk's steps run one after
another, so a chunked epoch is bitwise the per-batch one.

``weight_update_sharding`` (ZeRO-1; ``tpuddp/parallel/ddp.py:472-480``,
``tpuddp/training/step.py:291-366``): after the broadcast, the optimizer is
wrapped in :class:`~tpuddp_torch.optim.ShardedUpdate` over the flat layout
of :func:`~tpuddp_torch.training.step.make_flat_param_spec`: the
parameters become views into one flat vector, each rank keeps the
optimizer state of its shard only, and each update reduce-scatters the
flattened gradient, divides it by the world size, clips the shard (the
clip's norm summed across replicas), updates it and all-gathers the
shards. The wrap then makes no gradient all-reduce of its own. It holds for
``train_step``, ``train_cycle`` and ``train_step_many`` alike; the flat
buffers exist before the first capture.

``comm_hook`` (``bf16``, ``bf16_ef``, ``int8_ef``, ``topk_ef``;
``tpuddp/parallel/ddp.py:86-91, :242-247, :493-534``), with
``bucket_cap_mb`` and ``topk_density``: the gradient sync becomes the
bucketed compressed exchange of :mod:`tpuddp_torch.parallel.comm`, over
the gradient in the JAX package's flat order, so that the buckets and the
residual are the JAX package's (:func:`~tpuddp_torch.training.step.
comm_sync`); under ZeRO-1, the hooked reduce-scatter of the wrapped
optimizer, in the port's flat order. It runs at world 1 too: only the
collective is skipped, the compression and the error-feedback residual
(``residual``, this replica's ``(total,)`` float32 vector, allocated here
and updated in place, so a CUDA graph holds it) are not.
``grad_comm_bytes_per_step`` and ``grad_comm_bytes_per_step_f32`` count
one reduction's wire bytes with the hook and without it.

``comm_overlap`` (``true``, ``false`` or ``auto``, the default;
``tpuddp/parallel/ddp.py:44-61, :623-721``): the segmented-overlap step.
At wrap time :meth:`~DistributedDataParallel._resolve_overlap` walks the
JAX package's eligibility order (mode ``shard_map``, flat topology, no
ZeRO-1, no remat, no tensor parallel, a model whose JAX counterpart is a
``Sequential``: not a transformer, whose JAX tree is a dict) and cuts the
JAX package's bucket plan (for every hook, ``none`` included) into
backward segments at the children of that
``Sequential``; ``auto`` keeps the barrier step where it does not apply or
gives one segment, with the JAX package's reason, and ``true`` raises its
``ValueError`` there. Where it applies, every step, cycle and chunk runs
the exchange as :class:`~tpuddp_torch.training.step.SegmentedSync`: each
segment's exchange issued as its gradients land in backward, on a side
stream of the card, bitwise the barrier step. ``comm_overlap_meta`` records
``{"enabled", "segments", "reason"}`` as the JAX wrap does.

``remat`` (``training.remat``; ``tpuddp/parallel/ddp.py:83, :240``):
every step, cycle and chunk recomputes its forward in the backward
(:mod:`tpuddp_torch.nn.remat`), bitwise the plain step; the
segmented-overlap step does not apply (``auto`` records the JAX reason,
``true`` raises).

``guard`` (``training.guard``; ``tpuddp/parallel/ddp.py:90, :560-580,
:723-740``): the numerical guard. At wrap time, after the broadcast, every
replica's parameters are audited (:meth:`audit_replicas`,
``ReplicaDesync`` on a divergence; the loop's periodic audit too). Every step, cycle and
chunk is then guarded by the wrap's :class:`~tpuddp_torch.resilience.guard.
Firewall` (``training/step.py``): a non-finite aggregated gradient makes the
update a bitwise no-op on the parameters, the optimizer state, the hook's
residual and the BatchNorm buffers, counted on the device;
:meth:`~DistributedDataParallel.skip_counters` reads the counters. The
guard does not change how ``comm_overlap`` resolves.

``comm_topology`` (``flat``, the default, or ``hierarchical``;
``tpuddp/parallel/ddp.py:135-219, :485-530``): under ``hierarchical`` the
replicas split into ``hosts x local`` (:func:`~tpuddp_torch.parallel.mesh.
hierarchical_groups`: the rendezvous's host count, else a simulated 2),
and every step, cycle and chunk exchanges the gradient in three hops
(:meth:`~tpuddp_torch.parallel.comm.GradComm.reduce_hierarchical`): a
float32 reduce-scatter over the host's own ranks, the shard through the
hook between the hosts, an all-gather back, in the JAX flat order, with a
plan for hook ``none`` too. It is refused, with the JAX package's
``ValueError``s and in its order, with ZeRO-1 and where the host count
does not tile the world; the segmented-overlap step does not apply (``auto``
records the JAX reason, ``true`` raises). ``grad_comm_bytes_intra_host``
and ``grad_comm_bytes_inter_host`` split one reduction's bytes by link
(:func:`~tpuddp_torch.parallel.comm.comm_bytes_breakdown`; under ``flat``
all of them are inter-host).

``mode="auto"`` (the JAX package's XLA-placed step,
``tpuddp/training/step.py:814-826``) trains the global batch's step
instead: every BatchNorm syncs its statistics, one flip mask and one
dropout mask are drawn for the global batch (every replica's streams
seeded alike) and each replica keeps its rows, each replica's loss is
scaled by its share ``n_r / sum(n)`` of the real rows and the gradients
are summed (:meth:`DistributedDataParallel.sync_global`): the global
batch's weighted-mean gradient, the managed path's rule. The guard judges
that float32 sum; a hook rounds it locally with one replicated ``(total,)``
residual and no collective of its own, and the byte counters count the
float32 collective (``wire=False``). ZeRO-1 and ``comm_topology:
hierarchical`` are the JAX ``ValueError``; ``comm_overlap: auto`` falls
back with the JAX reason.

``mesh`` (a :class:`~tpuddp_torch.parallel.mesh2d.Mesh2D` from
``config.mesh_from``; ``tpuddp/parallel/ddp.py:181-195, :263-440``): at
``model > 1`` the wrap trains tensor-parallel. After the broadcast of the
whole model from rank 0, ``model`` becomes this rank's shard
(:class:`~tpuddp_torch.parallel.tensor.TensorParallelLM`, the Megatron
split of the transformer), the optimizer is rebound to the shard's
parameters (its state built over them at the first step: the Adam kernel
updates the local shards), the gradient mean and the comm hook's exchange
run over the rank's DATA group only, with the plan and the byte counts over
the local shard's leaves in the JAX TP layout's order and one residual per
rank (keyed ``(data_index, model_index)``), the guard's verdict is agreed
with one all-reduce MIN over the MODEL group, the desync audit compares
each rank's own shard across data replicas only, and the segmented-overlap
step records the JAX reason. Every combination the JAX TP wrap refuses is
its ``ValueError``, in its order (:meth:`DistributedDataParallel.
_validate_tp`), more than one host among them. ``model == 1`` (or no
``mesh``) is the unchanged code path. Metrics are per data replica: the
loop sums them over the data group (:attr:`metrics_group`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from tpuddp_torch.models.convert import (
    JaxFlatOrder, is_transformer, jax_from_state_dict, jax_layer_sizes, jax_order_indices,
    jax_param_span, jax_sizes, model_name, tree_leaves,
)
from tpuddp_torch.nn.layers import global_batch_dropout
from tpuddp_torch.nn.norm import convert_sync_batchnorm
from tpuddp_torch.optim import ShardedUpdate, arm_guard
from tpuddp_torch.parallel import backend, collectives, comm, mesh
from tpuddp_torch.parallel import mesh2d as mesh2d_lib
from tpuddp_torch.parallel import tensor as tp_lib
from tpuddp_torch.resilience import guard as guard_lib
from tpuddp_torch.resilience.guard import Firewall, ReplicaDesync, resolve_guard
from tpuddp_torch.training import graphs
from tpuddp_torch.training.pipeline import stage_batch, to_device
from tpuddp_torch.training.step import (
    EVAL_KEYS, TRAIN_KEYS, SegmentedSync, comm_sync, eval_core, eval_many, global_share,
    make_flat_param_spec, train_core, train_cycle, train_many,
)


def _no_sync() -> None:
    pass


class DistributedDataParallel:
    # False: on a GPU the K-step chunks and eval groups run eagerly, the
    # reference that chip_smoke.py and the cuda tests hold the replays
    # against. A tensor-parallel wrap runs them eagerly whatever it says
    # (:meth:`_group`)
    _graph_replay = True

    def __init__(
        self,
        model: torch.nn.Module,
        optimizer: torch.optim.Optimizer,
        criterion: Callable,
        augment: Optional[Callable] = None,
        eval_transform: Optional[Callable] = None,
        device: Optional[torch.device] = None,
        grad_accumulation: int = 1,
        generator: Optional[torch.Generator] = None,
        clip_grad_norm: Optional[float] = None,
        weight_update_sharding: bool = False,
        comm_hook: str = "none",
        bucket_cap_mb: float = comm.DEFAULT_BUCKET_CAP_MB,
        topk_density: float = comm.DEFAULT_TOPK_DENSITY,
        comm_overlap="auto",
        guard=None,
        comm_topology: str = "flat",
        remat: bool = False,
        mode: str = "shard_map",
        mesh: Optional[mesh2d_lib.Mesh2D] = None,
    ):
        if mode not in ("shard_map", "auto"):
            raise ValueError(f"unknown mode {mode!r}; one of 'shard_map', 'auto'")
        self.mode = mode
        # the (data, model) world: model == 1 squeezes to the flat data
        # world, today's code path; model > 1 is the tensor-parallel wrap
        self.model_size = mesh2d_lib.model_size(mesh)
        self.mesh = mesh if self.model_size > 1 else mesh2d_lib.squeeze_model(mesh)
        if self.model_size > 1:
            self._validate_tp(model, optimizer, mode, comm_topology, weight_update_sharding,
                              grad_accumulation, clip_grad_norm, augment, eval_transform, remat)
        self.guard = resolve_guard(guard)
        # the whole train forward recomputed in its backward (nn/remat.py)
        self.remat = bool(remat)
        self.comm_hook = comm.validate_hook(comm_hook)
        self.comm_topology = comm.validate_topology(comm_topology or "flat")
        hier = self.comm_topology == "hierarchical"
        self.comm_overlap = comm.normalize_overlap(comm_overlap)
        self.bucket_cap_mb = comm.validate_bucket_cap(bucket_cap_mb)
        self.topk_density = float(topk_density)
        comm.bucket_topk(1, self.topk_density)  # the range, checked now
        self.generator = generator
        self.clip_grad_norm = None if clip_grad_norm is None else float(clip_grad_norm)
        self.step = 0
        self.grad_accumulation = int(grad_accumulation)
        if self.grad_accumulation < 1:
            raise ValueError(f"grad_accumulation must be >= 1, got {grad_accumulation!r}")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise backend.BackendUnavailableError(
                "DistributedDataParallel on cuda but no GPU is visible; pass "
                "device='cpu' to run on the CPU"
            )
        self.model = model.to(self.device)
        self.optimizer = optimizer
        self.criterion = criterion
        self.augment = augment
        self.eval_transform = eval_transform
        self.rank = backend.get_rank()
        self.world_size = backend.get_world_size()
        # the replicas of the gradient exchange: the world, or the data axis
        self.data_size = mesh2d_lib.data_size(self.mesh)
        tp = mesh2d_lib.is_tensor_parallel(self.mesh)
        # (local_group, host_group, hosts, local) of the hierarchical split
        self._hier = self._hierarchy(weight_update_sharding) if hier else None
        auto = self.mode == "auto"
        if weight_update_sharding and auto:
            raise ValueError(
                "weight_update_sharding requires mode='shard_map' (the reduce-scatter/"
                "all-gather exchange is expressed over the explicit per-replica step's "
                "named axis)"
            )
        # mode auto's step is the global batch's: its BatchNorm statistics,
        # its dropout mask, its loss mean (global_share)
        self._scale = global_share if auto else None
        if auto:
            convert_sync_batchnorm(self.model)
            if self.world_size > 1:
                global_batch_dropout(self.model, self.rank, self.world_size)
        self._graphs = None  # training.graphs.StepGraphs, at the first group on a GPU
        collectives.broadcast_one_to_all(self.model)
        self._tp_specs = None
        # the hook's plan: over the JAX package's leaf order (its buckets),
        # or under ZeRO-1 over the flat layout (one whole-vector bucket)
        sizes = tuple(p.numel() for p in self.model.parameters())
        if tp:  # the whole model broadcast, then this rank keeps its shard
            self._tp_specs = tp_lib.tp_param_specs(self.model)
            # the plan over the LOCAL shard template, in the TP tree's leaf
            # order: the exchange spans the data group only
            whole, _ = jax_from_state_dict(model_name(self.model), self.model.state_dict())
            template = tp_lib.local_param_template(tp_lib.to_tp_tree(whole), self._tp_specs,
                                                   self.model_size)
            sizes = tuple(leaf.size for _, leaf in tree_leaves(template))
            full = list(self.model.parameters())
            self.model = tp_lib.TensorParallelLM(self.model, self.mesh)
            _rebind(optimizer, full, list(self.model.parameters()))
        self.weight_update_sharding = bool(weight_update_sharding)
        # what the step cores clip: under ZeRO-1 the wrapped optimizer's
        # step clips (and syncs, :attr:`_sync`)
        self._clip = self.clip_grad_norm
        if (self.comm_hook != "none" or hier) and not tp:
            sizes = jax_sizes(model_name(self.model), self.model)
        self._comm = self._order = self._residual = None
        wus, world = self.weight_update_sharding, self.data_size
        if wus:
            spec = make_flat_param_spec(self.model, world)
            self.optimizer = ShardedUpdate(
                optimizer, list(self.model.parameters()), spec, self.rank,
                clip=self.clip_grad_norm, comm=comm.make_grad_comm(
                    spec.sizes, world, self.comm_hook, self.bucket_cap_mb, self.topk_density),
            )
            self._clip = None
        else:
            # the hierarchical exchange needs the plan even uncompressed
            self._comm = comm.make_grad_comm(
                sizes, world, self.comm_hook, self.bucket_cap_mb, self.topk_density, force=hier)
            if auto and self._comm is not None:
                # the hook on the all-reduced aggregate: the world's plan and
                # one replicated (total,) residual, no collective of its own
                # (the JAX step's comm.reduce with no axis)
                self._comm = self._comm._replace(world=1)
        if self._comm is not None:
            self._residual = self._comm.init_residual(self.device)
        wire = not auto  # mode auto's collective is float32 whatever the hook
        if wus:
            total = comm.comm_bytes_for_hook(
                sizes, world, self.comm_hook, wus=True, bucket_cap_mb=self.bucket_cap_mb,
                density=self.topk_density)
            self._bytes = {"total": total, "inter_host": total, "intra_host": 0}
        else:
            self._bytes = comm.comm_bytes_breakdown(
                sizes, world, self.comm_hook, self.comm_topology,
                local_size=self._hier[3] if hier else None, wire=wire,
                bucket_cap_mb=self.bucket_cap_mb, density=self.topk_density)
        self.grad_comm_bytes_per_step = self._bytes["total"]
        self.grad_comm_bytes_per_step_f32 = comm.comm_bytes_for_hook(sizes, world, "none", wus=wus,
                                                                     wire=wire)
        self._overlap = None  # the SegmentedSync, where the segmented step applies
        self._resolve_overlap()
        if self._comm is not None and self._overlap is None:  # the barrier exchange's order
            self._order = JaxFlatOrder(model_name(self.model), self.model)
        self.firewall = None  # the numerical guard's device state, when it is on
        if self.guard.enabled:
            self.firewall = Firewall(self.device, self.residual)
            self.firewall.judged_in_sync = auto
            if tp:  # the shards' verdicts differ: one MIN over the model group
                self.firewall.agree_group = self.mesh.model_group
            arm_guard(self.optimizer, self.firewall)
            if self._overlap is not None:
                self._overlap.staged = self.firewall.staged
            leaf = self.audit_replicas()
            if leaf is not None:
                raise ReplicaDesync(leaf, where="ddp-wrap")

    def _validate_tp(self, model, optimizer, mode, comm_topology, weight_update_sharding,
                     grad_accumulation, clip_grad_norm, augment, eval_transform, remat) -> None:
        """The tensor-parallel refusal surface, in the JAX package's order
        and with its texts (``tpuddp/parallel/ddp.py:263-322``): the JAX
        wrap refuses more than one process, the port more than one host."""
        tp_lib.validate_tp_geometry(model, self.model_size)
        if mode != "shard_map":
            raise ValueError(
                "parallel.model > 1 needs the explicit per-replica step "
                "(mode='shard_map'): the model-axis exchanges are written "
                "over named mesh axes"
            )
        if (comm_topology or "flat") != "flat":
            raise ValueError(
                "parallel.model > 1 with comm_topology='hierarchical' is "
                "refused: the factored ('host','local') data axis and the "
                "model axis would need a 3-D mesh the comm hooks do not "
                "express yet — pick one"
            )
        if weight_update_sharding:
            raise ValueError(
                "parallel.model > 1 with weight_update_sharding is refused: "
                "the WUS flat layout spans the whole replicated parameter "
                "vector, which a model-sharded state no longer has (the "
                "ZeRO composition is ROADMAP item 2)"
            )
        if int(grad_accumulation) != 1:
            raise ValueError(
                "parallel.model > 1 with grad_accumulation > 1 is deferred; "
                "scale the per-replica batch instead"
            )
        if clip_grad_norm is not None:
            raise ValueError(
                "parallel.model > 1 with clip_grad_norm is deferred: the "
                "global norm of a model-sharded gradient needs a model-axis "
                "reduction the clip path does not express yet"
            )
        if augment is not None or eval_transform is not None:
            raise ValueError(
                "parallel.model > 1 is a token-model path; image "
                "augment/eval_transform hooks do not apply"
            )
        if remat:
            raise ValueError("parallel.model > 1 with remat is deferred")
        if type(optimizer).__name__ in ("LARS", "LAMB"):
            raise ValueError(
                "parallel.model > 1 with LARS/LAMB is deferred: per-layer "
                "trust ratios over model-sharded leaves need model-axis "
                "norm reductions; use adam/sgd/sgdw"
            )
        if (backend.num_hosts() or 1) > 1:
            raise ValueError(
                "parallel.model > 1 is single-controller only for now "
                "(every shard must be addressable for placement and "
                f"checkpoint gather): the {backend.num_hosts()} hosts of this "
                "rendezvous must be one"
            )

    @property
    def metrics_group(self):
        """The group a step's metric sums and the desync audit reduce over:
        the data group of a tensor-parallel wrap (model-axis neighbours hold
        the same batch and shards that differ by design), else None, the
        world."""
        return None if self.mesh is None else self.mesh.data_group

    def audit_replicas(self) -> Optional[str]:
        """The desync audit (``tpuddp/parallel/ddp.py:723-736``): the JAX
        path of the first parameter whose replicas differ, None when they
        agree; a collective. Under tensor parallelism each rank's own shard
        is compared across its data group and the finding agreed over its
        model group, so every rank returns the same verdict."""
        if self.mesh is None:
            return guard_lib.audit_params(self.model)
        return guard_lib.audit_params(self.model, self.mesh.data_group, self.mesh.model_group)

    @property
    def tp_rules_hash(self) -> Optional[str]:
        """The TP rule table's hash (run_meta ``mesh.tp_rules_hash``); None
        on a pure data-parallel wrap."""
        return tp_lib.tp_rules_hash() if self.model_size > 1 else None

    @property
    def tp_param_specs(self) -> Optional[dict]:
        """The TP-layout tree's specs (None on a pure data-parallel wrap)."""
        return self._tp_specs

    @property
    def mesh_block(self) -> dict:
        """The run_meta ``mesh`` block: ``{"data", "model",
        "tp_rules_hash"}``."""
        return dict(mesh2d_lib.describe(self.mesh, self.world_size),
                    tp_rules_hash=self.tp_rules_hash)

    def gather_params(self) -> dict:
        """The whole model's ``state_dict`` (torch layout): the model's own,
        or under tensor parallelism every model rank's shard joined (a
        collective of the model group)."""
        if self.model_size > 1:
            return tp_lib.gather_params(self.model)
        return {k: v.detach() for k, v in self.model.state_dict().items()}

    def _hierarchy(self, weight_update_sharding: bool):
        """The hierarchical split's groups, after the JAX package's checks
        in its order (``tpuddp/parallel/ddp.py:198-219``)."""
        if self.mode != "shard_map":
            raise ValueError(
                "comm_topology='hierarchical' needs the explicit per-replica step "
                "(mode='shard_map'): the multi-hop reduction is expressed over the factored "
                "mesh's named axes (mode='auto' lets XLA place the collective)"
            )
        if weight_update_sharding:
            raise ValueError(
                "comm_topology='hierarchical' and weight_update_sharding are mutually "
                "exclusive: the reduce-scatter/all-gather exchange already factors the "
                "reduction; pick one"
            )
        return mesh.hierarchical_groups(self.world_size)

    @property
    def hierarchy(self):
        """``(hosts, local)`` of the hierarchical split; None under
        ``flat``."""
        return None if self._hier is None else self._hier[2:]

    @property
    def grad_comm_bytes_inter_host(self) -> int:
        """The inter-host share of one reduction's bytes: the hook's payload
        of the shard under ``hierarchical``, all of them under ``flat``."""
        return self._bytes["inter_host"]

    @property
    def grad_comm_bytes_intra_host(self) -> int:
        """The intra-host share: the float32 reduce-scatter and all-gather
        operands under ``hierarchical``, 0 under ``flat``."""
        return self._bytes["intra_host"]

    def _resolve_overlap(self) -> None:
        """The ``comm_overlap`` knob against the JAX package's eligibility
        order and reasons (``tpuddp/parallel/ddp.py:623-715``): the
        segments of the JAX bucket plan, and the :class:`SegmentedSync`
        where the segmented step applies; ``auto`` falls back to the
        barrier step with a recorded reason, ``true`` raises."""
        want = self.comm_overlap
        if want is False:
            self._overlap_meta = {"enabled": False, "segments": None, "reason": "disabled"}
            return
        reason = None
        try:
            name = model_name(self.model)
        except ValueError:
            name = None
        if name is not None and is_transformer(name):
            name = None  # a dict tree, not a Sequential, in the JAX package
        if self.mode != "shard_map":
            reason = ("mode='auto' has no explicit collective to issue per segment (XLA places "
                      "the psum itself)")
        elif self.comm_topology != "flat":
            reason = ("comm_topology='hierarchical': a per-segment scatter would move the "
                      "error-feedback residual's owner placement")
        elif self.weight_update_sharding:
            reason = ("weight_update_sharding: per-segment reduce-scatter pieces do not "
                      "reassemble into the replica's canonical full-vector shard")
        elif self.remat:
            reason = ("remat wraps the whole forward in one jax.checkpoint body; per-segment "
                      "VJP staging would recompute outside it")
        elif self.model_size > 1:
            reason = "tensor parallelism (parallel.model > 1)"
        elif name is None:  # every other model with a JAX counterpart here is a Sequential
            reason = ("segment boundaries are derived from Sequential children; "
                      f"{type(self.model).__name__} has no child decomposition")
        segments = None
        if reason is None:
            try:
                sizes = jax_sizes(name, self.model)
                total = self.world_size * -(-sum(sizes) // self.world_size)
                buckets = (self._comm.buckets if self._comm is not None
                           else comm.make_buckets(sizes, total, self.bucket_cap_mb))
                segments = comm.make_segments(jax_layer_sizes(name, self.model), buckets, total)
                spans = [jax_param_span(name, self.model, seg.layers) for seg in segments]
            except ValueError as e:
                reason, segments = f"segment derivation failed: {e}", None
        if reason is None and want == "auto" and len(segments) < 2:
            reason = (f"single bucket-aligned segment at bucket_cap_mb={self.bucket_cap_mb:g} — "
                      "segmentation would be the barrier step with extra staging")
        if reason is not None:
            if want is True:
                raise ValueError(
                    f"comm_overlap=true refused: {reason}. Use comm_overlap='auto' to fall back "
                    "to the barrier step where segmentation does not apply."
                )
            self._overlap_meta = {"enabled": False, "segments": None, "reason": reason}
            return
        orders = None
        if self._comm is not None:  # each segment's permutation, from one of the model's
            perm = jax_order_indices(name, self.model)
            orders = [JaxFlatOrder(name, self.model, self.device, seg.layers, perm)
                      for seg in segments]
        stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._overlap = SegmentedSync(self.model, segments, spans, orders, self._comm,
                                      self._residual, self.world_size, stream)
        self._overlap_meta = {"enabled": True, "segments": len(segments), "reason": None}

    @property
    def _sync(self) -> Callable:
        """What the step cores sync the gradients with: :meth:`sync_grads`,
        nothing under ZeRO-1 (the wrapped optimizer's step syncs). Not
        stored: a bound method kept on the wrap would make a reference
        cycle, and a dropped wrap would hold its model's memory until a
        garbage collection."""
        if self.mode == "auto":
            return self.sync_global
        return _no_sync if self.weight_update_sharding else self.sync_grads

    def skip_counters(self):
        """Host ``(total, consecutive)`` of the guard's skipped updates;
        ``(0, 0)`` without the guard. One fetch: call it per epoch."""
        return (0, 0) if self.firewall is None else self.firewall.read()

    @property
    def comm_overlap_meta(self) -> dict:
        """How ``comm_overlap`` resolved: ``{"enabled", "segments",
        "reason"}``, as the JAX wrap's ``comm_overlap_meta``."""
        return self._overlap_meta

    @property
    def residual(self) -> Optional[torch.Tensor]:
        """This replica's error-feedback residual, ``(total,)`` float32 (in
        the JAX flat order; under ZeRO-1 in the port's), updated in place by
        every step; None without an error-feedback hook."""
        if self.weight_update_sharding:
            return self.optimizer.residual
        return self._residual

    def _comm_key(self) -> tuple:
        """What a captured step holds of the hook: its name, density and
        bucket plan."""
        plan = self._comm if self._comm is not None else getattr(self.optimizer, "comm", None)
        return (self.comm_hook, self.topk_density, None if plan is None else plan.buckets)

    def _mean(self, flat: torch.Tensor) -> None:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.metrics_group)
        flat.div_(self.data_size)

    def sync_grads(self) -> None:
        """The barrier step's sync: all-reduce mean of every gradient over
        the data replicas (the world; a tensor-parallel rank's data group),
        through one flat buffer; with a comm hook its exchange (at world 1
        too); under ``hierarchical`` the three-hop exchange."""
        if self._comm is not None:
            if self._order is None:  # the wrap's steps exchange per segment
                self._order = JaxFlatOrder(model_name(self.model), self.model)
            lost = None if self.firewall is None else self.firewall.staged
            groups = None if self._hier is None else self._hier[:2]
            comm_sync(list(self.model.parameters()), self._comm, self._order, self._residual, lost,
                      groups, group=self.metrics_group)
            return
        if self.data_size == 1:
            return
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        collectives.flat_collective(grads, self._mean)

    def _sum(self, flat: torch.Tensor) -> None:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)

    def sync_global(self) -> None:
        """``mode: auto``'s sync (``tpuddp/training/step.py:366-396`` with no
        axis): the all-reduce SUM of the share-scaled gradients, the global
        batch's mean gradient on every replica; the guard's verdict on it,
        in float32 before any hook; then the hook's round trip of that
        aggregate in the JAX flat order, with the one replicated residual
        and no collective of its own."""
        params = list(self.model.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.world_size > 1:
            collectives.flat_collective([p.grad for p in params], self._sum)
        if self.firewall is not None:
            self.firewall.judge([p.grad for p in params])
        if self._comm is not None:
            if self._order is None:
                self._order = JaxFlatOrder(model_name(self.model), self.model)
            lost = None if self.firewall is None else self.firewall.staged
            comm_sync(params, self._comm, self._order, self._residual, lost)

    def sync_buffers(self) -> None:
        """Broadcast the model's buffers from rank 0, one flat collective per
        buffer dtype; nothing for a world of one or a model without buffers,
        nor under ``mode: auto``, whose BatchNorm statistics are the global
        batch's on every replica."""
        if self.mode != "auto":
            collectives.broadcast_(self.model.buffers())

    def to_device(self, batch):
        """``(x, y, w)`` on the device: staged tensors as they are, a host
        batch copied from pinned memory without blocking."""
        return stage_batch(batch, self.device)

    def train_step(self, batch) -> torch.Tensor:
        """One step on a host batch; returns on-device ``[loss_sum, n]``."""
        if self.grad_accumulation > 1:
            raise RuntimeError(
                "per-batch train_step is undefined under grad_accumulation "
                f"(= {self.grad_accumulation}): it would apply one full-scale update "
                "per micro-batch; use train_cycle with a whole cycle of batches"
            )
        x, y, w = self.to_device(batch)
        self.step += 1
        mask = self._flip_masks([(x, y, w)])[0] if self._scale is not None else None
        return train_core(
            self.model, self.optimizer, self.criterion, self.augment,
            self._sync, self.sync_buffers, x, y, w, self._clip, mask, overlap=self._overlap,
            firewall=self.firewall, remat=self.remat, scale=self._scale,
        )

    def train_cycle(self, batches) -> torch.Tensor:
        """One accumulation cycle over ``grad_accumulation`` host batches;
        returns the cycle's on-device ``[loss_sum, n]``."""
        if len(batches) != self.grad_accumulation:
            raise ValueError(
                f"a cycle takes {self.grad_accumulation} micro-batches, got {len(batches)}"
            )
        self.step += len(batches)
        batches = [self.to_device(b) for b in batches]
        masks = self._flip_masks(batches) if self._scale is not None else None
        return train_cycle(
            self.model, self.optimizer, self.criterion, self.augment, self._sync,
            self.sync_buffers, batches, self._clip, masks,
            overlap=self._overlap, firewall=self.firewall, remat=self.remat, scale=self._scale,
        )

    def eval_step(self, batch) -> torch.Tensor:
        """Returns on-device ``[loss_sum, correct, n]``."""
        x, y, w = self.to_device(batch)
        return eval_core(self.model, self.criterion, self.eval_transform, x, y, w)

    def _flip_masks(self, batches):
        """One flip mask per batch (None without flips), drawn on the host
        from the augment's generator in step order, as the per-batch steps
        draw them, and sent to the device in one copy. Under ``mode: auto``
        at world > 1 each is this replica's rows of the global batch's mask
        (drawn alike on every replica: ``tpuddp/training/step.py:134-141``
        with no replica fold)."""
        draw = getattr(self.augment, "flip_mask", None)
        rows = self._scale is not None and self.world_size > 1

        def one(x):
            if draw is None:
                return None
            if not rows:
                return draw(x, device="cpu")
            b = x.shape[0]
            full = draw(torch.empty((self.world_size * b,), device="meta"), device="cpu")
            return full[self.rank * b:(self.rank + 1) * b]

        masks = [one(x) for x, _, _ in batches]
        if any(m is None for m in masks):
            return [None] * len(batches)
        return list(to_device(torch.stack(masks), self.device).unbind(0))

    def _group(self, kind: str, key: tuple, held: tuple, inputs, body):
        """``body(inputs)``: eagerly on the CPU (or with ``_graph_replay``
        off), else one group of the CUDA-graph engine. A tensor-parallel
        wrap runs eagerly on the card too: its model-axis exchanges run over
        Gloo where two ranks share a GPU, and a Gloo collective cannot be
        captured in a CUDA graph."""
        if not (self._graph_replay and self.device.type == "cuda") or self.model_size > 1:
            return body(inputs)
        if kind == "train":
            graphs.check_graph_safe(self.optimizer)
        if self._graphs is None:
            self._graphs = graphs.StepGraphs(self.device)
        return self._graphs.run(kind, key, held, inputs, body)

    def clear_graphs(self) -> None:
        """Drop every captured graph (after anything that replaces the
        storage of the parameters, buffers or optimizer state)."""
        if self._graphs is not None:
            self._graphs.clear()

    def train_step_many(self, batches, sums: Optional[torch.Tensor] = None) -> torch.Tensor:
        """K = ``len(batches)`` train steps as one dispatch (K / A cycles
        under accumulation; ``tpuddp/parallel/ddp.py:812-844``): one
        CUDA-graph replay on a GPU after its signature's warm-up and
        capture, the same steps one after another on the CPU. Returns
        ``sums`` (zeros when None) plus each step's ``[loss_sum, n]``, added
        in order."""
        if len(batches) % self.grad_accumulation:
            raise ValueError(
                f"a chunk holds whole cycles of {self.grad_accumulation} micro-batches, "
                f"got {len(batches)}"
            )
        batches = [self.to_device(b) for b in batches]
        masks = self._flip_masks(batches)
        if sums is None:
            sums = torch.zeros(len(TRAIN_KEYS), device=self.device)
        self.step += len(batches)

        def body(t):  # [sums, x_0, y_0, w_0, mask_0, x_1, ...]
            return train_many(
                self.model, self.optimizer, self.criterion, self.augment, self._sync,
                self.sync_buffers, t[0], [tuple(t[i:i + 3]) for i in range(1, len(t), 4)],
                t[4::4], self._clip, self.grad_accumulation, self._overlap, self.firewall,
                self.remat, self._scale,
            )

        inputs = [sums] + [t for b, m in zip(batches, masks) for t in (*b, m)]
        params = tuple(self.model.parameters())
        key = (graphs.shapes(inputs), self.grad_accumulation, self.clip_grad_norm,
               id(self.criterion), id(self.augment), tuple(id(p) for p in params),
               graphs.hyperparameters(self.optimizer), self._comm_key())
        return self._group("train", key, (self.criterion, self.augment, params), inputs, body)

    def eval_step_many(self, batches, sums: Optional[torch.Tensor] = None) -> torch.Tensor:
        """K eval batches as one dispatch (``tpuddp/parallel/ddp.py:
        885-905``), as :meth:`train_step_many` runs them; returns ``sums``
        (zeros when None) plus each batch's ``[loss_sum, correct, n]``,
        added in order."""
        batches = [self.to_device(b) for b in batches]
        if sums is None:
            sums = torch.zeros(len(EVAL_KEYS), device=self.device)

        def body(t):  # [sums, x_0, y_0, w_0, x_1, ...]
            return eval_many(self.model, self.criterion, self.eval_transform, t[0],
                             [tuple(t[i:i + 3]) for i in range(1, len(t), 3)])

        inputs = [sums] + [t for b in batches for t in b]
        params = tuple(self.model.parameters())
        key = (graphs.shapes(inputs), id(self.criterion), id(self.eval_transform),
               tuple(id(p) for p in params))
        return self._group("eval", key, (self.criterion, self.eval_transform, params), inputs, body)


def _rebind(optimizer, old, new) -> None:
    """Point ``optimizer`` at the parameters ``new`` in place of ``old``
    (one for one, in order): its param groups and its per-parameter tables
    (Adam's ``leaf_index`` and ``noise_base``). Its state must be empty: it
    is built over the new parameters at their first step."""
    if optimizer.state:
        raise ValueError("a tensor-parallel wrap takes an optimizer with no state yet")
    swap = {id(p): q for p, q in zip(old, new)}
    for group in optimizer.param_groups:
        group["params"] = [swap[id(p)] for p in group["params"]]
    for attr in ("leaf_index", "noise_base"):
        table = getattr(optimizer, attr, None)
        if isinstance(table, dict):
            setattr(optimizer, attr, {swap.get(id(p), p): v for p, v in table.items()})
