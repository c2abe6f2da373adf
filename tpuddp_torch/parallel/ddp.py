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
``Sequential``) and cuts the JAX package's bucket plan (for every hook,
``none`` included) into backward segments at the children of that
``Sequential``; ``auto`` keeps the barrier step where it does not apply or
gives one segment, with the JAX package's reason, and ``true`` raises its
``ValueError`` there. Where it applies, every step, cycle and chunk runs
the exchange as :class:`~tpuddp_torch.training.step.SegmentedSync`: each
segment's exchange issued as its gradients land in backward, on a side
stream of the card, bitwise the barrier step. ``comm_overlap_meta`` records
``{"enabled", "segments", "reason"}`` as the JAX wrap does.

``guard`` (``training.guard``; ``tpuddp/parallel/ddp.py:90, :560-580,
:723-740``): the numerical guard. At wrap time, after the broadcast, every
replica's parameters are audited (:func:`~tpuddp_torch.resilience.guard.
audit_or_raise`, ``ReplicaDesync`` on a divergence). Every step, cycle and
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
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from tpuddp_torch.models.convert import (
    JaxFlatOrder, flat_to_jax, jax_layer_sizes, jax_param_span, jax_sizes, model_name,
)
from tpuddp_torch.optim import ShardedUpdate, arm_guard
from tpuddp_torch.parallel import backend, collectives, comm, mesh
from tpuddp_torch.resilience.guard import Firewall, audit_or_raise, resolve_guard
from tpuddp_torch.training import graphs
from tpuddp_torch.training.pipeline import stage_batch, to_device
from tpuddp_torch.training.step import (
    EVAL_KEYS, TRAIN_KEYS, SegmentedSync, comm_sync, eval_core, eval_many, make_flat_param_spec,
    train_core, train_cycle, train_many,
)


def _no_sync() -> None:
    pass


class DistributedDataParallel:
    # False: on a GPU the K-step chunks and eval groups run eagerly, the
    # reference that chip_smoke.py and the cuda tests hold the replays against
    _graph_replay = True
    # what the port's wrap runs of the JAX package's knobs, which the
    # overlap eligibility reads in the JAX order (config refuses the others)
    mode = "shard_map"
    remat = False
    model_size = 1

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
    ):
        self.guard = resolve_guard(guard)
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
        # (local_group, host_group, hosts, local) of the hierarchical split
        self._hier = self._hierarchy(weight_update_sharding) if hier else None
        self._graphs = None  # training.graphs.StepGraphs, at the first group on a GPU
        collectives.broadcast_one_to_all(self.model)
        self.weight_update_sharding = bool(weight_update_sharding)
        # what the step cores clip: under ZeRO-1 the wrapped optimizer's
        # step clips (and syncs, :attr:`_sync`)
        self._clip = self.clip_grad_norm
        # the hook's plan: over the JAX package's leaf order (its buckets),
        # or under ZeRO-1 over the flat layout (one whole-vector bucket)
        sizes = tuple(p.numel() for p in self.model.parameters())
        if self.comm_hook != "none" or hier:
            sizes = jax_sizes(model_name(self.model), self.model)
        self._comm = self._order = self._residual = None
        wus, world = self.weight_update_sharding, self.world_size
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
        if self._comm is not None:
            self._residual = self._comm.init_residual(self.device)
        if wus:
            total = comm.comm_bytes_for_hook(
                sizes, world, self.comm_hook, wus=True, bucket_cap_mb=self.bucket_cap_mb,
                density=self.topk_density)
            self._bytes = {"total": total, "inter_host": total, "intra_host": 0}
        else:
            self._bytes = comm.comm_bytes_breakdown(
                sizes, world, self.comm_hook, self.comm_topology,
                local_size=self._hier[3] if hier else None, bucket_cap_mb=self.bucket_cap_mb,
                density=self.topk_density)
        self.grad_comm_bytes_per_step = self._bytes["total"]
        self.grad_comm_bytes_per_step_f32 = comm.comm_bytes_for_hook(sizes, world, "none", wus=wus)
        self._overlap = None  # the SegmentedSync, where the segmented step applies
        self._resolve_overlap()
        if self._comm is not None and self._overlap is None:  # the barrier exchange's order
            self._order = JaxFlatOrder(model_name(self.model), self.model)
        self.firewall = None  # the numerical guard's device state, when it is on
        if self.guard.enabled:
            self.firewall = Firewall(self.device, self.residual)
            arm_guard(self.optimizer, self.firewall)
            if self._overlap is not None:
                self._overlap.staged = self.firewall.staged
            audit_or_raise(self.model, where="ddp-wrap")

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
        elif name is None:  # every model with a JAX counterpart here is a Sequential
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
            perm = flat_to_jax(name, self.model, np.arange(sum(sizes), dtype=np.int64))
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
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        flat.div_(self.world_size)

    def sync_grads(self) -> None:
        """The barrier step's sync: all-reduce mean of every gradient,
        through one flat buffer; with a comm hook its exchange (at world 1
        too); under ``hierarchical`` the three-hop exchange."""
        if self._comm is not None:
            if self._order is None:  # the wrap's steps exchange per segment
                self._order = JaxFlatOrder(model_name(self.model), self.model)
            lost = None if self.firewall is None else self.firewall.staged
            groups = None if self._hier is None else self._hier[:2]
            comm_sync(list(self.model.parameters()), self._comm, self._order, self._residual, lost,
                      groups)
            return
        if self.world_size == 1:
            return
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        collectives.flat_collective(grads, self._mean)

    def sync_buffers(self) -> None:
        """Broadcast the model's buffers from rank 0, one flat collective per
        buffer dtype; nothing for a world of one or a model without buffers."""
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
        return train_core(
            self.model, self.optimizer, self.criterion, self.augment,
            self._sync, self.sync_buffers, x, y, w, self._clip, overlap=self._overlap,
            firewall=self.firewall,
        )

    def train_cycle(self, batches) -> torch.Tensor:
        """One accumulation cycle over ``grad_accumulation`` host batches;
        returns the cycle's on-device ``[loss_sum, n]``."""
        if len(batches) != self.grad_accumulation:
            raise ValueError(
                f"a cycle takes {self.grad_accumulation} micro-batches, got {len(batches)}"
            )
        self.step += len(batches)
        return train_cycle(
            self.model, self.optimizer, self.criterion, self.augment, self._sync,
            self.sync_buffers, [self.to_device(b) for b in batches], self._clip,
            overlap=self._overlap, firewall=self.firewall,
        )

    def eval_step(self, batch) -> torch.Tensor:
        """Returns on-device ``[loss_sum, correct, n]``."""
        x, y, w = self.to_device(batch)
        return eval_core(self.model, self.criterion, self.eval_transform, x, y, w)

    def _flip_masks(self, batches):
        """One flip mask per batch (None without flips), drawn on the host
        from the augment's generator in step order, as the per-batch steps
        draw them, and sent to the device in one copy."""
        draw = getattr(self.augment, "flip_mask", None)
        masks = [None if draw is None else draw(x, device="cpu") for x, _, _ in batches]
        if any(m is None for m in masks):
            return [None] * len(batches)
        return list(to_device(torch.stack(masks), self.device).unbind(0))

    def _group(self, kind: str, key: tuple, held: tuple, inputs, body):
        """``body(inputs)``: eagerly on the CPU (or with ``_graph_replay``
        off), else one group of the CUDA-graph engine."""
        if not (self._graph_replay and self.device.type == "cuda"):
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
