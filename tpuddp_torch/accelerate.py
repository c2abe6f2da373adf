"""Accelerator — the managed path of the port, the counterpart of
``tpuddp/accelerate.py`` (52-387, 521-1296 and 1299-1810) and of the
HuggingFace ``Accelerator`` surface the reference's
``multi-GPU-training-accelerate.py`` uses.

The training sequence is the torch one::

    outputs = model(inputs)                    # LazyForward: runs nothing yet
    loss = criterion(outputs, labels, weights) # LazyLoss: binds the weights
    accelerator.backward(loss)                 # the backward request
    optimizer.step()                           # the update (Adam: its kernel)

The forward waits for the criterion because a train-mode forward must leave
padded rows (``w = 0``) out of the BatchNorm statistics, and ``w`` is only
known when the criterion is applied (``tpuddp/accelerate.py:651-716``).
``accelerator.backward(loss)`` records the request (its batch on the device,
its flip mask drawn from the accelerator's stream, its step index). At fuse
depth 1 it runs at once: forward (train mode, with the accelerator's
``augment`` first), backward and the gradient sync, and ``step()`` applies
the update. A forward alone runs at ``loss.item()`` or ``outputs.argmax()``
(e.g. in eval loops, which pass already-transformed inputs).

**Fused steps** (``fuse_steps`` K > 1, ``tpuddp/accelerate.py:1032-1063,
:1237-1296``): ``backward`` only records, ``step()`` queues the request, and
the queue runs as one flush when it holds K steps, when the criterion or
the batch's shape or dtype changes, or when anything reads the model or a
queued loss. ``auto`` resolves at the first backward to 32, capped by the
staging budget over that batch's bytes (:func:`tpuddp_torch.utils.batching.
resolve_fuse`). On the CPU a flush runs its steps one after another with the
depth-1 operations in the depth-1 order, so a fused run is bitwise the
unfused one. On a CUDA model it runs as a CUDA graph of K steps, captured at
the second flush of each length and replayed at every later one
(``training/graphs.py``); the first flush of a length runs eagerly as the
warm-up. The contracts of the JAX queue hold:

- reading a queued loss (``item()``, ``device_value()``), ``sum_losses``,
  ``parameters()``, ``module``, a forward, ``gather``, ``save_model`` and
  ``save_state`` flush first;
- a loss read before ``step()`` flushes, then runs that step's gradient now;
  the ``step()`` that follows applies it at once, unqueued;
- ``load_model`` and ``load_state`` discard queued steps without running
  them (their losses are dropped) and drop every captured graph;
- a flush that fails marks its unresolved losses dropped, and reading one
  raises.

:class:`FusedEvaluator` sums each test batch's loss,
the correct count and the real-row count on the device in groups of K
batches (one CUDA-graph replay each on a CUDA model), with one host read at
``finalize()``.

The managed step computes the gradient of the GLOBAL batch's weighted-mean
loss, as the JAX step evaluates the criterion over the whole sharded batch:
each process scales its local weighted-mean loss by its share
``n_r / sum(n)`` of the real rows (one all-reduce of ``n``) before backward,
and one all-reduce SUM of the gradients (with the loss riding along) gives
``sum_r n_r g_r / sum_r n_r`` and the global loss on every process. On a
ragged batch this differs from the native path's mean of per-replica means.
BatchNorm statistics are the global batch's too (``prepare`` makes every
BatchNorm sync). At world 1 the collectives are the identity and the scale
is exactly 1, so a step is the native step.

Gradient accumulation (``gradient_accumulation_steps = A``) is the JAX
managed rule, which differs from the native one on purpose: ``step()`` adds
each micro-batch's global-mean gradient to a sum and every A-th applies ONE
update from the UNWEIGHTED mean ``sum / A``; ``flush_accumulation()`` applies
a partial cycle with ``1 / count`` (``tpuddp/accelerate.py:1092-1140``). It
excludes fusion: ``auto`` is then depth 1, and an explicit depth over 1 is a
``ValueError``.

``clip_grad_norm`` clips the update's gradient (after the loss-scaled
all-reduce and, under accumulation, after the cycle's average) to that global
L2 norm, once per update and never per micro-batch
(``tpuddp/accelerate.py:1143-1165``).

Besides its torch generator the accelerator keeps the JAX ``Accelerator``'s
key stream (:class:`~tpuddp_torch.seeding.JaxKeyStream`) and draws from it
wherever the JAX one draws: ``bwd_key`` and the model's init key at
``prepare``, one key per forward-only train-mode read and per
``next_rng_key()``. ``save_state`` writes the stream (``rng_key``) and
``bwd_key`` as the JAX package would at that point; ``load_state`` puts
them back.

Call-order contracts (``tests/test_accelerate.py``): ``step()`` without a
``backward()`` raises; a second ``backward()`` before ``step()`` drops the
first loss (reading it then raises), or raises under accumulation;
``zero_grad()`` drops a backward waiting for ``step()`` and is otherwise a
no-op (queued steps stay queued).

``weight_update_sharding`` (ZeRO-1, ``_FlatShardedUpdate`` and
``_ensure_opt_state``, ``tpuddp/accelerate.py:389-470, :968-1000``):
``prepare`` wraps the optimizer in :class:`~tpuddp_torch.optim.
ShardedUpdate` over the flat layout of :func:`~tpuddp_torch.training.step.
make_flat_param_spec`. The gradients are already the global ones (the
managed all-reduce), so each process takes its shard as a slice, clips
before (the clip's norm is of the whole gradient, as the JAX package clips
the gradient tree before the wrapped update), updates the shard and
all-gathers the shards; the bf16 rounding numbers the elements over the
whole flat vector (base ``rank * shard_n``), as the JAX package's
partitioned update does. It holds inside fused flushes and accumulation
alike; ``save_state``/``load_state`` write and read the ``data_flat``
vectors.

``comm_hook`` (``tpuddp/accelerate.py:813-822, :986-1001, :1150-1166``):
the managed path's collective is the float32 all-reduce of ``backward``, so,
as in the JAX package, the hook round-trips the aggregated gradient through
its wire format (:func:`~tpuddp_torch.parallel.comm.local_quantize`, each
parameter its own bucket) at each update, before the clip, with the
error-feedback residual (one float32 tensor per parameter, created at the
first update and updated in place, so a fused flush's graph holds it;
``save_state``/``load_state`` write and read it as ``['comm_state']``).
``grad_comm_bytes_per_step`` counts float32 bytes: no byte cut reaches the
wire here. ``comm_topology`` other than ``flat`` is the JAX package's
``ValueError``.

``comm_overlap`` (``tpuddp/accelerate.py:1417-1440``): accepted for parity
with the native path, which has the segmented-overlap step; the managed
path keeps the barrier step, so ``true`` is the JAX package's
``ValueError`` and ``comm_overlap_meta`` records its reason.

``guard`` (``training.guard``; ``tpuddp/accelerate.py:591-630, :790-910,
:1076-1190``): the numerical guard. ``prepare`` audits every process's
copy of the model's parameters (``ReplicaDesync`` on a divergence). Each
update (per step, in a fused flush, at a cycle's end) is then guarded by
the optimizer's :class:`~tpuddp_torch.resilience.guard.Firewall`: the
verdict of the aggregated float32 gradient, before the hook's round trip
and the clip; at 0 the update is a bitwise no-op on the parameters, the
optimizer state and the hook's residual, and the BatchNorm buffers go back
to their values before the step's forward (before the cycle's first
forward under accumulation); the skip counters advance on the device
(``PreparedOptimizer.skip_counters``) and ride in ``state_{epoch}.npz``.

Batches may arrive already on the device (the entry point stages them,
``training/pipeline.py``); a host array is copied from pinned memory without
blocking. ``save_model``/``load_model`` and ``save_state``/``load_state``
write and read the JAX package's ``model.npz`` and ``state_{epoch}.npz``
(``training/checkpoint.py``); ``save_state(step=, cursor=)`` writes a step
snapshot ``state_{epoch}_s{step}.npz``, whose cursor ``load_state`` leaves
in ``last_restore_cursor`` (``tpuddp/accelerate.py:1664-1797``).
"""

from __future__ import annotations

import os
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from tpuddp_torch import config as cfg_lib
from tpuddp_torch import seeding
from tpuddp_torch.data.loader import DataLoader, ShardedDataLoader
from tpuddp_torch.nn.norm import BatchNorm, batch_weights, convert_sync_batchnorm
from tpuddp_torch.optim import ShardedUpdate, arm_guard, clip_grad_norm_, count_from_state
from tpuddp_torch.parallel import backend, collectives, comm
from tpuddp_torch.resilience.guard import Firewall, audit_or_raise, resolve_guard
from tpuddp_torch.training import checkpoint as ckpt
from tpuddp_torch.training import graphs
from tpuddp_torch.training.pipeline import to_device
from tpuddp_torch.training.step import global_share, make_flat_param_spec
from tpuddp_torch.utils import batching

# the fuse depth that ``auto`` is capped at (tpuddp/accelerate.py:473-491)
AUTO_FUSE_CAP = 32


class LazyForward:
    """A deferred ``model(x)``; the forward runs when its value is needed."""

    def __init__(self, model: "PreparedModel", x):
        self._model = model
        self._x = x
        self._logits = None
        self._weights = None  # bound by a criterion

    def _tpuddp_bind_loss(self, criterion, labels, weights=None) -> "LazyLoss":
        self._weights = weights
        return LazyLoss(self, criterion, labels, weights)

    @property
    def value(self) -> torch.Tensor:
        """The logits (this process's rows)."""
        if self._logits is None:
            self._logits = self._model._forward_only(self._x, self._weights)
        return self._logits

    def argmax(self, dim: int = -1) -> torch.Tensor:
        return self.value.argmax(dim=dim)

    def __array__(self, dtype=None):
        arr = self.value.detach().float().cpu().numpy()
        return arr if dtype is None else arr.astype(dtype)


class LazyLoss:
    """A deferred ``criterion(outputs, labels, weights)``. After its step has
    run it holds the global batch's loss, the same on every process; read
    without a backward it is this process's forward-only loss."""

    def __init__(self, fwd: LazyForward, criterion: Callable, labels, weights):
        self._fwd = fwd
        self._criterion = criterion
        self._labels = labels
        self._weights = weights
        self._value: Optional[torch.Tensor] = None
        self._read = False
        self._dropped = None  # why its backward request was dropped, once it is
        self._queued_on: Optional["PreparedOptimizer"] = None  # its step is queued there

    def _drop(self, reason: str) -> None:
        """The backward request this loss belongs to was dropped before its
        ``step()``; a value never read must not be read later."""
        if not self._read:
            self._dropped = reason

    def device_value(self) -> torch.Tensor:
        """The loss as a device scalar, with no host read (a queued step's
        loss flushes its queue)."""
        if self._value is None and self._queued_on is not None:
            self._queued_on.flush()
        model = self._fwd._model
        if self._value is None and model._pending is not None and model._pending.loss is self:
            model._materialize()  # loss.item() before step(): its gradient runs now
        if self._dropped is not None:
            raise RuntimeError(
                f"this loss's backward request was dropped before optimizer.step() "
                f"({self._dropped}); its value must not be read"
            )
        if self._value is None:  # forward only, e.g. in an eval loop
            self._value = self._criterion(
                self._fwd.value, model.to_device(self._labels, torch.int64),
                None if self._weights is None else model.to_device(self._weights, torch.float32),
            ).detach()
        self._read = True
        return self._value

    def item(self) -> float:
        return float(self.device_value())


def loss_values(losses, initial=None) -> torch.Tensor:
    """The device vector of many losses' values in their order, with no
    host read; queued steps are flushed once. ``initial`` (the values of an
    interrupted pass's steps, carried by a step snapshot's cursor) comes
    first, so a resumed pass sums the uninterrupted pass's vector."""
    losses = list(losses)
    for l in losses:
        if l._value is None and l._queued_on is not None:
            l._queued_on.flush()
    parts = [torch.stack([l.device_value() for l in losses])] if losses else []
    if initial is not None:
        device = parts[0].device if parts else torch.device("cpu")
        parts.insert(0, torch.as_tensor(np.asarray(initial, np.float32), device=device))
    return torch.cat(parts) if parts else torch.zeros(0)


def sum_losses(losses) -> torch.Tensor:
    """The device sum of many losses' values, with no host read; ``float()``
    it for the one read of an epoch. Queued steps are flushed once. The
    values are summed as one vector in the losses' order, so the sum is the
    same bits whatever the fuse depth."""
    return loss_values(losses).sum()


class _Request(NamedTuple):
    """One ``accelerator.backward`` request: the batch on the device, its
    flip mask (None: no flip, or an augment that draws its own), the step
    index and the loss it fills."""

    x: torch.Tensor
    y: torch.Tensor
    w: torch.Tensor
    criterion: Callable
    step_idx: int
    loss: LazyLoss
    flip_mask: Optional[torch.Tensor]


class PreparedModel:
    """The managed model: ``model(x)`` returns a :class:`LazyForward`;
    ``train()``/``eval()`` switch the module's mode. ``module`` is the
    unwrapped ``nn.Module``, on the accelerator's device, every BatchNorm
    synced, with process 0's parameters and buffers; reading it (or
    ``parameters()``) flushes queued steps first."""

    def __init__(self, accelerator: "Accelerator", module: torch.nn.Module):
        self.accelerator = accelerator
        self.device = accelerator.device
        self._module = convert_sync_batchnorm(module.to(self.device))
        collectives.broadcast_one_to_all(self._module)
        self._pending: Optional[_Request] = None  # backward requested, not run yet
        self._staged: Optional[LazyLoss] = None  # backward run, step() not yet
        self._optimizer: Optional["PreparedOptimizer"] = None  # bound by prepare
        self._graphs = None  # training.graphs.StepGraphs, at the first group on a GPU
        # under the guard: the buffers before the last backward's forward,
        # which a skipped update restores
        self._buffers_before = None
        self._bwd_counter = 0  # backward requests, saved as ['bwd_counter']
        # the JAX model's draws: its backward base key here, its init key at
        # its first forward (tpuddp/accelerate.py:544, :605), which a
        # pretrained model (models/pretrained.py) does not draw (:597-605)
        self._bwd_key = accelerator.jax_keys.draw()
        if getattr(module, "pretrained_from", None) is None:
            accelerator.jax_keys.draw()

    @property
    def module(self) -> torch.nn.Module:
        self._flush_queues()
        return self._module

    def train(self, mode: bool = True) -> "PreparedModel":
        self._module.train(mode)
        return self

    def eval(self) -> "PreparedModel":
        return self.train(False)

    def parameters(self):
        return self.module.parameters()

    def __call__(self, x) -> LazyForward:
        return LazyForward(self, x)

    def to_device(self, a, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """A host array or a tensor on the device (``dtype`` if given); a
        tensor already there passes as it is."""
        return to_device(a, self.device, dtype)

    def _params(self):
        return [p for p in self._module.parameters() if p.requires_grad]

    def _graph_engine(self):
        """The CUDA-graph engine of this model's fused train steps and eval
        groups (one memory pool)."""
        if self._graphs is None:
            self._graphs = graphs.StepGraphs(self.device)
        return self._graphs

    def _flush_queues(self) -> None:
        """Run the optimizer's queued steps, so that what is read next is
        current."""
        if self._optimizer is not None:
            self._optimizer.flush()

    @torch.no_grad()
    def _forward_only(self, x, w) -> torch.Tensor:
        self._flush_queues()
        x = self.to_device(x)
        module = self._module
        if not module.training:
            return module(x)
        self.accelerator.jax_keys.draw()  # the JAX forward's dropout key
        # train mode without a backward: the JAX package computes it over
        # the batch it is given and discards the new buffers; so does this,
        # with the BatchNorms unsynced (no collective on one process's read)
        aug = self.accelerator.augment
        norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
        syncs = [m.sync for m in norms]
        saved = [b.clone() for b in module.buffers()]
        try:
            for m in norms:
                m.sync = False
            with batch_weights(module, None if w is None else self.to_device(w, torch.float32)):
                return module(aug(x) if aug is not None else x)
        finally:
            for m, s in zip(norms, syncs):
                m.sync = s
            for b, s in zip(module.buffers(), saved):
                b.copy_(s)

    def _backward(self, loss: LazyLoss) -> None:
        """Record the backward request of ``loss``; at fuse depth 1 run it
        now (forward, backward, gradient sync)."""
        if self._pending is not None or self._staged is not None:
            if self.accelerator.gradient_accumulation_steps > 1:
                raise RuntimeError(
                    "gradient accumulation requires optimizer.step() after EACH "
                    "accelerator.backward(): a second backward here would drop the "
                    "previous micro-batch's gradient"
                )
            old = self._pending.loss if self._pending is not None else self._staged
            old._drop("a second accelerator.backward() preceded optimizer.step()")
            self._pending = self._staged = None
        fwd = loss._fwd
        x = self.to_device(fwd._x)
        y = self.to_device(loss._labels, torch.int64)
        w = (torch.ones(y.shape[0], device=self.device) if loss._weights is None
             else self.to_device(loss._weights, torch.float32))
        draw = getattr(self.accelerator.augment, "flip_mask", None)
        req = _Request(x, y, w, loss._criterion, self._bwd_counter, loss,
                       draw(x) if draw is not None else None)
        self._bwd_counter += 1
        if self._optimizer is not None and self._optimizer._depth(x) > 1:
            self._pending = req
        else:
            self._stage(req)

    def _materialize(self) -> None:
        """A pending request's loss is read before ``step()``: the queue
        runs first (the gradient must be of the current parameters), then
        this request's forward and backward."""
        req, self._pending = self._pending, None
        self._flush_queues()
        self._stage(req)

    def _stage(self, req: _Request) -> None:
        """Run ``req``'s forward and backward; its gradient waits in
        ``.grad`` for ``step()``."""
        value, logits = self._execute(req)
        req.loss._value = value
        req.loss._fwd._logits = logits.detach()
        self._staged = req.loss

    @torch.enable_grad()  # a flush may start inside a forward-only read's no_grad
    def _execute(self, req: _Request):
        """Forward and backward of the global batch's loss for ``req``'s
        batch: the global-mean gradient lands in each parameter's ``.grad``.
        Returns ``(global loss, logits)``. Reads nothing on the host, so it
        runs inside a CUDA-graph capture too."""
        module = self._module
        x = req.x
        if self._optimizer is not None and self._optimizer.firewall is not None:
            self._buffers_before = Firewall.save_buffers(module)
        was_training = module.training
        module.train()
        try:
            aug = self.accelerator.augment
            if aug is not None:
                x = aug(x) if req.flip_mask is None else aug(x, flip_mask=req.flip_mask)
            with batch_weights(module, req.w):
                logits = module(x)
        finally:
            module.train(was_training)
        share, _ = global_share(req.w.sum())
        scaled = req.criterion(logits, req.y, req.w) * share
        params = self._params()
        for p in params:
            p.grad = None
        scaled.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        value = scaled.detach().reshape(1)
        collectives.all_reduce_sum_([p.grad for p in params] + [value])
        return value.reshape(()), logits


class PreparedOptimizer:
    """Wraps the optimizer: ``step()`` applies the gradient of the last
    ``accelerator.backward`` (clipped, with ``clip_grad_norm``; one
    Adam-kernel launch per Adam update on a CUDA model), adds it to the
    cycle's sum under accumulation, or queues the step at fuse depth K > 1.
    ``flush()`` runs the queue: eagerly on the CPU, as a CUDA graph on a CUDA
    model (``training/graphs.py``)."""

    # False: a CUDA model's flushes run the eager queue, the reference that
    # chip_smoke.py holds the graph replays against
    _graph_replay = True

    def __init__(self, optimizer: torch.optim.Optimizer, model: PreparedModel, firewall=None):
        self.optimizer = optimizer
        self.model = model
        self.firewall = firewall  # the numerical guard's device state, when it is on
        self._accum = None  # the cycle's gradient sum, one tensor per parameter
        self._accum_count = 0
        self._cycle_buffers = None  # under the guard: the buffers before the cycle
        self._fuse: Optional[int] = None  # the resolved depth, at the first backward
        self._queue: List[_Request] = []
        self._residual: Optional[List[torch.Tensor]] = None  # the hook's, at the first update
        self.updates = 0
        acc = model.accelerator
        # the collective is float32 whatever the hook (wire=False)
        self.grad_comm_bytes_per_step = comm.comm_bytes_for_hook(
            [p.numel() for p in model._params()], acc.num_processes, acc.comm_hook,
            wus=acc.weight_update_sharding, wire=False)

    def comm_residual(self) -> Optional[List[torch.Tensor]]:
        """The hook's error-feedback residual, one tensor per trained
        parameter (zeros when created here); None without error
        feedback."""
        if self.model.accelerator.comm_hook not in comm.EF_HOOKS:
            return None
        if self._residual is None:
            self._residual = comm.init_residual_tree(self.model._params())
        return self._residual

    def skip_counters(self):
        """Host ``(total, consecutive)`` of the guard's skipped updates;
        ``(0, 0)`` without the guard. One fetch: call it per epoch."""
        return (0, 0) if self.firewall is None else self.firewall.read()

    @property
    def fuse_depth(self) -> Optional[int]:
        """The resolved fuse depth (None before the first backward)."""
        return self._fuse

    @property
    def queued(self) -> int:
        """Steps waiting in the queue."""
        return len(self._queue)

    @property
    def accumulating(self) -> bool:
        """A gradient-accumulation cycle is open (micro-batches summed, its
        update not yet applied)."""
        return bool(self._accum_count)

    def _depth(self, x: torch.Tensor) -> int:
        """The fuse depth, resolved at the first request: ``auto`` is 32,
        capped by the staging budget over this batch's bytes."""
        if self._fuse is None:
            fuse = self.model.accelerator.fuse_steps
            if fuse == "auto":
                fuse = batching.resolve_fuse(x.numel() * x.element_size(), cap=AUTO_FUSE_CAP)
            self._fuse = int(fuse)
        return self._fuse

    def zero_grad(self) -> None:
        """Drops a backward waiting for ``step()``; otherwise nothing (the
        managed no-op)."""
        model = self.model
        if model._pending is not None:
            model._pending.loss._drop("zero_grad() preceded optimizer.step()")
        if model._staged is not None:
            model._staged._drop("zero_grad() preceded optimizer.step()")
            for p in model._params():
                p.grad = None
        model._pending = model._staged = None

    def step(self) -> None:
        model = self.model
        if model._staged is not None:  # its gradient is in .grad
            model._staged = None
            self._update()
            return
        req = model._pending
        if req is None:
            raise RuntimeError(
                "optimizer.step() called without a preceding accelerator.backward(loss)"
            )
        model._pending = None
        head = self._queue[0] if self._queue else None
        if head is not None and (
            head.criterion is not req.criterion or head.x.shape != req.x.shape
            or head.x.dtype != req.x.dtype
        ):
            self.flush()  # never one flush over mixed criteria, shapes or dtypes
        self._queue.append(req)
        req.loss._queued_on = self
        if len(self._queue) >= self._fuse:
            self.flush()

    def _update(self) -> None:
        """The staged gradient: applied, or added to the accumulation
        cycle."""
        accum = self.model.accelerator.gradient_accumulation_steps
        if accum == 1:
            self._apply()
            return
        params = self.model._params()
        grads = [p.grad for p in params]
        for p in params:
            p.grad = None
        if self._accum is None:
            self._accum = grads
            self._cycle_buffers = self.model._buffers_before
        else:
            self._accum = [a + g for a, g in zip(self._accum, grads)]
        self._accum_count += 1
        if self._accum_count >= accum:
            self.flush_accumulation()

    def flush(self) -> None:
        """Run every queued step now. If the flush fails, every queued loss
        without a value is marked dropped and the error propagates."""
        queue, self._queue = self._queue, []
        if not queue:
            return
        try:
            if self._graph_replay and self.model.device.type == "cuda":
                self._run_graph(queue)
            else:
                self._run_eager(queue)
        except BaseException:
            for req in queue:
                req.loss._queued_on = None
                if req.loss._value is None:
                    req.loss._drop("its fused-step flush failed (see the original exception)")
            raise
        for req in queue:
            req.loss._queued_on = None

    def _run_eager(self, queue) -> None:
        """The queued steps one after another, each the depth-1 step."""
        for req in queue:
            req.loss._value, _ = self.model._execute(req)
            self._apply()

    def _run_graph(self, queue) -> None:
        """The queued steps as one group of the model's graph engine: the
        eager steps at the signature's first flush, its graph after."""
        graphs.check_graph_safe(self.optimizer)
        model = self.model

        def body(slots):
            values = []
            for i, req in enumerate(queue):
                x, y, w, mask = slots[4 * i:4 * i + 4]
                value, _ = model._execute(req._replace(x=x, y=y, w=w, flip_mask=mask))
                values.append(value)
                self._apply()
            return torch.stack(values)

        def replayed():
            self.updates += len(queue)

        inputs = [t for req in queue for t in (req.x, req.y, req.w, req.flip_mask)]
        losses = model._graph_engine().run(
            "fused", graphs.signature(self, queue), graphs.held(self, queue), inputs, body, replayed)
        for i, req in enumerate(queue):
            req.loss._value = losses[i]

    def flush_accumulation(self) -> None:
        """Apply a partial cycle now, averaged over the micro-batches it
        holds (the dataloader-end rule of HF's ``accumulate()``); nothing
        when no cycle is open. The entry point calls it at every epoch end."""
        if self._accum_count == 0:
            return
        scale = 1.0 / self._accum_count
        for p, a in zip(self.model._params(), self._accum):
            p.grad = a * scale
        buffers, self._cycle_buffers = self._cycle_buffers, None
        self._accum, self._accum_count = None, 0
        self._apply(buffers)

    def _apply(self, buffers=None) -> None:
        """One update from the gradients in ``.grad``. Under the guard:
        their verdict first, and a skip restores ``buffers`` (the step's
        own buffers from before its forward when None)."""
        acc = self.model.accelerator
        fw = self.firewall
        if fw is not None:
            fw.judge([p.grad for p in self.model._params()])
        if acc.comm_hook != "none":
            params, residual = self.model._params(), self.comm_residual()
            quant, new = comm.local_quantize(
                [p.grad for p in params], residual, acc.comm_hook, acc.topk_density)
            for p, g in zip(params, quant):
                p.grad = g
            for r, n in zip(residual or (), new or ()):
                if fw is None:
                    r.copy_(n)
                else:
                    fw.keep(n, r)
        clip = acc.clip_grad_norm
        if clip is not None:
            clip_grad_norm_(self.model._params(), clip)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        if fw is not None:
            saved = self.model._buffers_before if buffers is None else buffers
            if saved is not None:
                fw.restore_buffers(self.model._module, saved)
            fw.commit()
        self.updates += 1


class FusedEvaluator:
    """The managed eval pass (``tpuddp/accelerate.py:221-387``): ``add``
    queues a test batch on the device, and each group of queued batches
    runs transform, forward, the per-batch criterion and the correct and
    real-row counts of every batch, adding them in order into three device
    scalars (the loss sum in float32, the counts as integers);
    ``finalize()`` runs what is still queued and reads them once: ``(loss
    sum, correct, total)``. Queued train steps are flushed before each
    group. Every process evaluates the whole stream it is given (quirk Q3);
    padded rows (``w = 0``) count nowhere.

    A group runs when the queue holds ``fuse_steps`` batches (None: auto,
    32 capped by the staging budget over the batch's bytes, worked out
    again whenever the batch shape changes, as the JAX evaluator's
    ``_resolve_fuse`` does), when a batch of another shape or dtype arrives
    (the queue never mixes them) and at ``finalize()``. On the CPU a group
    runs its batches one after another; on a CUDA model a group of two or
    more is one group of the model's CUDA-graph engine
    (``training/graphs.py``): eager at its signature's first group,
    captured at the second, replayed after. Either way the sums are added
    in batch order, so they are bitwise those of ``fuse_steps=1``."""

    def __init__(self, model: PreparedModel, criterion, transform=None, fuse_steps=None):
        self.model = model
        self.criterion = criterion
        self.transform = transform
        self.fuse_steps = None if fuse_steps is None else max(1, int(fuse_steps))
        self._queue: List[tuple] = []  # (x, y, w) on the device
        self._stats = None
        self._fuse_cache = None  # (shape key, resolved depth)

    def _resolve_fuse(self) -> int:
        """The group depth for the queued batches' shape."""
        if self.fuse_steps is not None:
            return self.fuse_steps
        x = self._queue[0][0]
        key = (tuple(x.shape), x.dtype)
        if self._fuse_cache is None or self._fuse_cache[0] != key:
            self._fuse_cache = (key, batching.resolve_fuse(x.numel() * x.element_size(),
                                                           cap=AUTO_FUSE_CAP))
        return self._fuse_cache[1]

    def add(self, x, y, w=None) -> None:
        model = self.model
        x, y = model.to_device(x), model.to_device(y, torch.int64)
        w = (torch.ones(y.shape[0], device=model.device) if w is None
             else model.to_device(w, torch.float32))
        if self._queue and (self._queue[0][0].shape != x.shape
                            or self._queue[0][0].dtype != x.dtype):
            self._flush()  # a ragged stream: never one group over mixed shapes
        self._queue.append((x, y, w))
        if len(self._queue) >= self._resolve_fuse():
            self._flush()

    @torch.no_grad()
    def _run(self, stats, batches):
        """The batches' sums added in order into ``stats``."""
        module = self.model._module
        loss_sum, correct, total = stats
        was_training = module.training
        module.eval()
        try:
            for x, y, w in batches:
                if self.transform is not None:
                    x = self.transform(x)
                logits = module(x)
                mask = w > 0
                loss_sum = loss_sum + self.criterion(logits, y, w)
                correct = correct + ((logits.argmax(dim=-1) == y) & mask).sum()
                total = total + mask.sum()
        finally:
            module.train(was_training)
        return loss_sum, correct, total

    def _flush(self) -> None:
        queue, self._queue = self._queue, []
        if not queue:
            return
        model = self.model
        model._flush_queues()  # queued train updates land first
        if self._stats is None:
            self._stats = (torch.zeros((), device=model.device),
                           torch.zeros((), dtype=torch.int64, device=model.device),
                           torch.zeros((), dtype=torch.int64, device=model.device))
        if len(queue) == 1 or model.device.type != "cuda":
            self._stats = self._run(self._stats, queue)
            return

        def body(slots):
            return self._run(tuple(slots[:3]), [tuple(slots[i:i + 3]) for i in range(3, len(slots), 3)])

        key = (graphs.shapes(t for b in queue for t in b), id(self.criterion), id(self.transform),
               tuple(id(p) for p in model._module.parameters()))
        held = (self.criterion, self.transform, tuple(model._module.parameters()))
        self._stats = model._graph_engine().run(
            "managed eval", key, held, [*self._stats, *(t for b in queue for t in b)], body)

    def finalize(self):
        """Run the queued batches, then read once: host ``(loss sum,
        correct, total)``."""
        self._flush()
        if self._stats is None:
            return 0.0, 0, 0
        loss_sum, correct, total = self._stats
        self._stats = None
        loss_sum, correct, total = torch.stack(
            [loss_sum.double(), correct.double(), total.double()]).tolist()
        return loss_sum, int(correct), int(total)


class Accelerator:
    """The managed entry: topology from the process group, a per-process
    random stream, and the verbs of the reference's Accelerator.

    ``device``: ``cuda`` (the default, the GPU the process group pinned:
    ``cuda:<local rank>``; raises
    without a GPU) or ``cpu``. ``augment``: the train-time transform
    ``x -> x`` (flip, normalize, resize) that runs inside every backward's
    forward; build it with ``generator=accelerator.generator`` so its flip
    masks draw from the process's stream. ``fuse_steps``: a depth, or
    ``auto`` (32 at the first backward, capped by the staging budget; 1
    under accumulation; :func:`tpuddp_torch.config.resolve_fuse_steps`).
    ``clip_grad_norm``: the global L2 norm each update's gradient is clipped
    to (None: no clip). ``weight_update_sharding``: ZeRO-1, the optimizer's
    update and state sharded across the processes. ``comm_hook`` and
    ``topk_density``: the gradient comm hook, emulated on the aggregated
    gradient; ``bucket_cap_mb`` is accepted for parity with the native
    path (each parameter is its own bucket here); ``comm_topology`` must be
    ``flat``; ``comm_overlap`` must not be true (``comm_overlap_meta`` says
    why). ``guard``: the ``training.guard`` block (the numerical guard)."""

    def __init__(
        self,
        seed: Optional[int] = None,
        fuse_steps=1,
        gradient_accumulation_steps: int = 1,
        augment: Optional[Callable] = None,
        device: str = "cuda",
        clip_grad_norm: Optional[float] = None,
        weight_update_sharding: bool = False,
        comm_hook: str = "none",
        bucket_cap_mb: float = comm.DEFAULT_BUCKET_CAP_MB,
        comm_topology: str = "flat",
        topk_density: float = comm.DEFAULT_TOPK_DENSITY,
        comm_overlap="auto",
        guard=None,
    ):
        self.guard = resolve_guard(guard)
        self.comm_hook = comm.validate_hook(comm_hook)
        self.bucket_cap_mb = comm.validate_bucket_cap(bucket_cap_mb)
        comm.validate_topology(comm_topology)
        overlap = comm.normalize_overlap(comm_overlap)
        if overlap is True:
            raise ValueError(
                "comm_overlap=true needs the explicit API (DistributedDataParallel / "
                "train_native.py, mode='shard_map'): the managed path's collective is "
                "XLA-inserted and cannot be issued per backward segment"
            )
        self.comm_overlap_meta = {"enabled": False, "segments": None, "reason": (
            "disabled" if overlap is False else
            "managed path: the gradient collective is XLA-inserted, not issued per segment")}
        if comm_topology != "flat":
            raise ValueError(
                "comm_topology='hierarchical' needs the explicit API "
                "(DistributedDataParallel / train_native.py, mode="
                "'shard_map'): the managed path's collective is XLA-"
                "inserted and cannot be hop-split"
            )
        self.comm_topology = comm_topology
        self.topk_density = float(topk_density)
        comm.bucket_topk(1, self.topk_density)  # the range, checked now
        self.gradient_accumulation_steps = max(1, int(gradient_accumulation_steps))
        self.weight_update_sharding = bool(weight_update_sharding)
        self.clip_grad_norm = None if clip_grad_norm is None else float(clip_grad_norm)
        self.fuse_steps = cfg_lib.resolve_fuse_steps(fuse_steps, self.gradient_accumulation_steps)
        self.process_index = backend.get_rank()
        self.num_processes = backend.get_world_size()
        if device == "cuda":
            if not torch.cuda.is_available():
                raise backend.BackendUnavailableError(
                    "Accelerator on cuda but no GPU is visible; pass device='cpu' "
                    "to run on the CPU"
                )
            # the GPU setup() pinned: the local rank's (the process index on one host)
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.device = torch.device(device)
        self.generator, self.seed = seeding.set_seed_based_on_rank(self.process_index, seed)
        self.jax_keys = seeding.JaxKeyStream(self.seed, self.process_index)
        self.augment = augment
        self._models: List[PreparedModel] = []
        self.last_restore_cursor: Optional[dict] = None  # a step snapshot's, after load_state
        # the last load_state's elastic restore rows (topology_change, ...),
        # which the managed entry point writes after its header
        self.last_restore_events: list = []

    @property
    def is_main_process(self) -> bool:
        return self.process_index == 0

    @property
    def is_local_main_process(self) -> bool:
        return self.process_index == 0

    def next_rng_key(self) -> torch.Generator:
        """A fresh generator split from the process's stream (and a draw
        from the JAX key stream, as the JAX call makes)."""
        self.jax_keys.draw()
        return seeding.split(self.generator)

    def prepare(self, *objects):
        """Wrap modules as :class:`PreparedModel`, optimizers as
        :class:`PreparedOptimizer` bound to the model of the same call, and
        re-create each :class:`DataLoader` as this process's
        :class:`ShardedDataLoader` (batch size per process, HF semantics).
        A loader left out keeps its full stream (the reference's test
        loader)."""
        out, model = [], None
        for obj in objects:
            if isinstance(obj, torch.nn.Module):
                model = PreparedModel(self, obj)
                if self.guard.enabled:  # every process's copy, as broadcast
                    audit_or_raise(model._module, where="accelerator-prepare")
                self._models.append(model)
                out.append(model)
            elif isinstance(obj, PreparedModel):
                model = obj
                out.append(obj)
            elif isinstance(obj, torch.optim.Optimizer):
                out.append(obj)
            elif isinstance(obj, DataLoader):
                out.append(ShardedDataLoader(
                    obj.dataset, obj.batch_size, self.process_index, self.num_processes,
                    shuffle=obj.shuffle, seed=obj.seed,
                ))
            elif isinstance(obj, ShardedDataLoader):
                out.append(obj)
            else:
                raise TypeError(f"cannot prepare object of type {type(obj)!r}")
        for i, obj in enumerate(out):
            if isinstance(obj, torch.optim.Optimizer):
                if model is None:
                    raise ValueError("prepare() got an optimizer but no model")
                if self.weight_update_sharding:
                    obj = ShardedUpdate(
                        obj, list(model._module.parameters()),
                        make_flat_param_spec(model._module, self.num_processes),
                        self.process_index, managed=True,
                    )
                firewall = None
                if self.guard.enabled:
                    firewall = Firewall(self.device)
                    arm_guard(obj, firewall)
                out[i] = model._optimizer = PreparedOptimizer(obj, model, firewall)
        return out[0] if len(out) == 1 else tuple(out)

    def backward(self, loss: LazyLoss) -> None:
        """Forward, backward and gradient sync of ``loss``'s batch (the
        reference's ``accelerator.backward(loss)``)."""
        if not isinstance(loss, LazyLoss):
            raise TypeError(
                "accelerator.backward expects the LazyLoss of a criterion applied to "
                "a prepared model's outputs"
            )
        loss._fwd._model._backward(loss)

    def wait_for_everyone(self) -> None:
        collectives.barrier()

    def gather(self, x) -> torch.Tensor:
        """Every process's ``x`` concatenated along axis 0, on every
        process (queued steps run first)."""
        for model in self._models:
            model._flush_queues()
        t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
        return collectives.process_allgather(t)

    def print(self, *args, **kwargs) -> None:
        if self.is_local_main_process:
            print(*args, **kwargs)

    def save_model(self, model: PreparedModel, save_dir: str):
        """Process 0 writes ``save_dir/model.npz`` (the unwrapped module's
        parameters and buffers in the JAX layout, after the queued steps);
        everyone waits at a barrier."""
        return ckpt.save_model_on_main(save_dir, model.module, self.process_index)

    @staticmethod
    def _discard_staged_work(model: PreparedModel, reason: str) -> None:
        """Drop what was staged against the weights about to be replaced,
        without running it: a backward waiting for ``step()``, queued steps
        (their losses are dropped), a partial accumulation cycle, and every
        captured graph (its replays would write the replaced storage)."""
        if model._pending is not None:
            model._pending.loss._drop(reason)
        if model._staged is not None:
            model._staged._drop(reason)
        model._pending = model._staged = None
        opt = model._optimizer
        if opt is not None:
            for req in opt._queue:
                req.loss._queued_on = None
                req.loss._drop(reason)
            opt._queue = []
            opt._accum, opt._accum_count, opt._cycle_buffers = None, 0, None
            for r in opt._residual or ():  # compression error of the weights replaced
                r.zero_()
        if model._graphs is not None:
            model._graphs.clear()

    def load_model(self, model: PreparedModel, save_dir: str) -> PreparedModel:
        """Restore the weights of ``save_dir/model.npz``; the optimizer's
        state and the comm hook's residual start again from zero, as
        ``tpuddp/accelerate.py:1599-1607`` resets them (moments of other
        weights must not steer these)."""
        self._discard_staged_work(model, "load_model discarded the staged step")
        ckpt.load(os.path.join(save_dir, "model.npz"), model._module, layout=ckpt.MANAGED)
        if model._optimizer is not None:
            model._optimizer.optimizer.state.clear()
            count_from_state(model._optimizer.optimizer)
        return model

    def save_state(self, model: PreparedModel, optimizer: PreparedOptimizer,
                   save_dir: str, epoch: int = 0, keep_last: Optional[int] = None,
                   step: Optional[int] = None, cursor: Optional[dict] = None):
        """Process 0 writes ``save_dir/state_{epoch}.npz``: parameters,
        buffers, the optimizer's state, the comm hook's residual, the guard's
        skip counters, the JAX keys and every process's random streams; with
        ``keep_last`` the older state files are pruned. ``step`` and
        ``cursor`` (``{"plan_key", "acc": {name: array}}``) write the step
        snapshot ``state_{epoch}_s{step}.npz`` with the v4 data cursor
        instead (``tpuddp/accelerate.py:1664-1713``), which :meth:`load_state`
        resumes at that step. Queued steps run first; a partial accumulation
        cycle is refused: it would be lost."""
        model._flush_queues()
        if optimizer._accum_count:
            raise RuntimeError(
                "save_state mid-gradient-accumulation-cycle would silently lose the "
                "partial cycle; call optimizer.flush_accumulation() first (the entry "
                "point's epoch boundary does)"
            )
        cursor_acc = None
        if cursor is not None:
            cursor = dict(cursor)
            cursor.setdefault("version", ckpt.FORMAT_VERSION)
            cursor.setdefault("epoch", int(epoch))
            if step is not None:
                cursor.setdefault("step", int(step))
            cursor_acc = cursor.pop("acc", None)
        return ckpt.save_on_main(
            save_dir, epoch, model._module, optimizer.optimizer, self.process_index,
            layout=ckpt.MANAGED, seed=self.seed, generator=self.generator,
            world_size=self.num_processes, keep_last=keep_last, counter=model._bwd_counter,
            keys=(self.jax_keys.key, model._bwd_key), comm_state=optimizer.comm_residual(),
            skipped=None if optimizer.firewall is None else optimizer.firewall.counters,
            snapshot_step=step, cursor=cursor, cursor_acc=cursor_acc,
        )

    def load_state(self, model: PreparedModel, optimizer: PreparedOptimizer,
                   save_dir: str) -> int:
        """Restore the freshest intact ``state_{epoch}.npz`` (or step
        snapshot ``state_{epoch}_s{step}.npz``) in ``save_dir``; returns the
        epoch to train next (0 when there is none; a step snapshot's own
        epoch, its cursor then in ``last_restore_cursor``, else None). A
        state written at another world size restores onto this one (ZeRO-1's
        flat moments re-padded; the residual is a tree of parameter-shaped
        leaves, the same at every world): its event rows land in
        ``last_restore_events`` (``tpuddp/accelerate.py:1745-1767``)."""
        self._discard_staged_work(model, "load_state discarded the staged step")
        cursors, events = [], []
        next_epoch, meta = ckpt.restore_latest(
            save_dir, model._module, optimizer.optimizer, layout=ckpt.MANAGED,
            generator=self.generator, comm_state=optimizer.comm_residual(),
            skipped=None if optimizer.firewall is None else optimizer.firewall.counters,
            cursor_out=cursors, reshard_log=events,
        )
        self.last_restore_cursor = cursors[-1] if cursors else None
        self.last_restore_events = events
        model._bwd_counter = meta.get("bwd_counter", model._bwd_counter)
        if "rng_key" in meta:
            self.jax_keys.key, model._bwd_key = meta["rng_key"], meta["bwd_key"]
        return next_epoch
