"""Train and eval cores — the counterpart of ``tpuddp/training/step.py``
(``_make_grad_core``/``_make_update_fn`` at 173-420, the accumulation cycle
at 945-1000, the eval core at 737-753, ``finalize_metrics`` at 1224).

A train step is its grad half (:func:`grad_core`: forward -> buffer sync
(the DDP wrap's broadcast of the model's buffers from rank 0) -> weighted
loss -> backward) and its update half (:func:`update_core`: gradient sync
(the DDP wrap's all-reduce mean) -> the optional ``clip_grad_norm`` on the
averaged gradient, the same on every replica (``tpuddp/training/step.py:
406-413``) -> the optimizer). The train forward hands the batch weights to
the model's BatchNorms, so padded rows stay out of their
statistics (``tpuddp/training/step.py:203-207``); eval normalises with the
running statistics. Metrics stay on the device as sums:
``loss_sum = loss * n`` and ``n`` (the batch's real rows) for training,
plus ``correct`` for eval; nothing is read back per batch.
:func:`finalize_metrics` makes one all-reduce of the stacked epoch sums.

:func:`train_cycle` is the native path's gradient accumulation: A
micro-batches through the grad half, their local gradients summed as
``n_i * g_i``, divided by ``sum n_i`` at the cycle boundary, then ONE update
half (one gradient all-reduce, one clip, one optimizer step). All-padding
micro-batches (``n = 0``) add nothing.

:func:`train_many` and :func:`eval_many` are the ``scan_steps`` cores: K
steps (or K / A cycles) and K eval batches as one group, their sums added
to a running sum in step order. They read nothing on the host, so a group
runs as one CUDA graph too (``training/graphs.py``); each step's flip mask
is an input, drawn before the group.

Under ``weight_update_sharding`` (ZeRO-1) the optimizer is a
:class:`tpuddp_torch.optim.ShardedUpdate` over the flat layout of
:func:`make_flat_param_spec` (``tpuddp/training/step.py:50-97``), and its
``step()`` is the whole update half of ``tpuddp/training/step.py:291-366``:
flatten the gradients, reduce-scatter, divide by the world size, clip,
update the shard, all-gather. The DDP wrap then passes no gradient sync and
no clip to these cores; everything else is unchanged.

With a comm hook (:mod:`tpuddp_torch.parallel.comm`), or under
``comm_topology: hierarchical`` with any hook, the DDP wrap's
gradient sync is :func:`comm_sync`, the exchange of
``tpuddp/training/step.py:390-396`` in its order of operations: flatten the
gradients in the JAX package's flat order, add the error-feedback residual,
compress, sum and decompress per bucket (hierarchically: the three hops
of :meth:`~tpuddp_torch.parallel.comm.GradComm.reduce_hierarchical`),
divide by the world size, keep ``send - kept`` as the new residual,
unflatten; the clip (on the
decompressed mean) and the optimizer follow as before. Under accumulation
it runs once per cycle, at its boundary; under ZeRO-1 the wrapped
optimizer's reduce-scatter is the hooked one.

The segmented-overlap step (``comm_overlap``; ``tpuddp/training/step.py:
486-733, :930-1040``) is :class:`SegmentedSync`: the same exchange cut
into the JAX package's backward segments (:func:`~tpuddp_torch.parallel.
comm.make_segments`), each issued from a gradient hook as soon as its
segment's gradients have landed in backward, on a side stream of the card
while backward goes on. The cores take it as ``overlap``: it is armed just
before the backward that ends a step (or a cycle, whose last micro-batch
then folds ``(acc + n g) / denom`` per segment inside the hook, as the JAX
package's accumulation peel does), and joined in place of ``sync_grads``
before the clip. Only the order in which the work is issued changes: the
step is bitwise the barrier step.

The numerical guard's firewall (``training.guard``, ``tpuddp/training/
step.py:231-254, :355-416``) is the cores' ``firewall``, a
:class:`~tpuddp_torch.resilience.guard.Firewall`: after the exchange (after
the join of the segmented step) the verdict is taken on the aggregated
float32 gradient, before the clip and any quantisation (under ZeRO-1 the
wrapped optimizer's step takes it from its shard); the optimizer reads it;
the hook's new residual, which the exchange wrote into the firewall's
staging vector (every segment's span of it), lands only where it is 1; the
BatchNorm buffers go back to their values before the step (before the
cycle under accumulation, ``:960-1066``) where it is 0; the skip counters
advance. All of it happens on the device, so a chunk replays whole.
"""

from __future__ import annotations

import math
import weakref
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpuddp_torch.nn.norm import batch_weights
from tpuddp_torch.optim import clip_grad_norm_
from tpuddp_torch.parallel import collectives

TRAIN_KEYS = ("loss_sum", "n")
EVAL_KEYS = ("loss_sum", "correct", "n")


class FlatParamSpec(NamedTuple):
    """The flat layout of weight-update sharding (the JAX package's
    ``FlatParamSpec``): the model's parameters in ``model.parameters()``
    order, each raveled as PyTorch stores it, as ONE float32 vector
    zero-padded from ``raw`` to ``total = world * ceil(raw / world)``
    elements, as the JAX spec pads, so each of ``world`` replicas owns an
    equal contiguous shard. The JAX package orders the same vector by its
    tree's leaves, each in its own layout;
    :func:`tpuddp_torch.models.convert.flat_to_jax` and ``flat_from_jax``
    permute between the two (exactly), which checkpoints pay. The port's
    order lets the parameters be views into the vector, so a step needs no
    permute."""

    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]
    raw: int
    total: int
    world: int

    @property
    def shard_n(self) -> int:
        return self.total // self.world

    @property
    def ends(self) -> Tuple[int, ...]:
        """Where each parameter's elements end in the vector."""
        return tuple(int(e) for e in np.cumsum(self.sizes))

    def check(self, params: Sequence[torch.Tensor]) -> None:
        shapes = tuple(tuple(p.shape) for p in params)
        if shapes != self.shapes:
            raise ValueError(f"parameters of shapes {shapes} for a flat spec of {self.shapes}")

    def flatten(self, tensors: Sequence[torch.Tensor], out: torch.Tensor) -> torch.Tensor:
        """``tensors`` (one per parameter) raveled into ``out``'s first
        ``raw`` elements, in one copy (``_tree_to_vec``); the padding is
        left as it is."""
        torch.cat([t.reshape(-1) for t in tensors], out=out[:self.raw])
        return out

    def views(self, vec: torch.Tensor):
        """Each parameter's shaped view into ``vec`` (``_vec_to_tree``)."""
        out, offset = [], 0
        for shape, size in zip(self.shapes, self.sizes):
            out.append(vec[offset:offset + size].view(shape))
            offset += size
        return out


def make_flat_param_spec(model: torch.nn.Module, world: int) -> FlatParamSpec:
    """The flat layout of ``model``'s parameters over ``world`` replicas;
    a parameter that is not float32 is the JAX package's ``ValueError``."""
    shapes, sizes = [], []
    for i, p in enumerate(model.parameters()):
        if p.dtype != torch.float32:
            raise ValueError(
                "weight_update_sharding flattens parameters into one f32 vector; leaf "
                f"{i} has dtype {p.dtype} (tpuddp keeps f32 master params — mixed compute "
                "dtypes live in activations, not parameters)"
            )
        shapes.append(tuple(p.shape))
        sizes.append(p.numel())
    raw = sum(sizes)
    total = world * math.ceil(raw / world)
    return FlatParamSpec(tuple(shapes), tuple(sizes), raw, total, int(world))


def grad_core(
    model, optimizer, criterion, augment: Optional[Callable], sync_buffers: Callable,
    x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, flip_mask: Optional[torch.Tensor] = None,
    arm: Optional[Callable] = None,
):
    """Forward and backward of one batch; the replica's local weighted-mean
    gradient replaces each parameter's ``.grad``. Returns the on-device
    ``(loss, n)``. Without ``flip_mask`` the augment draws its own.
    ``arm(loss, n)``, when given, runs just before the backward (it arms
    the segmented exchange)."""
    model.train()
    if augment is not None:
        x = augment(x) if flip_mask is None else augment(x, flip_mask=flip_mask)
    with batch_weights(model, w):
        logits = model(x)
    sync_buffers()
    loss = criterion(logits, y, w)
    n = w.sum()
    optimizer.zero_grad(set_to_none=True)
    if arm is not None:
        arm(loss.detach(), n)
    loss.backward()
    return loss.detach(), n


@torch.no_grad()
def comm_sync(params: Sequence[torch.Tensor], comm, order, residual: Optional[torch.Tensor],
              lost: Optional[torch.Tensor] = None, groups=None) -> None:
    """The hooked gradient exchange: each parameter's ``.grad`` (None counts
    as zeros) flattened into one vector in the JAX order (``order``, a
    :class:`~tpuddp_torch.models.convert.JaxFlatOrder`) and zero-padded to
    ``comm.total``, through ``comm.reduce`` (``residual`` updated in place,
    or the new one written into ``lost``), then each ``.grad`` set to its
    view of the mean, in the port's order. With ``groups = (local_group,
    host_group)`` (``comm_topology: hierarchical``) the exchange is
    ``comm.reduce_hierarchical`` over them instead, the JAX package's
    ``tpuddp/training/step.py:379-384``."""
    port = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    g_vec = order.to_jax(port)
    if comm.total > order.raw:
        g_vec = torch.cat([g_vec, g_vec.new_zeros(comm.total - order.raw)])
    if groups is None:
        reduced, _ = comm.reduce(g_vec, residual, lost)
    else:
        reduced, _ = comm.reduce_hierarchical(g_vec, residual, *groups, lost)
    flat, offset = order.from_jax(reduced), 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()


class SegmentedSync:
    """The segmented-overlap exchange of one DDP wrap: the counterpart of
    ``_segmented_exchange`` (``tpuddp/training/step.py:629-677``).

    ``segments`` are the plan's :class:`~tpuddp_torch.parallel.comm.
    CommSegment` for ``model``, ``spans`` each one's port parameters ``[first, end)``
    (:func:`~tpuddp_torch.models.convert.jax_param_span`) and ``orders``
    (with a hook; None for ``none``) each one's :class:`~tpuddp_torch.
    models.convert.JaxFlatOrder`; ``comm`` is the hook's plan (None for
    ``none``), ``residual`` its error-feedback vector (updated in place;
    under the guard each segment writes its span of ``staged`` instead, the
    firewall's staging vector, which the verdict lands after the join).

    A hook on every parameter counts the gradients that land in an armed
    backward; when a segment's last one has landed, the segment is
    exchanged: its gradients gathered into its span of the JAX order (the
    padding on the last segment), its residual span added, its buckets
    through :meth:`~tpuddp_torch.parallel.comm.GradComm.exchange_segment`,
    the sum divided by the world size and written back into each ``.grad``
    as a view of one flat vector in the port's order, as
    :func:`comm_sync` leaves them; with hook ``none`` the segment's
    gradients go through the all-reduce mean (nothing at world 1). Under a
    fold ``(acc, n, denom)`` each gradient first becomes ``(acc + n g) /
    denom``, the two operations of :func:`train_cycle`'s barrier fold.
    :meth:`join` exchanges any segment whose gradients did not all land (a
    parameter without a gradient counts as zeros, as in :func:`comm_sync`),
    last segment first, and disarms. ``counts`` says how many segment
    exchanges were issued from the backward (``"hook"``) and how many at the
    join (host counts: a CUDA-graph replay adds none).

    On the card the exchange runs on ``stream``, forked from the stream the
    gradient landed on and joined by the current stream in :meth:`join`, so
    inside a CUDA-graph capture every fork joins before the capture ends.
    What the side stream reads is kept alive until that join, and what the
    current stream reads afterwards is allocated on it before the fork.
    Hooks fire in the autograd engine's order, the same on every replica,
    so the segment collectives (and SyncBN's backward all-reduces) are
    issued in one order everywhere. The hooks reach this object through a
    weak reference, so a dropped wrap frees its model and its memory
    without waiting for the garbage collector."""

    def __init__(self, model, segments, spans, orders, comm, residual: Optional[torch.Tensor],
                 world: int, stream=None):
        self.model = model
        self.params = list(model.parameters())
        self.segments = tuple(segments)
        self.orders = orders
        self.comm = comm
        self.residual = residual
        self.staged: Optional[torch.Tensor] = None  # the guard's, set by the wrap
        self.world = int(world)
        self.stream = stream
        self.counts = {"hook": 0, "join": 0}
        self.raw = sum(p.numel() for p in self.params)
        self._members = [self.params[a:b] for a, b in spans]
        self._first = [a for a, _ in spans]
        ends = np.cumsum([0] + [p.numel() for p in self.params])
        self._port_lo = [int(ends[a]) for a, _ in spans]
        self._armed = False
        self._left = self._done = self._fold = self._flat = None
        self._forked = False
        self._held = []
        ref = weakref.ref(self)

        def hook(k):
            def landed(_param):
                sync = ref()
                if sync is not None:
                    sync._landed(k)
            return landed

        for k, members in enumerate(self._members):
            for p in members:
                if p.requires_grad:
                    p.register_post_accumulate_grad_hook(hook(k))

    def arm(self, fold=None) -> None:
        """Before the backward that ends a step, or a cycle with ``fold =
        (acc, n, denom)``: each segment's count starts anew."""
        if any(p is not q for p, q in zip(self.model.parameters(), self.params)):
            raise RuntimeError(
                "a parameter of the model was replaced after the DDP wrap (its gradient hook "
                "stays on the old one); wrap the model again")
        self._left = [sum(p.requires_grad for p in m) for m in self._members]
        self._done = [False] * len(self.segments)
        self._forked = False
        self._fold = fold
        # the hooked mean's port-order vector, on the current stream: the
        # gradients become views into it, read after the join
        self._flat = None if self.comm is None else torch.empty(
            self.raw, dtype=torch.float32, device=self.params[0].device)
        self._armed = True

    def _landed(self, k: int) -> None:
        if not self._armed:
            return
        self._left[k] -= 1
        if self._left[k] == 0:
            self.counts["hook"] += 1
            self._exchange(k)

    def join(self) -> None:
        """After the backward: the segments not yet exchanged (last first),
        then the current stream waits for the side stream; disarms."""
        if not self._armed:
            raise RuntimeError("SegmentedSync.join without an armed backward")
        for k in reversed(range(len(self.segments))):
            if not self._done[k]:
                self.counts["join"] += 1
                self._exchange(k)
        if self._forked:  # (a stream that never forked is not in a capture)
            torch.cuda.current_stream(self.stream.device).wait_stream(self.stream)
        self._held.clear()
        self._armed, self._fold, self._flat = False, None, None

    def _mean(self, flat: torch.Tensor) -> None:
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        flat.div_(self.world)

    def _folded(self, k: int, grads):
        """The segment's gradients under the cycle's fold (as they are
        without one)."""
        if self._fold is None:
            return grads
        acc, n, denom = self._fold
        first = self._first[k]
        out = []
        for i, g in enumerate(grads):
            a = acc[first + i]
            if g is None:
                out.append(None if a is None else a / denom)
            else:
                out.append((n * g if a is None else a + n * g) / denom)
        return out

    @torch.no_grad()
    def _exchange(self, k: int) -> None:
        self._done[k] = True
        members = self._members[k]
        grads = [p.grad for p in members]
        if self.comm is None and self.world == 1:  # the mean is the identity
            if self._fold is not None:
                for p, g in zip(members, self._folded(k, grads)):
                    p.grad = g
            return
        if self.stream is not None:
            self.stream.wait_stream(torch.cuda.current_stream(self.stream.device))
            self._forked = True
        # read on the side stream: alive until the join
        self._held.append((grads, self._fold))
        with torch.cuda.stream(self.stream):
            grads = self._folded(k, grads)
            if self.comm is None:
                # the segment's slice of the flat all-reduce mean, in place
                present = [g for g in grads if g is not None]
                if present:
                    collectives.flat_collective(present, self._mean)
                for p, g in zip(members, grads):
                    p.grad = g
                return
            seg, order = self.segments[k], self.orders[k]
            lo, hi = seg.flat
            port = torch.cat([(g if g is not None else torch.zeros_like(p)).reshape(-1)
                              for p, g in zip(members, grads)])
            g_vec = order.to_jax(port)
            if hi - lo > order.raw:  # the padding rides the last segment
                g_vec = torch.cat([g_vec, g_vec.new_zeros(hi - lo - order.raw)])
            residual = None if self.residual is None else self.residual[lo:hi]
            send = g_vec if residual is None else g_vec + residual
            lost = residual if self.staged is None else self.staged[lo:hi]
            summed = self.comm.exchange_segment(send, seg, lost if self.comm.needs_residual else None)
            if self.world > 1:
                summed = summed / self.world
            lo_port = self._port_lo[k]
            flat = order.from_jax(summed, out=self._flat[lo_port:lo_port + order.raw])
        offset = 0
        for p in members:
            p.grad = flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()


def update_core(optimizer, sync_grads: Callable, clip: Optional[float] = None,
                firewall=None) -> None:
    """The gradient all-reduce, the clip to global norm ``clip`` (if any),
    then one optimizer update. With ``firewall`` the update is guarded: the
    verdict of the exchanged gradient before the clip (unless the optimizer
    makes it, ZeRO-1), the update gated on it, then the residual and the
    counters (:meth:`~tpuddp_torch.resilience.guard.Firewall.commit`)."""
    sync_grads()
    params = [p for g in optimizer.param_groups for p in g["params"]]
    if firewall is not None and not getattr(optimizer, "judges", False):
        firewall.judge([p.grad for p in params if p.grad is not None])
    if clip is not None:
        clip_grad_norm_(params, clip)
    optimizer.step()
    if firewall is not None:
        firewall.commit()


def train_core(
    model, optimizer, criterion, augment: Optional[Callable], sync_grads: Callable,
    sync_buffers: Callable, x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
    clip: Optional[float] = None, flip_mask: Optional[torch.Tensor] = None,
    overlap: Optional[SegmentedSync] = None, firewall=None,
) -> torch.Tensor:
    """One train step; returns the on-device sums ``[loss_sum, n]``. With
    ``overlap`` its segmented exchange replaces ``sync_grads``; with
    ``firewall`` the update is guarded and a skipped step's buffers revert."""
    saved = None if firewall is None else firewall.save_buffers(model)
    arm = None if overlap is None else (lambda loss, n: overlap.arm())
    loss, n = grad_core(model, optimizer, criterion, augment, sync_buffers, x, y, w, flip_mask, arm)
    update_core(optimizer, sync_grads if overlap is None else overlap.join, clip, firewall)
    if saved is not None:
        firewall.restore_buffers(model, saved)
    return torch.stack([loss * n, n])


def _add_step(sums, loss, n):
    step = torch.stack([loss * n, n])
    return step if sums is None else sums + step


def _denom(sums):
    return torch.where(sums[1] == 0, torch.ones_like(sums[1]), sums[1])


def train_cycle(
    model, optimizer, criterion, augment: Optional[Callable], sync_grads: Callable,
    sync_buffers: Callable, batches: Sequence, clip: Optional[float] = None,
    flip_masks: Optional[Sequence] = None, overlap: Optional[SegmentedSync] = None,
    firewall=None,
) -> torch.Tensor:
    """One accumulation cycle over the device batches ``(x, y, w)`` of
    ``batches``: ``sum n_i g_i / sum n_i`` (the mean gradient of their
    concatenation on this replica; the all-padding case divides by 1), then
    one update. Returns the cycle's on-device sums ``[loss_sum, n]``. With
    ``overlap`` the last micro-batch's backward folds each segment and
    issues its exchange (``tpuddp/training/step.py:1001-1019``), in place
    of the fold after the cycle and ``sync_grads``. With ``firewall`` the
    update is guarded and a skipped cycle's buffers revert to their values
    before its first micro-batch."""
    saved = None if firewall is None else firewall.save_buffers(model)
    params = list(model.parameters())
    acc = [None] * len(params)
    sums = None
    masks = flip_masks or [None] * len(batches)
    for j, ((x, y, w), mask) in enumerate(zip(batches, masks)):
        arm = None
        if overlap is not None and j == len(batches) - 1:
            def arm(loss, n):
                overlap.arm(fold=(acc, n, _denom(_add_step(sums, loss, n))))
        loss, n = grad_core(model, optimizer, criterion, augment, sync_buffers, x, y, w, mask, arm)
        if arm is None:
            for i, p in enumerate(params):
                if p.grad is not None:
                    acc[i] = n * p.grad if acc[i] is None else acc[i] + n * p.grad
        sums = _add_step(sums, loss, n)
    if overlap is None:
        denom = _denom(sums)
        for p, a in zip(params, acc):
            p.grad = None if a is None else a / denom
    update_core(optimizer, sync_grads if overlap is None else overlap.join, clip, firewall)
    if saved is not None:
        firewall.restore_buffers(model, saved)
    return sums


def train_many(
    model, optimizer, criterion, augment: Optional[Callable], sync_grads: Callable,
    sync_buffers: Callable, sums: torch.Tensor, batches: Sequence, flip_masks: Sequence,
    clip: Optional[float] = None, accum: int = 1, overlap: Optional[SegmentedSync] = None,
    firewall=None,
) -> torch.Tensor:
    """K train steps on the device batches (K / ``accum`` accumulation
    cycles), each step's flip mask given: the counterpart of
    ``build_train_scan_step`` (``tpuddp/training/step.py:840-1100``).
    Returns ``sums`` plus each step's (each cycle's) sums, added in order,
    as the per-batch loop adds them; each update guarded with ``firewall``."""
    for i in range(0, len(batches), accum):
        if accum == 1:
            x, y, w = batches[i]
            step = train_core(model, optimizer, criterion, augment, sync_grads, sync_buffers,
                              x, y, w, clip, flip_masks[i], overlap, firewall)
        else:
            step = train_cycle(model, optimizer, criterion, augment, sync_grads, sync_buffers,
                               batches[i:i + accum], clip, flip_masks[i:i + accum], overlap,
                               firewall)
        sums = sums + step
    return sums


@torch.no_grad()
def eval_core(
    model, criterion, transform: Optional[Callable],
    x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
) -> torch.Tensor:
    """One eval step; returns the on-device sums ``[loss_sum, correct, n]``."""
    model.eval()
    if transform is not None:
        x = transform(x)
    logits = model(x)
    loss = criterion(logits, y, w)
    n = w.sum()
    correct = ((logits.argmax(dim=-1) == y) * w).sum()
    return torch.stack([loss * n, correct, n])


def eval_many(model, criterion, transform: Optional[Callable], sums: torch.Tensor,
              batches: Sequence) -> torch.Tensor:
    """K eval steps: ``sums`` plus each batch's sums, added in order (the
    counterpart of ``build_eval_scan_step``,
    ``tpuddp/training/step.py:1155-1185``)."""
    for x, y, w in batches:
        sums = sums + eval_core(model, criterion, transform, x, y, w)
    return sums


def finalize_metrics(train_sums: torch.Tensor, eval_sums: torch.Tensor) -> Dict[str, Dict[str, float]]:
    """Epoch-end aggregation: ONE all-reduce (SUM) of the stacked epoch sums
    over the process group, then one host read."""
    stacked = torch.cat([train_sums, eval_sums])
    if dist.is_initialized():
        dist.all_reduce(stacked, op=dist.ReduceOp.SUM)
    values = stacked.tolist()
    return {
        "train": dict(zip(TRAIN_KEYS, values[: len(TRAIN_KEYS)])),
        "eval": dict(zip(EVAL_KEYS, values[len(TRAIN_KEYS) :])),
    }
