"""Gradient-communication hooks — the port's copy of the flat topology of
``tpuddp/parallel/comm.py`` (torch DDP's ``bf16_compress_hook`` and its
kin, with error feedback).

The gradient is one float32 vector, zero-padded to a multiple of the world
size, split into size-capped contiguous **buckets** (``bucket_cap_mb``,
whole leaves packed greedily in the JAX package's tree order,
:func:`make_buckets`), and each bucket goes through the **hook**:

- ``none``: the plain all-reduce mean (no plan is built);
- ``bf16``: the bucket cast to bf16, summed across replicas in bf16,
  decompressed to float32, divided by the world size;
- ``bf16_ef``: ``bf16`` plus **error feedback**: each replica keeps a
  residual of what compression dropped and adds it to its next send;
- ``int8_ef``: per-bucket max-abs symmetric int8 codes and one float32
  scale, all-gathered and dequantised and summed in rank order on every
  replica, with the residual;
- ``topk_ef``: the ``topk_density`` largest-magnitude elements of each
  bucket, int8-quantised against the whole bucket's scale, their int32
  indices, all-gathered and scatter-added in rank order; the unsent rest
  and the rounding fold into the residual.

At world 1 the collectives are the identity, but the compression and the
residual run all the same, as the JAX package's ``shard_map`` step runs
them on one device.

The native path (:class:`~tpuddp_torch.parallel.ddp.DistributedDataParallel`)
exchanges the gradient in the JAX package's flat order
(:class:`~tpuddp_torch.models.convert.JaxFlatOrder`): the buckets are then
the JAX package's, which matters for the int8 scales and the top-k sets, and
the residual is bitwise its layout. Under ZeRO-1 (:meth:`GradComm.
reduce_scatter`) the whole vector is one bucket, whose scale and top-k set
do not depend on the order, so the port's own flat order serves. The
managed path (:func:`local_quantize`) round-trips the already all-reduced
gradient, each parameter its own bucket; the byte counter says the wire
carried float32 there (``wire=False``).

The segmented-overlap step (``comm_overlap``; :func:`make_segments`,
:meth:`GradComm.exchange_segment`, ``tpuddp/parallel/comm.py:233-300,
:393-414``) cuts the flat vector into backward **segments**: runs of the
JAX package's ``Sequential`` children whose span is a union of whole
buckets, so each segment's exchange can be issued as soon as its gradients
land in backward, bucket for bucket the barrier step's arithmetic
(:class:`~tpuddp_torch.training.step.SegmentedSync`).

The hierarchical topology (``comm_topology: hierarchical``;
:meth:`GradComm.reduce_hierarchical`, ``tpuddp/parallel/comm.py:433-475``)
runs the exchange in three hops over the groups of
:mod:`tpuddp_torch.parallel.mesh`: a float32 reduce-scatter over the local
group, the shard as ONE bucket through the hook over the host group (a
float32 all-reduce with hook ``none``, whose plan is then built all the
same: ``make_grad_comm(force=True)``), and an all-gather over the local
group. Only the middle hop is lossy, and its error is this replica's
residual at its shard's offset, zeros elsewhere.
:func:`comm_bytes_breakdown` splits one reduction's bytes between the
intra-host and the inter-host link.

A residual saved at one world size is restored at another by
:func:`redistribute_residual` (the elastic restore of
:mod:`tpuddp_torch.training.checkpoint`), which keeps the sum over the
replicas where whole rows allow it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from tpuddp_torch.parallel import collectives as col

COMM_HOOKS = ("none", "bf16", "bf16_ef", "int8_ef", "topk_ef")

# hooks that carry the error-feedback residual
EF_HOOKS = ("bf16_ef", "int8_ef", "topk_ef")

# torch DDP's bucket_cap_mb default
DEFAULT_BUCKET_CAP_MB = 25

# topk_ef's default: the top 10% of each bucket by magnitude
DEFAULT_TOPK_DENSITY = 0.1

_WIRE_DTYPES = {"bf16": torch.bfloat16, "bf16_ef": torch.bfloat16}
_F32_BYTES = 4
_INT8_BYTES = 1
_IDX_BYTES = 4  # top-k indices travel as int32
_SCALE_BYTES = 4  # one float32 scale per bucket

COMM_TOPOLOGIES = ("flat", "hierarchical")


def wire_dtype(hook: str) -> torch.dtype:
    """The dtype of a dense hook's collective (float32 for ``none``)."""
    return _WIRE_DTYPES.get(hook, torch.float32)


def wire_itemsize(hook: str) -> int:
    return torch.empty((), dtype=wire_dtype(hook)).element_size()


def validate_hook(hook: str) -> str:
    if hook not in COMM_HOOKS:
        raise ValueError(f"unknown comm_hook {hook!r}; one of {COMM_HOOKS}")
    return hook


def validate_topology(topology: str) -> str:
    if topology not in COMM_TOPOLOGIES:
        raise ValueError(f"unknown comm_topology {topology!r}; one of {COMM_TOPOLOGIES}")
    return topology


def normalize_overlap(value):
    """The ``comm_overlap`` knob as True, False or ``"auto"`` (None is
    ``"auto"``; YAML gives booleans, command-line overrides strings), as
    ``tpuddp/parallel/ddp.py:44-61`` reads it; anything else is its
    ``ValueError``."""
    if value is True or value is False:
        return value
    if value is None:
        return "auto"
    if isinstance(value, str):
        v = value.strip().lower()
        if v == "auto":
            return "auto"
        if v in ("true", "1", "on", "yes"):
            return True
        if v in ("false", "0", "off", "no"):
            return False
    raise ValueError(f"comm_overlap must be true, false, or 'auto'; got {value!r}")


def validate_bucket_cap(bucket_cap_mb) -> float:
    if not float(bucket_cap_mb) > 0:
        raise ValueError(f"bucket_cap_mb must be > 0, got {bucket_cap_mb!r}")
    return float(bucket_cap_mb)


def loss_parity_tol(hook: str, base_loss: float) -> float:
    """A hook's loss bound against the uncompressed run
    (``tpuddp/parallel/comm.py:152-167``): ``max(0.05, 0.02 |base|)`` for
    the dense hooks, ``max(0.35, 0.25 |base|)`` for ``topk_ef``, whose
    residual holds most of the gradient for its first O(1 / density)
    steps."""
    validate_hook(hook)
    if hook == "topk_ef":
        return max(0.35, 0.25 * abs(base_loss))
    return max(0.05, 0.02 * abs(base_loss))


def bucket_topk(size: int, density: float) -> int:
    """Elements topk_ef keeps of a ``size``-element bucket: ``density`` of it,
    floored, never below 1."""
    if not (0.0 < density <= 1.0):
        raise ValueError(f"topk density must be in (0, 1], got {density!r}")
    return max(1, int(size * density))


# ------------------------------------------------- int8 / top-k primitives --


def quantize_int8(b: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 codes of ``b`` against ``scale`` (= max|b| / 127),
    rounded half to even. An all-zero bucket (scale 0) sends zeros; a
    non-finite scale is not guarded, so dequantising a bucket that held a
    NaN or an Inf gives NaN at every element: the NaN reaches the numerical
    guard's verdict through the scale, whatever code a NaN element's cast
    to int8 gives (PyTorch leaves that cast undefined)."""
    denom = torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.clamp(torch.round(b / denom), -127, 127).to(torch.int8)


# float32(1 / 127): the JAX package's ``max|b| / 127.0`` compiles (XLA)
# into a multiplication by this reciprocal
_INV_127 = torch.tensor(1 / 127, dtype=torch.float32).item()


def int8_scale(b: torch.Tensor) -> torch.Tensor:
    """The bucket's max-abs scale over 127 (a float32 scalar on its
    device), as the JAX package's compiled steps compute it: ``max|b|``
    times float32(1 / 127). A NaN or an Inf in the bucket makes it
    non-finite."""
    return b.abs().amax() * _INV_127


def make_buckets(sizes: Sequence[int], total: int,
                 bucket_cap_mb: float = DEFAULT_BUCKET_CAP_MB) -> Tuple[Tuple[int, int], ...]:
    """Partition ``[0, total)`` into contiguous ``(start, end)`` buckets of
    whole leaves of ``sizes`` (in order), packed greedily up to
    ``bucket_cap_mb`` of float32; a leaf over the cap gets a bucket of its
    own, and the last bucket takes the padding up to ``total``."""
    validate_bucket_cap(bucket_cap_mb)
    cap_elems = max(1, int(bucket_cap_mb * 1024 * 1024) // _F32_BYTES)
    buckets = []
    start = cursor = filled = 0
    for size in sizes:
        if filled and filled + size > cap_elems:
            buckets.append((start, cursor))
            start, filled = cursor, 0
        cursor += size
        filled += size
    if cursor < total or filled or start < total:
        buckets.append((start, total))
    assert buckets and buckets[0][0] == 0 and buckets[-1][1] == total
    return tuple(buckets)


class CommSegment(NamedTuple):
    """One backward segment of the segmented-overlap step: the children
    ``[layers[0], layers[1])`` of the JAX package's ``Sequential``, whose
    span ``[flat[0], flat[1])`` of the padded vector is exactly the union of
    ``buckets`` (absolute ``(start, end)`` slices), so its exchange never
    splits a bucket."""

    layers: Tuple[int, int]
    flat: Tuple[int, int]
    buckets: Tuple[Tuple[int, int], ...]


def make_segments(layer_sizes: Sequence[int], buckets: Sequence[Tuple[int, int]],
                  total: int) -> Tuple[CommSegment, ...]:
    """The backward segments of a ``Sequential`` whose child ``i`` holds
    ``layer_sizes[i]`` elements (in the JAX tree order) over ``buckets`` of
    the vector padded to ``total`` (``tpuddp/parallel/comm.py:252-300``): a
    segment boundary at every child boundary that is also a bucket edge, so
    a bucket that straddles two children fuses them into one segment;
    parameter-free children join the segment before them (trailing ones
    the last), and the padding rides the last segment."""
    offsets = [0]
    for n in layer_sizes:
        offsets.append(offsets[-1] + int(n))
    if offsets[-1] > total:
        raise ValueError(f"layer sizes sum to {offsets[-1]} > padded total {total}")
    offsets[-1] = total
    edges = {s for s, _ in buckets} | {e for _, e in buckets}
    bounds = [0]
    for off in offsets[1:-1]:
        if off > bounds[-1] and off in edges:
            bounds.append(off)
    if total > bounds[-1] or bounds == [0]:
        bounds.append(total)
    segs, cursor, n_layers = [], 0, len(layer_sizes)
    for lo, hi in zip(bounds, bounds[1:]):
        first = cursor
        while cursor < n_layers and offsets[cursor + 1] <= hi:
            cursor += 1
        segs.append(CommSegment((first, cursor), (lo, hi),
                                tuple(b for b in buckets if lo <= b[0] and b[1] <= hi)))
    segs[-1] = segs[-1]._replace(layers=(segs[-1].layers[0], n_layers))
    assert sum(len(s.buckets) for s in segs) == len(buckets)
    return tuple(segs)


def _int8_lost(b: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``b - q * scale`` rounded once to float32, as the JAX package's
    compiled step computes it (XLA contracts the product and the difference
    into one fused multiply-add). The float64 product and difference are
    exact: ``q * scale`` has at most 31 significant bits, and where ``q`` is
    not 0, ``|b|`` is within a factor 256 of ``scale``."""
    return (b.double() - q.double() * scale.double()).float()


def _topk(b: torch.Tensor, density: float) -> torch.Tensor:
    """The indices of the ``bucket_topk`` largest |b| (int64, in no
    particular order). A NaN ranks above every number, as in ``lax.top_k``,
    on the CPU and on the card alike."""
    return torch.topk(b.abs(), bucket_topk(b.numel(), density), sorted=False).indices


class GradComm(NamedTuple):
    """The comm plan of one (model, world, hook): the leaf sizes in the
    exchange's order, the padded length ``total``, the buckets, the hook,
    the world size and the top-k density (ignored by the dense hooks)."""

    sizes: Tuple[int, ...]
    total: int
    buckets: Tuple[Tuple[int, int], ...]
    hook: str
    world: int
    density: float = DEFAULT_TOPK_DENSITY

    @property
    def needs_residual(self) -> bool:
        return self.hook in EF_HOOKS

    def init_residual(self, device=None) -> Optional[torch.Tensor]:
        """This replica's zero residual, ``(total,)`` float32 (its slice of
        the JAX package's ``(world * total,)`` vector); None without error
        feedback."""
        if not self.needs_residual:
            return None
        return torch.zeros(self.total, dtype=torch.float32, device=device)

    def _exchange_bucket(self, b: torch.Tensor, lost: Optional[torch.Tensor] = None,
                         group=None) -> torch.Tensor:
        """One bucket of this replica's send through the hook's wire format:
        returns the SUM over the replicas of ``group`` (the whole world
        when None) of each one's decompressed payload, and writes ``b -
        kept``, what the send lost in the round trip, into ``lost`` when it
        is given. A group of one skips the collective."""
        single = (self.world if group is None else col.group_size(group)) == 1
        if self.hook in ("bf16", "bf16_ef"):
            comp = b.to(wire_dtype(self.hook))
            kept = comp.float()
            if lost is not None:
                torch.sub(b, kept, out=lost)
            return kept if single else col.all_reduce_wire(comp, group).float()
        scale = int8_scale(b)
        if self.hook == "int8_ef":
            q = quantize_int8(b, scale)
            if lost is not None:
                lost.copy_(_int8_lost(b, q, scale))
            return q.float() * scale if single else col.allgather_dequant_sum(q, scale, group)
        if self.hook == "topk_ef":
            # the whole bucket's scale: top-k holds the max of a finite
            # bucket, and a NaN anywhere must poison the payload
            idx = _topk(b, self.density)
            q = quantize_int8(b.index_select(0, idx), scale)
            kept = torch.zeros_like(b).index_copy_(0, idx, q.float() * scale)
            if lost is not None:
                torch.sub(b, kept, out=lost)
            return kept if single else col.allgather_topk_sum(idx, q, scale, b.numel(), group)
        raise AssertionError(f"hook {self.hook!r} has no exchange")

    def _exchange_span(self, send: torch.Tensor, lo: int, buckets, lost: Optional[torch.Tensor]):
        """The buckets of a span starting at ``lo`` through the exchange,
        reassembled; ``send`` and ``lost`` (when given, receiving each
        bucket's loss) hold the span's elements."""
        sums = [self._exchange_bucket(send[s - lo:e - lo], None if lost is None else lost[s - lo:e - lo])
                for s, e in buckets]
        return sums[0] if len(sums) == 1 else torch.cat(sums)

    def _compressed_sum(self, send: torch.Tensor, lost: Optional[torch.Tensor]) -> torch.Tensor:
        """The padded vector through the bucketed exchange, reassembled;
        ``lost`` (when given) receives each bucket's loss."""
        return self._exchange_span(send, 0, self.buckets, lost)

    def exchange_segment(self, send: torch.Tensor, seg: CommSegment,
                         lost: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One segment's slice of the bucketed exchange: ``send`` is the
        segment's ``seg.flat`` span of this replica's send vector; returns
        the SUM over replicas of its buckets' payloads, element for element
        that span of what :meth:`reduce` sums over the whole vector, and
        writes each bucket's loss into ``lost`` (the segment's span of the
        residual) when it is given."""
        return self._exchange_span(send, seg.flat[0], seg.buckets, lost)

    def reduce(self, g_vec: torch.Tensor, residual: Optional[torch.Tensor],
               lost: Optional[torch.Tensor] = None):
        """The bucketed hook pipeline on this replica's padded gradient
        vector ``g_vec`` (``(total,)``, the exchange's order): returns the
        cross-replica MEAN vector and the residual, which becomes ``send -
        kept`` with ``send = g_vec + residual``, written in place, or into
        ``lost`` when it is given (the numerical guard's staging vector: the
        residual then stays as it is)."""
        send = g_vec if residual is None else g_vec + residual
        lost = residual if lost is None else lost
        reduced = self._compressed_sum(send, lost if self.needs_residual else None)
        if self.world > 1:
            reduced = reduced / self.world
        return reduced, residual

    def reduce_hierarchical(self, g_vec: torch.Tensor, residual: Optional[torch.Tensor],
                            local_group, host_group, lost: Optional[torch.Tensor] = None):
        """The multi-hop reduction of ``comm_topology: hierarchical``
        (``tpuddp/parallel/comm.py:433-475``) on this replica's padded
        vector ``g_vec`` (the exchange's order): ``send = g_vec +
        residual`` reduce-scattered in float32 over ``local_group`` (this
        rank's contiguous ``total / L`` shard of the host's sum), the shard
        as ONE bucket through the hook over ``host_group`` (hook ``none``:
        a float32 all-reduce), the sums all-gathered over ``local_group``
        and divided by the world size. Returns ``(mean, residual)``; the
        new residual, the shard's loss placed at ``local_rank * shard_n``
        with zeros elsewhere, is written in place, or into ``lost`` when
        that is given (the guard's staging vector), as :meth:`reduce`."""
        send = g_vec if residual is None else g_vec + residual
        n_local = col.group_size(local_group)
        shard_n = self.total // n_local
        shard = torch.empty(shard_n, dtype=torch.float32, device=send.device)
        col.reduce_scatter_sum(shard, send, local_group)
        shard_lost = torch.empty_like(shard) if self.needs_residual else None
        if self.hook == "none":
            shard_sum = col.all_reduce_wire(shard, host_group)
        else:
            single = self._replace(buckets=((0, shard_n),))
            shard_sum = single._exchange_bucket(shard, shard_lost, host_group)
        reduced = torch.empty(self.total, dtype=torch.float32, device=send.device)
        col.all_gather_shards(reduced, shard_sum, local_group)
        reduced = reduced / self.world
        if shard_lost is not None:
            out = residual if lost is None else lost
            offset = col.group_rank(local_group) * shard_n
            out.zero_()
            out[offset:offset + shard_n].copy_(shard_lost)
        return reduced, residual

    def reduce_scatter(self, g_vec: torch.Tensor, residual: Optional[torch.Tensor], rank: int,
                       lost: Optional[torch.Tensor] = None):
        """The ZeRO-1 composition: ``(rank's shard of the MEAN, residual)``.
        The bf16 hooks reduce-scatter the whole vector in bf16; int8_ef and
        topk_ef exchange it as one bucket and slice the rank's shard from
        the sum. The residual stays full length and replica-local; its new
        value goes into ``lost`` when that is given, as :meth:`reduce`."""
        send = g_vec if residual is None else g_vec + residual
        lost = (residual if lost is None else lost) if self.needs_residual else None
        n = self.total // self.world
        if self.hook in ("bf16", "bf16_ef"):
            shard, comp = col.psum_scatter_compressed(send, wire_dtype(self.hook))
            if lost is not None:
                torch.sub(send, comp.float(), out=lost)
        else:
            single = self._replace(buckets=((0, self.total),))
            shard = single._exchange_bucket(send, lost)[rank * n:(rank + 1) * n]
        if self.world > 1:
            shard = shard / self.world
        return shard, residual


def make_grad_comm(sizes: Sequence[int], world: int, comm_hook: str = "none",
                   bucket_cap_mb: float = DEFAULT_BUCKET_CAP_MB,
                   density: float = DEFAULT_TOPK_DENSITY, force: bool = False) -> Optional[GradComm]:
    """The plan for leaves of ``sizes`` (in the exchange's order) over
    ``world`` replicas: the vector padded to ``world * ceil(raw / world)``,
    its buckets; None for hook ``none``, whose sync needs no plan, unless
    ``force`` (the hierarchical exchange needs the flat layout even
    uncompressed, ``tpuddp/parallel/comm.py:511-530``)."""
    validate_hook(comm_hook)
    if comm_hook == "none" and not force:
        return None
    if comm_hook == "topk_ef":
        bucket_topk(1, density)
    sizes = tuple(int(s) for s in sizes)
    raw = sum(sizes)
    total = world * -(-raw // world)
    return GradComm(sizes=sizes, total=total, buckets=make_buckets(sizes, total, bucket_cap_mb),
                    hook=comm_hook, world=int(world), density=float(density))


def _bucket_payload_bytes(hook: str, size: int, density: float) -> int:
    """Wire bytes of one ``size``-element bucket: ``none`` 4 per element,
    the bf16 hooks 2, ``int8_ef`` 1 plus the 4-byte scale, ``topk_ef`` 5
    per kept element (int8 value, int32 index) plus the scale."""
    if hook == "int8_ef":
        return size * _INT8_BYTES + _SCALE_BYTES
    if hook == "topk_ef":
        k = bucket_topk(size, density)
        return k * (_INT8_BYTES + _IDX_BYTES) + _SCALE_BYTES
    return size * wire_itemsize(hook)


def comm_bytes_for_hook(sizes: Sequence[int], world: int, comm_hook: str, wus: bool = False,
                        wire: bool = True, bucket_cap_mb: float = DEFAULT_BUCKET_CAP_MB,
                        density: float = DEFAULT_TOPK_DENSITY) -> int:
    """Per-replica payload bytes of ONE gradient reduction of leaves of
    ``sizes`` (the JAX package's tree order) in the hook's wire format,
    scales and indices included (``tpuddp/parallel/comm.py:560-601``).
    ``wus`` counts one whole-vector bucket; ``wire=False`` (the managed
    path, whose collective stays float32) counts float32 whatever the
    hook."""
    validate_hook(comm_hook)
    sizes = tuple(int(s) for s in sizes)
    raw = sum(sizes)
    total = world * -(-raw // world)
    if not wire:
        comm_hook = "none"
    if comm_hook == "none" and not wus:
        return raw * _F32_BYTES  # the tree all-reduce carries no padding
    if comm_hook == "none":
        return total * _F32_BYTES
    if wus:
        return _bucket_payload_bytes(comm_hook, total, density)
    return sum(_bucket_payload_bytes(comm_hook, e - s, density)
               for s, e in make_buckets(sizes, total, bucket_cap_mb))


def comm_bytes_breakdown(sizes: Sequence[int], world: int, comm_hook: str, topology: str = "flat",
                         local_size: Optional[int] = None, wire: bool = True,
                         bucket_cap_mb: float = DEFAULT_BUCKET_CAP_MB,
                         density: float = DEFAULT_TOPK_DENSITY) -> dict:
    """One reduction's per-replica bytes split by link
    (``tpuddp/parallel/comm.py:604-653``): under the flat topology (and
    with ``wire=False``) all of it counts as inter-host; under the
    hierarchical one, intra-host is the float32 reduce-scatter operand
    (``total`` x 4) plus the float32 all-gather operand (the ``total / L``
    shard x 4), inter-host the hook's payload of that shard as one bucket.
    ``local_size`` is ``L``; missing, or not dividing ``world``, it is the
    JAX package's ``ValueError``."""
    validate_hook(comm_hook)
    validate_topology(topology)
    total_flat = comm_bytes_for_hook(sizes, world, comm_hook, wire=wire,
                                     bucket_cap_mb=bucket_cap_mb, density=density)
    if topology == "flat" or not wire:
        return {"total": total_flat, "inter_host": total_flat, "intra_host": 0}
    if not local_size or world % local_size:
        raise ValueError(
            f"hierarchical accounting needs the inner-axis size (got local_size={local_size!r} "
            f"for world {world})"
        )
    total = world * -(-sum(int(s) for s in sizes) // world)
    shard_n = total // local_size
    intra = total * _F32_BYTES + shard_n * _F32_BYTES
    inter = (shard_n * _F32_BYTES if comm_hook == "none"
             else _bucket_payload_bytes(comm_hook, shard_n, density))
    return {"total": intra + inter, "inter_host": inter, "intra_host": intra}


# ------------------------------------------------------- managed emulation --


def _leaf_roundtrip(s: torch.Tensor, hook: str, density: float, feedback: bool = True):
    """One leaf through the hook's wire format and back (the leaf is the
    bucket): ``(kept, s - kept)`` (None for the second without
    ``feedback``), shape-preserving, the loss computed as
    :meth:`GradComm._exchange_bucket` computes it. The int8 scale and the
    top-k set are those of the leaf's elements, whatever its layout."""
    flat = s.reshape(-1)
    lost = torch.empty_like(flat) if feedback else None
    plan = GradComm(sizes=(flat.numel(),), total=flat.numel(), buckets=((0, flat.numel()),),
                    hook=hook, world=1, density=density)
    kept = plan._exchange_bucket(flat, lost)
    return kept.view_as(s), None if lost is None else lost.view_as(s)


def local_quantize(grads: Sequence[torch.Tensor], residual: Optional[Sequence[torch.Tensor]],
                   hook: str, density: float = DEFAULT_TOPK_DENSITY):
    """The managed path's hook (``tpuddp/parallel/comm.py:677-699``): each
    leaf of the already aggregated gradient round-tripped through the
    hook's wire format, with the error-feedback residual (one tensor per
    leaf, None for ``none`` and ``bf16``). Returns ``(quantized,
    new_residual)``; nothing is written in place."""
    validate_hook(hook)
    if hook == "none":
        return list(grads), residual
    if hook == "bf16":
        return [_leaf_roundtrip(g, hook, density, feedback=False)[0] for g in grads], residual
    out = [_leaf_roundtrip(g + r, hook, density) for g, r in zip(grads, residual)]
    return [k for k, _ in out], [lost for _, lost in out]


def init_residual_tree(params: Sequence[torch.Tensor]):
    """Zeros like each of ``params``, float32: :func:`local_quantize`'s
    residual."""
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params]


def redistribute_residual(mat: np.ndarray, new_world: int) -> Tuple[np.ndarray, str]:
    """The per-replica error-feedback residuals ``mat``, ``(old_world,
    per)`` (row ``r`` replica ``r``'s), mapped onto ``new_world`` replicas
    (``tpuddp/parallel/comm.py:744-787``). What steers the run is the sum
    over the replicas (each adds its residual into its next send, and the
    sends are summed), so the map keeps the elementwise sum where it can:

    - shrink, ``new_world`` divides ``old_world``: new row ``i`` is the
      float32 sum of old rows ``i*k .. i*k + k - 1`` (``k = old / new``);
    - grow, ``old_world`` divides ``new_world``: old row ``r`` moves to new
      row ``r * (new / old)``, the other rows are zero;
    - neither: no alignment of whole rows keeps the sum, so the residual
      resets to zero (the un-sent error of about one step's rounding is
      dropped once; the caller records a ``comm_state_reset`` event).

    Returns ``(new_mat, action)``, ``action`` one of ``"unchanged"``,
    ``"redistributed"``, ``"reset"``; numpy, the JAX function's own
    arithmetic, so its result is bitwise the JAX package's."""
    mat = np.asarray(mat)
    if mat.ndim != 2:
        raise ValueError(f"expected a (world, per) residual view, got {mat.shape}")
    old_world, per = mat.shape
    if new_world < 1:
        raise ValueError(f"new_world must be >= 1, got {new_world}")
    if new_world == old_world:
        return mat, "unchanged"
    if old_world % new_world == 0:
        k = old_world // new_world
        return mat.reshape(new_world, k, per).sum(axis=1), "redistributed"
    if new_world % old_world == 0:
        k = new_world // old_world
        out = np.zeros((new_world, per), mat.dtype)
        out[::k] = mat
        return out, "redistributed"
    return np.zeros((new_world, per), mat.dtype), "reset"
