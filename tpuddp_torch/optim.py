"""The optimizers of ``tpuddp/optim.py``: torch-rule Adam with float32 or
bfloat16 moments (lines 133-225), SGD, SGDW, LARS and LAMB (lines 36-70,
228-460), and the global-norm gradient clip (lines 463-481).

Each param group's update is one call of
:func:`tpuddp_torch.ops.fused_adam.adam_update`: one CUDA kernel launch for
all of the group's CUDA parameters (up to 48 leaves; more take one launch per
48: 2 for a ResNet-18, 4 for a ResNet-50), the plain PyTorch version for CPU
ones. The launches of one update read the same step counts, on the host or,
under the guard, from the one device count, which advances once after the
last of them. ``weight_decay`` is the
torch L2 convention (added to the gradient), as in the JAX package.

``state_dtype`` (``training.optimizer_state_dtype``) stores m and v in
bfloat16: the update still runs in float32, ``p`` comes from the unrounded
moments, and the moments are stored with the JAX package's Weyl-sequence
stochastic rounding, keyed by each parameter's step count and its index in
the JAX package's flattened parameter tree (``leaf_index``;
:func:`tpuddp_torch.models.convert.jax_leaf_index` gives it for the port's
models).

The JAX optimizer is a pure function returning new arrays and one shared step
counter; this one keeps ``step``, ``exp_avg`` (m) and ``exp_avg_sq`` (v) per
parameter, as ``torch.optim.Adam`` does, and updates them and the parameter
in place.

SGD, SGDW, LARS and LAMB follow the JAX rules term by term, in float32, with
PyTorch ops: the JAX package computes them as XLA-fused tree maps, with no
Pallas kernel. They keep ``momentum_buffer`` (SGD and SGDW with a non-zero
momentum, LARS always) or ``step``, ``exp_avg`` and ``exp_avg_sq`` (LAMB) per
parameter. A LARS/LAMB "layer" is one parameter tensor, which is one leaf of
the JAX tree (weight and bias are separate leaves in both packages); a norm
does not depend on the HWIO/OIHW layout or on AlexNet's 9216-wide reorder, so
the trust ratios need no conversion. Each step leaves the ratios it used in
``trust_ratios`` (one float32 tensor, the stepped parameters in order), on
the parameters' device, read by no update.

Under ``weight_update_sharding`` (ZeRO-1, ``tpuddp/training/step.py:
291-366``) :class:`ShardedUpdate` wraps any of them: the model's parameters
become views into one flat float32 vector, and the wrapped optimizer steps
one parameter, this replica's contiguous shard of it, with its state
sharded alike; LARS and LAMB then take their per-layer norms over the
shard's segments of the flat vector (:class:`FlatSegments`), summed across
replicas.

Every optimizer here can run inside a CUDA graph (the managed path's
``fuse_steps`` replays, ``training/graphs.py``; ``GRAPH_SAFE``): none reads
a device value on the host. The host state that changes per step, Adam's and
LAMB's step counts and the scalars they give, is advanced and uploaded
before each replay through :mod:`tpuddp_torch.ops.device_scalars`, which
the captured launches read instead of the captured step's values.

Under the numerical guard (``training.guard``; :func:`arm_guard`) each
optimizer reads the firewall's device verdict (``verdict``, int32: 1 apply,
0 skip) and an update at 0 writes nothing: Adam's kernel takes the verdict
itself (its guarded calling form); SGD, SGDW, LARS and LAMB select the old
parameters and state back where it is 0, bitwise. Adam and LAMB then keep
one step count per optimizer on the device (``AdamState.step`` is one count
for the tree in the JAX package), advanced by the verdict after the update,
from which the kernel (Adam) or a device table (LAMB) takes the bias
corrections: nothing the host uploads before a replay depends on a skip.
The host's per-parameter ``state["step"]`` is brought into line with it by
:meth:`Adam.sync_steps` (at a save and at an epoch's end), and the device
count from the host's by :meth:`Adam.count_from_state` (after a restore).
"""

from __future__ import annotations

from functools import partial
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpuddp_torch.ops import device_scalars
from tpuddp_torch.ops.fused_adam import (
    adam_update, bias_corrections, bias_rows, bias_table, replay_scalars,
)
from tpuddp_torch.parallel import collectives

# tpuddp/optim.py:162-181: these two have a correct storage path; any other
# low-precision type would freeze Adam's v (its sub-ulp decrements vanish)
_STATE_DTYPES = {
    None: torch.float32, "float32": torch.float32, "f32": torch.float32,
    "fp32": torch.float32, "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    torch.float32: torch.float32, torch.bfloat16: torch.bfloat16,
}


def state_dtype_from(name) -> torch.dtype:
    """The moments' dtype for ``optimizer_state_dtype``: None and float32
    (``f32``, ``fp32``) give float32, ``bfloat16`` (``bf16``) bfloat16;
    anything else is a ``ValueError``."""
    try:
        return _STATE_DTYPES[name]
    except (KeyError, TypeError):
        raise ValueError(
            f"unsupported state_dtype {name!r} (training.optimizer_state_dtype); "
            "use bfloat16 or float32"
        ) from None


class _DeviceCount:
    """Adam's and LAMB's per-parameter state (``step``, ``exp_avg``,
    ``exp_avg_sq``) and, under the guard (``verdict`` set), one int32 step
    count per optimizer on the device, the updates applied, which the
    guarded update reads (``t = count + 1``) and advances by the verdict."""

    verdict: Optional[torch.Tensor] = None  # the firewall's, set by arm_guard
    _count: Optional[torch.Tensor] = None
    state_dtype = torch.float32

    def _init_state(self, p) -> dict:
        """``p``'s state, created (step 0, zero moments) at its first step."""
        state = self.state[p]
        if not state:
            state["step"] = 0
            state["exp_avg"] = torch.zeros_like(
                p, dtype=self.state_dtype, memory_format=torch.contiguous_format
            )
            state["exp_avg_sq"] = torch.zeros_like(state["exp_avg"])
        return state

    def _device_count(self) -> torch.Tensor:
        if self._count is None:
            device = self.param_groups[0]["params"][0].device
            if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "the guarded optimizer's step count is made inside a CUDA-graph capture; "
                    "run one step eagerly first"
                )
            self._count = torch.zeros((), dtype=torch.int32, device=device)
        return self._count

    def sync_steps(self) -> None:
        """Each parameter's host ``state["step"]`` set to the device count
        (a host read; nothing without the guard)."""
        if self.verdict is None or self._count is None:
            return
        count = int(self._count)
        for state in self.state.values():
            if "step" in state:
                state["step"] = count

    @torch.no_grad()
    def count_from_state(self) -> None:
        """The device count set to the parameters' host step count (one
        count for all of them; 0 without state), after a restore."""
        if self.verdict is None:
            return
        steps = {int(st["step"]) for st in self.state.values() if "step" in st}
        if len(steps) > 1:
            raise ValueError(f"parameters are at steps {sorted(steps)}; the guard keeps one count")
        self._device_count().fill_(steps.pop() if steps else 0)


class Adam(_DeviceCount, torch.optim.Optimizer):
    def __init__(
        self,
        params,
        lr: float = 1e-3,
        betas: Tuple[float, float] = (0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        state_dtype=None,
        leaf_index: Optional[Sequence[int]] = None,
    ):
        self.state_dtype = state_dtype_from(state_dtype)
        defaults = dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay)
        super().__init__(params, defaults)
        flat = [p for group in self.param_groups for p in group["params"]]
        # each parameter's index in the JAX package's flattened parameter
        # tree, which salts its bf16 rounding; float32 moments need none
        if leaf_index is None:
            if self.state_dtype == torch.bfloat16:
                raise ValueError(
                    "bf16 moments need leaf_index, each parameter's index in the "
                    "JAX package's flattened parameter tree "
                    "(tpuddp_torch.models.convert.jax_leaf_index)"
                )
            leaf_index = [None] * len(flat)
        leaf_index = list(leaf_index)
        if len(leaf_index) != len(flat):
            raise ValueError(
                f"leaf_index has {len(leaf_index)} entries for {len(flat)} parameters"
            )
        self.leaf_index = dict(zip(flat, leaf_index))
        # the flat index of a parameter's first element in the vector whose
        # elements the JAX package numbers for the rounding (0: its own)
        self.noise_base = {}

    GRAPH_SAFE = True

    def _advance(self, group, ps) -> dict:
        """Advance the step count of each of ``ps`` (creating its state at
        its first step) and return the per-leaf arguments of the group's
        ``adam_update`` call: bias corrections of each leaf's own step
        count, step counts, JAX leaf indices and flat index bases."""
        bc1s, bc2s, steps, leaves = [], [], [], []
        corrections = {}
        for p in ps:
            state = self._init_state(p)
            state["step"] += 1
            step = state["step"]
            if step not in corrections:
                corrections[step] = bias_corrections(step, group["betas"])
            bc1, bc2 = corrections[step]
            bc1s.append(bc1)
            bc2s.append(bc2)
            steps.append(step)
            leaves.append(self.leaf_index[p])
        return dict(bc1s=bc1s, bc2s=bc2s, steps=steps, leaves=leaves,
                    bases=[self.noise_base.get(p, 0) for p in ps])

    def _replay(self, stepped) -> List[np.ndarray]:
        """One captured step's host part for a replay: the step counts of
        the parameters it stepped advance, and each launch's words come
        back."""
        out = []
        for group, ps in zip(self.param_groups, stepped):
            if ps:
                out += replay_scalars([p.numel() for p in ps], moment_dtype=self.state_dtype,
                                      **self._advance(group, ps))
        return out

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        if self.verdict is not None:
            self._guarded_step()
            return loss
        stepped = []
        for group in self.param_groups:
            # the group's leaves that have a gradient, each with the bias
            # corrections of its own step count, in one adam_update call
            ps = [p for p in group["params"] if p.grad is not None]
            args = self._advance(group, ps)
            adam_update(
                ps, [p.grad for p in ps], [self.state[p]["exp_avg"] for p in ps],
                [self.state[p]["exp_avg_sq"] for p in ps], lr=group["lr"],
                betas=group["betas"], eps=group["eps"], weight_decay=group["weight_decay"],
                **args,
            )
            stepped.append(ps)
        device_scalars.on_replay(partial(self._replay, stepped))
        return loss

    def _guarded_step(self) -> None:
        """Every group's leaves through the kernel's guarded form at the
        device count, then ``count += verdict``: no host state advances,
        so a replay needs nothing uploaded."""
        count = self._device_count()
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            states = [self._init_state(p) for p in ps]
            adam_update(
                ps, [p.grad for p in ps], [st["exp_avg"] for st in states],
                [st["exp_avg_sq"] for st in states], lr=group["lr"], betas=group["betas"],
                eps=group["eps"], weight_decay=group["weight_decay"],
                leaves=[self.leaf_index[p] for p in ps],
                bases=[self.noise_base.get(p, 0) for p in ps], verdict=self.verdict, count=count,
            )
        count.add_(self.verdict)


# ------------------------------------------------- SGD, SGDW, LARS, LAMB --


def _stepped(group) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The group's parameters that have a gradient, and their gradients."""
    ps = [p for p in group["params"] if p.grad is not None]
    return ps, [p.grad for p in ps]


def _momentum_buffers(optimizer: torch.optim.Optimizer, ps) -> List[torch.Tensor]:
    """Each parameter's ``momentum_buffer``, zeros at its first step."""
    out = []
    for p in ps:
        state = optimizer.state[p]
        if "momentum_buffer" not in state:
            state["momentum_buffer"] = torch.zeros_like(p, memory_format=torch.contiguous_format)
        out.append(state["momentum_buffer"])
    return out


def _safe_ratio(p_norm: torch.Tensor, d_norm: torch.Tensor, scale: float) -> torch.Tensor:
    """``scale * p_norm / d_norm`` where both norms are positive, else 1
    (``tpuddp/optim.py:271-276``): a zero-norm layer takes the unscaled
    step."""
    ok = (p_norm > 0) & (d_norm > 0)
    return torch.where(ok, scale * p_norm / torch.where(ok, d_norm, torch.ones_like(d_norm)),
                       torch.ones_like(p_norm))


def _norms64(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Each tensor's L2 norm, stacked, accumulated and returned in float64,
    on the card and on the CPU alike. PyTorch's float32 norm on the CPU sums
    one element after another and is 2e-3 off on AlexNet's 37.7M-element
    leaf; the JAX package's float32 sum stays within its own rounding of
    the exact norm."""
    return torch.stack(torch._foreach_norm(list(tensors), 2, dtype=torch.float64))


def _norms(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Each tensor's L2 norm, stacked, rounded to float32."""
    return _norms64(tensors).float()


class FlatSegments:
    """The layers of a ZeRO-1 shard for LARS and LAMB (``tpuddp/optim.py::
    _flat_segment_ids``): the shard ``[start, start + n)`` of a flat vector
    whose layers end at ``ends`` (each parameter one layer, the padding past
    the last one a trailing layer of zeros), as contiguous slices. A layer's
    sum of squares is its slices' sum on each replica, accumulated in
    float64, summed across replicas; the ratios of the shard's layers come
    back one per element."""

    def __init__(self, ends: Sequence[int], total: int, start: int, n: int,
                 device: torch.device):
        bounds = [0, *ends, total]
        self.num_segments = len(bounds) - 1
        ids, self.slices = [], []
        for k in range(self.num_segments):
            lo, hi = max(bounds[k], start), min(bounds[k + 1], start + n)
            if lo < hi:
                ids.append(k)
                self.slices.append((lo - start, hi - start))
        self.n = n
        self.index = torch.tensor(ids, dtype=torch.int64, device=device)
        self.counts = torch.tensor([hi - lo for lo, hi in self.slices], dtype=torch.int64,
                                   device=device)

    def norms(self, x: torch.Tensor) -> torch.Tensor:
        """The L2 norm of each of the shard's layers over every replica's
        part of it, in float32."""
        sq = _norms64([x[lo:hi] for lo, hi in self.slices]).square()
        full = torch.zeros(self.num_segments, dtype=torch.float64, device=x.device)
        full.index_copy_(0, self.index, sq)
        collectives.all_reduce_sum_([full])
        return full.index_select(0, self.index).sqrt().float()

    def expand(self, ratios: torch.Tensor) -> torch.Tensor:
        """Per-layer ``ratios`` as one value per element of the shard."""
        return torch.repeat_interleave(ratios, self.counts, output_size=self.n)


class _TreeMap(torch.optim.Optimizer):
    """An update written in PyTorch ops, one param group at a time (the JAX
    package's tree maps), behind ``torch.optim.Optimizer.step``'s closure
    protocol. LARS and LAMB take their layers' norms per parameter, or with
    ``flat`` (a :class:`FlatSegments`, set by :class:`ShardedUpdate`) over
    the segments of their one parameter, a ZeRO-1 shard. Under the guard
    (``verdict``) the parameters and the state the update writes are copied
    first and selected back where the verdict is 0."""

    GRAPH_SAFE = True
    flat: Optional[FlatSegments] = None
    verdict: Optional[torch.Tensor] = None  # the firewall's, set by arm_guard

    def _layer_norms(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        return _norms(tensors) if self.flat is None else self.flat.norms(tensors[0])

    def _per_parameter(self, ratios: torch.Tensor):
        """Per-layer ratios as each parameter's factor: a scalar each, or one
        value per element of the flat shard."""
        return ratios if self.flat is None else [self.flat.expand(ratios)]

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        held = self._hold() if self.verdict is not None else ()
        for group in self.param_groups:
            self._update(group)
        if held:
            keep = self.verdict.bool()
            for t, old in held:
                torch.where(keep, t, old, out=t)
        return loss

    def _hold(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """``(tensor, its copy)`` of everything the update writes: the
        stepped parameters and their state (created first, as zeros)."""
        held = []
        for group in self.param_groups:
            ps, _ = _stepped(group)
            held += [(t, t.clone()) for t in ps + self._state_tensors(group, ps)]
        return held

    def _state_tensors(self, group, ps) -> List[torch.Tensor]:
        """The state tensors the update of ``ps`` writes."""
        return []

    def _update(self, group) -> None:
        raise NotImplementedError


class SGD(_TreeMap):
    """``tpuddp/optim.py:40-70`` without nesterov (no setting reaches it):
    ``g + wd * p``, then ``b = momentum * b + g`` and ``p - lr * b``, or
    ``p - lr * g`` with momentum 0 (which keeps no state)."""

    def __init__(self, params, lr: float, momentum: float = 0.0, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, momentum=momentum, weight_decay=weight_decay))

    def _state_tensors(self, group, ps) -> List[torch.Tensor]:
        return [] if group["momentum"] == 0.0 else _momentum_buffers(self, ps)

    def _update(self, group) -> None:
        ps, gs = _stepped(group)
        if not ps:
            return
        lr, mu, wd = group["lr"], group["momentum"], group["weight_decay"]
        if wd:
            gs = torch._foreach_add(gs, torch._foreach_mul(ps, wd))
        if mu == 0.0:
            torch._foreach_sub_(ps, torch._foreach_mul(gs, lr))
            return
        bufs = _momentum_buffers(self, ps)
        torch._foreach_mul_(bufs, mu)
        torch._foreach_add_(bufs, gs)
        torch._foreach_sub_(ps, torch._foreach_mul(bufs, lr))


class SGDW(_TreeMap):
    """``tpuddp/optim.py:279-307``, decoupled weight decay:
    ``b = momentum * b + g``, ``p - lr * b - lr * wd * p`` (``g`` for ``b``
    with momentum 0, which keeps no state)."""

    def __init__(self, params, lr: float, momentum: float = 0.9, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, momentum=momentum, weight_decay=weight_decay))

    def _state_tensors(self, group, ps) -> List[torch.Tensor]:
        return [] if group["momentum"] == 0.0 else _momentum_buffers(self, ps)

    def _update(self, group) -> None:
        ps, gs = _stepped(group)
        if not ps:
            return
        lr, mu, decay = group["lr"], group["momentum"], group["lr"] * group["weight_decay"]
        step = gs
        if mu != 0.0:
            step = _momentum_buffers(self, ps)
            torch._foreach_mul_(step, mu)
            torch._foreach_add_(step, gs)
        decayed = torch._foreach_mul(ps, decay) if decay else None
        torch._foreach_sub_(ps, torch._foreach_mul(step, lr))
        if decayed is not None:
            torch._foreach_sub_(ps, decayed)


class LARS(_TreeMap):
    """``tpuddp/optim.py:314-358``: per layer, ``d = ratio * (g + wd * p)``
    with ``ratio = tc * ||p|| / (||g|| + wd * ||p|| + eps)`` (1 where a norm
    is zero), then ``b = momentum * b + d`` and ``p - lr * b``. The
    momentum buffer is kept even at momentum 0, as the JAX state is."""

    def __init__(self, params, lr: float, momentum: float = 0.9, weight_decay: float = 0.0,
                 trust_coefficient: float = 0.001, eps: float = 1e-9):
        super().__init__(params, dict(lr=lr, momentum=momentum, weight_decay=weight_decay,
                                      trust_coefficient=trust_coefficient, eps=eps))
        self.trust_ratios: Optional[torch.Tensor] = None

    def _state_tensors(self, group, ps) -> List[torch.Tensor]:
        return _momentum_buffers(self, ps)

    def _update(self, group) -> None:
        ps, gs = _stepped(group)
        if not ps:
            return
        wd = group["weight_decay"]
        p_n, g_n = self._layer_norms(ps), self._layer_norms(gs)
        ratios = _safe_ratio(p_n, g_n + wd * p_n + group["eps"], group["trust_coefficient"])
        bufs = _momentum_buffers(self, ps)
        for p, g, b, ratio in zip(ps, gs, bufs, self._per_parameter(ratios)):
            d = g + wd * p
            b.mul_(group["momentum"]).add_(d.mul_(ratio))
            p.sub_(b * group["lr"])
        self.trust_ratios = ratios


class LAMB(_DeviceCount, _TreeMap):
    """``tpuddp/optim.py:361-448``: Adam's moments in float32 (``step``,
    ``exp_avg``, ``exp_avg_sq`` per parameter), the direction
    ``r = (m / bc1) / (sqrt(v / bc2) + eps) + wd * p`` and, per layer,
    ``p - lr * ratio * r`` with ``ratio = ||p|| / ||r||`` (1 where a norm is
    zero). ``eps`` defaults to 1e-6."""

    def __init__(self, params, lr: float = 1e-3, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay))
        self.trust_ratios: Optional[torch.Tensor] = None

    def _state_tensors(self, group, ps) -> List[torch.Tensor]:
        states = [self._init_state(p) for p in ps]
        return [st["exp_avg"] for st in states] + [st["exp_avg_sq"] for st in states]

    def _advance(self, group, ps) -> List[Tuple[float, float]]:
        """Advance the step count of each of ``ps`` (creating its state at
        its first step); each one's ``(bc1, bc2)``."""
        out = []
        for p in ps:
            state = self._init_state(p)
            state["step"] += 1
            out.append(bias_corrections(state["step"], group["betas"]))
        return out

    def _guarded_corrections(self, group, device) -> Tuple[torch.Tensor, bool]:
        """The bias corrections of step ``count + 1``, gathered on the
        device from a table of the host's values, and whether to divide by
        them: on the CPU ``(bc1, bc2)``, divided by as by the host's scalars;
        on the card ``(1 / bc1, 1 / bc2)``, which a division by a host
        scalar multiplies by there."""
        betas = group["betas"]
        t = (self._device_count() + 1).clamp_(max=bias_rows(betas) - 1).long().reshape(1)
        cpu = device.type == "cpu"
        table = bias_table(betas, device, inverse=not cpu)
        return table.index_select(0, t).reshape(2), cpu

    @staticmethod
    def _inverses(bcs) -> np.ndarray:
        """``(1 / bc1, 1 / bc2)`` per parameter, each a float32 division of
        float32 values: on the card ``m / bc1`` with a host scalar multiplies
        by exactly this inverse, so a replayed step that multiplies by it
        from the device is the eager step bitwise."""
        return np.float32(1) / np.asarray(bcs, dtype=np.float32).reshape(-1)

    def _replay(self, stepped) -> List[np.ndarray]:
        return [self._inverses(self._advance(group, ps))
                for group, ps in zip(self.param_groups, stepped) if ps]

    def step(self, closure=None):
        self._stepped = []
        loss = super().step(closure)
        if self.verdict is None:
            device_scalars.on_replay(partial(self._replay, self._stepped))
        else:
            self._device_count().add_(self.verdict)
        return loss

    def _update(self, group) -> None:
        ps, gs = _stepped(group)
        self._stepped.append(ps)
        if not ps:
            return
        b1, b2 = group["betas"]
        wd, eps = group["weight_decay"], group["eps"]
        if self.verdict is not None:  # the state exists: _hold made it
            bc, divide = self._guarded_corrections(group, ps[0].device)
            scales = [(bc[0], bc[1])] * len(ps)
        else:
            bcs = self._advance(group, ps)
            # inside a capture: the inverses from a device slot (see _inverses)
            recorder = device_scalars.active()
            inv = None if recorder is None else recorder.slot(self._inverses(bcs))
            divide = inv is None
            scales = bcs if divide else [(inv[2 * i], inv[2 * i + 1]) for i in range(len(ps))]
        rs = []
        for p, g, (c1, c2) in zip(ps, gs, scales):
            state = self.state[p]
            m, v = state["exp_avg"], state["exp_avg_sq"]
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g.square().mul_(1 - b2))
            if divide:
                r = (m / c1).div_((v / c2).sqrt_().add_(eps))
            else:
                r = (m * c1).div_((v * c2).sqrt_().add_(eps))
            if wd:
                r.add_(wd * p)
            rs.append(r)
        ratios = _safe_ratio(self._layer_norms(ps), self._layer_norms(rs), 1.0)
        for p, r, ratio in zip(ps, rs, self._per_parameter(ratios)):
            p.sub_(r.mul_(group["lr"] * ratio))
        self.trust_ratios = ratios


# ------------------------------------------------------------------ clip --


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of every element's square)`` over ``tensors``, on their
    device (``tpuddp/optim.py:463-465``), in float32."""
    return _norms64(tensors).square().sum().sqrt().float()


def clip_grad_norm_(params: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale the gradients of ``params`` in place by
    ``min(1, max_norm / (norm + 1e-6))`` so that their global L2 norm is at
    most ``max_norm`` (``tpuddp/optim.py:468-481``); returns the pre-clip
    norm, on the device, without a host read. Under DDP it runs on the
    averaged gradient, the same on every replica."""
    gs = [p.grad for p in params if p.grad is not None]
    if not gs:
        return torch.zeros(())
    norm = global_norm(gs)
    torch._foreach_mul_(gs, torch.clamp(max_norm / (norm + 1e-6), max=1.0))
    return norm


# ---------------------------------------------------------------- ZeRO-1 --


class ShardedUpdate:
    """ZeRO-1 around ``optimizer`` (any optimizer of this module, one param
    group over the model's parameters): the counterpart of the JAX
    package's weight-update sharding, native (``tpuddp/training/step.py:
    291-366``) and managed (``_FlatShardedUpdate``,
    ``tpuddp/accelerate.py:389-470``).

    At construction (after the model is on its device and replicas agree)
    the parameters, in ``params`` order, are copied into one flat float32
    vector of ``spec.total`` elements (zero padding past the last) and each
    becomes a view into it; ``optimizer`` is rebound to one parameter, this
    rank's shard ``[rank * shard_n, (rank + 1) * shard_n)`` of that vector,
    its state dropped (it is created at the first step, over the shard).
    Adam keys its bf16 rounding with JAX leaf index 0 (a one-array tree) and
    flat index base 0, as the JAX package's ``shard_map`` step numbers the
    shard's elements; on the ``managed`` path the JAX update is partitioned
    from the whole vector, whose elements it numbers, so the base is the
    shard's offset.
    LARS and LAMB take their layers' norms over the shard's segments of the
    flat vector, summed across replicas (:class:`FlatSegments`).

    :meth:`step` copies the parameters' gradients into one flat buffer (one
    copy), reduce-scatters it (SUM) into this rank's shard and divides by
    the world size (on the ``managed`` path the gradients are already the
    global ones, as its step makes them, and the shard is a slice), clips
    the shard to global norm
    ``clip`` (``sqrt`` of the replicas' summed squares, ``g * min(1, clip /
    (norm + 1e-6))``), runs the wrapped optimizer on the shard and
    all-gathers the new shards into the flat vector, which updates every
    parameter view. A world of one skips the collectives. Every buffer is
    allocated here, before any CUDA-graph capture; nothing reads the
    device on the host.

    ``comm`` (native only), a :class:`~tpuddp_torch.parallel.comm.GradComm`
    of a hook over the flat layout, makes the reduce-scatter its
    :meth:`~tpuddp_torch.parallel.comm.GradComm.reduce_scatter`
    (``tpuddp/parallel/comm.py:476-508``); ``residual`` is then this
    rank's full-length error-feedback residual in the port's flat order
    (None for ``bf16``), updated in place by each step.

    Under the guard (:func:`arm_guard`) the wrapped optimizer reads the
    firewall's verdict, and on the native path this step makes it: the
    shard of the mean gradient (before the clip) is judged and the verdict
    agreed across ranks with an all-reduce MIN, the JAX package's ``pmin``
    (``tpuddp/training/step.py:360-368``); the hook writes its residual into
    the firewall's staging vector. A skipped shard all-gathers unchanged."""

    def __init__(self, optimizer: torch.optim.Optimizer, params: Sequence[torch.Tensor], spec,
                 rank: int = 0, *, managed: bool = False, clip: Optional[float] = None,
                 comm=None):
        if len(optimizer.param_groups) != 1:
            raise ValueError(
                "weight_update_sharding steps one flat vector: the optimizer must have one "
                f"param group, not {len(optimizer.param_groups)}"
            )
        params = list(params)
        spec.check(params)
        self.inner = optimizer
        self.spec = spec
        self.params = params
        self.world, self.rank = spec.world, int(rank)
        self.clip = None if clip is None else float(clip)
        self.managed = bool(managed)
        self.firewall = None  # the numerical guard's, set by arm_guard
        device = params[0].device
        n = spec.shard_n
        self.lo, self.hi = self.rank * n, (self.rank + 1) * n
        with torch.no_grad():
            self.flat = torch.zeros(spec.total, dtype=torch.float32, device=device)
            spec.flatten([p.detach() for p in params], self.flat)
            for p, view in zip(params, spec.views(self.flat)):
                p.data = view
        self.flat_grad = torch.zeros_like(self.flat)
        if comm is not None and (managed or comm.total != spec.total):
            raise ValueError("a comm hook's reduce-scatter needs the native path's flat layout")
        self.comm = comm
        self.residual = None if comm is None else comm.init_residual(device)
        multi = self.world > 1
        self._g_shard = torch.empty(n, device=device) if multi and not managed and comm is None else None
        self._send = torch.empty(n, device=device) if multi else None
        self.shard = self.flat[self.lo:self.hi].detach()
        optimizer.param_groups[0]["params"] = [self.shard]
        optimizer.state.clear()
        if isinstance(optimizer, Adam):
            optimizer.leaf_index = {self.shard: 0}
            optimizer.noise_base = {self.shard: self.lo if managed else 0}
        elif isinstance(optimizer, (LARS, LAMB)):
            optimizer.flat = FlatSegments(spec.ends, spec.total, self.lo, n, device)

    # the torch.optim.Optimizer surface the steps, graphs and checkpoints read
    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    @property
    def defaults(self):
        return self.inner.defaults

    @property
    def GRAPH_SAFE(self) -> bool:
        return getattr(self.inner, "GRAPH_SAFE", False)

    @property
    def judges(self) -> bool:
        """Whether this step makes the guard's verdict (native ZeRO-1)."""
        return self.firewall is not None and not self.managed

    def zero_grad(self, set_to_none: bool = True) -> None:
        """Drop every parameter's gradient (the steps' one use)."""
        for p in self.params:
            p.grad = None
        self.shard.grad = None

    def shard_state(self, key: str) -> Optional[torch.Tensor]:
        """The wrapped optimizer's ``key`` state of the shard (None before
        its first step)."""
        return self.inner.state.get(self.shard, {}).get(key)

    @torch.no_grad()
    def _flat_gradient(self) -> torch.Tensor:
        """This rank's shard of the (mean) gradient."""
        grads = [p.grad for p in self.params]
        if all(g is not None for g in grads):
            self.spec.flatten(grads, self.flat_grad)
        else:
            for g, view in zip(grads, self.spec.views(self.flat_grad)):
                view.zero_() if g is None else view.copy_(g)
        if self.comm is not None:
            lost = None if self.firewall is None else self.firewall.staged
            return self.comm.reduce_scatter(self.flat_grad, self.residual, self.rank, lost)[0]
        if self._g_shard is None:
            return self.flat_grad[self.lo:self.hi]
        collectives.reduce_scatter_sum(self._g_shard, self.flat_grad)
        return self._g_shard.div_(self.world)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        g = self._flat_gradient()
        if self.judges:
            self.firewall.judge([g], agree=True)
        if self.clip is not None:
            sq = _norms64([g]).square()
            collectives.all_reduce_sum_([sq])
            g.mul_(torch.clamp(self.clip / (sq.sqrt().float() + 1e-6), max=1.0))
        self.shard.grad = g
        self.inner.step()
        self.shard.grad = None
        if self._send is not None:
            self._send.copy_(self.shard)
            collectives.all_gather_shards(self.flat, self._send)
        return loss


def arm_guard(optimizer, firewall) -> None:
    """Gate ``optimizer``'s updates on ``firewall``'s verdict (a
    :class:`~tpuddp_torch.resilience.guard.Firewall`): any optimizer of this
    module, or a :class:`ShardedUpdate` around one (which then also makes
    the verdict on the native path)."""
    inner = optimizer
    if isinstance(optimizer, ShardedUpdate):
        optimizer.firewall = firewall
        inner = optimizer.inner
    if not isinstance(inner, (Adam, _TreeMap)):
        raise TypeError(
            "the numerical guard (training.guard) gates the updates of tpuddp_torch.optim's "
            f"optimizers; got {type(inner).__name__}"
        )
    inner.verdict = firewall.verdict


def _counted(optimizer) -> Optional[_DeviceCount]:
    inner = optimizer.inner if isinstance(optimizer, ShardedUpdate) else optimizer
    return inner if isinstance(inner, _DeviceCount) else None


def sync_steps(optimizer) -> None:
    """:meth:`Adam.sync_steps` of ``optimizer`` (or of the optimizer a
    ZeRO-1 wrap holds); nothing for one without a step count."""
    counted = _counted(optimizer)
    if counted is not None:
        counted.sync_steps()


def count_from_state(optimizer) -> None:
    """:meth:`Adam.count_from_state` of ``optimizer``, as :func:`sync_steps`."""
    counted = _counted(optimizer)
    if counted is not None:
        counted.count_from_state()
