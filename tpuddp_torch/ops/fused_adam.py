"""Fused Adam update — the port of the Pallas TPU kernel
``tpuddp/ops/fused_adam.py::_adam_kernel`` to a CUDA C++ kernel for Hopper
(``csrc/fused_adam.cu``; the source notes what bounds it and its design).

:func:`adam_update` updates a list of parameter leaves in place, each with
its own bias corrections. For CUDA tensors it launches the kernel through
the wrapper of the moments' dtype in :data:`kernels` (which checks device,
dtype, contiguity and sizes in one pass and raises on anything else) once
per launch table of up to ``MAX_LEAVES`` leaves: once for AlexNet's 16,
twice for ``resnet18_small``'s 62 (tables of 48 and 14 rows), four times
for ResNet-50's 161;
for CPU tensors it runs
:func:`adam_update_reference`, the plain PyTorch version of the same rule,
leaf by leaf. There is no fallback between the two: a CUDA tensor never
reaches the plain version through this function.

The moments are float32 or bfloat16 (``optimizer_state_dtype: bfloat16``).
Each type has its own instantiation of the kernel and its own wrapper and
launch count (:data:`kernels`); bf16 moments are widened to float32 for the
update and stored back with the JAX package's Weyl-sequence stochastic
rounding (:func:`stochastic_round_bf16`), keyed by each leaf's step count,
its index in the JAX package's flattened parameter tree and the flat index of
its first element (``base``: 0 for a parameter, the shard's offset in the
flat parameter vector for a ZeRO-1 shard on the managed path). The kernel
adds the element's index within its row to a noise word per row, so the
base is folded into that word on the host: ``(base + i) * A + w = i * A +
(base * A + w)`` modulo 2^32.

The launch table (:func:`launch_tables`) is built here, from plain ints and
floats, so the CPU tests reach its chunk starts, alignment flags and
splitting; the kernel only reads it. A launch captured into a CUDA graph
(``training/graphs.py``) reads its rows' bias corrections and noise words
from a device slot instead (:func:`table_scalars`,
:mod:`tpuddp_torch.ops.device_scalars`), which the host refills before each
replay with :func:`replay_scalars`; an eager launch is unchanged.

The guarded calling form (``training.guard``; ``verdict`` and ``count``):
the launch reads a device verdict (1 apply, 0 skip: nothing is written) and
the optimizer's device step count, from which it takes its bias corrections
(a device table, :func:`bias_table`, of the host's own float32 values) and
its bf16 noise words, so that a skip decided on the device needs nothing
from the host, in a CUDA-graph replay too; at verdict 1 it is bitwise the
unguarded launch at the same count. The plain version takes the same two
arguments.

The JAX kernel returns new arrays; here ``p``, ``m`` and ``v`` are updated in
place, which keeps one copy of each in device memory.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpuddp_torch.ops import _build, device_scalars

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_adam.cu"

# Elements per chunk, the work of one block: 256 threads x two float4 groups
# of each tensor, in one pass. Chosen on an H100 with tune_chunk.py.
CHUNK = 2048
# Leaves per launch: the table rides in the kernel's parameters, which every
# CUDA version allows 4 KB (csrc/fused_adam.cu asserts the same number).
MAX_LEAVES = 48

# One row of the launch table; csrc/fused_adam.cu's `struct Leaf`, byte for byte.
LEAF_DTYPE = np.dtype(
    [
        ("p", np.uint64), ("g", np.uint64), ("m", np.uint64), ("v", np.uint64),
        ("n", np.int64), ("chunk_start", np.int64),
        ("bc1", np.float32), ("bc2", np.float32), ("aligned", np.int32),
        ("noise_m", np.uint32), ("noise_v", np.uint32),
    ],
    align=True,
)

# The Weyl-sequence constants of tpuddp/optim.py:107-130 (a copy: the port
# imports nothing of the JAX package).
_U32 = 0xFFFFFFFF
WEYL_INDEX, WEYL_STEP = 0x9E3779B1, 0x85EBCA77
SALT_M, SALT_V, SALT_LEAF = 0x5ADA0000, 0x7EE70000, 0x68E31DA4


def moment_salts(leaf: int) -> Tuple[int, int]:
    """The rounding salts of m and v for the leaf at index ``leaf`` of the
    JAX package's flattened parameter tree (``tpuddp/optim.py:127``)."""
    k = SALT_LEAF * (leaf + 1)
    return (SALT_M + k) & _U32, (SALT_V + k) & _U32


def noise_offset(step: int, salt: int, base: int = 0) -> int:
    """``(base * 0x9E3779B1 + step * 0x85EBCA77 + salt) mod 2^32``: the
    part of the rounding noise that is the same for every element of a row
    whose first element has the flat index ``base``."""
    return (base * WEYL_INDEX + step * WEYL_STEP + salt) & _U32


def stochastic_round_bf16(x: torch.Tensor, step: int, salt: int, base: int = 0) -> torch.Tensor:
    """float32 -> bfloat16 with the JAX package's dithered rounding
    (``tpuddp/optim.py::_stochastic_round_bf16``): add the noise
    ``((base + i) * 0x9E3779B1 + step * 0x85EBCA77 + salt) mod 2^16`` to the
    float32 bits, ``i`` the element's flat index in ``x`` (``base`` > 0: ``x``
    is a slice of a longer vector that the JAX package rounds whole), and
    keep the upper 16.
    The uint32 arithmetic runs in int64 masked to 32 bits (torch's uint32
    support is partial); only integer operations touch the bits, so
    subnormals, infinities and NaNs go through as JAX sends them."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64) & _U32
    i = torch.arange(x.numel(), dtype=torch.int64, device=x.device).view(x.shape)
    noise = (i * WEYL_INDEX + noise_offset(step, salt, base)) & 0xFFFF
    upper = ((bits + noise) >> 16) & 0xFFFF
    upper = torch.where(upper >= 0x8000, upper - 0x10000, upper)  # as int16
    return upper.to(torch.int16).view(torch.bfloat16)


def bias_corrections(step: int, betas: Tuple[float, float]) -> Tuple[float, float]:
    """``(1 - b1^t, 1 - b2^t)`` computed on the host in float32, as
    ``tpuddp/ops/fused_adam.py:87-89`` computes them."""
    t = np.float32(step)
    b1, b2 = np.float32(betas[0]), np.float32(betas[1])
    return float(np.float32(1) - b1**t), float(np.float32(1) - b2**t)


# a bias table past this many rows is refused (betas within ~2e-6 of 1)
MAX_BIAS_ROWS = 1 << 22
_bias_tables = {}  # (b1, b2 as float32 bits, device) -> the device table


def bias_rows(betas: Tuple[float, float]) -> int:
    """Rows of :func:`bias_table`: enough that at the last step count both
    ``b^t`` are below 2^-30, so that ``1 - b^t`` is exactly 1 in float32
    there and at every later count."""
    top = max(float(np.float32(b)) for b in betas)
    if not top < 1.0:
        raise ValueError(f"the guarded Adam needs betas below 1, got {tuple(betas)}")
    rows = 2 if top <= 0.0 else int(math.ceil(30 * math.log(2) / -math.log(top))) + 2
    if rows > MAX_BIAS_ROWS:
        raise ValueError(f"betas {tuple(betas)} need a bias table of {rows} rows")
    return rows


def bias_table(betas: Tuple[float, float], device, inverse: bool = False) -> torch.Tensor:
    """``(rows, 2)`` float32 on ``device``: row ``t`` holds
    :func:`bias_corrections` ``(t, betas)`` (row 0 is unused), the same host
    computation, so a guarded launch reads the unguarded launch's bits; the
    last row is ``(1, 1)``, which every later count also has, and the
    kernel reads it for them. ``inverse``: each value's float32 reciprocal
    instead (LAMB's on the card). Built once per betas and device, at the
    first guarded step, which must not be inside a CUDA-graph capture."""
    device = torch.device(device)
    key = (np.float32(betas[0]).tobytes(), np.float32(betas[1]).tobytes(), device, inverse)
    table = _bias_tables.get(key)
    if table is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "fused_adam: the bias table is built inside a CUDA-graph capture; "
                "run one guarded step eagerly first"
            )
        rows = bias_rows(betas)
        host = np.ones((rows, 2), np.float32)
        for t in range(1, rows):
            host[t] = bias_corrections(t, betas)
        if not (host[-1] == 1.0).all():
            raise AssertionError(f"the bias table of {tuple(betas)} does not end at (1, 1)")
        if inverse:
            host = np.float32(1) / host
        table = _bias_tables[key] = torch.from_numpy(host).to(device)
    return table


def bf16_neighbours(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 values just below and just above each float32 value of
    ``x`` (both ``x`` where it is a bf16 value), as float32: the two results
    a stochastic rounding of ``x`` can give. A check helper: the update never
    calls it; ``chip_smoke.py`` and the tests bound the kernel's bf16 moments
    with it."""
    bits = x.float().contiguous().view(torch.int32)
    toward_zero = bits & -0x10000
    away = torch.where((bits & 0xFFFF) == 0, toward_zero, toward_zero + 0x10000)
    toward_zero, away = toward_zero.view(torch.float32), away.view(torch.float32)
    negative = bits < 0
    return torch.where(negative, away, toward_zero), torch.where(negative, toward_zero, away)


def adam_update_reference(
    p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, *,
    lr: float, betas: Tuple[float, float], eps: float, weight_decay: float,
    bc1: Optional[float] = None, bc2: Optional[float] = None, step: Optional[int] = None,
    leaf: Optional[int] = None, base: int = 0, verdict: Optional[torch.Tensor] = None,
    count: Optional[torch.Tensor] = None,
) -> None:
    """Plain PyTorch version of the kernel for one leaf: the torch Adam rule
    with the L2 term, in the operation order of ``tpuddp/optim.py``'s Adam.
    bf16 moments (``m.dtype``) are widened, updated in float32, used for
    ``p`` unrounded, and stored with :func:`stochastic_round_bf16` keyed by
    the leaf's step count ``step``, JAX leaf index ``leaf`` and flat index
    base ``base``. The guarded form (``verdict``, ``count``: int32 scalars,
    read on the host) writes nothing at verdict 0 and otherwise takes the
    step ``count + 1`` and its bias corrections."""
    if verdict is not None:
        if not int(verdict):
            return
        step = int(count) + 1
        bc1, bc2 = bias_corrections(step, betas)
    b1, b2 = betas
    if weight_decay:
        g = g + weight_decay * p
    m_new = b1 * m.float() + (1 - b1) * g
    v_new = b2 * v.float() + (1 - b2) * (g * g)
    p_new = p - lr * (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    if m.dtype == torch.bfloat16:
        salt_m, salt_v = moment_salts(leaf)
        m_new = stochastic_round_bf16(m_new, step, salt_m, base)
        v_new = stochastic_round_bf16(v_new, step, salt_v, base)
    m.copy_(m_new)
    v.copy_(v_new)
    p.copy_(p_new)


def launch_tables(
    ptrs: Sequence[Tuple[int, int, int, int]], numels: Sequence[int],
    bc1s: Sequence[float], bc2s: Sequence[float], chunk: int = CHUNK,
    noise: Optional[Sequence[Tuple[int, int]]] = None, moment_bytes: int = 4,
) -> List[np.ndarray]:
    """The kernel's launch tables for leaves given by their ``(p, g, m, v)``
    data pointers, element counts and bias corrections (and, for bf16
    moments, their ``(noise_m, noise_v)`` offsets; zeros when None): one
    ``LEAF_DTYPE`` array per launch, of at most ``MAX_LEAVES`` rows. Empty
    leaves are dropped. Within a table, ``chunk_start`` is the prefix sum of
    ``ceil(n / chunk)``; ``aligned`` is 1 when p and g are 16-byte aligned
    and m and v aligned to four moments of ``moment_bytes`` each (the
    kernel's vector path), else 0 (its scalar path)."""
    if noise is None:
        noise = [(0, 0)] * len(ptrs)
    tables, rows, start = [], [], 0
    leaves = zip(ptrs, numels, bc1s, bc2s, noise, strict=True)
    for (p, g, m, v), n, bc1, bc2, (noise_m, noise_v) in leaves:
        if n == 0:
            continue
        if len(rows) == MAX_LEAVES:
            tables.append(np.array(rows, dtype=LEAF_DTYPE))
            rows, start = [], 0
        aligned = (p | g) % 16 == 0 and (m | v) % (4 * moment_bytes) == 0
        rows.append((p, g, m, v, n, start, bc1, bc2, aligned, noise_m, noise_v))
        start += -(-n // chunk)
    if rows:
        tables.append(np.array(rows, dtype=LEAF_DTYPE))
    return tables


def table_scalars(table: np.ndarray) -> np.ndarray:
    """A launch table's per-step words, ``(bc1, bc2, noise_m, noise_v)`` per
    row as float32 (the noise words' bits), the kernel's ``LeafScalars``."""
    return np.stack([
        table["bc1"], table["bc2"],
        table["noise_m"].view(np.float32), table["noise_v"].view(np.float32),
    ], axis=1).reshape(-1)


def replay_scalars(numels, bc1s, bc2s, moment_dtype, steps=None, leaves=None,
                   bases=None) -> List[np.ndarray]:
    """The :func:`table_scalars` of each launch that :func:`adam_update`
    makes for leaves of ``numels`` elements with these bias corrections (and
    bf16 rounding keys): what a replayed launch reads, computed on the host
    with no tensor at hand."""
    bf16 = moment_dtype == torch.bfloat16
    tables = launch_tables(
        [(0, 0, 0, 0)] * len(numels), numels, bc1s, bc2s,
        noise=_noise(steps, leaves, len(numels), bases) if bf16 else None,
    )
    return [table_scalars(t) for t in tables]


def _check(ps, gs, ms, vs, bc1s, bc2s, moment_dtype) -> None:
    """One pass over the leaves: equal list lengths, one CUDA device (the
    current one), float32 p and g, ``moment_dtype`` m and v, contiguous,
    equal element counts per leaf."""
    if not len(ps) == len(gs) == len(ms) == len(vs) == len(bc1s) == len(bc2s):
        raise ValueError(
            f"fused_adam: {len(ps)} p, {len(gs)} g, {len(ms)} m, {len(vs)} v, "
            f"{len(bc1s)} bc1 and {len(bc2s)} bc2: expected one of each per leaf"
        )
    device = ps[0].device
    if device.type != "cuda":
        raise ValueError(f"fused_adam: p[0] is on {device}, expected cuda")
    if device.index != torch.cuda.current_device():
        raise ValueError(
            f"fused_adam: tensors on {device} but the current device is "
            f"cuda:{torch.cuda.current_device()}"
        )
    for i, leaf in enumerate(zip(ps, gs, ms, vs)):
        n = leaf[0].numel()
        for name, t in zip("pgmv", leaf):
            if t.device != device:
                raise ValueError(f"fused_adam: {name}[{i}] is on {t.device}, expected {device}")
            want = moment_dtype if name in "mv" else torch.float32
            if t.dtype != want:
                raise TypeError(f"fused_adam: {name}[{i}] is {t.dtype}, expected {want}")
            if not t.is_contiguous():
                raise ValueError(f"fused_adam: {name}[{i}] is not contiguous")
            if t.numel() != n:
                raise ValueError(
                    f"fused_adam: {name}[{i}] has {t.numel()} elements, p[{i}] has {n}"
                )


def _rounding_keys(steps, leaves, n: int) -> List[Tuple[int, int]]:
    """``(step count, JAX leaf index)`` of each of ``n`` bf16 leaves."""
    if steps is None or leaves is None or not len(steps) == len(leaves) == n:
        raise ValueError(
            "fused_adam: bf16 moments need one step count and one JAX leaf index per leaf"
        )
    return list(zip(steps, leaves))


def _noise(steps, leaves, n: int, bases=None) -> List[Tuple[int, int]]:
    """Each bf16 leaf's ``(noise_m, noise_v)`` offsets (``bases``: the flat
    index of each leaf's first element, 0 when None)."""
    bases = [0] * n if bases is None else list(bases)
    return [
        tuple(noise_offset(t, salt, base) for salt in moment_salts(k))
        for (t, k), base in zip(_rounding_keys(steps, leaves, n), bases, strict=True)
    ]


class _Library:
    """The kernels' shared library: built (if needed) and loaded at first
    use; ``build_log`` holds the compiler's output of a build in this
    process."""

    def __init__(self):
        self.build_log = ""
        self._lib = None

    def function(self, name: str):
        if self._lib is None:
            path, self.build_log = _build.build(SOURCE, "fused_adam")
            self._lib = ctypes.CDLL(str(path))
        fn = getattr(self._lib, name)
        fn.argtypes = (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
            + [ctypes.c_void_p] * 3 + [ctypes.c_int64]
            + [ctypes.c_float] * 7 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        return fn


library = _Library()


class FusedAdamKernel:
    """The wrapper of one instantiation of the kernel (the moments' dtype):
    loads its C function at first use, checks its arguments and launches once
    per launch table on PyTorch's current stream. During a CUDA-graph
    capture each launch reads its rows' per-step words from a device slot
    (:mod:`~tpuddp_torch.ops.device_scalars`). With ``verdict`` and
    ``count`` (device int32 scalars) the launch is the guarded form: its
    rows hold the noise words' step-free parts, and the kernel takes the
    step, the bias corrections (:func:`bias_table`) and whether to write at
    all from the device, in a capture too.

    Each launch that runs adds one to a word on its device (the kernel's
    block 0 does, so a launch replayed from a CUDA graph counts as well as
    an eager one): ``launches`` reads the sum, ``reset_launches()`` sets it
    to 0. The word of a device is made at the first launch there, which
    must not be inside a capture."""

    def __init__(self, moment_dtype: torch.dtype, symbol: str):
        self.moment_dtype = moment_dtype
        self.symbol = symbol
        self._counters = {}  # device -> its int64 launch count, on the device
        # rows per table -> tables this wrapper launched or captured (host
        # code: a replay adds nothing); reset_launches() empties it
        self.table_rows = {}
        self._fn = None

    @property
    def launches(self) -> int:
        """Launches that ran, on every device so far (waits for them)."""
        return sum(int(c.item()) for c in self._counters.values())

    def reset_launches(self) -> None:
        for c in self._counters.values():
            c.zero_()
        self.table_rows = {}

    def _counter(self, device: torch.device) -> torch.Tensor:
        counter = self._counters.get(device)
        if counter is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "fused_adam: the first launch on a device is inside a CUDA-graph capture; "
                    "run one step eagerly first"
                )
            counter = self._counters[device] = torch.zeros((), dtype=torch.int64, device=device)
        return counter

    def load(self):
        """Build (if needed) and load the library; return the C function."""
        if self._fn is None:
            self._fn = library.function(self.symbol)
        return self._fn

    def __call__(
        self, ps, gs, ms, vs, *, lr, betas, eps, weight_decay, bc1s=None, bc2s=None,
        steps=None, leaves=None, bases=None, verdict=None, count=None,
    ) -> None:
        if not ps:
            return
        guarded = verdict is not None
        if guarded:
            # the step comes from the device: rows carry no bias corrections
            # and the noise words' step-free parts
            bc1s = bc2s = [0.0] * len(ps)
            steps = [0] * len(ps)
        _check(ps, gs, ms, vs, bc1s, bc2s, self.moment_dtype)
        bf16 = self.moment_dtype == torch.bfloat16
        chunk = CHUNK
        guard_args = (None, None, None, 0)
        if guarded:
            for name, t in (("verdict", verdict), ("count", count)):
                if t is None or t.device != ps[0].device or t.dtype != torch.int32 or t.numel() != 1:
                    raise ValueError(f"fused_adam: {name} must be an int32 scalar on {ps[0].device}")
            bc = bias_table(betas, ps[0].device)
            guard_args = (verdict.data_ptr(), count.data_ptr(), bc.data_ptr(), len(bc))
        tables = launch_tables(
            [(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr())
             for p, g, m, v in zip(ps, gs, ms, vs)],
            [p.numel() for p in ps], bc1s, bc2s, chunk,
            noise=_noise(steps, leaves, len(ps), bases) if bf16 else None,
            moment_bytes=ms[0].element_size(),
        )
        if not tables:
            return
        for table in tables:
            self.table_rows[len(table)] = self.table_rows.get(len(table), 0) + 1
        fn = self.load()
        b1, b2 = betas
        stream = torch.cuda.current_stream(ps[0].device).cuda_stream
        counter = self._counter(ps[0].device).data_ptr()
        recorder = None if guarded else device_scalars.active()
        for table in tables:
            scalars = None if recorder is None else recorder.slot(table_scalars(table))
            err = fn(
                table.ctypes.data, len(table), chunk,
                None if scalars is None else scalars.data_ptr(), counter, *guard_args,
                lr, b1, 1.0 - b1, b2, 1.0 - b2, eps, weight_decay, stream,
            )
            if err != 0:
                raise RuntimeError(f"fused_adam kernel launch failed: CUDA error {err}")


kernels = {
    torch.float32: FusedAdamKernel(torch.float32, "tpuddp_fused_adam_multi"),
    torch.bfloat16: FusedAdamKernel(torch.bfloat16, "tpuddp_fused_adam_multi_bf16"),
}
kernel = kernels[torch.float32]  # float32 moments, the default


def adam_update(
    ps, gs, ms, vs, *, lr, betas, eps, weight_decay, bc1s=None, bc2s=None, steps=None,
    leaves=None, bases=None, verdict=None, count=None,
) -> None:
    """Update the leaves ``ps[i]`` (gradient ``gs[i]``, moments ``ms[i]``,
    ``vs[i]``, bias corrections ``bc1s[i]``, ``bc2s[i]``) in place: the CUDA
    kernel of the moments' dtype for CUDA tensors, the plain version for CPU
    tensors. bf16 moments also need each leaf's step count ``steps[i]`` and
    JAX leaf index ``leaves[i]``, which key their rounding, and take the flat
    index of its first element from ``bases[i]`` (0 when None). With
    ``verdict`` and ``count`` (int32 scalars on the leaves' device) it is
    the guarded form: every leaf at step ``count + 1``, nothing written at
    verdict 0; ``bc1s``, ``bc2s`` and ``steps`` are then not given."""
    if not ps:
        return
    hp = dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)
    if verdict is not None:
        if bc1s is not None or bc2s is not None or steps is not None:
            raise ValueError("fused_adam: the guarded form takes its steps from count")
        hp.update(verdict=verdict, count=count)
        bc1s = bc2s = [None] * len(ps)
        steps = [0] * len(ps)
    device = ps[0].device
    moment_dtype = ms[0].dtype
    if moment_dtype not in kernels:
        raise TypeError(f"fused_adam: moments are {moment_dtype}, expected one of {list(kernels)}")
    if device.type == "cuda":
        if verdict is not None:
            kernels[moment_dtype](ps, gs, ms, vs, leaves=leaves, bases=bases, **hp)
            return
        kernels[moment_dtype](
            ps, gs, ms, vs, bc1s=bc1s, bc2s=bc2s, steps=steps, leaves=leaves, bases=bases, **hp
        )
    elif device.type == "cpu":
        rows = list(zip(ps, gs, ms, vs, bc1s, bc2s, strict=True))
        if moment_dtype == torch.bfloat16:
            keys = _rounding_keys(steps, leaves, len(rows))
        else:
            keys = [(None, None)] * len(rows)
        for i, leaf in enumerate(rows):
            for t in leaf[:4]:
                if t.device != device:
                    raise ValueError(f"fused_adam: leaf {i} has a tensor on {t.device}, p[0] on cpu")
            if leaf[2].dtype != moment_dtype or leaf[3].dtype != moment_dtype:
                raise TypeError(f"fused_adam: leaf {i} has moments of another dtype than m[0]")
        for (p, g, m, v, bc1, bc2), (step, leaf), base in zip(
                rows, keys, [0] * len(rows) if bases is None else bases, strict=True):
            adam_update_reference(p, g, m, v, bc1=bc1, bc2=bc2, step=step, leaf=leaf, base=base,
                                  **hp)
    else:
        raise ValueError(f"fused_adam: unsupported device {device}")
