"""Fused Adam update — the port of the Pallas TPU kernel
``tpuddp/ops/fused_adam.py::_adam_kernel`` to a CUDA C++ kernel for Hopper
(``csrc/fused_adam.cu``; the source notes what bounds it and its design).

:func:`adam_update` updates a list of parameter leaves in place, each with
its own bias corrections. For CUDA tensors it launches the kernel through
:data:`kernel` (which checks device, dtype, contiguity and sizes in one pass
and raises on anything else) once per launch table of up to ``MAX_LEAVES``
leaves, so once for AlexNet's 16; for CPU tensors it runs
:func:`adam_update_reference`, the plain PyTorch version of the same rule,
leaf by leaf. There is no fallback between the two: a CUDA tensor never
reaches the plain version through this function.

The launch table (:func:`launch_tables`) is built here, from plain ints and
floats, so the CPU tests reach its chunk starts, alignment flags and
splitting; the kernel only reads it.

The JAX kernel returns new arrays; here ``p``, ``m`` and ``v`` are updated in
place, which keeps one copy of each in device memory.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np
import torch

from tpuddp_torch.ops import _build

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
    ],
    align=True,
)


def bias_corrections(step: int, betas: Tuple[float, float]) -> Tuple[float, float]:
    """``(1 - b1^t, 1 - b2^t)`` computed on the host in float32, as
    ``tpuddp/ops/fused_adam.py:87-89`` computes them."""
    t = np.float32(step)
    b1, b2 = np.float32(betas[0]), np.float32(betas[1])
    return float(np.float32(1) - b1**t), float(np.float32(1) - b2**t)


def adam_update_reference(
    p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, *,
    lr: float, betas: Tuple[float, float], eps: float, weight_decay: float,
    bc1: float, bc2: float,
) -> None:
    """Plain PyTorch version of the kernel for one leaf: the torch Adam rule
    with the L2 term, in the operation order of ``tpuddp/optim.py``'s Adam."""
    b1, b2 = betas
    if weight_decay:
        g = g + weight_decay * p
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * (g * g)
    p_new = p - lr * (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    m.copy_(m_new)
    v.copy_(v_new)
    p.copy_(p_new)


def launch_tables(
    ptrs: Sequence[Tuple[int, int, int, int]], numels: Sequence[int],
    bc1s: Sequence[float], bc2s: Sequence[float], chunk: int = CHUNK,
) -> List[np.ndarray]:
    """The kernel's launch tables for leaves given by their ``(p, g, m, v)``
    data pointers, element counts and bias corrections: one ``LEAF_DTYPE``
    array per launch, of at most ``MAX_LEAVES`` rows. Empty leaves are
    dropped. Within a table, ``chunk_start`` is the prefix sum of
    ``ceil(n / chunk)``; ``aligned`` is 1 when all four pointers are 16-byte
    aligned (the kernel's float4 path), else 0 (its scalar path)."""
    tables, rows, start = [], [], 0
    for (p, g, m, v), n, bc1, bc2 in zip(ptrs, numels, bc1s, bc2s, strict=True):
        if n == 0:
            continue
        if len(rows) == MAX_LEAVES:
            tables.append(np.array(rows, dtype=LEAF_DTYPE))
            rows, start = [], 0
        rows.append((p, g, m, v, n, start, bc1, bc2, (p | g | m | v) % 16 == 0))
        start += -(-n // chunk)
    if rows:
        tables.append(np.array(rows, dtype=LEAF_DTYPE))
    return tables


def _check(ps, gs, ms, vs, bc1s, bc2s) -> None:
    """One pass over the leaves: equal list lengths, one CUDA device (the
    current one), float32, contiguous, equal element counts per leaf."""
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
            if t.dtype != torch.float32:
                raise TypeError(f"fused_adam: {name}[{i}] is {t.dtype}, expected float32")
            if not t.is_contiguous():
                raise ValueError(f"fused_adam: {name}[{i}] is not contiguous")
            if t.numel() != n:
                raise ValueError(
                    f"fused_adam: {name}[{i}] has {t.numel()} elements, p[{i}] has {n}"
                )


class FusedAdamKernel:
    """The kernel's wrapper: builds and loads the library at first use,
    checks its arguments, launches once per launch table on PyTorch's current
    stream and counts launches in ``launches``."""

    def __init__(self):
        self.launches = 0
        self.build_log = ""
        self._lib = None
        self._fn = None

    def load(self):
        """Build (if needed) and load the library; return the C function."""
        if self._fn is None:
            path, self.build_log = _build.build(SOURCE, "fused_adam")
            lib = ctypes.CDLL(str(path))
            fn = lib.tpuddp_fused_adam_multi
            fn.argtypes = (
                [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64]
                + [ctypes.c_float] * 7 + [ctypes.c_void_p]
            )
            fn.restype = ctypes.c_int
            self._lib, self._fn = lib, fn
        return self._fn

    def __call__(
        self, ps, gs, ms, vs, *, lr, betas, eps, weight_decay, bc1s, bc2s
    ) -> None:
        if not ps:
            return
        _check(ps, gs, ms, vs, bc1s, bc2s)
        chunk = CHUNK
        tables = launch_tables(
            [(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr())
             for p, g, m, v in zip(ps, gs, ms, vs)],
            [p.numel() for p in ps], bc1s, bc2s, chunk,
        )
        if not tables:
            return
        fn = self.load()
        b1, b2 = betas
        stream = torch.cuda.current_stream(ps[0].device).cuda_stream
        for table in tables:
            err = fn(
                table.ctypes.data, len(table), chunk,
                lr, b1, 1.0 - b1, b2, 1.0 - b2, eps, weight_decay, stream,
            )
            if err != 0:
                raise RuntimeError(f"fused_adam kernel launch failed: CUDA error {err}")
            self.launches += 1


kernel = FusedAdamKernel()


def adam_update(
    ps, gs, ms, vs, *, lr, betas, eps, weight_decay, bc1s, bc2s
) -> None:
    """Update the leaves ``ps[i]`` (gradient ``gs[i]``, moments ``ms[i]``,
    ``vs[i]``, bias corrections ``bc1s[i]``, ``bc2s[i]``) in place: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if not ps:
        return
    hp = dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay)
    device = ps[0].device
    if device.type == "cuda":
        kernel(ps, gs, ms, vs, bc1s=bc1s, bc2s=bc2s, **hp)
    elif device.type == "cpu":
        leaves = list(zip(ps, gs, ms, vs, bc1s, bc2s, strict=True))
        for i, leaf in enumerate(leaves):
            for t in leaf[:4]:
                if t.device != device:
                    raise ValueError(f"fused_adam: leaf {i} has a tensor on {t.device}, p[0] on cpu")
        for p, g, m, v, bc1, bc2 in leaves:
            adam_update_reference(p, g, m, v, bc1=bc1, bc2=bc2, **hp)
    else:
        raise ValueError(f"fused_adam: unsupported device {device}")
