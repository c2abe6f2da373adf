"""Fused Adam update — the port of the Pallas TPU kernel
``tpuddp/ops/fused_adam.py::_adam_kernel`` to a CUDA C++ kernel for Hopper
(``csrc/fused_adam.cu``; the source notes what bounds it and its design).

:func:`adam_update` updates one parameter leaf in place. For a CUDA tensor it
launches the kernel through :data:`kernel` (which checks device, dtype,
contiguity and sizes and raises on anything else); for a CPU tensor it runs
:func:`adam_update_reference`, the plain PyTorch version of the same rule.
There is no fallback between the two: a CUDA tensor never reaches the plain
version through this function.

The JAX kernel returns new arrays; here ``p``, ``m`` and ``v`` are updated in
place, which keeps one copy of each in device memory.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from tpuddp_torch.ops import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_adam.cu"


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
    """Plain PyTorch version of the kernel: the torch Adam rule with the L2
    term, in the operation order of ``tpuddp/optim.py``'s Adam."""
    b1, b2 = betas
    if weight_decay:
        g = g + weight_decay * p
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * (g * g)
    p_new = p - lr * (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    m.copy_(m_new)
    v.copy_(v_new)
    p.copy_(p_new)


def _check(p, g, m, v) -> None:
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"fused_adam: {name} is on {t.device}, expected cuda")
        if t.dtype != torch.float32:
            raise TypeError(f"fused_adam: {name} is {t.dtype}, expected float32")
        if not t.is_contiguous():
            raise ValueError(f"fused_adam: {name} is not contiguous")
        if t.device != p.device:
            raise ValueError(f"fused_adam: {name} is on {t.device}, p on {p.device}")
        if t.numel() != p.numel():
            raise ValueError(
                f"fused_adam: {name} has {t.numel()} elements, p has {p.numel()}"
            )
    if p.device.index != torch.cuda.current_device():
        raise ValueError(
            f"fused_adam: tensors on {p.device} but the current device is "
            f"cuda:{torch.cuda.current_device()}"
        )


class FusedAdamKernel:
    """The kernel's wrapper: builds and loads the library at first use,
    checks its arguments, launches on PyTorch's current stream and counts
    launches in ``launches``."""

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
            fn = lib.tpuddp_fused_adam
            fn.argtypes = (
                [ctypes.c_void_p] * 4 + [ctypes.c_int64]
                + [ctypes.c_float] * 9 + [ctypes.c_void_p]
            )
            fn.restype = ctypes.c_int
            self._lib, self._fn = lib, fn
        return self._fn

    def __call__(
        self, p, g, m, v, *, lr, betas, eps, weight_decay, bc1, bc2
    ) -> None:
        _check(p, g, m, v)
        n = p.numel()
        if n == 0:
            return
        fn = self.load()
        b1, b2 = betas
        err = fn(
            p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), n,
            lr, b1, 1.0 - b1, b2, 1.0 - b2, eps, weight_decay, bc1, bc2,
            torch.cuda.current_stream(p.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"fused_adam kernel launch failed: CUDA error {err}")
        self.launches += 1


kernel = FusedAdamKernel()


def adam_update(p, g, m, v, *, lr, betas, eps, weight_decay, bc1, bc2) -> None:
    """Update one leaf in place: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    kwargs = dict(
        lr=lr, betas=betas, eps=eps, weight_decay=weight_decay, bc1=bc1, bc2=bc2
    )
    if p.device.type == "cuda":
        kernel(p, g, m, v, **kwargs)
    elif p.device.type == "cpu":
        adam_update_reference(p, g, m, v, **kwargs)
    else:
        raise ValueError(f"fused_adam: unsupported device {p.device}")
