"""The host row gather (``gather.cpp``) through ``ctypes`` — the counterpart
of ``tpuddp/data/_native/__init__.py``.

The library is built with ``g++ -O3 -march=native -shared -fPIC`` at first
use into ``build/tpuddp_torch/`` at the root of the checkout, keyed by a hash
of the source, the flags and the host's ISA (``-march=native`` code built on
one CPU can fault on an older one), and published by an atomic rename. A
failed build or load raises with the compiler's output; nothing falls back to
numpy. ``ctypes`` releases the interpreter lock for the call, so
``PrefetchLoader`` workers gather in parallel.

:func:`gather_rows` checks its arguments before the call: a C-contiguous
source with at least one row, at least one index, every index in range
(``IndexError`` otherwise, where numpy would wrap a negative one).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from tpuddp_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "gather.cpp"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
ABI_VERSION = 1


def isa_tag() -> str:
    """The machine and a hash of the CPU's feature flags
    (``tpuddp/data/_native/__init__.py:24-39``)."""
    flags = b""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"flags", b"Features")):
                    flags = b" ".join(sorted(line.split(b":", 1)[1].split()))
                    break
    except OSError:
        pass
    return f"{platform.machine()}-{hashlib.sha256(flags).hexdigest()[:8]}"


def build(source: Path = SOURCE, cxx: Optional[str] = None) -> Tuple[Path, str]:
    """Return ``(library path, compiler log)``, building when no library for
    this source, these flags and this ISA exists yet (the log is empty
    then). ``cxx`` is the compiler, ``$CXX`` or ``g++`` by default."""
    source = Path(source)
    cxx = cxx or os.environ.get("CXX") or "g++"
    key = hashlib.sha256(
        source.read_bytes() + " ".join(CXX_FLAGS).encode() + isa_tag().encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"libtpuddp_gather-{key}.so"
    if out.exists():
        return out, ""
    if shutil.which(cxx) is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found; the row gather cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, str(source), "-o", str(tmp), "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{cxx} failed ({proc.returncode}) building {source}:\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


class Library:
    """The gather library of one process, built and loaded at first use."""

    def __init__(self, source: Path = SOURCE):
        self.source = source
        self.path: Optional[Path] = None
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self.path, self.build_log = build(self.source)
                lib = ctypes.CDLL(str(self.path))
                fn = lib.tpuddp_torch_gather_rows
                fn.argtypes = [
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
                ]
                fn.restype = None
                lib.tpuddp_torch_gather_abi_version.argtypes = []
                lib.tpuddp_torch_gather_abi_version.restype = ctypes.c_int
                version = lib.tpuddp_torch_gather_abi_version()
                if version != ABI_VERSION:
                    raise RuntimeError(
                        f"{self.path}: gather ABI version {version}, expected {ABI_VERSION}"
                    )
                self._lib = lib
            return self._lib

    def gather_rows(self, src: np.ndarray, indices, pad_rows: int = 0) -> np.ndarray:
        """``src[indices]`` (rows of an ``(N, ...)`` array), padded to
        ``pad_rows`` rows by repeating the first gathered row."""
        if not isinstance(src, np.ndarray) or not src.flags["C_CONTIGUOUS"] or len(src) == 0:
            raise ValueError("gather_rows needs a C-contiguous array with at least one row")
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        if idx.ndim != 1 or len(idx) == 0:
            raise ValueError(f"gather_rows needs a 1-D list of at least one index, got {idx.shape}")
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0 or hi >= len(src):
            bad = lo if lo < 0 else hi
            raise IndexError(f"index {bad} is out of bounds for {len(src)} rows")
        out = np.empty((max(len(idx), int(pad_rows)),) + src.shape[1:], dtype=src.dtype)
        address = lambda a: a.__array_interface__["data"][0]  # cheaper than a.ctypes.data
        self.load().tpuddp_torch_gather_rows(
            address(src), src.strides[0], address(idx), len(idx), len(out), address(out), 0,
        )
        return out


library = Library()


def load() -> ctypes.CDLL:
    return library.load()


def gather_rows(src: np.ndarray, indices, pad_rows: int = 0) -> np.ndarray:
    return library.gather_rows(src, indices, pad_rows)
