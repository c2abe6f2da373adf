"""Build a CUDA source with a plain C interface into a shared library.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into
``build/tpuddp_torch/`` at the root of the checkout, at first use, keyed by a
hash of the source and the flags: an unchanged source is built once. The
library is published by an atomic rename, so ranks that build at the same
time cannot load a half-written file. A failed build raises; nothing falls
back to a plain version.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpuddp_torch"

# No --use_fast_math: the kernels' tolerances assume IEEE float32 sqrt and
# division.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc`` or ``nvcc`` on
    the PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH); the CUDA kernels cannot be built"
        )
    return found


def build(source: Path, name: str, nvcc: str = None) -> Tuple[Path, str]:
    """Return ``(library path, compiler log)``, building when no library for
    this exact source exists yet. The log is empty when nothing was built."""
    source = Path(source)
    key = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"
    if out.exists():
        return out, ""
    nvcc = nvcc or find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {source}:\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr
