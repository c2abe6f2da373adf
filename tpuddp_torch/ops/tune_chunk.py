"""Time the Adam kernel on AlexNet's 16 leaves at several chunk sizes, in
turns with ``torch.optim.Adam(fused=True)`` on one card, to choose
``fused_adam.CHUNK``:

    python -m tpuddp_torch.ops.tune_chunk [--chunks 1024,2048,4096,8192,16384]

The kernel is launched through its C entry with a table built for each
size, without the wrapper's checks. Each size is timed twice, in the order
given and then reversed, with the library call between the passes; CUDA
events over 20 steps after 3 warm-up steps, best of the two. Prints one line
per size and the card's name and power limit. Needs a GPU and nvcc; exits 1
without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from tpuddp_torch.models import AlexNet
from tpuddp_torch.ops import fused_adam

HP = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", default="1024,2048,4096,8192,16384")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_chunk: no GPU", file=sys.stderr)
        return 1
    chunks = [int(c) for c in args.chunks.split(",")]
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = [
        torch.nn.Parameter(torch.randn(p.shape, generator=gen, device="cuda"))
        for p in AlexNet(num_classes=10).parameters()
    ]
    leaves = []
    for p in params:
        p.grad = torch.randn(p.shape, generator=gen, device="cuda")
        leaves.append((p.detach(), p.grad, torch.zeros_like(p), torch.zeros_like(p)))
    ptrs = [tuple(t.data_ptr() for t in leaf) for leaf in leaves]
    numels = [leaf[0].numel() for leaf in leaves]
    bc1, bc2 = fused_adam.bias_corrections(1, HP["betas"])
    b1, b2 = HP["betas"]
    fn = fused_adam.kernel.load()
    stream = torch.cuda.current_stream().cuda_stream
    library = torch.optim.Adam(params, fused=True, lr=HP["lr"], betas=HP["betas"], eps=HP["eps"])

    def kernel_at(chunk):
        (table,) = fused_adam.launch_tables(ptrs, numels, [bc1] * len(ptrs), [bc2] * len(ptrs), chunk)

        def run():
            err = fn(table.ctypes.data, len(table), chunk, HP["lr"], b1, 1.0 - b1, b2,
                     1.0 - b2, HP["eps"], HP["weight_decay"], stream)
            if err != 0:
                raise RuntimeError(f"fused_adam kernel launch failed: CUDA error {err}")
        return run

    times = {c: [] for c in chunks}
    library_ms = []
    for order in (chunks, chunks[::-1]):
        for c in order:
            times[c].append(time_ms(kernel_at(c)))
        library_ms.append(time_ms(library.step))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    for c in chunks:
        print(json.dumps({"chunk": c, "kernel_ms": min(times[c]), "runs": times[c]}))
    print(json.dumps({"library_ms": min(library_ms), "runs": library_ms, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
