"""Smoke test of the PyTorch/CUDA port on one GPU: the quickest proof that
``tpuddp_torch`` still builds its kernels and trains on the card.

    python chip_smoke.py

Phases, each printing one line (the first failure exits non-zero):

1. a CUDA device exists; print ``nvidia-smi``'s name and power limit;
2. build every kernel of the main path from the sources in the checkout;
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes and at odd ones (misaligned views, leaves of 1, 3 and
   4 elements, 100 leaves over three launches), and time kernel, plain
   version and ``torch.optim.Adam(fused=True)`` (a yardstick, never called
   by the port) in turns with CUDA events, beside the host's enqueue time
   and the card's bound for the same work;
4. drive the main path once — the ``train_native`` worker in-process on
   ``cuda:0`` with ``tpuddp_torch/configs/cifar10_alexnet_h100.yaml``:
   AlexNet at 224 px, batch 128, one epoch (16 train steps and 6 eval
   batches on the synthetic CIFAR-10 stand-in, no checkpoint) — and check
   that every train step went through the kernel, in one launch, and that
   the losses are finite.

Then one JSON line with every kernel's numbers, the card's name and power
limit again, and last ``{"ok": true, "device": {...}}``. Without a GPU, or
outside a checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from functools import partial

import torch

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False; no GPU", file=sys.stderr)
    sys.exit(1)

from tpuddp_torch import config as cfg_lib  # noqa: E402
from tpuddp_torch.models import AlexNet  # noqa: E402
from tpuddp_torch.ops import fused_adam  # noqa: E402
from tpuddp_torch.parallel.spawn import run_ddp_training  # noqa: E402
from tpuddp_torch.train_native import basic_ddp_training_loop  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
SETTINGS = os.path.join(ROOT, "tpuddp_torch", "configs", "cifar10_alexnet_h100.yaml")

# Tolerances of the kernel against its plain version (IEEE float32 both;
# they differ only where the kernel fuses a multiply-add that the plain
# version rounds twice).
P_TOL, MOMENT_TOL = 1e-5, 1e-6
ODD_SHAPES = [(37, 50), (5,), (700, 130)]
# csrc/fused_adam.cu's design: all leaves in one launch, 16-byte streaming
# accesses (its header says more)
DESIGN = "vec4-multi"
STEPS = 3
HP = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8)

# Published peaks (NVIDIA data sheets): memory bytes/s and float32 FLOP/s
# outside the tensor cores, by a substring of the card's name.
PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H200", 4.8e12, 67e12),
    ("H100", 3.35e12, 67e12),
)
ADAM_OPS_PER_ELEMENT = 14  # m: 3, v: 4, p: 7 (no weight decay)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def peaks_for(name: str):
    for key, bw, flops in PEAKS:
        if key in name:
            return bw, flops
    raise SystemExit(f"chip_smoke: no published peaks for card {name!r}")


def make_leaves(shapes, seed: int, misaligned: str = ""):
    """(p, g, m, v) per leaf on the card; the tensors named in `misaligned`
    are views at storage offset 1, 4 bytes off 16-byte alignment."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    leaves = []
    for shape in shapes:
        leaf = [torch.randn(shape, generator=gen, device="cuda") for _ in range(2)]
        leaf += [torch.zeros(shape, device="cuda"), torch.zeros(shape, device="cuda")]
        for i, name in enumerate("pgmv"):
            if name in misaligned:
                view = torch.empty(leaf[i].numel() + 1, device="cuda")[1:]
                leaf[i] = view.view(shape).copy_(leaf[i])
        leaves.append(tuple(leaf))
    return leaves


def clone(leaves):
    return [tuple(t.clone() for t in leaf) for leaf in leaves]


def step_bcs(t, n_leaves):
    """Per-leaf bias corrections: leaf i at step t + i % 3, as parameters
    whose step counts differ."""
    return [fused_adam.bias_corrections(t + i % 3, HP["betas"]) for i in range(n_leaves)]


def kernel_step(leaves, bcs, weight_decay):
    ps, gs, ms, vs = (list(x) for x in zip(*leaves))
    fused_adam.kernel(ps, gs, ms, vs, bc1s=[b[0] for b in bcs], bc2s=[b[1] for b in bcs],
                      weight_decay=weight_decay, **HP)


def plain_step(leaves, bcs, weight_decay):
    for (p, g, m, v), (bc1, bc2) in zip(leaves, bcs):
        fused_adam.adam_update_reference(p, g, m, v, weight_decay=weight_decay,
                                         bc1=bc1, bc2=bc2, **HP)


def max_diffs(a, b):
    return [
        max(float((x[i] - y[i]).abs().max()) for x, y in zip(a, b))
        for i in (0, 2, 3)  # p, m, v
    ]


def time_ms(fn, iters: int = 20, warmup: int = 3):
    """(device ms, enqueue ms) per call: CUDA events around `iters` calls,
    and the host clock around the same enqueues without synchronising. When
    the two are close, the host sets the pace."""
    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / iters
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters, enqueue_ms


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    card = card_line()
    phase("1 device", f"{name}; nvidia-smi: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} visible")
    bw, flops = peaks_for(name)

    t0 = time.perf_counter()
    fused_adam.kernel.load()
    build_s = time.perf_counter() - t0
    ptxas = " | ".join(
        line.strip() for line in fused_adam.kernel.build_log.splitlines()
        if "registers" in line or "spill" in line
    )
    phase("2 build", f"fused_adam.cu built and loaded in {build_s:.2f} s; ptxas: {ptxas}")

    with torch.device("meta"):
        alexnet_shapes = [tuple(t.shape) for t in AlexNet(num_classes=10).parameters()]
    n_leaves = len(alexnet_shapes)
    n_params = sum(math.prod(s) for s in alexnet_shapes)
    chunk = fused_adam.CHUNK
    hundred = [(1 + (i * 7919) % 40000,) for i in range(97)]
    hundred += [(chunk - 1,), (chunk,), (chunk + 1,)]
    cases = [
        ("AlexNet", alexnet_shapes, "", 0.0),
        ("odd shapes", ODD_SHAPES, "", 1e-2),
        ("odd shapes", ODD_SHAPES, "", 0.0),
        *[(f"odd shapes, {t} a misaligned view", ODD_SHAPES, t, 1e-2) for t in "pgmv"],
        ("sizes 1, 3, 4", [(1,), (3,), (4,)], "", 0.0),
        ("100 leaves", hundred, "", 1e-2),
    ]
    errs = []
    for label, shapes, misaligned, wd in cases:
        kern = make_leaves(shapes, seed=len(shapes), misaligned=misaligned)
        plain = clone(kern)
        launches = fused_adam.kernel.launches
        for t in range(1, STEPS + 1):
            bcs = step_bcs(t, len(shapes))
            kernel_step(kern, bcs, wd)
            plain_step(plain, bcs, wd)
        torch.cuda.synchronize()
        launches = fused_adam.kernel.launches - launches
        want = STEPS * math.ceil(len(shapes) / fused_adam.MAX_LEAVES)
        dp, dm, dv = max_diffs(kern, plain)
        if not (dp <= P_TOL and dm <= MOMENT_TOL and dv <= MOMENT_TOL and launches == want):
            raise SystemExit(
                f"chip_smoke: fused_adam disagrees with its plain version on {label} "
                f"({len(shapes)} leaves, wd={wd}): |dp|={dp:.3g} |dm|={dm:.3g} "
                f"|dv|={dv:.3g}, {launches} launches (expected {want})"
            )
        errs.append(dp)
        phase("3 compare", f"fused_adam vs plain, {label}: {len(shapes)} leaves, wd={wd}, "
              f"{STEPS} steps, {launches} launches: max|dp|={dp:.3g} max|dm|={dm:.3g} "
              f"max|dv|={dv:.3g}")
    del kern, plain

    leaves = make_leaves(alexnet_shapes, seed=1)
    bcs = step_bcs(1, n_leaves)
    ps, gs, ms, vs = (list(x) for x in zip(*leaves))
    bc1s, bc2s = [b[0] for b in bcs], [b[1] for b in bcs]

    def kernel_run():
        fused_adam.kernel(ps, gs, ms, vs, bc1s=bc1s, bc2s=bc2s, weight_decay=0.0, **HP)

    params = [torch.nn.Parameter(p.clone()) for p in ps]
    for prm, g in zip(params, gs):
        prm.grad = g.clone()
    library = torch.optim.Adam(params, fused=True, **HP)
    # in turns on one card: plain, kernel, library, library, kernel, plain
    order = ("plain", "kernel", "library", "library", "kernel", "plain")
    fns = {"plain": partial(plain_step, leaves, bcs, 0.0), "kernel": kernel_run,
           "library": library.step}
    runs = {k: [] for k in fns}
    for k in order:
        runs[k].append(time_ms(fns[k]))
    (kernel_ms, kernel_enq), (plain_ms, _), (library_ms, library_enq) = (
        min(runs[k]) for k in ("kernel", "plain", "library")
    )
    nbytes = 7 * 4 * n_params  # read p, g, m, v; write p, m, v
    bytes_ms = nbytes / bw * 1e3
    ops_ms = ADAM_OPS_PER_ELEMENT * n_params / flops * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    each = " ".join(f"{k}=" + ",".join(f"{t_ms:.4f}" for t_ms, _ in runs[k]) for k in fns)
    phase("3 time", f"one AlexNet Adam step ({n_leaves} leaves, {n_params} params, "
          f"{nbytes / 1e9:.3f} GB), best of two in turns: kernel_ms={kernel_ms:.4f} "
          f"enqueue_ms={kernel_enq:.4f} library_ms={library_ms:.4f} "
          f"library_enqueue_ms={library_enq:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({nbytes / kernel_ms / 1e6:.0f} GB/s, "
          f"{100 * bound_ms / kernel_ms:.1f}% of bound; kernel/library "
          f"{kernel_ms / library_ms:.3f}); each run: {each}")
    del leaves, ps, gs, ms, vs, params, library
    torch.cuda.empty_cache()

    settings = cfg_lib.load_settings(SETTINGS)
    cfg_lib.check_settings(settings)
    training = cfg_lib.training_config(settings)
    # the synthetic stand-in by name, so a CIFAR-10 staged under data_root
    # cannot change the epoch's size; no save_dir, so no checkpoint is written
    training.update(num_epochs=1, dataset="synthetic", synthetic_n=(2048, 512))
    fused_adam.kernel.launches = 0
    t0 = time.perf_counter()
    history = run_ddp_training(
        partial(basic_ddp_training_loop, training=training, device="cuda"),
        1, None, cfg_lib.optional_args_from(settings), backend="cuda",
    )
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = fused_adam.kernel.launches
    row = history[-1]
    steps = len(row["step_ms"])
    checks = {
        "16 train steps": steps == 16,
        "1 launch per step": launches == steps,
        "finite losses": all(math.isfinite(row[k]) for k in ("train_loss", "test_loss")),
        "2048 train / 512 test samples": (row["train_samples"], row["test_samples"]) == (2048, 512),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"chip_smoke: main path failed {failed}: launches={launches}, "
                         f"steps={steps}, row={row}")
    steady = statistics.median(row["step_ms"][1:])
    phase("4 main path", f"AlexNet@224 b128, 1 epoch: {steps} steps, fused_adam "
          f"launches={launches} ({launches // steps}/step), train_loss="
          f"{row['train_loss']:.4f} test_loss={row['test_loss']:.4f}; step_ms "
          f"first={row['step_ms'][0]:.2f} median(2..{steps})={steady:.2f} "
          f"min={min(row['step_ms'][1:]):.2f}; {128 * 1e3 / steady:.0f} img/s; "
          f"epoch wall {wall_s:.2f} s")

    print(json.dumps({"kernels": [{
        "name": "fused_adam",
        "route": "cuda",
        "source": "tpuddp_torch/ops/csrc/fused_adam.cu",
        "replaces": "tpuddp/ops/fused_adam.py:71",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "launches_per_step": launches // steps,
        "enqueue_ms": kernel_enq,
        "design": DESIGN,
    }]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
