"""CUDA-graph replay of K steps as one dispatch: the counterpart of the JAX
package's ``lax.scan`` over K batches, which compiles one program per K and
dispatches each group of that length as one call. One engine,
:class:`StepGraphs`, serves the three callers that run such groups:

- the managed ``fuse_steps`` queue (``tpuddp/accelerate.py:847-922,
  :1266-1296``): each flush of K queued steps;
- the native ``scan_steps`` chunks: K train steps (K / A accumulation
  cycles; ``tpuddp/training/step.py:840-1100``) and K eval batches
  (``:1155-1185``), :meth:`~tpuddp_torch.parallel.ddp.
  DistributedDataParallel.train_step_many` and ``eval_step_many``;
- the managed ``FusedEvaluator``'s groups of K test batches
  (``tpuddp/accelerate.py:221-387``).

A caller hands :meth:`StepGraphs.run` a signature (a dictionary key: K and
everything else that a capture holds fixed, such as each step's input
shapes and dtypes and whether it has a flip mask, the criterion, the
augment or transform, the clip, the trained parameters, the optimizer's
hyperparameters, which reach the captured kernels by value, and the comm
hook, its top-k density and bucket plan), the objects
whose ids the key takes, the group's input tensors and a function of those
inputs that runs the K steps and returns the group's output (a tensor or a
tuple of tensors). For each signature

- the first group runs eagerly: the warm-up that cuDNN, cuBLAS and the
  optimizer's lazily created state need, which also counts the device words
  of the per-step scalars that its capture will take;
- the second is captured, then replayed;
- every later one is replayed.

An epoch of N steps of one batch shape at depth K therefore has at most two
graphs per caller, K steps and the remainder, each captured once and
replayed every epoch after. The graphs of one engine share one memory pool.

A replay's inputs are copied into the graph's static slots first, one
device-to-device copy per tensor (allocated before the capture, so no
kernel of the graph uses them as scratch). The per-step scalars of the
optimizer (step counts, bias corrections, rounding noise) are advanced on
the host and uploaded before the replay (:mod:`tpuddp_torch.ops.
device_scalars`); ``on_replay`` advances what else the caller counts on the
host. The caller gets a copy of the graph's static output, which the next
replay overwrites.

Dropout draws from PyTorch's CUDA generator, which a capture registers: each
replay advances it as the eager steps would. Flip masks are drawn on the
host before the group, in step order, and enter as inputs; nothing inside a
group may read a device value on the host or copy from host memory.

State that a group updates and later groups read (parameters, optimizer
state, the comm hook's error-feedback residual) lives in tensors allocated
before the capture and is updated in place, so a replay and the eager
steps it stands for leave the same state. Under the numerical guard that
state includes the firewall's verdict, its skip counters and residual
staging vector, and the optimizer's device step count: a guarded step
decides a skip and advances its count on the device, and registers no
per-step scalars, so the host uploads nothing before a replay that
depends on a skip.

The segmented-overlap exchange (``training/step.py::SegmentedSync``) forks
each segment's work onto a side stream from a gradient hook, which the
autograd engine runs on its own thread (hence ``capture_error_mode=
"thread_local"``), and joins it before the clip: every fork joins inside
the capture, so the graph holds the side stream's branch, and a replay
runs it beside the backward as the eager step does.

A failed capture or replay raises; nothing falls back to eager steps.
``clear()`` drops every graph (anything that replaces the storage that a
graph's replays write must call it). At world > 1 the captures hold the
NCCL collectives of each step; that path has not run on a card yet. A
group at world > 1 on a Gloo process group (``$TPUDDP_BACKEND=gloo``, as a
two-host world on one card runs) raises ``ValueError`` before any work
(:func:`check_capturable`): Gloo moves the data in host code, which a CUDA
graph cannot hold (a captured Gloo all-reduce fails the capture on an
H100), so such runs take ``scan_steps: 1`` and ``fuse_steps: 1``.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from tpuddp_torch.ops import device_scalars


def _counts() -> dict:
    return {"captures": 0, "replays": 0, "capture_s": 0.0}


# counts over the process, in total and by caller kind ("fused", "train",
# "eval", "managed eval"), read (and reset) by chip_smoke.py
stats = {**_counts(), "by_kind": {}}


def _kind_counts(kind: str) -> dict:
    return stats["by_kind"].setdefault(kind, _counts())


def shapes(tensors) -> tuple:
    """The shapes and dtypes of ``tensors`` (None for a missing one)."""
    return tuple(None if t is None else (tuple(t.shape), t.dtype) for t in tensors)


def hyperparameters(optimizer) -> tuple:
    """Each parameter group's hyperparameters, which a capture holds by
    value."""
    return tuple(tuple(sorted((k, repr(v)) for k, v in group.items() if k != "params"))
                 for group in optimizer.param_groups)


def check_capturable() -> None:
    """``ValueError`` when the process group is Gloo at world > 1: its
    collectives cannot be captured into a CUDA graph, and a group is never
    run eagerly in a graph's place."""
    if dist.is_initialized() and dist.get_world_size() > 1 and dist.get_backend() == "gloo":
        raise ValueError(
            "a CUDA-graph group (scan_steps or fuse_steps > 1) at world "
            f"{dist.get_world_size()} on a Gloo process group: Gloo's collectives run in host "
            "code, which a CUDA graph cannot capture. Set scan_steps: 1 (native) or "
            "fuse_steps: 1 (managed), or use NCCL (one process per GPU)"
        )


def check_graph_safe(optimizer) -> None:
    """A captured optimizer step must read its per-step scalars from the
    device (``GRAPH_SAFE``, the optimizers of :mod:`tpuddp_torch.optim`)."""
    if not getattr(optimizer, "GRAPH_SAFE", False):
        raise TypeError(
            f"K steps per CUDA-graph replay need an optimizer of tpuddp_torch.optim; "
            f"got {type(optimizer).__name__}"
        )


def signature(opt, queue) -> tuple:
    """The managed flush's key: per step the shapes and dtypes of ``x``,
    ``y``, ``w`` and the flip mask (None without one) and the criterion;
    the augment, the clip, the parameters that train, the optimizer's
    hyperparameters and the comm hook with its density. Objects enter by
    ``id``; :class:`StepGraphs` keeps them alive while the key is in use, so
    no id is reused."""
    model = opt.model
    steps = tuple(shapes((req.x, req.y, req.w, req.flip_mask)) + (id(req.criterion),)
                  for req in queue)
    acc = model.accelerator
    return (steps, id(acc.augment), acc.clip_grad_norm,
            tuple(id(p) for p in model._params()), hyperparameters(opt.optimizer),
            acc.comm_hook, acc.topk_density)


def held(opt, queue) -> tuple:
    """The objects whose ids :func:`signature` takes."""
    model = opt.model
    return (tuple(req.criterion for req in queue), model.accelerator.augment,
            tuple(model._params()))


class _Graph:
    """One captured signature: the graph, its static input slots and
    output, and its scalar slots."""

    def __init__(self, kind, graph, slots, output, recorder):
        self.kind = kind
        self.graph = graph
        self.slots = slots
        self.output = output
        self.recorder = recorder


class StepGraphs:
    """The CUDA graphs of one model's groups of steps, by signature."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = None
        self._graphs: Dict[tuple, _Graph] = {}
        self._words: Dict[tuple, int] = {}  # signature -> scalar words, counted at its warm-up
        self._held: Dict[tuple, tuple] = {}  # signature -> the objects of its ids

    def clear(self) -> None:
        self._graphs.clear()
        self._words.clear()
        self._held.clear()

    def run(self, kind: str, key: tuple, held: tuple, inputs: Sequence[Optional[torch.Tensor]],
            body: Callable, on_replay: Optional[Callable[[], None]] = None):
        """The group of signature ``key`` (of caller ``kind``) on
        ``inputs``: ``body(inputs)`` eagerly at the signature's first group,
        captured at its second, replayed after. ``on_replay()`` runs before
        each replay after the capture's own. Returns the group's output."""
        key = (kind, key)
        graph = self._graphs.get(key)
        if graph is not None:
            self._load(graph.slots, inputs)
            graph.recorder.refresh()  # step counts advance; this group's scalars
            graph.recorder.upload()
            if on_replay is not None:
                on_replay()
            return self._launch(graph)
        check_capturable()  # before the signature's eager group, and again before its capture
        if key in self._words:
            graph = self._graphs[key] = self._capture(kind, inputs, body, self._words[key])
            return self._launch(graph)
        with device_scalars.Recorder(self.device) as counter:
            out = body(list(inputs))
        self._words[key] = counter.words
        self._held[key] = held
        return out

    @staticmethod
    def _load(slots, inputs) -> None:
        for dst, src in zip(slots, inputs):
            if dst is not None:
                dst.copy_(src, non_blocking=True)

    def _capture(self, kind: str, inputs, body: Callable, words: int) -> _Graph:
        """Capture ``body`` on static copies of ``inputs`` into one graph.
        The capture runs the steps' host code once, which is this group's:
        step counts and scalars (:meth:`run` then replays it for this
        group); ``words`` is what the signature's warm-up counted."""
        slots = [None if t is None else torch.empty_like(t) for t in inputs]
        self._load(slots, inputs)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        recorder = device_scalars.Recorder(self.device, capacity=words)
        t0 = time.perf_counter()
        # no cyclic garbage collection during the capture: a dead cycle that
        # holds another CUDA graph (an earlier model's) would destroy it
        # mid-capture, which CUDA refuses, and the capture fails
        collecting = gc.isenabled()
        gc.disable()
        try:
            # thread_local: the loader threads may touch the CUDA runtime meanwhile
            with recorder, torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
                output = body(slots)
        finally:
            if collecting:
                gc.enable()
        seconds = time.perf_counter() - t0
        for c in (stats, _kind_counts(kind)):
            c["captures"] += 1
            c["capture_s"] += seconds
        recorder.upload()  # the scalars the capture computed: this group's
        return _Graph(kind, graph, slots, output, recorder)

    @staticmethod
    def _launch(graph: _Graph):
        graph.graph.replay()
        for c in (stats, _kind_counts(graph.kind)):
            c["replays"] += 1
        out = graph.output
        return tuple(t.clone() for t in out) if isinstance(out, tuple) else out.clone()


def reset_stats() -> None:
    stats.update(_counts(), by_kind={})
