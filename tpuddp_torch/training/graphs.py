"""CUDA-graph replay of the managed path's fused steps — the counterpart of the
JAX package's fused scan (``tpuddp/accelerate.py:847-922, :1266-1296``),
which compiles one program per queue length and dispatches each flush of
that length as one call.

:class:`StepGraphs` belongs to one :class:`~tpuddp_torch.accelerate.
PreparedOptimizer` on a CUDA model. It keeps one ``torch.cuda.CUDAGraph``
of K whole steps (augment, forward, backward, the loss-share and gradient
all-reduces, the clip and the update of each) for each flush signature
(:func:`signature`): the queue length K and everything else a capture holds
fixed, that is each step's input shapes and dtypes and whether it has a
flip mask, the criterion, the augment, the clip, the trained parameters and
the optimizer's hyperparameters. For each signature

- the first flush runs eagerly: the warm-up that cuDNN, cuBLAS and the
  optimizer's lazily created state need, which also counts the device words
  of the per-step scalars that its capture will take;
- the second is captured, then replayed;
- every later one is replayed.

An epoch of N steps of one batch shape at depth K therefore has at most two
graphs, K steps and the remainder ``N mod K``, each captured once and
replayed every epoch after. The graphs share one memory pool.

A replay's inputs are copied into the graph's static slots first, one
device-to-device copy per tensor (batch, labels, weights, flip mask). The
per-step scalars of the optimizer (step counts, bias corrections, rounding
noise) are advanced on the host and uploaded before the replay
(:mod:`tpuddp_torch.ops.device_scalars`), and the optimizer's ``updates``
advances by what the capture counted (the Adam kernel counts its launches
on the device, replayed ones included). The queued losses get a copy of the
graph's static ``(K,)`` loss vector, which the next replay overwrites.

Dropout draws from PyTorch's CUDA generator, which a capture registers: each
replay advances it as the eager steps would. The flip masks are drawn on the
host at ``backward()``, as the eager steps draw them, and enter as inputs.

A failed capture or replay raises; nothing falls back to the eager queue.
``clear()`` drops every graph (``load_model``/``load_state`` replace the
storage that a graph's replays would write). At world > 1 the captures hold
the NCCL all-reduces of each step; that path has not run on a card yet.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import torch

from tpuddp_torch.ops import device_scalars

# counts over the process, read (and reset) by chip_smoke.py
stats = {"captures": 0, "replays": 0, "capture_s": 0.0}


class _Graph:
    """One captured flush signature: the graph, its static inputs and loss
    vector, its scalar slots and the updates one replay makes."""

    def __init__(self, graph, inputs, losses, recorder, updates: int):
        self.graph = graph
        self.inputs = inputs  # per step: (x, y, w, flip mask or None)
        self.losses = losses
        self.recorder = recorder
        self.updates = updates


def signature(opt, queue) -> tuple:
    """What a graph captured from ``queue`` holds fixed, as a dictionary
    key: per step the shapes and dtypes of ``x``, ``y``, ``w`` and the flip
    mask (None without one) and the criterion; the augment, the clip, the
    parameters that train and each parameter group's hyperparameters
    (``lr`` and the rest reach the captured kernels by value). Objects enter
    by ``id``; :class:`StepGraphs` keeps them alive while the key is in
    use, so no id is reused."""
    model = opt.model
    steps = tuple(
        tuple(None if t is None else (tuple(t.shape), t.dtype)
              for t in (req.x, req.y, req.w, req.flip_mask)) + (id(req.criterion),)
        for req in queue
    )
    acc = model.accelerator
    hyper = tuple(tuple(sorted((k, repr(v)) for k, v in group.items() if k != "params"))
                  for group in opt.optimizer.param_groups)
    return (steps, id(acc.augment), acc.clip_grad_norm,
            tuple(id(p) for p in model._params()), hyper)


def _held(opt, queue) -> tuple:
    """The objects whose ids :func:`signature` takes."""
    model = opt.model
    return (tuple(req.criterion for req in queue), model.accelerator.augment,
            tuple(model._params()))


class StepGraphs:
    """The CUDA graphs of one managed optimizer's flushes, by
    :func:`signature`."""

    def __init__(self, optimizer):
        if not getattr(optimizer.optimizer, "GRAPH_SAFE", False):
            raise TypeError(
                f"fused steps on a CUDA model replay CUDA graphs, which need an optimizer "
                f"of tpuddp_torch.optim; got {type(optimizer.optimizer).__name__}"
            )
        self.opt = optimizer
        self.pool = None
        self._graphs: Dict[tuple, _Graph] = {}
        self._words: Dict[tuple, int] = {}  # signature -> scalar words, counted at its warm-up
        self._held: Dict[tuple, tuple] = {}  # signature -> the objects of its ids

    def clear(self) -> None:
        self._graphs.clear()
        self._words.clear()
        self._held.clear()

    def run(self, queue) -> None:
        key = signature(self.opt, queue)
        graph = self._graphs.get(key)
        if graph is not None:
            self._replay(graph, queue)
        elif key in self._words:
            self._graphs[key] = self._capture(queue, self._words[key])
        else:
            with device_scalars.Recorder(self.opt.model.device) as counter:
                self.opt._run_eager(queue)
            self._words[key] = counter.words
            self._held[key] = _held(self.opt, queue)

    @staticmethod
    def _load_inputs(inputs, queue) -> None:
        for slots, req in zip(inputs, queue):
            for dst, src in zip(slots, (req.x, req.y, req.w, req.flip_mask)):
                if dst is not None:
                    dst.copy_(src, non_blocking=True)

    def _capture(self, queue, words: int) -> _Graph:
        """Capture the K steps of ``queue`` into one graph, then replay it
        for this flush. The capture runs the steps' host code once, which
        is this flush's: step counts, scalars and updates; ``words`` is
        what the signature's warm-up counted."""
        opt, model = self.opt, self.opt.model
        device = model.device
        inputs = [tuple(None if t is None else torch.empty_like(t)
                        for t in (req.x, req.y, req.w, req.flip_mask)) for req in queue]
        self._load_inputs(inputs, queue)
        losses = torch.empty(len(queue), device=device)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        recorder = device_scalars.Recorder(device, capacity=words)
        updates = opt.updates
        t0 = time.perf_counter()
        # no cyclic garbage collection during the capture: a dead cycle that
        # holds another CUDA graph (an earlier model's) would destroy it
        # mid-capture, which CUDA refuses, and the capture fails
        collecting = gc.isenabled()
        gc.disable()
        try:
            # thread_local: the loader threads may touch the CUDA runtime meanwhile
            with recorder, torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
                for i, (req, (x, y, w, mask)) in enumerate(zip(queue, inputs)):
                    value, _ = model._execute(req._replace(x=x, y=y, w=w, flip_mask=mask))
                    losses[i].copy_(value)
                    opt._apply()
        finally:
            if collecting:
                gc.enable()
        stats["captures"] += 1
        stats["capture_s"] += time.perf_counter() - t0
        captured = _Graph(graph, inputs, losses, recorder, opt.updates - updates)
        recorder.upload()  # the scalars the capture computed: this flush's
        self._launch(captured, queue)
        return captured

    def _replay(self, graph: _Graph, queue) -> None:
        self._load_inputs(graph.inputs, queue)
        graph.recorder.refresh()  # step counts advance; this flush's scalars
        graph.recorder.upload()
        self.opt.updates += graph.updates
        self._launch(graph, queue)

    @staticmethod
    def _launch(graph: _Graph, queue) -> None:
        graph.graph.replay()
        stats["replays"] += 1
        out = graph.losses.clone()
        for i, req in enumerate(queue):
            req.loss._value = out[i]


def reset_stats() -> None:
    stats.update(captures=0, replays=0, capture_s=0.0)

