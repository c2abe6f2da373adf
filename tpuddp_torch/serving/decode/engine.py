"""Autoregressive decode engine — the counterpart of
``tpuddp/serving/decode/engine.py``: token-level continuous batching.

The request-granularity engine (:mod:`tpuddp_torch.serving.engine`) batches
whole requests: a request joins a batch once and leaves when the batch
returns. Token traffic inverts the granularity: a sequence occupies a *slot*
in the running batch for its whole generation, and the batch's membership
changes **every decode step** — a sequence that samples its stop token frees
its KV blocks immediately and a queued request prefills into the vacated
slot before the next step.

Two-program scheduling (the prefill/decode split):

- **prefill** — one prompt at a time, padded to a power-of-two length
  bucket: at most ``log2(max_prompt) + 1`` prefill shapes, each run once at
  warm-up, eagerly on the replica's stream. The prompt's K/V is committed
  into the paged pool and its last position's logits sample the FIRST
  generated token — TTFT's clock stops here.
- **decode** — ONE fixed-shape ``(max_slots, 1)`` step for every step,
  whatever subset of slots is live: per-slot block tables and lengths are
  ordinary int32 inputs. On a card each replica captures the step once as a
  CUDA graph over its own pools (:class:`DecodeReplica`) and every step is a
  replay: the tokens, lengths and tables go into the graph's static inputs
  by ``copy_`` from pinned host buffers, and the ``(S, V)`` logits come back
  in one host copy, which is the step's fence. On the CPU the same step
  runs eagerly.

Sampling runs on the host from the step's logits: greedy argmax, or
temperature softmax drawn from a per-sequence deterministic stream (seeded
by the request's seed and its own token index — never by batch
composition). Combined with per-slot-independent device math (one step
shape, so one kernel sequence, whichever slot a sequence holds), this makes
continuous batching numerically invisible: a sequence decodes to
bitwise-identical tokens whether it ran alone or packed among strangers.

Streaming: ``submit`` returns a :class:`StreamedResult`; every sampled
token is delivered to it as generated (``for tok in result.stream():``),
and ``result()`` still blocks for the full sequence.

Lifecycle mirrors the request engine: ``start()`` warms every prefill shape
and captures every replica's step graph before any loop thread runs,
``drain()`` closes admission and lets in-flight sequences finish, and the
``python -m tpuddp_torch.serving --decode`` entrypoint maps SIGTERM onto
drain + exit 75.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import logging
import queue as queue_lib
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from tpuddp_torch.models import TRANSFORMERS
from tpuddp_torch.models.transformer import TransformerLM, prefill_buckets
from tpuddp_torch.observability import MetricsWriter, schema
from tpuddp_torch.observability import trace as trace_lib
from tpuddp_torch.resilience import faults
from tpuddp_torch.serving import queue as queue_mod
from tpuddp_torch.serving import survive as survive_lib
from tpuddp_torch.serving.decode.cache import PagedKVCache
from tpuddp_torch.serving.decode.stats import DecodeStats
from tpuddp_torch.serving.engine import run_meta_header
from tpuddp_torch.serving.queue import AdmissionError, RequestQueue, ServedResult
from tpuddp_torch.serving.replica import (
    _restore_variables, seeded_model, serving_devices, set_numerics,
)
from tpuddp_torch.serving.survive import NoHealthyReplicaError, SurvivePolicy
from tpuddp_torch.utils import batching

logger = logging.getLogger("tpuddp")

_ids = itertools.count()
_STREAM_END = object()


class StreamedResult(ServedResult):
    """Future for one sequence's tokens, streamed as generated.

    ``stream()`` yields ints the moment the decode loop samples them;
    ``result(timeout)`` (inherited) blocks for the FULL sequence and returns
    it as an int32 array. A failed sequence raises through both paths."""

    def __init__(self):
        super().__init__()
        self._stream: "queue_lib.Queue" = queue_lib.Queue()
        self.first_token_at: Optional[float] = None

    def _deliver_token(self, token: int) -> None:
        if self.first_token_at is None:
            self.first_token_at = time.perf_counter()
        self._stream.put(int(token))

    def _deliver(self, value, error=None) -> None:
        super()._deliver(value, error=error)
        self._stream.put(_STREAM_END)

    def stream(self, timeout: Optional[float] = None):
        """Yield tokens as they are generated; raises the sequence's error
        (or TimeoutError on a stalled stream, matching ``result()``'s
        contract) instead of hanging."""
        while True:
            try:
                item = self._stream.get(timeout=timeout)
            except queue_lib.Empty:
                raise TimeoutError(
                    f"decode stream stalled: no token within {timeout}s"
                ) from None
            if item is _STREAM_END:
                if self._error is not None:
                    raise self._error
                return
            yield item


class DecodeRequest:
    """One admitted decode request. Duck-types the queue's ``Request``
    protocol (tenant / rows / key / id / t_enqueue) so :class:`RequestQueue`
    admission, per-tenant lanes, and round-robin fairness apply unchanged —
    every request is one row of the same key, so any group assembles.

    Survivability fields: ``deadline`` (absolute; a request still QUEUED
    past it is shed — an in-flight stream is never deadline-killed);
    ``resume_tokens`` is the session-failover journal — None for a fresh
    request, a list of the tokens already streamed to the client when the
    request is re-queued after its replica died (``[]`` = it died during
    prefill, before the first token); ``failed_from`` names the dead
    replica for the ``session_failover`` event."""

    __slots__ = (
        "id", "tenant", "tokens", "max_new_tokens", "temperature", "seed",
        "stop_token", "rows", "key", "t_enqueue", "result",
        "deadline", "resume_tokens", "failed_from", "failovers", "trace",
    )

    def __init__(
        self, tenant: str, tokens: np.ndarray, max_new_tokens: int,
        temperature: float, seed: int, stop_token: Optional[int],
        deadline: Optional[float] = None,
    ):
        self.id = next(_ids)
        self.tenant = str(tenant)
        self.tokens = tokens
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.stop_token = stop_token
        self.rows = 1
        self.key = ("decode",)
        self.t_enqueue = time.perf_counter()
        self.result = StreamedResult()
        self.deadline = deadline
        self.resume_tokens: Optional[List[int]] = None
        self.failed_from: Optional[int] = None
        # times this session was parked into its journal by a replica
        # incident; bounded by SurvivePolicy.max_failovers (the
        # poisoned-request firewall)
        self.failovers = 0
        # causal-tracing context (observability/trace.py; None = off):
        # {"root": Span, "open": Span|None, "last_id": int|None} — the one
        # tree this session keeps across queueing, prefill, AND failover,
        # so a resumed stream is a single trace with a follows_from edge
        self.trace = None

    @property
    def total_tokens(self) -> int:
        """Worst-case lifetime length — the KV budget reserved up front."""
        return len(self.tokens) + self.max_new_tokens


class _Active:
    """One sequence occupying a decode slot.

    ``replay`` (session failover): tokens this sequence already streamed to
    its client whose K/V must be re-committed on the new replica. While
    non-empty, each decode step feeds the next recorded token instead of
    sampling and delivers NOTHING (the client saw these tokens already);
    once the replay drains, live sampling resumes at token index
    ``n_generated`` — and because every K/V position was rebuilt by the
    same program kind that wrote it originally (prompt by prefill, replay
    tokens by the step) and sampling is keyed by ``(seed, index)`` only,
    the continued stream is bitwise the undisturbed one."""

    __slots__ = (
        "req", "slot", "last_token", "n_generated", "out", "t_last", "replay",
    )

    def __init__(self, req: DecodeRequest, slot: int, first_token: int):
        self.req = req
        self.slot = slot
        self.last_token = first_token
        self.n_generated = 1
        self.out = [first_token]
        self.t_last = time.perf_counter()
        self.replay: List[int] = []


def _sample(logits_row: np.ndarray, temperature: float, seed: int, index: int) -> int:
    """Host-side sampling. Greedy at temperature 0; otherwise softmax with a
    stream keyed by (request seed, token index) ONLY — two decodes of the
    same request sample identically whatever else shares their batch."""
    if temperature <= 0.0:
        return int(np.argmax(logits_row))
    rng = np.random.RandomState((seed * 1000003 + index * 7919 + 0x5D) & 0x7FFFFFFF)
    z = logits_row.astype(np.float64) / temperature
    z -= z.max()
    p = np.exp(z)
    p /= p.sum()
    return int(rng.choice(len(p), p=p))


class DecodeReplica:
    """One device's decode lane: its own copy of the model, a private
    :class:`PagedKVCache` with its K/V pool pair, and the stream all of its
    work runs on.

    On a card the step is ONE captured CUDA graph over this replica's pools
    (the counterpart of the JAX engine's one compiled ``(max_slots, 1)``
    program): :meth:`capture` records it on the replica's stream with
    ``capture_error_mode="thread_local"``, so a probation's recapture is not
    spoiled by the CUDA calls other replicas' loop threads make meanwhile,
    and :meth:`_step` replays it. The graph holds the pools' addresses, so
    the pools and the graph live and die together: :meth:`poison` drops both,
    after which every dispatch raises until :meth:`rebuild` makes fresh pools
    and the next warm-up captures the graph again. Prefill runs eagerly, one
    shape per bucket. On the CPU the step runs eagerly too.

    ``captures`` and ``replays`` count graph captures and replays;
    ``steps`` counts the decode steps the engine dispatched."""

    def __init__(self, index: int, device, model: TransformerLM, cfg: dict):
        self.index = index
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.on_card else None
        self.cache = PagedKVCache(
            layers=model.n_layers,
            heads=model.n_heads,
            head_dim=model.head_dim,
            num_blocks=int(cfg["kv_blocks"]),
            block_size=int(cfg["kv_block_size"]),
            max_slots=int(cfg["max_slots"]),
            max_seq_len=int(cfg["max_seq_len"]),
        )
        self._graph = None
        self._captured = None  # the (kpool, vpool) pair the graph was captured over
        self._logits = None  # the graph's output
        # every device tensor of the replica is made on its stream, the one
        # that uses it
        with self._on_stream():
            self.model = copy.deepcopy(model).to(self.device).eval()
            self.model.requires_grad_(False)
            self.kpool, self.vpool = self._fresh_pools()
            if self.on_card:
                s, mb, v = self.cache.max_slots, self.cache.max_blocks, model.vocab_size
                self._in = {  # the graph's static inputs and their pinned host mirrors
                    name: (torch.zeros(shape, dtype=torch.int32, device=self.device),
                           torch.zeros(shape, dtype=torch.int32, pin_memory=True))
                    for name, shape in (("tables", (s, mb)), ("lengths", (s,)), ("tokens", (s,)))
                }
                self._host_logits = torch.empty((s, v), dtype=torch.float32, pin_memory=True)
        self.steps = 0
        self.captures = 0
        self.replays = 0
        # survivability state machine (serving/survive.py): healthy ->
        # recovering (probation) -> healthy | removed. ``broken`` is an
        # injected replica_kill: every dispatch raises until rebuild()
        self.state = "healthy"
        self.recoveries = 0
        self.broken = False
        # True while this replica's decode-loop thread runs: the survivor
        # check must not hand failover journals to a peer whose loop exited
        self.loop_alive = False

    @property
    def healthy(self) -> bool:
        return self.state == "healthy"

    def _fresh_pools(self):
        shape = self.cache.pool_shape()
        with self._on_stream():
            return (torch.zeros(shape, dtype=torch.float32, device=self.device),
                    torch.zeros(shape, dtype=torch.float32, device=self.device))

    def _on_stream(self):
        return torch.cuda.stream(self.stream) if self.on_card else contextlib.nullcontext()

    def check_broken(self) -> None:
        if self.broken:
            raise RuntimeError(
                f"decode replica {self.index} is down (injected replica_kill)"
            )

    def _check_pools(self, kpool, vpool) -> None:
        if kpool is None or vpool is None:
            raise RuntimeError(
                f"decode replica {self.index} has no KV pools (lost to pool_poison); "
                "rebuild() makes them anew"
            )

    # ------------------------------------------------------------ programs --
    def _prefill(self, kpool, vpool, table_row: np.ndarray, buf: np.ndarray, n: int):
        """One bucketed prompt's prefill into ``kpool``/``vpool`` (in place):
        ``(host logits (V,) of position n - 1, kpool, vpool)``."""
        self._check_pools(kpool, vpool)
        with self._on_stream():
            logits, kpool, vpool = self.model.prefill(
                kpool, vpool, torch.from_numpy(table_row).to(self.device),
                torch.from_numpy(buf).to(self.device), int(n))
            return logits.cpu().numpy(), kpool, vpool

    def _step(self, kpool, vpool, tables: np.ndarray, lengths: np.ndarray, tokens: np.ndarray):
        """One ``(max_slots, 1)`` step of every slot over ``kpool``/``vpool``:
        ``(host logits (S, V), kpool, vpool)``. On a card the inputs are
        copied into the graph's static buffers and the graph is replayed; it
        only runs over the pools it was captured on."""
        self._check_pools(kpool, vpool)
        if not self.on_card:
            logits, kpool, vpool = self.model.decode_step(
                kpool, vpool, torch.from_numpy(tables), torch.from_numpy(lengths),
                torch.from_numpy(tokens))
            return logits.numpy(), kpool, vpool
        if self._graph is None or self._captured[0] is not kpool or self._captured[1] is not vpool:
            raise RuntimeError(
                f"decode replica {self.index}: no step graph captured over these pools"
            )
        with self._on_stream():
            for name, host in (("tables", tables), ("lengths", lengths), ("tokens", tokens)):
                dev, pinned = self._in[name]
                pinned.numpy()[...] = host
                dev.copy_(pinned, non_blocking=True)
            self._graph.replay()
            self._host_logits.copy_(self._logits, non_blocking=True)
            self.stream.synchronize()
        self.replays += 1
        return self._host_logits.numpy().copy(), kpool, vpool

    def capture(self) -> None:
        """Record the step over the current pools as this replica's graph
        (a card only), after one eager run of it on the replica's stream. A
        capture that fails raises: the card never decodes eagerly in its
        place."""
        if not self.on_card:
            return
        self._drop_graph()
        ins = {name: dev for name, (dev, _) in self._in.items()}
        graph = torch.cuda.CUDAGraph()
        with self._on_stream():
            for dev in ins.values():
                dev.zero_()  # all-zero tables and lengths: the warm-up writes garbage block 0
            self.model.decode_step(self.kpool, self.vpool, ins["tables"], ins["lengths"],
                                   ins["tokens"])
            self.stream.synchronize()
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                logits, _, _ = self.model.decode_step(
                    self.kpool, self.vpool, ins["tables"], ins["lengths"], ins["tokens"])
            finally:
                graph.capture_end()
        self._graph, self._logits = graph, logits
        self._captured = (self.kpool, self.vpool)
        self.captures += 1

    def _drop_graph(self) -> None:
        if self._graph is not None:
            self._graph.reset()
        self._graph, self._logits, self._captured = None, None, None

    # ----------------------------------------------------------- lifecycle --
    def poison(self) -> None:
        """The ``pool_poison`` fault: the pools are lost, and with them the
        graph that holds their addresses, so no replay can touch freed
        storage; every dispatch raises until :meth:`rebuild`."""
        if self.on_card:
            self.stream.synchronize()
        self._drop_graph()
        self.kpool = self.vpool = None

    def rebuild(self) -> None:
        """Probation step 1: fresh KV pools and block-table allocator (every
        sequence that lived here was parked into its failover journal), the
        old graph dropped, the kill flag cleared — the restarted-device
        state. The next :meth:`warmup` captures the graph again."""
        if self.on_card:
            self.stream.synchronize()
        self._drop_graph()
        self.cache = PagedKVCache(
            layers=self.cache.layers,
            heads=self.cache.heads,
            head_dim=self.cache.head_dim,
            num_blocks=self.cache.num_blocks,
            block_size=self.cache.block_size,
            max_slots=self.cache.max_slots,
            max_seq_len=self.cache.max_seq_len,
        )
        self.kpool, self.vpool = self._fresh_pools()
        self.broken = False

    def canary(self, buckets: List[int]) -> None:
        """Probation step 2: re-warm (every prefill shape, and on a card the
        graph captured over the fresh pools) and require a finite canary
        step — a replica that cannot decode the canary does not rejoin
        routing."""
        self.check_broken()
        self.warmup(buckets)
        s, mb = self.cache.max_slots, self.cache.max_blocks
        zeros = np.zeros((s,), np.int32)
        out, self.kpool, self.vpool = self._step(
            self.kpool, self.vpool, np.zeros((s, mb), np.int32), zeros, zeros)
        if not np.all(np.isfinite(out)):
            raise RuntimeError(
                f"decode replica {self.index} canary produced non-finite "
                "logits"
            )

    def warmup(self, buckets: List[int]) -> None:
        """Run every prefill bucket once and capture the step (a card) or
        run it once (the CPU). Warm-up traffic writes only into reserved
        garbage block 0 (all-zero table rows), so the allocatable pool is
        untouched."""
        zrow = np.zeros((self.cache.max_blocks,), np.int32)
        for p in buckets:
            _, self.kpool, self.vpool = self._prefill(
                self.kpool, self.vpool, zrow, np.zeros((1, p), np.int32), 1)
        if self.on_card:
            self.capture()
        else:
            s, mb = self.cache.max_slots, self.cache.max_blocks
            zeros = np.zeros((s,), np.int32)
            self._step(self.kpool, self.vpool, np.zeros((s, mb), np.int32), zeros, zeros)
        self.steps = 0


class DecodeEngine:
    """Token-level continuous-batching engine over N decode replicas."""

    def __init__(
        self,
        cfg: dict,
        out_dir: Optional[str] = None,
        devices=None,
        observability: Optional[dict] = None,
    ):
        from tpuddp_torch import config as cfg_lib
        from tpuddp_torch.observability import exporter as exp_lib
        from tpuddp_torch.observability import flight as flight_lib

        self.cfg = dict(cfg)
        self.vocab_size = int(cfg["vocab_size"])
        self.max_seq_len = int(cfg["max_seq_len"])
        self.max_new_tokens = int(cfg["max_new_tokens"])
        self.max_prompt_len = self.max_seq_len - 1  # >= 1 generated token
        self.stop_token = (
            None if cfg.get("stop_token") is None else int(cfg["stop_token"])
        )
        self.temperature = float(cfg.get("temperature") or 0.0)
        self.buckets = prefill_buckets(self.max_prompt_len)

        if str(cfg["model"]) not in TRANSFORMERS:
            raise ValueError(
                f"decode.model {cfg['model']!r} is not a TransformerLM — the "
                "decode engine needs the prefill/decode_step protocol"
            )
        model = seeded_model(str(cfg["model"]), self.vocab_size, (), int(cfg.get("seed") or 0))
        if model.max_seq_len < self.max_seq_len:
            raise ValueError(
                f"decode.max_seq_len={self.max_seq_len} exceeds the model's "
                f"position table ({model.max_seq_len})"
            )
        self.restored_epoch = None
        if cfg.get("checkpoint_dir"):
            self.restored_epoch = _restore_variables(
                cfg["checkpoint_dir"], str(cfg.get("checkpoint_prefix") or "auto"), model)
        self.model = model.eval()
        set_numerics()

        if devices is None:
            devices = serving_devices("cuda")
        devices = list(devices)
        n = cfg.get("num_replicas", 1)
        n = len(devices) if n == "auto" else int(n)
        if n < 1 or n > len(devices):
            raise ValueError(
                f"num_replicas={n} outside [1, {len(devices)} local devices]"
            )
        self.replicas = [
            DecodeReplica(i, d, self.model, cfg)
            for i, d in enumerate(devices[:n])
        ]

        quota = cfg.get("per_tenant_quota")
        self.queue = RequestQueue(
            int(cfg["max_queue_depth"]),
            None if quota is None else int(quota),
        )
        self.survive = SurvivePolicy.from_config(cfg)
        self.queue.shed_handler = self._on_shed
        self._health_lock = threading.Lock()
        self._step_counter = itertools.count(1)  # chaos site step=N
        self._obs_cfg = cfg_lib.resolve_observability(observability)
        # causal tracing plane (observability/trace.py, default OFF): one
        # tree per session (request -> admission -> queue_wait -> prefill,
        # failover episodes linked follows_from so a resumed stream stays
        # ONE trace) plus per-replica decode_step rows; trace_decode.json
        # at drain, live on /trace
        self.tracer = trace_lib.tracer_from_config(
            self._obs_cfg, "decode", run_dir=out_dir
        )
        self._engine_trace = None  # the decode_step timeline's trace id
        self.flight = None
        if self._obs_cfg["flight_recorder"] and out_dir:
            self.flight = flight_lib.install(flight_lib.FlightRecorder(
                out_dir, capacity=int(self._obs_cfg["flight_capacity"]),
            ))
            if self.tracer.enabled:
                self.flight.add_context(
                    "open_spans", self.tracer.open_span_summaries
                )
        self.writer = (
            MetricsWriter(out_dir, flight=self.flight) if out_dir else None
        )
        self.stats = DecodeStats(
            self.writer,
            window=int(cfg["stats_window"]),
            gauges=lambda: (self.kv_occupancy(), self.active_sequences()),
        )
        self.exporter = exp_lib.exporter_from_config(
            self._obs_cfg, run_dir=out_dir
        )
        self._threads: List[threading.Thread] = []
        self._active_counts = [0] * len(self.replicas)
        self._started = False
        self._drained = False
        self._in_flight_at_drain: Optional[int] = None

    @classmethod
    def from_config(
        cls, cfg: dict, out_dir: Optional[str] = None, devices=None,
        observability: Optional[dict] = None,
    ) -> "DecodeEngine":
        """``cfg`` is a resolved ``serving.decode`` block
        (:func:`tpuddp_torch.config.decode_config`); ``devices`` defaults to
        every visible card."""
        return cls(cfg, out_dir=out_dir, devices=devices,
                   observability=observability)

    # -------------------------------------------------------------- gauges --
    def _event(self, record: dict) -> None:
        if self.writer is not None:
            self.writer.write(schema.stamp("event", record))

    def _on_shed(self, request) -> None:
        """Queue shed callback: one queued decode request expired past its
        deadline and was dropped before prefill (its future already carries
        the typed ``deadline_exceeded`` rejection)."""
        self._trace_fail(request, "deadline_exceeded")
        self.stats.record_shed(request.tenant)

    def kv_occupancy(self) -> float:
        """Mean KV-pool occupancy across replicas still IN routing. A
        removed replica's cache is stale garbage (its parked sessions'
        slots were never freed — probation's rebuild never ran), and
        counting it would pin the exported gauge high forever, feeding the
        autoscaler's occupancy rule sustained phantom pressure."""
        live = [r for r in self.replicas if r.state != "removed"]
        if not live:
            return 0.0
        return sum(r.cache.occupancy() for r in live) / len(live)

    def active_sequences(self) -> int:
        return sum(self._active_counts)

    def decode_meta(self) -> dict:
        """The run_meta ``decode`` provenance block (schema v6)."""
        cfg = self.cfg
        return {
            "model": cfg["model"],
            "vocab_size": self.vocab_size,
            "num_replicas": len(self.replicas),
            "max_slots": int(cfg["max_slots"]),
            "kv_blocks": int(cfg["kv_blocks"]),
            "kv_block_size": int(cfg["kv_block_size"]),
            "max_seq_len": self.max_seq_len,
            "max_new_tokens": self.max_new_tokens,
            "stop_token": self.stop_token,
            "temperature": self.temperature,
            "prefill_buckets": list(self.buckets),
        }

    # ----------------------------------------------------------- lifecycle --
    def start(self, warmup: bool = True) -> "DecodeEngine":
        if self._started:
            return self
        if self.exporter is not None:
            self.exporter.start()
            self.exporter.register_source(
                "decode", self.stats.export_source(engine=self)
            )
            if self.tracer.enabled:
                self.exporter.set_trace_source(self.tracer.endpoint_payload)
        self._engine_trace = self.tracer.new_trace()
        if self.writer is not None:
            self.writer.write(run_meta_header(
                len(self.replicas), self.replicas[0].device,
                observability={
                    "exporter": (
                        self.exporter.describe()
                        if self.exporter is not None else False
                    ),
                    "aggregate": False,
                    "flight_recorder": (
                        self.flight.describe()
                        if self.flight is not None else False
                    ),
                },
                decode=self.decode_meta(),
                survivability=self.survive.meta(),
                tracing=self.tracer.describe(),
                extra={
                    "api": "serving_decode",
                    "model": self.cfg.get("model"),
                    "num_replicas": len(self.replicas),
                    "max_queue_depth": self.queue.max_depth,
                    "per_tenant_quota": self.queue.per_tenant_quota,
                    "buckets": list(self.buckets),
                    "restored_epoch": self.restored_epoch,
                    "checkpoint_dir": self.cfg.get("checkpoint_dir"),
                    "config_hash": schema.config_hash(self.cfg or None),
                },
            ))
        if warmup:
            t0 = time.perf_counter()
            for r in self.replicas:
                r.warmup(self.buckets)
            logger.info(
                "decode: %d replica(s) warm over prefill buckets %s + the "
                "(%d, 1) step (captured on a card) in %.1fs",
                len(self.replicas), self.buckets,
                self.replicas[0].cache.max_slots, time.perf_counter() - t0,
            )
        self.stats.reset_clock()
        for replica in self.replicas:
            t = threading.Thread(
                target=self._decode_loop,
                args=(replica,),
                name=f"tpuddp-decode-r{replica.index}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)
        self._started = True
        return self

    def drain(self, reason: str = "shutdown", timeout: Optional[float] = None) -> dict:
        """Close admission, let in-flight sequences decode to termination,
        flush stats. Idempotent; returns the final summary, which carries
        ``in_flight_at_drain`` — the active + queued sequence count at the
        FIRST drain call, so a drain test can prove the signal landed
        mid-decode rather than against an already-idle engine."""
        if self._in_flight_at_drain is None:
            self._in_flight_at_drain = (
                self.active_sequences() + self.queue.depth()
            )
        self.queue.close()
        for t in self._threads:
            t.join(timeout)
        alive = [t.name for t in self._threads if t.is_alive()]
        if alive:
            logger.warning(
                "decode: loop(s) %s still running after the drain timeout; "
                "stats not finalized yet", alive,
            )
            return self._summary()
        if not self._drained:
            self._drained = True
            self.stats.flush_window()
            if self.tracer.enabled:
                if self.writer is not None:
                    self.writer.write(schema.stamp(
                        "trace_summary", self.tracer.summary_record()
                    ))
                self.tracer.export()
            if self.writer is not None:
                summary = self.stats.summary()
                self.writer.write(schema.stamp("event", {
                    "event": "decode_drain",
                    "reason": reason,
                    **{k: summary[k] for k in (
                        "submitted", "completed", "tokens", "tokens_per_sec",
                    )},
                }))
                self.writer.close()
            if self.exporter is not None:
                self.exporter.stop()
            if self.flight is not None:
                from tpuddp_torch.observability import flight as flight_lib

                flight_lib.uninstall(self.flight)
        return self._summary()

    def _summary(self) -> dict:
        out = self.stats.summary()
        out["in_flight_at_drain"] = self._in_flight_at_drain
        return out

    # -------------------------------------------------------------- client --
    def submit(
        self,
        tenant: str,
        tokens,
        max_new_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
        seed: int = 0,
        stop_token="default",
        deadline_s: Optional[float] = None,
    ) -> StreamedResult:
        """Admit one prompt (1-D int token ids). Raises
        :class:`AdmissionError` (bad_shape / oversized / queue_full /
        tenant_quota / draining) or returns the streaming future.

        ``deadline_s``: optional client deadline (seconds from now),
        combined with the engine's ``request_ttl_s``: a request still
        QUEUED past the tighter bound is shed with a ``deadline_exceeded``
        rejection through the future; a sequence that started decoding is
        NEVER killed by its deadline."""
        tokens = np.asarray(tokens)
        self.stats.record_submit()
        t = self.tracer
        root = t.start_span(
            "request", trace_lib.KIND_REQUEST, tid="client",
            attrs={"tenant": str(tenant)},
        )
        adm = t.start_span("admission", trace_lib.KIND_ADMISSION, parent=root)
        request = None
        try:
            if tokens.ndim != 1 or tokens.shape[0] < 1:
                raise AdmissionError(
                    queue_mod.REJECT_BAD_SHAPE,
                    f"prompt must be a non-empty 1-D token vector, got shape "
                    f"{tuple(tokens.shape)}",
                )
            if tokens.dtype.kind not in "iu":
                raise AdmissionError(
                    queue_mod.REJECT_BAD_SHAPE,
                    f"prompt dtype {tokens.dtype} is not integer token ids",
                )
            if tokens.min() < 0 or tokens.max() >= self.vocab_size:
                raise AdmissionError(
                    queue_mod.REJECT_BAD_SHAPE,
                    f"token ids outside [0, {self.vocab_size})",
                )
            if tokens.shape[0] > self.max_prompt_len:
                raise AdmissionError(
                    queue_mod.REJECT_OVERSIZED,
                    f"{tokens.shape[0]}-token prompt > max_prompt_len="
                    f"{self.max_prompt_len}",
                )
            mnt = self.max_new_tokens if max_new_tokens is None else int(max_new_tokens)
            if mnt < 1 or mnt > self.max_new_tokens:
                raise AdmissionError(
                    queue_mod.REJECT_OVERSIZED,
                    f"max_new_tokens={mnt} outside [1, {self.max_new_tokens}]",
                )
            if tokens.shape[0] + mnt > self.max_seq_len:
                raise AdmissionError(
                    queue_mod.REJECT_OVERSIZED,
                    f"prompt ({tokens.shape[0]}) + max_new_tokens ({mnt}) > "
                    f"max_seq_len={self.max_seq_len}",
                )
            request = DecodeRequest(
                tenant,
                np.array(tokens, dtype=np.int32, copy=True),  # own the prompt
                mnt,
                self.temperature if temperature is None else float(temperature),
                seed,
                self.stop_token if stop_token == "default" else stop_token,
                deadline=survive_lib.admission_deadline(
                    time.perf_counter(), self.survive.request_ttl_s, deadline_s
                ),
            )
            t.end_span(
                adm, prompt_len=int(tokens.shape[0]), request=request.id
            )
            if t.enabled:
                # attach BEFORE put (the request-engine rule): once put()
                # publishes the request a decode loop may place it, and a
                # trace attached after would race the prefill and leak a
                # never-closed queue_wait
                request.trace = {
                    "root": root,
                    "open": t.start_span(
                        "queue_wait", trace_lib.KIND_QUEUE_WAIT, parent=root,
                    ),
                    "last_id": None,
                }
            self.queue.put(request)
        except AdmissionError as e:
            if request is not None and request.trace:
                t.end_span(request.trace["open"], error=e.reason)
                request.trace = None
            t.end_span(adm, rejected=e.reason)
            t.end_span(root, error=e.reason)
            self.stats.record_reject(tenant, e.reason)
            raise
        return request.result

    # ------------------------------------------------------------- decoding --
    def _finish(self, cache: PagedKVCache, seq: _Active) -> None:
        """Terminate one sequence: free its KV blocks (capacity visible to
        the very next admission pass) and deliver the final array."""
        cache.free(seq.slot)
        seq.req.result._deliver(np.asarray(seq.out, np.int32))
        if seq.req.trace:
            self.tracer.end_span(
                seq.req.trace["root"], tokens=len(seq.out),
                failovers=seq.req.failovers,
            )
            seq.req.trace = None
        self.stats.record_finish(seq.req.tenant)

    def _trace_fail(self, req: DecodeRequest, error) -> None:
        """Close a failed session's trace (the shared
        :func:`~tpuddp_torch.observability.trace.end_request_trace` sequence —
        every failure path: shed, max-failovers, mortuary)."""
        trace_lib.end_request_trace(self.tracer, req, error)

    def _prefill_dispatch(
        self, replica: DecodeReplica, slot: int, req: DecodeRequest
    ):
        """The ONE prompt-prefill dispatch both the fresh path and the
        failover-resume path run: bucket the prompt, commit its K/V into
        the slot, return the last position's logits. Bitwise-critical
        single source — a resume must prefill exactly as the undisturbed
        run did, or the continuation guarantee breaks."""
        cache = replica.cache
        n = len(req.tokens)
        P = batching.bucket_for(n, self.max_prompt_len)
        t = self.tracer
        if req.trace and req.trace.get("open") is not None:
            t.end_span(req.trace["open"])  # queue wait ends at placement
            req.trace["open"] = None
        resuming = req.failed_from is not None
        psp = t.start_span(
            "prefill", trace_lib.KIND_PREFILL,
            parent=req.trace["root"] if req.trace else None,
            # the failover edge: a resume's prefill follows causally from
            # the session's last span on the dead replica — one trace, one
            # stream, across the migration
            follows_from=(
                req.trace.get("last_id") if (req.trace and resuming) else None
            ),
            attrs={
                "replica": replica.index, "prompt_len": n, "bucket": P,
                **({"resume": True} if resuming else {}),
            },
        )
        buf = np.zeros((1, P), np.int32)
        buf[0, :n] = req.tokens
        try:
            logits, replica.kpool, replica.vpool = replica._prefill(
                replica.kpool, replica.vpool, cache.tables[slot], buf, n,
            )
        except BaseException as e:
            t.end_span(psp, error=repr(e))
            if req.trace:
                # the errored prefill IS the session's last span: a later
                # resume must follows_from it or the trace loses the episode
                req.trace["last_id"] = psp.span_id
            raise
        t.end_span(psp)
        if req.trace:
            req.trace["last_id"] = psp.span_id
        cache.lengths[slot] = n
        return logits

    def _prefill_one(
        self, replica: DecodeReplica, slot: int, req: DecodeRequest
    ) -> Optional[_Active]:
        """Prefill one prompt into its slot and sample the first token.
        Returns the active sequence, or None when it terminated at birth
        (first sample hit the stop token, or max_new_tokens == 1)."""
        cache = replica.cache
        n = len(req.tokens)
        logits = self._prefill_dispatch(replica, slot, req)
        tok = _sample(logits, req.temperature, req.seed, 0)
        if req.stop_token is not None and tok == req.stop_token:
            # terminated before emitting anything: an empty (but successful)
            # stream — the stop token is consumed, never delivered
            seq = _Active(req, slot, tok)
            seq.out = []
            self._finish(cache, seq)
            return None
        req.result._deliver_token(tok)
        self.stats.record_first_token(
            (time.perf_counter() - req.t_enqueue) * 1e3, n
        )
        seq = _Active(req, slot, tok)
        if seq.n_generated >= req.max_new_tokens:
            self._finish(cache, seq)
            return None
        return seq

    def _resume_one(
        self, replica: DecodeReplica, slot: int, req: DecodeRequest
    ) -> Optional[_Active]:
        """Session failover re-admission: continue a sequence whose replica
        died, **bitwise-equal** to an undisturbed run.

        The journal (``req.resume_tokens``) holds every token already
        streamed to the client. The original prompt is re-prefilled through
        the SAME prefill program the undisturbed run used (its sampled
        logits are discarded — those tokens are known), and the generated
        prefix is queued for REPLAY through the step program: each replay
        step re-commits one recorded token's K/V exactly the way the
        original run committed it, delivering nothing. Every K/V position
        is therefore rebuilt by the same program kind that wrote it
        originally, and host sampling is keyed by ``(seed, token index)``
        alone — so when live decoding resumes at the journal's cursor, the
        continuation is bitwise the stream the dead replica would have
        produced."""
        journal = list(req.resume_tokens)
        if not journal:
            # died during prefill, before its first token: a fresh prefill
            # IS the bitwise resume (token index 0 samples identically)
            req.resume_tokens = None
            try:
                seq = self._prefill_one(replica, slot, req)
            except BaseException:
                req.resume_tokens = []  # keep the journal for the next try
                raise
            self._record_failover(replica, req, 0)
            return seq
        self._prefill_dispatch(replica, slot, req)  # sampled logits
        # discarded: the journal already knows these tokens
        req.resume_tokens = None
        self._record_failover(replica, req, len(journal))
        seq = _Active(req, slot, journal[0])
        seq.out = list(journal)
        seq.n_generated = len(journal)
        seq.replay = list(journal[1:])
        return seq

    def _record_failover(
        self, replica: DecodeReplica, req: DecodeRequest, tokens: int
    ) -> None:
        if req.trace:
            # the episode marker (zero-length annotation in the session's
            # own trace — the resume prefill carries the follows_from edge)
            self.tracer.end_span(self.tracer.start_span(
                "failover", trace_lib.KIND_FAILOVER, parent=req.trace["root"],
                attrs={
                    "from_replica": req.failed_from,
                    "to_replica": replica.index,
                    "tokens_journaled": tokens,
                },
            ))
        self.stats.record_failover(req.tenant)
        self._event({
            "event": "session_failover",
            "request": req.id,
            "tenant": req.tenant,
            "from_replica": req.failed_from,
            "to_replica": replica.index,
            "tokens_generated": tokens,
        })
        logger.warning(
            "decode: session %d (tenant %s) failed over from replica %s to "
            "%d with %d token(s) journaled",
            req.id, req.tenant, req.failed_from, replica.index, tokens,
        )

    def _replica_incident(
        self,
        replica: DecodeReplica,
        pending: List[DecodeRequest],
        active: Dict[int, "_Active"],
        error: BaseException,
    ) -> bool:
        """A dispatch on ``replica`` died (step/prefill raised — possibly
        after losing its K/V pools). Park every live session
        into its failover journal and re-queue it at lane front (immune to
        deadline shedding and the closed flag — a draining engine still
        owes its streams), return untouched pending work to the shared
        queue, then run one probation episode (rebuild pools + canary,
        jittered backoff, bounded by the policy). True = the replica
        recovered and rejoins routing; False = it is permanently removed
        (the caller decides between exiting to surviving peers and the
        typed no-healthy-replica fallback).

        Attribution: a place-phase failure tags its CULPRIT on the
        exception. Only the culprit is charged a failover episode (the
        poisoned-request firewall — innocent sessions parked by someone
        else's incident ride free), and a culprit-attributed incident
        whose canary then passes does not charge the replica's lifetime
        ``max_recoveries`` budget either: the device was provably never
        the problem. Unattributed (step) failures are device evidence —
        they charge the replica, and park every session for free."""
        culprit = getattr(error, "_tpuddp_culprit", None)
        logger.exception(
            "decode: dispatch failed on replica %d; parking %d session(s), "
            "returning %d pending request(s)",
            replica.index, len(active), len(pending),
        )
        with self._health_lock:
            replica.state = "recovering"
        self._event({
            "event": "replica_unhealthy",
            "replica": replica.index,
            "error": repr(error),
            "sessions": len(active),
        })
        # requeue is appendleft: push pending in reverse to preserve FIFO,
        # then the journals, so live sessions land ahead of untouched work
        for req in reversed(pending):
            if req is culprit:
                if not self._park(req, error):
                    continue
                # the parked culprit resumes like any other session: name
                # the replica it died on (the failover event's from_replica,
                # and what marks its next prefill a resume) and reopen a
                # queue_wait in its trace — its original one closed when the
                # failed prefill began, and without this the second wait
                # renders as an unexplained gap with no follows_from edge
                req.failed_from = replica.index
                if req.trace and req.trace.get("open") is None:
                    req.trace["open"] = self.tracer.start_span(
                        "queue_wait", trace_lib.KIND_QUEUE_WAIT,
                        parent=req.trace["root"],
                        follows_from=req.trace.get("last_id"),
                        attrs={"parked_from": replica.index},
                    )
            self.queue.requeue(req)
        pending.clear()
        for slot in sorted(active.keys(), reverse=True):
            seq = active[slot]
            seq.req.resume_tokens = list(seq.out)
            seq.req.failed_from = replica.index
            if seq.req.trace:
                # parked: back to waiting — a fresh queue_wait in the SAME
                # trace, linked to the session's last pre-death span
                seq.req.trace["open"] = self.tracer.start_span(
                    "queue_wait", trace_lib.KIND_QUEUE_WAIT,
                    parent=seq.req.trace["root"],
                    follows_from=seq.req.trace.get("last_id"),
                    attrs={"parked_from": replica.index},
                )
            self.queue.requeue(seq.req)
        active.clear()
        self._active_counts[replica.index] = 0

        def recover():
            replica.rebuild()
            replica.canary(self.buckets)

        psp = self.tracer.start_span(
            f"probation replica {replica.index}", trace_lib.KIND_PROBATION,
            trace_id=self._engine_trace, tid=f"replica{replica.index}",
            attrs={"recoveries": replica.recoveries},
        )
        ok, event = survive_lib.probation_episode(
            replica,
            name=f"decode replica {replica.index}",
            recover=recover,
            policy=self.survive,
            count_recovery=culprit is None,
            lock=self._health_lock,
        )
        self.tracer.end_span(psp, outcome="recovered" if ok else "removed")
        self._event(event)
        return ok

    def _park(self, req: DecodeRequest, error: BaseException) -> bool:
        """Charge one failover episode to the CULPRIT of a place-phase
        incident. True = within the budget (the caller journals + requeues
        it); False = the budget is spent — the request is failed through
        with the dispatch error (delivered here) instead of re-parked, so
        a request whose own content kills any dispatch cannot ride its
        journal around the pool forever."""
        req.failovers += 1
        if req.failovers <= self.survive.max_failovers:
            return True
        logger.error(
            "decode: session %d (tenant %s) exceeded max_failovers=%d — "
            "failing it with the dispatch error instead of re-parking "
            "(poisoned-request firewall)",
            req.id, req.tenant, self.survive.max_failovers,
        )
        self._trace_fail(req, error)
        req.result._deliver(None, error=error)
        return False

    def _shed_expired_pending(self, pending: List[DecodeRequest]) -> None:
        """Deadline shedding for the loop's private pending list: a pulled-
        but-never-prefilled request is still queued work. Journals
        (in-flight sessions mid-migration) are exempt."""
        if not pending:
            return
        now = time.perf_counter()
        keep = []
        for req in pending:
            if (
                req.resume_tokens is None
                and req.deadline is not None
                and now > req.deadline
            ):
                self.queue._deliver_shed(req)
            else:
                keep.append(req)
        pending[:] = keep

    def _serve_once(
        self,
        replica: DecodeReplica,
        pending: List[DecodeRequest],
        active: Dict[int, "_Active"],
    ) -> bool:
        """One admit -> place -> step -> deliver iteration. True = the
        queue is closed and fully drained (the loop's exit signal). Any
        dispatch failure raises to the caller's incident handler."""
        cache = replica.cache
        S = cache.max_slots
        self._shed_expired_pending(pending)
        # -- admit: pull queued requests round-robin into free capacity.
        # Capacity counts BLOCKS as well as slots, at worst-case lifetime
        # budget (max_blocks per sequence): a block-starved replica must
        # not pull work into its private pending list that an idle
        # sibling could place immediately — requests it cannot yet hold
        # stay in the shared queue where any replica can take them.
        capacity = min(
            cache.free_slots, cache.free_blocks // cache.max_blocks
        )
        if not active and not pending:
            group = self.queue.take_group(max(1, capacity), wait=True)
            if group is None:
                return True
        else:
            room = capacity - len(pending)
            group = (
                self.queue.take_group(room, wait=False) if room > 0 else []
            )
            group = group or []  # None (closed) -> finish what we hold
        pending.extend(group)
        # -- place: strict arrival order; stop at the first request the
        # pool cannot hold yet, so nobody is starved by a smaller
        # latecomer jumping the block queue
        while pending and cache.can_admit(pending[0].total_tokens):
            req = pending.pop(0)
            slot = cache.allocate(req.total_tokens)
            try:
                if req.resume_tokens is not None:
                    seq = self._resume_one(replica, slot, req)
                else:
                    seq = self._prefill_one(replica, slot, req)
            except BaseException as e:
                # the request mid-prefill becomes a live session with an
                # empty journal (it was admitted and dispatched); put it
                # back at the head so the incident handler parks it. Tag
                # it as the incident's CULPRIT: a place-phase failure is
                # attributable to the one request being placed, and only
                # the culprit is charged a failover episode (innocent
                # parked sessions ride free) or can spare the replica's
                # lifetime probation budget.
                if req.resume_tokens is None:
                    req.resume_tokens = []
                pending.insert(0, req)
                try:
                    e._tpuddp_culprit = req
                except Exception:  # noqa: BLE001 — exotic exception types
                    pass
                raise
            if seq is not None:
                active[seq.slot] = seq
        self._active_counts[replica.index] = len(active)
        if not active:
            if pending or not self.queue.closed:
                return False
            if self.queue.depth() == 0:
                return True
            return False
        # -- step: the one fixed-shape (max_slots, 1) program
        tokens = np.zeros((S,), np.int32)
        for slot, seq in active.items():
            tokens[slot] = seq.last_token
        ssp = self.tracer.start_span(
            "decode_step", trace_lib.KIND_DECODE_STEP,
            trace_id=self._engine_trace, tid=f"replica{replica.index}",
            attrs={"step": replica.steps, "active": len(active)},
        )
        try:
            kind = faults.maybe_serving_fault(
                "step", step=next(self._step_counter)
            )
            if kind == "replica_kill":
                replica.broken = True  # persistent until rebuild()
            if kind == "pool_poison":
                # the pools are gone mid-sweep (with the graph bound to them)
                replica.poison()
                raise RuntimeError("injected pool_poison fault: KV pools lost")
            if kind == "dispatch_wedge":
                raise RuntimeError("injected dispatch_wedge fault (transient)")
            replica.check_broken()
            logits, replica.kpool, replica.vpool = replica._step(
                replica.kpool, replica.vpool, cache.tables, cache.lengths, tokens,
            )  # host logits: the fetch is the fence
        except BaseException as e:
            self.tracer.end_span(ssp, error=repr(e))
            raise
        self.tracer.end_span(ssp)
        replica.steps += 1
        now = time.perf_counter()
        for slot, seq in list(active.items()):
            cache.lengths[slot] += 1  # the step committed last_token's KV
            if seq.replay:
                # failover replay: the step re-committed a recorded token's
                # K/V; the client already has every replayed token, so
                # nothing is sampled, delivered, or counted
                seq.last_token = seq.replay.pop(0)
                seq.t_last = now
                continue
            tok = _sample(
                logits[slot], seq.req.temperature, seq.req.seed,
                seq.n_generated,
            )
            if seq.req.stop_token is not None and tok == seq.req.stop_token:
                del active[slot]
                self._finish(cache, seq)
                continue
            seq.out.append(tok)
            seq.n_generated += 1
            seq.req.result._deliver_token(tok)
            self.stats.record_token((now - seq.t_last) * 1e3)
            seq.t_last = now
            seq.last_token = tok
            if seq.n_generated >= seq.req.max_new_tokens:
                del active[slot]
                self._finish(cache, seq)
        self._active_counts[replica.index] = len(active)
        return False

    def _decode_loop(self, replica: DecodeReplica) -> None:
        """One replica's life: admit -> prefill -> step -> deliver -> retire,
        every iteration. Exits when the queue closes and drains AND every
        in-flight sequence has terminated (the drain contract: SIGTERM never
        truncates a stream).

        Survivability: a failed dispatch no longer kills its streams — the
        incident handler parks every live session into a failover journal
        (re-queued at lane front for ANY replica to resume bitwise) and
        runs probation on this replica. Recovered -> rejoin; removed with
        surviving peers -> this thread exits and the peers own the
        journals; removed as the LAST replica -> queued and parked work
        fails with the typed ``no_healthy_replica`` reason and the loop
        keeps failing new arrivals fast until drain — never a hang."""
        pending: List[DecodeRequest] = []
        active: Dict[int, _Active] = {}
        replica.loop_alive = True
        try:
            self._decode_loop_body(replica, pending, active)
        finally:
            replica.loop_alive = False

    def _decode_loop_body(
        self,
        replica: DecodeReplica,
        pending: List[DecodeRequest],
        active: Dict[int, "_Active"],
    ) -> None:
        while True:
            if replica.state == "removed":
                # mortuary mode: no servable replica remains and the
                # recovery round already failed — fail queued work fast
                # with the machine-readable terminal reason
                group = self.queue.take_group(1, wait=True)
                if group is None:
                    return
                err = NoHealthyReplicaError(
                    "all decode replicas removed after failed recovery"
                )
                for req in group:
                    self._trace_fail(req, err)
                    req.result._deliver(None, error=err)
                continue
            try:
                if self._serve_once(replica, pending, active):
                    return
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:  # noqa: BLE001 — the incident path
                if self._replica_incident(replica, pending, active, e):
                    continue  # recovered; rejoin routing
                with self._health_lock:
                    survivors = survive_lib.live_survivors(
                        self.replicas, replica
                    )
                if survivors:
                    return  # peers own the journals; this thread is done
                logger.critical(
                    "decode: NO healthy replicas remain after the recovery "
                    "round; failing queued work with reason "
                    "no_healthy_replica instead of hanging"
                )
                self._event({
                    "event": "no_healthy_replica",
                    "replica": replica.index,
                })
                if self.flight is not None:
                    # decode dispatch death: the last windows + the
                    # unhealthy/removed events are in the ring
                    self.flight.dump("serving_dispatch")
                continue  # -> mortuary branch
