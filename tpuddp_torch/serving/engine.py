"""ServingEngine — the counterpart of ``tpuddp/serving/engine.py``: queue +
scheduler + replica pool + SLO stats, assembled.

One dispatch loop thread per replica pulls coalesced batches off the shared
scheduler and runs them on its own device and stream; N replicas therefore
serve N batches concurrently while admission, fairness, and bucketing stay
centralized. ``submit`` is the whole
client API: synchronous admission verdict (raises :class:`AdmissionError`
with a machine-readable reason), asynchronous result future.

Lifecycle: ``start()`` writes the ``run_meta`` header and runs every bucket
shape once on every replica (warmup — the first real request never pays a
shape's first call), ``drain()`` closes admission, lets the queued work finish,
flushes the final stats window, and stamps a ``serving_drain`` event. The
``__main__`` entrypoint maps SIGTERM onto drain + exit 75 — the resilience
exit-code contract (:mod:`tpuddp_torch.resilience.preemption`), so schedulers treat a
draining server exactly like a draining trainer.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from tpuddp_torch.config import tuning_provenance_from_env
from tpuddp_torch.observability import MetricsWriter, schema
from tpuddp_torch.observability import trace as trace_lib
from tpuddp_torch.resilience import faults
from tpuddp_torch.serving import queue as queue_mod
from tpuddp_torch.serving import survive as survive_lib
from tpuddp_torch.serving.queue import AdmissionError, Request, RequestQueue, ServedResult
from tpuddp_torch.serving.replica import Replica, ReplicaPool
from tpuddp_torch.serving.scheduler import BatchScheduler
from tpuddp_torch.serving.stats import ServingStats
from tpuddp_torch.serving.survive import NoHealthyReplicaError, SurvivePolicy

logger = logging.getLogger("tpuddp")


def run_meta_header(replicas: int, device, **fields) -> dict:
    """A serving engine's ``run_meta`` row: the JAX serving header's shape
    (no mesh, ``world_size`` the replica count, no gradient exchange) with
    the card's name as ``device_kind``."""
    device = torch.device(device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    record = schema.make_run_meta(world_size=None, device_kind=kind, **fields)
    record["world_size"] = int(replicas)
    return record


class ServingEngine:
    """Continuous-batching inference over a replica pool. See module doc."""

    def __init__(
        self,
        pool: ReplicaPool,
        max_batch_size: int = 32,
        max_queue_depth: int = 256,
        per_tenant_quota: Optional[int] = None,
        batch_timeout_ms: float = 2.0,
        stats_window: int = 64,
        out_dir: Optional[str] = None,
        config: Optional[dict] = None,
        unhealthy_after: int = 3,
        observability: Optional[dict] = None,
        survive: Optional[SurvivePolicy] = None,
    ):
        """``unhealthy_after``: K consecutive dispatch errors mark a replica
        unhealthy — it leaves routing and enters probation (see ``survive``)
        while a ``replica_unhealthy`` event row lands in history.jsonl;
        healthy replicas keep serving and drain still exits cleanly. 0
        disables the marking (legacy behavior: each batch on the broken
        replica fails individually, forever).

        ``survive``: the survivability policy
        (:class:`~tpuddp_torch.serving.survive.SurvivePolicy`): probation/recovery
        bounds for unhealthy replicas (jittered-backoff rebuild + canary,
        ``max_recoveries`` lifetime rejoins, permanent removal as the
        fallback), the admission-time request TTL, and the per-tenant
        transient-dispatch retry budget. None -> defaults (recovery on,
        TTL and retries off).

        ``observability``: the live-plane block (config.OBSERVABILITY_DEFAULTS
        shape): ``exporter: true`` serves /metrics from the SLO stats (last
        flushed window + cumulative counters — host dicts only, the dispatch
        hot path is untouched); the flight recorder tees every history record
        and dumps ``flightrec_serving_dispatch.json`` if the engine ever
        loses its last healthy replica."""
        from tpuddp_torch import config as cfg_lib
        from tpuddp_torch.observability import exporter as exp_lib
        from tpuddp_torch.observability import flight as flight_lib

        self.pool = pool
        self.queue = RequestQueue(max_queue_depth, per_tenant_quota)
        self.scheduler = BatchScheduler(
            self.queue, max_batch_size, batch_timeout_ms
        )
        self.unhealthy_after = int(unhealthy_after or 0)
        self.survive = survive or SurvivePolicy()
        self.retry_budget = survive_lib.RetryBudget(self.survive.retry_budget)
        self.queue.shed_handler = self._on_shed
        self._health_lock = threading.Lock()
        self._batch_counter = itertools.count(1)  # chaos site batch=N
        self._obs_cfg = cfg_lib.resolve_observability(observability)
        # causal tracing plane (observability/trace.py, default OFF): one
        # span tree per request — request -> admission -> queue_wait ->
        # serve — plus per-replica infer/probation rows, exported as
        # trace_serving.json at drain and served live on /trace
        self.tracer = trace_lib.tracer_from_config(
            self._obs_cfg, "serving", run_dir=out_dir
        )
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
        self.stats = ServingStats(self.writer, window=stats_window)
        self.exporter = exp_lib.exporter_from_config(
            self._obs_cfg, run_dir=out_dir
        )
        self._config = dict(config or {})
        self._threads: List[threading.Thread] = []
        self._started = False
        self._drained = False

    @classmethod
    def from_config(
        cls, cfg: dict, out_dir: Optional[str] = None, devices=None,
        observability: Optional[dict] = None,
    ) -> "ServingEngine":
        """Build pool + engine from a resolved ``serving`` block
        (:func:`tpuddp_torch.config.serving_config`); ``devices`` defaults to
        every visible card; the optional ``observability`` block arms the
        exporter/flight recorder."""
        pool = ReplicaPool.from_config(cfg, devices=devices)
        quota = cfg.get("per_tenant_quota")
        return cls(
            pool,
            max_batch_size=int(cfg["max_batch_size"]),
            max_queue_depth=int(cfg["max_queue_depth"]),
            per_tenant_quota=None if quota is None else int(quota),
            batch_timeout_ms=float(cfg["batch_timeout_ms"]),
            stats_window=int(cfg["stats_window"]),
            out_dir=out_dir,
            config=cfg,
            unhealthy_after=int(cfg.get("unhealthy_after", 3) or 0),
            observability=observability,
            survive=SurvivePolicy.from_config(cfg),
        )

    # ------------------------------------------------------------- lifecycle --
    def start(self, warmup: bool = True) -> "ServingEngine":
        if self._started:
            return self
        if self.exporter is not None:
            # bind before the header so run_meta records the real port
            self.exporter.start()
            self.exporter.register_source(
                "serving", self.stats.export_source(engine=self)
            )
            if self.tracer.enabled:
                self.exporter.set_trace_source(self.tracer.endpoint_payload)
        if self.writer is not None:
            cfg = self._config
            self.writer.write(run_meta_header(
                len(self.pool), self.pool.devices[0],
                tuning=tuning_provenance_from_env("serving"),
                observability={
                    "exporter": (
                        self.exporter.describe() if self.exporter is not None else False
                    ),
                    "aggregate": False,  # no pod axis on the serving path
                    "flight_recorder": (
                        self.flight.describe() if self.flight is not None else False
                    ),
                },
                survivability=self.survive.meta(),
                tracing=self.tracer.describe(),
                extra={
                    "api": "serving",
                    "model": cfg.get("model"),
                    "num_replicas": len(self.pool),
                    "max_batch_size": self.scheduler.max_batch_size,
                    "max_queue_depth": self.queue.max_depth,
                    "per_tenant_quota": self.queue.per_tenant_quota,
                    "batch_timeout_ms": self.scheduler.batch_timeout_s * 1e3,
                    "buckets": self.scheduler.buckets,
                    "input_shape": list(self.pool.sample_shape),
                    "restored_epoch": self.pool.restored_epoch,
                    "checkpoint_dir": cfg.get("checkpoint_dir"),
                    "config_hash": schema.config_hash(cfg or None),
                },
            ))
        if warmup:
            t0 = time.perf_counter()
            self.pool.warmup(self.scheduler.buckets)
            logger.info(
                "serving: %d replica(s) warm over buckets %s in %.1fs",
                len(self.pool), self.scheduler.buckets,
                time.perf_counter() - t0,
            )
        # window 0's throughput must measure serving, not the buckets' first calls
        self.stats.reset_clock()
        for replica in self.pool.replicas:
            t = threading.Thread(
                target=self._dispatch_loop,
                args=(replica,),
                name=f"tpuddp-serve-r{replica.index}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)
        self._started = True
        return self

    def drain(self, reason: str = "shutdown", timeout: Optional[float] = None) -> dict:
        """Close admission, finish queued + in-flight work, flush stats.
        Idempotent; returns the final :meth:`ServingStats.summary`.

        With a ``timeout``, dispatch threads may outlive the join — then the
        stats are NOT finalized and the writer stays open (the still-running
        loops keep recording honestly); call ``drain`` again to finish."""
        self.queue.close()
        for t in self._threads:
            t.join(timeout)
        alive = [t.name for t in self._threads if t.is_alive()]
        if alive:
            logger.warning(
                "serving: dispatch thread(s) %s still running after the "
                "drain timeout; stats not finalized yet", alive,
            )
            return self.stats.summary()
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
                self.writer.write(
                    schema.stamp(
                        "event",
                        {
                            "event": "serving_drain",
                            "reason": reason,
                            **{
                                k: v
                                for k, v in self.stats.summary().items()
                                if k in (
                                    "submitted", "completed", "rejected",
                                    "batches", "throughput_rps",
                                )
                            },
                        },
                    )
                )
                self.writer.close()
            if self.exporter is not None:
                self.exporter.stop()
            if self.flight is not None:
                from tpuddp_torch.observability import flight as flight_lib

                flight_lib.uninstall(self.flight)
        return self.stats.summary()

    # --------------------------------------------------------------- client --
    def _trace_close(self, request, error) -> None:
        """Close a failed/shed request's trace (the shared
        :func:`~tpuddp_torch.observability.trace.end_request_trace` sequence)."""
        trace_lib.end_request_trace(self.tracer, request, error)

    def _on_shed(self, request) -> None:
        """Queue shed callback: one queued request expired past its deadline
        and was dropped before dispatch (its future already carries the
        typed ``deadline_exceeded`` rejection). A shed request LEAVES the
        system — any retry tokens it consumed while bouncing off a failed
        dispatch are refunded, like every other exit path."""
        if getattr(request, "retries", 0):
            self.retry_budget.refund(request.tenant, request.retries)
            request.retries = 0
        self._trace_close(request, "deadline_exceeded")
        self.stats.record_shed(request.tenant)

    def submit(
        self, tenant: str, x: np.ndarray, deadline_s: Optional[float] = None
    ) -> ServedResult:
        """Admit one request of ``(rows, *sample_shape)`` float32 rows.
        Raises :class:`AdmissionError` (reason queue_full / tenant_quota /
        draining / oversized / bad_shape) or returns the result future.

        ``deadline_s``: optional client deadline (seconds from now). The
        effective deadline is the tighter of it and the engine's
        ``request_ttl_s``; a request still QUEUED past it is shed with a
        ``deadline_exceeded`` rejection delivered through the future —
        work already dispatched always completes."""
        x = np.asarray(x)
        self.stats.record_submit()
        t = self.tracer
        root = t.start_span(
            "request", trace_lib.KIND_REQUEST, tid="client",
            attrs={"tenant": str(tenant)},
        )
        adm = t.start_span("admission", trace_lib.KIND_ADMISSION, parent=root)
        request = None
        try:
            if x.ndim != 1 + len(self.pool.sample_shape) or (
                tuple(x.shape[1:]) != self.pool.sample_shape
            ):
                raise AdmissionError(
                    queue_mod.REJECT_BAD_SHAPE,
                    f"rows of shape {tuple(x.shape[1:])} != the served "
                    f"model's sample shape {self.pool.sample_shape}",
                )
            if x.dtype != np.float32:
                raise AdmissionError(
                    queue_mod.REJECT_BAD_SHAPE,
                    f"dtype {x.dtype} != float32",
                )
            if x.shape[0] < 1:
                raise AdmissionError(
                    queue_mod.REJECT_BAD_SHAPE, "empty request (0 rows)"
                )
            if x.shape[0] > self.scheduler.max_batch_size:
                raise AdmissionError(
                    queue_mod.REJECT_OVERSIZED,
                    f"{x.shape[0]} rows > max_batch_size="
                    f"{self.scheduler.max_batch_size}; split the request",
                )
            # own the rows: a client reusing (mutating) its submit buffer
            # must not rewrite a still-queued request's inputs
            request = Request(
                tenant,
                np.array(x, copy=True),
                deadline=survive_lib.admission_deadline(
                    time.perf_counter(), self.survive.request_ttl_s, deadline_s
                ),
            )
            t.end_span(adm, rows=int(x.shape[0]), request=request.id)
            if t.enabled:
                # attach BEFORE put: the instant put() publishes the request
                # a dispatcher may take and serve it — a trace attached
                # after would race the dispatch and leak a never-closed
                # queue_wait. The trace then rides the queue on the request
                # itself, so retries and failovers extend the SAME tree.
                request.trace = {
                    "root": root,
                    "open": t.start_span(
                        "queue_wait", trace_lib.KIND_QUEUE_WAIT, parent=root,
                    ),
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

    # -------------------------------------------------------------- dispatch --
    def _event(self, record: dict) -> None:
        if self.writer is not None:
            self.writer.write(schema.stamp("event", record))

    def _dispatch_loop(self, replica: Replica) -> None:
        """One replica's life: pull, dispatch, deliver, repeat — exits when
        the queue closes and drains. A failed dispatch retries its batch's
        requests within the per-tenant retry budget (they re-enter the
        queue and another — or the recovered — replica serves them) and
        fails the rest through their futures; the loop itself never dies on
        a dispatch. ``unhealthy_after`` consecutive failures put the
        replica on PROBATION: a bounded jittered-backoff recovery loop
        (rebuild + re-warm + canary) runs here, off the serving path, and
        the replica rejoins routing only after the canary passes
        (``replica_recovered`` event). Probation exhausted -> permanent
        removal: with surviving peers this thread exits (traffic continues
        on them); as the LAST replica, after that one recovery round, the
        loop keeps pulling and fails everything with the typed
        ``no_healthy_replica`` reason — queued clients get machine-readable
        errors, never a hung drain."""
        replica.loop_alive = True
        try:
            self._dispatch_loop_body(replica)
        finally:
            replica.loop_alive = False

    def _dispatch_loop_body(self, replica: Replica) -> None:
        while True:
            batch = self.scheduler.next_batch()
            if batch is None:
                return
            if replica.state == "removed":
                # mortuary mode — only reachable when no servable replica
                # remains and the recovery round already failed
                err = NoHealthyReplicaError(
                    f"replica {replica.index} is removed and no healthy "
                    "replicas remain"
                )
                for r in batch.requests:
                    self._fail_request(r, err)
                continue
            t_dispatch = time.perf_counter()
            t = self.tracer
            for r in batch.requests:
                if r.trace:
                    # queue wait is over; the serve interval (dispatch ->
                    # delivery, shared by the whole coalesced batch) begins
                    t.end_span(r.trace["open"])
                    r.trace["open"] = t.start_span(
                        "serve", trace_lib.KIND_SERVE, parent=r.trace["root"],
                        attrs={"replica": replica.index},
                    )
            bsp = t.start_span(
                "infer", trace_lib.KIND_DISPATCH,
                tid=f"replica{replica.index}",
                attrs={
                    "requests": len(batch.requests),
                    "rows": int(batch.x.shape[0]),
                },
            )
            try:
                kind = faults.maybe_serving_fault(
                    "batch", batch=next(self._batch_counter)
                )
                if kind == "replica_kill":
                    replica.broken = True  # persistent until rebuild()
                if kind == "dispatch_wedge":
                    raise RuntimeError(
                        "injected dispatch_wedge fault (transient)"
                    )
                logits = replica.infer(batch.x)  # host logits: the fetch is the fence
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:  # noqa: BLE001 — retried or delivered
                t.end_span(bsp, error=repr(e))
                self._dispatch_failed(replica, batch, e)
                if replica.state == "recovering" and not self._probation(replica):
                    with self._health_lock:
                        survivors = survive_lib.live_survivors(
                            self.pool.replicas, replica
                        )
                    if survivors:
                        return  # peers own the traffic; this thread is done
                    logger.critical(
                        "serving: NO healthy replicas remain after the "
                        "recovery round; failing queued requests with "
                        "reason no_healthy_replica instead of hanging"
                    )
                    self._event({
                        "event": "no_healthy_replica",
                        "replica": replica.index,
                    })
                    if self.flight is not None:
                        # serving dispatch death: the last windows + the
                        # dispatch-error/unhealthy events are in the ring
                        self.flight.dump("serving_dispatch")
                continue
            t.end_span(bsp)
            replica.consecutive_errors = 0
            for r in batch.requests:
                if r.retries:
                    # a retried request made it: return its tokens so a
                    # transient blip never permanently drains the tenant
                    self.retry_budget.refund(r.tenant, r.retries)
                    r.retries = 0
            t_done = time.perf_counter()
            for r, (lo, hi) in zip(batch.requests, batch.slices):
                # copy, don't view: a view would pin the whole padded
                # bucket's logits per result and alias clients to each other
                r.result._deliver(logits[lo:hi].copy())
                if r.trace:
                    t.end_span(r.trace["open"])
                    t.end_span(r.trace["root"], rows=hi - lo)
                    r.trace = None
            self.stats.record_batch(batch, t_dispatch, t_done)

    def _fail_request(self, r, error: BaseException) -> None:
        """Fail one request through its future — refunding any retry
        tokens it consumed first: the budget bounds retries PER REQUEST,
        and a request leaving the system (success or failure alike) must
        not drain the tenant's budget for unrelated future work."""
        if r.retries:
            self.retry_budget.refund(r.tenant, r.retries)
            r.retries = 0
        self._trace_close(r, error)
        r.result._deliver(None, error=error)

    def _dispatch_failed(self, replica: Replica, batch, e: BaseException) -> None:
        """One failed dispatch: retry the batch's requests within the
        per-tenant budget (re-queued at lane front; any replica may pick
        them up), fail the rest, and cross into probation at the
        ``unhealthy_after`` threshold."""
        logger.exception(
            "serving: dispatch failed on replica %d", replica.index
        )
        replica.consecutive_errors += 1
        retried = 0
        for r in batch.requests:
            if self.retry_budget.try_consume(r.tenant):
                r.retries += 1
                retried += 1
                self.stats.record_retry(r.tenant)
                if r.trace:
                    # the failed serve attempt closes; a fresh queue_wait
                    # follows from it — the retry stays one trace
                    failed = r.trace["open"]
                    self.tracer.end_span(
                        failed, error="dispatch_failed", retry=r.retries,
                    )
                    r.trace["open"] = self.tracer.start_span(
                        "queue_wait", trace_lib.KIND_QUEUE_WAIT,
                        parent=r.trace["root"],
                        follows_from=failed.span_id,
                    )
                self.queue.requeue(r)
            else:
                self._fail_request(r, e)
        self._event({
            "event": "serving_dispatch_error",
            "replica": replica.index,
            "error": repr(e),
            "requests": len(batch.requests),
            "retried": retried,
        })
        if (
            self.unhealthy_after
            and replica.state == "healthy"
            and replica.consecutive_errors >= self.unhealthy_after
        ):
            replica.state = "recovering"
            logger.critical(
                "serving: replica %d marked UNHEALTHY after %d consecutive "
                "dispatch errors; entering probation",
                replica.index, replica.consecutive_errors,
            )
            self._event({
                "event": "replica_unhealthy",
                "replica": replica.index,
                "consecutive_errors": replica.consecutive_errors,
            })

    def _probation(self, replica: Replica) -> bool:
        """One probation episode for an unhealthy replica. True = it passed
        (rebuilt, re-warmed, canary served finite logits) and rejoined
        routing; False = it is permanently removed (``max_recoveries``
        lifetime episodes spent, or every in-episode attempt failed)."""

        def recover():
            replica.rebuild()
            replica.warmup(self.scheduler.buckets, self.pool.sample_shape)
            replica.canary(self.pool.sample_shape)

        psp = self.tracer.start_span(
            f"probation replica {replica.index}", trace_lib.KIND_PROBATION,
            tid=f"replica{replica.index}",
            attrs={"recoveries": replica.recoveries},
        )
        ok, event = survive_lib.probation_episode(
            replica,
            name=f"serving replica {replica.index}",
            recover=recover,
            policy=self.survive,
            lock=self._health_lock,
        )
        self.tracer.end_span(psp, outcome="recovered" if ok else "removed")
        if ok:
            replica.consecutive_errors = 0
        self._event(event)
        return ok
