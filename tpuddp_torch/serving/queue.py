"""Request queue and admission control — the counterpart of
``tpuddp/serving/queue.py``, the front door of both serving engines.

Admission is decided synchronously at ``put`` time against two bounds: a
global queue depth (beyond it the engine is overloaded and honest rejection
beats unbounded latency) and an optional per-tenant quota (one tenant's
flood must not evict everyone else's capacity). Rejections raise
:class:`AdmissionError` carrying a machine-readable ``reason`` so callers
(and the SLO stats) can distinguish "back off" from "you sent garbage".

Fairness: requests are kept in per-tenant FIFO lanes and drained round-robin
— each assembled batch takes at most one head-of-lane request per tenant per
pass, so a tenant queueing 100 requests cannot make another tenant's single
request wait behind all 100. Within a tenant, order is strictly FIFO.

Everything here is plain ``threading`` — dispatch loops (one per replica)
block on the queue's condition variable; device work never holds the lock.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict, deque
from typing import List, Optional, Tuple

import numpy as np

from tpuddp_torch.utils import batching

# Machine-readable admission-rejection reasons (the `reason` field of
# AdmissionError and the per-reason reject counters in ServingStats).
REJECT_QUEUE_FULL = "queue_full"  # global max_queue_depth reached
REJECT_TENANT_QUOTA = "tenant_quota"  # this tenant's quota reached
REJECT_DRAINING = "draining"  # engine is shutting down; no new admissions
REJECT_OVERSIZED = "oversized"  # more rows than max_batch_size can ever hold
REJECT_BAD_SHAPE = "bad_shape"  # sample shape/dtype != the served model's
REJECT_DEADLINE = "deadline_exceeded"  # queued past its deadline; shed
# before dispatch (load shedding, serving/survive.py) — work already
# IN FLIGHT is never killed by a deadline

REJECT_REASONS = (
    REJECT_QUEUE_FULL,
    REJECT_TENANT_QUOTA,
    REJECT_DRAINING,
    REJECT_OVERSIZED,
    REJECT_BAD_SHAPE,
    REJECT_DEADLINE,
)


class AdmissionError(RuntimeError):
    """A request the engine refused to admit. ``reason`` is one of
    :data:`REJECT_REASONS`; the message carries the human detail."""

    def __init__(self, reason: str, detail: str):
        assert reason in REJECT_REASONS, reason
        self.reason = reason
        super().__init__(f"request rejected ({reason}): {detail}")


class ServedResult:
    """Future for one request's logits.

    ``result(timeout)`` blocks until the dispatch loop delivers; a failed
    dispatch delivers the exception instead, so a caller never hangs on a
    batch that died. ``done_at`` (perf_counter seconds) is stamped at
    delivery — the timestamp load generators difference against their own
    submit time for end-to-end latency without a callback in the hot path."""

    def __init__(self):
        self._event = threading.Event()
        self._value: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None
        self.done_at: Optional[float] = None

    def _deliver(self, value: Optional[np.ndarray], error=None) -> None:
        self._value = value
        self._error = error
        self.done_at = time.perf_counter()
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError("request not served within the timeout")
        if self._error is not None:
            raise self._error
        return self._value


_ids = itertools.count()


class Request:
    """One admitted inference request: ``x`` is a ``(rows, *sample_shape)``
    host batch (rows >= 1, variable per request); results arrive on
    ``result``. ``key`` buckets by per-SAMPLE shape+dtype (rows concatenate
    across requests, so the batch axis is not part of the key).

    ``deadline`` (absolute perf_counter seconds, or None) arms load
    shedding: a request still queued past it is shed with reason
    ``deadline_exceeded`` instead of dispatched. ``retries`` counts how
    many times a transient dispatch failure re-queued this request (the
    per-tenant :class:`~tpuddp_torch.serving.survive.RetryBudget` bounds it)."""

    __slots__ = (
        "id", "tenant", "x", "rows", "key", "t_enqueue", "result",
        "deadline", "retries", "resume_tokens", "trace",
    )

    def __init__(self, tenant: str, x: np.ndarray, deadline: Optional[float] = None):
        self.id = next(_ids)
        self.tenant = str(tenant)
        self.x = x
        self.rows = int(x.shape[0])
        self.key = (batching.shape_key(x)[0][1:], str(x.dtype))
        self.t_enqueue = time.perf_counter()
        self.result = ServedResult()
        self.deadline = deadline
        self.retries = 0
        # non-None marks a failover journal (a live session mid-migration,
        # decode engine); journals are in-flight work and are never shed
        self.resume_tokens = None
        # causal-tracing context (observability/trace.py; None = tracing
        # off): the engine hangs the request's root span + the currently
        # open child here so the request's whole life — admission, queue
        # wait, dispatch, retries, failover — stays ONE trace
        self.trace = None


class RequestQueue:
    """Bounded multi-tenant queue with round-robin draining.

    ``take_group(max_rows, top_up_wait)`` is the dispatch-loop primitive:
    block until work exists, then assemble up to ``max_rows`` rows of
    same-key requests round-robin across tenant lanes; optionally linger
    ``top_up_wait`` seconds to coalesce late arrivals into the same batch
    (the latency/occupancy knob). Returns ``None`` only when the queue is
    closed AND empty — the dispatch loop's exit signal."""

    def __init__(self, max_depth: int, per_tenant_quota: Optional[int] = None):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        if per_tenant_quota is not None and per_tenant_quota < 1:
            raise ValueError(
                f"per_tenant_quota must be >= 1 or None, got {per_tenant_quota}"
            )
        self.max_depth = int(max_depth)
        self.per_tenant_quota = (
            int(per_tenant_quota) if per_tenant_quota is not None else None
        )
        self._lanes: "OrderedDict[str, deque]" = OrderedDict()
        self._rr: int = 0  # round-robin cursor into the lane ordering
        self._depth = 0
        self._closed = False
        self._cond = threading.Condition()
        # load shedding (serving/survive.py): requests whose deadline
        # expired while still queued are dropped at assembly time — their
        # futures get a typed AdmissionError(deadline_exceeded), and the
        # engine's optional handler records the shed in its SLO stats. A
        # request holding a failover journal (resume_tokens set — a live
        # session mid-migration) is never shed: it is in-flight work.
        self.shed_handler = None  # optional callable(request)

    # ---------------------------------------------------------- admission --
    def put(self, request: Request) -> None:
        """Admit or raise :class:`AdmissionError` (synchronously — the caller
        knows the verdict before ``put`` returns)."""
        with self._cond:
            if self._closed:
                raise AdmissionError(
                    REJECT_DRAINING, "the engine is draining; no new admissions"
                )
            if self._depth >= self.max_depth:
                raise AdmissionError(
                    REJECT_QUEUE_FULL,
                    f"queue depth {self._depth} is at max_queue_depth="
                    f"{self.max_depth}",
                )
            lane = self._lanes.get(request.tenant)
            if (
                self.per_tenant_quota is not None
                and lane is not None
                and len(lane) >= self.per_tenant_quota
            ):
                raise AdmissionError(
                    REJECT_TENANT_QUOTA,
                    f"tenant {request.tenant!r} has {len(lane)} queued "
                    f"requests, at per_tenant_quota={self.per_tenant_quota}",
                )
            if lane is None:
                lane = self._lanes[request.tenant] = deque()
            lane.append(request)
            self._depth += 1
            # notify_all, not notify: a single wakeup can land on a thread
            # mid-linger whose batch cannot take this request (rows don't
            # fit), leaving an IDLE replica asleep while admitted work sits
            # queued. Waiter count == replica count, so the broadcast is
            # cheap.
            self._cond.notify_all()

    def requeue(self, request) -> None:
        """Return an already-admitted request to the FRONT of its tenant
        lane — the transient-retry / session-failover path. Bypasses
        admission control entirely (depth bound, quota, and the closed
        flag): the request was admitted once and is owed service, even by a
        draining engine whose replica died mid-stream."""
        with self._cond:
            lane = self._lanes.get(request.tenant)
            if lane is None:
                lane = self._lanes[request.tenant] = deque()
            lane.appendleft(request)
            self._depth += 1
            self._cond.notify_all()

    def close(self) -> None:
        """Stop admissions; queued work still drains. Wakes every waiter."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    def depth(self) -> int:
        with self._cond:
            return self._depth

    def tenant_depth(self, tenant: str) -> int:
        with self._cond:
            lane = self._lanes.get(tenant)
            return len(lane) if lane else 0

    def tenant_depths(self) -> dict:
        """Current queued-request count per tenant lane (the exporter's
        per-tenant queue-depth gauge) — one lock hold for the whole view."""
        with self._cond:
            return {t: len(lane) for t, lane in self._lanes.items() if lane}

    # ------------------------------------------------------------ draining --
    @staticmethod
    def _expired(request, now: float) -> bool:
        """Queued-deadline check. A failover journal (``resume_tokens`` not
        None — a live session awaiting migration) is in-flight work and is
        exempt: deadlines shed queued work only, never kill a stream."""
        return (
            getattr(request, "deadline", None) is not None
            and now > request.deadline
            and getattr(request, "resume_tokens", None) is None
        )

    def _assemble(
        self, max_rows: int, key=None, shed: Optional[List[Request]] = None
    ) -> Tuple[List[Request], Optional[tuple]]:
        """Pop up to ``max_rows`` rows of ``key``-matching requests,
        round-robin across tenant lanes (at most one request per tenant per
        pass). Caller holds the lock. The first pop fixes ``key`` when None.
        A lane whose head doesn't match (different sample shape, or too many
        rows to fit the remaining budget) is skipped, not popped — per-tenant
        FIFO order is never reordered. Expired heads are popped into
        ``shed`` (never dispatched); the caller delivers their typed
        rejections OUTSIDE the lock."""
        taken: List[Request] = []
        rows = 0
        now = time.perf_counter()
        while True:
            lanes = list(self._lanes.keys())
            if not lanes:
                break
            took_this_pass = False
            n = len(lanes)
            start = self._rr % n  # fixed for the pass — the cursor must not
            # move under the iteration, or one tenant gets visited twice
            for i in range(n):
                name = lanes[(start + i) % n]
                lane = self._lanes.get(name)
                if not lane:
                    continue
                # shed expired work before it can cost a dispatch — the
                # deadline contract: queued-expired is rejected, in-flight
                # is untouchable
                while shed is not None and lane and self._expired(lane[0], now):
                    shed.append(lane.popleft())
                    self._depth -= 1
                if not lane:
                    del self._lanes[name]
                    continue
                head = lane[0]
                if key is not None and head.key != key:
                    continue
                if rows + head.rows > max_rows:
                    continue
                lane.popleft()
                self._depth -= 1
                if not lane:
                    del self._lanes[name]
                taken.append(head)
                rows += head.rows
                key = key if key is not None else head.key
                took_this_pass = True
                # the NEXT pass / NEXT batch starts with this tenant's
                # successor (by pass position; lane deletions shift the
                # ordering slightly, which only rotates the start — every
                # still-populated lane is visited exactly once per pass)
                self._rr = (start + i + 1) % n
                if rows >= max_rows:
                    return taken, key
            if not took_this_pass:
                break
        return taken, key

    def take_group(
        self, max_rows: int, top_up_wait: float = 0.0, wait: bool = True
    ) -> Optional[List[Request]]:
        """Block for work, then assemble one same-key group (see class doc).
        ``None`` = closed and fully drained. ``wait=False`` never blocks:
        an open-but-empty queue returns ``[]`` — the decode loop's
        between-steps poll (it must keep stepping its active sequences, not
        sleep on the condition variable, while the queue is empty).
        Expired queued requests encountered during assembly are shed
        (typed ``deadline_exceeded`` delivered to their futures after the
        lock is released — never dispatched). The delivery happens BEFORE
        the loop can re-block on the condition variable: a shed client's
        verdict must not wait for the next arrival (or drain) to wake this
        thread."""
        while True:
            shed: List[Request] = []
            try:
                with self._cond:
                    while self._depth == 0:
                        if self._closed:
                            return None
                        if not wait:
                            return []
                        self._cond.wait()
                    taken, key = self._assemble(max_rows, shed=shed)
                    if not taken:
                        if not shed:
                            # nothing shed AND nothing taken: a queued
                            # request is bigger than max_rows — the engine's
                            # oversized admission check exists precisely so
                            # this cannot happen; fail loudly over spinning
                            raise RuntimeError(
                                f"queued request(s) exceed the {max_rows}-row "
                                "batch budget; admission should have rejected "
                                "them as oversized"
                            )
                        # everything assembled-over was expired — deliver the
                        # shed verdicts (finally), then wait for live work
                        continue
                    # Linger for late arrivals ONLY while the queue is
                    # otherwise empty: under load there is more work right
                    # behind this batch, and a replica idling out the full
                    # linger on every dispatch would throttle saturation
                    # throughput for zero occupancy gain. At light load the
                    # linger is pure win — it coalesces a straggler into the
                    # in-hand batch instead of paying a whole extra dispatch
                    # for it.
                    if top_up_wait > 0 and self._depth == 0:
                        rows = sum(r.rows for r in taken)
                        deadline = time.monotonic() + top_up_wait
                        while rows < max_rows and not self._closed:
                            remaining = deadline - time.monotonic()
                            if remaining <= 0 or not self._cond.wait(remaining):
                                break
                            more, _ = self._assemble(
                                max_rows - rows, key, shed=shed
                            )
                            taken.extend(more)
                            rows += sum(r.rows for r in more)
                    return taken
            finally:
                for request in shed:
                    self._deliver_shed(request)

    def _deliver_shed(self, request) -> None:
        """Fail one expired request's future with the typed rejection and
        notify the engine's shed handler (stats). Called OUTSIDE the queue
        lock — the handler may take the stats lock, which the exporter
        holds while reading queue depth (lock-order safety)."""
        waited = time.perf_counter() - request.t_enqueue
        err = AdmissionError(
            REJECT_DEADLINE,
            f"request {request.id} (tenant {request.tenant!r}) expired after "
            f"{waited:.3f}s in queue; shed before dispatch",
        )
        request.result._deliver(None, error=err)
        if self.shed_handler is not None:
            try:
                self.shed_handler(request)
            except Exception:  # noqa: BLE001 — stats must not kill dispatch
                pass
