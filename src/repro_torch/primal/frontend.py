"""Traffic-hardened async frontend over the λ-resident AllocationServer;
port of `repro.primal.frontend` (host-side bookkeeping, the same state
machine, series and events).

`AllocationServer.query` is a synchronous microbatch call: perfect for
one caller, defenseless at traffic.  A burst of concurrent clients — or
one slow `warm_resolve` — turns into unbounded queueing with no timeout,
no shedding, and no safe shutdown.  This module is the hardening layer
(DESIGN.md §12): callers submit requests to a *bounded* queue and get a
`Ticket`; a single dispatch thread coalesces queued requests into
deadline-aware microbatches and answers every ticket with a classified
`Response`.  Four properties, each enforced structurally:

  * admission control + load shedding — a request is admitted only if
    the queue has room AND its estimated wait (queued batches × an EMA of
    batch execution time) fits inside its deadline; otherwise it gets an
    immediate SHED response instead of unbounded latency.  Overload cost
    is paid at the door, not discovered at the deadline.
  * deadline-aware microbatch coalescing — the dispatch thread batches
    up to `max_batch` sources (the server pads to the same power-of-two
    lengths the kernels already specialize on), flushing on batch-full,
    on the `max_wait_s` coalesce window, or early when the tightest
    deadline in the batch leaves no slack for further waiting.
  * classified completion — every submitted request terminates in
    exactly one of OK / SHED / TIMEOUT / ERROR.  A request that expires
    in the queue is TIMEOUT without touching the device; one that
    completes past its deadline is TIMEOUT even though it computed;
    unknown source ids are ERROR at submission (the async 404).  No
    request is ever silently dropped.
  * resolve circuit breaker + graceful drain — `refresh()` runs
    `warm_resolve` (with its §9 retry/backoff and atomic snapshot swap)
    on a background thread, at most one in flight; the query path never
    blocks on it.  `drain()` (or SIGTERM via
    `install_signal_handlers()`) stops admissions, flushes every
    in-flight batch, resolves any leftovers, and emits a final metrics
    snapshot — shutdown leaves zero unanswered tickets.

Threading model: ONE dispatch thread executes batches (on the server's
query stream, so device work of queries stays serialized), any number of
client threads submit, and at most one resolve thread re-solves (on the
server's resolve stream, which queries never wait behind).  Coherence of
the served (obj, λ) pair is the server's snapshot contract; everything
here is host-side bookkeeping under one lock.
"""
from __future__ import annotations

import dataclasses
import enum
import math
import signal
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Sequence

from ..obs import Telemetry
from ..obs.memory import register_memory_gauges
from ..obs.metrics import (DEFAULT_LATENCY_BUCKETS, MetricsExporter,
                           MetricsRegistry)

from .server import AllocationServer, DecisionRow

__all__ = ["FrontendConfig", "RequestStatus", "Response", "Ticket",
           "ServerFrontend", "FrontendStats"]


class RequestStatus(enum.Enum):
    OK = "ok"            # completed within its deadline
    SHED = "shed"        # refused admission (queue full / est. wait / drain)
    TIMEOUT = "timeout"  # admitted but missed its deadline
    ERROR = "error"      # failed outright (unknown source, batch exception)


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Knobs of the admission/batching/drain state machine (module doc).

    max_queue      bounded request queue: depth at or beyond this sheds;
    max_batch      sources coalesced per dispatch (the server pads each
                   slab group to the pow2 kernel lengths, capped by its
                   own max_batch);
    max_wait_s     coalesce window: a batch never waits longer than this
                   for company;
    default_deadline_s  per-request deadline when the caller gives none;
    shed_wait_factor    admit only while estimated wait <= factor ×
                   remaining deadline (1.0 = shed anything predicted to
                   time out anyway);
    ema_alpha / initial_batch_estimate_s   the batch-execution-time EMA
                   the estimated-wait gate runs on;
    drain_timeout_s     how long `drain()` waits for the dispatch thread
                   to flush before force-resolving leftovers as SHED;
    metrics_port   when set, serve the live Prometheus `/metrics` plane
                   (DESIGN.md §13) on this port for the frontend's
                   registry — 0 binds an ephemeral port (read it back
                   from `frontend.exporter.port`); None (default) runs
                   no HTTP listener at all.
    """

    max_queue: int = 256
    max_batch: int = 64
    max_wait_s: float = 0.002
    default_deadline_s: float = 0.25
    shed_wait_factor: float = 1.0
    ema_alpha: float = 0.2
    initial_batch_estimate_s: float = 0.002
    drain_timeout_s: float = 10.0
    metrics_port: Optional[int] = None


class Response(NamedTuple):
    """The classified answer to one submitted request."""

    status: RequestStatus
    decisions: Optional[Dict[int, DecisionRow]]  # present only for OK
    reason: str = ""
    latency_s: float = 0.0


class Ticket:
    """A pending request: wait on `result()` for its classified Response.

    Completion is one-shot and thread-safe; every admitted or refused
    ticket is completed by the frontend exactly once.
    """

    __slots__ = ("source_ids", "deadline", "t_submit", "_event", "_response")

    def __init__(self, source_ids: List[int], deadline: float,
                 t_submit: float):
        self.source_ids = source_ids
        self.deadline = deadline
        self.t_submit = t_submit
        self._event = threading.Event()
        self._response: Optional[Response] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Response:
        """Block until the response is ready (raises TimeoutError if
        `timeout` seconds pass first — distinct from a TIMEOUT response,
        which is the request missing its *serving* deadline)."""
        if not self._event.wait(timeout):
            raise TimeoutError("response not ready")
        return self._response

    def _complete(self, response: Response) -> None:
        self._response = response
        self._event.set()


class FrontendStats(NamedTuple):
    """Point-in-time serving-frontend statistics (see metrics_snapshot
    for the lifetime-monotonic scrape surface)."""

    submitted: int
    admitted: int
    ok: int
    shed: int
    timeout: int
    error: int
    batches: int
    queue_depth: int
    ema_batch_ms: float
    ok_p50_ms: float
    ok_p99_ms: float


class ServerFrontend:
    """The async admission/batching/drain layer over one AllocationServer
    (module doc)."""

    def __init__(self, server: AllocationServer,
                 config: Optional[FrontendConfig] = None,
                 telemetry: Optional[Telemetry] = None,
                 start: bool = True,
                 registry: Optional[MetricsRegistry] = None):
        self.server = server
        self.config = config or FrontendConfig()
        self.telemetry = (telemetry if telemetry is not None
                          else server.telemetry)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: deque = deque()
        self._pending_sources = 0
        self._ema_batch_s = float(self.config.initial_batch_estimate_s)
        self._draining = False
        self._stopped = False
        # the scrape plane (DESIGN.md §13): the frontend shares the
        # server's registry by default, so ONE /metrics endpoint carries
        # query latencies, admission counters, resolve staleness, and the
        # memory gauges together
        self.registry = registry if registry is not None else server.registry
        self._c_requests = self.registry.counter(
            "repro_frontend_requests_total",
            "Classified request completions (every submitted request "
            "terminates in exactly one class).", labels=("status",))
        self._c_submitted = self.registry.counter(
            "repro_frontend_submitted_total", "Requests submitted.")
        self._c_admitted = self.registry.counter(
            "repro_frontend_admitted_total",
            "Requests admitted past the shed gate.")
        self._c_batches = self.registry.counter(
            "repro_frontend_batches_total",
            "Coalesced microbatches dispatched.")
        self._lat_hist = self.registry.histogram(
            "repro_frontend_latency_seconds",
            "End-to-end request latency (submit to classified "
            "completion), by final status.",
            buckets=DEFAULT_LATENCY_BUCKETS, labels=("status",))
        # materialize every status child up front so a scrape always sees
        # the full classification space at 0 (a counter that appears only
        # on its first increment breaks rate() and the smoke's presence
        # checks)
        for st in RequestStatus:
            self._c_requests.labels(status=st.value)
            self._lat_hist.labels(status=st.value)
        self.registry.gauge(
            "repro_frontend_queue_depth",
            "Requests waiting in the bounded admission queue."
        ).set_function(lambda: float(len(self._queue)))
        self.registry.gauge(
            "repro_frontend_ema_batch_seconds",
            "EMA of batch execution time (the shed gate's estimator)."
        ).set_function(lambda: self._ema_batch_s)
        self.registry.gauge(
            "repro_frontend_draining",
            "1 once drain() stopped admissions."
        ).set_function(lambda: 1.0 if self._draining else 0.0)
        register_memory_gauges(self.registry, device=server.device)
        self.exporter: Optional[MetricsExporter] = None
        if self.config.metrics_port is not None:
            self.exporter = MetricsExporter(self.registry,
                                            self.config.metrics_port)
        self._refresh_lock = threading.Lock()
        self._resolve_thread: Optional[threading.Thread] = None
        self.last_resolve = None   # ("accepted"|"rejected"|"error", result)
        self._worker = threading.Thread(target=self._run,
                                        name="frontend-dispatch",
                                        daemon=True)
        if start:
            self._worker.start()

    # -- admission --------------------------------------------------------
    def submit(self, source_ids: Sequence[int],
               deadline_s: Optional[float] = None) -> Ticket:
        """Admit (or refuse) one request; never blocks on device work.

        Refusals complete the ticket immediately: SHED when draining, the
        queue is full, or the estimated wait exceeds the deadline; ERROR
        for unknown source ids.  Admitted tickets are completed by the
        dispatch thread with OK / TIMEOUT / ERROR.
        """
        now = time.monotonic()
        if deadline_s is None:
            deadline_s = self.config.default_deadline_s
        deadline_s = float(deadline_s)
        ids = [int(s) for s in source_ids]
        ticket = Ticket(ids, now + deadline_s, now)
        self._c_submitted.inc()
        unknown = self.server.unknown_sources(ids)
        if unknown:
            self._finish(ticket, RequestStatus.ERROR,
                         reason=f"unknown source ids {unknown[:3]}")
            return ticket
        with self._cond:
            if self._draining or self._stopped:
                return self._shed_locked(ticket, "draining")
            if len(self._queue) >= self.config.max_queue:
                return self._shed_locked(ticket, "queue_full")
            est_wait = self._estimated_wait_locked(len(ids))
            if est_wait > self.config.shed_wait_factor * deadline_s:
                return self._shed_locked(
                    ticket, "est_wait",
                    detail=f"{est_wait * 1e3:.1f}ms est vs "
                           f"{deadline_s * 1e3:.1f}ms deadline")
            self._c_admitted.inc()
            self._queue.append(ticket)
            self._pending_sources += len(ids)
            self._cond.notify()
        return ticket

    def query(self, source_ids: Sequence[int],
              deadline_s: Optional[float] = None,
              timeout: Optional[float] = None) -> Response:
        """Synchronous convenience: submit + wait for the response."""
        return self.submit(source_ids, deadline_s).result(timeout)

    def _estimated_wait_locked(self, extra_sources: int) -> float:
        batches_ahead = math.ceil(
            (self._pending_sources + extra_sources)
            / max(self.config.max_batch, 1))
        return batches_ahead * self._ema_batch_s

    def _shed_locked(self, ticket: Ticket, reason: str,
                     detail: str = "") -> Ticket:
        latency = time.monotonic() - ticket.t_submit
        self._c_requests.labels(status="shed").inc()
        self._lat_hist.labels(status="shed").observe(latency)
        self.telemetry.counter("frontend.shed")
        self.telemetry.event("shed", reason=reason, detail=detail,
                             sources=len(ticket.source_ids))
        ticket._complete(Response(
            status=RequestStatus.SHED, decisions=None,
            reason=reason if not detail else f"{reason}: {detail}",
            latency_s=latency))
        return ticket

    def _finish(self, ticket: Ticket, status: RequestStatus,
                decisions: Optional[Dict[int, DecisionRow]] = None,
                reason: str = "", now: Optional[float] = None) -> None:
        """Complete `ticket`; `now` is the instant its class was decided
        (the latency reported is measured to it), else the present."""
        if now is None:
            now = time.monotonic()
        latency = now - ticket.t_submit
        self._c_requests.labels(status=status.value).inc()
        self._lat_hist.labels(status=status.value).observe(latency)
        if status is RequestStatus.TIMEOUT:
            self.telemetry.counter("frontend.timeout")
            self.telemetry.event(
                "timeout", waited_s=latency,
                deadline_s=ticket.deadline - ticket.t_submit,
                reason=reason)
        elif status is RequestStatus.ERROR:
            self.telemetry.counter("frontend.error")
        else:
            self.telemetry.counter("frontend.ok")
        ticket._complete(Response(status=status, decisions=decisions,
                                  reason=reason, latency_s=latency))

    # -- dispatch loop ----------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue:
                    if self._stopped or self._draining:
                        return
                    self._cond.wait(0.05)
                first = self._queue.popleft()
                self._pending_sources -= len(first.source_ids)
            try:
                self._process_batch(first)
            except Exception as e:  # never die silently mid-serve
                self._finish(first, RequestStatus.ERROR,
                             reason=f"dispatch failed: "
                                    f"{type(e).__name__}: {e}")
                self.telemetry.error(f"frontend dispatch error: {e}")

    def _coalesce(self, batch: List[Ticket], n_src: int) -> int:
        """Grow `batch` until full, the coalesce window closes, or the
        tightest deadline leaves no slack for more waiting."""
        cfg = self.config
        t_first = time.monotonic()
        while n_src < cfg.max_batch:
            now = time.monotonic()
            slack = min(t.deadline for t in batch) - now - self._ema_batch_s
            remaining = min(cfg.max_wait_s - (now - t_first), slack)
            if remaining <= 0:
                break
            with self._cond:
                if not self._queue:
                    self._cond.wait(remaining)
                if not self._queue:
                    break   # window closed with no company: flush
                nxt = self._queue[0]
                if n_src + len(nxt.source_ids) > cfg.max_batch:
                    break
                self._queue.popleft()
                self._pending_sources -= len(nxt.source_ids)
            batch.append(nxt)
            n_src += len(nxt.source_ids)
        return n_src

    def _process_batch(self, first: Ticket) -> None:
        n_src = self._coalesce(batch := [first], len(first.source_ids))
        with self._lock:
            depth = len(self._queue)
        self.telemetry.gauge("frontend.queue_depth", depth)
        self.telemetry.event("queue_depth", depth=depth,
                             batch_sources=n_src,
                             batch_requests=len(batch))

        # queue-expired requests go straight to TIMEOUT — no device work
        now = time.monotonic()
        live = []
        for t in batch:
            if now >= t.deadline:
                self._finish(t, RequestStatus.TIMEOUT,
                             reason="expired in queue")
            else:
                live.append(t)
        if not live:
            return

        seen, ids = set(), []
        for t in live:
            for sid in t.source_ids:
                if sid not in seen:     # dedup across coalesced requests
                    seen.add(sid)
                    ids.append(sid)
        try:
            t_exec = time.monotonic()
            decisions = self.server.query(ids)
            dt = time.monotonic() - t_exec
        except Exception as e:
            for t in live:
                self._finish(t, RequestStatus.ERROR,
                             reason=f"batch failed: "
                                    f"{type(e).__name__}: {e}")
            self.telemetry.error(f"frontend batch execution failed: {e}")
            return
        a = self.config.ema_alpha
        with self._lock:
            self._ema_batch_s = a * dt + (1 - a) * self._ema_batch_s
        self._c_batches.inc()
        done = time.monotonic()
        for t in live:
            if done > t.deadline:   # computed, but too late: still TIMEOUT
                self._finish(t, RequestStatus.TIMEOUT,
                             reason="completed past deadline", now=done)
            else:
                self._finish(t, RequestStatus.OK,
                             decisions={s: decisions[s]
                                        for s in t.source_ids}, now=done)

    # -- background refresh (the resolve circuit breaker) -----------------
    def refresh(self, criteria=None, obj=None, config=None,
                require_certificate: bool = False,
                force: bool = False) -> bool:
        """Kick a background `warm_resolve`; never blocks the query path.

        At most one resolve is in flight — a second call while one runs
        returns False (classified skipped, the circuit-breaker).  The
        resolve carries the §9 acceptance checks, retry backoff, and
        atomic snapshot swap; its outcome lands in `last_resolve`.
        A dual-shape mismatch on `obj` raises here, synchronously — a
        topology change is a caller bug, not a background failure.
        """
        if obj is not None and (tuple(obj.dual_shape)
                                != tuple(self.server.obj.dual_shape)):
            raise ValueError(
                f"replacement objective dual shape "
                f"{tuple(obj.dual_shape)} != served "
                f"{tuple(self.server.obj.dual_shape)}")
        with self._refresh_lock:
            if (self._resolve_thread is not None
                    and self._resolve_thread.is_alive()):
                self.telemetry.event("resolve", outcome="skipped",
                                     reason="refresh_in_flight")
                return False

            def _resolve():
                try:
                    res = self.server.warm_resolve(
                        criteria=criteria, obj=obj, config=config,
                        require_certificate=require_certificate,
                        force=force)
                    self.last_resolve = (
                        "accepted" if res is not None else "rejected", res)
                except Exception as e:   # pragma: no cover - defensive
                    self.last_resolve = ("error", None)
                    self.telemetry.error(
                        f"background warm_resolve raised: {e}")

            self._resolve_thread = threading.Thread(
                target=_resolve, name="frontend-resolve", daemon=True)
            self._resolve_thread.start()
            return True

    def refresh_in_flight(self) -> bool:
        t = self._resolve_thread
        return t is not None and t.is_alive()

    def wait_refresh(self, timeout: Optional[float] = None):
        """Join the in-flight resolve (if any); returns `last_resolve`."""
        t = self._resolve_thread
        if t is not None:
            t.join(timeout)
        return self.last_resolve

    # -- graceful drain ---------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> Dict[str, float]:
        """Stop admitting, flush in-flight batches, answer every ticket.

        New submissions SHED immediately with reason `draining`; queued
        requests are still dispatched (expired ones classify TIMEOUT).
        If the dispatch thread does not empty the queue within `timeout`
        (default `drain_timeout_s`) the leftovers are resolved as SHED —
        a drain never strands an unanswered ticket.  Emits the final
        `drain` event + metrics snapshot and returns the snapshot.
        """
        if timeout is None:
            timeout = self.config.drain_timeout_s
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        if self._worker.is_alive():
            self._worker.join(timeout)
        leftovers = []
        with self._cond:
            self._stopped = True
            while self._queue:
                leftovers.append(self._queue.popleft())
            self._pending_sources = 0
            self._cond.notify_all()
        for t in leftovers:
            self._shed_after_drain(t)
        snap = self.metrics_snapshot()
        self.telemetry.event("drain", pending=len(leftovers),
                             **{k: v for k, v in snap.items()
                                if k.endswith("_total")})
        # post-mortem parity with the live plane: the run log carries the
        # same registry digest /metrics was serving (DESIGN.md §13)
        self.telemetry.event("metrics", series=self.registry.summary())
        self.telemetry.gauge("frontend.queue_depth", 0)
        if self.exporter is not None:
            # closed LAST: the final drained state stays scrapeable until
            # every ticket is answered
            self.exporter.close()
        return snap

    def _shed_after_drain(self, ticket: Ticket) -> None:
        latency = time.monotonic() - ticket.t_submit
        self._c_requests.labels(status="shed").inc()
        self._lat_hist.labels(status="shed").observe(latency)
        self.telemetry.counter("frontend.shed")
        self.telemetry.event("shed", reason="drain_timeout", detail="",
                             sources=len(ticket.source_ids))
        ticket._complete(Response(
            status=RequestStatus.SHED, decisions=None,
            reason="drain_timeout", latency_s=latency))

    def install_signal_handlers(self, signals=(signal.SIGTERM,)) -> None:
        """Drain gracefully on SIGTERM (call from the main thread only —
        a CPython restriction on signal.signal)."""
        def _handler(signum, frame):
            self.drain()
        for s in signals:
            signal.signal(s, _handler)

    # -- observability ----------------------------------------------------
    def stats(self) -> FrontendStats:
        """Point-in-time stats; OK quantiles are bucket-estimated from
        the shared `repro_frontend_latency_seconds{status="ok"}`
        histogram (`HistogramSnapshot.quantile` — the one quantile
        implementation, DESIGN.md §13)."""
        with self._lock:
            depth = len(self._queue)
            ema = self._ema_batch_s
        ok_snap = self._lat_hist.labels(status="ok").snapshot()
        return FrontendStats(
            submitted=int(self._c_submitted.value),
            admitted=int(self._c_admitted.value),
            ok=int(self._c_requests.labels(status="ok").value),
            shed=int(self._c_requests.labels(status="shed").value),
            timeout=int(self._c_requests.labels(status="timeout").value),
            error=int(self._c_requests.labels(status="error").value),
            batches=int(self._c_batches.value), queue_depth=depth,
            ema_batch_ms=ema * 1e3,
            ok_p50_ms=ok_snap.quantile(0.50) * 1e3,
            ok_p99_ms=ok_snap.quantile(0.99) * 1e3)

    def metrics_snapshot(self) -> Dict[str, float]:
        """Lifetime-monotonic counters + gauges, the same scrape contract
        as `AllocationServer.metrics_snapshot` (counters never rewind);
        the counters are the same registry families `/metrics` serves."""
        with self._lock:
            depth = len(self._queue)
            ema = self._ema_batch_s
        snap: Dict[str, float] = {
            "submitted_total": int(self._c_submitted.value),
            "admitted_total": int(self._c_admitted.value),
            "batches_total": int(self._c_batches.value),
        }
        for status in ("ok", "shed", "timeout", "error"):
            snap[f"{status}_total"] = int(
                self._c_requests.labels(status=status).value)
        snap["queue_depth"] = depth
        snap["ema_batch_s"] = ema
        snap["draining"] = 1 if self._draining else 0
        return snap
