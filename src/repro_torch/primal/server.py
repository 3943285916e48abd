"""AllocationServer — the λ-resident online allocation query engine; port
of `repro.primal.server`.

The serving half of the duals-to-decisions story (DESIGN.md §8): the dual
vector λ — m·J + a few floats, regardless of edge count — stays resident
on the device, and each request for a batch of sources is answered by
recovering exactly those sources' decisions: gather their slab rows, run
the same per-row sweep as the solve loop (`MatchingObjective.primal_rows`:
K1 on a gathered sub-slab, on the card), return x*(λ).  No precomputed
allocation table exists anywhere; decisions are a pure function of
(λ, γ, instance), which is what makes replication trivial — ship λ, not x.

Request path mechanics:

  * routing: host-side tables built once per objective: the servable
    source ids sorted, each with its (slab, row), looked up by binary
    search (a dict of 2M entries at full width is what the reference
    builds), plus host copies of every slab's dest ids and masks;
  * microbatching: each query's rows are grouped per slab and padded to a
    power-of-two batch length (row 0 repeated; overhang dropped) capped at
    `max_batch`, the shapes `warmup()` runs once each;
  * measurement: every query records wall-clock latency; `stats()`
    summarizes count / mean / p50 / p95 / sources-per-second.

Served decisions are BITWISE equal to batch extraction at the same λ: the
per-row math is row-independent (K1's layout depends on the width alone,
a wide row runs a block to itself), so a row's x does not depend on how
many rows are launched with it.

`warm_resolve` is the instance-update hook: when budgets/rhs move, the
server re-solves *from its resident λ* with γ-continuation disabled (the
established warm-start rule: re-running the schedule from gamma_init
would march λ away from the loaded optimum), then swaps the new λ in.

Concurrency contract (DESIGN.md §12): everything a query reads — the
objective, λ, and the routing tables derived from the objective — lives
in ONE immutable `_Serving` snapshot tuple, and a query binds that tuple
exactly once at entry.  `warm_resolve`/`update_duals` publish a fully
built replacement snapshot with a single reference assignment (atomic
under the GIL), so a query racing a swap sees either the old pair or the
new pair, never a torn mix of the two.  Only one resolve runs at a time
(`_resolve_lock`; a second concurrent call is classified skipped), and
the latency window / counters are lock-protected.

Streams, on the card: queries run on the server's query stream and a
re-solve on its resolve stream (the current stream is per thread), so a
query's copy back to the host never waits behind a re-solve's queued
kernels.  A snapshot is published only after the stream that made its λ
is synchronized, and a query holds its bound snapshot until its own
synchronous copy completes, so the λ it reads is neither unfinished nor
freed under it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import Maximizer, SolveConfig, StoppingCriteria
from ..core.types import SolveResult, StopReason
from ..obs import Telemetry
from ..obs.metrics import DEFAULT_LATENCY_BUCKETS, MetricsRegistry
from .extract import rows_to_host


class DecisionRow(NamedTuple):
    """One source's served allocation: its slab row and the decisions."""

    source_id: int
    slab_index: int
    row: int
    dest_idx: np.ndarray   # (w,) destination ids (0 on padding)
    mask: np.ndarray       # (w,) True on real edges
    x: np.ndarray          # (w,) allocation per edge (0 on padding)


class QueryStats(NamedTuple):
    """Serving metrics.  The trailing fields are the degraded-mode health
    surface: `resolve_failures` counts every failed `warm_resolve` over
    the server's lifetime, `consecutive_failures` the current streak,
    `staleness_s` how long the served λ has gone without a successful
    refresh, and `degraded` whether the server is currently answering
    from a last-good λ after at least one failed refresh.

    Quantiles are bucket-estimated from the shared
    `repro_server_query_latency_seconds` histogram
    (`HistogramSnapshot.quantile`), over the window since construction /
    the last `reset_stats()`."""

    queries: int
    sources: int
    mean_ms: float
    p50_ms: float
    p95_ms: float
    sources_per_s: float
    resolve_failures: int = 0
    consecutive_failures: int = 0
    staleness_s: float = 0.0
    degraded: bool = False


def _pad_pow2(n: int, floor: int = 8) -> int:
    return max(floor, 1 << (max(n - 1, 1)).bit_length())


class _Routes(NamedTuple):
    """Source id → (slab, row), as sorted host tables, plus host copies
    of every slab's dest ids and masks (the rows a DecisionRow carries)."""

    ids: np.ndarray     # (S,) servable source ids, sorted, unique
    slab: np.ndarray    # (S,) slab index of ids[i]
    row: np.ndarray     # (S,) row of ids[i] in its slab
    dest: List[np.ndarray]
    mask: List[np.ndarray]

    def lookup(self, source_ids: Sequence[int]) -> Tuple[np.ndarray, ...]:
        """(ids, slab, row) of the ids in order; KeyError naming the first
        unknown."""
        q, found = self.find(source_ids)
        if not found.all():
            raise KeyError(int(q[np.argmin(found)]))
        pos = np.searchsorted(self.ids, q)
        return q, self.slab[pos], self.row[pos]

    def find(self, source_ids: Sequence[int]):
        """(the ids as int64, whether each is servable)."""
        q = np.asarray([int(s) for s in source_ids], np.int64)
        if not len(self.ids):
            return q, np.zeros(len(q), bool)
        pos = np.minimum(np.searchsorted(self.ids, q), len(self.ids) - 1)
        return q, self.ids[pos] == q


def _build_routes(obj) -> _Routes:
    ids, slab, row, dest, mask = [], [], [], [], []
    for si, s in enumerate(obj.lp.slabs):
        sid = s.source_ids.cpu().numpy().astype(np.int64)
        real = np.nonzero(sid >= 0)[0]    # padded rows carry source_id −1
        ids.append(sid[real])
        slab.append(np.full(len(real), si, np.int32))
        row.append(real)
        dest.append(s.dest_idx.cpu().numpy())
        mask.append(s.mask.cpu().numpy())
    ids = np.concatenate(ids) if ids else np.zeros(0, np.int64)
    slab = np.concatenate(slab) if slab else np.zeros(0, np.int32)
    row = np.concatenate(row) if row else np.zeros(0, np.int64)
    order = np.argsort(ids, kind="stable")
    ids, slab, row = ids[order], slab[order], row[order]
    # a repeated id routes to its last (slab, row), as the reference's
    # dict does
    last = np.ones(len(ids), bool)
    last[:-1] = ids[1:] != ids[:-1]
    return _Routes(ids=ids[last], slab=slab[last], row=row[last],
                   dest=dest, mask=mask)


def _same_slabs(a, b) -> bool:
    """True when two objectives route over the very same slab tensors
    (an rhs nudge or a wrapper), so their routes are the same."""
    sa, sb = a.lp.slabs, b.lp.slabs
    return len(sa) == len(sb) and all(
        x.source_ids is y.source_ids and x.dest_idx is y.dest_idx
        and x.mask is y.mask for x, y in zip(sa, sb))


class _Serving(NamedTuple):
    """One coherent serving state: the objective, its duals, and the
    routing tables derived from the objective.  Immutable — a swap builds
    a complete replacement and publishes it with one assignment, so a
    concurrent query never pairs a new λ with old routes (or vice versa).
    """

    obj: Any
    lam: torch.Tensor
    routes: _Routes


class AllocationServer:
    """Microbatch allocation server over a solved objective (module doc).

    obj      any objective exposing `primal_rows` (MatchingObjective and
             subclasses, compiled formulations); served on its device;
    lam      the converged dual vector (copied onto the device; the server
             owns its copy from here on);
    gamma    the γ the duals were solved at (decisions are x*_γ(λ));
    config   optional SolveConfig used by `warm_resolve` (its continuation
             fields are stripped there);
    max_batch  per-slab microbatch cap — longer queries are chunked.
    """

    def __init__(self, obj, lam, gamma, config: Optional[SolveConfig] = None,
                 max_batch: int = 256, retry_backoff_s: float = 1.0,
                 max_backoff_s: float = 60.0,
                 telemetry: Optional[Telemetry] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.device = obj.lp.b.device
        cuda = self.device.type == "cuda"
        # queries at the high priority: their few blocks go ahead of a
        # re-solve's waiting ones when both streams have kernels ready
        self._query_stream = (torch.cuda.Stream(self.device, priority=-1)
                              if cuda else None)
        self._resolve_stream = (torch.cuda.Stream(self.device) if cuda
                                else None)
        t0 = time.perf_counter()
        self._serving = _Serving(obj=obj, lam=self._own(lam),
                                 routes=_build_routes(obj))
        self.snapshot_build_s = time.perf_counter() - t0
        self.gamma = torch.as_tensor(gamma, dtype=torch.float32,
                                     device=self.device)
        self._published()
        self.config = config
        self.max_batch = int(max_batch)
        self.telemetry = (telemetry if telemetry is not None
                          else Telemetry.disabled())
        self._stats_lock = threading.Lock()
        self._resolve_lock = threading.Lock()
        # the scrapeable plane (DESIGN.md §13): counters and the shared
        # latency histogram live in a MetricsRegistry — private per server
        # by default, so co-resident servers/tests never merge series;
        # pass one registry explicitly to aggregate (the frontend reuses
        # the server's so one /metrics endpoint covers both)
        self.registry = registry if registry is not None else MetricsRegistry()
        self._lat_hist = self.registry.histogram(
            "repro_server_query_latency_seconds",
            "Microbatch query wall-clock latency (routing + device "
            "compute + readback).", buckets=DEFAULT_LATENCY_BUCKETS)
        # `stats()` windows are snapshot deltas against this mark — the
        # scraped series stays lifetime-monotonic across reset_stats()
        self._lat_mark = self._lat_hist.snapshot()
        self._sources_served = 0
        # lifetime-monotonic counters (metrics_snapshot): unlike the
        # latency window, these survive reset_stats()
        self._c_queries = self.registry.counter(
            "repro_server_queries_total", "Microbatch queries served.")
        self._c_sources = self.registry.counter(
            "repro_server_sources_total", "Sources served across queries.")
        self._c_resolves = self.registry.counter(
            "repro_server_resolves_total",
            "warm_resolve outcomes by class.", labels=("outcome",))
        self._c_warmup = self.registry.counter(
            "repro_server_warmup_kernels_total",
            "Query kernels compiled by warmup passes.")
        self.registry.gauge(
            "repro_server_degraded",
            "1 while serving a last-good λ after a failed refresh."
        ).set_function(lambda: 1.0 if self._consec_failures > 0 else 0.0)
        self.registry.gauge(
            "repro_server_consecutive_failures",
            "Current warm_resolve failure streak."
        ).set_function(lambda: float(self._consec_failures))
        self.registry.gauge(
            "repro_server_resolve_staleness_seconds",
            "Seconds since the served λ last refreshed successfully."
        ).set_function(
            lambda: time.monotonic() - self._last_good_update)
        # degraded-mode bookkeeping: failed warm_resolves never disturb the
        # served (obj, λ) pair; retries are gated by exponential backoff
        self.retry_backoff_s = float(retry_backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self._resolve_failures = 0
        self._consec_failures = 0
        self._last_good_update = time.monotonic()
        self._next_retry_at = 0.0
        self.last_failure_reason: Optional[str] = None

    # -- device plumbing ----------------------------------------------------
    def _own(self, lam) -> torch.Tensor:
        """The server's own copy of a dual vector, on its device."""
        return torch.as_tensor(lam, device=self.device).clone()

    def _published(self) -> None:
        """Wait for the calling thread's stream, on which the caller made
        what is about to be (or was just) published: the query and
        resolve streams read it without waiting for that stream."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    @staticmethod
    def _on(stream):
        return (torch.cuda.stream(stream) if stream is not None
                else contextlib.nullcontext())

    # the served pair is read-only through these properties: all writes go
    # through a whole-snapshot replacement (module doc)
    @property
    def obj(self):
        return self._serving.obj

    @property
    def lam(self):
        return self._serving.lam

    def source_ids(self) -> np.ndarray:
        """All servable source ids, sorted — the public routing surface
        (callers must not depend on the private routing layout)."""
        return self._serving.routes.ids.copy()

    def unknown_sources(self, source_ids: Sequence[int]) -> List[int]:
        """The subset of `source_ids` this server cannot route — the
        admission-time 404 check of the serving frontend (which must
        classify unknown ids ERROR instead of letting a batch blow up)."""
        q, found = self._serving.routes.find(source_ids)
        return [int(s) for s in q[~found]]

    def warmup(self) -> int:
        """Run every (slab, microbatch-length) query shape once.

        Cold-start control: the first query otherwise pays the kernels'
        build and the allocator's first blocks in its latency.  Batch
        lengths are padded to powers of two capped at `max_batch`, so the
        set is small and enumerable.  Returns the number of shapes run
        (the reference's count of compiled kernels).
        """
        with self._on(self._query_stream):
            return self._warmup_serving(self._serving)

    def _warmup_serving(self, srv: _Serving) -> int:
        """Warm every query shape of one serving snapshot (the public
        `warmup()` and the pre-publish warm of a resolve that swaps
        objectives), on the calling thread's current stream."""
        ran = 0
        for si, slab in enumerate(srv.obj.lp.slabs):
            length = _pad_pow2(1)
            cap = min(_pad_pow2(self.max_batch), _pad_pow2(slab.n))
            while True:
                rows_to_host(srv.obj.primal_rows(
                    srv.lam, self.gamma, si,
                    torch.zeros(length, dtype=torch.long,
                                device=self.device)))
                ran += 1
                if length >= cap:
                    break
                length *= 2
        self._c_warmup.inc(ran)
        return ran

    def query(self, source_ids: Sequence[int]) -> Dict[int, DecisionRow]:
        """Serve one microbatch: decisions for each requested source.

        Unknown source ids raise KeyError before any device work (a
        serving 404).  Latency of the whole batch — routing, device
        compute, readback — is recorded for `stats()`.

        Safe to call concurrently with `warm_resolve`/`update_duals`: the
        serving snapshot is bound ONCE here, so every row of this query
        is computed from one coherent (obj, λ, routes) triple even if a
        swap lands mid-query (module doc).
        """
        t0 = time.perf_counter()
        srv = self._serving
        out: Dict[int, DecisionRow] = {}
        with self.telemetry.span("query", sources=len(source_ids)), \
                self._on(self._query_stream):
            ids, slabs, rows = srv.routes.lookup(source_ids)  # KeyError
            ids = ids.tolist()
            for si in dict.fromkeys(slabs.tolist()):     # first-seen order
                sel = np.nonzero(slabs == si)[0]
                for lo in range(0, len(sel), self.max_batch):
                    chunk = sel[lo:lo + self.max_batch]
                    padded = np.zeros(_pad_pow2(len(chunk)), np.int64)
                    padded[:len(chunk)] = rows[chunk]
                    x = rows_to_host(srv.obj.primal_rows(
                        srv.lam, self.gamma, si,
                        torch.from_numpy(padded).to(self.device)))
                    for k, j in enumerate(chunk):
                        row = int(rows[j])
                        out[ids[j]] = DecisionRow(
                            source_id=ids[j], slab_index=si, row=row,
                            dest_idx=srv.routes.dest[si][row],
                            mask=srv.routes.mask[si][row], x=x[k])
        dt = time.perf_counter() - t0
        self._lat_hist.observe(dt)
        self._c_queries.inc()
        self._c_sources.inc(len(out))
        with self._stats_lock:
            self._sources_served += len(out)
        return out

    def stats(self) -> QueryStats:
        with self._stats_lock:
            window = self._lat_hist.snapshot() - self._lat_mark
            sources = self._sources_served
        health = dict(
            resolve_failures=self._resolve_failures,
            consecutive_failures=self._consec_failures,
            staleness_s=time.monotonic() - self._last_good_update,
            degraded=self._consec_failures > 0)
        if not window.count:
            return QueryStats(0, 0, 0.0, 0.0, 0.0, 0.0, **health)
        total = window.sum
        return QueryStats(
            queries=window.count, sources=sources,
            mean_ms=window.mean * 1e3,
            p50_ms=window.quantile(0.50) * 1e3,
            p95_ms=window.quantile(0.95) * 1e3,
            sources_per_s=sources / total if total else 0.0,
            **health)

    def reset_stats(self):
        """Start a fresh `stats()` window.  The scraped histogram series
        is NOT reset — windows are snapshot deltas, so the /metrics plane
        stays lifetime-monotonic (DESIGN.md §13)."""
        with self._stats_lock:
            self._lat_mark = self._lat_hist.snapshot()
            self._sources_served = 0

    def metrics_snapshot(self) -> Dict[str, float]:
        """Lifetime-monotonic counters plus point-in-time gauges.

        Unlike `stats()` (whose window `reset_stats()` clears), the
        `*_total` counters here only ever increase over the server's
        lifetime — a scrape target must never see a counter go backwards.
        Gauges (`degraded`, `staleness_s`, `consecutive_failures`) carry
        the current health surface of DESIGN.md §9.
        """
        snap: Dict[str, float] = {
            "queries_total": int(self._c_queries.value),
            "sources_total": int(self._c_sources.value),
            "warmup_kernels_total": int(self._c_warmup.value),
        }
        for outcome in ("attempts", "failures", "successes", "skipped"):
            snap[f"resolve_{outcome}_total"] = int(
                self._c_resolves.labels(outcome=outcome).value)
        snap["degraded"] = 1 if self._consec_failures > 0 else 0
        snap["consecutive_failures"] = self._consec_failures
        snap["staleness_s"] = time.monotonic() - self._last_good_update
        return snap

    def update_duals(self, lam):
        """Swap in a new dual vector (e.g. replicated from a re-solve).
        Published as a whole-snapshot replacement over the same routes: a
        concurrent query sees the old λ or the new λ, never anything in
        between."""
        lam = self._own(lam)
        if tuple(lam.shape) != tuple(self.obj.dual_shape):
            raise ValueError(
                f"dual shape {tuple(lam.shape)} != objective's "
                f"{tuple(self.obj.dual_shape)}")
        self._published()
        self._serving = self._serving._replace(lam=lam)

    def _record_failure(self, reason: str) -> None:
        """A warm_resolve failed: count it, schedule the next retry with
        exponential backoff, leave the served (obj, λ) pair untouched."""
        self._resolve_failures += 1
        self._consec_failures += 1
        self.last_failure_reason = reason
        backoff = min(self.retry_backoff_s * 2.0 ** (self._consec_failures
                                                     - 1),
                      self.max_backoff_s)
        self._next_retry_at = time.monotonic() + backoff
        self._c_resolves.labels(outcome="failures").inc()
        self.telemetry.event("resolve", outcome="reject", reason=reason,
                             consecutive_failures=self._consec_failures,
                             backoff_s=backoff)
        return None

    def warm_resolve(self, criteria: Optional[StoppingCriteria] = None,
                     obj=None, config: Optional[SolveConfig] = None,
                     require_certificate: bool = False,
                     force: bool = False) -> Optional[SolveResult]:
        """Incremental re-solve from the resident λ on an instance update.

        `obj` replaces the served objective (same dual shape — an rhs /
        budget-cap nudge, not a topology change).  γ-continuation is
        stripped from the config unconditionally: a warm start must NOT
        re-run the schedule (it would forfeit the head start).

        Degraded mode (DESIGN.md §9): a failed re-solve — an exception, a
        diverged solve, non-finite duals, or (with `require_certificate`)
        an invalid gap certificate — NEVER disturbs what is being served.
        The server keeps answering from the last-good (obj, λ) pair,
        records the failure (`stats().resolve_failures` / `.degraded` /
        `.staleness_s`, `last_failure_reason`), and gates the next attempt
        behind exponential backoff (retry_backoff_s · 2^k, capped at
        max_backoff_s; `force=True` bypasses the gate).  Returns the
        SolveResult on success, None on failure or while backoff-gated.
        The (obj, λ) swap is atomic: both change together, after every
        acceptance check has passed.

        A dual-shape mismatch on `obj` still raises ValueError — that is
        a caller bug (topology change), not a transient fault.

        Concurrency: at most one resolve runs at a time — a second call
        while one is in flight is classified skipped (reason
        `in_flight`).  The query path never waits on this lock, nor on the
        re-solve's kernels (they run on the resolve stream); it keeps
        reading the published snapshot throughout.
        """
        if obj is not None and (tuple(obj.dual_shape)
                                != tuple(self.obj.dual_shape)):
            raise ValueError(
                f"replacement objective dual shape "
                f"{tuple(obj.dual_shape)} != served "
                f"{tuple(self.obj.dual_shape)}")
        if not self._resolve_lock.acquire(blocking=False):
            self._c_resolves.labels(outcome="skipped").inc()
            self.telemetry.event("resolve", outcome="skipped",
                                 reason="in_flight")
            return None
        try:
            if obj is not None:
                self._published()   # the caller made `obj` on its stream
            with self._on(self._resolve_stream):
                return self._resolve_locked(criteria, obj, config,
                                            require_certificate, force)
        finally:
            self._resolve_lock.release()

    def _resolve_locked(self, criteria, obj, config, require_certificate,
                        force) -> Optional[SolveResult]:
        if not force and time.monotonic() < self._next_retry_at:
            self._c_resolves.labels(outcome="skipped").inc()
            self.telemetry.event("resolve", outcome="skipped",
                                 reason="backoff")
            return None
        self._c_resolves.labels(outcome="attempts").inc()
        swapped = obj is not None
        current = self._serving
        target = obj if swapped else current.obj
        cfg = config or self.config or SolveConfig()
        cfg = dataclasses.replace(cfg, gamma_init=None,
                                  adaptive_continuation=False)
        try:
            res = Maximizer(cfg).maximize(target, initial_value=current.lam,
                                          criteria=criteria)
            # the publish point: the re-solve's stream has finished λ
            self._published()
        except Exception as e:
            return self._record_failure(
                f"re-solve raised {type(e).__name__}: {e}")
        if res.stop_reason == StopReason.DIVERGED:
            return self._record_failure("re-solve diverged")
        if not bool(torch.isfinite(res.lam).all()):
            return self._record_failure("re-solve returned non-finite duals")
        if require_certificate:
            from .certify import certify as _certify
            try:
                cert = _certify(target, res.lam, self.gamma)
            except Exception as e:
                return self._record_failure(
                    f"certification raised {type(e).__name__}: {e}")
            if not cert.valid:
                return self._record_failure(
                    "re-solved duals failed certification")
        # success: build the complete replacement snapshot — routes
        # included, reused when the slabs are the same tensors — then
        # publish it with ONE assignment, so a query racing this swap
        # binds either the old or the new (obj, λ) pair
        routes = (current.routes if not swapped
                  or _same_slabs(target, current.obj)
                  else _build_routes(target))
        serving = _Serving(obj=target, lam=res.lam, routes=routes)
        if swapped:
            # run the new objective's query shapes in THIS thread before
            # publishing, so post-swap queries pay no first-call cost
            self._warmup_serving(serving)
        self._serving = serving
        self._consec_failures = 0
        self._next_retry_at = 0.0
        self._last_good_update = time.monotonic()
        self._c_resolves.labels(outcome="successes").inc()
        self.telemetry.event("resolve", outcome="accept",
                             iterations=int(res.iterations_run),
                             stop_reason=str(res.stop_reason.name),
                             swapped_objective=swapped)
        return res
