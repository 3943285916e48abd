"""Telemetry — the structured run-log recorder (DESIGN.md §11); port of
`repro.obs.telemetry`, the same records, with a torch environment stamp.

One `Telemetry` instance accompanies one run (a solve, a serving session,
a benchmark row).  It records four kinds of signal:

  * events    — typed dict records appended to the sink as JSON lines
                (`event("check", it=..., ...)`); the schema lives in
                `obs/schema.py` and every record is validated on read;
  * spans     — nestable wall-clock sections (`with tel.span("compile")`),
                emitted as `span` events carrying the slash-joined nesting
                path, the duration, an integer `id`, the `parent` id of
                the span open around it (None at the root), its
                `start_ns` / `end_ns` on the unix clock torch.profiler
                records host events on, and the `solve` sequence number
                of the solve span it lies in (`next_solve`; null outside
                one);
  * counters / gauges — in-memory monotonic counts and last-value gauges,
                readable any time via `metrics_snapshot()` and flushed as
                one `counters` record by `close()`;
  * logs      — a leveled console logger (`tel.info(...)`) whose lines are
                *also* emitted to the sink as `log` events, so the run log
                carries exactly what the operator saw.

The sink is pluggable: `JsonlSink` appends one JSON object per line and
flushes per record (a killed process loses at most the record in flight,
and the spans closed since the last other record: closed spans are kept
as plain tuples and written, in order, when a thread's outermost span
closes or before the next record of another type);
`ListSink` keeps parsed dicts in memory for tests.  A sink-less Telemetry
is a console logger + metrics registry (events are dropped).

`Telemetry.disabled()` returns the no-op singleton — the default of the
allocation server and its frontend, so a path with no telemetry attached
does no work for it.

`with tel.activate():` makes a recorder this thread's current one and
`current()` returns it (the disabled singleton when none is active):
layers that are never handed a recorder — the objective's constructor,
the preconditioning, the kernel wrappers — record their spans through it.

The clock: each Telemetry takes one anchor pair, `time.time_ns()` and
`time.perf_counter_ns()` read back to back, and maps every span's
perf_counter readings onto the unix nanoseconds that kineto stamps host
events with, so a span can be laid beside a profiler trace.

All records are JSON-sanitized at emission: non-finite floats become
null (a NaN dual objective from a diverging run must not produce an
invalid JSON line), numpy scalars and 0-d tensors become Python numbers,
and unknown objects are stringified.

The manifest stamps the environment as `torch_version`, `cuda_version`
(None on a build without CUDA), `platform` ("cuda" when a card is
visible, else "cpu") and `device_count`.

Thread safety (DESIGN.md §12): one Telemetry may be shared by the serving
frontend's dispatch thread, a background warm_resolve thread, and any
number of client threads.  Record emission, counters/gauges, and close()
are serialized by an internal lock (a JsonlSink additionally locks its
own write+flush, so even a sink shared across recorders never interleaves
half-written lines), and the span stack is *thread-local*: concurrent
spans on different threads each keep a well-formed nesting path instead
of splicing into each other's.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import math
import os
import sys
import threading
import time
import uuid
from typing import Any, Deque, Dict, List, Optional, TextIO

import torch

__all__ = ["Telemetry", "JsonlSink", "ListSink", "LEVELS", "current",
           "spanned"]

LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}


def _json_safe(v: Any) -> Any:
    """Recursively coerce a value into strictly-valid JSON.

    Non-finite floats map to None (json.dumps would otherwise emit the
    non-standard NaN/Infinity literals), mappings/sequences recurse, and
    anything else unserializable is stringified (dtypes, enums, paths).
    """
    if v is None or isinstance(v, (bool, int, str)):
        return v
    if isinstance(v, float):
        return v if math.isfinite(v) else None
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    # numpy scalars and 0-d tensors expose item(); arrays, whose item()
    # raises past one element, expose tolist()
    for attr in ("item", "tolist"):
        fn = getattr(v, attr, None)
        if fn is not None:
            try:
                return _json_safe(fn())
            except (ValueError, RuntimeError):
                continue
    return str(v)


class JsonlSink:
    """Append-only JSONL file sink; one flushed line per record.

    Thread-safe: the serialize+write+flush of each record runs under a
    lock, so two threads can never interleave half-written lines."""

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._lock = threading.Lock()
        self._f: Optional[TextIO] = open(path, "a")

    def write(self, record: Dict[str, Any]) -> None:
        with self._lock:
            if self._f is None:
                return
            self._f.write(json.dumps(record, separators=(",", ":")) + "\n")
            self._f.flush()

    def write_many(self, records: List[Dict[str, Any]]) -> None:
        with self._lock:
            if self._f is None:
                return
            self._f.write("".join(json.dumps(r, separators=(",", ":"))
                                  + "\n" for r in records))
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


class ListSink:
    """In-memory sink for tests: records end up as parsed dicts."""

    def __init__(self):
        self.records: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    def write(self, record: Dict[str, Any]) -> None:
        with self._lock:
            self.records.append(record)

    def write_many(self, records: List[Dict[str, Any]]) -> None:
        with self._lock:
            self.records.extend(records)

    def close(self) -> None:
        pass


class _Span:
    """One nestable wall-clock section; emitted as a `span` event on exit.
    A span given a `solve` field passes it to every span opened inside
    it on the same thread."""

    __slots__ = ("_tel", "name", "path", "fields", "t0", "id", "parent",
                 "solve", "_stack")

    def __init__(self, tel: "Telemetry", name: str, fields: Dict[str, Any]):
        self._tel = tel
        self.name = name
        self.fields = fields

    def __enter__(self) -> "_Span":
        tel = self._tel
        self._stack = stack = tel._tls.stack
        self.id = next(tel._ids)
        if stack:
            top = stack[-1]
            self.path = top.path + "/" + self.name
            self.parent = top.id
            self.solve = (self.fields.get("solve", top.solve)
                          if self.fields else top.solve)
        else:
            self.path, self.parent = self.name, None
            self.solve = self.fields.get("solve")
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = time.perf_counter_ns()
        stack = self._stack
        if stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        # plain values, made a record when the spans are flushed
        tel = self._tel
        tel._spans.append((self.name, self.path, self.id, self.parent,
                           self.solve, self.t0, t1,
                           _json_safe(self.fields) if self.fields
                           else self.fields))
        if not stack:
            tel._flush()


class _SpanStack(threading.local):
    """Each thread's stack of open spans."""

    def __init__(self):
        self.stack: List[_Span] = []


class _NullSpan:
    """Reusable no-op context manager for the disabled singleton."""

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None


_NULL_SPAN = _NullSpan()


class Telemetry:
    """The run recorder (module doc).  Construct with a sink to persist a
    run log, without one for a console logger + metrics registry, or use
    `Telemetry.disabled()` for the zero-cost default."""

    enabled = True

    def __init__(self, sink=None, level: str = "info",
                 stream: Optional[TextIO] = None,
                 run_id: Optional[str] = None):
        self._sink = sink
        self._level = LEVELS.get(level, LEVELS["info"])
        self._stream = stream if stream is not None else sys.stdout
        self._t0_ns = time.perf_counter_ns()
        self._t0 = self._t0_ns * 1e-9
        # the anchor pair: perf_counter_ns + _unix_ns is unix ns
        unix, perf = time.time_ns(), time.perf_counter_ns()
        self._unix_ns = unix - perf
        self._ids = itertools.count()
        self._solves = itertools.count()
        # the records of closed spans not yet written, appended without a
        # lock: deque appends and pops are atomic
        self._spans: Deque[tuple] = collections.deque()
        self._lock = threading.RLock()
        self._tls = _SpanStack()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._closed = False
        self._manifest: Dict[str, Any] = {
            "run_id": run_id or uuid.uuid4().hex[:12],
            "created_unix": time.time(),
            "schema_version": 1,
        }
        cuda = torch.cuda.is_available()
        self._manifest.update(
            torch_version=torch.__version__, cuda_version=torch.version.cuda,
            platform="cuda" if cuda else "cpu",
            device_count=torch.cuda.device_count() if cuda else 0)

    # -- classmethod constructors ---------------------------------------
    @classmethod
    def disabled(cls) -> "Telemetry":
        return _DISABLED

    @classmethod
    def jsonl(cls, path: str, **kw) -> "Telemetry":
        return cls(sink=JsonlSink(path), **kw)

    @property
    def run_id(self) -> str:
        return self._manifest["run_id"]

    # -- record plumbing -------------------------------------------------
    def _emit(self, record: Dict[str, Any]) -> None:
        record.setdefault("t", time.perf_counter() - self._t0)
        safe = _json_safe(record)
        with self._lock:
            self._flush()
            if self._sink is None or self._closed:
                return
            self._sink.write(safe)

    def _flush(self) -> None:
        """Write the closed spans' records, in the order they closed.  Runs
        when a thread's outermost span closes and before any other
        record, so the sink holds the records in the order they happened;
        a killed process loses the spans closed since the last record."""
        spans = self._spans
        if not spans:
            return
        unix, t0 = self._unix_ns, self._t0_ns
        with self._lock:
            batch = [spans.popleft() for _ in range(len(spans))]
            if self._sink is None or self._closed:
                return
            records = [{"type": "span", "name": name, "path": path,
                        "dur_s": (e - b) * 1e-9, "id": sid, "parent": parent,
                        "start_ns": b + unix, "end_ns": e + unix,
                        "solve": solve, "t": (e - t0) * 1e-9, **fields}
                       for name, path, sid, parent, solve, b, e, fields
                       in batch]
            write_many = getattr(self._sink, "write_many", None)
            if write_many is not None:
                write_many(records)
            else:
                for rec in records:
                    self._sink.write(rec)

    def event(self, etype: str, **fields) -> None:
        """Emit one typed record to the sink (obs/schema.py names the
        required fields per type; use type "event" for ad-hoc payloads)."""
        self._emit({"type": etype, **fields})

    def manifest(self, **fields) -> None:
        """Merge fields into the run manifest and (re-)emit it.

        The baseline (run_id, torch and CUDA versions, platform, device
        count) is
        stamped at construction; callers layer on what they know —
        instance fingerprint, formulation, algorithm, γ schedule, config,
        byte census.  Re-calling merges, so the latest manifest record in
        a log is always the most complete one.
        """
        with self._lock:
            self._manifest.update(fields)
            merged = dict(self._manifest)
        self._emit({"type": "manifest", **merged})

    def span(self, name: str, **fields):
        """`with tel.span("compile"): ...` — nested spans join their names
        into a slash path ("solve/chunk/compile") on the emitted record."""
        return _Span(self, name, fields)

    def next_solve(self) -> int:
        """The next solve's sequence number (0, 1, ... a recorder)."""
        return next(self._solves)

    @contextlib.contextmanager
    def activate(self):
        """Make this recorder the thread's `current()` one for the body."""
        prev = _CURRENT.tel
        _CURRENT.tel = self
        try:
            yield self
        finally:
            _CURRENT.tel = prev

    # -- metrics ----------------------------------------------------------
    def counter(self, name: str, n: int = 1) -> int:
        """Bump a monotonic counter; returns the new value.  Thread-safe:
        the read-modify-write is atomic under the recorder's lock."""
        with self._lock:
            v = self._counters.get(name, 0) + int(n)
            self._counters[name] = v
        return v

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def metrics_snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges)}

    # -- leveled console logging -----------------------------------------
    def log(self, level: str, msg: str) -> None:
        """Print `msg` when `level` clears the threshold, and mirror it
        into the sink as a `log` event either way — the run log carries
        the full stream even when the console is quiet."""
        self._emit({"type": "log", "level": level, "msg": msg})
        if LEVELS.get(level, LEVELS["info"]) >= self._level:
            print(msg, file=self._stream, flush=True)

    def debug(self, msg: str) -> None:
        self.log("debug", msg)

    def info(self, msg: str) -> None:
        self.log("info", msg)

    def warning(self, msg: str) -> None:
        self.log("warning", msg)

    def error(self, msg: str) -> None:
        self.log("error", msg)

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Flush the aggregated metrics as one `counters` record and close
        the sink.  Idempotent (and thread-safe: the RLock lets the nested
        `_emit` re-enter while excluding concurrent closers)."""
        with self._lock:
            if self._closed:
                return
            self._emit({"type": "counters",
                        "counters": dict(self._counters),
                        "gauges": dict(self._gauges)})
            self._closed = True
            if self._sink is not None:
                self._sink.close()


class _DisabledTelemetry(Telemetry):
    """Zero-cost no-op: every method returns immediately.  The engine and
    server default to this, keeping the untelemetered path identical to
    the pre-telemetry code."""

    enabled = False

    def __init__(self):  # no baseline stamp, no uuid, no clocks
        self._counters = {}
        self._gauges = {}
        self._manifest = {"run_id": "disabled"}
        self._lock = threading.RLock()  # metrics_snapshot is inherited

    def _emit(self, record):
        pass

    def event(self, etype, **fields):
        pass

    def manifest(self, **fields):
        pass

    def span(self, name, **fields):
        return _NULL_SPAN

    def next_solve(self):
        return 0

    def counter(self, name, n=1):
        return 0

    def gauge(self, name, value):
        pass

    def log(self, level, msg):
        pass

    def close(self):
        pass


_DISABLED = _DisabledTelemetry()


class _Current(threading.local):
    """Each thread's active recorder; the disabled singleton until one is
    activated."""

    tel: Telemetry = _DISABLED


_CURRENT = _Current()


def current() -> Telemetry:
    """This thread's active recorder (`Telemetry.activate`), or the
    disabled singleton."""
    return _CURRENT.tel


def spanned(name: str, **fields):
    """Decorator: each call of the function runs in a span `name` (with
    `fields`) of the thread's active recorder, and with none active runs
    as it is, at the cost of one lookup.  For a function that opens no
    span itself: the span is recorded as a leaf, the child of the span
    open around the call."""
    fields = _json_safe(fields)

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            tel = _CURRENT.tel
            if not tel.enabled:
                return fn(*args, **kw)
            t0 = time.perf_counter_ns()
            try:
                return fn(*args, **kw)
            finally:
                t1 = time.perf_counter_ns()
                stack = tel._tls.stack
                if stack:
                    top = stack[-1]
                    tel._spans.append((name, top.path + "/" + name,
                                       next(tel._ids), top.id, top.solve,
                                       t0, t1, fields))
                else:
                    tel._spans.append((name, name, next(tel._ids), None,
                                       None, t0, t1, fields))
                    tel._flush()
        return call
    return wrap
