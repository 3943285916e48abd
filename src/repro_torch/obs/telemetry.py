"""Telemetry — the structured run-log recorder (DESIGN.md §11); port of
`repro.obs.telemetry`, the same records, with a torch environment stamp.

One `Telemetry` instance accompanies one run (a solve, a serving session,
a benchmark row).  It records four kinds of signal:

  * events    — typed dict records appended to the sink as JSON lines
                (`event("check", it=..., ...)`); the schema lives in
                `obs/schema.py` and every record is validated on read;
  * spans     — nestable wall-clock sections (`with tel.span("compile")`),
                emitted as `span` events carrying the slash-joined nesting
                path and the duration;
  * counters / gauges — in-memory monotonic counts and last-value gauges,
                readable any time via `metrics_snapshot()` and flushed as
                one `counters` record by `close()`;
  * logs      — a leveled console logger (`tel.info(...)`) whose lines are
                *also* emitted to the sink as `log` events, so the run log
                carries exactly what the operator saw.

The sink is pluggable: `JsonlSink` appends one JSON object per line and
flushes per record (a killed process loses at most the record in flight);
`ListSink` keeps parsed dicts in memory for tests.  A sink-less Telemetry
is a console logger + metrics registry (events are dropped).

`Telemetry.disabled()` returns the no-op singleton — the default of the
allocation server and its frontend, so a path with no telemetry attached
does no work for it.

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

import json
import math
import os
import sys
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, TextIO

import torch

__all__ = ["Telemetry", "JsonlSink", "ListSink", "LEVELS"]

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

    def close(self) -> None:
        pass


class _Span:
    """One nestable wall-clock section; emitted as a `span` event on exit."""

    __slots__ = ("_tel", "name", "path", "fields", "t0")

    def __init__(self, tel: "Telemetry", name: str, fields: Dict[str, Any]):
        self._tel = tel
        self.name = name
        self.fields = fields
        self.path = ""
        self.t0 = 0.0

    def __enter__(self) -> "_Span":
        tel = self._tel
        tel._stack.append(self.name)
        self.path = "/".join(tel._stack)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        dur = time.perf_counter() - self.t0
        tel = self._tel
        if tel._stack and tel._stack[-1] == self.name:
            tel._stack.pop()
        tel._emit({"type": "span", "name": self.name, "path": self.path,
                   "dur_s": dur, **self.fields})


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
        self._t0 = time.perf_counter()
        self._lock = threading.RLock()
        self._tls = threading.local()
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
    @property
    def _stack(self) -> List[str]:
        """Per-thread span stack: concurrent spans on different threads
        each see their own nesting path (a shared list would splice one
        thread's span names into another's slash path)."""
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _emit(self, record: Dict[str, Any]) -> None:
        record.setdefault("t", time.perf_counter() - self._t0)
        safe = _json_safe(record)
        with self._lock:
            if self._sink is None or self._closed:
                return
            self._sink.write(safe)

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

    def counter(self, name, n=1):
        return 0

    def gauge(self, name, value):
        pass

    def log(self, level, msg):
        pass

    def close(self):
        pass


_DISABLED = _DisabledTelemetry()
