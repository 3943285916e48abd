"""Process-wide metrics plane: registry, Prometheus exposition, exporter.

DESIGN.md §13; port of `repro.obs.metrics` (pure Python, the same series
names, exposition and quantile math).  The telemetry layer (§11) records a post-mortem JSONL
stream; this module is the *live* side — counters, gauges, and
fixed-bucket histograms an operator can scrape over HTTP while a drill
or a solve is in flight.

Three collector kinds, Prometheus semantics throughout:

  Counter    monotonically non-decreasing (``_total`` suffix by
             convention); never rewinds, never resets on scrape.
  Gauge      a point-in-time value; ``set_function`` binds a callable
             evaluated at render time (queue depth, staleness, RSS).
  Histogram  fixed buckets, cumulative ``le`` rendering with ``+Inf``,
             plus ``_sum``/``_count`` series.  Observations are
             lifetime-monotonic; windowed views (a server's
             ``stats()``) are snapshot deltas, never resets.

``HistogramSnapshot`` is the one quantile implementation in the repo:
``QueryStats``/``FrontendStats`` percentiles and benchmark-reported
quantiles all route through ``HistogramSnapshot.quantile`` so the math
cannot skew between surfaces.

``MetricsRegistry.counter/gauge/histogram`` are get-or-create: asking
for an existing name with the same kind returns the existing collector
(so two components can share a family), and a kind or label mismatch
raises.  ``render()`` emits Prometheus text format 0.0.4;
``parse_exposition`` is the strict reader used by tests and the CI
scrape step (HELP/TYPE presence, bucket monotonicity, ``_count``
consistency).

``MetricsExporter`` serves ``GET /metrics`` from a daemon thread on a
stdlib ``http.server`` — opt-in via ``FrontendConfig.metrics_port``;
``port=0`` binds an ephemeral port
(read it back from ``.port``) for tests.
"""
from __future__ import annotations

import bisect
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import (Any, Callable, Dict, Iterable, List, NamedTuple,
                    Optional, Sequence, Tuple)

__all__ = [
    "Counter", "Gauge", "Histogram", "HistogramSnapshot",
    "MetricsRegistry", "MetricsExporter", "ExpositionError",
    "parse_exposition", "REGISTRY", "DEFAULT_LATENCY_BUCKETS",
]

# Log-ish spacing from 0.5 ms to 10 s: wide enough for microbatch query
# latencies (p50 ~1 ms) and end-to-end frontend latencies under overload.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(s: str) -> str:
    return (s.replace("\\", "\\\\").replace("\"", "\\\"")
            .replace("\n", "\\n"))


def _format_value(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _format_le(bound: float) -> str:
    return "+Inf" if math.isinf(bound) else _format_value(bound)


def _labels_suffix(label_names: Sequence[str],
                   label_values: Sequence[str],
                   extra: Sequence[Tuple[str, str]] = ()) -> str:
    parts = [f'{n}="{_escape_label_value(str(v))}"'
             for n, v in zip(label_names, label_values)]
    parts.extend(f'{n}="{_escape_label_value(str(v))}"' for n, v in extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Child:
    """One labeled series of a family (or the family's sole series when
    it has no labels)."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0


class _CounterChild(_Child):
    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _GaugeChild(_Child):
    __slots__ = ("_fn",)

    def __init__(self) -> None:
        super().__init__()
        self._fn: Optional[Callable[[], float]] = None

    def set(self, v: float) -> None:
        with self._lock:
            self._fn = None
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    def set_function(self, fn: Callable[[], float]) -> None:
        """Evaluate `fn` at render time instead of storing a value."""
        with self._lock:
            self._fn = fn

    @property
    def value(self) -> float:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:
            return float(fn())
        except Exception:
            return float("nan")


class HistogramSnapshot(NamedTuple):
    """Immutable histogram state: per-bucket (non-cumulative) counts
    aligned with `bounds` (which always ends with +Inf), plus sum/count.

    Supports windowing by subtraction (`now - mark`) — the scrape-facing
    series stay lifetime-monotonic while `stats()`-style windows are
    computed as deltas — and `quantile()` with linear interpolation
    inside the landing bucket.  This is the repo's one quantile
    implementation (DESIGN.md §13).
    """

    bounds: Tuple[float, ...]
    counts: Tuple[int, ...]
    sum: float
    count: int

    def __sub__(self, other: "HistogramSnapshot") -> "HistogramSnapshot":
        if other.bounds != self.bounds:
            raise ValueError("snapshot bucket bounds differ")
        return HistogramSnapshot(
            self.bounds,
            tuple(a - b for a, b in zip(self.counts, other.counts)),
            self.sum - other.sum, self.count - other.count)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Prometheus-style histogram_quantile: locate the bucket where
        the cumulative count crosses q*count, interpolate linearly
        within it.  Returns 0.0 on an empty window; the +Inf bucket
        clamps to the last finite bound."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count <= 0:
            return 0.0
        rank = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            prev = cum
            cum += c
            if cum >= rank and c > 0:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                if math.isinf(hi):
                    return self.bounds[i - 1] if i > 0 else 0.0
                frac = (rank - prev) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return self.bounds[-2] if len(self.bounds) > 1 else 0.0


class _HistogramChild:
    __slots__ = ("_lock", "_bounds", "_counts", "_sum", "_count")

    def __init__(self, bounds: Tuple[float, ...]) -> None:
        self._lock = threading.Lock()
        self._bounds = bounds            # ends with +Inf
        self._counts = [0] * len(bounds)
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self._bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> HistogramSnapshot:
        with self._lock:
            return HistogramSnapshot(self._bounds, tuple(self._counts),
                                     self._sum, self._count)


_KINDS = {"counter", "gauge", "histogram"}


class _Family:
    """One named metric family: kind, help text, label names, children
    keyed by label-value tuples."""

    def __init__(self, name: str, kind: str, help: str,
                 label_names: Tuple[str, ...],
                 bounds: Optional[Tuple[float, ...]] = None) -> None:
        self.name = name
        self.kind = kind
        self.help = help
        self.label_names = label_names
        self.bounds = bounds
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], Any] = {}
        if not label_names:
            self._default = self._make_child()
            self._children[()] = self._default
        else:
            self._default = None

    def _make_child(self):
        if self.kind == "counter":
            return _CounterChild()
        if self.kind == "gauge":
            return _GaugeChild()
        return _HistogramChild(self.bounds)

    def labels(self, *values: Any, **kv: Any):
        """Get-or-create the child for one label-value combination."""
        if kv:
            if values:
                raise ValueError("pass label values positionally or by "
                                 "keyword, not both")
            try:
                values = tuple(str(kv[n]) for n in self.label_names)
            except KeyError as e:
                raise ValueError(
                    f"{self.name}: missing label {e} "
                    f"(labels: {self.label_names})") from e
            if len(kv) != len(self.label_names):
                raise ValueError(
                    f"{self.name}: unexpected labels "
                    f"{sorted(set(kv) - set(self.label_names))}")
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected {len(self.label_names)} label "
                f"values {self.label_names}, got {len(values)}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._make_child()
                self._children[values] = child
            return child

    def _items(self) -> List[Tuple[Tuple[str, ...], Any]]:
        with self._lock:
            return sorted(self._children.items())

    # -- unlabeled convenience passthroughs ------------------------------
    def _sole(self):
        if self._default is None:
            raise ValueError(
                f"{self.name} has labels {self.label_names}; call "
                f".labels(...) first")
        return self._default

    def inc(self, n: float = 1.0) -> None:
        self._sole().inc(n)

    def set(self, v: float) -> None:
        self._sole().set(v)

    def dec(self, n: float = 1.0) -> None:
        self._sole().dec(n)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._sole().set_function(fn)

    def observe(self, v: float) -> None:
        self._sole().observe(v)

    @property
    def value(self) -> float:
        return self._sole().value

    def snapshot(self) -> HistogramSnapshot:
        return self._sole().snapshot()

    # -- exposition ------------------------------------------------------
    def render(self) -> str:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} {self.kind}"]
        for values, child in self._items():
            if self.kind in ("counter", "gauge"):
                lines.append(
                    f"{self.name}"
                    f"{_labels_suffix(self.label_names, values)} "
                    f"{_format_value(child.value)}")
            else:
                snap = child.snapshot()
                cum = 0
                for bound, c in zip(snap.bounds, snap.counts):
                    cum += c
                    suffix = _labels_suffix(
                        self.label_names, values,
                        extra=[("le", _format_le(bound))])
                    lines.append(f"{self.name}_bucket{suffix} {cum}")
                base = _labels_suffix(self.label_names, values)
                lines.append(f"{self.name}_sum{base} "
                             f"{_format_value(snap.sum)}")
                lines.append(f"{self.name}_count{base} {snap.count}")
        return "\n".join(lines) + "\n"

    def summary(self) -> Dict[str, Any]:
        """Compact JSON-able digest (for `metrics` telemetry events and
        launch/report.py rendering)."""
        out: Dict[str, Any] = {"type": self.kind}
        series = {}
        for values, child in self._items():
            key = ",".join(f"{n}={v}" for n, v in
                           zip(self.label_names, values)) or ""
            if self.kind in ("counter", "gauge"):
                series[key] = child.value
            else:
                snap = child.snapshot()
                series[key] = {
                    "count": snap.count, "sum": snap.sum,
                    "mean": snap.mean,
                    "p50": snap.quantile(0.50),
                    "p95": snap.quantile(0.95),
                    "p99": snap.quantile(0.99),
                }
        out["series"] = series
        return out


# Public aliases — a family IS the collector users hold.
Counter = _Family
Gauge = _Family
Histogram = _Family


class MetricsRegistry:
    """Thread-safe get-or-create registry of metric families.

    Re-requesting an existing name with a matching kind (and, for
    histograms, matching buckets) returns the existing family; a
    mismatch raises ValueError.  ``render()`` serializes every family in
    registration order as Prometheus text format 0.0.4.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _get_or_create(self, name: str, kind: str, help: str,
                       labels: Sequence[str],
                       bounds: Optional[Tuple[float, ...]] = None
                       ) -> _Family:
        labels = tuple(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}, requested {kind}")
                if fam.label_names != labels:
                    raise ValueError(
                        f"metric {name!r} label mismatch: registered "
                        f"{fam.label_names}, requested {labels}")
                if kind == "histogram" and bounds != fam.bounds:
                    raise ValueError(
                        f"metric {name!r} bucket mismatch")
                return fam
            fam = _Family(name, kind, help, labels, bounds)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(name, "counter", help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(name, "gauge", help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                  labels: Sequence[str] = ()) -> Histogram:
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError("histogram needs at least one bucket")
        if not math.isinf(b[-1]):
            b = b + (float("inf"),)
        return self._get_or_create(name, "histogram", help, labels,
                                   bounds=b)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def families(self) -> List[_Family]:
        with self._lock:
            return list(self._families.values())

    def render(self) -> str:
        return "".join(f.render() for f in self.families())

    def summary(self) -> Dict[str, Any]:
        """name -> family.summary() digest for every registered family."""
        return {f.name: f.summary() for f in self.families()}


#: Process-wide default registry (the solve CLI's plane).  Servers and
#: frontends default to *private* registries so tests and co-resident
#: instances never share series; pass this explicitly to aggregate.
REGISTRY = MetricsRegistry()


class ExpositionError(ValueError):
    """Exposition text violates the format or its invariants."""


def parse_exposition(text: str) -> Dict[str, float]:
    """Strict Prometheus text-format 0.0.4 reader.

    Returns ``{series-with-labels: value}``.  Raises ExpositionError on:
    a sample line naming a family with no preceding # TYPE, a HELP/TYPE
    pair missing for a family, non-monotone cumulative ``le`` buckets, a
    ``+Inf`` bucket disagreeing with ``_count``, or an unparseable line.
    Used by tests and the CI mid-drill scrape step.
    """
    samples: Dict[str, float] = {}
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    for ln, raw in enumerate(text.splitlines(), start=1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            parts = line.split(" ", 3)
            if len(parts) < 3:
                raise ExpositionError(f"line {ln}: malformed HELP")
            helps[parts[2]] = parts[3] if len(parts) > 3 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4 or parts[3] not in _KINDS:
                raise ExpositionError(f"line {ln}: malformed TYPE: {raw!r}")
            types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        # sample line: name{labels} value  — labels may contain spaces
        # inside quoted values, so split on the last space outside braces.
        try:
            if "}" in line:
                name_part, value_part = (line[:line.rindex("}") + 1],
                                         line[line.rindex("}") + 1:])
            else:
                name_part, value_part = line.rsplit(" ", 1)
            value = float(value_part.strip().replace("+Inf", "inf")
                          .replace("-Inf", "-inf"))
        except ValueError as e:
            raise ExpositionError(f"line {ln}: bad sample: {raw!r}") from e
        base = name_part.split("{", 1)[0].strip()
        family = base
        for suffix in ("_bucket", "_sum", "_count"):
            if base.endswith(suffix) and base[:-len(suffix)] in types:
                family = base[:-len(suffix)]
                break
        if family not in types:
            raise ExpositionError(
                f"line {ln}: sample {base!r} has no preceding # TYPE")
        if family not in helps:
            raise ExpositionError(
                f"line {ln}: family {family!r} has TYPE but no HELP")
        if name_part.strip() in samples:
            raise ExpositionError(
                f"line {ln}: duplicate series {name_part.strip()!r}")
        samples[name_part.strip()] = value

    # histogram invariants: per labelset, buckets monotone non-decreasing
    # in le-order and +Inf bucket == _count.
    for family, kind in types.items():
        if kind != "histogram":
            continue
        buckets: Dict[str, List[Tuple[float, float]]] = {}
        for series, value in samples.items():
            if not series.startswith(family + "_bucket"):
                continue
            labels = series[len(family + "_bucket"):]
            if not labels.startswith("{") or 'le="' not in labels:
                raise ExpositionError(
                    f"{series!r}: histogram bucket without le label")
            le_raw = labels.split('le="', 1)[1].split('"', 1)[0]
            le = float(le_raw.replace("+Inf", "inf"))
            rest = labels.replace(f'le="{le_raw}"', "").replace(
                "{,", "{").replace(",}", "}").replace(",,", ",")
            buckets.setdefault(rest, []).append((le, value))
        for rest, pairs in buckets.items():
            pairs.sort()
            if not math.isinf(pairs[-1][0]):
                raise ExpositionError(
                    f"{family}{rest}: histogram missing +Inf bucket")
            values = [v for _, v in pairs]
            if any(b > a for a, b in zip(values[1:], values)):
                raise ExpositionError(
                    f"{family}{rest}: bucket counts not monotone: "
                    f"{values}")
            count_series = f"{family}_count{rest}".replace("{}", "")
            count = samples.get(count_series)
            if count is None:
                raise ExpositionError(
                    f"{family}{rest}: missing _count series")
            if values[-1] != count:
                raise ExpositionError(
                    f"{family}{rest}: +Inf bucket {values[-1]} != "
                    f"_count {count}")
            sum_series = f"{family}_sum{rest}".replace("{}", "")
            if sum_series not in samples:
                raise ExpositionError(
                    f"{family}{rest}: missing _sum series")
    return samples


class _MetricsHandler(BaseHTTPRequestHandler):
    registry: MetricsRegistry = REGISTRY

    def do_GET(self) -> None:  # noqa: N802 (stdlib naming)
        if self.path.split("?")[0] not in ("/metrics", "/"):
            self.send_error(404)
            return
        try:
            body = self.registry.render().encode("utf-8")
        except Exception as e:  # never kill the server thread
            self.send_error(500, str(e)[:100])
            return
        self.send_response(200)
        self.send_header("Content-Type", _CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt: str, *args: Any) -> None:
        pass  # scrapes are not operator output


class MetricsExporter:
    """Background /metrics HTTP endpoint over one registry.

    Daemon-threaded stdlib server; ``port=0`` binds an ephemeral port
    (read ``.port`` after construction).  ``close()`` shuts the listener
    down and joins the thread — idempotent, and the frontend's drain
    path calls it last so the final drill state stays scrapeable until
    drain completes (DESIGN.md §13).
    """

    def __init__(self, registry: MetricsRegistry, port: int,
                 host: str = "127.0.0.1") -> None:
        handler = type("_BoundHandler", (_MetricsHandler,),
                       {"registry": registry})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            name=f"metrics-exporter:{self.port}", daemon=True)
        self._closed = False
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._httpd.shutdown()
        self._thread.join(timeout=5.0)
        self._httpd.server_close()

    def __enter__(self) -> "MetricsExporter":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
