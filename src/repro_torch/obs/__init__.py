"""repro_torch.obs — the observability pieces the serving path reads
(counterpart of `repro.obs`, DESIGN.md §11 and §13).

Structured run logs (JSONL events + manifest), nestable wall-clock spans,
counters/gauges and a leveled console logger (`telemetry`, `schema`), the
scrapeable metrics plane with Prometheus exposition and a background
`/metrics` exporter (`metrics`), and the host/device memory gauges
(`memory`).  `Telemetry.disabled()` is the zero-cost default of the
allocation server and its frontend.  The engine's telemetry,
`MemorySampler`, the profiler window and `launch/report.py` are not
ported yet (ROADMAP queue A item 14).
"""
from .telemetry import JsonlSink, ListSink, Telemetry, LEVELS
from .schema import (EVENT_FIELDS, RunLog, SchemaError, iter_events,
                     load_run, validate_event, validate_run)
from .metrics import (Counter, Gauge, Histogram, HistogramSnapshot,
                      MetricsExporter, MetricsRegistry, ExpositionError,
                      parse_exposition, REGISTRY,
                      DEFAULT_LATENCY_BUCKETS)
from .memory import (device_memory_stats, host_rss_bytes,
                     host_peak_rss_bytes, register_memory_gauges)

__all__ = [
    "Telemetry", "JsonlSink", "ListSink", "LEVELS",
    "EVENT_FIELDS", "RunLog", "SchemaError", "iter_events", "load_run",
    "validate_event", "validate_run",
    "Counter", "Gauge", "Histogram", "HistogramSnapshot",
    "MetricsRegistry", "MetricsExporter", "ExpositionError",
    "parse_exposition", "REGISTRY", "DEFAULT_LATENCY_BUCKETS",
    "device_memory_stats", "host_rss_bytes", "host_peak_rss_bytes",
    "register_memory_gauges",
]
