"""repro_torch.obs — the solver's and the server's observability
(counterpart of `repro.obs`, DESIGN.md §11 and §13).

Structured run logs (JSONL events + manifest), nestable wall-clock spans,
counters/gauges and a leveled console logger (`telemetry`, `schema`), an
opt-in torch.profiler window over a range of chunks (`profile`), the
scrapeable metrics plane with Prometheus exposition and a background
`/metrics` exporter (`metrics`), and the resource sampler (`memory`: host
RSS from procfs, the card's allocator bytes, per-runner estimates from
the launch census) whose watermarks the engine stamps into the manifest.
`Telemetry.disabled()` is the zero-cost default threaded through the
solve engine and the allocation server; `launch/report.py` renders a
post-mortem from any emitted run log.
"""
from .telemetry import JsonlSink, ListSink, Telemetry, LEVELS
from .schema import (EVENT_FIELDS, RunLog, SchemaError, iter_events,
                     load_run, validate_event, validate_run)
from .profile import ProfilerHook
from .metrics import (Counter, Gauge, Histogram, HistogramSnapshot,
                      MetricsExporter, MetricsRegistry, ExpositionError,
                      parse_exposition, REGISTRY,
                      DEFAULT_LATENCY_BUCKETS)
from .memory import (MemorySample, MemorySampler, compiled_memory_estimate,
                     device_memory_stats, host_rss_bytes,
                     host_peak_rss_bytes, register_memory_gauges)

__all__ = [
    "Telemetry", "JsonlSink", "ListSink", "LEVELS",
    "EVENT_FIELDS", "RunLog", "SchemaError", "iter_events", "load_run",
    "validate_event", "validate_run",
    "ProfilerHook",
    "Counter", "Gauge", "Histogram", "HistogramSnapshot",
    "MetricsRegistry", "MetricsExporter", "ExpositionError",
    "parse_exposition", "REGISTRY", "DEFAULT_LATENCY_BUCKETS",
    "MemorySample", "MemorySampler", "compiled_memory_estimate",
    "device_memory_stats", "host_rss_bytes", "host_peak_rss_bytes",
    "register_memory_gauges",
]
