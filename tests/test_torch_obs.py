"""The port's observability pieces (`repro_torch.obs`: telemetry, schema,
metrics, memory gauges) against the JAX package's (`repro.obs`).

Histogram snapshots, windows and quantiles equal the reference's exactly
on the same observations (pure Python, the same arithmetic); both
packages' expositions parse with both parsers into the same series;
serving events validate under both schemas; the memory gauges read host
RSS > 0 and device 0 on the CPU; the exporter serves `/metrics` on an
ephemeral loopback port.  Every thread join has its own timeout.
"""
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro.obs import metrics as rmetrics
from repro.obs import schema as rschema
from repro_torch.obs import (DEFAULT_LATENCY_BUCKETS, EVENT_FIELDS,
                             ExpositionError, ListSink, MetricsExporter,
                             MetricsRegistry, SchemaError, Telemetry,
                             device_memory_stats, host_peak_rss_bytes,
                             host_rss_bytes, load_run, parse_exposition,
                             register_memory_gauges, validate_event)

OBS = np.random.default_rng(5).lognormal(-6.0, 1.5, size=2000).tolist()
QUANTILES = (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0)


def _fill(registry_cls, buckets):
    r = registry_cls()
    h = r.histogram("lat_seconds", "Latency.", buckets=buckets)
    mark = None
    for i, v in enumerate(OBS):
        if i == 700:
            mark = h.snapshot()
        h.observe(v)
    return h.snapshot(), mark


@pytest.mark.parametrize("buckets", [DEFAULT_LATENCY_BUCKETS,
                                     (0.001, 0.01, 0.1)],
                         ids=["default", "coarse"])
def test_histogram_snapshots_and_quantiles_equal_reference(buckets):
    assert DEFAULT_LATENCY_BUCKETS == rmetrics.DEFAULT_LATENCY_BUCKETS
    now, mark = _fill(MetricsRegistry, buckets)
    now_r, mark_r = _fill(rmetrics.MetricsRegistry, buckets)
    assert tuple(now) == tuple(now_r)
    window, window_r = now - mark, now_r - mark_r
    assert tuple(window) == tuple(window_r)
    assert window.count == len(OBS) - 700
    for q in QUANTILES:
        assert now.quantile(q) == now_r.quantile(q)
        assert window.quantile(q) == window_r.quantile(q)
    assert window.mean == window_r.mean


def _serving_registry(registry_cls):
    """A registry with the series names the server and frontend export."""
    r = registry_cls()
    r.counter("repro_server_queries_total", "Queries.").inc(7)
    c = r.counter("repro_frontend_requests_total", "Requests, by status.",
                  labels=("status",))
    for st, n in (("ok", 5), ("shed", 2), ("timeout", 1), ("error", 0)):
        c.labels(status=st).inc(n)
    c.labels(status='odd"label\\')
    r.gauge("repro_frontend_queue_depth", "Depth.").set(3)
    h = r.histogram("repro_frontend_latency_seconds", "Latency.",
                    labels=("status",))
    for v in OBS[:50]:
        h.labels(status="ok").observe(v)
    return r


def test_exposition_parses_with_both_parsers():
    text = _serving_registry(MetricsRegistry).render()
    assert text == _serving_registry(rmetrics.MetricsRegistry).render()
    ours, theirs = parse_exposition(text), rmetrics.parse_exposition(text)
    assert ours == theirs
    assert ours['repro_frontend_requests_total{status="shed"}'] == 2
    assert ours['repro_frontend_latency_seconds_count{status="ok"}'] == 50


@pytest.mark.parametrize("bad", [
    "# HELP a h\n# TYPE a counter\na 1\na 2\n",
    "# HELP h x\n# TYPE h histogram\nh_bucket{le=\"1\"} 5\n"
    "h_bucket{le=\"+Inf\"} 3\nh_sum 1\nh_count 3\n",
    "orphan 1\n",
], ids=["duplicate", "nonmonotone", "no_type"])
def test_parser_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ExpositionError):
        parse_exposition(bad)
    with pytest.raises(rmetrics.ExpositionError):
        rmetrics.parse_exposition(bad)


def test_registry_get_or_create_and_mismatch():
    r = MetricsRegistry()
    c = r.counter("x_total", "x")
    assert r.counter("x_total") is c
    with pytest.raises(ValueError):
        r.gauge("x_total")
    with pytest.raises(ValueError):
        r.counter("x_total", labels=("a",))
    with pytest.raises(ValueError):
        c.inc(-1)


def test_memory_gauges_on_the_cpu():
    assert host_rss_bytes() > 0
    assert host_peak_rss_bytes() >= host_rss_bytes()
    assert device_memory_stats(torch.device("cpu")) is None
    r = MetricsRegistry()
    register_memory_gauges(r, device=torch.device("cpu"))
    series = parse_exposition(r.render())
    assert series["repro_memory_host_rss_bytes"] > 0
    assert series["repro_memory_host_peak_rss_bytes"] > 0
    assert series["repro_memory_device_bytes_in_use"] == 0
    assert series["repro_memory_device_peak_bytes"] == 0


def test_exporter_serves_metrics_on_ephemeral_port():
    r = _serving_registry(MetricsRegistry)
    with MetricsExporter(r, port=0) as exp:
        assert exp.port != 0 and exp.host == "127.0.0.1"
        with urllib.request.urlopen(exp.url, timeout=10.0) as resp:
            body = resp.read().decode("utf-8")
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(exp.url.replace("/metrics", "/nope"),
                                   timeout=10.0)
    assert body == r.render()
    assert parse_exposition(body) == rmetrics.parse_exposition(body)
    exp.close()   # idempotent


class TestTelemetry:
    def test_manifest_stamps_torch(self, tmp_path):
        path = str(tmp_path / "run.jsonl")
        tel = Telemetry.jsonl(path, stream=open(os.devnull, "w"))
        tel.manifest(formulation="matching")
        tel.close()
        run = load_run(path)
        m = run.manifest
        assert m["torch_version"] == torch.__version__
        assert m["cuda_version"] == torch.version.cuda
        assert m["platform"] == ("cuda" if torch.cuda.is_available()
                                 else "cpu")
        assert m["device_count"] == (torch.cuda.device_count()
                                     if torch.cuda.is_available() else 0)
        assert m["formulation"] == "matching"
        assert EVENT_FIELDS["manifest"] >= {"torch_version", "platform"}

    def test_serving_events_validate_under_both_schemas(self):
        sink = ListSink()
        tel = Telemetry(sink=sink, stream=open(os.devnull, "w"))
        with tel.span("query", sources=3):
            pass
        tel.event("resolve", outcome="accept", iterations=4)
        tel.event("shed", reason="queue_full", detail="", sources=1)
        tel.event("timeout", waited_s=0.3, deadline_s=0.1, reason="late")
        tel.event("queue_depth", depth=2, batch_sources=8)
        tel.event("drain", pending=0)
        tel.event("metrics", series={})
        tel.info("hello")
        tel.counter("frontend.ok", 2)
        tel.close()
        types = [r["type"] for r in sink.records]
        assert types == ["span", "resolve", "shed", "timeout", "queue_depth",
                         "drain", "metrics", "log", "counters"]
        for rec in sink.records:
            validate_event(rec)
            rschema.validate_event(rec)
        assert set(EVENT_FIELDS) == set(rschema.EVENT_FIELDS)
        for etype in set(EVENT_FIELDS) - {"manifest"}:
            assert EVENT_FIELDS[etype] == rschema.EVENT_FIELDS[etype]

    def test_validator_rejects_bad_records(self):
        with pytest.raises(SchemaError):
            validate_event({"type": "nope", "t": 0.0})
        with pytest.raises(SchemaError):
            validate_event({"type": "shed"})
        with pytest.raises(SchemaError):
            validate_event({"type": "shed", "t": 0.0})

    def test_records_are_json_safe(self, tmp_path):
        path = str(tmp_path / "run.jsonl")
        tel = Telemetry.jsonl(path, stream=open(os.devnull, "w"))
        tel.event("event", nan=float("nan"), t0=torch.tensor(2.5),
                  arr=np.arange(3), f=np.float32(1.5))
        tel.close()
        rec = json.loads(open(path).readline())
        assert rec["nan"] is None and rec["t0"] == 2.5
        assert rec["arr"] == [0, 1, 2] and rec["f"] == 1.5

    def test_disabled_is_a_noop_singleton(self):
        tel = Telemetry.disabled()
        assert tel is Telemetry.disabled() and not tel.enabled
        with tel.span("x"):
            tel.event("event", a=1)
        assert tel.counter("c") == 0
        assert tel.metrics_snapshot() == {"counters": {}, "gauges": {}}

    def test_concurrent_counters_and_spans(self):
        n_threads, n_each = 6, 150
        sink = ListSink()
        tel = Telemetry(sink=sink, stream=open(os.devnull, "w"))
        barrier = threading.Barrier(n_threads)

        def worker(tid):
            barrier.wait()
            for _ in range(n_each):
                tel.counter("hits")
                with tel.span(f"outer{tid}"):
                    with tel.span("inner"):
                        pass

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
        assert tel.metrics_snapshot()["counters"]["hits"] == \
            n_threads * n_each
        inner = {r["path"] for r in sink.records if r.get("name") == "inner"}
        assert inner == {f"outer{t}/inner" for t in range(n_threads)}
