"""The port's resource sampler (DESIGN.md §13) against the JAX package's
`repro.obs.memory`, on the reference's fixture (30 × 8, seed 3).

  * the probes degrade to None off the card and read real host RSS;
  * `compiled_memory_estimate` counts a chunk runner from the launch
    census (`source="launch_census"`), None for a bare function;
  * the sampler keeps the reference's watermarks, event fields and RSS
    guard (once an excursion, re-armed 5 % under the bound), and its
    events validate under both packages' schemas;
  * the engine emits one `memory` event a chunk boundary (one on the fast
    path), the per-runner estimate once a chunk length, and the manifest
    watermarks; a sampled solve equals the bare one bit for bit;
  * extraction, the shard export and the certificate sample per streamed
    chunk and give the same results as unsampled.
"""
import os

import numpy as np
import pytest
import torch

from repro.obs import MemorySampler as RSampler
from repro.obs import schema as rschema
from repro_torch.convert import lp_to_torch
from repro_torch.core import (MatchingObjective, Maximizer, SolveConfig,
                              StoppingCriteria, instance, precondition)
from repro_torch.obs import (ListSink, MemorySampler, MetricsRegistry,
                             Telemetry, compiled_memory_estimate,
                             device_memory_stats, host_peak_rss_bytes,
                             host_rss_bytes, parse_exposition,
                             register_memory_gauges, validate_event)

SPEC = dict(num_sources=30, num_destinations=8, avg_nnz_per_row=10, seed=3)
CFG = SolveConfig(iterations=120, gamma=0.1, max_step=10.0,
                  initial_step=1e-3)
CRIT = StoppingCriteria(tol_grad_norm=0.0, check_every=7)
CHUNKS = -(-120 // 7)


@pytest.fixture(scope="module")
def lp():
    return precondition(lp_to_torch(
        instance.generate(instance.InstanceSpec(**SPEC)), "cpu"),
        row_norm=True)[0]


@pytest.fixture(scope="module")
def solved(lp):
    obj = MatchingObjective(lp)
    return obj, Maximizer(CFG).maximize(obj)


def _recording():
    sink = ListSink()
    return Telemetry(sink=sink, stream=open(os.devnull, "w")), sink


def _assert_same_result(a, b):
    assert torch.equal(a.lam, b.lam)
    for x, y in zip(a.stats, b.stats):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert a.iterations_run == b.iterations_run
    assert a.stop_reason == b.stop_reason


class TestProbes:
    def test_host_rss_positive(self):
        rss = host_rss_bytes()
        assert rss is not None and rss > 0

    def test_host_peak_at_least_current(self):
        assert host_peak_rss_bytes() >= host_rss_bytes()

    def test_device_stats_none_for_cpu(self):
        assert device_memory_stats("cpu") is None

    def test_estimate_from_the_census(self, lp):
        obj = MatchingObjective(lp)
        state = torch.zeros(obj.dual_shape), torch.zeros(obj.dual_shape)
        est = compiled_memory_estimate(obj, state, length=7)
        assert est["source"] == "launch_census"
        lp_bytes = (sum(t.numel() * t.element_size()
                        for s in lp.slabs for t in s)
                    + lp.b.numel() * 4)
        st = 2 * lp.m * lp.num_destinations * 4
        assert est["argument_bytes"] > lp_bytes + st    # + the plan
        assert est["output_bytes"] == st + 6 * 7 * 4
        assert est["temp_bytes"] >= obj._xbuf.numel() * 4

    def test_estimate_none_for_bare_function(self):
        assert compiled_memory_estimate(lambda lam, g: None, ()) is None

    def test_register_memory_gauges_renders_live_rss(self):
        r = MetricsRegistry()
        register_memory_gauges(r)
        series = parse_exposition(r.render())
        assert series["repro_memory_host_rss_bytes"] > 0
        assert series["repro_memory_device_bytes_in_use"] == 0


class TestSampler:
    def test_sample_accumulates_watermarks(self):
        s = MemorySampler()
        s.sample(where="a")
        s.sample(where="b")
        marks = s.watermarks()
        assert marks["memory_samples"] == 2
        assert marks["peak_rss_bytes"] > 0
        assert marks["peak_hbm_bytes"] is None
        assert set(marks) == set(RSampler().watermarks())

    def test_event_fields_match_both_schemas(self):
        fields = MemorySampler.event_fields(MemorySampler().sample(where="t"))
        validate_event({"type": "memory", "t": 0.0, **fields})
        rschema.validate_event({"type": "memory", "t": 0.0, **fields})
        assert set(fields) == set(RSampler.event_fields(
            RSampler().sample(where="t")))

    def test_rss_guard_fires_once_per_excursion(self):
        tel, sink = _recording()
        s = MemorySampler(telemetry=tel, max_host_rss_bytes=1)
        s.sample(where="t1")
        s.sample(where="t2")
        guard = [r for r in sink.records
                 if r["type"] == "memory" and r.get("reason") == "rss_guard"]
        warnings = [r for r in sink.records
                    if r["type"] == "log" and r.get("level") == "warning"]
        assert len(guard) == 1 and len(warnings) == 1
        assert guard[0]["where"] == "t1"
        assert "--max-host-rss-mb" in warnings[0]["msg"]

    def test_rss_guard_rearms_under_the_bound(self):
        tel, sink = _recording()
        s = MemorySampler(telemetry=tel, max_host_rss_bytes=1)
        s.sample(where="high")
        s.max_host_rss_bytes = 1 << 60      # RSS now far under the bound
        s.sample(where="low")
        s.max_host_rss_bytes = 1
        s.sample(where="high again")
        guard = [r["where"] for r in sink.records
                 if r.get("reason") == "rss_guard"]
        assert guard == ["high", "high again"]

    def test_rss_guard_silent_under_bound(self):
        tel, sink = _recording()
        MemorySampler(telemetry=tel, max_host_rss_bytes=1 << 60).sample()
        assert not [r for r in sink.records if r.get("reason") == "rss_guard"]

    def test_note_compiled_keeps_the_largest(self):
        s = MemorySampler()
        s.note_compiled({"argument_bytes": 10, "output_bytes": 5,
                         "temp_bytes": 1, "source": "launch_census"})
        s.note_compiled({"argument_bytes": 3, "source": "launch_census"})
        s.note_compiled(None)
        assert s.watermarks()["compiled_peak_bytes"] == 16

    def test_registry_mirrors_gauges(self):
        r = MetricsRegistry()
        MemorySampler(registry=r).sample()
        assert parse_exposition(r.render())["repro_memory_host_rss_bytes"] > 0


class TestEngine:
    def test_chunked_solve_emits_memory_events(self, lp):
        tel, sink = _recording()
        res = Maximizer(CFG).maximize(MatchingObjective(lp), criteria=CRIT,
                                      telemetry=tel,
                                      sampler=MemorySampler(telemetry=tel))
        mem = [r for r in sink.records if r["type"] == "memory"]
        assert len(mem) == CHUNKS
        for r in mem:
            validate_event(r)
            assert r["peak_rss_bytes"] > 0
        assert mem[-1]["it"] == res.iterations_run
        est = [r for r in sink.records if r["type"] == "event"]
        # one estimate a distinct chunk length: 7, and the last chunk's 1
        assert [r["chunk_len"] for r in est] == [7, 1]
        assert all(r["kind"] == "compiled_memory" for r in est)
        manifest = [r for r in sink.records if r["type"] == "manifest"][-1]
        for key in ("peak_rss_bytes", "peak_hbm_bytes",
                    "compiled_peak_bytes", "memory_samples"):
            assert key in manifest
        assert manifest["compiled_peak_bytes"] > 0
        assert manifest["memory_samples"] == CHUNKS

    def test_fast_path_emits_memory_event(self, lp):
        tel, sink = _recording()
        res = Maximizer(CFG).maximize(MatchingObjective(lp), telemetry=tel,
                                      sampler=MemorySampler(telemetry=tel))
        mem = [r for r in sink.records if r["type"] == "memory"]
        assert len(mem) == 1 and mem[0]["it"] == res.iterations_run

    @pytest.mark.parametrize("criteria", [None, CRIT], ids=["fast", "chunked"])
    def test_sampler_keeps_solve_bitwise_identical(self, lp, criteria):
        obj = MatchingObjective(lp)
        plain = Maximizer(CFG).maximize(obj, criteria=criteria)
        sampled = Maximizer(CFG).maximize(obj, criteria=criteria,
                                          sampler=MemorySampler())
        _assert_same_result(plain, sampled)

    def test_sampler_without_telemetry_reads_only(self, lp):
        s = MemorySampler()
        Maximizer(CFG).maximize(MatchingObjective(lp), criteria=CRIT,
                                sampler=s)
        assert s.watermarks()["memory_samples"] == CHUNKS


class TestStreaming:
    def test_extract_samples_and_stays_bitwise(self, solved):
        from repro_torch import primal
        obj, res = solved
        gamma = np.float32(CFG.gamma)
        plain = primal.extract_primal(obj, res.lam, gamma, chunk_rows=8)
        sampler = MemorySampler()
        sampled = primal.extract_primal(obj, res.lam, gamma, chunk_rows=8,
                                        sampler=sampler)
        for a, b in zip(plain, sampled):
            np.testing.assert_array_equal(a, b)
        chunks = sum(-(-s.n // 8) for s in obj.lp.slabs)
        assert sampler.watermarks()["memory_samples"] == chunks

    def test_write_shards_samples(self, solved, tmp_path):
        from repro_torch import primal
        obj, res = solved
        sampler = MemorySampler()
        paths = primal.write_shards(obj, res.lam, np.float32(CFG.gamma),
                                    str(tmp_path), chunk_rows=8,
                                    sampler=sampler)
        assert sampler.watermarks()["memory_samples"] == len(paths)

    def test_certify_samples_and_stays_bitwise(self, solved):
        from repro_torch import primal
        obj, res = solved
        gamma = np.float32(CFG.gamma)
        plain = primal.certify(obj, res.lam, gamma, chunk_rows=8)
        sampler = MemorySampler()
        cert = primal.certify(obj, res.lam, gamma, chunk_rows=8,
                              sampler=sampler)
        assert cert == plain
        chunks = sum(-(-s.n // 8) for s in obj.lp.slabs)
        assert sampler.watermarks()["memory_samples"] == chunks + 1
