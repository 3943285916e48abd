"""The port's engine telemetry (DESIGN.md §11) against the JAX package's,
on the reference's telemetry fixture (30 × 8, seed 3, γ 0.1, max_step
10, a check every 7 iterations).

  * hooks observe and never perturb: with a recording Telemetry, a
    MemorySampler and a ProfilerHook attached, λ, every IterStats field,
    iterations and stop reason are bit for bit the bare run's, fast path
    and chunked, for every rule;
  * with the defaults the engine makes no extra sync and no extra host
    read (`_sync` and `Tensor.cpu` counted);
  * every emitted record validates, under the port's schema and the
    reference's; check events mirror the diagnostics one for one, also
    when `max_diagnostics` trims the in-memory stream; health, gamma,
    checkpoint events and the counters are the reference's;
  * the reference's and the port's run logs of one instance, at the step
    cap where the two packages' float32 trajectories stay together
    (max_step 0.05), hold the same ordered event types (spans aside: the
    port traces and compiles no program), the same `it` of every check,
    gamma and health event, and duals within 1e-4 relative.  pdhg's
    restarts carry the float32 differences further (2.4e-4 there), so the
    fault scenario runs agd, pga and bb;
  * `repro_torch.launch.report` renders the port's run log: execute/host
    rows, no trace/compile, the byte census; exits 1 on a missing
    manifest or a bad record;
  * `src/repro_torch/core/` and `primal/` hold no bare print().
"""
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import HealthConfig as RHealth
from repro.core import MatchingObjective as RObjective
from repro.core import SolveConfig as RConfig
from repro.core import StoppingCriteria as RCriteria
from repro.core import instance as rinst
from repro.core import precondition as rprecondition
from repro.core.maximizer import SolveEngine as REngine
from repro.obs import ListSink as RListSink
from repro.obs import Telemetry as RTelemetry
from repro.obs import schema as rschema
from repro.testing import ChunkFaultInjector as RInjector
from repro_torch.convert import lp_to_torch
from repro_torch.core import (HealthConfig, MatchingObjective, Maximizer,
                              SolveConfig, SolveEngine, StopReason,
                              StoppingCriteria, instance, precondition)
from repro_torch.core import maximizer as tmaximizer
from repro_torch.launch import report
from repro_torch.obs import (ListSink, MemorySampler, ProfilerHook,
                             SchemaError, Telemetry, load_run,
                             validate_event, validate_run)
from repro_torch.testing import ChunkFaultInjector

SPEC = dict(num_sources=30, num_destinations=8, avg_nnz_per_row=10, seed=3)
CFG = SolveConfig(iterations=120, gamma=0.1, max_step=10.0,
                  initial_step=1e-3)
CRIT = StoppingCriteria(tol_grad_norm=0.0, check_every=7)
CHUNKS = -(-120 // 7)
RULES = ("agd", "pga", "pdhg", "bb")


@pytest.fixture(scope="module")
def lp():
    lp_t, _ = precondition(lp_to_torch(
        instance.generate(instance.InstanceSpec(**SPEC)), "cpu"),
        row_norm=True)
    return lp_t


@pytest.fixture(scope="module")
def lp_r():
    lp_r, _ = rprecondition(jax.tree.map(
        jnp.asarray, rinst.generate(rinst.InstanceSpec(**SPEC))),
        row_norm=True)
    return lp_r


def _recording():
    sink = ListSink()
    return Telemetry(sink=sink, stream=open(os.devnull, "w")), sink


def _assert_same_result(a, b):
    assert torch.equal(a.lam, b.lam)
    for x, y in zip(a.stats, b.stats):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert a.iterations_run == b.iterations_run
    assert a.stop_reason == b.stop_reason


def _types(records, skip=("span",)):
    return [r["type"] for r in records if r["type"] not in skip]


class TestBitIdentity:
    def test_fast_path_bitwise_identical(self, lp):
        obj = MatchingObjective(lp)
        plain = Maximizer(CFG).maximize(obj)
        tel, sink = _recording()
        logged = Maximizer(CFG).maximize(obj, telemetry=tel,
                                         sampler=MemorySampler())
        _assert_same_result(plain, logged)
        assert _types(sink.records) == ["solve_start", "event", "memory",
                                        "manifest", "solve_end"]
        spans = [r for r in sink.records if r["type"] == "span"]
        assert [(s["name"], s["n"]) for s in spans
                if s["name"] == "execute"] == [("execute", 120)]
        names = [s["name"] for s in spans]
        assert names.count("step") == names.count("calculate") == 120
        assert names[-1] == "solve" and names.count("solve") == 1

    @pytest.mark.parametrize("rule", RULES)
    def test_chunked_path_bitwise_identical(self, lp, rule, tmp_path):
        obj = MatchingObjective(lp)
        plain = Maximizer(CFG, algorithm=rule).maximize(obj, criteria=CRIT)
        tel, sink = _recording()
        prof = ProfilerHook(str(tmp_path), start_chunk=2, num_chunks=2)
        logged = Maximizer(CFG, algorithm=rule).maximize(
            obj, criteria=CRIT, telemetry=tel, profiler=prof,
            sampler=MemorySampler(telemetry=tel))
        _assert_same_result(plain, logged)
        checks = [r for r in sink.records if r["type"] == "check"]
        assert len(checks) == len(logged.diagnostics) == CHUNKS
        assert prof.trace_paths == [str(tmp_path / "trace_rank0_chunks2-3.json")]

    def test_guarded_checkpointed_run_bitwise_identical(self, lp):
        obj = MatchingObjective(lp)
        kw = dict(criteria=CRIT, health=HealthConfig(),
                  checkpoint_fn=lambda it, state, meta: None)
        plain = Maximizer(CFG).maximize(obj, **kw)
        tel, _ = _recording()
        _assert_same_result(plain, Maximizer(CFG).maximize(
            obj, telemetry=tel, sampler=MemorySampler(), **kw))

    def test_disabled_is_singleton_noop(self):
        tel = Telemetry.disabled()
        assert tel is Telemetry.disabled()
        assert not tel.enabled
        with tel.span("anything"):
            pass
        tel.event("check", it=1)
        tel.info("dropped")
        assert tel.counter("x") == 0
        tel.close()


@pytest.mark.parametrize("recording", [False, True], ids=["off", "on"])
def test_syncs_and_host_reads(lp, monkeypatch, recording):
    """Off: one stats copy a chunk and no sync; on: one sync a chunk more
    (the execute span waits for the card), and still one copy."""
    obj = MatchingObjective(lp)
    syncs, copies = [], []
    monkeypatch.setattr(tmaximizer, "_sync", lambda dev: syncs.append(dev))
    cpu = torch.Tensor.cpu

    def counting_cpu(self, *a, **k):
        copies.append(self.shape)
        return cpu(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    tel = _recording()[0] if recording else None
    Maximizer(CFG).maximize(obj, criteria=CRIT, telemetry=tel)
    assert len(copies) == CHUNKS
    assert len(syncs) == (CHUNKS if recording else 0)


class TestSchema:
    def test_every_emitted_record_validates(self, lp, tmp_path):
        path = str(tmp_path / "run.jsonl")
        tel = Telemetry.jsonl(path, stream=open(os.devnull, "w"))
        tel.manifest(fingerprint="f" * 8, formulation="matching",
                     algorithm="agd")
        res = Maximizer(CFG).maximize(MatchingObjective(lp), criteria=CRIT,
                                      telemetry=tel)
        tel.close()
        run = validate_run(path)
        assert run.manifest["fingerprint"] == "f" * 8
        by = {}
        for e in run.events:
            by.setdefault(e["type"], []).append(e)
        assert len(by["check"]) == len(res.diagnostics)
        assert len(by["solve_start"]) == len(by["solve_end"]) == 1
        assert by["solve_end"][0]["iterations_run"] == res.iterations_run
        chunk_spans = [s for s in by["span"]
                       if s["name"] in ("execute", "host")]
        names = [s["name"] for s in chunk_spans]
        assert names == ["execute", "host"] * CHUNKS
        assert [s["chunk"] for s in chunk_spans[::2]] == list(range(CHUNKS))
        counters = by["counters"][-1]["counters"]
        assert counters["solve.iterations"] == 120
        assert counters["solve.chunks"] == CHUNKS

    def test_records_validate_under_reference_schema(self, lp):
        tel, sink = _recording()
        Maximizer(CFG).maximize(MatchingObjective(lp), criteria=CRIT,
                                telemetry=tel, sampler=MemorySampler(),
                                health=HealthConfig(),
                                checkpoint_fn=lambda it, st, meta: None)
        for r in sink.records:
            if r["type"] != "manifest":    # the environment stamps differ
                rschema.validate_event(r)

    def test_validator_rejects_bad_records(self):
        with pytest.raises(SchemaError, match="unknown event type"):
            validate_event({"type": "nope", "t": 0.0})
        with pytest.raises(SchemaError, match="missing numeric 't'"):
            validate_event({"type": "check"})
        with pytest.raises(SchemaError, match="missing required fields"):
            validate_event({"type": "span", "t": 0.0, "name": "x"})

    def test_nonfinite_floats_sanitized_to_null(self, tmp_path):
        path = str(tmp_path / "nan.jsonl")
        tel = Telemetry.jsonl(path)
        tel.event("event", bad=float("nan"), worse=float("inf"), ok=1.5,
                  dev=torch.tensor(float("nan")))
        tel.close()
        lines = [json.loads(line) for line in open(path) if line.strip()]
        rec = [r for r in lines if r["type"] == "event"][0]
        assert rec["bad"] is None and rec["worse"] is None
        assert rec["dev"] is None and rec["ok"] == 1.5

    def test_manifest_merge_last_wins(self, tmp_path):
        path = str(tmp_path / "m.jsonl")
        tel = Telemetry.jsonl(path)
        tel.manifest(a=1)
        tel.manifest(b=2)
        tel.close()
        run = load_run(path)
        assert run.manifest["a"] == 1 and run.manifest["b"] == 2

    def test_span_nesting_paths(self):
        tel, sink = _recording()
        with tel.span("outer"):
            with tel.span("inner"):
                pass
        paths = [r["path"] for r in sink.records if r["type"] == "span"]
        assert paths == ["outer/inner", "outer"]


class TestEngineEvents:
    def test_health_rollbacks_emitted(self, lp):
        obj = MatchingObjective(lp)
        eng = SolveEngine(obj.calculate, CFG)
        eng.chunk_fault_hook = ChunkFaultInjector(at_it=14, times=2)
        tel, sink = _recording()
        res = eng.solve(torch.zeros(obj.dual_shape), criteria=CRIT,
                        health=HealthConfig(max_retries=3), telemetry=tel)
        assert res.stop_reason == StopReason.MAX_ITERATIONS
        health = [r for r in sink.records if r["type"] == "health"]
        assert [(h["status"], h["action"]) for h in health] == [
            ("nonfinite", "rollback")] * 2
        assert tel.metrics_snapshot()["counters"]["solve.rollbacks"] == 2

    def test_giveup_emitted_without_rollback_count(self, lp):
        obj = MatchingObjective(lp)
        eng = SolveEngine(obj.calculate, CFG)
        eng.chunk_fault_hook = ChunkFaultInjector(at_it=14, times=10)
        tel, sink = _recording()
        res = eng.solve(torch.zeros(obj.dual_shape), criteria=CRIT,
                        health=HealthConfig(max_retries=2), telemetry=tel)
        assert res.stop_reason == StopReason.DIVERGED
        actions = [r["action"] for r in sink.records if r["type"] == "health"]
        assert actions == ["rollback", "rollback", "giveup"]
        assert tel.metrics_snapshot()["counters"]["solve.rollbacks"] == 2
        end = [r for r in sink.records if r["type"] == "solve_end"][0]
        assert end["stop_reason"] == "diverged"
        assert end["health_incidents"] == 3

    def test_adaptive_gamma_moves_emitted(self, lp):
        adapt = SolveConfig(iterations=300, gamma=0.05, gamma_init=0.8,
                            gamma_decay_rate=0.5, max_step=20.0,
                            initial_step=1e-3, adaptive_continuation=True)
        tel, sink = _recording()
        res = Maximizer(adapt).maximize(MatchingObjective(lp), telemetry=tel)
        gammas = np.asarray(res.stats.gamma)
        assert gammas[0] > gammas[-1]
        moves = [r for r in sink.records if r["type"] == "gamma"]
        assert moves and all(m["reason"] == "stall_decay" for m in moves)
        assert all(m["gamma_to"] < m["gamma_from"] for m in moves)

    def test_checkpoint_flushes_emitted(self, lp):
        tel, sink = _recording()
        Maximizer(CFG).maximize(MatchingObjective(lp), criteria=CRIT,
                                telemetry=tel,
                                checkpoint_fn=lambda it, state, meta: None)
        cps = [r for r in sink.records if r["type"] == "checkpoint"]
        assert len(cps) == CHUNKS + 1
        assert cps[-1]["final"] is True
        spans = [r for r in sink.records
                 if r["type"] == "span" and r["name"] == "checkpoint"]
        assert len(spans) == CHUNKS + 1

    def test_max_diagnostics_keeps_last(self, lp):
        obj = MatchingObjective(lp)
        cfg = SolveConfig(iterations=120, gamma=0.1, max_step=10.0,
                          initial_step=1e-3, max_diagnostics=3)
        unbounded = Maximizer(CFG).maximize(obj, criteria=CRIT)
        tel, sink = _recording()
        res = Maximizer(cfg).maximize(obj, criteria=CRIT, telemetry=tel)
        assert len(res.diagnostics) == 3
        assert [r.it for r in res.diagnostics] == [
            r.it for r in unbounded.diagnostics[-3:]]
        checks = [r for r in sink.records if r["type"] == "check"]
        assert len(checks) == len(unbounded.diagnostics)
        assert torch.equal(res.lam, unbounded.lam)

    def test_profiler_stops_on_divergence(self, lp, tmp_path):
        obj = MatchingObjective(lp)
        eng = SolveEngine(obj.calculate, CFG)
        eng.chunk_fault_hook = ChunkFaultInjector(at_it=14, times=10)
        tel, sink = _recording()
        prof = ProfilerHook(str(tmp_path), start_chunk=1, num_chunks=50)
        res = eng.solve(torch.zeros(obj.dual_shape), criteria=CRIT,
                        health=HealthConfig(max_retries=1), telemetry=tel,
                        profiler=prof)
        assert res.stop_reason == StopReason.DIVERGED
        assert len(prof.trace_paths) == 1
        assert os.path.getsize(prof.trace_paths[0]) > 0
        acts = [r["action"] for r in sink.records if r["type"] == "profile"]
        assert acts == ["start", "stop"]

    def test_profiler_warms_up_one_chunk_early(self, lp, tmp_path):
        """The window at chunk 2 is recorded from chunk 1 in warm-up: the
        run log says it starts at 2; a solve that ends in the warm-up
        chunk writes no trace."""
        tel, sink = _recording()
        prof = ProfilerHook(str(tmp_path / "w"), start_chunk=2, num_chunks=2)
        Maximizer(CFG).maximize(MatchingObjective(lp), criteria=CRIT,
                                telemetry=tel, profiler=prof)
        acts = [(r["action"], r["chunk"]) for r in sink.records
                if r["type"] == "profile"]
        assert acts == [("start", 2), ("stop", 3)]
        short = ProfilerHook(str(tmp_path / "s"), start_chunk=2)
        Maximizer(SolveConfig(iterations=14, gamma=0.1)).maximize(
            MatchingObjective(lp), criteria=CRIT, profiler=short)
        assert short.trace_paths == [] and not short.active
        assert not torch._C._autograd._profiler_enabled()

    def test_second_profiler_raises(self, lp, tmp_path):
        from torch.profiler import profile
        with profile():
            with pytest.raises(RuntimeError, match="another profiler"):
                Maximizer(CFG).maximize(
                    MatchingObjective(lp), criteria=CRIT,
                    profiler=ProfilerHook(str(tmp_path)))


def _reference_log(lp_r, cfg, rule, criteria, inject):
    eng = REngine(RObjective(lp_r).calculate, RConfig(**cfg), algorithm=rule)
    if inject:
        eng.chunk_fault_hook = RInjector(at_it=14, times=2)
    sink = RListSink()
    eng.solve(jnp.zeros((lp_r.m, lp_r.num_destinations), jnp.float32),
              criteria=RCriteria(**criteria), health=RHealth(max_retries=3),
              telemetry=RTelemetry(sink=sink, stream=open(os.devnull, "w")))
    return sink.records


def _port_log(lp, cfg, rule, criteria, inject):
    eng = SolveEngine(MatchingObjective(lp).calculate, SolveConfig(**cfg),
                      algorithm=rule)
    if inject:
        eng.chunk_fault_hook = ChunkFaultInjector(at_it=14, times=2)
    tel, sink = _recording()
    eng.solve(torch.zeros((lp.m, lp.num_destinations)),
              criteria=StoppingCriteria(**criteria),
              health=HealthConfig(max_retries=3), telemetry=tel)
    return sink.records


SCENARIOS = {
    # adaptive γ-continuation: stall-decay gamma events
    "adaptive": ("agd", dict(iterations=400, gamma=0.05, gamma_init=0.8,
                             gamma_decay_rate=0.5, max_step=0.05,
                             initial_step=1e-3, adaptive_continuation=True),
                 False),
    # a transient chunk fault at it 14, twice: health events
    "fault_agd": ("agd", dict(iterations=120, gamma=0.1, max_step=0.05,
                              initial_step=1e-3), True),
    "fault_pga": ("pga", dict(iterations=120, gamma=0.1, max_step=0.05,
                              initial_step=1e-3), True),
    "fault_bb": ("bb", dict(iterations=120, gamma=0.1, max_step=0.05,
                            initial_step=1e-3), True),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_run_log_matches_reference(lp, lp_r, scenario):
    rule, cfg, inject = SCENARIOS[scenario]
    criteria = dict(tol_grad_norm=0.0, check_every=7)
    ref = _reference_log(lp_r, cfg, rule, criteria, inject)
    port = _port_log(lp, cfg, rule, criteria, inject)
    assert _types(port) == _types(ref)
    for etype in ("check", "gamma", "health"):
        assert ([r["it"] for r in port if r["type"] == etype]
                == [r["it"] for r in ref if r["type"] == etype])
    assert any(r["type"] == ("health" if inject else "gamma") for r in port)
    for a, b in zip([r for r in port if r["type"] == "check"],
                    [r for r in ref if r["type"] == "check"]):
        assert abs(a["dual_obj"] - b["dual_obj"]) <= 1e-4 * max(
            1.0, abs(b["dual_obj"]))
    end_p = [r for r in port if r["type"] == "solve_end"][0]
    end_r = [r for r in ref if r["type"] == "solve_end"][0]
    for k in ("stop_reason", "iterations_run", "checks", "health_incidents"):
        assert end_p[k] == end_r[k]


class TestReport:
    @pytest.fixture(scope="class")
    def run_log(self, lp, tmp_path_factory):
        from repro_torch.launch import census
        path = str(tmp_path_factory.mktemp("runlog") / "run.jsonl")
        tel = Telemetry.jsonl(path, stream=open(os.devnull, "w"))
        tel.manifest(fingerprint="f" * 8, formulation="matching",
                     algorithm="agd")
        obj = MatchingObjective(lp)
        Maximizer(CFG).maximize(obj, criteria=CRIT, telemetry=tel,
                                sampler=MemorySampler(telemetry=tel))
        tel.manifest(byte_census=census.evaluation_census(obj))
        tel.close()
        return path

    def test_summarize_splits_chunk_time(self, run_log):
        summary = report.summarize(load_run(run_log))
        assert len(summary["chunks"]) == CHUNKS
        for row in summary["chunks"].values():
            assert set(row) == {"execute", "host"}
        assert all(v >= 0 for v in summary["span_totals"].values())
        assert summary["trajectory"]["checks"] == CHUNKS
        assert summary["memory"]["compiled_peak_bytes"] > 0
        assert summary["byte_census"]["bytes_per_iteration"] > 0

    def test_render_and_cli(self, run_log, capsys):
        text = report.render(report.summarize(load_run(run_log)))
        assert "per-chunk wall-clock split" in text
        assert "execute" in text and "compile" not in text.split(
            "per-chunk wall-clock split")[1].split("==")[1]
        assert "byte census" in text and "dual_x_slab" in text
        assert report.main([run_log]) == 0
        assert report.main([run_log, "--json"]) == 0
        out = capsys.readouterr().out
        payload = json.loads(out[out.index("\n{") + 1:])
        assert payload["manifest"]["algorithm"] == "agd"

    def test_renders_reference_summary_keys(self, run_log, lp_r, tmp_path):
        """The port's summary has every key of the reference's summary of
        a reference log."""
        from repro.launch import report as rreport
        path = str(tmp_path / "ref.jsonl")
        tel = RTelemetry.jsonl(path, stream=open(os.devnull, "w"))
        tel.manifest(algorithm="agd")
        from repro.core import Maximizer as RMaximizer
        RMaximizer(RConfig(iterations=14, gamma=0.1)).maximize(
            RObjective(lp_r), criteria=RCriteria(check_every=7),
            telemetry=tel)
        tel.close()
        from repro.obs import load_run as rload
        ref_keys = set(rreport.summarize(rload(path)))
        assert ref_keys <= set(report.summarize(load_run(run_log)))

    def test_cli_rejects_missing_manifest(self, tmp_path, capsys):
        path = str(tmp_path / "nomanifest.jsonl")
        tel = Telemetry.jsonl(path)
        tel.event("event", note="no manifest here")
        tel.close()
        assert report.main([path]) == 1
        assert "no manifest" in capsys.readouterr().err

    def test_cli_rejects_schema_violation(self, tmp_path):
        path = str(tmp_path / "bad.jsonl")
        with open(path, "w") as f:
            f.write('{"type": "span", "t": 0.0}\n')
        assert report.main([path]) == 1

    def test_cli_rejects_unparseable_line(self, tmp_path):
        path = str(tmp_path / "torn.jsonl")
        with open(path, "w") as f:
            f.write('{"type": "manifest", "t": 0.0, "run_id": "x"\n')
        assert report.main([path]) == 1


def test_core_and_primal_are_print_free():
    """Operator output goes through the telemetry logger; a bare print()
    in the solver or the server would bypass the run log (and corrupt
    --json stdout)."""
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src", "repro_torch")
    offenders = []
    pat = re.compile(r"(?<![\w.])print\(")
    for sub in ("core", "primal"):
        for dirpath, _, files in os.walk(os.path.join(root, sub)):
            for fn in files:
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                for ln, line in enumerate(open(path), start=1):
                    if pat.search(line.split("#")[0]):
                        offenders.append(f"{path}:{ln}")
    assert not offenders, f"bare print() found: {offenders}"
