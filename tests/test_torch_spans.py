"""The port's spans inside the set-up and the solve loop (obs/telemetry.py,
core/maximizer.py, the kernel wrappers, core/preconditioning.py and
core/objectives.py), on the telemetry fixture (30 × 8, seed 3):

  * the span tree of a tiny agd and pdhg solve: every span's `parent` is
    the span open around it, every span carries its solve's `solve`, a
    step's self time is the step less its `calculate`;
  * the counters and the solve_end fields: evaluations, kernel launches;
  * with telemetry disabled the trajectory is the recording run's bit for
    bit and nothing reaches an outer recorder;
  * the repaired `host` span covers the chunk boundary's decisions;
  * the clock: a span's `start_ns`/`end_ns` contain the profiler's host
    interval of the operation inside it;
  * the set-up's `row_norm` and `ax_plan` spans through `current()`;
  * `launch.report` shows the spans by name.
"""
import io
import threading
import time

import pytest
import torch

from repro_torch.convert import lp_to_torch
from repro_torch.core import (MatchingObjective, Maximizer, SolveConfig,
                              SolveEngine, StoppingCriteria, instance,
                              precondition)
from repro_torch.launch import report
from repro_torch.obs import ListSink, RunLog, Telemetry
from repro_torch.obs.telemetry import current

SPEC = dict(num_sources=30, num_destinations=8, avg_nnz_per_row=10, seed=3)
CFG = SolveConfig(iterations=60, gamma=0.1, max_step=10.0,
                  initial_step=1e-3)
CRIT = StoppingCriteria(tol_grad_norm=0.0, check_every=7)
CHUNKS = -(-60 // 7)


@pytest.fixture(scope="module")
def lp():
    lp_t, _ = precondition(lp_to_torch(
        instance.generate(instance.InstanceSpec(**SPEC)), "cpu"),
        row_norm=True)
    return lp_t


def _recording():
    sink = ListSink()
    return Telemetry(sink=sink, stream=io.StringIO()), sink


def _spans(records):
    return [r for r in records if r["type"] == "span"]


@pytest.mark.parametrize("rule", ["agd", "pdhg"])
def test_span_tree(lp, rule):
    tel, sink = _recording()
    obj = MatchingObjective(lp)
    for _ in range(2):
        Maximizer(CFG, algorithm=rule).maximize(obj, criteria=CRIT,
                                                telemetry=tel)
    spans = _spans(sink.records)
    by_id = {s["id"]: s for s in spans}
    assert len(by_id) == len(spans)
    roots = [s for s in spans if s["parent"] is None]
    assert [(s["name"], s["solve"]) for s in roots] == [("solve", 0),
                                                        ("solve", 1)]
    parent_of = {"execute": "solve", "host": "solve", "step": "execute",
                 "calculate": "step", "launch": "calculate"}
    for s in spans:
        assert s["solve"] in (0, 1)
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["name"] == parent_of[s["name"]]
            assert p["solve"] == s["solve"]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"]
            assert s["path"] == p["path"] + "/" + s["name"]
        assert s["end_ns"] - s["start_ns"] == pytest.approx(
            s["dur_s"] * 1e9, abs=2)
    for seq in (0, 1):
        names = [s["name"] for s in spans if s["solve"] == seq]
        assert names.count("step") == names.count("calculate") == 60
        assert names.count("execute") == names.count("host") == CHUNKS
        # the CPU's plain versions of K1 (one a slab) and K2 (one)
        assert names.count("launch") == 60 * (len(lp.slabs) + 1)
    kernels = {s["kernel"] for s in spans if s["name"] == "launch"}
    assert kernels == {"dual_x_slab", "ax_reduce_plan_x"}
    # a step's self time: the step less its one calculate
    for step in (s for s in spans if s["name"] == "step"):
        inner = [s for s in spans if s["parent"] == step["id"]]
        assert [s["name"] for s in inner] == ["calculate"]
        assert 0 <= step["dur_s"] - inner[0]["dur_s"] < step["dur_s"]
    ends = [r for r in sink.records if r["type"] == "solve_end"]
    assert [(e["solve"], e["evaluations"]) for e in ends] == [(0, 60),
                                                             (1, 60)]
    assert tel.metrics_snapshot()["counters"]["solve.evaluations"] == 120


def test_fast_path_spans(lp):
    """One chunk of the full count: every step still in its span."""
    tel, sink = _recording()
    Maximizer(CFG).maximize(MatchingObjective(lp), telemetry=tel)
    names = [s["name"] for s in _spans(sink.records)]
    assert names.count("step") == names.count("calculate") == 60
    assert names.count("execute") == 1 and names[-1] == "solve"


def test_launch_deltas_counted(lp, monkeypatch):
    """The wrappers' `launches` deltas of a solve become counters (the
    CPU's plain versions count none, so the counts are faked)."""
    import repro_torch.kernels as kernels
    counts = {"dual_x_slab": 5, "ax_reduce_plan_x": 7, "proj_boxcut": 1}

    def fake():
        counts["dual_x_slab"] += 2
        counts["ax_reduce_plan_x"] += 1
        return dict(counts)
    monkeypatch.setattr(kernels, "launch_counts", fake)
    tel, _ = _recording()
    Maximizer(CFG).maximize(MatchingObjective(lp), criteria=CRIT,
                            telemetry=tel)
    got = tel.metrics_snapshot()["counters"]
    assert got["kernels.dual_x_slab.launches"] == 2
    assert got["kernels.ax_reduce_plan_x.launches"] == 1
    assert "kernels.proj_boxcut.launches" not in got


@pytest.mark.parametrize("rule", ["agd", "pdhg"])
def test_disabled_records_nothing(lp, rule):
    """Telemetry off: the recording run's trajectory bit for bit, and a
    recorder active around the solve gets nothing (the engine makes the
    disabled one current for the solve)."""
    obj = MatchingObjective(lp)
    tel, _ = _recording()
    logged = Maximizer(CFG, algorithm=rule).maximize(obj, criteria=CRIT,
                                                     telemetry=tel)
    outer, sink = _recording()
    seen = []
    calculate = obj.calculate

    def watch(lam, gamma):
        seen.append(current())
        return calculate(lam, gamma)
    eng = SolveEngine(watch, CFG, rule)
    with outer.activate():
        plain = eng.solve(torch.zeros(obj.dual_shape), criteria=CRIT)
        assert current() is outer
    assert current() is Telemetry.disabled()
    assert torch.equal(plain.lam, logged.lam)
    for a, b in zip(plain.stats, logged.stats):
        assert (a == b).all()
    assert sink.records == []
    assert set(map(id, seen)) == {id(Telemetry.disabled())}


def test_current_is_thread_local():
    tel, _ = _recording()
    other = []
    with tel.activate():
        t = threading.Thread(target=lambda: other.append(current()))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        assert current() is tel
    assert other == [Telemetry.disabled()]


def test_host_span_covers_the_decisions(lp):
    """The `host` span runs from the stats copy to the next chunk's
    enqueue: a diagnostics callback made at the chunk boundary falls
    inside it."""
    tel, sink = _recording()
    marks = []

    def on_check(rec):
        marks.append(time.perf_counter_ns())
    Maximizer(CFG).maximize(MatchingObjective(lp), criteria=CRIT,
                            telemetry=tel, diagnostics_fn=on_check)
    hosts = [s for s in _spans(sink.records) if s["name"] == "host"]
    execs = [s for s in _spans(sink.records) if s["name"] == "execute"]
    assert len(hosts) == len(marks) == CHUNKS
    for h, t in zip(hosts, marks):
        assert h["start_ns"] <= t + tel._unix_ns <= h["end_ns"]
    for h, nxt in zip(hosts, execs[1:]):
        assert h["end_ns"] <= nxt["start_ns"]


def test_span_clock_holds_the_profiler_interval():
    """A span around `x.sin_()`, on the unix clock, contains the
    interval a CPU-activity profile gives `aten::sin_`."""
    from torch.profiler import ProfilerActivity, profile
    tel, sink = _recording()
    x = torch.zeros(100_000)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tel.span("sin"):
            x.sin_()
    span = _spans(sink.records)[0]
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::sin_"]
    assert len(ops) == 1
    assert span["start_ns"] <= ops[0].start_ns() <= ops[0].end_ns() \
        <= span["end_ns"]


def test_setup_spans_through_current():
    lp0 = lp_to_torch(instance.generate(instance.InstanceSpec(**SPEC)),
                      "cpu")
    tel, sink = _recording()
    with tel.activate():
        lp, _ = precondition(lp0, row_norm=True)
        MatchingObjective(lp)
    assert [(s["name"], s["parent"]) for s in _spans(sink.records)] == [
        ("row_norm", None), ("ax_plan", None)]
    # no recorder active: nothing is recorded anywhere
    precondition(lp0, row_norm=True)
    assert len(sink.records) == 2


def test_report_spans_by_name(lp):
    tel, sink = _recording()
    tel.manifest(fingerprint="f" * 8)
    Maximizer(CFG).maximize(MatchingObjective(lp), criteria=CRIT,
                            telemetry=tel)
    tel.close()
    run = RunLog(manifest=sink.records[0], events=tuple(sink.records))
    summary = report.summarize(run)
    names = summary["span_names"]
    assert names["step"]["count"] == names["calculate"]["count"] == 60
    assert names["solve"]["count"] == 1
    step_self = names["step"]["total_s"] - names["calculate"]["total_s"]
    assert names["step"]["self_s"] == pytest.approx(step_self)
    assert names["solve"]["self_s"] <= names["solve"]["total_s"]
    text = report.render(summary)
    assert "spans by name" in text and "calculate" in text
    assert "solve.evaluations" in text


def test_spanned_decorator():
    """`spanned`: the function as it is with no recorder active; with one,
    a leaf span under the span open around the call, also when the call
    raises."""
    from repro_torch.obs.telemetry import spanned

    @spanned("launch", kernel="k")
    def f(x, fail=False):
        if fail:
            raise ValueError("no")
        return x + 1
    assert f(1) == 2 and f.__name__ == "f"
    tel, sink = _recording()
    with tel.activate():
        assert f(2) == 3                       # a root leaf: written now
        assert [r["name"] for r in sink.records] == ["launch"]
        with tel.span("outer", solve=4):
            f(3)
            with pytest.raises(ValueError):
                f(0, fail=True)
    spans = _spans(sink.records)
    assert [(s["name"], s["path"], s["solve"]) for s in spans] == [
        ("launch", "launch", None), ("launch", "outer/launch", 4),
        ("launch", "outer/launch", 4), ("outer", "outer", 4)]
    assert spans[1]["parent"] == spans[2]["parent"] == spans[3]["id"]
    assert all(s["kernel"] == "k" for s in spans[:3])
    assert f(5) == 6 and len(sink.records) == 4
