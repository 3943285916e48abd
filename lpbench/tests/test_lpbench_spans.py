"""The charging of the card's idle time to the program's spans
(`spans.py`) on a timeline made by hand, `trace.reduce_events` pinned on
a fixed event list, and CPU rehearsals of the traced run's new readings
(the program's plain versions in place of its kernels, no device
trace)."""
import json

import pytest

from lpbench import run, spans
from lpbench.tests.tiny import one_thread, tiny  # noqa: F401
from lpbench.trace import reduce_events

K = ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::{}_kernel_cuda(at::TensorIteratorBase&)>")
MS = 1_000_000
EARLY = 4 * MS          # the card's clock reads 4 ms early
T0 = 1_700_000_000 * 10**9


def timeline():
    """Host (unix ns, from T0, in ms): the solve span 100-290; a step
    110-150 holding a calculate 112-140 holding two launches 114-120 and
    125-135; a host span 150-200; a second step 200-260 with its
    calculate 205-230.  Card, on the host's clock: the opening burst
    ends at 100, the kernels launched at 114, 125, 205 and 240 run
    118-124, 136-146, 206-226 and 241-245 (a read to the host), the
    closing burst starts at 300.  The card's timestamps read EARLY; each
    launch and its kernel share a correlation id.  The tightest kernel
    starts 1 ms after its launch, so the offset found is EARLY - 1 ms."""
    def dev(a, b, name, link):
        return (T0 + a * MS - EARLY, T0 + b * MS - EARLY, name, link)

    def host(a, b, link):
        return (T0 + a * MS, T0 + a * MS + 2000, "cudaLaunchKernel", link)
    device = [dev(90, 100, K.format("atan"), 1),
              dev(118, 124, "dual_x_kernel", 2),
              dev(136, 146, "ax_items_kernel", 3),
              dev(206, 226, "dual_x_kernel", 4),
              dev(241, 245, "Memcpy DtoH (Device -> Pinned)", 5),
              dev(300, 301, K.format("sinh"), 6)]
    launches = [host(89, 0, 1), host(114, 0, 2), host(125, 0, 3),
                host(205, 0, 4), host(240, 0, 5), host(299, 0, 6)]

    def span(sid, parent, name, a, b):
        return {"type": "span", "name": name, "id": sid, "parent": parent,
                "solve": 0, "start_ns": T0 + a * MS, "end_ns": T0 + b * MS,
                "dur_s": (b - a) / 1e3}
    records = [span(0, None, "solve", 100, 290),
               span(1, 0, "step", 110, 150),
               span(2, 1, "calculate", 112, 140),
               span(3, 2, "launch", 114, 120),
               span(4, 2, "launch", 125, 135),
               span(5, 0, "host", 150, 200),
               span(6, 0, "step", 200, 260),
               span(7, 6, "calculate", 205, 230)]
    return device, launches, records


def test_offset_is_the_early_clock():
    device, launches, _ = timeline()
    # the tightest kernel starts 1 ms after its launch (206 after 205)
    assert spans.align(device, launches) == EARLY - MS


def test_charge_by_span():
    device, launches, records = timeline()
    ch = spans.charge_trace(device, launches, records)
    assert ch["offset_ns"] == EARLY - MS and ch["solve"] == 0
    # the four kernels, each its own stretch: shifts 0, -7, 3, 3 ms
    assert ch["offset_drift_ns"] == 10 * MS
    assert ch["linked_share"] == 1.0
    s = 1e-3        # ms in seconds
    # on the host clock (the card's + 3 ms) the card idles 99-117,
    # 123-135, 145-205, 225-240 and 244-299
    by = ch["by_name"]
    assert by["solve"] == pytest.approx(40 * s)      # 100-110, 260-290
    assert by["step"] == pytest.approx(38 * s)       # 110-112, 145-150,
    #                                    200-205, 230-240, 244-260
    assert by["calculate"] == pytest.approx(9 * s)   # 112-114, 123-125,
    #                                                  225-230
    assert by["launch"] == pytest.approx(13 * s)     # 114-117, 125-135
    assert by["host"] == pytest.approx(50 * s)
    assert by[spans.OUTSIDE] == pytest.approx(10 * s)   # 99-100, 290-299
    assert ch["idle_s"] == pytest.approx(160 * s)
    assert ch["idle_s"] == pytest.approx(sum(by.values()))
    assert ch["charged_s"] + ch["outside_s"] == pytest.approx(ch["idle_s"])
    tr = reduce_events([e[:3] for e in device])
    assert ch["idle_s"] == pytest.approx(tr["window_s"] - tr["busy_s"])
    assert ch["under"]["calculate"] == pytest.approx(22 * s)
    assert ch["under"]["solve"] == pytest.approx(150 * s)
    assert ch["counts"] == {"solve": 1, "step": 2, "calculate": 2,
                            "launch": 2, "host": 1}
    idle = spans.idle_ms(ch)
    assert idle["objective.idle_ms"] == pytest.approx(11.0)
    assert idle["rule.idle_ms"] == pytest.approx(19.0)
    lines = spans.table(ch).splitlines()
    assert lines[0].startswith("charge: clock offset 3000000 ns (card to "
                               "host, moving 10000000 ns over the window)")
    assert len(lines) == 7 and "host" in lines[1]


def test_innermost_and_charge_by_hand():
    sp = [{"id": 0, "parent": None, "start_ns": 0, "end_ns": 100},
          {"id": 1, "parent": 0, "start_ns": 10, "end_ns": 50},
          {"id": 2, "parent": 1, "start_ns": 20, "end_ns": 30}]
    pieces = spans.innermost(sp)
    assert pieces == [(0, 10, 0), (10, 20, 1), (20, 30, 2), (30, 50, 1),
                      (50, 100, 0)]
    by_id, outside = spans.charge([(5, 25), (90, 120)], pieces)
    assert by_id == {0: 15, 1: 10, 2: 5} and outside == 20


def test_no_window_or_link_charges_nothing():
    device, launches, records = timeline()
    assert spans.charge_trace(device, [], records) is None
    assert spans.charge_trace([e for e in device if "sinh" not in e[2]],
                              launches, records) is None


def test_reduce_events_pinned():
    """`trace.reduce_events` on a fixed list, its whole output."""
    device, _, _ = timeline()
    tr = reduce_events([e[:3] for e in device])
    assert json.loads(json.dumps(tr)) == {
        "events": 6, "window_s": pytest.approx(0.2),
        "busy_s": pytest.approx(0.040), "calculate_s": [],
        "device_ops": [["dual_x_kernel", pytest.approx(0.026)],
                       ["ax_items_kernel", pytest.approx(0.010)],
                       ["Memcpy DtoH (Device -> Pinned)",
                        pytest.approx(0.004)]],
        "idle_gaps": [
            ["between evaluations (the rule's step, the engine)",
             pytest.approx(0.087)],
            ["the solve's end (the engine's return)", pytest.approx(0.055)],
            ["the solve's start (the engine's set-up)",
             pytest.approx(0.018)]]}


CAPS = {"matching-2m.cold": ("criteria", "max_iterations"),
        "multi_budget-2m.cold": ("solve", "iterations")}
NEW = {"objective.host_ms", "kernels.host_ms", "rule.host_ms"}


def short(cell_name):
    """The tiny cell with its solves cut to 30 iterations, so a window of
    a second holds several."""
    bench, cell, config, traffic = tiny(cell_name)
    group, key = CAPS[cell_name]
    config[group][key] = 30
    return bench, cell, config, traffic


@pytest.mark.parametrize("cell", sorted(CAPS))
def test_rehearsal_reads_the_new_metrics(cell):
    bench, c, config, traffic = short(cell)
    result = run.run_cell(bench, c, config, traffic, 2**31 + 11, 1.0, True,
                          "cpu")
    assert result["attempted"] >= 2
    assert NEW | {"setup.build_s", "engine.iters", "engine.host_ms"} <= set(
        result["metrics"])
    for name in NEW:
        assert result["metrics"][name]["value"] > 0
    m = {k: v["value"] for k, v in result["metrics"].items()}
    # the wrappers run inside the evaluation
    assert m["kernels.host_ms"] < m["objective.host_ms"]


@pytest.mark.parametrize("cell", sorted(CAPS))
def test_traced_tool_rehearsal(cell):
    _, _, config, traffic = short(cell)
    out = spans.measure(config, traffic, 2**31 + 13, 1.0, "cpu")
    m = out["metrics"]
    readable = NEW | {"setup.row_norm_s", "setup.ax_plan_s"}
    for name in readable:
        assert m[name] > 0, name
    # without a card: no device trace, no charge
    assert out["charge"] is None
    assert m["objective.idle_ms"] is None and m["rule.idle_ms"] is None
    assert len(out["solve_s"]) >= 2 and out["raised"] is None
