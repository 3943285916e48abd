"""The traced solve's idle time on the card, put down to the program's
spans, and the program's set-up spans: one traced run of a cell, apart
from `run.py`,

    python3 -m lpbench.spans --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on a CUDA card.  It builds the cell's
objective under a recorder of its own (the `row_norm` and `ax_plan`
spans), warms up, and runs `run.window` with the engine's telemetry and
a device trace over the first solve that also keeps the host's launch
records (`LaunchTrace`); it logs the charge table on stderr and prints
one JSON line: the per-layer readings (`setup.row_norm_s`,
`setup.ax_plan_s`, `objective.idle_ms`, `rule.idle_ms`, and `run.py`'s
readers of the same run), the charge and the window's solve times.  The
charging lives in the benchmark, not in the program, so that a change to
the program cannot change how it is judged.

The program's spans (`repro_torch.obs.telemetry`) carry `start_ns` and
`end_ns` on the unix clock that torch.profiler stamps host records with,
and an `id` and the `parent` id.  The device trace (`trace.py`) keeps the
card's events and the host's launch records (CUDA runtime and driver
calls), each device event linked to the launch that enqueued it by their
correlation id.  Then:

  1. the card's clock is put on the host's by one shift a trace: the
     least after which no device event starts before its own launch
     (`align`; the card's timestamps have read up to ~4 ms early);
  2. each idle gap of the window between the bracketing bursts (the
     rule of `trace.reduce_events`) is moved onto the host clock and
     split among the innermost program spans open over it; idle that no
     span covers is charged to OUTSIDE (`charge`).

A span's charge is idle time during its self time (its children's
intervals go to them): the card waited while that span's own host code
ran.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from .trace import DRAIN, PRIME, DeviceTrace, _marks, _on_device

OUTSIDE = "outside the program"


def align(device: Sequence[tuple], launches: Sequence[tuple]
          ) -> Optional[int]:
    """The shift in ns that puts the card's (start, end, name, link)
    events on the host clock of the (start, end, name, link) launch
    records: the least after which no linked event starts before its
    launch.  None when no event is linked."""
    starts = {link: a for a, _, _, link in launches}
    shifts = [starts[link] - a for a, _, _, link in device
              if link in starts]
    return max(shifts) if shifts else None


def offset_drift(device: Sequence[tuple], launches: Sequence[tuple],
                 w0: int, w1: int, parts: int = 10) -> Optional[int]:
    """How far the least-shift rule moves across the window: the range,
    in ns, of `align` over each of `parts` equal stretches of the
    window's linked events.  One offset a trace assumes it is small
    next to the idle gaps."""
    inside = sorted(e for e in device if w0 <= e[0] and e[1] <= w1)
    if not inside:
        return None
    step = -(-len(inside) // min(parts, len(inside)))
    shifts = [align(inside[i:i + step], launches)
              for i in range(0, len(inside), step)]
    shifts = [x for x in shifts if x is not None]
    return max(shifts) - min(shifts) if shifts else None


def window(device: Sequence[tuple]) -> Optional[Tuple[int, int]]:
    """The traced window on the card's clock, as `trace.reduce_events`
    takes it: from the last kernel of the opening burst to the first of
    the closing one."""
    prime = [b for a, b, n, *_ in device if _marks(PRIME, n)]
    drain = [a for a, b, n, *_ in device if _marks(DRAIN, n)]
    if not prime or not drain:
        return None
    return max(prime), min(drain)


def idle_gaps(device: Sequence[tuple], w0: int, w1: int
              ) -> List[Tuple[int, int]]:
    """The window's stretches with nothing on the card, by the rule of
    `trace.reduce_events`: before each event that starts after every
    earlier one has ended, and from the last end to the window's."""
    gaps, prev_end = [], w0
    for a, b, *_ in sorted(e for e in device if e[0] >= w0 and e[1] <= w1):
        if a > prev_end:
            gaps.append((prev_end, a))
        prev_end = max(prev_end, b)
    if w1 > prev_end:
        gaps.append((prev_end, w1))
    return gaps


def innermost(spans: Sequence[dict]) -> List[Tuple[int, int, int]]:
    """(start, end, span id) pieces of time, each under the innermost of
    the spans open over it (the deepest by `parent`), in order."""
    by_id = {s["id"]: s for s in spans}
    depth: Dict[int, int] = {}
    for s in spans:
        d, p = 0, s.get("parent")
        while p in by_id:
            d, p = d + 1, by_id[p].get("parent")
        depth[s["id"]] = d
    # at one time, closes before opens
    points = sorted([(s["start_ns"], 1, s["id"]) for s in spans]
                    + [(s["end_ns"], 0, s["id"]) for s in spans])
    pieces, open_ids, prev = [], [], None
    for t, opens, sid in points:
        if open_ids and t > prev:
            top = max(open_ids, key=depth.__getitem__)
            if pieces and pieces[-1][2] == top and pieces[-1][1] == prev:
                pieces[-1] = (pieces[-1][0], t, top)
            else:
                pieces.append((prev, t, top))
        prev = t
        if opens:
            open_ids.append(sid)
        else:
            open_ids.remove(sid)
    return pieces


def charge(gaps: Sequence[Tuple[int, int]],
           pieces: Sequence[Tuple[int, int, int]]
           ) -> Tuple[Dict[int, int], int]:
    """Split each gap among the pieces over it: (ns charged by span id,
    ns under no span).  Both lists are in order and do not overlap."""
    by_id: Dict[int, int] = {}
    outside, j = 0, 0
    for g0, g1 in gaps:
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        covered, k = 0, j
        while k < len(pieces) and pieces[k][0] < g1:
            a, b, sid = pieces[k]
            ov = min(g1, b) - max(g0, a)
            if ov > 0:
                by_id[sid] = by_id.get(sid, 0) + ov
                covered += ov
            k += 1
        outside += g1 - g0 - covered
    return by_id, outside


def traced_solve(spans: Sequence[dict], w0: int, w1: int) -> Optional[int]:
    """The `solve` sequence number of the solve span over most of the
    window (host clock)."""
    best, seq = 0, None
    for s in spans:
        if s["name"] == "solve" and s.get("solve") is not None:
            ov = min(w1, s["end_ns"]) - max(w0, s["start_ns"])
            if ov > best:
                best, seq = ov, s["solve"]
    return seq


def charge_trace(device: Sequence[tuple], launches: Sequence[tuple],
                 records: Sequence[dict]) -> Optional[dict]:
    """The traced solve's idle charged to its spans (module doc), from
    the card's linked events, the launch records and the window's
    telemetry records; None without a window or a linked event.  The
    result: the clock `offset_ns`, the `linked_share` of the window's
    device time, `idle_s`, `charged_s` and `outside_s`, `by_name` (idle
    seconds by span name, OUTSIDE for no span), `under` (idle charged
    to the spans of a name and their descendants) and `counts` (the
    traced solve's spans by name)."""
    edges = window(device)
    offset = align(device, launches)
    if edges is None or offset is None:
        return None
    w0, w1 = edges
    inside = [e for e in device if e[0] >= w0 and e[1] <= w1]
    busy = sum(b - a for a, b, *_ in inside)
    starts = {link for *_, link in launches}
    linked = sum(b - a for a, b, _, link in inside if link in starts)
    gaps = [(a + offset, b + offset) for a, b in idle_gaps(device, w0, w1)]
    spans = [r for r in records or () if r.get("type") == "span"
             and "start_ns" in r and "id" in r]
    seq = traced_solve(spans, w0 + offset, w1 + offset)
    if seq is not None:
        spans = [s for s in spans if s.get("solve") == seq]
    by_id, outside = charge(gaps, innermost(spans))
    names = {s["id"]: s["name"] for s in spans}
    parents = {s["id"]: s.get("parent") for s in spans}
    by_name: Dict[str, float] = {}
    under: Dict[str, float] = {}
    for sid, ns in by_id.items():
        by_name[names[sid]] = by_name.get(names[sid], 0.0) + ns / 1e9
        seen, p = set(), sid
        while p in names:
            if names[p] not in seen:
                under[names[p]] = under.get(names[p], 0.0) + ns / 1e9
                seen.add(names[p])
            p = parents[p]
    by_name[OUTSIDE] = outside / 1e9
    counts: Dict[str, int] = {}
    for s in spans:
        counts[s["name"]] = counts.get(s["name"], 0) + 1
    idle = sum(b - a for a, b in gaps)
    return {"offset_ns": offset, "solve": seq,
            "offset_drift_ns": offset_drift(device, launches, w0, w1),
            "linked_share": linked / busy if busy else None,
            "idle_s": idle / 1e9, "charged_s": (idle - outside) / 1e9,
            "outside_s": outside / 1e9, "by_name": by_name,
            "under": under, "counts": counts}


def table(ch: dict) -> str:
    """The charge as the lines logged beside the run's `trace:` line."""
    lines = [f"charge: clock offset {ch['offset_ns']} ns (card to host, "
             f"moving {ch['offset_drift_ns']} ns over the window); "
             f"linked {ch['linked_share']!r} of the window's device time; "
             f"solve {ch['solve']}; idle {ch['idle_s']!r} s = charged "
             f"{ch['charged_s']!r} + {OUTSIDE} {ch['outside_s']!r}"]
    for name, s in sorted(ch["by_name"].items(), key=lambda kv: -kv[1]):
        lines.append(f"charge:   {name:24s} {s!r} s "
                     f"({ch['counts'].get(name, 0)} spans)")
    return "\n".join(lines)


def _is_launch(e) -> bool:
    """A host record of a CUDA runtime or driver call (`cudaLaunchKernel`,
    `cudaMemcpyAsync`, `cuLaunchKernel`, ...).  The loading records the
    profiler nests in a first launch share its correlation id and are
    not calls."""
    return (not _on_device(e) and e.name().startswith("cu")
            and e.correlation_id() != 0)


class LaunchTrace(DeviceTrace):
    """`trace.DeviceTrace` that also keeps, from the same profiler, each
    device event with its correlation id (`linked`) and the host's launch
    records (`launches`): the profiler records them with the card's
    activity whether or not they are kept."""

    linked: Optional[List[tuple]] = None
    launches: Optional[List[tuple]] = None

    def __exit__(self, *exc):
        prof = self._prof
        out = super().__exit__(*exc)
        kineto = prof.profiler.kineto_results.events()
        self.linked = [(e.start_ns(), e.end_ns(), e.name(),
                        e.correlation_id()) for e in kineto if _on_device(e)]
        self.launches = [(e.start_ns(), e.end_ns(), e.name(),
                          e.correlation_id()) for e in kineto
                         if _is_launch(e)]
        return out


def setup_seconds(records: Sequence[dict], name: str) -> Optional[float]:
    """The summed seconds of the set-up's `name` spans."""
    spans = [r["dur_s"] for r in records or ()
             if r.get("type") == "span" and r.get("name") == name]
    return sum(spans) if spans else None


def idle_ms(ch: Optional[dict]) -> Dict[str, Optional[float]]:
    """`objective.idle_ms`: idle charged to `calculate` spans and the
    spans inside them, an evaluation; `rule.idle_ms`: idle charged to
    `step` spans' self time, an iteration (the traced solve's counts)."""
    counts = (ch or {}).get("counts") or {}
    calls, steps = counts.get("calculate"), counts.get("step")
    return {
        "objective.idle_ms": (ch["under"].get("calculate", 0.0) / calls
                              * 1e3 if calls else None),
        "rule.idle_ms": (ch["by_name"].get("step", 0.0) / steps * 1e3
                         if steps else None)}


def measure(config: dict, traffic: dict, seed: int, seconds: float,
            device) -> dict:
    """One traced run of a cell's configuration (module doc); on the CPU
    a rehearsal without a device trace."""
    import torch

    from . import run
    from .instance import instance, to_port_lp
    device = torch.device(device)
    cuda = device.type == "cuda"
    run.use_program()
    from repro_torch.obs.telemetry import ListSink, Telemetry
    if cuda:
        from repro_torch.kernels import _build
        _build.build()
    raw = instance(config["instance"], seed, device)
    lp = to_port_lp(raw, config["instance"]["min_width"])
    del raw
    setup = ListSink()
    tel = Telemetry(sink=setup, stream=io.StringIO())
    # a program without the current recorder records no set-up span
    with getattr(tel, "activate", contextlib.nullcontext)():
        obj = run.build_objective(config, lp)
    del lp
    rule, cfg = config["rule"], run.settings(config)

    def starts(k):
        return run.start(obj, traffic, seed, k, device)
    run.solve_once(obj, cfg, rule, starts(-1))
    sink = ListSink()
    tel = Telemetry(sink=sink, stream=io.StringIO())
    tracer = None
    if cuda:
        tracer = LaunchTrace(device)
        calculate = obj.calculate

        def traced_calculate(lam, gamma):
            tracer.enter()
            out = calculate(lam, gamma)
            tracer.exit()
            return out
        obj.calculate = traced_calculate
    win = run.window(obj, cfg, rule, seconds, starts, tel, tracer)
    ctx = {"solves": win["solves"], "records": sink.records,
           "trace": tracer.reduce() if tracer else None}
    ch = (charge_trace(tracer.linked, tracer.launches, sink.records)
          if tracer else None)
    metrics = {name: run.reader(name)(ctx) for name in (
        "engine.iters", "engine.host_ms", "objective.host_ms",
        "kernels.host_ms", "rule.host_ms", "objective.device_ms",
        "device.idle_share")}
    metrics.update({"setup.row_norm_s": setup_seconds(setup.records,
                                                      "row_norm"),
                    "setup.ax_plan_s": setup_seconds(setup.records,
                                                     "ax_plan")})
    metrics.update(idle_ms(ch))
    times = [s["seconds"] for s in win["solves"]]
    tr = ctx["trace"] or {}
    return {"metrics": metrics, "charge": ch,
            "trace_idle_s": (tr["window_s"] - tr["busy_s"]
                             if "busy_s" in tr else None),
            "marker_idle_gaps": tr.get("idle_gaps"),
            "evaluations_marked": len(tr.get("calculate_s") or ()),
            "solve_s": times, "raised": win["raised"],
            "device": torch.cuda.get_device_name(device) if cuda else "cpu"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from . import run
    _, cell, config, traffic = run.load_cell(args.workload)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        run.log(f"{args.workload} needs a CUDA card")
        return 2
    out = measure(config, traffic, args.seed, args.seconds, "cuda:0")
    if out["charge"] is not None:
        run.log(table(out["charge"]))
    out["workload"] = cell["name"]
    print(json.dumps(out), flush=True)
    return 0 if out["raised"] is None else 1


if __name__ == "__main__":
    sys.exit(main())
