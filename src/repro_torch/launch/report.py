"""Post-mortem renderer for telemetry run logs (DESIGN.md §11); port of
`repro.launch.report`.

    python -m repro_torch.launch.report run.jsonl [--json]

Reads a JSONL run log emitted via ``--log-jsonl`` (or any `JsonlSink`),
validates every record against the event schema, and renders the solve
post-mortem: the run manifest, the per-chunk execute / host wall-clock
split, every span name's count, total and self time (the objective's
`row_norm` and `ax_plan`, the engine's `solve`, `step` and `calculate`,
the kernel wrappers' `launch`), the convergence trajectory, γ-continuation moves, health
rollbacks, memory peaks, the launch census (`byte_census`) and final
counters.  The port traces and compiles no program, so its logs have no
`trace`/`compile` spans; a reference log's are still folded in.  Exits
1 on a schema violation or a missing manifest so CI can gate on log
integrity.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from repro_torch.obs import RunLog, SchemaError, load_run


# --------------------------------------------------------------------------
# summarize: RunLog -> plain dict (the --json payload)
# --------------------------------------------------------------------------

def _span_chunks(spans: List[dict]) -> Dict[int, Dict[str, float]]:
    """Fold span events into per-chunk {phase: seconds} rows.

    `trace`/`compile` spans carry no chunk index (they happen once per
    distinct chunk length, not per chunk) — they are folded into the
    chunk that was in flight when they fired, tracked positionally via
    the surrounding `execute` spans' chunk ids; standalone ones land in
    chunk 0.
    """
    chunks: Dict[int, Dict[str, float]] = {}
    pending: Dict[str, float] = {}
    for ev in spans:
        name = ev.get("name")
        dur = float(ev.get("dur_s", 0.0))
        if name in ("trace", "compile"):
            pending[name] = pending.get(name, 0.0) + dur
            continue
        if name not in ("execute", "host", "checkpoint"):
            continue
        idx = int(ev.get("chunk", ev.get("it", 0)) or 0)
        row = chunks.setdefault(idx, {})
        row[name] = row.get(name, 0.0) + dur
        if name == "execute" and pending:
            for k, v in pending.items():
                row[k] = row.get(k, 0.0) + v
            pending.clear()
    if pending:  # trace/compile with no execute span at all (fast path)
        row = chunks.setdefault(0, {})
        for k, v in pending.items():
            row[k] = row.get(k, 0.0) + v
    return chunks


def _span_names(spans: List[dict]) -> Dict[str, Dict[str, float]]:
    """Each span name's count, total seconds and self seconds (its
    duration less its child spans', by the `parent` ids; a log without
    ids gives self = total)."""
    inner: Dict[Any, float] = {}
    for ev in spans:
        if ev.get("parent") is not None:
            inner[ev["parent"]] = (inner.get(ev["parent"], 0.0)
                                   + float(ev.get("dur_s", 0.0)))
    rows: Dict[str, Dict[str, float]] = {}
    for ev in spans:
        dur = float(ev.get("dur_s", 0.0))
        row = rows.setdefault(ev["name"],
                              {"count": 0, "total_s": 0.0, "self_s": 0.0})
        row["count"] += 1
        row["total_s"] += dur
        row["self_s"] += dur - inner.get(ev.get("id"), 0.0)
    return rows


def summarize(run: RunLog) -> Dict[str, Any]:
    by: Dict[str, List[dict]] = {}
    for ev in run.events:
        by.setdefault(ev["type"], []).append(ev)
    spans = by.get("span", [])
    chunks = _span_chunks(spans)
    totals: Dict[str, float] = {}
    for row in chunks.values():
        for k, v in row.items():
            totals[k] = totals.get(k, 0.0) + v

    checks = by.get("check", [])
    traj: Dict[str, Any] = {"checks": len(checks)}
    if checks:
        last = checks[-1]
        traj.update(
            first_it=checks[0].get("it"), last_it=last.get("it"),
            final_dual_obj=last.get("dual_obj"),
            final_rel_dual=last.get("rel_dual"),
            final_infeas=last.get("infeas"),
            final_gamma=last.get("gamma"))

    mem_events = by.get("memory", [])
    memory: Dict[str, Any] = {}
    if mem_events or any(k in run.manifest
                         for k in ("peak_rss_bytes", "peak_hbm_bytes")):
        memory = {
            "samples": [
                {k: ev.get(k) for k in ("it", "chunk", "where", "reason",
                                        "host_rss_bytes",
                                        "device_bytes_in_use")
                 if ev.get(k) is not None}
                for ev in mem_events],
            "rss_guard_trips": sum(1 for ev in mem_events
                                   if ev.get("reason") == "rss_guard"),
            "peak_rss_bytes": run.manifest.get("peak_rss_bytes"),
            "peak_hbm_bytes": run.manifest.get("peak_hbm_bytes"),
            "compiled_peak_bytes": run.manifest.get("compiled_peak_bytes"),
        }

    # the flushed registry digest ("metrics" event): keep only histogram
    # families' summary stats — counters/gauges already render above from
    # the solve's own counters record, the histograms are the new signal
    metrics_ev = (by.get("metrics") or [{}])[-1]
    histograms: Dict[str, Any] = {}
    for fam, body in (metrics_ev.get("series") or {}).items():
        if isinstance(body, dict) and body.get("type") == "histogram":
            histograms[fam] = body.get("series", {})

    solve_end = (by.get("solve_end") or [{}])[-1]
    counters = (by.get("counters") or [{}])[-1]
    return {
        "manifest": run.manifest,
        "events_total": len(run.events),
        "solve": {
            "start": (by.get("solve_start") or [{}])[-1],
            "end": solve_end,
        },
        "chunks": {str(k): chunks[k] for k in sorted(chunks)},
        "span_totals": totals,
        "span_names": _span_names(spans),
        "trajectory": traj,
        "gamma_moves": [
            {k: ev.get(k) for k in ("it", "gamma_from", "gamma_to", "reason")}
            for ev in by.get("gamma", [])],
        "health_events": [
            {k: ev.get(k) for k in ("it", "status", "action", "retries")}
            for ev in by.get("health", [])],
        "checkpoints": len(by.get("checkpoint", [])),
        "resolves": [
            {k: ev.get(k) for k in ("outcome", "reason", "iterations")
             if k in ev}
            for ev in by.get("resolve", [])],
        "counters": counters.get("counters", {}),
        "gauges": counters.get("gauges", {}),
        "memory": memory,
        "histograms": histograms,
        "profile": [{k: ev.get(k) for k in ("action", "chunk", "trace_dir",
                                            "trace")
                     if k in ev}
                    for ev in by.get("profile", [])],
        "byte_census": run.manifest.get("byte_census"),
    }


# --------------------------------------------------------------------------
# render: summary dict -> human text
# --------------------------------------------------------------------------

def _fmt_s(v: Optional[float]) -> str:
    if v is None:
        return "-"
    return f"{v * 1e3:8.2f}ms" if v < 1.0 else f"{v:8.3f}s "


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def _fmt_bytes(v: Optional[float]) -> str:
    if v is None:
        return "-"
    v = float(v)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if v < 1024 or unit == "TiB":
            return f"{v:.0f}{unit}" if unit == "B" else f"{v:.1f}{unit}"
        v /= 1024
    return f"{v:.1f}TiB"


def render(summary: Dict[str, Any]) -> str:
    out: List[str] = []
    man = summary["manifest"]
    out.append("== run manifest ==")
    for k in sorted(man):
        if k != "byte_census":
            out.append(f"  {k:24s} {_fmt(man[k])}")

    solve = summary["solve"]
    if solve["start"] or solve["end"]:
        out.append("== solve ==")
        for k, v in sorted({**solve["start"], **solve["end"]}.items()):
            if k not in ("type", "t"):
                out.append(f"  {k:24s} {_fmt(v)}")

    chunks = summary["chunks"]
    if chunks:
        out.append("== per-chunk wall-clock split ==")
        seen = {k for row in chunks.values() for k in row}
        phases = [p for p in ("trace", "compile", "execute", "host",
                              "checkpoint") if p in seen]
        out.append("  chunk  " + "".join(f"{p:>11s}" for p in phases))
        for idx in sorted(chunks, key=int):
            row = chunks[idx]
            out.append(f"  {idx:>5s}  " + "".join(
                f"{_fmt_s(row.get(p)):>11s}" for p in phases))
        tot = summary["span_totals"]
        out.append("  total  " + "".join(
            f"{_fmt_s(tot.get(p)):>11s}" for p in phases))

    names = summary.get("span_names") or {}
    if names:
        out.append("== spans by name ==")
        out.append(f"  {'name':16s} {'count':>8s} {'total':>11s} "
                   f"{'self':>11s}")
        for name in sorted(names, key=lambda n: -names[n]["total_s"]):
            row = names[name]
            out.append(f"  {name:16s} {row['count']:>8d} "
                       f"{_fmt_s(row['total_s']):>11s} "
                       f"{_fmt_s(row['self_s']):>11s}")

    traj = summary["trajectory"]
    out.append(f"== trajectory ({traj['checks']} convergence checks) ==")
    for k in ("first_it", "last_it", "final_dual_obj", "final_rel_dual",
              "final_infeas", "final_gamma"):
        if k in traj and traj[k] is not None:
            out.append(f"  {k:24s} {_fmt(traj[k])}")

    for key, title in (("gamma_moves", "gamma continuation"),
                       ("health_events", "health"),
                       ("resolves", "warm resolves"),
                       ("profile", "profiler")):
        rows = summary[key]
        if rows:
            out.append(f"== {title} ({len(rows)}) ==")
            for r in rows:
                out.append("  " + "  ".join(
                    f"{k}={_fmt(v)}" for k, v in r.items() if v is not None))

    if summary["checkpoints"]:
        out.append(f"== checkpoints: {summary['checkpoints']} flushes ==")

    mem = summary.get("memory") or {}
    if mem:
        n = len(mem.get("samples") or [])
        out.append(f"== memory timeline ({n} samples) ==")
        peak = mem.get("peak_rss_bytes")
        scale = max([peak or 0] + [s.get("host_rss_bytes") or 0
                                   for s in mem.get("samples") or []])
        for s in mem.get("samples") or []:
            rss = s.get("host_rss_bytes")
            dev = s.get("device_bytes_in_use")
            bar = ("#" * max(1, round(30 * rss / scale))
                   if rss and scale else "")
            flag = " !rss-guard" if s.get("reason") == "rss_guard" else ""
            where = s.get("where") or ("chunk" if "chunk" in s else "?")
            out.append(
                f"  {where:>8s} it {s.get('it', '-')!s:>8s}  "
                f"rss {_fmt_bytes(rss):>10s}  "
                f"dev {_fmt_bytes(dev):>10s}  {bar}{flag}")
        for k in ("peak_rss_bytes", "peak_hbm_bytes", "compiled_peak_bytes"):
            if mem.get(k) is not None:
                out.append(f"  {k:24s} {_fmt_bytes(mem[k])}")
        if mem.get("rss_guard_trips"):
            out.append(f"  rss_guard_trips          {mem['rss_guard_trips']}")

    census = summary.get("byte_census")
    if census:
        out.append(f"== byte census (one evaluation, "
                   f"{census.get('ax_mode', '?')}) ==")
        for name, row in (census.get("kernels") or {}).items():
            out.append(f"  {name:24s} {_fmt_bytes(row.get('bytes')):>10s}  "
                       f"{_fmt(row.get('flops'))} flops")
        for k in ("bytes_per_iteration", "flops_per_iteration",
                  "collective_bytes_per_iteration"):
            if census.get(k) is not None:
                out.append(f"  {k:32s} {_fmt(census[k])}")

    if summary.get("histograms"):
        out.append("== latency histograms ==")
        for fam in sorted(summary["histograms"]):
            out.append(f"  {fam}")
            for labels, stats in sorted(summary["histograms"][fam].items()):
                if not isinstance(stats, dict):
                    continue
                out.append(
                    f"    {labels or '(all)':20s} "
                    f"n={stats.get('count', 0):<8d} "
                    f"mean={_fmt(stats.get('mean'))}s "
                    f"p50={_fmt(stats.get('p50'))}s "
                    f"p95={_fmt(stats.get('p95'))}s "
                    f"p99={_fmt(stats.get('p99'))}s")

    if summary["counters"] or summary["gauges"]:
        out.append("== counters ==")
        for k in sorted(summary["counters"]):
            out.append(f"  {k:24s} {summary['counters'][k]}")
        for k in sorted(summary["gauges"]):
            out.append(f"  {k:24s} {_fmt(summary['gauges'][k])} (gauge)")

    out.append(f"== {summary['events_total']} events total ==")
    return "\n".join(out)


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.report",
        description="Render a post-mortem from a telemetry JSONL run log.")
    ap.add_argument("path", help="run log written via --log-jsonl")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as JSON instead of text")
    args = ap.parse_args(argv)

    try:
        run = load_run(args.path)
    except (SchemaError, OSError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if not run.manifest:
        print(f"error: {args.path}: no manifest record in run log",
              file=sys.stderr)
        return 1

    summary = summarize(run)
    if args.json:
        print(json.dumps(summary, indent=2, sort_keys=True))
    else:
        print(render(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
