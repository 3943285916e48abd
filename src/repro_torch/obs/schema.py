"""Run-log event schema + validation (DESIGN.md §11); port of
`repro.obs.schema`.  Every event type keeps the reference's required
fields except the manifest, whose environment stamp is torch's
(`torch_version`, `cuda_version`, `platform`, `device_count`), so the
serving events validate under both schemas.

A run log is a JSONL file of typed records.  Every record carries
`type` (one of EVENT_FIELDS) and `t` (seconds since the Telemetry was
constructed); each type additionally requires the fields named here.
Extra fields are always allowed — the schema pins the floor a consumer
(launch/report.py, the CI smoke) can rely on, not the ceiling.

Event taxonomy:

  manifest     run identity: run_id, environment, instance fingerprint,
               formulation/algorithm/γ-schedule/config.
               Emitted (merged) by Telemetry.manifest(); the LAST manifest
               record in a log is the most complete one.
  span         one wall-clock section: name, slash-joined nesting path,
               duration.  The engine emits trace/compile per runner build
               and execute/host per chunk; the server emits query spans.
  solve_start / solve_end   one solve's bracket records.
  check        one ConvergenceCheck (per-check host scalars, §4).
  gamma        a host-side γ-continuation move (stall decay or health
               backoff) — scheduled in-scan decays surface through the
               `gamma` field of check events instead.
  health       one HealthRecord incident (rollback / giveup, §9).
  checkpoint   a checkpoint flush accepted by the hook.
  resolve      an AllocationServer warm_resolve outcome
               (accept / reject / skipped).
  shed         the serving frontend refused admission to a request
               (queue full / estimated wait exceeds the deadline /
               draining) — the request got an immediate SHED response
               instead of unbounded queueing (DESIGN.md §12).
  timeout      an admitted request missed its deadline (expired in the
               queue or completed late) and was classified TIMEOUT.
  queue_depth  frontend queue depth at a batch flush (dispatch-loop
               backpressure signal; also mirrored as a gauge).
  drain        the frontend's graceful-drain summary: admissions stopped,
               in-flight batches flushed, `pending` requests left (0 on
               a clean drain).
  memory       one resource observation (obs/memory.py): host RSS and
               run-peak watermarks, plus device allocator bytes where
               the backend reports them (required fields are present
               but null on CPU, which exposes no allocator stats).
               The engine emits one per chunk boundary; extraction /
               certification emit per streaming chunk; the RSS soft
               guard emits one flagged `reason="rss_guard"`.
  metrics      a registry digest (MetricsRegistry.summary()): every
               family's type + per-series values or histogram
               count/sum/p50/p95/p99 — flushed at solve end and at
               frontend drain so post-mortem logs carry the same
               numbers the /metrics plane served live.
  log          one leveled console-logger line.
  counters     the aggregated counters/gauges, flushed by close().
  profile      profiler start/stop markers.
  event        generic escape hatch (no required fields).
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, Iterator, NamedTuple, Optional

__all__ = ["SchemaError", "EVENT_FIELDS", "validate_event", "iter_events",
           "load_run", "RunLog"]

EVENT_FIELDS: Dict[str, frozenset] = {
    "manifest": frozenset({"run_id", "torch_version", "cuda_version",
                           "platform", "device_count"}),
    "span": frozenset({"name", "path", "dur_s"}),
    "solve_start": frozenset({"algorithm", "iterations_cap"}),
    "solve_end": frozenset({"stop_reason", "iterations_run", "converged",
                            "wall_s"}),
    "check": frozenset({"it", "dual_obj", "rel_dual", "infeas", "grad_norm",
                        "gamma", "elapsed", "stalled"}),
    "gamma": frozenset({"it", "gamma_from", "gamma_to", "reason"}),
    "health": frozenset({"it", "status", "action", "retries"}),
    "checkpoint": frozenset({"it", "final"}),
    "resolve": frozenset({"outcome"}),
    "shed": frozenset({"reason"}),
    "timeout": frozenset({"waited_s", "deadline_s"}),
    "queue_depth": frozenset({"depth"}),
    "drain": frozenset({"pending"}),
    "memory": frozenset({"host_rss_bytes", "peak_rss_bytes",
                         "device_bytes_in_use", "device_peak_bytes",
                         "peak_hbm_bytes"}),
    "metrics": frozenset({"series"}),
    "log": frozenset({"level", "msg"}),
    "counters": frozenset({"counters", "gauges"}),
    "profile": frozenset({"action"}),
    "event": frozenset(),
}


class SchemaError(ValueError):
    """A run-log record violates the schema (names the offense and, when
    read from a file, the line number)."""


def validate_event(record: Any, where: str = "") -> Dict[str, Any]:
    """Validate one parsed record; returns it on success."""
    loc = f" ({where})" if where else ""
    if not isinstance(record, dict):
        raise SchemaError(f"record is not an object{loc}: {record!r}")
    etype = record.get("type")
    if etype not in EVENT_FIELDS:
        raise SchemaError(
            f"unknown event type {etype!r}{loc}; known: "
            f"{sorted(EVENT_FIELDS)}")
    if not isinstance(record.get("t"), (int, float)):
        raise SchemaError(f"event {etype!r} missing numeric 't'{loc}")
    missing = EVENT_FIELDS[etype] - record.keys()
    if missing:
        raise SchemaError(
            f"event {etype!r} missing required fields "
            f"{sorted(missing)}{loc}")
    return record


def iter_events(path: str) -> Iterator[Dict[str, Any]]:
    """Parse + validate a JSONL run log line by line.  Raises SchemaError
    naming the line for an unparseable or schema-violating record."""
    with open(path) as f:
        for ln, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                record = json.loads(line)
            except json.JSONDecodeError as e:
                raise SchemaError(
                    f"{path}:{ln}: not valid JSON ({e})") from e
            yield validate_event(record, where=f"{path}:{ln}")


class RunLog(NamedTuple):
    """A fully-loaded run log: the merged manifest (None when the log has
    no manifest record) and every event in file order."""

    manifest: Optional[Dict[str, Any]]
    events: tuple

    def by_type(self, etype: str) -> list:
        return [e for e in self.events if e["type"] == etype]


def load_run(path: str) -> RunLog:
    events = tuple(iter_events(path))
    manifest = None
    for e in events:  # last manifest record wins (merged re-emits)
        if e["type"] == "manifest":
            manifest = e
    return RunLog(manifest=manifest, events=events)


def validate_run(path: str, require_manifest: bool = True) -> RunLog:
    """Whole-file validation for the CI smoke: every record validates and
    (by default) a manifest is present."""
    run = load_run(path)
    if require_manifest and run.manifest is None:
        raise SchemaError(f"{path}: run log has no manifest record")
    return run
