"""Host and device memory observation (DESIGN.md §13); the part of
`repro.obs.memory` that the serving frontend's gauges read.

  host_rss_bytes / host_peak_rss_bytes
      parsed from /proc/self/status (VmRSS / VmHWM) — no psutil.
      ``None`` on platforms without procfs.
  device_memory_stats
      the caching allocator's bytes on a CUDA device
      (``torch.cuda.memory_stats``) under the reference's keys; ``None``
      for a CPU device, which has no allocator stats.
  compiled_memory_estimate
      per-runner estimate of a chunk's memory.  Eager PyTorch compiles no
      program to read, so it is the launch census's count of what a chunk
      holds (`launch/census.py::runner_memory`): its arguments, its
      outputs and the evaluation's scratch.
  register_memory_gauges
      render-time ``repro_memory_*`` gauges on a metrics registry.
  MemorySampler
      stateful watermark tracker: ``sample()`` reads host+device, updates
      peak-RSS/peak-HBM highs, mirrors gauges into a metrics registry,
      emits the leveled warning + ``memory`` event when host RSS crosses
      the configured soft bound (``launch/solve.py --max-host-rss-mb``),
      and hands the engine the fields for its per-chunk ``memory``
      events.

House standard: a ``sampler=None`` default everywhere means zero reads,
zero events, zero gauges — the unsampled solve path stays bitwise
identical (tests/test_torch_memory_obs.py).

The device peak is the caching allocator's ``allocated_bytes.all.peak``:
it runs from the start of the process or from the caller's last
``torch.cuda.reset_peak_memory_stats()``.  Nothing here resets it, since
another thread (a server's) may be reading it.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, NamedTuple, Optional

import torch

__all__ = ["host_rss_bytes", "host_peak_rss_bytes", "device_memory_stats",
           "compiled_memory_estimate", "register_memory_gauges",
           "MemorySample", "MemorySampler"]

_PROC_STATUS = "/proc/self/status"


def _proc_status_kb(key: str) -> Optional[int]:
    try:
        with open(_PROC_STATUS) as f:
            for line in f:
                if line.startswith(key + ":"):
                    return int(line.split()[1])  # value is in kB
    except (OSError, ValueError, IndexError):
        return None
    return None


def host_rss_bytes() -> Optional[int]:
    """Current resident set size of this process, or None off-Linux."""
    kb = _proc_status_kb("VmRSS")
    return kb * 1024 if kb is not None else None


def host_peak_rss_bytes() -> Optional[int]:
    """Process-lifetime peak RSS (VmHWM), or None off-Linux."""
    kb = _proc_status_kb("VmHWM")
    return kb * 1024 if kb is not None else None


def device_memory_stats(device: Any = None) -> Optional[Dict[str, int]]:
    """The caching allocator's stats of one CUDA device under the
    reference's keys: ``bytes_in_use`` (allocated now),
    ``peak_bytes_in_use`` (allocated at peak) and ``bytes_limit`` (the
    card's memory).

    `device` None means the current CUDA device when there is a card.
    Returns None for a CPU device, or with no card.
    """
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(
            torch.cuda.get_device_properties(device).total_memory),
    }


def compiled_memory_estimate(obj: Any, state: Any,
                             length: int = 1) -> Optional[Dict[str, Any]]:
    """Memory estimate for one chunk runner of `length` steps over the
    objective `obj` from the solver state `state`: ``argument_bytes``
    (the objective's resident tensors and the state), ``output_bytes``
    (the new state and the chunk's stats), ``temp_bytes`` (the
    evaluation's buffers and scratch), ``source="launch_census"``.
    Counted from tensor shapes alone (no device read).  Returns None
    where it cannot count (an objective the census does not know) —
    never raises."""
    from ..launch import census    # launch imports obs
    return census.runner_memory(obj, state, length)


def register_memory_gauges(registry: Any, device: Any = None) -> None:
    """Register render-time memory gauges on `registry`.

    ``repro_memory_host_rss_bytes`` / ``repro_memory_host_peak_rss_bytes``
    read procfs at scrape time; ``repro_memory_device_bytes_in_use`` /
    ``repro_memory_device_peak_bytes`` read `device`'s allocator (0 for a
    CPU device — the series still exists so dashboards don't gap across
    platforms).
    """
    registry.gauge(
        "repro_memory_host_rss_bytes",
        "Current host RSS of the serving/solve process (VmRSS)."
    ).set_function(lambda: float(host_rss_bytes() or 0))
    registry.gauge(
        "repro_memory_host_peak_rss_bytes",
        "Process-lifetime peak host RSS (VmHWM)."
    ).set_function(lambda: float(host_peak_rss_bytes() or 0))

    def _dev(key: str) -> float:
        stats = device_memory_stats(device)
        return float(stats.get(key, 0)) if stats else 0.0

    registry.gauge(
        "repro_memory_device_bytes_in_use",
        "Device allocator bytes in use (0 where the backend reports "
        "no stats, e.g. CPU)."
    ).set_function(lambda: _dev("bytes_in_use"))
    registry.gauge(
        "repro_memory_device_peak_bytes",
        "Device allocator peak bytes in use (0 where unavailable)."
    ).set_function(lambda: _dev("peak_bytes_in_use"))


class MemorySample(NamedTuple):
    """One observation: instantaneous values plus watermark highs as of
    this sample.  Device fields are None off the card — consumers must
    treat them as nullable."""

    unix_time: float
    host_rss_bytes: Optional[int]
    device_bytes_in_use: Optional[int]
    device_peak_bytes: Optional[int]
    peak_rss_bytes: Optional[int]
    peak_hbm_bytes: Optional[int]
    rss_guard_exceeded: bool


class MemorySampler:
    """Watermark-tracking resource sampler (thread-safe).

    One sampler spans one logical run: the engine samples at every chunk
    boundary, extraction/certification sample per streaming chunk, and
    `watermarks()` yields the run-level peaks the engine stamps into the
    manifest.  With `registry` set, the ``repro_memory_*`` gauges are
    registered on it; with `telemetry` + `max_host_rss_bytes` set, the
    first sample over the bound emits a warning log record and a
    ``memory`` event flagged ``reason="rss_guard"`` (re-armed once RSS
    drops 5% under the bound).  `device` is the card whose allocator is
    read (None: the current card, when there is one).
    """

    def __init__(self, registry: Any = None, telemetry: Any = None,
                 max_host_rss_bytes: Optional[int] = None,
                 device: Any = None) -> None:
        self._lock = threading.Lock()
        self._device = device
        self._registry = registry
        self._telemetry = telemetry
        self.max_host_rss_bytes = max_host_rss_bytes
        self._guard_armed = True
        self._samples = 0
        self._peak_rss: Optional[int] = None
        self._peak_hbm: Optional[int] = None
        self._compiled_peak: Optional[int] = None
        if registry is not None:
            register_memory_gauges(registry, device=device)

    def sample(self, where: str = "", it: Optional[int] = None
               ) -> MemorySample:
        """Read host+device, update watermarks, run the RSS soft guard.

        `where`/`it` only annotate the guard's emitted event; the caller
        composes its own per-chunk ``memory`` event from the returned
        sample (see SolveEngine).
        """
        rss = host_rss_bytes()
        dev = device_memory_stats(self._device)
        in_use = dev.get("bytes_in_use") if dev else None
        dev_peak = dev.get("peak_bytes_in_use", in_use) if dev else None
        with self._lock:
            self._samples += 1
            if rss is not None:
                self._peak_rss = max(self._peak_rss or 0, rss)
            hbm_high = dev_peak if dev_peak is not None else in_use
            if hbm_high is not None:
                self._peak_hbm = max(self._peak_hbm or 0, hbm_high)
            exceeded = (self.max_host_rss_bytes is not None
                        and rss is not None
                        and rss > self.max_host_rss_bytes)
            fire_guard = exceeded and self._guard_armed
            if fire_guard:
                self._guard_armed = False
            elif (not exceeded and not self._guard_armed
                  and self.max_host_rss_bytes is not None
                  and rss is not None
                  and rss < 0.95 * self.max_host_rss_bytes):
                self._guard_armed = True
            peak_rss, peak_hbm = self._peak_rss, self._peak_hbm
        s = MemorySample(unix_time=time.time(), host_rss_bytes=rss,
                         device_bytes_in_use=in_use,
                         device_peak_bytes=dev_peak,
                         peak_rss_bytes=peak_rss,
                         peak_hbm_bytes=peak_hbm,
                         rss_guard_exceeded=exceeded)
        tel = self._telemetry
        if fire_guard and tel is not None and getattr(tel, "enabled", False):
            mb = rss / 2**20
            cap = self.max_host_rss_bytes / 2**20
            tel.warning(
                f"host RSS {mb:.0f} MiB exceeds --max-host-rss-mb "
                f"{cap:.0f} MiB{f' at {where}' if where else ''}")
            tel.event("memory", reason="rss_guard", where=where, it=it,
                      max_host_rss_bytes=self.max_host_rss_bytes,
                      **self.event_fields(s))
        return s

    def note_compiled(self, est: Optional[Dict[str, Any]]) -> None:
        """Fold one runner's memory estimate into the run peak
        (`manifest.compiled_peak_bytes` = max over runners)."""
        if not est:
            return
        total = sum(int(v) for k, v in est.items()
                    if k.endswith("_bytes") and isinstance(v, (int, float)))
        if total:
            with self._lock:
                self._compiled_peak = max(self._compiled_peak or 0, total)

    @staticmethod
    def event_fields(s: MemorySample) -> Dict[str, Any]:
        """The schema-required `memory` event fields for one sample."""
        return {"host_rss_bytes": s.host_rss_bytes,
                "device_bytes_in_use": s.device_bytes_in_use,
                "device_peak_bytes": s.device_peak_bytes,
                "peak_rss_bytes": s.peak_rss_bytes,
                "peak_hbm_bytes": s.peak_hbm_bytes}

    def watermarks(self) -> Dict[str, Any]:
        """Run-level peaks (manifest stamp + result fields)."""
        with self._lock:
            return {"peak_rss_bytes": self._peak_rss,
                    "peak_hbm_bytes": self._peak_hbm,
                    "compiled_peak_bytes": self._compiled_peak,
                    "memory_samples": self._samples}
