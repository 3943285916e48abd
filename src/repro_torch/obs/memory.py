"""Host and device memory observation (DESIGN.md §13); the part of
`repro.obs.memory` that the serving frontend's gauges read.

  host_rss_bytes / host_peak_rss_bytes
      parsed from /proc/self/status (VmRSS / VmHWM) — no psutil.
      ``None`` on platforms without procfs.
  device_memory_stats
      the caching allocator's bytes on a CUDA device
      (``torch.cuda.memory_stats``) under the reference's keys; ``None``
      for a CPU device, which has no allocator stats.
  register_memory_gauges
      render-time ``repro_memory_*`` gauges on a metrics registry.

The sampler with its watermarks and the RSS guard (`MemorySampler`) and
the compiled-program estimate are not ported yet (ROADMAP queue A item
14).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

__all__ = ["host_rss_bytes", "host_peak_rss_bytes", "device_memory_stats",
           "register_memory_gauges"]

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
