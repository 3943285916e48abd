"""Fault injectors for the fault-tolerance and serving paths (counterpart
of `repro.testing`; DESIGN.md §9, §12).  Test-only: no production path
imports it."""
from .faults import (ChunkFaultInjector, ExplodingObjective,
                     NaNInjectingObjective, PreemptAfter, SlowObjective,
                     corrupt_checkpoint, litter_tmp)

__all__ = ["NaNInjectingObjective", "ChunkFaultInjector",
           "ExplodingObjective", "SlowObjective", "PreemptAfter",
           "corrupt_checkpoint", "litter_tmp"]
