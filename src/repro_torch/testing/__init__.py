"""Fault injectors for the fault-tolerance path (counterpart of
`repro.testing`; DESIGN.md §9).  Test-only: no production path imports
it.  `ExplodingObjective` and `SlowObjective` serve the server and come
with it (ROADMAP queue A item 13)."""
from .faults import (ChunkFaultInjector, NaNInjectingObjective,
                     PreemptAfter, corrupt_checkpoint, litter_tmp)

__all__ = ["NaNInjectingObjective", "ChunkFaultInjector", "PreemptAfter",
           "corrupt_checkpoint", "litter_tmp"]
