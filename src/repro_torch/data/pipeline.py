"""Deterministic synthetic data pipeline with checkpointable iterator state;
the port's own copy of `repro.data.pipeline` (numpy only), whose batches
equal the reference's bit for bit.

Every batch is a pure function of (seed, step, global_example_index), so:
  * restart-from-checkpoint replays the exact stream (state = one int);
  * each data shard generates ONLY its slice, bit-identically to slicing the
    global batch (no host-0 scatter — same design as the LP instance
    generator, DESIGN.md §2);
  * elastic re-sharding is free: the mapping example->shard is
    index-arithmetic, not RNG-state.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class TokenStream:
    vocab: int
    batch: int              # global batch
    seq_len: int
    seed: int = 0
    shard: Tuple[int, int] = (0, 1)   # (shard_id, num_shards)
    step: int = 0           # iterator state (checkpointed)
    frontend: Optional[str] = None    # "frames" | "patches" stubs
    n_frontend: int = 0
    d_model: int = 0

    def __post_init__(self):
        if self.batch % self.shard[1]:
            raise ValueError(f"batch {self.batch} does not split over "
                             f"{self.shard[1]} shards")

    @property
    def local_batch(self) -> int:
        return self.batch // self.shard[1]

    def _example(self, step: int, idx: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, step, idx))
        # zipf-ish skewed token distribution, deterministic per (step, idx)
        u = rng.random(self.seq_len + 1)
        toks = (self.vocab * u ** 2.0).astype(np.int32) % self.vocab
        return toks

    def next(self) -> Dict[str, np.ndarray]:
        k, n = self.shard
        lb = self.local_batch
        idxs = [k * lb + i for i in range(lb)]
        toks = np.stack([self._example(self.step, i) for i in idxs])
        batch = {"tokens": toks[:, :-1].astype(np.int32),
                 "labels": toks[:, 1:].astype(np.int32)}
        if self.frontend in ("frames", "patches"):
            rng = np.random.default_rng((self.seed, self.step, 10**9))
            key = "frames" if self.frontend == "frames" else "patches"
            batch[key] = rng.standard_normal(
                (lb, self.n_frontend, self.d_model)).astype(np.float32)
        self.step += 1
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next()

    # -- checkpointable state -------------------------------------------
    def state(self) -> Dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: Dict) -> None:
        if state["seed"] != self.seed:
            raise ValueError(f"stream seed mismatch: checkpoint "
                             f"{state['seed']}, stream {self.seed}")
        self.step = int(state["step"])
