"""Batched serving engine: decode steps over a request queue with a
fixed-capacity KV cache; port of `repro.serving.engine`.

Request queue -> batch assembly (padded to the engine's batch), greedy or
temperature sampling, per-sequence stop handling.  Every step is one
`decode_step` for the whole batch and one host read of its sampled tokens.
The caches are allocated once and zeroed in place for every batch.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new: int = 16
    out: Optional[List[int]] = None


class Engine:
    def __init__(self, model, params, batch: int, max_seq: int,
                 temperature: float = 0.0, seed: int = 0):
        self.model = model
        self.params = params
        self.batch = batch
        self.max_seq = max_seq
        self.temperature = temperature
        self.device = next(iter(params.values())).device
        # sampling's stream is torch's, not jax.random.categorical's
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.caches = model.zero_caches(batch, max_seq, self.device)
        self.steps = 0              # decode steps run, all batches
        self.step_seconds = 0.0     # their host time, each ending in a read

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0]

    def generate(self, requests: List[Request]) -> List[Request]:
        """Serve a list of requests in fixed-size batches.  The prompt runs
        as decode steps too, one token a step (correct and simple)."""
        out: List[Request] = []
        with torch.inference_mode():
            for i in range(0, len(requests), self.batch):
                out.extend(self._generate_batch(requests[i:i + self.batch]))
        return out

    def _generate_batch(self, requests: List[Request]) -> List[Request]:
        """Each sequence switches from its own prompt to its own generated
        continuation the moment its prompt ends — no pad tokens ever enter
        a cache, so outputs are independent of batch composition."""
        B = self.batch
        reqs = list(requests) + [Request(prompt=[0], max_new=0)
                                 for _ in range(B - len(requests))]
        for layer in self.caches:
            for t in layer.values():
                t.zero_()
        lens = [len(r.prompt) for r in reqs]
        total = max(l + r.max_new for l, r in zip(lens, reqs))
        outs = [[] for _ in range(B)]
        cur = np.array([r.prompt[0] for r in reqs], np.int64)
        for t in range(total - 1):
            t0 = time.perf_counter()
            tokens = torch.from_numpy(cur).to(self.device)[:, None]
            logits, _ = self.model.decode_step(self.params, self.caches,
                                               tokens, t)
            nxt = self._sample(logits).cpu().numpy()   # the step's one read
            self.step_seconds += time.perf_counter() - t0
            self.steps += 1
            for b, r in enumerate(reqs):
                if t + 1 < lens[b]:
                    cur[b] = r.prompt[t + 1]          # still in prompt
                else:
                    cur[b] = nxt[b]                   # own continuation
                    if len(outs[b]) < r.max_new:
                        outs[b].append(int(nxt[b]))
        for r, o in zip(reqs, outs):
            r.out = o[:r.max_new]
        return reqs[:len(requests)]
