"""AdamW + Adafactor, schedules, global-norm clipping; port of
`repro.optim.optimizers`.

Plain functions on dicts of tensors, not `torch.optim` classes, so each
update is the reference's arithmetic step for step: in float32, cast back
to each param's and state's dtype, returning new tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

F32 = torch.float32


class OptState(NamedTuple):
    count: torch.Tensor
    mu: Dict[str, torch.Tensor]      # AdamW: m;  Adafactor: row stats
    nu: Dict[str, torch.Tensor]      # AdamW: v;  Adafactor: col stats


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    """(grads scaled to a global norm of at most max_norm, the norm before
    scaling); the norm in float32, over the leaves in sorted path order."""
    gn = torch.sqrt(sum(g.to(F32).square().sum()
                        for _, g in sorted(grads.items())))
    scale = torch.clamp(max_norm / gn.clamp(min=1e-9), max=1.0)
    return {k: (g.to(F32) * scale).to(g.dtype)
            for k, g in grads.items()}, gn


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """lr(step): linear warm-up over `warmup` steps, then a cosine decay to
    0 at `total`; float32, as the reference's."""
    def lr(step):
        step = torch.as_tensor(step).to(F32)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr


def _count(params) -> torch.Tensor:
    dev = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=dev)


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: Optional[str] = "float32"   # bf16 for the largest models

    def init(self, params) -> OptState:
        dt = getattr(torch, self.state_dtype)

        def z():
            return {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                    for k, p in params.items()}
        return OptState(count=_count(params), mu=z(), nu=z())

    def update(self, grads, state: OptState, params, lr
               ) -> Tuple[Dict, OptState]:
        c = state.count + 1
        b1c = 1.0 - self.b1 ** c.to(F32)
        b2c = 1.0 - self.b2 ** c.to(F32)
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            gf = grads[k].to(F32)
            m, v = state.mu[k], state.nu[k]
            m_new = self.b1 * m.to(F32) + (1 - self.b1) * gf
            v_new = self.b2 * v.to(F32) + (1 - self.b2) * gf * gf
            step = (m_new / b1c) / (torch.sqrt(v_new / b2c) + self.eps)
            step = step + self.weight_decay * p.to(F32)
            new_p[k] = (p.to(F32) - lr * step).to(p.dtype)
            new_m[k] = m_new.to(m.dtype)
            new_v[k] = v_new.to(v.dtype)
        return new_p, OptState(count=c, mu=new_m, nu=new_v)


@dataclasses.dataclass(frozen=True)
class Adafactor:
    """Factored second moments: O(r+c) state per matrix instead of O(r·c) —
    the distributed-optimization memory trick for the largest models."""
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0

    def init(self, params) -> OptState:
        def rows(p):
            shape = p.shape if p.dim() < 2 else p.shape[:-1]
            return torch.zeros(shape, dtype=F32, device=p.device)

        def cols(p):
            shape = (1,) if p.dim() < 2 else p.shape[:-2] + p.shape[-1:]
            return torch.zeros(shape, dtype=F32, device=p.device)

        return OptState(count=_count(params),
                        mu={k: rows(p) for k, p in params.items()},
                        nu={k: cols(p) for k, p in params.items()})

    def update(self, grads, state: OptState, params, lr):
        c = state.count + 1
        beta = 1.0 - c.to(F32) ** (-self.decay)
        new_p, new_r, new_c = {}, {}, {}
        for k, p in params.items():
            r, col = state.mu[k], state.nu[k]
            gf = grads[k].to(F32)
            g2 = gf * gf + self.eps
            if p.dim() < 2:
                r_new = beta * r + (1 - beta) * g2
                update = gf / torch.sqrt(r_new + self.eps)
                col_new = col
            else:
                r_new = beta * r + (1 - beta) * g2.mean(-1)
                col_new = beta * col + (1 - beta) * g2.mean(-2)
                r_fac = r_new / torch.clamp(r_new.mean(-1, keepdim=True),
                                            min=self.eps)
                denom = (torch.sqrt(r_fac)[..., None]
                         * torch.sqrt(col_new)[..., None, :])
                update = gf / denom
            rms = torch.sqrt(torch.mean(update * update))
            update = update / torch.clamp(rms / self.clip_threshold, min=1.0)
            p_new = (p.to(F32) - lr * update
                     - lr * self.weight_decay * p.to(F32))
            new_p[k], new_r[k], new_c[k] = p_new.to(p.dtype), r_new, col_new
        return new_p, OptState(count=c, mu=new_r, nu=new_c)


def make_optimizer(name: str, **kw):
    if name == "adamw":
        return AdamW(**kw)
    if name == "adafactor":
        return Adafactor(**{k: v for k, v in kw.items()
                            if k != "state_dtype"})
    raise ValueError(name)
