"""Optimizers (counterpart of `repro.optim`): AdamW and Adafactor,
functional style — `init(params) -> state`, `update(grads, state, params,
lr) -> (new_params, new_state)` — with configurable state dtype so the
largest models can keep m/v in bfloat16."""
from .optimizers import (AdamW, Adafactor, OptState, clip_by_global_norm,
                         cosine_schedule, make_optimizer)

__all__ = ["AdamW", "Adafactor", "OptState", "clip_by_global_norm",
           "cosine_schedule", "make_optimizer"]
