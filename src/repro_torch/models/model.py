"""build_model(config) — the serving façade over the dense decoders; port of
`repro.models.model`.

`Model` is an `nn.Module` whose parameters are registered under the
reference's `param_defs()` paths ("blk0/attn/wq", ...), so the reference's
weights carry across as a copy by name (`convert.lm_params_from_numpy`).
It keeps the reference's functional surface, the params passed in:

  param_defs()                  single source of truth (shape/dtype/logical)
  init(generator)               draw the params on the generator's device
  prefill(params, batch)        full-context forward -> last-position logits
  decode_step(params, caches, tokens, pos)
  cache_shapes(batch, seq_len)
  zero_caches(batch, seq_len, device)

A model is built on the meta device (no storage) until `init` or
`load_params` gives it tensors.  Configs with MoE, mamba, encoder–decoder
or a frontend raise `NotImplementedError` (ROADMAP item 16).
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch import nn

from . import layers, transformer
from .config import ModelConfig


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        for path, d in self.param_defs().items():
            self.register_parameter(path, nn.Parameter(
                torch.empty(d.shape, dtype=d.dtype, device="meta"),
                requires_grad=False))

    # -- params ------------------------------------------------------------
    def param_defs(self) -> layers.ParamDefs:
        return transformer.lm_param_defs(self.cfg)

    def params(self) -> Dict[str, torch.Tensor]:
        """The registered params by path."""
        return {path: p for path, p in self.named_parameters()}

    def load_params(self, params: Mapping[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """Take `params` (every path of `param_defs()`, each of its shape
        and dtype) as the model's own, without a copy."""
        defs = self.param_defs()
        if set(params) != set(defs):
            raise KeyError(f"params differ from param_defs(): missing "
                           f"{sorted(set(defs) - set(params))}, extra "
                           f"{sorted(set(params) - set(defs))}")
        for path, d in defs.items():
            t = params[path]
            if tuple(t.shape) != tuple(d.shape) or t.dtype != d.dtype:
                raise ValueError(f"{path}: {tuple(t.shape)} {t.dtype}, "
                                 f"want {d.shape} {d.dtype}")
            setattr(self, path, nn.Parameter(t, requires_grad=False))
        return self.params()

    def init(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Draw every param on the generator's device (`layers.init_params`)
        and return them by path."""
        return self.load_params(layers.init_params(self.param_defs(),
                                                   generator))

    # -- serving -----------------------------------------------------------
    def prefill(self, params, batch) -> torch.Tensor:
        return transformer.lm_prefill(self.cfg, params, batch["tokens"])

    def decode_step(self, params, caches, tokens, pos):
        return transformer.lm_decode_step(self.cfg, params, caches, tokens,
                                          pos)

    def cache_shapes(self, batch: int, seq_len: int):
        return transformer.lm_cache_shapes(self.cfg, batch, seq_len)

    def zero_caches(self, batch: int, seq_len: int, device):
        """Caches of `cache_shapes(batch, seq_len)` on `device`, zeroed."""
        return tuple({k: torch.zeros(s.shape, dtype=s.dtype, device=device)
                      for k, s in layer.items()}
                     for layer in self.cache_shapes(batch, seq_len))


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
