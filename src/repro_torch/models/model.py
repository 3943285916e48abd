"""build_model(config) — one façade over the zoo; port of
`repro.models.model`.

`Model` is an `nn.Module` whose parameters are registered under the
reference's `param_defs()` paths ("blk0/attn/wq", "dec/cross/wk", ...), so
the reference's weights carry across as a copy by name
(`convert.lm_params_from_numpy`).  It keeps the reference's functional
surface, the params passed in:

  param_defs()                  single source of truth (shape/dtype/logical)
  init(generator)               draw the params on the generator's device
  abstract_params()             `meta` stand-ins (no storage)
  param_pspecs()                specs under the active mesh rules
  loss(params, batch)           train objective (next-token xent [+ moe aux])
  prefill(params, batch)        full-context forward -> last-position logits
  decode_step(params, caches, tokens, pos)
  cache_shapes(batch, seq_len, src_len=4096) / cache_pspecs()
  zero_caches(batch, seq_len, device, src_len=4096)
  input_specs(shape_cell) / input_pspecs(shape_cell)
                                the dry run's input stand-ins and specs

A model is built on the meta device (no storage) until `init` or
`load_params` gives it tensors.  The registered parameters take no
gradient: serving runs under `inference_mode`, and training
(`training.trainer`) takes the gradient of `loss` with respect to leaves
of its own.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch
from torch import nn

from .. import sharding
from . import encdec, layers, transformer
from .config import ModelConfig, ShapeCell


def param_defs(cfg: ModelConfig) -> layers.ParamDefs:
    """Every param's path, shape, dtype and init scale, for any family."""
    if cfg.is_encdec:
        return encdec.encdec_param_defs(cfg)
    return transformer.lm_param_defs(cfg)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, moe_impl: str = "einsum"):
        super().__init__()
        self.cfg = cfg
        self.moe_impl = moe_impl
        for path, d in self.param_defs().items():
            self.register_parameter(path, nn.Parameter(
                torch.empty(d.shape, dtype=d.dtype, device="meta"),
                requires_grad=False))

    # -- params ------------------------------------------------------------
    def param_defs(self) -> layers.ParamDefs:
        return param_defs(self.cfg)

    def abstract_params(self) -> Dict[str, torch.Tensor]:
        return layers.abstract_params(self.param_defs())

    def param_pspecs(self) -> Dict[str, sharding.Spec]:
        return layers.param_pspecs(self.param_defs())

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

    @property
    def use_rope(self) -> bool:
        # jamba-style hybrids rely on mamba for position; no rope there
        return self.cfg.family != "hybrid"

    # -- training ----------------------------------------------------------
    def loss(self, params, batch) -> torch.Tensor:
        if self.cfg.is_encdec:
            return encdec.encdec_loss(self.cfg, params, batch)
        return transformer.lm_loss(self.cfg, params, batch,
                                   moe_impl=self.moe_impl,
                                   use_rope=self.use_rope)

    # -- serving -----------------------------------------------------------
    def prefill(self, params, batch) -> torch.Tensor:
        cfg = self.cfg
        if cfg.is_encdec:
            memory = encdec.encode(cfg, params, batch["frames"])
            h = encdec.decode_train(cfg, params, batch["tokens"], memory)
            h = layers.rms_norm(h[:, -1, :], params["final_norm"],
                                cfg.norm_eps)
            return layers.logits_last(cfg, params, h)
        patches = (batch.get("patches") if cfg.frontend == "patches"
                   else None)
        return transformer.lm_prefill(cfg, params, batch["tokens"],
                                      moe_impl=self.moe_impl,
                                      use_rope=self.use_rope,
                                      patches=patches)

    def decode_step(self, params, caches, tokens, pos):
        if self.cfg.is_encdec:
            return encdec.encdec_decode_step(self.cfg, params, caches,
                                             tokens, pos)
        return transformer.lm_decode_step(self.cfg, params, caches, tokens,
                                          pos, moe_impl=self.moe_impl,
                                          use_rope=self.use_rope)

    def cache_shapes(self, batch: int, seq_len: int, src_len: int = 4096):
        if self.cfg.is_encdec:
            return encdec.encdec_cache_shapes(self.cfg, batch, seq_len,
                                              src_len)
        return transformer.lm_cache_shapes(self.cfg, batch, seq_len)

    def cache_pspecs(self):
        if self.cfg.is_encdec:
            return encdec.encdec_cache_pspecs(self.cfg)
        return transformer.lm_cache_pspecs(self.cfg)

    # -- dry-run input stand-ins -------------------------------------------
    def input_specs(self, cell: ShapeCell) -> Dict[str, object]:
        """`layers.ShapeDtype` stand-ins for every model input of a cell.

        train:   {tokens, labels [, frames | patches]}
        prefill: {tokens [, frames | patches]}
        decode:  {tokens (B,1), pos, caches}
        """
        B, S = cell.global_batch, cell.seq_len
        i32 = torch.int32
        cfg = self.cfg
        sd = layers.ShapeDtype
        if cell.kind in ("train", "prefill"):
            if cfg.is_encdec:
                # split the cell's seq budget: half frames, half tokens
                s_src, s_tgt = S // 2, S // 2
                specs = {"frames": sd((B, s_src, cfg.d_model), cfg.cdtype),
                         "tokens": sd((B, s_tgt), i32)}
                if cell.kind == "train":
                    specs["labels"] = sd((B, s_tgt), i32)
                return specs
            specs = {"tokens": sd((B, S), i32)}
            if cfg.frontend == "patches":
                # vlm stub: patch embeddings prepended; token budget reduced
                P = cfg.n_frontend_tokens
                specs["tokens"] = sd((B, S - P), i32)
                specs["patches"] = sd((B, P, cfg.d_model), cfg.cdtype)
            if cell.kind == "train":
                specs["labels"] = sd((B, specs["tokens"].shape[1]), i32)
            return specs
        # decode: one new token against a seq_len cache
        return {"tokens": sd((B, 1), i32), "pos": sd((), i32),
                "caches": self.cache_shapes(B, S, src_len=4096)}

    def input_pspecs(self, cell: ShapeCell):
        """Specs mirroring `input_specs` (under the active mesh rules)."""
        sp = sharding.spec_for
        if cell.kind in ("train", "prefill"):
            specs = {"tokens": sp(("batch", "seq"))}
            if self.cfg.is_encdec:
                specs["frames"] = sp(("batch", "seq", None))
            if self.cfg.frontend == "patches":
                specs["patches"] = sp(("batch", None, None))
            if cell.kind == "train":
                specs["labels"] = sp(("batch", "seq"))
            return specs
        return {"tokens": sp(("cache_batch", None)), "pos": (),
                "caches": self.cache_pspecs()}

    def zero_caches(self, batch: int, seq_len: int, device,
                    src_len: int = 4096):
        """Caches of `cache_shapes(batch, seq_len, src_len)` on `device`,
        zeroed (mamba's `ssm` state in float32)."""
        return layers.zeros_like_shapes(
            self.cache_shapes(batch, seq_len, src_len), device)


def build_model(cfg: ModelConfig, moe_impl: str = "einsum") -> Model:
    return Model(cfg, moe_impl)
