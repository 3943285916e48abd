"""The port's Mamba2 SSD layer (`repro_torch.models.mamba`) and the ssm and
hybrid configs against the JAX package's.

On seeded inputs with the reference's `init_params` carried across (the
reference oracle tests' layer: d_model 64, state 8, heads of 8, chunk 4):
the chunked SSD is the same function at chunk 4, 8 and 16 (atol 2e-4, the
reference test's), and equals the step recurrence run over every position
(atol 3e-4, the reference test's); `mamba_apply` and 12 steps of
`mamba_decode_step` (output and all four cache tensors, written in place)
equal the reference's at 1e-5 of the largest magnitude.  On `reduced()`
mamba2-780m and jamba-1.5-large (one 8-layer period: attention at layer 0,
mamba elsewhere, MoE on odd layers, no rope), float32, the reference's
`init(PRNGKey(0))` carried across: prefill logits and the logits after
T = 8 decode steps at 1e-5 of the largest logit, jamba's greedy tokens
from the engine equal the reference engine's, and mamba2's decode
against its own prefill at the reference's atol 2e-2 / rtol 1e-2.  `Model.loss` at rtol 1e-5 of
the reference's and each gradient at 1e-4 of its largest entry for
mamba2; at 1e-3 for jamba, whose gradients move by up to 7.6e-5 when only
the reference's own chunking changes and lie 1.7e-4 to 3.3e-4 from the
port's on three seeds (tests/torch_lm_floor.py): float32 noise through
eight mixed layers, spread over many leaves, not a wrong term.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ModelConfig as RModelConfig
from repro.models import layers as RL
from repro.models import mamba as RM
from repro_torch.models import ModelConfig
from repro_torch.models import mamba as TM
from torch_lm_ref import (TOL_LOGITS, batch_for, carry, close_scaled,
                          greedy_generate_parity, loss_and_grads_parity,
                          port_decode, port_prefill, reference_decode, to_jax)
from torch_lm_ref import one_torch_thread  # noqa: F401 (autouse)

SSM_ARCHS = ("mamba2-780m", "jamba-1.5-large-398b")
TOL_LAYER = 1e-5


def _layer(seed, S=16, **kw):
    """(reference cfg, port cfg, reference params, port params, x (1, S, d)
    as numpy) of one mamba layer drawn by the reference's `init_params`,
    with A_log and dt_bias drawn too (the init leaves them 0)."""
    base = dict(name="t", family="ssm", n_layers=2, d_model=64, n_heads=8,
                n_kv=2, head_dim=16, d_ff=0, vocab=300, ssm_state=8,
                ssm_head_dim=8, ssm_chunk=4, param_dtype="float32",
                compute_dtype="float32", remat="none")
    base.update(kw)
    rcfg, cfg = RModelConfig(**base), ModelConfig(**base)
    r_p = RL.init_params(RM.mamba_defs(rcfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    for name in ("mamba/A_log", "mamba/dt_bias"):
        r_p[name] = jnp.asarray(
            rng.standard_normal(r_p[name].shape).astype(np.float32) * 0.5)
    p = {k: torch.from_numpy(np.array(v)) for k, v in r_p.items()}
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    return rcfg, cfg, r_p, p, x


def test_ssd_chunk_size_invariance():
    _, cfg, _, p, x = _layer(7)
    a = TM.mamba_apply(cfg, p, torch.from_numpy(x)).numpy()
    for Q in (8, 16):
        b = TM.mamba_apply(dataclasses.replace(cfg, ssm_chunk=Q), p,
                           torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(a, b, atol=2e-4)


def test_ssd_matches_step_recurrence():
    _, cfg, _, p, x = _layer(9, S=12)
    want = TM.mamba_apply(cfg, p, torch.from_numpy(x))
    cache = {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in
             TM.init_mamba_cache_shapes(cfg, x.shape[0]).items()}
    outs = []
    for t in range(x.shape[1]):
        y, cache = TM.mamba_decode_step(cfg, p,
                                        torch.from_numpy(x[:, t:t + 1]), cache)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), want.numpy(),
                               atol=3e-4)


def test_mamba_apply_matches_reference():
    rcfg, cfg, r_p, p, x = _layer(11, S=16)
    want = RM.mamba_apply(rcfg, r_p, jnp.asarray(x))
    got = TM.mamba_apply(cfg, p, torch.from_numpy(x))
    close_scaled(got.numpy(), want, TOL_LAYER)


def test_mamba_decode_step_matches_reference():
    rcfg, cfg, r_p, p, x = _layer(13, S=12)
    shapes = TM.init_mamba_cache_shapes(cfg, x.shape[0])
    cache = {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in shapes.items()}
    r_cache = {k: jnp.zeros(s.shape, s.dtype) for k, s in
               RM.init_mamba_cache_shapes(rcfg, x.shape[0]).items()}
    for t in range(x.shape[1]):
        want, r_cache = RM.mamba_decode_step(rcfg, r_p,
                                             jnp.asarray(x[:, t:t + 1]),
                                             r_cache)
        tensors = dict(cache)
        got, cache = TM.mamba_decode_step(cfg, p,
                                          torch.from_numpy(x[:, t:t + 1]),
                                          cache)
        assert all(cache[k] is tensors[k] for k in cache)   # in place
        close_scaled(got.numpy(), want, TOL_LAYER)
    for k in cache:
        assert cache[k].dtype == (torch.float32 if k == "ssm" else
                                  cfg.cdtype)
        close_scaled(cache[k].numpy(), r_cache[k], TOL_LAYER)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    r_model, r_params, model, params = carry(arch)
    toks = batch_for(model.cfg, 1)["tokens"]
    want = np.asarray(r_model.prefill(r_params, to_jax({"tokens": toks})))
    close_scaled(port_prefill(model, params, {"tokens": toks}), want,
                 TOL_LOGITS)
    want_d, r_caches = reference_decode(r_model, r_params, toks)
    got_d, caches = port_decode(model, params, toks)
    close_scaled(got_d, want_d, TOL_LOGITS)
    assert [sorted(c) for c in caches] == [sorted(c) for c in r_caches]


def test_mamba2_decode_matches_prefill():
    _, _, model, params = carry("mamba2-780m")
    toks = batch_for(model.cfg, 2)["tokens"]
    prefill = port_prefill(model, params, {"tokens": toks})
    decoded, _ = port_decode(model, params, toks)
    np.testing.assert_allclose(decoded, prefill, atol=2e-2, rtol=1e-2)


def test_greedy_generate_matches_reference():
    greedy_generate_parity("jamba-1.5-large-398b")


@pytest.mark.parametrize("arch,gtol", [("mamba2-780m", 1e-4),
                                       ("jamba-1.5-large-398b", 1e-3)])
def test_loss_and_grads_match_reference(arch, gtol):
    loss_and_grads_parity(arch, gtol=gtol)
