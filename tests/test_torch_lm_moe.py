"""The port's MoE layer (`repro_torch.models.moe`) and the MoE configs
against the JAX package's.

On seeded numpy inputs with the reference's `init_params` carried across:
`top_k` orders exact ties as `lax.top_k` does (lower index first); einsum
equals gather (seeds 0-2, atol 1e-5, aux 1e-6) and both drop the same
(token, slot) pairs at capacity factor 0.25, as the reference's oracle
tests hold them; `moe_apply` of each impl, with and without a shared
expert, equals the reference's at 1e-5 of its largest magnitude.  On
`reduced()` granite (32 experts top-8 cut to 4 top-2) and llama4 (top-1 +
a shared expert), both impls, float32, the reference's `init(PRNGKey(0))`
carried across: prefill logits and the logits after T = 8 decode steps at
1e-5 of the largest logit, granite's greedy tokens from the engine under
gather equal the reference engine's, and decode against the port's own
prefill at the reference's atol 2e-2 / rtol 1e-2 with the capacity factor
raised to E (so no token is dropped, as tests/test_archs.py raises it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ModelConfig as RModelConfig
from repro.models import layers as RL
from repro.models import moe as RMOE
from repro_torch.configs import get_config
from repro_torch.models import ModelConfig
from repro_torch.models import moe as TMOE
from torch_lm_ref import (TOL_LOGITS, batch_for, carry, close_scaled,
                          greedy_generate_parity, port_decode, port_prefill,
                          reference_decode, to_jax)
from torch_lm_ref import one_torch_thread  # noqa: F401 (autouse)

MOE_ARCHS = ("granite-moe-1b-a400m", "llama4-scout-17b-a16e")
TOL_LAYER = 1e-5


def _cfgs(**kw):
    base = dict(name="t", family="moe", n_layers=2, d_model=64, n_heads=8,
                n_kv=2, head_dim=16, d_ff=96, vocab=300, n_experts=4,
                top_k=2, param_dtype="float32", compute_dtype="float32",
                xent_chunk=16, attn_q_chunk=8, remat="none")
    base.update(kw)
    return RModelConfig(**base), ModelConfig(**base)


def _layer(seed, **kw):
    """(reference cfg, port cfg, reference params, port params, x as numpy)
    of one MoE layer drawn by the reference's `init_params`."""
    rcfg, cfg = _cfgs(**kw)
    r_p = RL.init_params(RMOE.moe_defs(rcfg), jax.random.PRNGKey(seed))
    p = {k: torch.from_numpy(np.array(v)) for k, v in r_p.items()}
    x = np.array(jax.random.normal(jax.random.PRNGKey(seed + 10),
                                   (2, 32, cfg.d_model)))
    return rcfg, cfg, r_p, p, x


def test_top_k_orders_ties_as_lax_top_k():
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2]], np.float32)
    for k in (1, 2, 3):
        rv, ri = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = TMOE.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_einsum_equals_gather(seed):
    _, cfg, _, p, x = _layer(seed)
    a, aux_a = TMOE.moe_einsum(cfg, p, torch.from_numpy(x))
    b, aux_b = TMOE.moe_gather(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    assert abs(float(aux_a) - float(aux_b)) < 1e-6


def test_capacity_drops_match_reference():
    """At cf 0.25 both impls drop the same tokens, some rows come out zero,
    and the port's drops are the reference's."""
    rcfg, cfg, r_p, p, x = _layer(0, moe_capacity_factor=0.25)
    a, _ = TMOE.moe_einsum(cfg, p, torch.from_numpy(x))
    b, _ = TMOE.moe_gather(cfg, p, torch.from_numpy(x))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    dropped = np.abs(a.numpy()).sum(-1) < 1e-6
    assert dropped.any()
    want, _ = RMOE.moe_einsum(rcfg, r_p, jnp.asarray(x))
    np.testing.assert_array_equal(
        dropped, np.abs(np.asarray(want)).sum(-1) < 1e-6)
    close_scaled(a.numpy(), want, TOL_LAYER)


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_moe_apply_matches_reference(impl, shared):
    rcfg, cfg, r_p, p, x = _layer(3, n_shared_experts=shared)
    want, r_aux = RMOE.moe_apply(rcfg, r_p, jnp.asarray(x), impl=impl)
    got, aux = TMOE.moe_apply(cfg, p, torch.from_numpy(x), impl=impl)
    close_scaled(got.numpy(), want, TOL_LAYER)
    np.testing.assert_allclose(float(aux), float(r_aux), rtol=1e-6)


@pytest.mark.parametrize("impl", ["einsum", "gather"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_reference(arch, impl):
    r_model, r_params, model, params = carry(arch, impl)
    batch = batch_for(model.cfg, 1)
    want = np.asarray(r_model.prefill(r_params, to_jax(
        {"tokens": batch["tokens"]})))
    got = port_prefill(model, params, {"tokens": batch["tokens"]})
    assert got.shape == want.shape == (2, model.cfg.padded_vocab)
    close_scaled(got, want, TOL_LOGITS)
    want_d, _ = reference_decode(r_model, r_params, batch["tokens"])
    got_d, _ = port_decode(model, params, batch["tokens"])
    close_scaled(got_d, want_d, TOL_LOGITS)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_prefill_with_capacity_raised(arch):
    E = float(get_config(arch).reduced().n_experts)
    _, _, model, params = carry(arch, moe_capacity_factor=E)
    toks = batch_for(model.cfg, 2)["tokens"]
    prefill = port_prefill(model, params, {"tokens": toks})
    decoded, _ = port_decode(model, params, toks)
    np.testing.assert_allclose(decoded, prefill, atol=2e-2, rtol=1e-2)


def test_greedy_generate_matches_reference():
    greedy_generate_parity("granite-moe-1b-a400m", "gather")
