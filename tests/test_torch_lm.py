"""The port's dense LM serving path (`repro_torch.models`, `configs`) against
the JAX package's.

Shapes: for the four dense configs at full width the port's `param_defs()`
paths, shapes and dtypes equal the reference's (no tensor is allocated);
qwen3-1.7b has 13 paths and 1,720,837,120 parameters.  Every non-dense
config (MoE, mamba2, the hybrid, encoder-decoder, VLM), which raised
NotImplementedError before its families were ported, now builds at full
width and reduced with the reference's paths, shapes and dtypes; every
`reduced()` config equals the reference's field for field.

Numbers: on `reduced()` qwen3, gemma and chatglm3 in float32 the
reference's `model.init(PRNGKey(0))` is carried across by path
(`convert.lm_params_from_numpy`), and the same tokens (numpy, seeded) go
through both.  Tolerances: `rms_norm`, `apply_rope` and `mlp_apply` at
atol/rtol 1e-6; prefill logits, and the logits after T = 8 decode steps,
at atol/rtol 1e-5; every cache after those steps, and one attention
layer's output, at rtol 1e-5 with atol 1e-5 of the tensor's largest
magnitude (`_close_scaled`: their entries are float32 sums of 32-128
products whose terms reach ~100, so an entry near 0 carries the sum's
rounding, ~2e-5 absolute, measured); decode against prefill at the
reference's own atol 2e-2 / rtol 1e-2 (tests/test_archs.py); q-chunk
invariance at 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import arch_ids as r_arch_ids
from repro.configs import get_config as r_get_config
from repro.models import attention as RA
from repro.models import ModelConfig as RModelConfig
from repro.models import build_model as r_build_model
from repro.models import layers as RL
from repro_torch.configs import arch_ids, get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import ModelConfig, build_model
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

DENSE = ("qwen3-1.7b", "gemma-2b", "chatglm3-6b", "deepseek-coder-33b")
NON_DENSE = tuple(a for a in r_arch_ids() if a not in DENSE)
CARRIED = ("qwen3-1.7b", "gemma-2b", "chatglm3-6b")
QWEN3_PARAMS = 1_720_837_120
B, T = 2, 8
TOL_LAYER = 1e-6
TOL_MODEL = 1e-5


def _close_scaled(got, want, tol=TOL_MODEL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _np_dtype_name(d):
    return str(d).replace("torch.", "")


def test_registry_matches_reference():
    assert arch_ids() == r_arch_ids()


@pytest.mark.parametrize("arch", r_arch_ids())
def test_configs_equal_field_for_field(arch):
    for full in (True, False):
        r, t = r_get_config(arch), get_config(arch)
        if not full:
            r, t = r.reduced(), t.reduced()
        assert dataclasses.asdict(r) == dataclasses.asdict(t), arch
        assert (r.padded_vocab, r.layer_groups(), r.is_encdec) == (
            t.padded_vocab, t.layer_groups(), t.is_encdec)
        assert _np_dtype_name(r.pdtype) == _np_dtype_name(t.pdtype)
        assert _np_dtype_name(r.cdtype) == _np_dtype_name(t.cdtype)


@pytest.mark.parametrize("arch", DENSE)
def test_full_width_param_defs_equal_reference(arch):
    """Paths, shapes and dtypes, from the defs alone (no allocation)."""
    want = r_build_model(r_get_config(arch)).param_defs()
    model = build_model(get_config(arch))          # meta tensors only
    got = model.param_defs()
    assert sorted(got) == sorted(want)
    for path, d in want.items():
        assert got[path].shape == d.shape, path
        assert _np_dtype_name(got[path].dtype) == str(np.dtype(d.dtype)), path
        assert got[path].scale == d.scale, path
        assert got[path].logical == d.logical, path
    assert all(p.device.type == "meta" for p in model.parameters())
    if arch == "qwen3-1.7b":
        assert len(got) == 13
        assert sum(int(np.prod(d.shape)) for d in got.values()) == \
            QWEN3_PARAMS


@pytest.mark.parametrize("arch", NON_DENSE)
def test_non_dense_configs_raise(arch):
    """Once NotImplementedError (ROADMAP item 16); now every non-dense
    config builds, full and reduced, on the meta device, with the
    reference's param paths, shapes and dtypes, under both MoE impls."""
    for full in (True, False):
        r_cfg, cfg = r_get_config(arch), get_config(arch)
        if not full:
            r_cfg, cfg = r_cfg.reduced(), cfg.reduced()
        want = r_build_model(r_cfg).param_defs()
        for impl in ("einsum", "gather"):
            model = build_model(cfg, moe_impl=impl)
            got = model.param_defs()
            assert sorted(got) == sorted(want), arch
            for path, d in want.items():
                assert got[path].shape == d.shape, path
                assert (_np_dtype_name(got[path].dtype)
                        == str(np.dtype(d.dtype))), path
                assert got[path].scale == d.scale, path
            assert all(p.device.type == "meta" for p in model.parameters())


# ---------------------------------------------------------------------------
# layers, on seeded numpy inputs
# ---------------------------------------------------------------------------
def _rng(seed):
    return np.random.default_rng(seed)


def test_rms_norm_matches_reference():
    x = _rng(0).standard_normal((2, 5, 64)).astype(np.float32)
    w = _rng(1).standard_normal(64).astype(np.float32)
    want = np.asarray(RL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_LAYER,
                               rtol=TOL_LAYER)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_apply_rope_matches_reference(fraction):
    """Interleaved pairs, only `fraction` of head_dim rotated."""
    x = _rng(2).standard_normal((2, 11, 4, 32)).astype(np.float32)
    pos = np.arange(3, 14, dtype=np.int32)[None, :]
    want = np.asarray(RL.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                    fraction, 10000.0))
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                        fraction, 10000.0)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_LAYER,
                               rtol=TOL_LAYER)
    if fraction < 1.0:
        np.testing.assert_array_equal(got.numpy()[..., 16:], x[..., 16:])


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_apply_matches_reference(act):
    kw = dict(d_model=32, d_ff=48, act=act, param_dtype="float32",
              compute_dtype="float32")
    rcfg, cfg = RModelConfig(**kw), ModelConfig(**kw)
    rng = _rng(3)
    p = {f"mlp/{k}": (rng.standard_normal(s) * 0.2).astype(np.float32)
         for k, s in (("wg", (32, 48)), ("wu", (32, 48)), ("wo", (48, 32)))}
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    want = np.asarray(RL.mlp_apply(rcfg, {k: jnp.asarray(v)
                                         for k, v in p.items()},
                                   jnp.asarray(x)))
    got = TL.mlp_apply(cfg, {k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_LAYER,
                               rtol=TOL_LAYER)


# ---------------------------------------------------------------------------
# the reduced models, with the reference's weights carried across
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=CARRIED)
def carried(request):
    arch = request.param
    r_model = r_build_model(r_get_config(arch).reduced())
    r_params = r_model.init(jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.load_params(lm_params_from_numpy(
        {k: np.asarray(v) for k, v in r_params.items()}, cfg, "cpu"))
    toks = _rng(1).integers(0, cfg.vocab, (B, T)).astype(np.int32)
    return arch, r_model, r_params, model, params, toks


def _prefill(carried):
    _, r_model, r_params, model, params, toks = carried
    want = np.asarray(r_model.prefill(r_params, {"tokens": jnp.asarray(toks)}))
    with torch.inference_mode():
        got = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    return got.numpy(), want


def test_prefill_logits_match_reference(carried):
    got, want = _prefill(carried)
    assert got.shape == (B, carried[3].cfg.padded_vocab)
    np.testing.assert_allclose(got, want, atol=TOL_MODEL, rtol=TOL_MODEL)


def test_decode_logits_and_caches_match_reference(carried):
    _, r_model, r_params, model, params, toks = carried
    r_caches = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                            r_model.cache_shapes(B, T))
    caches = model.zero_caches(B, T, "cpu")
    step = jax.jit(r_model.decode_step)
    with torch.inference_mode():
        for t in range(T):
            r_logits, r_caches = step(r_params, r_caches,
                                      jnp.asarray(toks[:, t:t + 1]),
                                      jnp.asarray(t, jnp.int32))
            logits, caches = model.decode_step(
                params, caches, torch.from_numpy(toks[:, t:t + 1]), t)
    np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits),
                               atol=TOL_MODEL, rtol=TOL_MODEL)
    assert len(caches) == len(r_caches) == model.cfg.n_layers
    for got, want in zip(caches, r_caches):
        for k in ("k", "v"):
            _close_scaled(got[k].numpy(), want[k])
    # decode against the port's own prefill, at the reference's tolerance
    prefill, _ = _prefill(carried)
    np.testing.assert_allclose(logits.numpy(), prefill, atol=2e-2, rtol=1e-2)


def test_prefill_q_chunk_invariance(carried):
    _, _, _, model, params, toks = carried
    x = torch.from_numpy(_rng(4).standard_normal(
        (B, 21, model.cfg.d_model)).astype(np.float32))
    p_blk = TT._layer_params(params, 1, 0)
    with torch.inference_mode():
        a = TA.attention(dataclasses.replace(model.cfg, attn_q_chunk=4),
                         p_blk, x)
        b = TA.attention(dataclasses.replace(model.cfg, attn_q_chunk=21),
                         p_blk, x)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL_MODEL,
                               rtol=TOL_MODEL)


def test_attention_matches_reference_on_a_ragged_chunk(carried):
    """S = 19 over q-chunks of 8: the padded queries' positions sit at S+1
    in both packages."""
    _, _, r_params, model, params, _ = carried
    cfg = dataclasses.replace(model.cfg, attn_q_chunk=8)
    x = _rng(5).standard_normal((B, 19, cfg.d_model)).astype(np.float32)
    r_blk = {k[len("blk0/"):]: v[0] for k, v in r_params.items()
             if k.startswith("blk0/")}
    rcfg = dataclasses.replace(r_get_config(carried[0]).reduced(),
                               attn_q_chunk=8)
    want = np.asarray(RA.attention(rcfg, r_blk, jnp.asarray(x)))
    with torch.inference_mode():
        got = TA.attention(cfg, TT._layer_params(params, 1, 0),
                           torch.from_numpy(x))
    _close_scaled(got.numpy(), want)
