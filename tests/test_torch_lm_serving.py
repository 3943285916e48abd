"""The port's serving engine (`repro_torch.serving.engine`) and the weight
carry (`convert.lm_params_from_numpy`) against the JAX package's.

On `reduced()` qwen3, gemma and chatglm3 in float32 with the reference's
`model.init(PRNGKey(0))` carried across, `Engine.generate` with greedy
decoding returns the reference `Engine`'s tokens for the reference demo's
five requests at batch 4 (two batches).  Where the reference's top two
logits at a step lie within 1e-5, greedy decoding may pick either in
float32; there the test compares that step's logits at atol/rtol 1e-5 in
place of the tokens from it on, and says so in its output.  The carry is
exact: float32 and bfloat16 leaves arrive bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import build_model as r_build_model
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import build_model
from torch_lm_ref import ARCHS, greedy_generate_parity


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_reference(arch):
    greedy_generate_parity(arch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_carry_is_exact(dtype):
    import dataclasses
    r_cfg = dataclasses.replace(r_get_config("qwen3-1.7b").reduced(),
                                param_dtype=dtype)
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              param_dtype=dtype)
    r_params = r_build_model(r_cfg).init(jax.random.PRNGKey(0))
    got = lm_params_from_numpy({k: np.asarray(v) for k, v in
                                r_params.items()}, cfg, "cpu")
    assert sorted(got) == sorted(r_params)
    for path, v in r_params.items():
        assert got[path].dtype == getattr(torch, dtype), path
        want = np.asarray(v.astype(jnp.float32))
        np.testing.assert_array_equal(got[path].float().numpy(), want)


def test_weight_carry_refuses_a_missing_path():
    r_params = r_build_model(r_get_config("qwen3-1.7b").reduced()).init(
        jax.random.PRNGKey(0))
    host = {k: np.asarray(v) for k, v in r_params.items()}
    host.pop("final_norm")
    cfg = get_config("qwen3-1.7b").reduced()
    with pytest.raises(KeyError, match="final_norm"):
        build_model(cfg).load_params(lm_params_from_numpy(host, cfg, "cpu"))
