"""Helpers of the LM serving tests (`tests/test_torch_lm_serving.py`,
`tests/test_torch_lm_engine.py`): the reference's reduced models with
their `init(PRNGKey(0))` carried into the port, and the reference demo's
requests."""
import functools

import jax
import numpy as np
import torch

from repro.configs import get_config as r_get_config
from repro.models import build_model as r_build_model
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import build_model

ARCHS = ("qwen3-1.7b", "gemma-2b", "chatglm3-6b")
TIE = 1e-5
PROMPTS = [([5, 17, 42], 12), ([9, 9, 9, 9], 8), ([100, 200], 10), ([7], 6),
           ([1, 2, 3, 4, 5], 12)]


@functools.lru_cache(maxsize=None)
def reference_model(arch):
    """The reference's reduced model and its `init(PRNGKey(0))`, once an
    arch a process."""
    r_model = r_build_model(r_get_config(arch).reduced())
    return r_model, r_model.init(jax.random.PRNGKey(0))


def carry(arch):
    """(reference model, its params, a fresh port model, the carried
    params)."""
    r_model, r_params = reference_model(arch)
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.load_params(lm_params_from_numpy(
        {k: np.asarray(v) for k, v in r_params.items()}, cfg, "cpu"))
    return r_model, r_params, model, params


def recording(step, into):
    """Wrap a decode step so that each step's logits are kept."""
    def run(*args):
        logits, caches = step(*args)
        into.append(np.asarray(logits, np.float32) if not isinstance(
            logits, torch.Tensor) else logits.numpy().copy())
        return logits, caches
    return run
