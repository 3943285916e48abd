"""Helpers of the LM tests (`tests/test_torch_lm_*.py`, `test_torch_train.py`,
`test_torch_trainer.py`): the reference's reduced models with their
`init(PRNGKey(0))` carried into the port, seeded batches for every family,
the reference's prefill and decode, and the reference demo's requests."""
import dataclasses
import functools

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

ARCHS = ("qwen3-1.7b", "gemma-2b", "chatglm3-6b")
# the non-dense families: MoE (granite top-8 of 32, llama4 top-1 + a shared
# expert), mamba2, the jamba hybrid, encoder-decoder and the VLM stub
FAMILIES = ("granite-moe-1b-a400m", "llama4-scout-17b-a16e", "mamba2-780m",
            "jamba-1.5-large-398b", "seamless-m4t-medium", "pixtral-12b")
TIE = 1e-5
PROMPTS = [([5, 17, 42], 12), ([9, 9, 9, 9], 8), ([100, 200], 10), ([7], 6),
           ([1, 2, 3, 4, 5], 12)]
B, T = 2, 8          # batch and tokens of the parity batches
N_FRONTEND = 16      # frames (seamless) or patches given a batch
SRC_LEN = 16         # the enc-dec cross caches' length in the decode tests
# logits (prefill and after T decode steps) against the reference's, at
# this fraction of the largest logit
TOL_LOGITS = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU runs on one thread in a module that imports this
    fixture: the tests run several files at once, and at these sizes more
    threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def reference_model(arch):
    """The reference's reduced model and its `init(PRNGKey(0))`, once an
    arch a process."""
    r_model = r_build_model(r_get_config(arch).reduced())
    return r_model, r_model.init(jax.random.PRNGKey(0))


def carry(arch, moe_impl="einsum", **changes):
    """(reference model, its params, a fresh port model, the carried
    params) of the reduced config with `changes`, both models on
    `moe_impl`."""
    _, r_params = reference_model(arch)
    r_model = r_build_model(dataclasses.replace(
        r_get_config(arch).reduced(), **changes), moe_impl=moe_impl)
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    model = build_model(cfg, moe_impl=moe_impl)
    params = model.load_params(lm_params_from_numpy(
        {k: np.asarray(v) for k, v in r_params.items()}, cfg, "cpu"))
    return r_model, r_params, model, params


def batch_for(cfg, seed, b=B, t=T):
    """A seeded numpy batch: tokens, labels, and frames or patches where
    the config has a frontend."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, t)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)}
    if cfg.frontend:
        key = "frames" if cfg.frontend == "frames" else "patches"
        batch[key] = rng.standard_normal(
            (b, N_FRONTEND, cfg.d_model)).astype(np.float32)
    return batch


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def close_scaled(got, want, tol):
    """|got - want| <= tol × (|want| + its largest magnitude)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def reference_decode(r_model, r_params, toks):
    """The reference's logits after decoding `toks` (B, T) one at a time
    from zero caches, and the caches."""
    b, t = toks.shape
    kw = {"src_len": SRC_LEN} if r_model.cfg.is_encdec else {}
    caches = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          r_model.cache_shapes(b, t, **kw))
    step = jax.jit(r_model.decode_step)
    for i in range(t):
        logits, caches = step(r_params, caches, jnp.asarray(toks[:, i:i + 1]),
                              jnp.asarray(i, jnp.int32))
    return np.asarray(logits), caches


def port_decode(model, params, toks):
    """The port's logits after decoding `toks` one at a time, and the
    caches."""
    b, t = toks.shape
    caches = model.zero_caches(b, t, "cpu", src_len=SRC_LEN)
    with torch.inference_mode():
        for i in range(t):
            logits, caches = model.decode_step(
                params, caches, torch.from_numpy(np.asarray(toks[:, i:i + 1])),
                i)
    return logits.numpy(), caches


def port_prefill(model, params, batch):
    with torch.inference_mode():
        return model.prefill(params, to_torch(
            {k: v for k, v in batch.items() if k != "labels"})).numpy()


def recording(step, into):
    """Wrap a decode step so that each step's logits are kept."""
    def run(*args):
        logits, caches = step(*args)
        into.append(np.asarray(logits, np.float32) if not isinstance(
            logits, torch.Tensor) else logits.numpy().copy())
        return logits, caches
    return run


def greedy_generate_parity(arch, moe_impl="einsum"):
    """The port's `Engine.generate` against the reference `Engine`'s on the
    reference demo's five requests at batch 4, greedy: equal tokens, or,
    where the reference's top two logits at a step lie within TIE (greedy
    float32 may pick either), that step's logits and the ones before it at
    TIE.  Returns the step of such a tie, or None."""
    from repro.serving.engine import Engine as REngine
    from repro.serving.engine import Request as RRequest
    from repro_torch.serving.engine import Engine, Request
    r_model, r_params, model, params = carry(arch, moe_impl)
    r_eng = REngine(r_model, r_params, batch=4, max_seq=64)
    r_logits, logits = [], []
    r_eng._decode = recording(r_eng._decode, r_logits)
    eng = Engine(model, params, batch=4, max_seq=64)
    model.decode_step = recording(model.decode_step, logits)
    want = [r.out for r in r_eng.generate(
        [RRequest(prompt=list(p), max_new=n) for p, n in PROMPTS])]
    got = [r.out for r in eng.generate(
        [Request(prompt=list(p), max_new=n) for p, n in PROMPTS])]
    assert [len(o) for o in got] == [n for _, n in PROMPTS]
    gaps = [float(np.min(np.diff(np.sort(lg, axis=-1)[:, -2:], axis=-1)))
            for lg in r_logits]
    tie = next((i for i, g in enumerate(gaps) if g < TIE), None)
    if tie is None:
        assert got == want
    else:
        print(f"{arch}: the reference's top two logits lie within {TIE} at "
              f"decode step {tie}; logits compared up to it, not tokens")
        for a, b in zip(logits[:tie + 1], r_logits[:tie + 1]):
            np.testing.assert_allclose(a, b, atol=TIE, rtol=TIE)
    return tie


def loss_and_grads_parity(arch, moe_impl="einsum", gtol=1e-4):
    """`Model.loss` and every gradient (`trainer.value_and_grad`) against
    `jax.value_and_grad(r_model.loss)` on the seed-1 batch: the loss at
    rtol 1e-5, each gradient at `gtol` of its largest entry."""
    from repro_torch.training.trainer import value_and_grad
    r_model, r_params, model, params = carry(arch, moe_impl)
    batch = batch_for(model.cfg, 1)
    r_loss, r_grads = jax.value_and_grad(r_model.loss)(r_params,
                                                       to_jax(batch))
    loss, grads = value_and_grad(model.loss, params, to_torch(batch))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=1e-5)
    assert sorted(grads) == sorted(r_grads)
    for k, want in r_grads.items():
        close_scaled(grads[k].numpy(), want, gtol)
