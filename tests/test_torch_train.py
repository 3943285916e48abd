"""The port's training pieces against the JAX package's: `Model.loss` and
its gradients, `layers.chunked_xent`, the optimizers, clipping and the
schedule, `make_train_step` (microbatches, accumulation dtype, the NaN
guard), the Watchdog and `TokenStream`.

Loss and gradients: on `reduced()` qwen3 and granite (both dispatches)
in float32, the reference's `init(PRNGKey(0))` carried across and a
seeded batch, the port's loss at rtol 1e-5 of `jax.value_and_grad(
r_model.loss)`'s and each gradient at 1e-4 of its largest entry for
qwen3 (`torch_lm_ref.loss_and_grads_parity`; the other families' cases
sit in their own files); at 1e-3 for granite, whose gradients lie 1.8e-5
to 2.4e-4 from the reference's on three seeds (tests/torch_lm_floor.py):
float32 order through a top-8 router's softmax.

One AdamW (float32 and bfloat16 state) and one Adafactor update on the
same params and gradients at 1e-6; clipping and the cosine schedule at
1e-6; a step at microbatches=2 equal to the full batch's (1e-5).  Three
train steps, and one in bfloat16 accumulation, against the reference's:
losses at rtol 1e-5 (1e-6 for the one step) and params at 3 % of the lr
the steps summed.  AdamW divides m by √v, so an entry whose gradient is
float32 noise (an embedding row of a token the batch never names) steps
by up to lr either way: the three steps' lr sum to 1.8e-3 and the
measured worst entry moved 1.2e-5 (3.6e-6 in the bfloat16 step, which is
also within the reference test's 1e-2 of float32 accumulation).  The NaN
guard leaves params and optimizer state bit for bit; TokenStream's batches
are the reference's bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import TokenStream as RTokenStream
from repro.models import ModelConfig as RModelConfig
from repro.models import build_model as r_build_model
from repro.models import layers as RL
from repro.optim import AdamW as RAdamW
from repro.optim import Adafactor as RAdafactor
from repro.optim import clip_by_global_norm as r_clip
from repro.optim import cosine_schedule as r_cosine
from repro.training.trainer import TrainState as RTrainState
from repro.training.trainer import make_train_step as r_make_train_step
from repro_torch.data.pipeline import TokenStream
from repro_torch.models import ModelConfig, build_model
from repro_torch.models import layers as TL
from repro_torch.optim import AdamW, Adafactor, clip_by_global_norm
from repro_torch.optim import cosine_schedule
from repro_torch.training.trainer import (TrainState, Watchdog,
                                          make_train_step)
from torch_lm_ref import loss_and_grads_parity, to_jax, to_torch
from torch_lm_ref import one_torch_thread  # noqa: F401 (autouse)

# qwen3 and granite here; mamba2 and jamba in test_torch_lm_mamba.py,
# seamless and pixtral in test_torch_lm_encdec.py, so that --dist loadfile
# spreads the reference's gradient compiles over workers
LOSS_CASES = [("qwen3-1.7b", "einsum", 1e-4),
              ("granite-moe-1b-a400m", "einsum", 1e-3),
              ("granite-moe-1b-a400m", "gather", 1e-3)]


def tiny_cfgs(**kw):
    """The reference substrate tests' tiny config, in both packages."""
    base = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv=2,
                head_dim=8, d_ff=64, vocab=64, param_dtype="float32",
                compute_dtype="float32", xent_chunk=16, attn_q_chunk=16,
                remat="none")
    base.update(kw)
    return RModelConfig(**base), ModelConfig(**base)


def tiny_models():
    """(reference model, the port's seeded init as jax arrays, port model,
    its params)."""
    rcfg, cfg = tiny_cfgs()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    r_params = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    return r_build_model(rcfg), r_params, model, params


def tiny_batch(seed, b=4):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 64, (b, 8)).astype(np.int32),
            "labels": rng.integers(0, 64, (b, 8)).astype(np.int32)}


def _np(tree):
    return {k: np.asarray(v, np.float32) if not isinstance(v, torch.Tensor)
            else v.float().numpy() for k, v in tree.items()}


@pytest.mark.parametrize("arch,impl,gtol", LOSS_CASES,
                         ids=[f"{a}-{i}" for a, i, _ in LOSS_CASES])
def test_loss_and_grads_match_reference(arch, impl, gtol):
    loss_and_grads_parity(arch, impl, gtol)


def test_chunked_xent_matches_naive_softmax_and_reference():
    rcfg, cfg = tiny_cfgs(vocab=300, d_model=64)
    rng = np.random.default_rng(0)
    emb = (rng.standard_normal((cfg.padded_vocab, 64)) * 0.02).astype(
        np.float32)
    h = rng.standard_normal((2, 33, 64)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (2, 33)).astype(np.int32)
    labels[0, [2, 3, 5]] = -1
    p = {"embed/tok": torch.from_numpy(emb)}
    got = float(TL.chunked_xent(cfg, p, torch.from_numpy(h),
                                torch.from_numpy(labels)))
    logits = torch.from_numpy(h) @ p["embed/tok"].T
    lse = torch.logsumexp(logits, -1)
    picked = torch.gather(logits, -1, torch.from_numpy(
        labels).clamp(min=0).long()[..., None])[..., 0]
    mask = torch.from_numpy(labels >= 0).float()
    naive = float(((lse - picked) * mask).sum() / mask.sum())
    assert abs(got - naive) < 1e-5
    want = float(RL.chunked_xent(rcfg, {"embed/tok": jnp.asarray(emb)},
                                 jnp.asarray(h), jnp.asarray(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _opt_inputs(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (5,), "b": (4, 6), "c": (3, 4, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
    return params, grads


@pytest.mark.parametrize("name", ["adamw-float32", "adamw-bfloat16",
                                  "adafactor"])
def test_optimizer_update_matches_reference(name):
    params, grads = _opt_inputs()
    if name == "adafactor":
        r_opt, opt = RAdafactor(), Adafactor()
    else:
        dt = name.split("-")[1]
        r_opt, opt = RAdamW(state_dtype=dt), AdamW(state_dtype=dt)
    r_p = {k: jnp.asarray(v) for k, v in params.items()}
    t_p = {k: torch.from_numpy(v) for k, v in params.items()}
    r_state, state = r_opt.init(r_p), opt.init(t_p)
    for step in range(3):       # the first update and two after it
        g = {k: v * (1 + step) for k, v in grads.items()}
        r_p, r_state = r_opt.update({k: jnp.asarray(v) for k, v in
                                     g.items()}, r_state, r_p, 0.01)
        t_p, state = opt.update({k: torch.from_numpy(v) for k, v in
                                 g.items()}, state, t_p, 0.01)
    assert int(state.count) == int(r_state.count) == 3
    for got, want in ((t_p, r_p), (state.mu, r_state.mu),
                      (state.nu, r_state.nu)):
        for k in want:
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
            np.testing.assert_allclose(got[k].float().numpy(),
                                       np.asarray(want[k], np.float32),
                                       rtol=1e-6, atol=1e-6, err_msg=k)


def test_clip_and_cosine_schedule_match_reference():
    _, grads = _opt_inputs(1)
    for max_norm in (0.5, 100.0):
        r_g, r_n = r_clip({k: jnp.asarray(v) for k, v in grads.items()},
                          max_norm)
        g, n = clip_by_global_norm({k: torch.from_numpy(v)
                                    for k, v in grads.items()}, max_norm)
        np.testing.assert_allclose(float(n), float(r_n), rtol=1e-6)
        for k in grads:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(r_g[k]),
                                       rtol=1e-6, atol=1e-7)
    r_lr, lr = r_cosine(3e-3, 5, 40), cosine_schedule(3e-3, 5, 40)
    for step in (0, 1, 4, 5, 6, 20, 39, 40, 50):
        np.testing.assert_allclose(float(lr(torch.tensor(step))),
                                   float(r_lr(step)), rtol=1e-6, atol=1e-9)
    assert float(lr(0)) == 0.0


def _states(opt):
    r_model, r_params, model, params = tiny_models()
    r_state = RTrainState(step=jnp.zeros((), jnp.int32), params=r_params,
                          opt_state=RAdamW(state_dtype="float32").init(
                              r_params))
    state = TrainState(step=torch.zeros((), dtype=torch.int32),
                       params=params, opt_state=opt.init(params))
    return r_model, r_state, model, state


def test_microbatches_equal_full_batch():
    opt = AdamW(state_dtype="float32")
    _, _, model, state = _states(opt)
    batch = to_torch(tiny_batch(1))
    full = make_train_step(model.loss, opt, lambda s: 1e-3)(state, batch)
    micro = make_train_step(model.loss, opt, lambda s: 1e-3,
                            microbatches=2)(state, batch)
    assert abs(float(full[1].loss) - float(micro[1].loss)) < 1e-5
    for k in full[0].params:
        np.testing.assert_allclose(micro[0].params[k].numpy(),
                                   full[0].params[k].numpy(), atol=1e-5)


def test_bf16_accumulation_matches_reference():
    opt = AdamW(state_dtype="float32")
    r_model, r_state, model, state = _states(opt)
    batch = tiny_batch(2)
    r_new, r_m = jax.jit(r_make_train_step(
        r_model.loss, RAdamW(state_dtype="float32"), lambda s: 1e-3,
        microbatches=2, accum_dtype="bfloat16"))(r_state, to_jax(batch))
    new, m = make_train_step(model.loss, opt, lambda s: 1e-3,
                             microbatches=2, accum_dtype="bfloat16")(
                                 state, to_torch(batch))
    f32, _ = make_train_step(model.loss, opt, lambda s: 1e-3,
                             microbatches=2)(state, to_torch(batch))
    np.testing.assert_allclose(float(m.loss), float(r_m.loss), rtol=1e-6)
    np.testing.assert_allclose(float(m.grad_norm), float(r_m.grad_norm),
                               rtol=1e-2)
    for k, want in _np(r_new.params).items():
        np.testing.assert_allclose(new.params[k].numpy(), want,
                                   atol=0.03 * 1e-3, err_msg=k)
        assert np.abs(new.params[k].numpy()
                      - f32.params[k].numpy()).max() < 1e-2


def test_train_step_matches_reference():
    opt = AdamW(state_dtype="float32")
    r_model, r_state, model, state = _states(opt)
    lr = cosine_schedule(3e-3, 5, 40)
    step = make_train_step(model.loss, opt, lr)
    r_step = jax.jit(r_make_train_step(
        r_model.loss, RAdamW(state_dtype="float32"),
        r_cosine(3e-3, 5, 40)))
    lr_sum = sum(float(lr(i)) for i in range(3))
    for i in range(3):
        batch = tiny_batch(10 + i)
        r_state, r_m = r_step(r_state, to_jax(batch))
        state, m = step(state, to_torch(batch))
        np.testing.assert_allclose(float(m.loss), float(r_m.loss), rtol=1e-5)
    assert int(state.step) == int(r_state.step) == 3
    for k, want in _np(r_state.params).items():
        np.testing.assert_allclose(state.params[k].numpy(), want,
                                   atol=0.03 * lr_sum, err_msg=k)


def test_nan_guard_leaves_params_and_state_unchanged():
    opt = AdamW(state_dtype="float32")
    _, _, model, state = _states(opt)
    state, _ = make_train_step(model.loss, opt, lambda s: 1e-3)(
        state, to_torch(tiny_batch(3)))          # a state with m, v set

    def bad_loss(p, batch):
        return model.loss(p, batch) + float("nan")
    new, m = make_train_step(bad_loss, opt, lambda s: 1e-3)(
        state, to_torch(tiny_batch(4)))
    assert float(m.skipped) == 1.0 and not np.isfinite(float(m.loss))
    assert int(new.step) == int(state.step) + 1
    assert int(new.opt_state.count) == int(state.opt_state.count)
    for got, want in ((new.params, state.params),
                      (new.opt_state.mu, state.opt_state.mu),
                      (new.opt_state.nu, state.opt_state.nu)):
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_watchdog_flags_stragglers():
    wd = Watchdog(threshold=3.0)
    assert not wd.observe(1.0)
    assert not wd.observe(1.1)
    assert wd.observe(10.0)
    assert wd.outliers == 1


@pytest.mark.parametrize("frontend", [None, "frames", "patches"])
def test_token_stream_equals_reference(frontend):
    kw = dict(vocab=1000, batch=8, seq_len=16, seed=3, frontend=frontend,
              n_frontend=4, d_model=8)
    full, r_full = TokenStream(**kw), RTokenStream(**kw)
    parts = [TokenStream(**kw, shard=(k, 4)) for k in range(4)]
    for _ in range(3):
        want = r_full.next()
        got = full.next()
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(
            np.concatenate([p.next()["tokens"] for p in parts]),
            want["tokens"])
    state = full.state()
    assert state == r_full.state()
    again = TokenStream(**kw)
    again.restore(state)
    np.testing.assert_array_equal(again.next()["labels"],
                                  r_full.next()["labels"])
    with pytest.raises(ValueError, match="seed"):
        TokenStream(**{**kw, "seed": 4}).restore(state)
