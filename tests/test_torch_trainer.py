"""The port's `Trainer` (`repro_torch.training.trainer`), its checkpoints,
and the training entry points `launch/train` and `examples/train_lm`, on
the CPU.

The port's Trainer takes 4 steps on `reduced()` qwen3 from the reference's
`init(PRNGKey(0))` and the same TokenStream as the reference's Trainer:
losses at 1e-4 relative.  A run saved at step 2 and resumed in a new
Trainer ends bit for bit on the uninterrupted run's params, optimizer
state and losses; SIGTERM saves at the next step boundary and stops; a
step whose loss is NaN is skipped (params bit for bit), leaves an
emergency checkpoint, and the run goes on; bfloat16 params checkpoint and
restore bit for bit.  Both entry points run a few steps with `--json`.
"""
import dataclasses
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import TokenStream as RTokenStream
from repro.optim import AdamW as RAdamW
from repro.optim import cosine_schedule as r_cosine
from repro.training.trainer import Trainer as RTrainer
from repro.training.trainer import TrainState as RTrainState
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenStream
from repro_torch.examples import train_lm
from repro_torch.launch import train
from repro_torch.models import build_model
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.training.trainer import Trainer, TrainState
from torch_lm_ref import carry
from torch_lm_ref import one_torch_thread  # noqa: F401 (autouse)

ARCH = "qwen3-1.7b"
BATCH, SEQ = 4, 32


def _stream(cls, cfg):
    return cls(vocab=cfg.vocab, batch=BATCH, seq_len=SEQ, seed=0)


def _trainer(model, ckpt_dir, **kw):
    return Trainer(model, AdamW(state_dtype="float32"),
                   _stream(TokenStream, model.cfg), ckpt_dir=str(ckpt_dir),
                   lr_fn=cosine_schedule(3e-3, warmup=2, total=8),
                   device="cpu", **kw)


def _tiny_model():
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_layers=2,
                              d_model=64, head_dim=16, d_ff=128)
    model = build_model(cfg)
    return model, model.init(torch.Generator().manual_seed(0))


def test_trainer_matches_reference(tmp_path):
    r_model, r_params, model, params = carry(ARCH)
    r_tr = RTrainer(r_model, RAdamW(state_dtype="float32"),
                    _stream(RTokenStream, model.cfg),
                    ckpt_dir=str(tmp_path / "ref"),
                    lr_fn=r_cosine(3e-3, warmup=2, total=8))
    r_tr.run(4, state=RTrainState(
        step=jnp.zeros((), jnp.int32), params=r_params,
        opt_state=RAdamW(state_dtype="float32").init(r_params)),
        resume=False)
    tr = _trainer(model, tmp_path / "port")
    state = tr.run(4, state=tr.state_from(params), resume=False)
    assert int(state.step) == 4
    want = [h["loss"] for h in r_tr.history]
    got = [h["loss"] for h in tr.history]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    assert [h["skipped"] for h in tr.history] == [0.0] * 4


def _leaves(state):
    return [state.step] + [state.params[k] for k in sorted(state.params)] + [
        t[k] for t in (state.opt_state.mu, state.opt_state.nu)
        for k in sorted(t)] + [state.opt_state.count]


def test_resume_is_bit_exact(tmp_path):
    model, params = _tiny_model()
    whole = _trainer(model, tmp_path / "a", ckpt_every=100)
    end = whole.run(4, state=whole.state_from(params), resume=False)
    first = _trainer(model, tmp_path / "b", ckpt_every=2)
    first.run(2, state=first.state_from(params), resume=False)
    assert first.manager.all_steps() == [2]
    second = _trainer(model, tmp_path / "b", ckpt_every=100)
    resumed = second.run(4, state=second.state_from(params))
    assert [h["step"] for h in second.history] == [2, 3]
    assert [h["loss"] for h in second.history] == [
        h["loss"] for h in whole.history[2:]]
    for a, b in zip(_leaves(resumed), _leaves(end)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_sigterm_saves_at_the_next_step_and_stops(tmp_path):
    model, params = _tiny_model()
    tr = _trainer(model, tmp_path, ckpt_every=100)
    nxt = tr.stream.next

    def next_and_signal():
        batch = nxt()
        if tr.stream.step == 2:            # during step 1
            os.kill(os.getpid(), signal.SIGTERM)
        return batch
    tr.stream.next = next_and_signal
    old = signal.getsignal(signal.SIGTERM)
    try:
        state = tr.run(10, state=tr.state_from(params), resume=False)
    finally:
        signal.signal(signal.SIGTERM, old)
    assert int(state.step) == 2 and len(tr.history) == 2
    assert tr.manager.all_steps() == [2]


def test_nan_step_is_skipped_with_an_emergency_checkpoint(tmp_path):
    model, params = _tiny_model()
    calls = []

    class Poisoned:
        cfg = model.cfg

        @staticmethod
        def loss(p, batch):
            calls.append(1)
            out = model.loss(p, batch)
            return out + float("nan") if len(calls) == 2 else out
    tr = _trainer(Poisoned, tmp_path, ckpt_every=100)
    before = {}

    def keep(state):
        before.update({k: v.clone() for k, v in state.params.items()})
    step_fn = tr.step_fn

    def step(state, batch):
        if len(calls) == 1:
            keep(state)
        return step_fn(state, batch)
    tr.step_fn = step
    state = tr.run(3, state=tr.state_from(params), resume=False)
    assert [h["skipped"] for h in tr.history] == [0.0, 1.0, 0.0]
    assert tr.manager.all_steps() == [1]
    _, extra = tr.manager.restore_flat(1)
    assert extra["emergency"] is True
    restored, _ = tr.manager.restore(1, state)
    for k, v in before.items():
        assert torch.equal(restored.params[k], v), k
    assert int(state.step) == 3


def test_bfloat16_state_checkpoints_bit_for_bit(tmp_path):
    model, params = _tiny_model()
    params = {k: v.to(torch.bfloat16) for k, v in params.items()}
    opt = AdamW(state_dtype="bfloat16")
    state = TrainState(step=torch.tensor(7, dtype=torch.int32), params=params,
                       opt_state=opt.init(params))
    state.opt_state.mu["embed/tok"].normal_()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, state)
    like = TrainState(step=torch.zeros((), dtype=torch.int32),
                      params={k: torch.zeros_like(v) for k, v in
                              params.items()},
                      opt_state=opt.init(params))
    step, got, _ = mgr.restore_latest(like)
    assert step == 7
    for a, b in zip(_leaves(got), _leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_launch_train_runs_and_resumes(tmp_path, capsys):
    argv = ["--arch", "granite-moe-1b-a400m", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2", "--json"]
    out = train.main(argv + ["--steps", "3"])
    assert (out["first_step"], out["last_step"]) == (0, 2)
    assert out["checkpoints"] == [2] and out["skipped"] == 0
    assert all(np.isfinite(out["losses"]))
    assert out["device"] == "cpu" and out["peak_hbm_bytes"] is None
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2].startswith("steps 0..2  loss ")
    assert json.loads(lines[-1])["arch"] == "granite-moe-1b-a400m"
    again = train.main(argv + ["--steps", "4"])
    assert (again["first_step"], again["last_step"]) == (2, 3)


def test_train_lm_example_runs(tmp_path, capsys):
    out = train_lm.main(["--device", "cpu", "--steps", "4", "--batch", "2",
                         "--seq", "16", "--ckpt-dir", str(tmp_path),
                         "--json"])
    assert out["example"] == "train_lm" and len(out["losses"]) == 4
    assert out["skipped"] == 0
    text = capsys.readouterr().out
    assert "loss: first10=" in text and "NaN-guard skips: 0" in text
    assert json.loads(text.strip().splitlines()[-1])["steps"] == 4


def test_entry_points_refuse_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", ARCH, "--steps", "1",
                    "--ckpt-dir", str(tmp_path)])
