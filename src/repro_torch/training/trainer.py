"""Train step factory + fault-tolerant training loop; port of
`repro.training.trainer`.

make_train_step builds the (state, batch) -> (state, metrics) update:
  * the gradient of the model loss with respect to every param (remat
    lives in the model: `cfg.remat == "full"` recomputes each period),
  * optional microbatch gradient accumulation, optionally in a narrower
    dtype (`accum_dtype`, the gradient-compression knob),
  * global-norm clipping,
  * NaN/Inf guard: a non-finite loss or gradient norm SKIPS the update
    (params and optimizer state pass through unchanged, bit for bit) and
    raises a flag the loop turns into an emergency checkpoint.

Trainer adds the fleet-behaviour shell around it: checkpoint/auto-resume,
SIGTERM -> checkpoint at the next step boundary, step-time EWMA watchdog
(straggler detection).  The step runs eagerly: each call is the reference's
jitted step's arithmetic, op for op.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..checkpoint.manager import CheckpointManager
from ..convert import resolve_device
from ..optim import OptState, clip_by_global_norm


class TrainState(NamedTuple):
    step: torch.Tensor
    params: Dict[str, torch.Tensor]
    opt_state: OptState


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    grad_norm: torch.Tensor
    skipped: torch.Tensor   # 1.0 if the NaN guard suppressed the update


def value_and_grad(loss_fn: Callable, params: Dict[str, torch.Tensor],
                   batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, d loss / d param for every param), the loss detached; a param
    the loss does not reach gets a zero gradient, as `jax.grad` gives."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    with torch.enable_grad():
        loss = loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True, materialize_grads=True)
    return loss.detach(), dict(zip(leaves, grads))


def make_train_step(loss_fn: Callable, optimizer, lr_fn: Callable,
                    clip_norm: float = 1.0, microbatches: int = 1,
                    accum_dtype: Optional[str] = None):
    """loss_fn(params, batch) -> scalar.  Returns the step function."""
    acc_dt = getattr(torch, accum_dtype) if accum_dtype else None

    def compute_grads(params, batch):
        if microbatches <= 1:
            return value_and_grad(loss_fn, params, batch)

        def split(x):
            b = x.shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatches} microbatches")
            return x.reshape((microbatches, b // microbatches)
                             + tuple(x.shape[1:]))
        mb = {k: split(v) for k, v in batch.items()}
        dev = next(iter(params.values())).device
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        g_acc = {k: torch.zeros(p.shape, dtype=acc_dt or p.dtype,
                                device=p.device) for k, p in params.items()}
        for i in range(microbatches):
            loss, g = value_and_grad(loss_fn, params,
                                     {k: v[i] for k, v in mb.items()})
            g_acc = {k: g_acc[k] + (g[k] if acc_dt is None
                                    else g[k].to(acc_dt)) for k in g_acc}
            loss_acc = loss_acc + loss
        inv = 1.0 / microbatches
        return loss_acc * inv, {k: g * inv for k, g in g_acc.items()}

    def train_step(state: TrainState, batch
                   ) -> Tuple[TrainState, StepMetrics]:
        loss, grads = compute_grads(state.params, batch)
        with torch.no_grad():
            grads, gn = clip_by_global_norm(grads, clip_norm)
            lr = lr_fn(state.step)
            new_params, new_opt = optimizer.update(grads, state.opt_state,
                                                   state.params, lr)
            finite = torch.isfinite(loss) & torch.isfinite(gn)

            def pick(new, old):     # written into `new`: no second copy
                if type(new) is not torch.Tensor:   # a DTensor: no out=
                    return torch.where(finite, new, old)
                return torch.where(finite, new, old, out=new)
            new_params = {k: pick(new_params[k], state.params[k])
                          for k in new_params}
            new_opt = OptState(
                count=pick(new_opt.count, state.opt_state.count),
                mu={k: pick(v, state.opt_state.mu[k])
                    for k, v in new_opt.mu.items()},
                nu={k: pick(v, state.opt_state.nu[k])
                    for k, v in new_opt.nu.items()})
        new_state = TrainState(step=state.step + 1, params=new_params,
                               opt_state=new_opt)
        return new_state, StepMetrics(loss=loss, grad_norm=gn,
                                      skipped=1.0 - finite.float())

    return train_step


@dataclasses.dataclass
class Watchdog:
    """Step-time EWMA straggler detector (fleet behaviour, CPU-testable)."""
    alpha: float = 0.1
    threshold: float = 3.0
    ewma: Optional[float] = None
    outliers: int = 0

    def observe(self, dt: float) -> bool:
        if self.ewma is None:
            self.ewma = dt
            return False
        slow = dt > self.threshold * self.ewma
        if slow:
            self.outliers += 1
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow


class Trainer:
    """The loop: one `make_train_step` step a batch of `stream`, on
    `device` (the card unless the caller asks for the CPU)."""

    def __init__(self, model, optimizer, stream, ckpt_dir: str,
                 lr_fn=None, clip_norm: float = 1.0, microbatches: int = 1,
                 ckpt_every: int = 50, keep_last: int = 3,
                 accum_dtype: Optional[str] = None, device="cuda"):
        self.model = model
        self.stream = stream
        self.optimizer = optimizer
        self.device = resolve_device(device)
        self.manager = CheckpointManager(ckpt_dir, keep_last=keep_last)
        lr_fn = lr_fn or (lambda step: 1e-3)
        self.step_fn = make_train_step(model.loss, optimizer, lr_fn,
                                       clip_norm, microbatches, accum_dtype)
        self.ckpt_every = ckpt_every
        self.watchdog = Watchdog()
        self._stop = False
        self.history = []

    def _install_sigterm(self):
        def handler(signum, frame):
            self._stop = True     # checkpoint at next step boundary
        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass                   # non-main thread (tests)

    def state_from(self, params: Dict[str, torch.Tensor]) -> TrainState:
        """Step 0 of `params`, with a fresh optimizer state."""
        return TrainState(
            step=torch.zeros((), dtype=torch.int32, device=self.device),
            params=dict(params), opt_state=self.optimizer.init(params))

    def init_state(self, seed: int = 0) -> TrainState:
        return self.state_from(self.model.init(
            torch.Generator(self.device).manual_seed(seed)))

    def run(self, num_steps: int, state: Optional[TrainState] = None,
            resume: bool = True) -> TrainState:
        self._install_sigterm()
        if state is None:
            state = self.init_state()
        if resume:
            got = self.manager.restore_latest(state)
            if got is not None:
                step, state, extra = got
                if "stream" in extra:
                    self.stream.restore(extra["stream"])
        start = int(state.step)
        for i in range(start, num_steps):
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.stream.next().items()}
            state, metrics = self.step_fn(state, batch)
            loss = float(metrics.loss)          # waits for the step
            dt = time.perf_counter() - t0
            slow = self.watchdog.observe(dt)
            skipped = float(metrics.skipped)
            self.history.append({"step": i, "loss": loss, "time": dt,
                                 "skipped": skipped,
                                 "straggler": bool(slow)})
            if skipped > 0:
                # emergency checkpoint on NaN guard trip
                self.manager.save(i, state, {"stream": self.stream.state(),
                                             "emergency": True})
            if (i + 1) % self.ckpt_every == 0 or self._stop:
                self.manager.save(i + 1, state,
                                  {"stream": self.stream.state()})
            if self._stop:
                break
        return state
