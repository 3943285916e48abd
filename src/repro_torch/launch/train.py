"""Training launcher of the port:
`python -m repro_torch.launch.train --arch <id> [...]`.

Counterpart of `python -m repro.launch.train`.  Runs the REDUCED config
unless `--full-config` asks for the published width, on the card by
default (`--device cpu` runs on the CPU; without a card the default
raises).  Wires together: config -> model -> data stream -> optimizer ->
fault-tolerant Trainer (checkpoint/resume/NaN-guard/SIGTERM).  It resumes
from the newest checkpoint in `--ckpt-dir` (by default a directory of the
arch's under the system's temporary directory).  Prints the reference's
line; `--json` adds one result object last, with the step times, tokens/s
and, on the card, peak device memory.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
from typing import Optional

import torch

from ..configs import arch_ids, get_config
from ..data.pipeline import TokenStream
from ..models import build_model
from ..optim import AdamW, Adafactor, cosine_schedule
from ..training.trainer import Trainer


def stream_for(cfg, batch: int, seq: int) -> TokenStream:
    """The reference launchers' synthetic stream for a config (frames or
    patches stand-ins where it has a frontend)."""
    return TokenStream(vocab=cfg.vocab, batch=batch, seq_len=seq, seed=0,
                       frontend=cfg.frontend,
                       n_frontend=cfg.n_frontend_tokens or 16,
                       d_model=cfg.d_model)


def summary(trainer: Trainer, state, batch: int, seq: int) -> dict:
    """What a run did: its steps and losses, NaN-guard skips, stragglers,
    step times (host clock, each step ending in its loss's read) and
    tokens/s over the steps after the first, and on the card the peak
    device memory since the process started or the last reset."""
    h = trainer.history
    times = [r["time"] for r in h]
    steady = statistics.median(times[1:] or times) if times else None
    dev = trainer.device
    return {
        "device": str(dev),
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else None,
        "params": sum(p.numel() for p in state.params.values()),
        "first_step": h[0]["step"] if h else None,
        "last_step": h[-1]["step"] if h else None,
        "losses": [r["loss"] for r in h],
        "skipped": sum(r["skipped"] for r in h),
        "stragglers": trainer.watchdog.outliers,
        "first_step_ms": times[0] * 1e3 if times else None,
        "step_ms": steady * 1e3 if steady else None,
        "tokens_per_s": batch * seq / steady if steady else None,
        "peak_hbm_bytes": torch.cuda.max_memory_allocated(dev)
        if dev.type == "cuda" else None,
        "checkpoints": trainer.manager.all_steps(),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=arch_ids())
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full assigned config (its published "
                         "width) instead of reduced()")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the port runs (default: the card; it "
                         "raises without one)")
    ap.add_argument("--json", action="store_true",
                    help="print the result as one JSON object, last")
    return ap


def main(argv: Optional[list] = None) -> dict:
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.reduced()
    model = build_model(cfg)
    stream = stream_for(cfg, args.batch, args.seq)
    if args.optimizer == "adamw":
        opt = AdamW(state_dtype=cfg.optstate_dtype)
    else:
        opt = Adafactor()
    trainer = Trainer(
        model, opt, stream,
        ckpt_dir=args.ckpt_dir or os.path.join(
            tempfile.gettempdir(), f"repro_torch_ckpt_{args.arch}"),
        lr_fn=cosine_schedule(args.lr, warmup=max(args.steps // 20, 5),
                              total=args.steps),
        microbatches=args.microbatches,
        ckpt_every=args.ckpt_every,
        device=args.device,
    )
    state = trainer.run(args.steps, resume=True)
    if trainer.history:
        h0, h1 = trainer.history[0], trainer.history[-1]
        print(f"steps {h0['step']}..{h1['step']}  "
              f"loss {h0['loss']:.4f} -> {h1['loss']:.4f}  "
              f"stragglers={trainer.watchdog.outliers}", flush=True)
    result = {"arch": args.arch, "full_config": args.full_config,
              "batch": args.batch, "seq": args.seq,
              "optimizer": args.optimizer, "remat": cfg.remat,
              "param_dtype": cfg.param_dtype,
              "optstate_dtype": cfg.optstate_dtype,
              **summary(trainer, state, args.batch, args.seq)}
    if args.json:
        print(json.dumps(result, sort_keys=True), flush=True)
    return result


if __name__ == "__main__":
    main()
