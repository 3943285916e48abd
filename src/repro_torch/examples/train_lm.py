"""End-to-end LM training example: data pipeline -> model -> optimizer ->
checkpointed training loop with auto-resume and NaN guard; the port of the
reference's `examples/train_lm.py`.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300]
        [--arch qwen3-1.7b] [--device cpu] [--json]

Uses the REDUCED config of the chosen architecture.  Interrupt it (SIGTERM)
and re-run: it resumes from the latest checkpoint in `--ckpt-dir` (by
default a directory under the system's temporary directory) and replays
the data stream exactly.
"""
import os
import tempfile

from ..configs import get_config
from ..launch.train import stream_for, summary
from ..models import build_model
from ..optim import AdamW, cosine_schedule
from ..training.trainer import Trainer
from ._common import emit, parser


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    model = build_model(cfg)
    trainer = Trainer(
        model, AdamW(state_dtype="float32"),
        stream_for(cfg, args.batch, args.seq),
        ckpt_dir=args.ckpt_dir,
        lr_fn=cosine_schedule(3e-3, warmup=20, total=args.steps),
        ckpt_every=50, device=args.device,
    )
    state = trainer.run(args.steps, resume=True)
    losses = [h["loss"] for h in trainer.history]
    result = {"example": "train_lm", "arch": args.arch,
              "steps": args.steps, "batch": args.batch, "seq": args.seq,
              **summary(trainer, state, args.batch, args.seq)}
    if losses:
        k = max(len(losses) // 10, 1)
        first, last = sum(losses[:k]) / k, sum(losses[-k:]) / k
        skips = sum(h["skipped"] for h in trainer.history)
        print(f"[{args.arch} reduced] steps {trainer.history[0]['step']}..."
              f"{int(state.step) - 1}")
        print(f"loss: first10={first:.4f} last10={last:.4f}")
        print(f"stragglers flagged: {trainer.watchdog.outliers}, "
              f"NaN-guard skips: {skips:.0f}")
        result.update(first10=first, last10=last)
    print(f"checkpoints in {args.ckpt_dir}: "
          f"steps {trainer.manager.all_steps()}", flush=True)
    return emit(result, args)


if __name__ == "__main__":
    main()
