"""Batched serving demo: the Engine drives decode steps over a request
queue with greedy sampling and fixed-capacity batches; the port of the
reference's `examples/serve_lm.py`.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--arch qwen3-1.7b]
        [--batch 4] [--max-seq 64] [--full] [--device cpu] [--json]

Serves the reduced config unless `--full` asks for the published width.
The weights are drawn from a seeded generator on the device.  Dense
configs only (ROADMAP item 16).
"""
import time

import torch

from ..configs import get_config
from ..convert import resolve_device
from ..models import build_model
from ..serving.engine import Engine, Request
from ._common import emit, fail, parser


def requests():
    """The reference demo's five requests (the fifth opens a second batch
    at batch 4)."""
    return [
        Request(prompt=[5, 17, 42], max_new=12),
        Request(prompt=[9, 9, 9, 9], max_new=8),
        Request(prompt=[100, 200], max_new=10),
        Request(prompt=[7], max_new=6),
        Request(prompt=[1, 2, 3, 4, 5], max_new=12),
    ]


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--full", action="store_true",
                    help="the config at its published width, not reduced()")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0))
    n_params = sum(p.numel() for p in params.values())
    engine = Engine(model, params, batch=args.batch, max_seq=args.max_seq)

    t0 = time.perf_counter()
    done = engine.generate(requests())
    dt = time.perf_counter() - t0
    total_new = sum(len(r.out) for r in done)
    size = "full" if args.full else "reduced"
    steps = engine.steps
    step_ms = engine.step_seconds / max(steps, 1) * 1e3
    print(f"[{args.arch} {size}] served {len(done)} requests, "
          f"{total_new} tokens in {dt:.2f}s ({total_new / dt:.1f} tok/s, "
          f"{steps} decode steps of {args.batch}, "
          f"{step_ms:.2f} ms a step)")
    for i, r in enumerate(done):
        print(f"  req{i}: prompt={r.prompt} -> {r.out}")
    # determinism: the same prompt alone reproduces its batched output
    again = engine.generate([Request(prompt=[5, 17, 42], max_new=12)])
    invariant = again[0].out == done[0].out
    result = {"example": "serve_lm", "device": str(dev), "arch": args.arch,
              "full": args.full, "params": n_params, "batch": args.batch,
              "max_seq": args.max_seq, "tokens": [r.out for r in done],
              "new_tokens": total_new, "seconds": dt,
              "tokens_per_s": total_new / dt, "decode_steps": steps,
              "decode_ms_per_step": step_ms,
              "batch_invariant": invariant}
    if not invariant:
        fail("batch-composition must not matter")
    print("batch-composition invariance: OK")
    return emit(result, args)


if __name__ == "__main__":
    main()
