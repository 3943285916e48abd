"""How many kernels a `ProfilerHook` window loses from its trace on the
card, with the hook's bursts as they are, with an opening burst of tiny
kernels back to back for 5 ms and no closing one, and with no burst.

    PYTHONPATH=src python3 tests/torch_trace_loss.py [--windows 25]

Each window is chunks 2-3 of a six-chunk loop whose chunks run 25
iterations of 4 launches that each stream 256 MB and 20 tiny launches, a
host read ending each chunk, as the engine's loop does.  For every
variant it prints, a window a line, what `chip_smoke.py`'s
`trace_kernels` reads from the trace (`lost`: the loop's launches whose
kernel is missing; `lost_hook`: those of each burst; `skew_us`: the least
time from a launch to its kernel's start on the trace's clock) and the
trace's size, then a summary line a variant.  Needs a card; not
collected by pytest.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

sys.path[:0] = [os.path.join(os.path.dirname(__file__), "..", "src"),
                os.path.join(os.path.dirname(__file__), "..")]
from chip_smoke import trace_kernels  # noqa: E402
from repro_torch.obs import profile  # noqa: E402

BURST = profile.ProfilerHook._burst


def _opening_5ms(hook, name):
    if name != "ProfilerHook.prime":
        return
    with torch.profiler.record_function(name):
        x = torch.zeros(32, device=hook._device)
        t0, n = time.perf_counter(), 0
        while n < 256 or time.perf_counter() - t0 < 0.005:
            x.add_(1.0)
            n += 1
        torch.cuda.synchronize(hook._device)


VARIANTS = {
    "hook": BURST,
    "opening_5ms": _opening_5ms,
    "none": lambda hook, name: None,
}


def window(dev, variant, trace_dir):
    profile.ProfilerHook._burst = VARIANTS[variant]
    big = torch.ones(64 << 20, device=dev)
    small = torch.ones(4096, device=dev)
    hook = profile.ProfilerHook(trace_dir, start_chunk=2, num_chunks=2)
    for chunk in range(6):
        hook.chunk_start(chunk, None, device=dev)
        for _ in range(25):
            for _ in range(4):
                big.mul_(1.0)
            for _ in range(20):
                small.add_(1.0)
        small[:4].cpu()
        hook.chunk_end(chunk, None)
    hook.stop(None)
    counts, _, _, lost = trace_kernels(hook.trace_paths[0])
    return dict(lost, loop_kernels=counts.get("other", 0),
                hook_kernels=counts.get("hook", 0),
                trace_bytes=os.path.getsize(hook.trace_paths[0]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=25,
                    help="windows a variant, taken in turn")
    args = ap.parse_args()
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), torch.__version__)
    rows = []
    for rep in range(args.windows):
        for variant in VARIANTS:
            with tempfile.TemporaryDirectory() as tmp:
                row = dict(window(dev, variant, tmp), variant=variant,
                           rep=rep)
            print(json.dumps(row), flush=True)
            rows.append(row)
    for variant in VARIANTS:
        rs = [r for r in rows if r["variant"] == variant]
        print(json.dumps({
            "variant": variant, "windows": len(rs),
            "windows_losing_loop_kernels": sum(r["lost"] > 0 for r in rs),
            "loop_kernels_lost": sum(r["lost"] for r in rs),
            "loop_kernels_a_window": 2 * 25 * 24,
            "most_lost_from_opening_burst": max(
                r["lost_hook"]["prime"] for r in rs),
            "most_lost_from_closing_burst": max(
                r["lost_hook"]["drain"] for r in rs),
            "least_skew_us": min(r["skew_us"] for r in rs),
            "largest_trace_bytes": max(r["trace_bytes"] for r in rs)}))


if __name__ == "__main__":
    main()
