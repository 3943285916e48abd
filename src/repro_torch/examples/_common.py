"""What the examples share: the `--device` / `--json` flags, the kernels'
launch counts of a run, the failure exit and the JSON line."""
from __future__ import annotations

import argparse
import json
from typing import Dict


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the port runs (default: the card; it "
                         "raises without one)")
    ap.add_argument("--json", action="store_true",
                    help="print the result as one JSON object, last")
    return ap


def _wrappers():
    from ..kernels.ax_reduce import ax_reduce_plan, ax_reduce_plan_x
    from ..kernels.dual_grad import dual_grad_slab, dual_x_slab
    from ..kernels.proj import proj_boxcut
    return dict(dual_x_slab=dual_x_slab, ax_reduce_plan_x=ax_reduce_plan_x,
                dual_grad_slab=dual_grad_slab, ax_reduce_plan=ax_reduce_plan,
                proj_boxcut=proj_boxcut)


def launch_counts() -> Dict[str, int]:
    """K1-K5's launch counters now, by wrapper name (they count launches
    on the card only; a run on the CPU leaves them as they were)."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    return {name: n - before[name] for name, n in launch_counts().items()}


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def emit(result: dict, args) -> dict:
    if args.json:
        print(json.dumps(result, sort_keys=True), flush=True)
    return result

