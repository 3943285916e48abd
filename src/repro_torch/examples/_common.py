"""What the examples share: the `--device` / `--json` flags, the kernels'
launch counts of a run, the failure exit and the JSON line."""
from __future__ import annotations

import argparse
import json
from typing import Dict

from ..kernels import launch_counts


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the port runs (default: the card; it "
                         "raises without one)")
    ap.add_argument("--json", action="store_true",
                    help="print the result as one JSON object, last")
    return ap


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    return {name: n - before[name] for name, n in launch_counts().items()}


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def emit(result: dict, args) -> dict:
    if args.json:
        print(json.dumps(result, sort_keys=True), flush=True)
    return result

