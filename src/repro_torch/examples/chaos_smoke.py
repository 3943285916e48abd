"""Chaos smoke: kill the solve launcher mid-run, resume it, demand the
exact trajectory (DESIGN.md §9); the port of the reference's
`examples/chaos_smoke.py`.

    PYTHONPATH=src python -m repro_torch.examples.chaos_smoke [--quick]

The preemption drill, end to end through the real process surface of
`python -m repro_torch.launch.solve`:

  1. run it to completion with checkpointing on; save the duals;
  2. run it again, read its output as it comes for the first `checkpoint
     saved:` line, then deliver SIGTERM at once — the launcher's handler
     flushes a final checkpoint at the next chunk boundary and exits
     cleanly with stop reason `preempted`;
  3. relaunch with `--resume`: the fingerprint check accepts, the solve
     continues from the restored state, and the final duals must match the
     uninterrupted run's with drift ≤ 1e-7 (they are bitwise equal);
  4. in process on the same instance size: a transient NaN chunk under the
     health guard rolls back and still runs to its cap.

The launcher runs on `--device` and finds the package through PYTHONPATH
set to this package's own location.  The interrupted run's output is read
through a pipe, line by line, not polled from its log file: on the card
the rest of the 120 iterations can take less than the reference's 0.2 s
poll, and a SIGTERM that lands after the solve's handler is gone kills
the launcher.  Exits non-zero on any miss: no
checkpoint line, unclean death, refused resume, dual drift, or an
unguarded recovery.
"""
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from ..convert import lp_to_torch, resolve_device
from ..core import (HealthConfig, InstanceSpec, MatchingObjective,
                    SolveConfig, SolveEngine, StopReason, StoppingCriteria,
                    generate, precondition)
from ..testing import ChunkFaultInjector
from ._common import emit, fail, launch_counts, launches_since, parser

# the directory holding the repro_torch package
SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def launch(args, extra, log_path, watch=None):
    """Start the launcher with its output in `log_path`.  With `watch`,
    its output comes through a pipe that a thread copies to the log line
    by line, setting the returned event at the first line holding
    `watch`; returns (process, (event, thread)), else (process, None)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    base = [sys.executable, "-m", "repro_torch.launch.solve",
            "--sources", str(args.sources), "--destinations", "50",
            "--iterations", str(args.iterations),
            "--check-every", str(args.check_every),
            "--checkpoint-every", str(args.check_every),
            "--seed", "11", "--device", args.device]
    if watch is None:
        with open(log_path, "w") as log:
            return subprocess.Popen(base + extra, stdout=log,
                                    stderr=subprocess.STDOUT, env=env), None
    proc = subprocess.Popen(base + extra, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, env=env, text=True)
    seen = threading.Event()

    def pump():
        with open(log_path, "w") as log:
            for line in proc.stdout:
                log.write(line)
                log.flush()
                if watch in line:
                    seen.set()

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    return proc, (seen, reader)


def _read(path):
    with open(path) as f:
        return f.read()


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--sources", type=int, default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    args.sources = args.sources or (1500 if args.quick else 20000)
    args.iterations = 120
    args.check_every = 20
    before = launch_counts()
    result = {"example": "chaos_smoke", "device": str(dev),
              "sources": args.sources}

    failures = []
    t_drill = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck")
        ref_npz = os.path.join(tmp, "ref.npz")
        res_npz = os.path.join(tmp, "resumed.npz")

        # 1. uninterrupted reference (its own checkpoint dir, kept apart)
        print("== reference run ==", flush=True)
        p, _ = launch(args, ["--checkpoint-dir", os.path.join(tmp, "ck_ref"),
                             "--save-duals", ref_npz],
                      os.path.join(tmp, "ref.log"))
        if p.wait(timeout=600) != 0:
            failures.append("reference run exited non-zero")

        # 2. kill mid-solve after the first checkpoint commits
        print("== interrupted run (SIGTERM) ==", flush=True)
        log1 = os.path.join(tmp, "run1.log")
        p, (seen, reader) = launch(args, ["--checkpoint-dir", ck], log1,
                                   watch="checkpoint saved:")
        if not seen.wait(timeout=300):
            failures.append("no checkpoint line before timeout")
            p.kill()
        else:
            p.send_signal(signal.SIGTERM)
        rc = p.wait(timeout=300)
        reader.join(timeout=60)
        body = _read(log1)
        if rc != 0:
            failures.append(f"interrupted run exited {rc} (want clean 0)")
        if "stop reason: preempted" not in body:
            failures.append("interrupted run did not report 'preempted'")
        lines = body.strip().splitlines()
        result["interrupted_last_line"] = lines[-1] if lines else ""
        print(result["interrupted_last_line"])

        # 3. resume to completion; duals must match the reference
        print("== resumed run ==", flush=True)
        log2 = os.path.join(tmp, "run2.log")
        p, _ = launch(args, ["--checkpoint-dir", ck, "--resume",
                             "--save-duals", res_npz], log2)
        rc = p.wait(timeout=600)
        body = _read(log2)
        if rc != 0:
            failures.append(f"resumed run exited {rc}")
        if "resumed from checkpoint step" not in body:
            failures.append("resume did not restore a checkpoint")
        if failures:
            fail("; ".join(failures))
        ref = np.load(ref_npz)["lam"]
        got = np.load(res_npz)["lam"]
        drift = float(np.abs(ref - got).max())
        print(f"dual drift vs uninterrupted: {drift:.3e}")
        result["dual_drift"] = drift
        if not drift <= 1e-7:
            failures.append(f"dual drift {drift:.3e} > 1e-7")
    result["drill_seconds"] = time.perf_counter() - t_drill

    # 4. in-process fault injection: transient NaN -> rollback -> recovery,
    # on the objective the reference's default builds (scatter)
    print("== health-guard recovery ==", flush=True)
    spec = InstanceSpec(num_sources=min(args.sources, 2000),
                        num_destinations=50, avg_nnz_per_row=8, seed=11)
    lp, _ = precondition(lp_to_torch(generate(spec), dev), row_norm=True)
    obj = MatchingObjective(lp, ax_mode="scatter")
    eng = SolveEngine(obj.calculate,
                      SolveConfig(iterations=args.iterations, gamma=0.01,
                                  max_step=1e-1, initial_step=1e-5))
    eng.chunk_fault_hook = ChunkFaultInjector(at_it=args.check_every,
                                              times=1)
    res = eng.solve(torch.zeros(obj.dual_shape, dtype=torch.float32,
                                device=dev),
                    criteria=StoppingCriteria(tol_grad_norm=0.0,
                                              check_every=args.check_every),
                    health=HealthConfig())
    if res.stop_reason != StopReason.MAX_ITERATIONS:
        failures.append(f"guarded solve stopped {res.stop_reason}")
    if not res.health or res.health[0].action != "rollback":
        failures.append("fault was not detected/rolled back")
    if not bool(torch.isfinite(res.lam).all()):
        failures.append("guarded solve returned non-finite duals")
    health = [(r.status, r.action) for r in res.health]
    print(f"health records: {health}")
    result.update(health=[list(h) for h in health],
                  guarded_stop_reason=res.stop_reason.value,
                  guarded_iterations=res.iterations_run,
                  launches=launches_since(before))
    if failures:
        fail("; ".join(failures))
    print("chaos smoke: all checks passed")
    return emit(result, args)


if __name__ == "__main__":
    main()
