#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU:  python3 chip_smoke.py

Run from the root of a checkout.  Imports the port (`src/repro_torch`) and
nothing of JAX or of the JAX package.  Phases, each failing loudly:

  1. device   the card's name and power limit (nvidia-smi), CUDA version
  2. build    nvcc builds every kernel from src/repro_torch/kernels/csrc
  3. main     the port's CLI entry point, in process, at 2M sources x 10k
              destinations (nu = 25): generate (once for phases 3 and 6),
              row-normalize, agd to tolerance with adaptive continuation
              on the x-carry aligned path, certificate.  Every kernel's
              launch counter is set to 0 just before and read just after;
              each kernel of the path must have launched.  Then the
              counters of one dual evaluation (what an agd iteration runs
              once), and its time: synchronised and host enqueue without
              the profiler, and the device's kernel time in a window
              profiled for device activity alone (idle share against
              the unprofiled synchronised time).
  4. kernels  K1 and K2 against their plain PyTorch versions on the card,
              on the main path's own tensors (K1: every slab in float32,
              bfloat16 copies of the widest and narrowest, and every slab
              bit for bit against its kernel-order plain version at 4, 8
              and 16 values a lane, each layout timed; the bisection's
              steps at the final lambda and at lambda = 0; K2: every
              bucket alone and the whole plan in one call, float32 and a
              bfloat16 copy, bit for bit against its kernel-order plain
              version), with times (CUDA events, median of 20 after
              warm-up), the bound max(bytes, operations) (K1 and K3: the
              operations at each row's own bisection steps, at the float32
              lane rate; the SASS loop's lockstep issue time printed
              beside it), and a library yardstick where one PyTorch call
              computes the same function (K2: the ratio to it, and the
              same Ax over work tables of other item sizes and bands);
              then row norms and 50 main-path iterations, each twice, bit
              for bit
  5. gvals    the main path's instance again through the CLI entry point
              with --ax-mode aligned_gvals --certify (K3 + K4), then one
              evaluation there equal bit for bit to the aligned path's at
              its final lambda; K3 (as K1 in 4), K4 (as K2 in 4, and
              equal to K2's Ax bit for bit) and K5 against their plain
              versions at the main path's shapes, timed as in 4 (K5
              through its entry point `ops.proj_boxcut`, on every slab's
              pre-projection u, which it must map to K1's x and to its
              kernel-order plain version bit for bit; its steps, and its
              bound at each row's own steps); then the same instance with
              --ax-mode scatter
  6. wide     rows wider than 1,024 (one block a row): 3,000 x 5,000 at
              nu = 1000 (a 2,048-wide slab) through the CLI entry point,
              50 iterations against the reference CLI's dual, then to
              tolerance with a valid certificate; K1, K3, K5 on its 3 x
              2,048 slab and on a synthetic 8,192 x 2,048 throughput slab,
              timed beside their plain versions and bounds, with the wide
              routine's steps; K1, K3, K5 bit for bit against their
              block-order plain versions there and at widths 2,048,
              8,192, 16,384 and 32,768 (chunks in registers, shared
              memory, global scratch); then each of the three storages
              of a row's chunks timed against the others at widths
              2,048, 4,096 and 8,192, on 2^24 entries and on 3 rows
  7. parity   the reference's recorded perf_lp/tol_agd run (2000 x 1000,
              nu = 4, seed 42) in each ax mode: converged, final dual
              within 1e-4 relative of -2340.3547, stopped within one check
              of where the reference's own ax modes stop; aligned, scatter
              and sorted twice each bit-identical, aligned_gvals
              bit-identical to aligned; then GlobalCountObjective (count row normalized)
              with the count at 90 % of the unconstrained sum of x, which
              must converge and bind
  8. rules    the other update rules and the fault-tolerance path.  The
              main path's instance (generated once in phase 3) through
              the CLI entry point with --algorithm pdhg --certify:
              converged, a valid certificate, K1 and K2 launched, its
              final dual within 1e-3 relative of phase 3's agd dual; bb and
              pga on its objective for a fixed 200 iterations each, finite.
              On phase 3's objective: a guarded agd run equal to the
              unguarded one bit for bit, a transient chunk fault rolled
              back once and converging, a NaN objective stopping DIVERGED
              after max_retries + 1 records, and pdhg preempted after 4
              chunks, checkpointed to disk and resumed, equal bit for bit
              to the uninterrupted run (lambda, iterations, dual
              trajectory).  Parity: perf_lp/tol_pdhg and tol_bb twice each
              in aligned, bit-identical, converged, duals within 1e-4 of
              the reference's and stopping within one check of the
              reference's own spread; pga's fixed 300 iterations within
              1e-5 of the port's CPU run.  The CLI's --save-duals then
              --warm-start (continuation skipped), --checkpoint-dir then
              --resume (ending on the uninterrupted run's bits), and
              --resume under another --algorithm (refused), at parity size
  9. forms    the formulations.  The main path's instance through the CLI
              entry point with --formulation multi_budget --algorithm pdhg
              --certify (two coupling rows folded into K1's c): converged
              within 6,000 iterations, K1 and K2 launched, a valid
              certificate, both rows' use within 1 % of their limits; one
              evaluation against phase 3's at the same destination block,
              and the shift fold's own time.  assignment_eq at full width
              for 50 iterations: finite, K2 launched, K1 not (its
              simplex_eq block has no kernel and runs the plain sweep).
              compile_formulation(matching) equal to phase 3's objective
              bit for bit at its final lambda.  Parity with the
              reference's perf_lp formulation rows: agd twice on
              global_count, multi_budget and assignment_eq (each pair
              bit-identical), pdhg on each, bb on multi_budget and
              assignment_eq: converged, duals within 1e-4 of the recorded
              ones, stops inside FORM_WINDOWS; multi_budget in
              aligned_gvals (K3 + K4) along aligned's trajectory bit for
              bit
 10. ranks    the distributed solve (repro_torch.core.distributed).  (a)
              in this process, a one-rank NCCL group: the main path's
              instance (still the one phase 3 generated) through the CLI
              entry point, whose matching path is the distributed solve,
              in aligned with --certify and in aligned_gvals: iterations,
              final dual, lambda and certificate bit for bit phase 3's
              and phase 5's, ms/iteration beside theirs, and the time of
              one all_reduce of the step's m*J + 2 floats (CUDA events)
              with its bytes.  (b) two ranks spawned on this card over
              gloo at perf_lp/tol_agd's instance in aligned on a (2, 1)
              grid, twice: converged, final dual within 1e-4 relative of
              the reference's, stopped within one check of its window,
              the two runs' bits compared and printed; then, if gloo
              takes CUDA tensors in all_gather and reduce-scatter (probed
              and printed either way), lambda split on a (1, 2) grid,
              held the same.  Each rank has a hard timeout.  (c) with
              more than one card, (b) over NCCL on every card; with one,
              a line saying it was not run
 11. serve    run after phase 9 and before phase 10, which frees phase 3's
              objective: the allocation server (repro_torch.primal) on it
              and its final lambda.  (a) the snapshot build's time and
              warmup (K1 launched once a shape); (b) >= 10,000 random
              sources over every slab served bit for bit equal to
              obj.primal, and every source of phase 6's wide cell (its
              2,048-wide slab); K1 on 8-, 64- and 256-row sub-slabs
              against its plain version (atol 1e-4), timed (CUDA events;
              device time profiled) beside each microbatch's bound; (c)
              500 queries each of 1, 8, 64 and 256 sources on one thread:
              p50, p95, sources/s, K1 launches a query; (d) the whole
              instance through write_shards, read back bit for bit equal
              to extract_primal (seconds, sources/s, bytes), and the
              CLI's --export-primal at parity size; (e) warm_resolve onto
              b x 0.99 with a certificate required, queries after the
              swap bit for bit the new objective's primal, an
              ExplodingObjective refused (degraded, lambda unchanged) and
              cleared by a forced success; one thread's queries idle and
              beside a fixed re-solve on the two streams and on one;
              (f) a ServerFrontend drill: client threads at twice the
              one-thread capacity for 10 s, a refresh mid-run, one
              /metrics scrape over loopback, then drain: every ticket
              classified, 0 ERROR, no OK past its deadline.  K1's and
              K2's launches of (a)-(e), each run counted alone, go into
              the kernels line (launches_serving)
 12. obs      run after phase 11 and before phase 10: the solve's
              observability.  (a) phase 3's objective solved twice in turn
              through Maximizer, bare and with a JSONL run log, a memory
              sampler and a torch.profiler window over chunks 2-3: lambda,
              the stats, iterations and stop reason bit for bit; the log
              valid with one check event a diagnostic; the trace's K1 and
              K2 kernels (a K2 call is two CUDA launches) equal to the
              launch counters over the window; the manifest's peak HBM
              between the census's argument bytes and
              max_memory_allocated; the census's K1 and K2 bytes equal to
              phase 4's; ms/iteration of both, the execute / host split
              of `report.summarize`.  (b) the wide cell through the CLI's
              main with --certify --log-jsonl --profile-dir --metrics-port
              0 --max-host-rss-mb 1 --json: stdout one object with its
              peaks, the guard fired once, the report renders the log, the
              metrics digest has the memory series; aligned_gvals's census
              names K3 and K4.  (c) a NaN objective under a profiler window
              stops DIVERGED and leaves its trace
 13. examples run after phase 10: each solver example of the port as a
              user runs it, `python -m repro_torch.examples.<name> --json`
              in a process of its own at the reference example's default
              sizes (quickstart, moe_lp_routing, formulations_tour,
              matching_scale on a one-rank NCCL group, chaos_smoke with its
              three CLI processes, allocation_server's tour and its
              --load-test --metrics-port 0 drill; the tour also at --quick,
              the reference's CI size, EXAMPLE_RUNS): exit 0, its own
              criterion (converged, VALID, bitwise, drift <= 1e-7 and a
              rollback, distributed < 1e-2, balanced routing; quickstart's
              stop within one check and its dual at 1e-4 of the
              reference's), and the launches of its path's kernels from
              its JSON (K1 + K2 for aligned, K3 for scatter), each printed
              with its numbers and seconds.  The tour at its default size
              may end at its 4,000-iteration cap unconverged, as the
              reference's kernel path does there (CAP_RUNS): recorded as a
              fault.  Then, in this process, each example's kernels on its
              own objective (K3 for quickstart, moe_lp_routing and the
              chaos guard; K1 and K2 for formulations_tour, matching_scale
              and allocation_server) against their plain versions
 14. lm       qwen3-1.7b at full width in bfloat16, drawn on the card from
              a seeded generator (1,720,837,120 parameters, peak HBM
              printed): (a) serve_lm's five requests at batch 4, max_seq
              64, greedy, batch-composition invariant; (b) the logits
              after 8 decode steps against prefill's at atol 2e-2 / rtol
              1e-2, max |diff| printed; (c) the reduced config in float32,
              prefill and decode logits on the card against the CPU's on
              the same weights at 1e-4 of the largest; (d) decode ms a step
              and tokens/s at batch 4 and 32 (CUDA events) beside the
              bytes bound
 15. families the other families in bfloat16, drawn on the card from a
              seeded generator: granite-moe-1b-a400m, mamba2-780m,
              seamless-m4t-medium and pixtral-12b at their published
              width, llama4-scout-17b-a16e at its width and 2 of its 48
              layers (109 B params do not fit), each with its count and
              peak HBM: (a) serve_lm's five requests at batch 4, max_seq
              64, greedy (granite and llama4 under einsum and gather,
              their tokens printed side by side; batch-composition
              invariance required where no MoE capacity drop can move a
              token, printed otherwise); (b) granite (capacity factor
              raised to E) and mamba2: the logits after 8 decode steps
              against prefill's in float32 at atol 2e-2 / rtol 1e-2, the
              bfloat16 max |diff| printed; seamless's prefill with 64
              frames and pixtral's with its 1,024 patch stand-ins: finite,
              moved by them; (c) the six non-dense reduced configs
              (jamba's 398 B only so) in float32, prefill and decode on
              the card against the CPU on the same weights at 1e-4 of the
              largest; (d) decode ms a step and tokens/s at batch 4 and 32
              (CUDA events) beside the bytes bound (every weight read once
              a step; with the caches; for MoE with only top-k experts)
 16. train    (a) `python -m repro_torch.launch.train --arch qwen3-1.7b
              --full-config --steps 10 --lr 1e-3` as a process (batch 8 x
              seq 128, bfloat16 params, float32 AdamW state, remat full):
              no step skipped, the first loss within 1 of ln(vocab), the
              last below it; (b) granite-moe-1b and mamba2-780m at full
              width, 5 steps each through `launch.train.main`, the same
              checks; each with step ms, tokens/s and peak HBM; (c) the
              seven reduced configs' loss (1e-5 relative) and every
              gradient (`TRAIN_GRAD_*`) in float32 on the card against
              the CPU; (d) a NaN patch batch skipped with params and
              optimizer state bit for bit, and a reduced qwen3 run
              checkpointed at step 2 and resumed ending on the
              uninterrupted run's params (1e-6 relative; bit for bit
              printed); (e) `python -m repro_torch.examples.train_lm
              --json` as a process at its default (reduced, 300 steps):
              the loss falling, no skip
 17. tools    (a) the op walker (launch/op_cost.py) over qwen3-1.7b's
              decode step at batch 4 with its params placed as DTensors
              by `param_pspecs` on a 1 x 1 NCCL mesh: dot FLOPs, bytes,
              the H100 roofline bound (launch/analysis.py), held at most
              the step's measured median (CUDA events), the bytes at
              least the weights'; (b) the same over qwen3's AdamW train
              step at batch 8 x 128, its dot FLOPs beside 8·N·D; (c)
              that sharded decode step's logits bit for bit the plain
              step's; (d) the dry run (launch/dryrun.py) of lp-matching
              on both production meshes and of qwen3-1.7b decode_32k on
              (16, 16): HBM, the three roofline terms, the dominant one

The last three lines of standard output are the card's name and power
limit, the kernels' JSON record, and {"ok": true, "device": {...}}.  Exits
non-zero, printing no result, when there is no card.

  python3 chip_smoke.py --rank-worker SPEC

is one rank of phase 10 (b) and (c), which spawns it.

  python3 chip_smoke.py --kernel-times DIR

only times K1, K3 and K5 of the checkout unpacked at DIR (another commit,
say) on phase 6's wide slabs, and prints one JSON line: run it for two
commits in turn, in one session on one card, to compare them.
"""
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

DEVICE = "cuda"


def _load_analysis():
    """This checkout's `repro_torch/launch/analysis.py` (numpy only), read
    from its file so that `--kernel-times` can import another checkout's
    package."""
    import importlib.util
    path = os.path.join(ROOT, "src", "repro_torch", "launch", "analysis.py")
    spec = importlib.util.spec_from_file_location("_h100_analysis", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the port's H100 SXM roofline figures (launch/analysis.py): HBM3 device
# memory and dense bfloat16 tensor cores
_ANALYSIS = _load_analysis()
HBM_BYTES_PER_S = _ANALYSIS.HBM_BW
BF16_OPS_PER_S = _ANALYSIS.PEAK_FLOPS
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
MAIN_ARGS = ["--sources", "2000000", "--destinations", "10000",
             "--nnz-per-row", "25", "--seed", "42",
             "--adaptive-continuation", "--tol-rel-dual", "1e-6",
             "--check-every", "25", "--iterations", "3000", "--certify",
             "--json", "--device", "cuda"]
WIDE_ARGS = ["--sources", "3000", "--destinations", "5000",
             "--nnz-per-row", "1000", "--seed", "42", "--json",
             "--device", "cuda"]
# the final dual of `python -m repro.launch.solve --sources 3000
# --destinations 5000 --nnz-per-row 1000 --seed 42 --iterations 50 --json`,
# the reference CLI on a CPU
WIDE_DUAL_50 = -13033.7939453125
PARITY_DUAL = -2340.354736328125       # perf_lp/tol_agd, bench_results.json
# where the reference's own ax modes stop on that instance (scatter 1600,
# sorted 1625, aligned and aligned_gvals 2150; JAX on a CPU): at
# tol_rel_dual 1e-6 the stopping check moves with the summation order alone
PARITY_ITERATIONS = (1600, 2150)
PARITY_CHECK = 25
# perf_lp/tol_pdhg and tol_bb (bench_results.json: 600 and 10,525
# iterations), and the window their stop is held in: where the reference's
# rule stops (JAX on a CPU, tests/torch_stop_iterations.py) in its own ax
# modes (pdhg 850-1,225, bb 10,400-10,725) and on the port's objective
# (pdhg 725, bb 11,725), with the recorded row.  At tol_rel_dual 1e-6 the
# stop is float32 noise of the objective's sums, which the ax modes alone
# do not sample: the port's rule on the reference's objective stops inside
# the ax modes' window (pdhg 750, bb 10,650)
RULE_PARITY = {"pdhg": (-2340.39697265625, (600, 1225)),
               "bb": (-2340.354736328125, (10400, 11725))}
# the port's dual after a fixed 300 pga iterations on the parity instance,
# float32 on a CPU (tests/test_torch_rules.py, PGA_300_DUAL)
PGA_300_DUAL = -2353.14990234375
# the dual drift the main path's pdhg run may show against phase 3's agd
MAIN_RULE_DRIFT = 1e-3
RULE_ITERATIONS = 200   # bb's and pga's fixed run on the main path
PARITY_ARGS = ["--sources", "2000", "--destinations", "1000",
               "--nnz-per-row", "4", "--seed", "42", "--json",
               "--device", "cuda"]
# phase 9: the reference's recorded perf_lp/tol_<rule>_<formulation> rows
# (bench_results.json: 2000 x 1000, nu = 4, seed 42, row_norm, aligned),
# stopping iteration and final dual, each dual held at 1e-4 relative
FORM_RECORDED = {
    ("agd", "global_count"): (1650, -2278.330322265625),
    ("agd", "multi_budget"): (6600, -1585.3785400390625),
    ("agd", "assignment_eq"): (1850, -3452.912109375),
    ("pdhg", "global_count"): (1025, -2278.3271484375),
    ("pdhg", "multi_budget"): (375, -1585.4058837890625),
    ("pdhg", "assignment_eq"): (750, -3452.91357421875),
    ("bb", "multi_budget"): (1375, -1585.6009521484375),
    ("bb", "assignment_eq"): (7875, -3452.911865234375),
}
# the window each stop is held in, one check wider (tests/
# torch_stop_iterations.py --formulation, JAX and the port on a CPU).
# agd: the reference's own ax modes and its recorded row.  pdhg and bb:
# each package's rule in its own ax modes and on the other's objective,
# and the recorded row: at tol_rel_dual 1e-6 their stop follows the
# float32 sums of g, and the port's sums of c'x are the nearer to exact
# (its dual sits ~1.7e-6 below the reference's at the same lambda)
FORM_WINDOWS = {
    ("agd", "global_count"): (1075, 1675),
    ("agd", "multi_budget"): (6575, 6650),
    ("agd", "assignment_eq"): (1600, 1850),
    ("pdhg", "global_count"): (925, 3325),
    ("pdhg", "multi_budget"): (375, 775),
    ("pdhg", "assignment_eq"): (600, 750),
    ("bb", "multi_budget"): (1325, 1425),
    ("bb", "assignment_eq"): (7825, 8100),
}
# phase 9's full-width multi_budget run under pdhg: its iteration cap, and
# how near its limit each coupling row's use must end (relative)
FORM_MAIN_CAP = 6000
FORM_BIND_TOL = 1e-2
FORM_FIXED = 50     # assignment_eq's fixed iterations at full width
# work tables (item size C, band entries) timed beside the default
TABLE_SWEEP = ((2048, None), (1024, None), (4096, None), (1024, 1 << 22),
               (4096, 1 << 22), (2048, 1 << 21), (2048, 1 << 23))
# K1's and K3's values a lane, timed on the main path's slabs (the
# float32 kernels of the swept layouts cover rows up to 64 wide)
VPT_SWEEP = (4, 8, 16)
# widths at which K1, K3, K5's wide path is held bit for bit (chunks in
# registers, registers, shared memory, global scratch), and the rows and
# width of its throughput slab
WIDE_BITS = (2048, 8192, 16384, 32768)
THROUGHPUT_SLAB = (8192, 2048)
# widths at which phase 6 times the wide path's chunks in each storage
# (registers, shared memory, global scratch) on a slab of 2^24 entries
# and on one of 3 rows
STORE_WIDTHS = (2048, 4096, 8192)
STORE_ENTRIES = 1 << 24
STORE_NAMES = ("registers", "shared", "global")
WRAPPERS = {}    # kernel wrapper name -> wrapper, with its launch counter


def log(msg):
    print(msg, flush=True)


def require(ok, msg):
    """Fail the phase (a plain check, not `assert`, so -O cannot drop it)."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of `fn` on the card over `reps` timed calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def _dual_x_instance(mangled):
    """(dtype, L, VPT, gvals) of a mangled dual_x.cu register-path kernel
    name, else None."""
    m = re.search(r"dual_x_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELb([01])E",
                  mangled)
    if not m:
        return None
    return ("f32" if m.group(1) == "f" else "bf16", int(m.group(2)),
            int(m.group(3)), m.group(4) == "1")


def ptxas_dual_x(log_text):
    """{(dtype, L, VPT, gvals): (registers, spill store bytes)} of the
    dual_x kernel instances, from nvcc's -Xptxas -v output."""
    out, cur, spill = {}, None, 0
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur, spill = _dual_x_instance(m.group(1)), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            out[cur] = (int(m.group(1)), spill)
            cur = None
    return out


def ptxas_wide(log_text):
    """{"K1|K3|K5 type layout": (registers, spill store bytes)} of the
    wide kernels (chunk C, or "mem" for staged rows) and K5's register
    path (L x VPT), from nvcc's -Xptxas -v output."""
    pat = re.compile(r"(dual_x_wide_kernel|proj_wide_kernel|proj_rows_kernel)"
                     r"I(f|13__nv_bfloat16)Li(\d+)E(?:Li(\d+)E)?(?:Lb([01])E)?")
    out, cur, spill = {}, None, 0
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = pat.search(m.group(1))
            cur, spill = None, 0
            if k:
                kind = ("K3" if k.group(5) == "1" else "K1") if k.group(
                    1).startswith("dual") else "K5"
                dt = "f32" if k.group(2) == "f" else "bf16"
                lay = (f"{k.group(3)}x{k.group(4)}" if k.group(4)
                       else f"C={k.group(3)}" if k.group(3) != "0" else "mem")
                cur = f"{kind} {dt} {lay}"
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            out[cur] = (int(m.group(1)), spill)
            cur = None
    return out


@functools.lru_cache(maxsize=None)
def sass_loop_counts():
    """{(dtype, L, VPT, gvals): instructions of one bisection step} of the
    dual_x kernel instances, from `cuobjdump -sass` of the built library:
    the innermost loop (a backward branch) whose body holds the warp vote
    of `boxcut_tau_chunk`'s loop condition."""
    from repro_torch.kernels import _build
    txt = subprocess.run([_build.cuda_tool("cuobjdump"), "-sass",
                          str(_build.library_path("dual_x"))],
                         capture_output=True, text=True, check=True).stdout
    funcs, key, labels = {}, None, {}
    pending = []
    for line in txt.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            key = _dual_x_instance(m.group(1))
            if key is not None:
                funcs[key], labels[key] = [], {}
            continue
        if key is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(.*?)\s*;", line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[key][lab] = addr
            pending = []
            funcs[key].append((addr, m.group(2)))
    counts = {}
    for key, ins in funcs.items():
        best = None
        for addr, text in ins:
            if not re.search(r"\bBRA\b", text):
                continue
            m = re.search(r"(0x[0-9a-f]+)\s*$", text)
            lab = re.search(r"\((\.L_x_\d+)\)", text)
            tgt = (int(m.group(1), 16) if m else
                   labels[key].get(lab.group(1)) if lab else None)
            if tgt is None or tgt >= addr:
                continue
            body = [t for a, t in ins if tgt <= a <= addr]
            if (any("VOTE" in t for t in body)
                    and (best is None or len(body) < len(best))):
                best = body
        if best is not None:
            counts[key] = len(best)
    return counts


def sm_clock_mhz():
    """(current, maximum) SM clock of card 0 in MHz, from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader,nounits", "-i", "0"],
                         capture_output=True, text=True,
                         check=True).stdout.split(",")
    return float(out[0]), float(out[1])


def steps_stats(width, n, v, ubp, s, lay, iters, mask):
    """One slab's bisection, from the plain early-exit version on the card
    in the kernels' order of the sums, `v`, `ubp` its rows as the kernels
    hold them at layout `lay` (L lanes a row, or a block of 256 threads
    past 1,024), `mask` its real entries: rows, real entries, real
    entries x the steps of their row (the work of the function's loop:
    padding and columns past the width add exactly +0 and are not
    counted), rows with f0 > s, the steps each such row ran to a fixed
    bracket, and the mean steps a warp (a block past 1,024) runs, the
    largest of its rows', the warp looping while any is not done."""
    import torch
    from repro_torch.kernels import ref
    if lay[0] > 32:
        _, steps = ref.bisect_block_ref(v, ubp, s, iters)
        groups = 1
    else:
        _, steps = ref.bisect_lanes_ref(v, ubp, s, iters, lay)
        groups = 32 // lay[0]
    warp = torch.nn.functional.pad(steps, (0, (-n) % groups))
    warp = warp.reshape(-1, groups).amax(dim=1)
    ran = steps[steps > 0].double()
    real = mask.sum(dim=1, dtype=torch.int64)
    return {"width": width, "rows": n, "entries": int(real.sum()),
            "entry_steps": int((real * steps).sum()),
            "need": int((steps > 0).sum()),
            "mean": float(ran.mean()) if ran.numel() else 0.0,
            "max": int(steps.max()), "warps": warp.numel(),
            "warp_mean": float(warp.double().mean())}


def bisection_steps(slabs, lam, g, iters):
    """`steps_stats` of K1's (and K3's) bisection on every slab at lam."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.dual_grad import kernel_layout
    stats = []
    for s in slabs:
        lay = kernel_layout(s.width)
        v, ubp = ref.lanes_u(s.a_vals, s.c_vals, s.dest_idx, s.mask, s.ub,
                             lam, g, lay)
        stats.append(steps_stats(s.width, s.n, v, ubp, s.s, lay, iters,
                                 s.mask))
        del v, ubp
    return stats


def proj_steps(slabs, us, iters):
    """`steps_stats` of K5's bisection on every slab's u."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.dual_grad import kernel_layout
    stats = []
    for s, u in zip(slabs, us):
        lay = kernel_layout(s.width)
        v, ubp = ref.pad_rows(u, s.ub, s.mask, lay[0] * lay[1])
        stats.append(steps_stats(s.width, s.n, v, ubp, s.s, lay, iters,
                                 s.mask))
        del v, ubp
    return stats


def steps_line(what, stats):
    need = sum(x["need"] for x in stats)
    rows = sum(x["rows"] for x in stats)
    mean = sum(x["mean"] * x["need"] for x in stats) / max(need, 1)
    return (f"bisection at {what}: {need} of {rows} rows have f0 > s "
            f"({need / rows:.4f}); steps to a fixed bracket: mean {mean:.3f}, "
            f"max {max(x['max'] for x in stats)}; by slab (width: share, "
            f"mean, max, mean a warp) " + ", ".join(
                f"{x['width']}: {x['need'] / x['rows']:.4f}, {x['mean']:.2f}, "
                f"{x['max']}, {x['warp_mean']:.2f}" for x in stats))


def lockstep_issue(stats, gvals, iters):
    """A diagnostic, not the bound: the issue time in ms of the built
    kernels' bisection loops as they run, per slab warps x the loop's SASS
    instructions a step x the mean steps a warp runs (the largest of its
    rows', done rows idling in lockstep) or `iters`, at 4 warp
    instructions a clock an SM at the card's maximum SM clock.  Returns
    (counted ms, ms at `iters` steps, {layout: instructions a step})."""
    import torch
    from repro_torch.kernels.dual_grad import row_layout
    counts = sass_loop_counts()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    _, clk = sm_clock_mhz()
    rate = 4 * sms * clk * 1e6                  # warp instructions a second
    counted = fixed = 0.0
    per = {}
    for x in stats:
        L, V = row_layout(x["width"])
        key = ("f32", L, V, gvals)
        require(key in counts, f"no bisection loop found in the SASS of "
                f"dual_x_kernel {key}")
        per[f"{L}x{V}"] = counts[key]
        counted += x["warps"] * x["warp_mean"] * counts[key]
        fixed += x["warps"] * iters * counts[key]
    return counted / rate * 1e3, fixed / rate * 1e3, per


# float32 operations an entry of K1's function, each one lane-operation
# (an FMA counts once), counted at real entries only (padding and columns
# past the width add exactly +0, which the function does not need): a
# bisection step sums clip(v − mid, 0, ub) over the row's real entries
# (subtract, max, min, add); outside the loop f0 and max v (max, min,
# add, max), u = −(aᵀλ + c)/γ (m multiply-adds, an add, a scale),
# x = clip(v − τ, 0, ub) (3) and the c·x and x·x partials (2).  K3 adds
# m multiplies an edge for gvals.
OPS_A_STEP, OPS_ENTRY, OPS_REAL = 4, 4, 7


# float32 operations at a real edge of K5's function: x = clip(v − τ, 0, ub)
OPS_X = 3


def real_ops(real, m, gvals):
    """The float32 operations K1's (K3's) function does at its `real`
    edges outside the loop."""
    return real * (OPS_REAL + m + (m if gvals else 0))


def issue_bound(stats, ops_real, iters):
    """The bisection's least issue time in ms: the operations the
    function needs on these inputs, each row's own steps to a fixed
    bracket (`stats`, from `steps_stats`) over its real entries, f0 and
    max v there, plus `ops_real` at them, at 128 float32 lanes a clock an
    SM at the card's maximum SM clock (the 67 TFLOP/s of an H100 counts
    an FMA as 2).  Returns (ms, ms at `iters` steps a row, operations, SMs,
    MHz)."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    _, clk = sm_clock_mhz()
    rate = 128 * sms * clk * 1e6                # lane operations a second
    rest = sum(x["entries"] for x in stats) * OPS_ENTRY + ops_real
    ops = OPS_A_STEP * sum(x["entry_steps"] for x in stats) + rest
    ops40 = OPS_A_STEP * iters * sum(x["entries"] for x in stats) + rest
    return ops / rate * 1e3, ops40 / rate * 1e3, ops, sms, clk


def steps_bound(nbytes, stats, ops_real, iters):
    """(bound ms, bound_by, bytes ms, issue ms): max(bytes over the card's
    memory rate, the issue time at each row's own steps)."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    issue_ms = issue_bound(stats, ops_real, iters)[0]
    return (max(bytes_ms, issue_ms),
            "bytes" if bytes_ms >= issue_ms else "operations", bytes_ms,
            issue_ms)


def lanes_checks(what, kernel, lanes_ref, slabs, lam, g, iters):
    """Every slab through `kernel` (K1 or K3, at its default layout and at
    4 and 16 values a lane) bit for bit against its kernel-order plain
    version; then one sweep timed at each.  Returns {VPT cap: ms}."""
    import torch
    from repro_torch.kernels import dual_grad as dg
    from repro_torch.kernels.dual_grad import row_layout
    for s in slabs:
        for cap in VPT_SWEEP:
            lay = row_layout(s.width, cap)
            got = kernel(s, lay)
            want = lanes_ref(*s[:6], lam, g, iters, lay)
            require(all(torch.equal(u, v) for u, v in zip(got, want)),
                    f"{what} w={s.width} layout {lay}: not the bits of its "
                    f"kernel-order plain version")
    sweep = {}
    for cap in VPT_SWEEP:
        lays = [row_layout(s.width, cap) for s in slabs]
        sweep[cap] = cuda_ms(lambda: [kernel(s, lay)
                                      for s, lay in zip(slabs, lays)])
    log(f"{what}  f32 all {len(slabs)} slabs at VPT caps {VPT_SWEEP} (layouts "
        + ", ".join(f"w={s.width}: " + "/".join(
            str(row_layout(s.width, c)) for c in VPT_SWEEP) for s in slabs)
        + "): x, scalars" + (", gvals" if "grad" in what else "")
        + " equal the kernel-order plain version bit for bit; one sweep "
        + ", ".join(f"VPT {c}: {t:.4f} ms" for c, t in sweep.items())
        + f" (default VPT {dg.VPT})")
    return sweep


def slab_errors(slabs, lam, g, iters, gvals=False):
    """K1 (with `gvals`, K3) on every slab against its plain version:
    (max |dx| (and |dgvals|), the scalars' largest relative error)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.dual_grad import dual_grad_slab, dual_x_slab
    err_x, err_s = 0.0, 0.0
    for s in slabs:
        if gvals:
            x, gv, cx, xsq = dual_grad_slab(*s[:6], lam, g, iters=iters)
            xr, gr, cxr, xsqr = ref.dual_grad_ref(*s[:6], lam, g, iters)
            err_x = max(err_x, float((gv - gr).abs().max()))
        else:
            x, cx, xsq = dual_x_slab(*s[:6], lam, g, iters=iters)
            xr, cxr, xsqr = ref.dual_x_ref(*s[:6], lam, g, iters)
        err_x = max(err_x, float((x - xr).abs().max()))
        for u, v in ((cx, cxr), (xsq, xsqr)):
            err_s = max(err_s, abs(float(u) - float(v))
                        / max(abs(float(v)), 1e-30))
    return err_x, err_s


def check_dual_x(obj, lam, gamma):
    """K1 on every slab of the main path against its plain version and,
    bit for bit, its kernel-order plain version; the bisection's steps at
    the final lambda and at lambda = 0; one sweep timed at three layouts;
    the bound max(bytes, issue).  Returns the record and the steps."""
    import torch
    from repro_torch.kernels import dual_grad as dg
    from repro_torch.kernels import ref
    from repro_torch.kernels.dual_grad import dual_x_slab
    from repro_torch.launch import census
    slabs = obj.lp.slabs
    g = torch.full((), gamma, dtype=torch.float32, device=lam.device)
    iters = obj.proj_iters
    err_x, err_s = slab_errors(slabs, lam, g, iters)
    require(err_x <= 1e-4, f"dual_x: max |dx| {err_x} > 1e-4")
    require(err_s <= 1e-5, f"dual_x: scalar rel err {err_s} > 1e-5")
    log(f"dual_x_slab  f32 all {len(slabs)} slabs: max|dx| {err_x:.3e} "
        f"(atol 1e-4), scalars rel {err_s:.3e} (rtol 1e-5)")
    widths = sorted(range(len(slabs)), key=lambda i: slabs[i].width)
    for si in (widths[0], widths[-1]):
        s = slabs[si]
        sb = [t.to(torch.bfloat16) if t.is_floating_point() else t
              for t in s[:6]]
        x, cx, xsq = dual_x_slab(*sb, lam, g, iters=iters)
        xr, cxr, xsqr = ref.dual_x_ref(*sb, lam, g.to(torch.bfloat16), iters)
        e = float((x.float() - xr.float()).abs().max())
        es = max(abs(float(cx) - float(cxr)) / max(abs(float(cxr)), 1e-30),
                 abs(float(xsq) - float(xsqr)) / max(abs(float(xsqr)), 1e-30))
        require(e <= 5e-2 and es <= 5e-2,
                f"dual_x bf16 w={s.width}: {e}, {es}")
        log(f"dual_x_slab  bf16 w={s.width}: max|dx| {e:.3e}, scalars rel "
            f"{es:.3e} (tol 5e-2)")
    sweep = lanes_checks(
        "dual_x_slab",
        lambda s, lay: dg._launch(dual_x_slab, *s[:6], lam, g, iters, None,
                                  None, lay),
        ref.dual_x_lanes_ref, slabs, lam, g, iters)
    steps = bisection_steps(slabs, lam, g, iters)
    log(steps_line("the final lambda", steps))
    log(steps_line("lambda = 0",
                   bisection_steps(slabs, torch.zeros_like(lam), g, iters)))

    def kernel():
        for s in slabs:
            dual_x_slab(*s[:6], lam, g, iters=iters)

    def plain():
        for s in slabs:
            ref.dual_x_ref(*s[:6], lam, g, iters)

    ms = cuda_ms(kernel)
    plain_ms = cuda_ms(plain, reps=5, warmup=1)
    m, J = lam.shape
    # the launch census's count (phase 12 holds evaluation_census to it)
    c = census.slab_counts(slabs)
    nbytes = census.sweep_bytes(c, m, J)
    real, padded, rows, ea, ec, eu = (c.real, c.padded, c.rows, c.ea, c.ec,
                                      c.eu)
    rec = {"name": "dual_x_slab", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/dual_x.cu",
           "replaces": "src/repro/kernels/dual_grad.py:80",
           "max_abs_err": err_x, "ms": ms, "plain_ms": plain_ms,
           "library_ms": None, "bytes": nbytes}
    rec.update(_lanes_bound("dual_x_slab", nbytes, steps, real, m, False,
                            iters, sweep))
    log(f"dual_x_slab  one sweep ({len(slabs)} slabs, {real} real edges of "
        f"{padded}): {ms:.4f} ms; plain {plain_ms:.4f} ms; bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); bytes = real*({ea}m + "
        f"{ec} c + 4 dest + {eu} ub) + padded*(1 mask + {ec} x) + {rows} "
        f"rows*s + 4mJ")
    return rec, steps


def _lanes_bound(what, nbytes, steps, real, m, gvals, iters, sweep):
    """K1's or K3's bound max(bytes, issue) and its parts, logged: the
    issue term from the operations the function needs at each row's own
    steps; the SASS loop's lockstep issue time beside it."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    issue_ms, issue40_ms, ops, sms, clk = issue_bound(
        steps, real_ops(real, m, gvals), iters)
    lock_ms, lock40_ms, per = lockstep_issue(steps, gvals, iters)
    log(f"{what}  bound = max({nbytes} bytes / 3.35 TB/s = {bytes_ms:.4f} ms, "
        f"issue {issue_ms:.4f} ms) = {max(bytes_ms, issue_ms):.4f} ms; issue "
        f"= {ops} float32 operations ({OPS_A_STEP} a step over each row's "
        f"real entries x its own steps to a fixed bracket, {OPS_ENTRY} + "
        f"{OPS_REAL} + m{' + m' if gvals else ''} a real edge outside the "
        f"loop) "
        f"at 128 lanes a clock on {sms} SMs at {clk:.0f} MHz; at {iters} "
        f"steps a row: {issue40_ms:.4f} ms.  Diagnostic, not the bound: the "
        f"built loop in lockstep (SASS instructions a step by layout L x "
        f"VPT: {per}, x warps x mean steps a warp, at 4 warp instructions "
        f"a clock an SM): {lock_ms:.4f} ms, at {iters} steps {lock40_ms:.4f} "
        f"ms")
    return {"bound_ms": max(bytes_ms, issue_ms),
            "bound_by": "bytes" if bytes_ms >= issue_ms else "operations",
            "bound_bytes_ms": bytes_ms, "bound_issue_ms": issue_ms,
            "bound_issue_fixed_count_ms": issue40_ms,
            "lockstep_issue_ms": lock_ms,
            "lockstep_issue_fixed_count_ms": lock40_ms,
            "loop_instructions": per,
            "ms_by_vpt": {str(c): t for c, t in sweep.items()}}


def _ax_plan_checks(what, plan, work, src, m, kernel, plain, items_kw):
    """One plan-level Ax (K2 or K4) into a NaN-filled buffer against its
    plain version (rtol 1e-5 of max(1, |ax|)) and, bit for bit, against
    the kernels' own order of the sums; twice, bit-identical.  Returns
    the Ax and its max |error|."""
    import torch
    from repro_torch.kernels import ref
    J = plan.num_destinations
    outs = []
    for _ in range(2):
        out = torch.full((m, J), float("nan"), device=src.device)
        kernel(src, plan, out, work)
        outs.append(out)
    require(not torch.isnan(outs[0]).any(),
            f"{what}: a destination was not written")
    require(torch.equal(outs[0], outs[1]), f"{what}: two runs differ")
    want = plain(plan, src)
    rel = float(((outs[0] - want).abs() / want.abs().clamp_min(1.0)).max())
    require(rel <= 1e-5, f"{what}: rel err {rel} > 1e-5")
    require(torch.equal(outs[0], ref.ax_items_ref(plan, work, **items_kw)),
            f"{what}: not the bits of its kernel-order plain version")
    return outs[0], float((outs[0] - want).abs().max())


def _bf16_plan(plan):
    from repro_torch.core.types import AxPlan
    import torch
    return AxPlan(tuple(b._replace(a_dm=None if b.a_dm is None else
                                   b.a_dm.to(torch.bfloat16))
                        for b in plan.buckets), plan.inv_perm)


def _ax_items_line(work, plan):
    lens = (work.items[:, 3] - work.items[:, 2]).long()
    return (f"work table: {work.items.shape[0]} items of at most C = "
            f"{work.item_entries} entries ({int(lens.sum())} entries read of "
            f"{sum(b.mask.numel() for b in plan.buckets)} in the plan), "
            f"{work.multi.shape[0]} rows of several items, "
            f"{work.num_partials} partials")


def _table_sweep(what, plan, full, ms, run):
    """The same Ax over work tables of other item sizes C and bands, each
    checked against `full` and timed as the default table was (`ms`).
    Returns {"C/band": ms}."""
    import torch
    from repro_torch.kernels.ax_reduce import (BAND_ENTRIES, ITEM_ENTRIES,
                                               plan_work)
    sweep = {f"{ITEM_ENTRIES}/{BAND_ENTRIES}": ms}
    for c, band in TABLE_SWEEP:
        work = plan_work(plan, c, band)
        require(torch.allclose(run(work), full, rtol=1e-5, atol=1e-5),
                f"{what} C={c} band={band}")
        sweep[f"{c}/{band}"] = cuda_ms(lambda: run(work))
    log(f"{what}  one Ax by work table (item size C / band entries, "
        f"{ITEM_ENTRIES}/{BAND_ENTRIES} the default): " + ", ".join(
            f"{k}: {v:.4f} ms" for k, v in sweep.items()))
    return sweep


def check_ax_reduce(obj):
    """K2 on every bucket of the main path's plan (one bucket a call) and
    on the whole plan (one call, the main path's) against its plain
    version, fed the main path's own x buffer."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ax_reduce import (ax_reduce_bucket_x,
                                               ax_reduce_plan_x, plan_work)
    plan, x, work = obj._plan, obj._xbuf, obj._work
    m, J = obj.lp.m, obj.lp.num_destinations
    out = torch.full((m, J), float("nan"), device=x.device)
    for b in plan.buckets:
        ax_reduce_bucket_x(x, b.a_dm, b.edge_idx, b.mask, b.dest_ids, out)
        want = ref.ax_reduce_x_ref(x, b.a_dm, b.edge_idx, b.mask).T
        got = out[:, b.dest_ids.long()]
        rel = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
        require(rel <= 1e-5, f"ax_reduce w={b.width}: rel err {rel} > 1e-5")
    require(not torch.isnan(out).any(),
            "ax_reduce: a destination was not written")
    full, err = _ax_plan_checks("ax_reduce_plan_x", plan, work, x, m,
                                ax_reduce_plan_x, ref.ax_plan_x_ref,
                                {"x": x})
    require(torch.equal(full, out),
            "ax_reduce_x: the plan and the per-bucket calls differ in bits")
    log(f"ax_reduce_plan_x  f32, all {len(plan.buckets)} buckets (widths "
        f"{plan.buckets[0].width}..{plan.buckets[-1].width}) one by one and "
        f"as one plan: max|d ax| {err:.3e} (rtol 1e-5 of max(1, |ax|)); the "
        f"two, two runs and the kernel-order plain version (ref.ax_items_ref) "
        f"bit for bit; {_ax_items_line(work, plan)}")
    plan_b, xb = _bf16_plan(plan), x.to(torch.bfloat16)
    ob = torch.full((m, J), float("nan"), device=x.device)
    ax_reduce_plan_x(xb, plan_b, ob, plan_work(plan_b))
    want = ref.ax_plan_x_ref(plan_b, xb)
    rel = float(((ob - want).abs() / want.abs().clamp_min(1.0)).max())
    require(rel <= 5e-2, f"ax_reduce_plan_x bf16: {rel}")
    log(f"ax_reduce_plan_x  bf16 whole plan: rel err {rel:.3e} (tol 5e-2)")
    del plan_b, xb, ob

    ms = cuda_ms(lambda: ops.ax_aligned_x(plan, x, work=work))
    plain_ms = cuda_ms(lambda: ref.ax_plan_x_ref(plan, x), reps=5, warmup=1)
    sweep = _table_sweep("ax_reduce_plan_x", plan, full, ms,
                         lambda w: ops.ax_aligned_x(plan, x, work=w))
    # the library yardstick: one cuSPARSE CSR x vector product of the same A
    rows, cols, vals = [], [], []
    for b in plan.buckets:
        rr, qq = torch.nonzero(b.mask, as_tuple=True)
        for k in range(m):
            rows.append(k * J + b.dest_ids.long()[rr])
            cols.append(b.edge_idx.long()[rr, qq])
            vals.append(b.a_dm[rr, qq, k])
    coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows),
                                               torch.cat(cols)]),
                                  torch.cat(vals), (m * J, x.numel()))
    csr = coo.coalesce().to_sparse_csr()
    del coo, rows, cols, vals
    lib = (csr @ x[:, None]).reshape(m, J)
    require(torch.allclose(lib, full, rtol=1e-4, atol=1e-4), "CSR yardstick")
    library_ms = cuda_ms(lambda: csr @ x[:, None])
    # bytes the function must move (the launch census's count): a_dm,
    # edge_idx and the x gather at the real entries only (the kernel skips
    # masked ones), the mask over every plan entry, dest_ids per row, the
    # (m, J) result written once
    from repro_torch.launch import census
    p = census.plan_counts(plan)
    real, entries, prow, ea = p.real, p.entries, p.rows, p.ea
    ex = x.element_size()
    nbytes = census.ax_bytes(p, m, J, ex, carry=True)
    bound_ms, bound_by = bound(nbytes, 2 * m * real)
    log(f"ax_reduce_plan_x  one Ax ({len(plan.buckets)} buckets, {real} "
        f"real entries of {entries}; 1 call, 2 CUDA launches): {ms:.4f} ms; "
        f"plain {plain_ms:.4f} ms; CSR library {library_ms:.4f} ms (kernel / "
        f"CSR = {ms / library_ms:.3f}); bound {bound_ms:.4f} ms = {nbytes} "
        f"bytes / 3.35 TB/s; bytes = real*({ea}m + 4 idx + {ex} x) + "
        f"entries*1 mask + {prow} rows*4 dest + 4mJ")
    return {"name": "ax_reduce_plan_x", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ax_reduce_x.cu",
            "replaces": "src/repro/kernels/ax_reduce.py:103",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "items": int(work.items.shape[0]),
            "item_entries": work.item_entries, "ms_by_table": sweep,
            "bytes": nbytes}


def check_dual_grad(obj, lam, gamma, steps):
    """K3 on every slab of the main path against its plain version and,
    bit for bit, its kernel-order plain version, and its x, c_x, x_sq
    against K1's bit for bit; timed at three layouts; the bound max(bytes,
    issue) at the bisection `steps` K1's check counted."""
    import torch
    from repro_torch.kernels import dual_grad as dg
    from repro_torch.kernels import ref
    from repro_torch.kernels.dual_grad import dual_grad_slab, dual_x_slab
    slabs = obj.lp.slabs
    g = torch.full((), gamma, dtype=torch.float32, device=lam.device)
    iters = obj.proj_iters
    err_x, err_s, same_as_k1 = 0.0, 0.0, True
    for s in slabs:
        x, gv, cx, xsq = dual_grad_slab(*s[:6], lam, g, iters=iters)
        x1, cx1, xsq1 = dual_x_slab(*s[:6], lam, g, iters=iters)
        same_as_k1 &= (torch.equal(x, x1) and torch.equal(cx, cx1)
                       and torch.equal(xsq, xsq1))
        xr, gr, cxr, xsqr = ref.dual_grad_ref(*s[:6], lam, g, iters)
        err_x = max(err_x, float((x - xr).abs().max()),
                    float((gv - gr).abs().max()))
        for u, v in ((cx, cxr), (xsq, xsqr)):
            err_s = max(err_s, abs(float(u) - float(v)) / max(abs(float(v)), 1e-30))
        require(torch.equal(gv, torch.where(s.mask[..., None],
                                            s.a_vals * x[..., None], 0.0)),
                f"dual_grad w={s.width}: gvals is not a*x, 0 on padding")
    require(same_as_k1, "dual_grad: x, c_x, x_sq differ from dual_x's bits")
    require(err_x <= 1e-4, f"dual_grad: max |dx|, |dgvals| {err_x} > 1e-4")
    require(err_s <= 1e-5, f"dual_grad: scalar rel err {err_s} > 1e-5")
    log(f"dual_grad_slab  f32 all {len(slabs)} slabs: max|dx|,|dg| "
        f"{err_x:.3e} (atol 1e-4), scalars rel {err_s:.3e} (rtol 1e-5); "
        f"x, c_x, x_sq equal dual_x_slab's bit for bit")
    widths = sorted(range(len(slabs)), key=lambda i: slabs[i].width)
    for si in (widths[0], widths[-1]):
        s = slabs[si]
        sb = [t.to(torch.bfloat16) if t.is_floating_point() else t
              for t in s[:6]]
        x, gv, cx, xsq = dual_grad_slab(*sb, lam, g, iters=iters)
        xr, gr, cxr, xsqr = ref.dual_grad_ref(*sb, lam, g.to(torch.bfloat16),
                                              iters)
        e = max(float((x.float() - xr.float()).abs().max()),
                float((gv.float() - gr.float()).abs().max()))
        es = max(abs(float(cx) - float(cxr)) / max(abs(float(cxr)), 1e-30),
                 abs(float(xsq) - float(xsqr)) / max(abs(float(xsqr)), 1e-30))
        require(e <= 5e-2 and es <= 5e-2,
                f"dual_grad bf16 w={s.width}: {e}, {es}")
        log(f"dual_grad_slab  bf16 w={s.width}: max|dx|,|dg| {e:.3e}, "
            f"scalars rel {es:.3e} (tol 5e-2)")

    def k3(s, lay):
        gv = torch.empty(s.a_vals.shape, dtype=s.a_vals.dtype,
                         device=lam.device)
        x, cx, xsq = dg._launch(dual_grad_slab, *s[:6], lam, g, iters, None,
                                gv, lay)
        return x, gv, cx, xsq

    sweep = lanes_checks("dual_grad_slab", k3, ref.dual_grad_lanes_ref,
                         slabs, lam, g, iters)

    def kernel():
        for s in slabs:
            dual_grad_slab(*s[:6], lam, g, iters=iters)

    def plain():
        for s in slabs:
            ref.dual_grad_ref(*s[:6], lam, g, iters)

    ms = cuda_ms(kernel)
    plain_ms = cuda_ms(plain, reps=5, warmup=1)
    m, J = lam.shape
    from repro_torch.launch import census
    c = census.slab_counts(slabs)
    nbytes = census.sweep_bytes(c, m, J, gvals=True)
    real, padded, rows, ea, ec, eu = (c.real, c.padded, c.rows, c.ea, c.ec,
                                      c.eu)
    rec = {"name": "dual_grad_slab", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/dual_x.cu",
           "replaces": "src/repro/kernels/dual_grad.py:32",
           "max_abs_err": err_x, "ms": ms, "plain_ms": plain_ms,
           "library_ms": None}
    rec.update(_lanes_bound("dual_grad_slab", nbytes, steps, real, m, True,
                            iters, sweep))
    log(f"dual_grad_slab  one sweep ({len(slabs)} slabs, {real} real edges of "
        f"{padded}): {ms:.4f} ms; plain {plain_ms:.4f} ms; bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); bytes = real*({ea}m a "
        f"+ {ec} c + 4 dest + {eu} ub) + padded*(1 mask + {ec} x + {ea}m "
        f"gvals) + {rows} rows*s + 4mJ")
    return rec


def check_ax_reduce_gvals(obj, obj_x):
    """K4 on every bucket of the index-only plan (one bucket a call) and
    on the whole plan (one call, the path's) against its plain version,
    fed the main path's own gvals buffer; at float32 its Ax equals K2's on
    the x buffer of the same sweep bit for bit."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ax_reduce import ax_reduce_bucket, ax_reduce_plan
    plan, gv, work = obj._plan, obj._gbuf, obj._work
    m, J = obj.lp.m, obj.lp.num_destinations
    out = torch.full((m, J), float("nan"), device=gv.device)
    for b in plan.buckets:
        ax_reduce_bucket(gv, b.edge_idx, b.mask, b.dest_ids, out)
        want = ref.ax_reduce_ref(gv, b.edge_idx, b.mask).T
        got = out[:, b.dest_ids.long()]
        rel = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
        require(rel <= 1e-5, f"ax_reduce w={b.width}: rel err {rel} > 1e-5")
    require(not torch.isnan(out).any(),
            "ax_reduce: a destination was not written")
    full, err = _ax_plan_checks("ax_reduce_plan", plan, work, gv, m,
                                ax_reduce_plan, ref.ax_plan_ref,
                                {"gvals": gv})
    require(torch.equal(full, out),
            "ax_reduce: the plan and the per-bucket calls differ in bits")
    require(torch.equal(full, ops.ax_aligned_x(obj_x._plan, obj._xbuf,
                                               work=obj_x._work)),
            "ax_reduce (gvals) and ax_reduce_x (x-carry) Ax differ in bits")
    log(f"ax_reduce_plan  f32, all {len(plan.buckets)} buckets (widths "
        f"{plan.buckets[0].width}..{plan.buckets[-1].width}) one by one and "
        f"as one plan: max|d ax| {err:.3e} (rtol 1e-5 of max(1, |ax|)); the "
        f"two, two runs and the kernel-order plain version bit for bit; "
        f"equal to "
        f"ax_reduce_plan_x's Ax bit for bit; {_ax_items_line(work, plan)}")
    gb = gv.to(torch.bfloat16)
    ob = torch.full((m, J), float("nan"), device=gv.device)
    ax_reduce_plan(gb, plan, ob, work)
    want = ref.ax_plan_ref(plan, gb)
    rel = float(((ob - want).abs() / want.abs().clamp_min(1.0)).max())
    require(rel <= 5e-2, f"ax_reduce_plan bf16: {rel}")
    log(f"ax_reduce_plan  bf16 whole plan: rel err {rel:.3e} (tol 5e-2)")
    del gb, ob

    ms = cuda_ms(lambda: ops.ax_aligned(plan, gv, work=work))
    plain_ms = cuda_ms(lambda: ref.ax_plan_ref(plan, gv), reps=5, warmup=1)
    sweep = _table_sweep("ax_reduce_plan", plan, full, ms,
                         lambda w: ops.ax_aligned(plan, gv, work=w))
    # the library yardstick: one cuSPARSE CSR product of the 0/1
    # destination-incidence matrix (J x E) with the gvals (E x m)
    rows, cols = [], []
    for b in plan.buckets:
        rr, qq = torch.nonzero(b.mask, as_tuple=True)
        rows.append(b.dest_ids.long()[rr])
        cols.append(b.edge_idx.long()[rr, qq])
    idx = torch.stack([torch.cat(rows), torch.cat(cols)])
    coo = torch.sparse_coo_tensor(idx, torch.ones(idx.shape[1],
                                                  device=gv.device),
                                  (J, gv.shape[0]))
    csr = coo.coalesce().to_sparse_csr()
    del coo, rows, cols, idx
    lib = (csr @ gv).T
    require(torch.allclose(lib, full, rtol=1e-4, atol=1e-4), "CSR yardstick")
    library_ms = cuda_ms(lambda: csr @ gv)
    del csr
    # bytes (the launch census's count): the m gvals and edge_idx at the
    # real entries (the kernel skips masked ones), the mask over every plan
    # entry, dest_ids per row, the (m, J) result written once
    from repro_torch.launch import census
    p = census.plan_counts(plan)
    real, entries, prow = p.real, p.entries, p.rows
    eg = gv.element_size()
    nbytes = census.ax_bytes(p, m, J, eg, carry=False)
    bound_ms, bound_by = bound(nbytes, m * real)
    log(f"ax_reduce_plan  one Ax ({len(plan.buckets)} buckets, {real} real "
        f"entries of {entries}; 1 call, 2 CUDA launches): {ms:.4f} ms; plain "
        f"{plain_ms:.4f} ms; CSR library {library_ms:.4f} ms (kernel / CSR = "
        f"{ms / library_ms:.3f}); bound {bound_ms:.4f} ms = {nbytes} bytes / "
        f"3.35 TB/s; bytes = real*({eg}m gvals + 4 idx) + entries*1 mask + "
        f"{prow} rows*4 dest + 4mJ")
    return {"name": "ax_reduce_plan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ax_reduce.cu",
            "replaces": "src/repro/kernels/ax_reduce.py:52",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "items": int(work.items.shape[0]),
            "item_entries": work.item_entries, "ms_by_table": sweep}


def slab_u(a_vals, c_vals, dest_idx, lam, gamma):
    """The pre-projection point u = -(sum_k a_k lam_k[dest] + c) / gamma of a
    slab, as the plain version forms it (float32)."""
    import torch
    d = dest_idx.long()
    atl = torch.zeros_like(c_vals)
    for k in range(a_vals.shape[2]):
        atl = atl + a_vals[:, :, k] * lam[k][d]
    return -(atl + c_vals) / gamma


def proj_path(obj, lam, gamma):
    """The path that launches K5: its entry point `ops.proj_boxcut` on every
    slab's pre-projection u at the main path's final lambda.  Returns the
    projected slabs, the u's and the launches."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.proj import proj_boxcut
    g = torch.full((), gamma, dtype=torch.float32, device=lam.device)
    us = [slab_u(s.a_vals, s.c_vals, s.dest_idx, lam, g)
          for s in obj.lp.slabs]
    proj_boxcut.launches = 0
    xs = [ops.proj_boxcut(u, s.ub, s.s, s.mask, iters=obj.proj_iters)
          for u, s in zip(us, obj.lp.slabs)]
    torch.cuda.synchronize()
    return xs, us, proj_boxcut.launches


def check_proj(obj, lam, gamma, xs, us):
    """K5's outputs on its path (`xs`, from every slab's u) bit for bit
    against K1's x of the same slab and against K5's kernel-order plain
    version, and within 1e-4 of its plain version; bfloat16 copies of the
    widest and narrowest within 5e-2; the steps on its inputs; one sweep
    timed against the bound max(bytes, issue at each row's own steps)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.dual_grad import dual_x_slab, row_layout
    from repro_torch.kernels.proj import proj_boxcut
    slabs, iters = obj.lp.slabs, obj.proj_iters
    g = torch.full((), gamma, dtype=torch.float32, device=lam.device)
    err = 0.0
    for s, u, x in zip(slabs, us, xs):
        x1, _, _ = dual_x_slab(*s[:6], lam, g, iters=iters)
        require(torch.equal(x, x1), f"proj w={s.width}: x of u is not "
                f"dual_x_slab's x bit for bit")
        require(torch.equal(x, ref.proj_lanes_ref(
            u, s.ub, s.s, s.mask, iters, row_layout(s.width))),
            f"proj w={s.width}: not the bits of proj_lanes_ref")
        xr = ref.proj_boxcut_ref(u, s.ub, s.s, s.mask, iters)
        err = max(err, float((x - xr).abs().max()))
        del x1, xr
    require(err <= 1e-4, f"proj: max |dx| {err} > 1e-4")
    log(f"proj_boxcut  f32 all {len(slabs)} slabs (layouts "
        f"{[row_layout(s.width) for s in slabs]}): x of every slab's u "
        f"equals dual_x_slab's x and proj_lanes_ref bit for bit; max|dx| "
        f"against the plain version {err:.3e} (atol 1e-4)")
    widths = sorted(range(len(slabs)), key=lambda i: slabs[i].width)
    for si in (widths[0], widths[-1]):
        s = slabs[si]
        ub, sb, ubb = (t.to(torch.bfloat16) for t in (us[si], s.s, s.ub))
        x = proj_boxcut(ub, ubb, sb, s.mask, iters)
        xr = ref.proj_boxcut_ref(ub, ubb, sb, s.mask, iters)
        e = float((x.float() - xr.float()).abs().max())
        require(e <= 5e-2, f"proj bf16 w={s.width}: {e}")
        log(f"proj_boxcut  bf16 w={s.width}: max|dx| {e:.3e} (tol 5e-2)")
    steps = proj_steps(slabs, us, iters)
    log("proj_boxcut  " + steps_line("K5's inputs (each slab's u at the "
                                     "final lambda)", steps))

    def kernel():
        for s, u in zip(slabs, us):
            proj_boxcut(u, s.ub, s.s, s.mask, iters)

    def plain():
        for s, u in zip(slabs, us):
            ref.proj_boxcut_ref(u, s.ub, s.s, s.mask, iters)

    ms = cuda_ms(kernel)
    plain_ms = cuda_ms(plain, reps=5, warmup=1)
    real = sum(int(s.mask.sum()) for s in slabs)
    padded = sum(s.n * s.width for s in slabs)
    rows = sum(s.n for s in slabs)
    ev = us[0].element_size()
    nbytes = real * (ev + 4) + padded * (1 + ev) + rows * 4
    bound_ms, bound_by, bytes_ms, issue_ms = steps_bound(
        nbytes, steps, real * OPS_X, iters)
    log(f"proj_boxcut  one sweep ({len(slabs)} slabs, {real} real entries of "
        f"{padded}): {ms:.4f} ms; plain {plain_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms ({bound_by}) = max({nbytes} bytes / 3.35 TB/s = "
        f"{bytes_ms:.4f} ms, issue {issue_ms:.4f} ms: {OPS_A_STEP} float32 "
        f"operations a step over each row's real entries x its own steps, "
        f"{OPS_ENTRY} + {OPS_X} a real entry outside the loop, at 128 lanes "
        f"a clock an SM); bytes = real*({ev} v + 4 ub) + padded*(1 mask + {ev} "
        f"x) + {rows} rows*4 s")
    return {"name": "proj_boxcut", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/proj.cu",
            "replaces": "src/repro/kernels/proj.py:49",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_bytes_ms": bytes_ms, "bound_issue_ms": issue_ms,
            "library_ms": None}


def calculate_bits_equal(a, b):
    """Two `calculate` results (g, grad, aux) are equal bit for bit."""
    import torch
    (g1, d1, a1), (g2, d2, a2) = a, b
    return (torch.equal(g1, g2) and torch.equal(d1, d2)
            and all(torch.equal(u, v) for u, v in zip(a1, a2)))


def wide_slab(seed, n, w, m, J):
    """A synthetic slab of n rows of width w on the card, as tensors (a, c,
    dest, mask, ub, s) in a `Slab`, with lam (m, J) and gamma = 0.1: row
    degrees uniform in [0, w] (a prefix mask), ub uniform in [0.5, 1] and
    s in [0.5, 4] (drawn as tests/test_torch_cuda.py::
    test_proj_kernel_matches_plain draws them), a and -c lognormal(0, 0.5),
    dest uniform over J, lam uniform in [0, 0.05]: u ~ 10, so nearly every
    row needs the bisection."""
    import numpy as np
    import torch
    from repro_torch.core.types import Slab
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, w + 1, size=n)
    mask = np.arange(w)[None, :] < deg[:, None]
    ub = np.where(mask, rng.uniform(0.5, 1.0, (n, w)), 0)
    s = rng.uniform(0.5, 4.0, n)
    a = np.where(mask[..., None], rng.lognormal(0, 0.5, (n, w, m)), 0)
    c = np.where(mask, -rng.lognormal(0, 0.5, (n, w)), 0)
    dest = np.where(mask, rng.integers(0, J, (n, w)), 0)
    lam = rng.uniform(0, 0.05, (m, J))
    f = np.float32
    to = lambda v: torch.from_numpy(v).to(DEVICE)
    slab = Slab(to(a.astype(f)), to(c.astype(f)), to(dest.astype(np.int32)),
                to(mask), to(ub.astype(f)), to(s.astype(f)),
                torch.arange(n, dtype=torch.int32, device=DEVICE))
    return slab, to(lam.astype(f)), torch.full((), 0.1, device=DEVICE)


def wide_calls(slab, lam, g, iters):
    """K1, K3 and K5 (on the slab's u) of one slab, each a callable, as the
    checkout's wrappers run them."""
    from repro_torch.kernels.dual_grad import dual_grad_slab, dual_x_slab
    from repro_torch.kernels.proj import proj_boxcut
    u = slab_u(slab.a_vals, slab.c_vals, slab.dest_idx, lam, g)
    return {"dual_x_slab": lambda: dual_x_slab(*slab[:6], lam, g,
                                               iters=iters),
            "dual_grad_slab": lambda: dual_grad_slab(*slab[:6], lam, g,
                                                     iters=iters),
            "proj_boxcut": lambda: proj_boxcut(u, slab.ub, slab.s,
                                               slab.mask, iters)}, u


def wide_slab_record(what, slab, lam, g, iters):
    """K1, K3 and K5 on one wide slab: bit for bit against their
    block-order plain versions (K5 fed the slab's u gives K1's x), the
    wide routine's steps, and each kernel's time, its plain version's and
    its bound max(bytes, issue at each row's own steps).  Returns {kernel
    name: {ms, plain_ms, bound_ms, bound_by}}."""
    import torch
    from repro_torch.kernels import ref
    calls, u = wide_calls(slab, lam, g, iters)
    x1, cx1, sq1 = calls["dual_x_slab"]()
    x3, g3, cx3, sq3 = calls["dual_grad_slab"]()
    x5 = calls["proj_boxcut"]()
    want = ref.dual_grad_block_ref(*slab[:6], lam, g, iters)
    require(all(torch.equal(a, b) for a, b in
                zip((x3, g3, cx3, sq3), want)) and torch.equal(x1, x3)
            and torch.equal(cx1, cx3) and torch.equal(sq1, sq3),
            f"{what}: dual_x / dual_grad not the bits of dual_grad_block_ref")
    require(torch.equal(x5, x1) and torch.equal(
        x5, ref.proj_block_ref(u, slab.ub, slab.s, slab.mask, iters)),
        f"{what}: proj_boxcut(u) not dual_x's x / proj_block_ref bit for bit")
    lay = ref.block_layout(slab.width)
    v, ubp = ref.lanes_u(*slab[:5], lam, g, lay)
    steps = [steps_stats(slab.width, slab.n, v, ubp, slab.s, lay, iters,
                         slab.mask)]
    del v, ubp, x1, x3, g3, x5, want
    log(f"{what} ({slab.n} x {slab.width}, chunk {lay[1]}): K1, K3, K5 equal "
        f"their block-order plain versions bit for bit; " + steps_line(
            "its lambda", steps))
    m, J = lam.shape
    from repro_torch.launch import census
    c = census.slab_counts([slab])
    real, padded, rows, ea, ec, eu = (c.real, c.padded, c.rows, c.ea, c.ec,
                                      c.eu)
    plains = {"dual_x_slab": lambda: ref.dual_x_ref(*slab[:6], lam, g, iters),
              "dual_grad_slab": lambda: ref.dual_grad_ref(*slab[:6], lam, g,
                                                          iters),
              "proj_boxcut": lambda: ref.proj_boxcut_ref(
                  u, slab.ub, slab.s, slab.mask, iters)}
    work = {"dual_x_slab": (census.sweep_bytes(c, m, J),
                            real_ops(real, m, False)),
            "dual_grad_slab": (census.sweep_bytes(c, m, J, gvals=True),
                               real_ops(real, m, True)),
            "proj_boxcut": (real * (4 + eu) + padded * (1 + ec) + rows * 4,
                            real * OPS_X)}
    no_steps, _ = wide_calls(slab, lam, g, 0)
    out = {}
    for name, fn in calls.items():
        nbytes, ops_real = work[name]
        bound_ms, bound_by, bytes_ms, issue_ms = steps_bound(
            nbytes, steps, ops_real, iters)
        out[name] = {"ms": cuda_ms(fn), "device_ms": device_ms(fn),
                     "device_ms_no_steps": device_ms(no_steps[name]),
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "plain_ms": cuda_ms(plains[name], reps=5, warmup=1)}
        r = out[name]
        fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
        log(f"{name} on {what} ({slab.n} x {slab.width}, {real} real "
            f"entries): {r['ms']:.4f} ms (CUDA events); its kernels on the "
            f"device {fmt(r['device_ms'])}, and at 0 bisection steps "
            f"{fmt(r['device_ms_no_steps'])} (profiled; the second a "
            f"diagnostic: loads, u, stores); "
            f"plain {r['plain_ms']:.4f} ms; bound {bound_ms:.5f} ms "
            f"({bound_by}) = max({nbytes} bytes = {bytes_ms:.5f} ms, issue "
            f"{issue_ms:.5f} ms)")
    return out


def wide_instance(args_extra, log_fn):
    """The dense-eligibility instance, generated, and solved through the
    CLI's entry point for 50 iterations: (instance, outcome, launches)."""
    from repro_torch.launch import solve
    args = solve.build_parser().parse_args(WIDE_ARGS + args_extra)
    inst = solve.generate_instance(args, log=log_fn)
    reset_counters()
    out = solve.run(args, log=log_fn, instance=inst)
    return inst, out, read_counters()


def wide_rows():
    """Rows wider than 1,024.  A dense-eligibility instance (a 2,048-wide
    slab) through the CLI entry point: 50 iterations against the reference
    CLI's dual, then to tolerance with a valid certificate.  K1, K3 and K5
    on its 3 x 2,048 slab at the 50-iteration lambda and on the 8,192 x
    2,048 throughput slab, timed against their bounds; and bit for bit
    against their block-order plain versions at widths 2,048, 8,192,
    16,384 and 32,768 (chunks in registers, shared memory, global
    scratch).  Returns ({kernel name: {slab: times}}, the converged
    outcome, which phase 11 serves)."""
    import torch
    from repro_torch.launch import solve
    inst, out, launches = wide_instance(["--iterations", "50"],
                                        lambda msg: log(f"  {msg}"))
    widths = [s.width for s in inst.lp.slabs]
    require(max(widths) > 1024, f"wide instance: widths {widths}")
    dual = out.result["dual_obj_final"]
    rel = abs(dual - WIDE_DUAL_50) / abs(WIDE_DUAL_50)
    log(f"wide 3000x5000 nu=1000 (slab widths {widths}), 50 iterations: "
        f"dual {dual:.6f} vs the reference CLI's {WIDE_DUAL_50} (rel "
        f"{rel:.2e}, limit 1e-4); solve loop {out.solve_seconds:.3f} s; "
        f"launches {launches} (dual_x_slab: one a slab an evaluation)")
    require(rel <= 1e-4, f"wide instance dual off by {rel:.2e}")
    require(launches["dual_x_slab"] > 0, "the wide path never ran")
    wide = max(out.objective.lp.slabs, key=lambda s: s.width)
    lam, g = out.lam, torch.full((), out.gamma, device=out.lam.device)
    recs = {name: {"cell_3x2048": r} for name, r in wide_slab_record(
        "the wide cell's slab", wide, lam, g,
        out.objective.proj_iters).items()}
    recs["dual_x_slab"]["cell_3x2048"]["launches"] = launches["dual_x_slab"]
    del out
    args = solve.build_parser().parse_args(
        WIDE_ARGS + ["--adaptive-continuation", "--tol-rel-dual", "1e-6",
                     "--iterations", "3000", "--certify"])
    out = solve.run(args, log=lambda msg: log(f"  {msg}"), instance=inst)
    res = out.result
    log(f"wide to tolerance: {res['stop_reason']} after "
        f"{res['iterations_run']} iterations, dual "
        f"{res['dual_obj_final']:.6f}, certificate "
        f"{res['certificate_valid']}; solve loop {out.solve_seconds:.2f} s")
    require(res["stop_reason"] == "converged", "wide solve did not converge")
    require(res["certificate_valid"] is True, "wide certificate not valid")
    del inst

    for w in WIDE_BITS:
        n = min(600, 10_000_000 // w)
        slab, lam, g = wide_slab(w, n, w, 2, 5000)
        wide_slab_bits(f"wide synthetic w={w}", slab, lam, g)
        del slab
    slab, lam, g = wide_slab(0, *THROUGHPUT_SLAB, 1, 5000)
    for name, r in wide_slab_record("the throughput slab", slab, lam, g,
                                    40).items():
        recs[name]["throughput_8192x2048"] = r
    del slab
    for name, r in wide_store_times().items():
        recs[name]["by_storage"] = r
    return recs, out


def wide_store_times():
    """K1, K3 and K5 (float32, m = 1, seed 0) at each of STORE_WIDTHS with
    the chunks in registers, staged in shared memory and staged in global
    scratch, on a slab of STORE_ENTRIES / w rows and on one of 3 rows: the
    three give the same bits (checked: one order of the sums), and each
    is timed by CUDA events and by device time.  Returns {kernel:
    {"n x w": {storage: {ms, device_ms}}}}."""
    import torch
    from repro_torch.kernels import dual_grad as dg
    from repro_torch.kernels import proj, ref
    out = {}
    for w in STORE_WIDTHS:
        for n in (STORE_ENTRIES // w, 3):
            slab, lam, g = wide_slab(0, n, w, 1, 5000)
            u = slab_u(slab.a_vals, slab.c_vals, slab.dest_idx, lam, g)
            gv = torch.empty_like(slab.a_vals)
            lay = ref.block_layout(w)
            runs = {}
            for st, store in enumerate(STORE_NAMES):
                runs[store] = {
                    "dual_x_slab": functools.partial(
                        dg._launch, dg.dual_x_slab, *slab[:6], lam, g, 40,
                        None, None, lay, st),
                    "dual_grad_slab": functools.partial(
                        dg._launch, dg.dual_grad_slab, *slab[:6], lam, g,
                        40, None, gv, lay, st),
                    "proj_boxcut": functools.partial(
                        proj._launch, u, slab.ub, slab.s, slab.mask, 40, lay,
                        st)}
            first = None
            for store, calls in runs.items():
                got = [calls["dual_x_slab"](), calls["dual_grad_slab"](),
                       gv.clone(), calls["proj_boxcut"]()]
                got = [t for r in got for t in
                       (r if isinstance(r, tuple) else (r,))]
                first = first or got
                require(all(torch.equal(a, b) for a, b in zip(first, got)),
                        f"wide w={w} n={n}: chunks in {store} do not give "
                        f"the bits of chunks in registers")
            del first, got
            key = f"{n}x{w}"
            for name in runs["registers"]:
                t = {store: {"ms": cuda_ms(calls[name]),
                             "device_ms": device_ms(calls[name])}
                     for store, calls in runs.items()}
                out.setdefault(name, {})[key] = t
                fmt = lambda v: ("not measured" if v is None
                                 else f"{v:.4f} ms")
                log(f"{name} {key} (chunk {lay[1]}, f32, m=1), by storage: "
                    + "; ".join(
                        f"{store} {fmt(r['device_ms'])} device, "
                        f"{r['ms']:.4f} ms events" for store, r in t.items())
                    + " (the same bits in each)")
            del slab, u, gv, runs
    return out


def wide_slab_bits(what, slab, lam, g):
    """K1, K3, K5 of one synthetic wide slab (m = 2) against their
    block-order plain versions, bit for bit, and within 1e-4 of their
    plain versions; two runs bit for bit."""
    import torch
    from repro_torch.kernels import ref
    calls, u = wide_calls(slab, lam, g, 40)
    first, again = ([*k1, *k3, k5] for k1, k3, k5 in (
        [f() for f in calls.values()] for _ in range(2)))
    require(all(torch.equal(a, b) for a, b in zip(first, again)),
            f"{what}: two runs differ")
    x1, cx1, sq1, x3, g3, cx3, sq3, x5 = first
    want = ref.dual_grad_block_ref(*slab[:6], lam, g, 40)
    require(all(torch.equal(a, b) for a, b in zip((x3, g3, cx3, sq3), want))
            and torch.equal(x1, x3) and torch.equal(cx1, cx3)
            and torch.equal(sq1, sq3), f"{what}: dual_x / dual_grad not the "
            f"bits of dual_grad_block_ref")
    require(torch.equal(x5, x1) and torch.equal(
        x5, ref.proj_block_ref(u, slab.ub, slab.s, slab.mask, 40)),
        f"{what}: proj_boxcut(u) not dual_x's x / proj_block_ref")
    xr, gr, cxr, sqr = ref.dual_grad_ref(*slab[:6], lam, g)
    e = max(float((x1 - xr).abs().max()), float((g3 - gr).abs().max()))
    es = max(abs(float(cx1) - float(cxr)) / abs(float(cxr)),
             abs(float(sq1) - float(sqr)) / abs(float(sqr)))
    require(e <= 1e-4 and es <= 1e-5, f"{what}: against the plain versions "
            f"{e}, {es}")
    log(f"{what} (n={slab.n}, m=2, chunk {ref.block_layout(slab.width)[1]}): "
        f"K1, K3, K5 equal their block-order plain versions bit for bit, "
        f"twice; against the plain versions max|dx|,|dg| {e:.3e} (atol "
        f"1e-4), scalars rel {es:.3e} (rtol 1e-5)")


def kernel_times(root):
    """`--kernel-times ROOT`: K1, K3 and K5 of the checkout at `root` (whose
    `src/` is on the path) timed on the wide slabs that phase 6 times:
    the 8,192 x 2,048 throughput slab, and the wide cell's 3 x 2,048 slab
    at its 50-iteration lambda (CUDA events, and the device time of the
    calls' kernels).  Prints one JSON line; checks nothing."""
    import torch
    from repro_torch.kernels import _build
    WRAPPERS.update(_wrappers())
    _build.build()
    times = {}
    _, out, _ = wide_instance(["--iterations", "50"], lambda msg: None)
    wide = max(out.objective.lp.slabs, key=lambda s: s.width)
    g = torch.full((), out.gamma, device=out.lam.device)
    calls, _ = wide_calls(wide, out.lam, g, out.objective.proj_iters)
    times["cell_3x2048"] = {k: {"ms": cuda_ms(f), "device_ms": device_ms(f)}
                            for k, f in calls.items()}
    del out, calls
    slab, lam, g = wide_slab(0, *THROUGHPUT_SLAB, 1, 5000)
    calls, _ = wide_calls(slab, lam, g, 40)
    times["throughput_8192x2048"] = {
        k: {"ms": cuda_ms(f), "device_ms": device_ms(f)}
        for k, f in calls.items()}
    print(json.dumps({"kernel_times": times, "root": root,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


def _wrappers():
    from repro_torch.kernels.ax_reduce import ax_reduce_plan, ax_reduce_plan_x
    from repro_torch.kernels.dual_grad import dual_grad_slab, dual_x_slab
    from repro_torch.kernels.proj import proj_boxcut
    return dict(dual_x_slab=dual_x_slab, ax_reduce_plan_x=ax_reduce_plan_x,
                dual_grad_slab=dual_grad_slab, ax_reduce_plan=ax_reduce_plan,
                proj_boxcut=proj_boxcut)


def repeatability(obj, gamma):
    """At the main path's size: the row norms of preconditioning twice, and
    the first 50 agd iterations twice from lambda = 0, bit for bit."""
    import torch
    from repro_torch.core import Maximizer, SolveConfig, row_norms
    require(torch.equal(row_norms(obj.lp), row_norms(obj.lp)),
            "row_norms differ from run to run")
    cfg = SolveConfig(iterations=50, gamma=gamma, max_step=1e-1,
                      initial_step=1e-5)
    first, again = (Maximizer(cfg).maximize(obj).lam for _ in range(2))
    require(torch.equal(first, again),
            "two 50-iteration runs of the main path differ")
    log("repeatability: row norms and 50 main-path iterations bit-identical "
        "run to run")


def parity_solve(lp_np, mode, count=None, normalized=True,
                 max_iterations=None, algorithm="agd", fixed=None):
    """One perf_lp/tol_agd solve on the card from a fresh transfer of the
    instance, in `mode`; with `count`, of GlobalCountObjective, its count
    row normalized (row_scale 1/sqrt(real edges), as the reference's
    formulations compiler normalizes a global row) or, with `normalized`
    False, all ones as in the reference's class.  `algorithm` names the
    update rule; `fixed` runs that many iterations with no criteria."""
    import torch
    from repro_torch.convert import lp_to_torch
    from repro_torch.core import (GlobalCountObjective, MatchingObjective,
                                  Maximizer, SolveConfig, StoppingCriteria,
                                  precondition)
    lp, _ = precondition(lp_to_torch(lp_np, DEVICE), row_norm=True)
    kw = dict(proj_kind="boxcut", proj_iters=20, ax_mode=mode)
    if count is None:
        obj = MatchingObjective(lp, **kw)
    else:
        real = sum(int(s.mask.sum()) for s in lp.slabs)
        scale = 1.0 / math.sqrt(real) if normalized else 1.0
        obj = GlobalCountObjective(lp, count=count, row_scale=scale, **kw)
    cfg = SolveConfig(iterations=fixed or 30000, gamma=0.01, max_step=1e-1,
                      initial_step=1e-5)
    crit = (None if fixed else
            StoppingCriteria(tol_rel_dual=1e-6, tol_infeas_rel=1e-4,
                             check_every=PARITY_CHECK,
                             max_iterations=max_iterations))
    t0 = time.perf_counter()
    res = Maximizer(cfg, algorithm=algorithm).maximize(obj, criteria=crit)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, obj


def parity():
    """The reference's recorded perf_lp/tol_agd run on the card in every ax
    mode, aligned, scatter and sorted twice from a fresh instance (the two
    runs must agree bit for bit: no atomics on aligned's and sorted's
    paths, scatter's sum in float64), aligned_gvals bit-identical to
    aligned; then GlobalCountObjective."""
    import torch
    from repro_torch.core import InstanceSpec, generate, validate_lp
    spec = InstanceSpec(num_sources=2000, num_destinations=1000,
                        avg_nnz_per_row=4.0, seed=42)
    lp_np = validate_lp(generate(spec))
    lo, hi = PARITY_ITERATIONS
    runs = {}
    for mode in ("aligned", "aligned", "aligned_gvals", "scatter", "scatter",
                 "sorted", "sorted"):
        res, dt, obj = parity_solve(lp_np, mode)
        dual = float(res.stats.dual_obj[-1])
        rel = abs(dual - PARITY_DUAL) / abs(PARITY_DUAL)
        log(f"parity perf_lp/tol_agd {mode}: {res.stop_reason.value} after "
            f"{res.iterations_run} iterations (reference {lo}..{hi}, held "
            f"within one check of that); dual {dual:.6f} vs "
            f"{PARITY_DUAL:.6f} (rel {rel:.2e}, limit 1e-4); {dt:.2f} s, "
            f"{dt / max(res.iterations_run, 1) * 1e3:.3f} ms/iter")
        require(res.converged, f"parity solve ({mode}) did not converge")
        require(rel <= 1e-4, f"parity dual ({mode}) off by {rel:.2e}")
        require(lo - PARITY_CHECK <= res.iterations_run <= hi + PARITY_CHECK,
                f"parity ({mode}) stopped at {res.iterations_run}, outside "
                f"{lo}..{hi}")
        runs.setdefault(mode, []).append((res, obj))
    (a, obj_a), (a2, _) = runs["aligned"]
    (s1, _), (s2, _) = runs["sorted"]
    (c1, _), (c2, _) = runs["scatter"]
    (ag, _), = runs["aligned_gvals"]
    for r1, r2, what in ((a, a2, "two aligned runs"),
                         (s1, s2, "two sorted runs"),
                         (c1, c2, "two scatter runs"),
                         (a, ag, "aligned_gvals and aligned")):
        require(r1.iterations_run == r2.iterations_run
                and torch.equal(r1.lam, r2.lam), f"{what} differ")
    log("parity: aligned twice, scatter twice, sorted twice, and "
        "aligned_gvals against aligned bit-identical (iterations and "
        "lambda)")

    gamma = torch.full((), 0.01, device=DEVICE)
    x_free = sum(float(x.float().sum()) for x in obj_a.primal(a.lam, gamma))
    count = 0.9 * x_free
    res, dt, obj = parity_solve(lp_np, "aligned", count=count)
    x_sum = sum(float(x.float().sum()) for x in obj.primal(res.lam, gamma))
    mu = float(res.lam[-1])
    log(f"GlobalCountObjective, count row normalized (count {count:.4f} = "
        f"0.9 x the unconstrained sum of x {x_free:.4f}): "
        f"{res.stop_reason.value} after "
        f"{res.iterations_run} iterations, {dt:.2f} s; sum of x {x_sum:.4f} "
        f"(limit count x (1 + 1e-3)), mu {mu:.6f}")
    require(res.converged, "GlobalCountObjective did not converge")
    require(x_sum <= count * (1 + 1e-3) and mu > 0,
            "GlobalCountObjective: the count row does not bind")
    # the same run with the reference class's all-ones row, for the record
    # (PERF.md §6): its curvature dwarfs the normalized destination rows'
    res, dt, obj = parity_solve(lp_np, "aligned", count=count,
                                normalized=False, max_iterations=5000)
    x_sum = sum(float(x.float().sum()) for x in obj.primal(res.lam, gamma))
    log(f"GlobalCountObjective, all-ones count row (as the reference's class), "
        f"capped at 5000 iterations: {res.stop_reason.value} after "
        f"{res.iterations_run} iterations, {dt:.2f} s; sum of x {x_sum:.4f}, "
        f"infeas {float(res.stats.infeas[-1]):.4e}, last rel_dual "
        f"{res.diagnostics[-1].rel_dual:.3e}")


def main_path_rules(args, inst, agd_dual):
    """Phase 8 on the main path: pdhg through the CLI entry point with the
    certificate, then bb and pga for a fixed RULE_ITERATIONS each on its
    objective.  Returns the launches of K1 and K2 in each rule's run."""
    import torch
    from repro_torch.core import Maximizer, SolveConfig
    from repro_torch.launch import solve
    args_p = solve.build_parser().parse_args(
        MAIN_ARGS + ["--algorithm", "pdhg"])
    out, launches, _ = drive(args_p, inst,
                             ("dual_x_slab", "ax_reduce_plan_x"),
                             "main path, pdhg")
    require(out.result["algorithm"] == "pdhg", "the CLI ran another rule")
    require(out.result["certificate_valid"] is True,
            "pdhg certificate not valid")
    dual = out.result["dual_obj_final"]
    drift = abs(dual - agd_dual) / abs(agd_dual)
    log(f"main path, pdhg: {out.result['iterations_run']} iterations, dual "
        f"{dual!r} against agd's {agd_dual!r} (phase 3): relative "
        f"{drift:.3e} (limit {MAIN_RULE_DRIFT:.0e})")
    require(drift <= MAIN_RULE_DRIFT, f"pdhg's dual drifts {drift:.3e}")
    by_rule = {"pdhg": launches}
    cfg = SolveConfig(iterations=RULE_ITERATIONS, gamma=out.gamma,
                      max_step=1e-1, initial_step=1e-5)
    for rule in ("bb", "pga"):
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        res = Maximizer(cfg, algorithm=rule).maximize(out.objective)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        by_rule[rule] = read_counters()
        d = res.stats.dual_obj
        log(f"main path, {rule}: {RULE_ITERATIONS} iterations at gamma "
            f"{out.gamma:.4g} from lambda = 0 in {dt:.3f} s, "
            f"{dt / RULE_ITERATIONS * 1e3:.3f} ms/iteration (synchronised, "
            f"one host read); dual {float(d[0]):.3f} -> {float(d[-1]):.3f}; "
            f"launches {by_rule[rule]}")
        require(bool(torch.isfinite(res.lam).all())
                and all(math.isfinite(float(v)) for v in d),
                f"{rule} on the main path: non-finite dual")
        require(by_rule[rule]["dual_x_slab"] > 0
                and by_rule[rule]["ax_reduce_plan_x"] > 0,
                f"{rule} on the main path: K1 or K2 never ran")
    return by_rule


def fault_tolerance(args, obj, lam, iterations):
    """Phase 8 on phase 3's objective, through Maximizer: the health guard
    off and on, a transient fault, a persistent one, and pdhg preempted,
    checkpointed to disk and resumed."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import (HealthConfig, Maximizer, SolveEngine,
                                  StopReason, get_rule)
    from repro_torch.launch import solve
    from repro_torch.testing import (ChunkFaultInjector,
                                     NaNInjectingObjective, PreemptAfter)
    cfg, crit = solve.solve_config(args)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return res, dt, dt / max(res.iterations_run, 1) * 1e3

    res, dt, ms = timed(lambda: Maximizer(cfg).maximize(
        obj, criteria=crit, health=HealthConfig()))
    log(f"fault tolerance: guarded agd {res.iterations_run} iterations in "
        f"{dt:.3f} s ({ms:.3f} ms/iteration, guard on, one host read a "
        f"chunk), {len(res.health)} health records")
    require(res.iterations_run == iterations and torch.equal(res.lam, lam)
            and res.health == (),
            "the guarded run differs from the unguarded one")
    log("fault tolerance: guarded agd equals phase 3's unguarded run bit "
        "for bit (lambda and iterations)")

    eng = SolveEngine(obj.calculate, cfg)
    eng.chunk_fault_hook = ChunkFaultInjector(at_it=crit.check_every)
    res, dt, ms = timed(lambda: eng.solve(
        torch.zeros(obj.dual_shape, device=DEVICE), criteria=crit,
        health=HealthConfig()))
    log(f"fault tolerance: NaN injected into the second chunk: "
        f"{[tuple(r[:4]) + (r.rolled_back_to, r.step_scale) for r in res.health]}; "
        f"{res.stop_reason.value} after {res.iterations_run} iterations, "
        f"dual {float(res.stats.dual_obj[-1])!r}")
    require(len(res.health) == 1 and res.health[0].action == "rollback"
            and res.converged, "the transient fault was not rolled back")

    health = HealthConfig(max_retries=3)
    res, dt, ms = timed(lambda: Maximizer(cfg).maximize(
        NaNInjectingObjective(obj, mode="always"), criteria=crit,
        health=health))
    log(f"fault tolerance: NaN objective: {res.stop_reason.value} after "
        f"{len(res.health)} records "
        f"({[r.action for r in res.health]}), lambda finite "
        f"{bool(torch.isfinite(res.lam).all())}")
    require(res.stop_reason == StopReason.DIVERGED
            and len(res.health) == health.max_retries + 1
            and bool(torch.isfinite(res.lam).all()),
            "the persistent fault did not stop DIVERGED")

    full, dt, ms = timed(lambda: Maximizer(cfg, algorithm="pdhg").maximize(
        obj, criteria=crit))
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        part = Maximizer(cfg, algorithm="pdhg").maximize(
            obj, criteria=crit,
            checkpoint_fn=lambda it, st, meta: mgr.save(it, st,
                                                        extra=dict(meta)),
            preempt_fn=PreemptAfter(4))
        flat, extra = mgr.restore_flat(mgr.latest_step())
    state = get_rule("pdhg").state_from_flat(flat, DEVICE)
    res = Maximizer(cfg, algorithm="pdhg").maximize(
        obj, criteria=crit, initial_state=state, resume_meta=extra)
    same = (res.iterations_run == full.iterations_run
            and torch.equal(res.lam, full.lam)
            and all(bool((a == np.concatenate([b, c])).all())
                    for a, b, c in zip(full.stats, part.stats, res.stats)))
    log(f"fault tolerance: pdhg uninterrupted {full.iterations_run} "
        f"iterations ({ms:.3f} ms/iteration); preempted at "
        f"{part.iterations_run} ({part.stop_reason.value}), checkpointed, "
        f"resumed to {res.iterations_run}: bit for bit {same}")
    require(part.stop_reason == StopReason.PREEMPTED and same,
            "the resumed pdhg run differs from the uninterrupted one")


def rule_parity():
    """Phase 8's parity: perf_lp/tol_pdhg and tol_bb twice each in aligned
    (bit-identical, converged, the dual within 1e-4 of the reference's,
    the stop within one check of the reference's spread), and pga's fixed
    300 iterations against the port's CPU run."""
    import torch
    from repro_torch.core import InstanceSpec, generate, validate_lp
    spec = InstanceSpec(num_sources=2000, num_destinations=1000,
                        avg_nnz_per_row=4.0, seed=42)
    lp_np = validate_lp(generate(spec))
    for rule, (ref_dual, (lo, hi)) in RULE_PARITY.items():
        runs = []
        for _ in range(2):
            res, dt, _ = parity_solve(lp_np, "aligned", algorithm=rule)
            dual = float(res.stats.dual_obj[-1])
            rel = abs(dual - ref_dual) / abs(ref_dual)
            log(f"parity perf_lp/tol_{rule} aligned: {res.stop_reason.value} "
                f"after {res.iterations_run} iterations (reference {lo}..{hi}, "
                f"held within one check of that); dual {dual:.6f} vs "
                f"{ref_dual:.6f} (rel {rel:.2e}, limit 1e-4); {dt:.2f} s, "
                f"{dt / max(res.iterations_run, 1) * 1e3:.3f} ms/iter")
            require(res.converged, f"parity {rule} did not converge")
            require(rel <= 1e-4, f"parity {rule} dual off by {rel:.2e}")
            require(lo - PARITY_CHECK <= res.iterations_run
                    <= hi + PARITY_CHECK,
                    f"parity {rule} stopped at {res.iterations_run}, outside "
                    f"{lo}..{hi}")
            runs.append(res)
        require(runs[0].iterations_run == runs[1].iterations_run
                and torch.equal(runs[0].lam, runs[1].lam),
                f"two {rule} parity runs differ")
        log(f"parity: two {rule} runs bit-identical (iterations and lambda)")
    res, dt, _ = parity_solve(lp_np, "aligned", algorithm="pga", fixed=300)
    dual = float(res.stats.dual_obj[-1])
    rel = abs(dual - PGA_300_DUAL) / abs(PGA_300_DUAL)
    log(f"parity pga, fixed 300 iterations: dual {dual:.6f} vs the port's "
        f"CPU run {PGA_300_DUAL:.6f} (rel {rel:.2e}, limit 1e-5); "
        f"{dt:.2f} s, {dt / 300 * 1e3:.3f} ms/iter")
    require(rel <= 1e-5, f"pga's 300-iteration dual off by {rel:.2e}")


def cli_flags():
    """Phase 8's CLI flags at parity size: --save-duals then --warm-start,
    --checkpoint-dir then --resume against the uninterrupted run, and
    --resume under another --algorithm."""
    import tempfile
    import torch
    from repro_torch.launch import solve
    lines = []

    def run(*flags):
        args = solve.build_parser().parse_args(PARITY_ARGS + list(flags))
        return solve.run(args, log=lines.append, instance=inst)

    inst = solve.generate_instance(
        solve.build_parser().parse_args(PARITY_ARGS), log=lambda m: None)
    tol = ["--adaptive-continuation", "--tol-rel-dual", "1e-6",
           "--iterations", "3000"]
    with tempfile.TemporaryDirectory() as d:
        first = run(*tol, "--save-duals", os.path.join(d, "lam.npz"))
        warm = run(*tol, "--warm-start", os.path.join(d, "lam.npz"))
        reason = [m for m in lines if m.startswith("warm start:")]
        log(f"cli: --save-duals after {first.result['iterations_run']} "
            f"iterations, --warm-start stops after "
            f"{warm.result['iterations_run']} at gamma "
            f"{warm.result['gamma_final']:.4g}; {reason}")
        require(reason == ["warm start: duals already at gamma=0.01 on this "
                           "instance; continuation skipped"]
                and warm.result["iterations_run"]
                < first.result["iterations_run"],
                "--warm-start did not skip continuation")

        ck = ["--algorithm", "pdhg", "--checkpoint-dir"]
        run("--iterations", "100", *ck, os.path.join(d, "ck"))
        resumed = run("--iterations", "200", *ck, os.path.join(d, "ck"),
                      "--resume")
        full = run("--iterations", "200", *ck, os.path.join(d, "full"))
        same = (torch.equal(resumed.lam, full.lam)
                and resumed.result["dual_obj_final"]
                == full.result["dual_obj_final"])
        log(f"cli: --checkpoint-dir at 100, --resume to 200 against the "
            f"uninterrupted 200 (pdhg): bit for bit {same}")
        require(same and any(m.startswith("resumed from checkpoint step 100")
                             for m in lines),
                "the resumed CLI run differs from the uninterrupted one")
        try:
            run("--iterations", "300", "--algorithm", "bb",
                "--checkpoint-dir", os.path.join(d, "ck"), "--resume")
            refused = None
        except SystemExit as e:
            refused = str(e)
        log(f"cli: --resume with --algorithm bb on a pdhg checkpoint: "
            f"{refused}")
        require(refused is not None and refused.startswith(
            "--resume refused"), "--resume under another rule ran")


def formulation_main_path(inst, out):
    """Phase 9 (a): the main path's instance through the CLI entry point
    with --formulation multi_budget --algorithm pdhg --certify: converged
    within FORM_MAIN_CAP iterations, K1 and K2 launched, a valid
    certificate, both coupling rows binding; then what the two rows cost
    an evaluation against phase 3's matching objective at the same
    destination block, and the shift fold's own operations.  Returns the
    run's launches."""
    import torch
    from repro_torch.core.objectives import _shift_term
    from repro_torch.launch import solve
    args = solve.build_parser().parse_args(
        MAIN_ARGS + ["--formulation", "multi_budget", "--algorithm", "pdhg",
                     "--iterations", str(FORM_MAIN_CAP)])
    what = "formulations: main path, multi_budget, pdhg"
    out_f, launches, _ = drive(args, inst, ("dual_x_slab", "ax_reduce_plan_x"),
                               what)
    require(out_f.result["formulation"] == "multi_budget"
            and out_f.result["algorithm"] == "pdhg", "the CLI ran another "
            "formulation or rule")
    require(out_f.result["certificate_valid"] is True,
            "multi_budget certificate not valid")
    obj, lam = out_f.objective, out_f.lam
    g = torch.full((), out_f.gamma, device=DEVICE)
    mus = [lam[-2], lam[-1]]
    for (label, (used, limit)), mu in zip(obj.global_usage(lam, g).items(),
                                          mus):
        rel = used / limit - 1.0
        log(f"{what}: row {label} used {used!r} / limit {limit!r} "
            f"(relative {rel:+.3e}, limit {FORM_BIND_TOL:.0e}), "
            f"mu {float(mu)!r}")
        require(abs(rel) <= FORM_BIND_TOL and float(mu) > 0,
                f"{what}: row {label} does not bind")
    m, J = out.objective.lp.m, out.objective.lp.num_destinations
    lam_block = lam[:m * J].reshape(m, J)
    times = {"multi_budget": [], "matching": []}
    for _ in range(2):      # in turns
        times["matching"].append(cuda_ms(
            lambda: out.objective.calculate(lam_block, g), reps=10))
        times["multi_budget"].append(cuda_ms(
            lambda: obj.calculate(lam, g), reps=10))

    def fold():
        for si, slab in enumerate(obj.lp.slabs):
            shift = obj._shift_for(si, mus)
            slab.c_vals + shift
            _shift_term(shift, obj._views(si, slab)[0])
    t_fold = cuda_ms(fold)
    log(f"{what}: one evaluation (CUDA events, median of 10, in turns) "
        f"multi_budget {times['multi_budget']} ms against matching "
        f"{times['matching']} ms at the same destination block; the shift "
        f"fold alone (per slab: build mu_c + mu_v w, add it to c, take "
        f"<shift, x> back out) {t_fold:.4f} ms")
    return launches


def formulation_assignment(inst):
    """Phase 9 (b): assignment_eq at full width through the CLI entry
    point for a fixed FORM_FIXED iterations: finite, K2 launched, K1
    never (its simplex_eq block has no kernel, in the reference either:
    the plain sweep projects it).  Returns the run's launches."""
    import torch
    from repro_torch.launch import solve
    args = solve.build_parser().parse_args(
        MAIN_ARGS[:8] + ["--formulation", "assignment_eq", "--iterations",
                         str(FORM_FIXED), "--json", "--device", DEVICE])
    what = "formulations: main path, assignment_eq"
    reset_counters()
    out_a = solve.run(args, log=lambda msg: log(f"  {msg}"), instance=inst)
    launches = read_counters()
    res = out_a.result
    log(f"{what} result: {json.dumps(res, sort_keys=True)}")
    log(f"{what}: set-up {out_a.setup_seconds:.2f} s, {FORM_FIXED} "
        f"iterations in {out_a.solve_seconds:.3f} s "
        f"({out_a.solve_seconds / FORM_FIXED * 1e3:.3f} ms/iteration); "
        f"launches {launches}: K1 (dual_x_slab) 0, since the simplex_eq "
        f"block has no kernel (the reference's compiler keeps it off its "
        f"kernels too) and every slab runs the plain sweep; K2 runs the Ax")
    require(res["iterations_run"] == FORM_FIXED
            and bool(torch.isfinite(out_a.lam).all())
            and math.isfinite(res["dual_obj_final"]),
            f"{what}: non-finite lambda or dual")
    require(launches["ax_reduce_plan_x"] > 0 and launches["dual_x_slab"] == 0,
            f"{what}: K2 did not run, or K1 ran: {launches}")
    t_eval, t_enq, busy = evaluation_timing(out_a.objective, out_a.lam,
                                            out_a.gamma, reps=3)
    log(f"{what}: one evaluation {t_eval:.3f} ms synchronised, host "
        f"enqueue {t_enq:.3f} ms, device kernel time "
        + ("not measured" if busy is None else f"{busy:.3f} ms"))
    return launches


def compiled_matching(out):
    """Phase 9 (c): `compile_formulation(matching)` on phase 3's LP equals
    phase 3's objective bit for bit at its final lambda."""
    import torch
    from repro_torch import formulations
    obj = out.objective
    comp = formulations.compile_formulation(
        formulations.build("matching", obj.lp), obj.lp)
    g = torch.full((), out.gamma, device=DEVICE)
    g1, d1, a1 = obj.calculate(out.lam, g)
    g2, d2, a2 = comp.calculate(out.lam.reshape(-1), g)
    require(calculate_bits_equal((g1, d1.reshape(-1), a1), (g2, d2, a2)),
            "compiled matching differs from phase 3's objective")
    log("formulations: compile_formulation(matching) equals phase 3's "
        "objective bit for bit at its final lambda (g, grad, aux)")


def formulation_solve(lp_np, name, mode="aligned", algorithm="agd"):
    """One perf_lp/tol_<algorithm>_<name> solve on the card, as the
    reference's rows ran: compiled with row_norm from the un-preconditioned
    instance, gamma 0.01, max_step 0.1, tol_rel_dual 1e-6 and
    tol_infeas_rel 1e-4 every 25, at most 30,000 iterations.  Returns
    (result, seconds, launches)."""
    import torch
    from repro_torch import formulations
    from repro_torch.convert import lp_to_torch
    from repro_torch.core import Maximizer, SolveConfig, StoppingCriteria
    obj = formulations.make_objective(name, lp_to_torch(lp_np, DEVICE),
                                      ax_mode=mode, row_norm=True)
    cfg = SolveConfig(iterations=30000, gamma=0.01, max_step=1e-1,
                      initial_step=1e-5)
    crit = StoppingCriteria(tol_rel_dual=1e-6, tol_infeas_rel=1e-4,
                            check_every=PARITY_CHECK)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    res = Maximizer(cfg, algorithm=algorithm).maximize(obj, criteria=crit)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, read_counters()


def formulation_parity():
    """Phase 9 (d): the reference's perf_lp formulation rows on the card:
    agd twice on global_count, multi_budget and assignment_eq (each pair
    bit-identical), pdhg on each, bb on multi_budget and assignment_eq,
    each converged, its dual within 1e-4 of the recorded one and its stop
    inside FORM_WINDOWS; then multi_budget in aligned_gvals (K3 + K4)
    along aligned's trajectory bit for bit.  Returns each run's
    launches."""
    import numpy as np
    import torch
    from repro_torch.core import InstanceSpec, generate, validate_lp
    spec = InstanceSpec(num_sources=2000, num_destinations=1000,
                        avg_nnz_per_row=4.0, seed=42)
    lp_np = validate_lp(generate(spec))
    launches = {}

    def run(name, rule, mode="aligned"):
        res, dt, n = formulation_solve(lp_np, name, mode, rule)
        lo, hi = FORM_WINDOWS[rule, name]
        rec_it, rec_dual = FORM_RECORDED[rule, name]
        dual = float(res.stats.dual_obj[-1])
        rel = abs(dual - rec_dual) / abs(rec_dual)
        what = f"parity perf_lp/tol_{rule}_{name} {mode}"
        log(f"{what}: {res.stop_reason.value} after {res.iterations_run} "
            f"iterations (recorded {rec_it}, window {lo}..{hi}, held within "
            f"one check of it); dual {dual:.6f} vs {rec_dual:.6f} (rel "
            f"{rel:.2e}, limit 1e-4); {dt:.2f} s, "
            f"{dt / max(res.iterations_run, 1) * 1e3:.3f} ms/iter; "
            f"launches {n}")
        require(res.converged, f"{what} did not converge")
        require(rel <= 1e-4, f"{what}: dual off by {rel:.2e}")
        require(lo - PARITY_CHECK <= res.iterations_run <= hi + PARITY_CHECK,
                f"{what} stopped at {res.iterations_run}, outside "
                f"{lo}..{hi}")
        launches[f"{rule} {name} {mode}"] = n
        return res

    agd = {}
    for name in ("global_count", "multi_budget", "assignment_eq"):
        r1, r2 = run(name, "agd"), run(name, "agd")
        require(r1.iterations_run == r2.iterations_run
                and torch.equal(r1.lam, r2.lam),
                f"two agd {name} parity runs differ")
        log(f"parity: two agd {name} runs bit-identical (iterations and "
            f"lambda)")
        agd[name] = r1
    for name in ("global_count", "multi_budget", "assignment_eq"):
        run(name, "pdhg")
    for name in ("multi_budget", "assignment_eq"):
        run(name, "bb")
    res_g = run("multi_budget", "agd", "aligned_gvals")
    a = agd["multi_budget"]
    require(res_g.iterations_run == a.iterations_run
            and torch.equal(res_g.lam, a.lam)
            and all(np.array_equal(u, v) for u, v in zip(res_g.stats,
                                                            a.stats)),
            "multi_budget: aligned_gvals's trajectory differs from aligned's")
    log("parity: multi_budget in aligned_gvals (K3 + K4) follows aligned's "
        "trajectory bit for bit (every iteration's stats, lambda)")
    return launches


# phase 10: the ranks' hard timeout, and the (b) runs' grids
RANK_TIMEOUT = 300
RANK_RUNS = {"replicated": dict(shape=[2, 1], lambda_axis=None, runs=2),
             "lambda-sharded": dict(shape=[1, 2], lambda_axis="model",
                                    runs=1)}


def probe_gloo_cuda(group):
    """Whether gloo takes CUDA tensors in all_gather and reduce-scatter
    (the λ-sharded mode's collectives): (True, "") or (False, the error).
    Both ranks run the same probe, so a refusal is the same on each."""
    import torch
    from repro_torch.core.distributed import _all_gather, _reduce_scatter
    world = torch.distributed.get_world_size()
    x = torch.ones(4, device="cuda")
    try:
        _all_gather(torch.empty(4 * world, device="cuda"), x, group)
        _reduce_scatter(torch.empty(4, device="cuda"),
                        torch.ones(4 * world, device="cuda"), group)
        torch.cuda.synchronize()
    except RuntimeError as e:
        return False, str(e).splitlines()[0][:200]
    return True, ""


def rank_worker(spec):
    """`--rank-worker SPEC`: one rank of phase 10 (b)/(c).  Brings up the
    group (gloo or NCCL over a FileStore, a collective timeout of 120 s),
    solves perf_lp/tol_agd's instance distributed on the spec's grid in
    aligned (`rank_solve`), and returns what it found."""
    import datetime
    import gc
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(spec["card"])
    dist.init_process_group(spec["backend"],
                            store=dist.FileStore(spec["store"],
                                                 spec["world"]),
                            rank=spec["rank"], world_size=spec["world"],
                            timeout=datetime.timedelta(seconds=120))
    try:
        return rank_solve(spec)
    finally:
        # rank_solve let go of every subgroup; one that outlives the
        # default group is torn down at exit, where gloo may abort
        gc.collect()
        dist.destroy_process_group()


def rank_solve(spec):
    import hashlib
    import torch
    from repro_torch.convert import lp_to_torch
    from repro_torch.core import (DistributedMatchingObjective, InstanceSpec,
                                  SolveConfig, StoppingCriteria, generate,
                                  precondition, validate_lp)
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import init_ranks, make_grid
    device = torch.device("cuda", spec["card"])
    ranks = init_ranks(str(device))
    require(ranks.grouped and ranks.world == spec["world"], f"ranks {ranks}")
    grid = make_grid(spec["shape"], ("data", "model"))
    found = {"rank": spec["rank"], "backend": spec["backend"],
             "card": torch.cuda.get_device_name(device)}
    if spec["lambda_axis"] is not None and spec["backend"] == "gloo":
        ok, why = probe_gloo_cuda(grid.group((spec["lambda_axis"],)))
        found["gloo_cuda_collectives"] = [ok, why]
        if not ok:
            return found
    _build.build()
    WRAPPERS.update(_wrappers())
    lp = precondition(lp_to_torch(validate_lp(generate(InstanceSpec(
        num_sources=2000, num_destinations=1000, avg_nnz_per_row=4.0,
        seed=42))), "cpu"), row_norm=True)[0]
    cfg = SolveConfig(iterations=30000, gamma=0.01, max_step=1e-1,
                      initial_step=1e-5)
    crit = StoppingCriteria(tol_rel_dual=1e-6, tol_infeas_rel=1e-4,
                            check_every=PARITY_CHECK)
    obj = DistributedMatchingObjective(
        lp, grid, proj_kind="boxcut", proj_iters=20, ax_mode="aligned",
        lambda_axis=spec["lambda_axis"], device=device)
    found["rows"] = sum(s.n for s in obj.lp.slabs)
    found["runs"] = []
    reset_counters()
    for _ in range(spec["runs"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = obj.solve(cfg, criteria=crit)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        found["runs"].append({
            "iterations": res.iterations_run,
            "converged": res.converged,
            "dual": float(res.stats.dual_obj[-1]),
            "lam_sha256": hashlib.sha256(
                res.lam.cpu().numpy().tobytes()).hexdigest(),
            "seconds": dt})
    found["launches"] = read_counters()
    return found


def spawn_ranks(world, backend, shape, lambda_axis, runs, per_card):
    """Phase 10 (b)/(c): `world` rank processes of this script, on card 0
    (`per_card` False) or one card each, each killed past RANK_TIMEOUT.
    Returns every rank's findings."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        procs = []
        for r in range(world):
            spec = dict(rank=r, world=world, backend=backend, shape=shape,
                        lambda_axis=lambda_axis, runs=runs,
                        card=r if per_card else 0,
                        store=os.path.join(d, "store"), out=d)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank-worker",
                 json.dumps(spec)], cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, text) in enumerate(zip(procs, logs)):
            require(p.returncode == 0,
                    f"rank {r} of {world} ({backend}) failed (rc "
                    f"{p.returncode}):\n{text[-3000:]}")
        return [json.load(open(os.path.join(d, f"rank{r}.json")))
                for r in range(world)]


def ranks_parity(what, world, backend, per_card):
    """Phase 10 (b)/(c): the parity run on `world` ranks, replicated
    (twice) and, where the collectives are taken, λ-sharded; each held to
    the reference's window; every rank the same bits."""
    lo, hi = PARITY_ITERATIONS
    for mode, run in RANK_RUNS.items():
        shape = ([world, 1] if run["lambda_axis"] is None else [1, world])
        ranks = spawn_ranks(world, backend, shape, run["lambda_axis"],
                            run["runs"], per_card)
        probe = ranks[0].get("gloo_cuda_collectives")
        if probe is not None:
            log(f"ranks {what}: gloo {'takes' if probe[0] else 'refuses'} "
                f"CUDA tensors in all_gather and reduce-scatter"
                + ("" if probe[0] else f" ({probe[1]}); the lambda-sharded "
                   f"run on {world} ranks was not run on the card (held by "
                   f"the CPU tests only)"))
            if not probe[0]:
                continue
        runs = ranks[0]["runs"]

        def bits(r):
            return [(x["iterations"], x["dual"], x["lam_sha256"])
                    for x in r["runs"]]
        for r in ranks[1:]:
            require(bits(r) == bits(ranks[0]),
                    f"ranks {what} {mode}: rank {r['rank']} differs from "
                    f"rank 0")
        for i, x in enumerate(runs):
            rel = abs(x["dual"] - PARITY_DUAL) / abs(PARITY_DUAL)
            log(f"ranks {what} {mode} on a {tuple(shape)} grid, run {i + 1}: "
                f"{'converged' if x['converged'] else 'NOT converged'} after "
                f"{x['iterations']} iterations (reference {lo}..{hi}, held "
                f"within one check); dual {x['dual']:.6f} vs "
                f"{PARITY_DUAL:.6f} (rel {rel:.2e}, limit 1e-4); "
                f"{x['seconds']:.2f} s, "
                f"{x['seconds'] / max(x['iterations'], 1) * 1e3:.3f} "
                f"ms/iter; rank rows {[r['rows'] for r in ranks]}; "
                f"launches of rank 0 {ranks[0]['launches']}")
            require(x["converged"], f"ranks {what} {mode}: not converged")
            require(rel <= 1e-4, f"ranks {what} {mode}: dual off by "
                    f"{rel:.2e}")
            require(lo - PARITY_CHECK <= x["iterations"] <= hi + PARITY_CHECK,
                    f"ranks {what} {mode}: stopped at {x['iterations']}")
        require(ranks[0]["launches"]["dual_x_slab"] > 0
                and ranks[0]["launches"]["ax_reduce_plan_x"] > 0,
                f"ranks {what} {mode}: K1/K2 never ran on rank 0")
        if len(runs) > 1:
            same = all((a["iterations"], a["lam_sha256"])
                       == (runs[0]["iterations"], runs[0]["lam_sha256"])
                       for a in runs[1:])
            log(f"ranks {what} {mode}: the {len(runs)} runs' bits repeat "
                f"(iterations and lambda): {same}")


def distributed_one_rank(inst, main, gvals):
    """Phase 10 (a): a one-rank NCCL group in this process, and the main
    path through the CLI entry point (its matching path is the
    distributed solve) in aligned (+ certificate) and aligned_gvals, each
    bit for bit its single-device phase's (`main`, `gvals`: (result,
    lambda, solve seconds)).  Returns the launches of each run."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import solve
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        launches = {}
        for mode, (res0, lam0, solve0), extra in (
                ("aligned", main, []),
                ("aligned_gvals", gvals, ["--ax-mode", "aligned_gvals"])):
            flags = MAIN_ARGS + extra
            if mode != "aligned":
                flags = [a for a in flags if a != "--certify"]
            args = solve.build_parser().parse_args(flags)
            expect = (("dual_x_slab", "ax_reduce_plan_x") if mode == "aligned"
                      else ("dual_grad_slab", "ax_reduce_plan"))
            out, launches[mode], _ = drive(args, inst, expect,
                                           f"ranks (a) one NCCL rank, {mode}")
            res = out.result
            same = (res["iterations_run"] == res0["iterations_run"]
                    and res["dual_obj_final"] == res0["dual_obj_final"]
                    and torch.equal(out.lam, lam0))
            iters = res["iterations_run"]
            log(f"ranks (a) {mode}: {iters} iterations, dual "
                f"{res['dual_obj_final']!r}, certificate "
                f"{res.get('certificate_valid', 'not asked')}; bit for bit "
                f"the single-device run: {same}; solve loop "
                f"{out.solve_seconds / max(iters, 1) * 1e3:.3f} ms/iteration "
                f"against {solve0 / max(res0['iterations_run'], 1) * 1e3:.3f} "
                f"single-device")
            require(same, f"ranks (a) {mode}: one NCCL rank differs from the "
                    f"single-device run")
            if mode == "aligned":
                require(res["certificate_valid"] is True
                        and res0["certificate_valid"] is True,
                        "ranks (a): certificate not valid")
                m, J = out.lam.shape
                buf = torch.zeros(m * J + 2, device="cuda")
                ms = cuda_ms(lambda: dist.all_reduce(buf), reps=50)
                log(f"ranks (a): one all_reduce of the step's m*J + 2 = "
                    f"{m * J + 2} floats ({4 * (m * J + 2)} bytes) over one "
                    f"NCCL rank: {ms:.4f} ms (CUDA events, median of 50)")
            del out
            torch.cuda.empty_cache()
        return launches
    finally:
        dist.destroy_process_group()


# phase 11: the allocation server and its frontend on phase 3's objective:
# the query sizes driven one thread at a time (queries of each), the
# random sources held bit for bit, the microbatch rows K1 is timed at, the
# drill's client threads, request size (sources; two fill one 64-source
# batch, and the clients' own interpreter time stays a small share of
# the load), deadline, length in seconds and its load, in sources,
# against the capacity measured one thread at a time
SERVE_SIZES = (1, 8, 64, 256)
SERVE_QUERIES = 500
SERVE_BITS = 10_000
MICROBATCH_ROWS = (8, 64, 256)
DRILL_THREADS = 8
DRILL_REQUEST = 32
DRILL_DEADLINE = 0.25
DRILL_SECONDS = 10.0
DRILL_LOAD = 2.0
RESOLVE_FIXED = 500   # iterations of the re-solve queries run beside


class ServeCounts:
    """K1's and K2's launches over phase 11's serving runs: each run has
    its counters set to 0 just before and read just after, and is added
    up here; the launches that compare a kernel with its plain version or
    time it are never counted."""

    def __init__(self):
        self.by_step = {}

    def run(self, step, fn, *args, **kw):
        import torch
        reset_counters()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        got = read_counters()
        for k, v in got.items():
            self.by_step.setdefault(step, {}).setdefault(k, 0)
            self.by_step[step][k] += v
        return out

    def total(self, name):
        return sum(n.get(name, 0) for n in self.by_step.values())


def served_bits(what, srv, obj, ids, counts, step):
    """Serve `ids` in queries of 256 and hold every row to the same row
    of `obj.primal(lambda)` bit for bit.  Returns the rows checked."""
    import numpy as np
    import torch
    g = torch.full((), float(srv.gamma), device=srv.lam.device)
    full = obj.primal(srv.lam, g)
    got = {}
    for lo in range(0, len(ids), 256):
        got.update(counts.run(step, srv.query, ids[lo:lo + 256]))
    require(set(got) == set(int(i) for i in ids), f"{what}: ids missing")
    by_slab = {}
    for d in got.values():
        by_slab.setdefault(d.slab_index, []).append(d)
    for si, ds in by_slab.items():
        rows = torch.tensor([d.row for d in ds], device=srv.lam.device)
        want = full[si].index_select(0, rows).float().cpu().numpy()
        served = np.stack([d.x for d in ds])
        require(np.array_equal(served, want),
                f"{what}: served rows of slab {si} differ from primal")
    widths = sorted({obj.lp.slabs[si].width for si in by_slab})
    log(f"serve bits, {what}: {len(got)} served rows over {len(by_slab)} "
        f"slabs (widths {widths}) equal obj.primal(lambda) bit for bit")
    del full
    return len(got)


def microbatch_records(obj, lam, gamma):
    """K1 on 256-row sub-slabs gathered as a query gathers them, against
    its plain version (max |dx|, atol 1e-4), and its time on 8-, 64- and
    256-row microbatches of each slab (CUDA events around the wrapper, and
    the kernel's device time, profiled) beside the byte and issue bound of
    that microbatch.  None of these launches is counted."""
    import numpy as np
    import torch
    from repro_torch.core.types import Slab
    from repro_torch.kernels import ref
    from repro_torch.kernels.dual_grad import dual_x_slab
    from repro_torch.launch import census
    g = torch.full((), gamma, device=lam.device)
    iters = obj.proj_iters
    m, J = lam.shape
    rng = np.random.default_rng(11)
    err, out = 0.0, {}
    for si, slab in enumerate(obj.lp.slabs):
        for n in MICROBATCH_ROWS:
            rows = torch.from_numpy(np.sort(rng.choice(
                slab.n, size=min(n, slab.n), replace=False))).to(lam.device)
            sub = Slab(*(t.index_select(0, rows) for t in slab))
            x, _, _ = dual_x_slab(*sub[:6], lam, g, iters=iters)
            if n == max(MICROBATCH_ROWS):
                xr, _, _ = ref.dual_x_ref(*sub[:6], lam, g, iters)
                err = max(err, float((x - xr).abs().max()))
            c = census.slab_counts([sub])
            nbytes, real = census.sweep_bytes(c, m, J), c.real
            steps = bisection_steps([sub], lam, g, iters)
            b_ms, b_by, bytes_ms, issue_ms = steps_bound(
                nbytes, steps, real_ops(real, m, False), iters)
            call = lambda: dual_x_slab(*sub[:6], lam, g, iters=iters)
            ms, dev_ms = cuda_ms(call), device_ms(call)
            plain_ms = cuda_ms(lambda: ref.dual_x_ref(*sub[:6], lam, g,
                                                      iters),
                               reps=5, warmup=1)
            out[f"w{slab.width}_rows{n}"] = {
                "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by,
                "bound_bytes_ms": bytes_ms, "bound_issue_ms": issue_ms,
                "real_entries": real}
            log(f"serve K1 microbatch: slab {si} (w={slab.width}), {n} rows "
                f"({real} real entries): {ms:.4f} ms (CUDA events around "
                f"the wrapper, median of 20), its kernel on the device "
                + ("not measured" if dev_ms is None else f"{dev_ms:.4f} ms")
                + f" (profiled); plain {plain_ms:.4f} ms; bound "
                f"{b_ms:.6f} ms ({b_by}) = max("
                f"{nbytes} bytes = {bytes_ms:.6f} ms, issue {issue_ms:.6f} "
                f"ms)")
    require(err <= 1e-4, f"serve: K1 on 256-row sub-slabs max |dx| {err} "
            f"against its plain version > 1e-4")
    log(f"serve: K1 on every slab's 256-row sub-slab against "
        f"kernels/ref.py::dual_x_ref: max |dx| {err:.3e} (atol 1e-4)")
    return out, err


def one_thread(srv, counts):
    """SERVE_QUERIES queries of each of SERVE_SIZES random sources, one
    thread: stats() of each size, and K1 launches a query."""
    import numpy as np
    ids = srv.source_ids()
    rng = np.random.default_rng(3)
    per = {}
    for size in SERVE_SIZES:
        srv.reset_stats()
        reset_before = counts.total("dual_x_slab")
        for _ in range(SERVE_QUERIES):
            counts.run("one thread", srv.query,
                       rng.choice(ids, size=size, replace=False).tolist())
        st = srv.stats()
        k1 = counts.total("dual_x_slab") - reset_before
        per[size] = {"queries": st.queries, "p50_ms": st.p50_ms,
                     "p95_ms": st.p95_ms, "mean_ms": st.mean_ms,
                     "sources_per_s": st.sources_per_s,
                     "k1_launches_per_query": k1 / st.queries}
        log(f"serve one thread, {size} sources a query: {st.queries} "
            f"queries, p50 {st.p50_ms:.4f} ms, p95 {st.p95_ms:.4f} ms "
            f"(histogram buckets), mean {st.mean_ms:.4f} ms, "
            f"{st.sources_per_s:.0f} sources/s, K1 launches a query "
            f"{k1 / st.queries:.3f}")
    require(sum(p["queries"] for p in per.values()) >= 2000,
            "serve: fewer than 2,000 one-thread queries")
    return per


def export_round_trip(obj, lam, gamma, counts):
    """write_shards of the whole instance to a temporary directory, read
    back, bit for bit extract_primal; the directory is deleted."""
    import shutil
    import tempfile
    from repro_torch.primal import extract_primal, read_shards, write_shards
    d = tempfile.mkdtemp(prefix="serve_export_")
    try:
        t0 = time.perf_counter()
        paths = counts.run("export", write_shards, obj, lam, gamma, d)
        dt = time.perf_counter() - t0
        size = sum(os.path.getsize(p) for p in paths)
        n_src = sum(s.n for s in obj.lp.slabs)
        t1 = time.perf_counter()
        back = read_shards(paths, len(obj.lp.slabs))
        dt_read = time.perf_counter() - t1
        xs = extract_primal(obj, lam, gamma)
        require(all(a is not None and a.shape == b.shape
                    and (a == b).all() and
                    (a.view("u4") == b.view("u4")).all()
                    for a, b in zip(back, xs)),
                "serve: read_shards(write_shards) differs from "
                "extract_primal")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    log(f"serve export: {len(paths)} shards of {n_src} sources, {size} "
        f"bytes on disk, written in {dt:.2f} s ({n_src / dt:.0f} "
        f"sources/s), read back in {dt_read:.2f} s, equal to extract_primal "
        f"bit for bit; directory deleted")
    return {"shards": len(paths), "seconds": dt, "sources_per_s": n_src / dt,
            "bytes": size, "read_seconds": dt_read}


def export_cli():
    """The CLI's --export-primal at parity size: its shards read back equal
    extract_primal at its own final lambda bit for bit."""
    import shutil
    import tempfile
    from repro_torch.launch import solve
    from repro_torch.primal import extract_primal, read_shards
    d = tempfile.mkdtemp(prefix="serve_cli_")
    try:
        args = solve.build_parser().parse_args(
            PARITY_ARGS + ["--iterations", "200", "--chunk-rows", "512",
                           "--export-primal", d])
        lines = []
        out = solve.run(args, log=lines.append)
        names = sorted(os.listdir(d))
        back = read_shards([os.path.join(d, n) for n in names],
                           len(out.objective.lp.slabs))
        xs = extract_primal(out.objective, out.lam, out.gamma)
        same = all(a is not None and (a.view("u4") == b.view("u4")).all()
                   for a, b in zip(back, xs))
        note = [m for m in lines if m.startswith("exported ")]
        log(f"cli: --export-primal at parity size: {note}; "
            f"{out.result.get('export_shards')} shards, read back equal to "
            f"extract_primal bit for bit {same}")
        require(same and out.result.get("export_shards") == len(names) > 1,
                "--export-primal shards differ from extract_primal")
    finally:
        shutil.rmtree(d, ignore_errors=True)


def rhs_nudge(obj, factor):
    """Phase 3's objective over b x `factor`: the same slabs, plan and
    work table (a shallow copy shares them), its own x buffer."""
    import copy
    import torch
    require(not obj._graphs and obj._gbuf is None,
            "rhs_nudge: phase 3's objective should be aligned, graph-free")
    new = copy.copy(obj)
    new.lp = obj.lp._replace(b=obj.lp.b * factor)
    new._xbuf = torch.zeros_like(obj._xbuf)
    return new


def warm_resolve_phase(srv, obj, counts):
    """(e): the full-width warm re-solve onto b x 0.99 with a certificate,
    queries after the swap against the new objective's primal, then an
    ExplodingObjective refused (degraded, lambda unchanged) and cleared by
    the next forced success.  Returns (record, the new objective)."""
    import numpy as np
    import torch
    from repro_torch.core import StoppingCriteria
    from repro_torch.testing import ExplodingObjective
    crit = StoppingCriteria(tol_rel_dual=1e-6, check_every=25,
                            max_iterations=3000)
    new = rhs_nudge(obj, 0.99)
    t0 = time.perf_counter()
    res = counts.run("warm re-solve", srv.warm_resolve, criteria=crit,
                     obj=new, require_certificate=True)
    dt = time.perf_counter() - t0
    require(res is not None and res.converged,
            f"serve: warm re-solve failed ({srv.last_failure_reason})")
    require(srv.obj is new and torch.equal(srv.lam, res.lam),
            "serve: the re-solved pair was not published")
    log(f"serve warm re-solve (b x 0.99, full width, certificate required): "
        f"{res.iterations_run} iterations, {res.stop_reason.value}, "
        f"{dt:.2f} s including the certificate and the new objective's "
        f"query shapes; launches {counts.by_step['warm re-solve']}")
    ids = np.random.default_rng(5).choice(srv.source_ids(), size=2000,
                                          replace=False)
    served_bits("after the swap (b x 0.99)", srv, new, ids.tolist(), counts,
                "warm re-solve")
    lam_before = srv.lam.clone()
    bad = srv.warm_resolve(criteria=crit, obj=ExplodingObjective(new),
                           force=True)
    st = srv.stats()
    require(bad is None and st.degraded and srv.obj is new
            and torch.equal(srv.lam, lam_before),
            "serve: ExplodingObjective was not refused cleanly")
    log(f"serve: ExplodingObjective refused ({srv.last_failure_reason}); "
        f"degraded {st.degraded}, served lambda unchanged")
    t1 = time.perf_counter()
    again = counts.run("warm re-solve", srv.warm_resolve, criteria=crit,
                       force=True)
    dt2 = time.perf_counter() - t1
    st = srv.stats()
    require(again is not None and not st.degraded
            and st.consecutive_failures == 0,
            "serve: a forced success did not clear the degraded state")
    log(f"serve: forced re-solve from the served lambda: "
        f"{again.iterations_run} iterations in {dt2:.2f} s; degraded "
        f"{st.degraded}, resolve failures {st.resolve_failures}")
    return {"iterations": res.iterations_run, "seconds": dt,
            "stop_reason": res.stop_reason.value,
            "forced_iterations": again.iterations_run,
            "forced_seconds": dt2}, new


def queries_during_resolve(srv):
    """One thread's back-to-back 64-source queries, idle and while another
    thread re-solves RESOLVE_FIXED iterations from the served lambda: on
    the server's two streams, then (a diagnostic of that design) with the
    re-solve on the query stream.  Exact percentiles of the host clock;
    no launch is counted (two threads launch)."""
    import threading
    import numpy as np
    from repro_torch.core import StoppingCriteria
    ids = srv.source_ids()
    rng = np.random.default_rng(13)
    crit = StoppingCriteria(max_iterations=RESOLVE_FIXED)

    def probe(resolve):
        lat = []
        t = threading.Thread(target=resolve) if resolve else None
        if t is not None:
            t.start()
        while (len(lat) < 200) if t is None else t.is_alive():
            q = rng.choice(ids, size=64, replace=False).tolist()
            t0 = time.perf_counter()
            srv.query(q)
            lat.append((time.perf_counter() - t0) * 1e3)
        if t is not None:
            t.join(timeout=300.0)
            require(not t.is_alive(), "serve: the re-solve did not end")
        return {"n": len(lat), "p50_ms": float(np.percentile(lat, 50)),
                "p95_ms": float(np.percentile(lat, 95))}

    out, resolved = {"idle": probe(None)}, []

    def resolve():
        t0 = time.perf_counter()
        res = srv.warm_resolve(criteria=crit, force=True)
        resolved.append((res, time.perf_counter() - t0))

    out["two streams"] = probe(resolve)
    own = srv._resolve_stream
    srv._resolve_stream = srv._query_stream
    try:
        out["one shared stream"] = probe(resolve)
    finally:
        srv._resolve_stream = own
    require(len(resolved) == 2 and all(r is not None for r, _ in resolved),
            "serve: a fixed re-solve failed")
    for (k, v), (_, sec) in zip(list(out.items())[1:], resolved):
        v["resolve_seconds"] = sec
    log(f"serve: 64-source queries on one thread, p50 / p95 ms (exact), "
        f"idle and beside a {RESOLVE_FIXED}-iteration re-solve: " + "; ".join(
            f"{k}: n={v['n']} {v['p50_ms']:.4f} / {v['p95_ms']:.4f}"
            + (f" (re-solve {v['resolve_seconds']:.3f} s)"
               if "resolve_seconds" in v else "")
            for k, v in out.items()))
    return out


def frontend_drill(srv, obj, capacity_rps):
    """(f): DRILL_THREADS client threads submit DRILL_REQUEST-source
    requests open loop at DRILL_LOAD x the one-thread capacity for about
    DRILL_SECONDS; a refresh onto b x 0.98 lands mid-run and /metrics is
    scraped once over loopback; then drain.  Every ticket answered, 0
    ERROR, no OK past its deadline, every submission classified."""
    import threading
    import urllib.request
    import numpy as np
    from repro_torch.core import StoppingCriteria
    from repro_torch.obs import parse_exposition
    from repro_torch.primal import FrontendConfig, RequestStatus, \
        ServerFrontend
    fe = ServerFrontend(srv, FrontendConfig(
        max_queue=512, max_batch=64, default_deadline_s=DRILL_DEADLINE,
        metrics_port=0))
    ids = srv.source_ids()
    rate = DRILL_LOAD * capacity_rps
    gap = DRILL_THREADS / rate
    tickets, lock, stop = [], threading.Lock(), threading.Event()

    def client(k):
        # open loop on a fixed schedule; a client behind it skips to the
        # next slot, so it always sleeps between requests (one that never
        # blocks holds the interpreter lock until the switch interval
        # forces it off, and every GIL hand-back of the dispatch thread
        # then waits behind it)
        rng = np.random.default_rng(100 + k)
        t_next = time.perf_counter()
        mine = []
        while not stop.is_set():
            mine.append(fe.submit(rng.choice(ids, size=DRILL_REQUEST,
                                             replace=False).tolist()))
            now = time.perf_counter()
            t_next += gap
            if t_next <= now:
                t_next = now + gap
            stop.wait(t_next - now)
        with lock:
            tickets.extend(mine)

    reset_counters()
    srv.reset_stats()
    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(DRILL_THREADS)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    stop.wait(DRILL_SECONDS * 0.3)
    with urllib.request.urlopen(fe.exporter.url, timeout=10.0) as resp:
        series = parse_exposition(resp.read().decode("utf-8"))
    want = ('repro_frontend_latency_seconds_count{status="ok"}',
            "repro_frontend_queue_depth",
            'repro_frontend_requests_total{status="shed"}',
            'repro_frontend_requests_total{status="timeout"}',
            "repro_memory_host_rss_bytes", "repro_memory_device_bytes_in_use")
    missing = [s for s in want if s not in series]
    require(not missing and series["repro_memory_device_bytes_in_use"] > 0,
            f"serve drill: /metrics lacks {missing} or the device gauge is 0")
    log(f"serve drill: /metrics scraped over loopback ({len(series)} series, "
        f"parsed); device bytes in use "
        f"{series['repro_memory_device_bytes_in_use']:.0f}, queue depth "
        f"{series['repro_frontend_queue_depth']:.0f}")
    stop.wait(DRILL_SECONDS * 0.1)
    target = rhs_nudge(obj, 0.98)
    crit = StoppingCriteria(tol_rel_dual=1e-6, check_every=25,
                            max_iterations=3000)
    r0 = time.monotonic()
    require(fe.refresh(criteria=crit, obj=target, force=True),
            "serve drill: refresh refused")
    while fe.refresh_in_flight() and time.monotonic() - r0 < 300:
        time.sleep(0.002)
    r1 = time.monotonic()
    status, res = fe.last_resolve
    rest = DRILL_SECONDS - (time.monotonic() - t0)
    if rest > 0:
        stop.wait(rest)
    stop.set()
    for t in threads:
        t.join(timeout=30.0)
    require(not any(t.is_alive() for t in threads),
            "serve drill: a client thread did not stop")
    snap = fe.drain(timeout=30.0)
    import torch
    torch.cuda.synchronize()
    # two threads launched here (dispatch, refresh) and the counters take
    # no lock: these counts are a floor, kept out of the serving totals
    got = read_counters()
    require(status == "accepted" and res is not None and res.converged
            and srv.obj is target,
            f"serve drill: the refresh was {status} "
            f"({srv.last_failure_reason})")
    resp = [t.result(timeout=1.0) for t in tickets]
    by = {s: 0 for s in RequestStatus}
    for r in resp:
        by[r.status] += 1
    late = sum(1 for t, r in zip(tickets, resp)
               if r.status is RequestStatus.OK
               and r.latency_s > t.deadline - t.t_submit)
    classified = (snap["ok_total"] + snap["shed_total"]
                  + snap["timeout_total"] + snap["error_total"])
    require(by[RequestStatus.ERROR] == 0 and late == 0
            and classified == snap["submitted_total"] == len(tickets)
            and all(t.done() for t in tickets),
            f"serve drill: {by}, {late} late OK, classified {classified} of "
            f"{snap['submitted_total']} ({len(tickets)} tickets)")

    def ok_ms(lo, hi):
        lat = [r.latency_s * 1e3 for t, r in zip(tickets, resp)
               if r.status is RequestStatus.OK and lo <= t.t_submit < hi]
        if not lat:
            return 0, None, None
        return (len(lat), float(np.percentile(lat, 50)),
                float(np.percentile(lat, 95)))

    before, during = ok_ms(t0, r0), ok_ms(r0, r1)
    require(during[0] > 0, "serve drill: no OK request during the refresh")
    fst, qst = fe.stats(), srv.stats()
    rec = {"submitted": len(tickets), "ok": by[RequestStatus.OK],
           "shed": by[RequestStatus.SHED],
           "timeout": by[RequestStatus.TIMEOUT], "error": 0,
           "offered_rps": len(tickets) / DRILL_SECONDS,
           "target_rps": rate, "capacity_rps": capacity_rps,
           "ok_before": {"n": before[0], "p50_ms": before[1],
                         "p95_ms": before[2]},
           "ok_during_refresh": {"n": during[0], "p50_ms": during[1],
                                 "p95_ms": during[2]},
           "refresh_seconds": r1 - r0,
           "refresh_iterations": res.iterations_run,
           "batches": fst.batches, "ema_batch_ms": fst.ema_batch_ms,
           "query_p50_ms": qst.p50_ms, "query_p95_ms": qst.p95_ms,
           "query_mean_ms": qst.mean_ms,
           "launches_floor": got}
    log(f"serve drill: {DRILL_THREADS} client threads, {DRILL_REQUEST} "
        f"sources a request, deadline {DRILL_DEADLINE} s, offered "
        f"{rec['offered_rps']:.0f} requests/s against a one-thread capacity "
        f"of {capacity_rps:.0f} (target {rate:.0f}); {fst.batches} batches, "
        f"each one server query: p50 {qst.p50_ms:.4f} ms, p95 "
        f"{qst.p95_ms:.4f} ms (histogram buckets), mean "
        f"{qst.mean_ms:.4f} ms; batch time EMA at the end "
        f"{fst.ema_batch_ms:.3f} ms: {len(tickets)} "
        f"submitted, OK {rec['ok']}, SHED {rec['shed']}, TIMEOUT "
        f"{rec['timeout']}, ERROR 0, no OK past its deadline, all "
        f"classified; OK latency before the refresh n={before[0]} p50 "
        f"{before[1]} ms p95 {before[2]} ms, during it n={during[0]} p50 "
        f"{during[1]} ms p95 {during[2]} ms (exact percentiles); the "
        f"refresh (b x 0.98) {r1 - r0:.3f} s, {res.iterations_run} "
        f"iterations; launches (two threads, unlocked counters: a floor) "
        f"{got}")
    return rec


def serve_phase(out, wide_out):
    """Phase 11: the lambda-resident allocation server and its frontend on
    phase 3's objective and final lambda.  Returns K1's and K2's serving
    fields for the kernels line."""
    import numpy as np
    import torch
    from repro_torch.launch import solve
    from repro_torch.primal import AllocationServer
    obj, lam, gamma = out.objective, out.lam, out.gamma
    counts = ServeCounts()
    cfg, _ = solve.solve_config(solve.build_parser().parse_args(MAIN_ARGS))
    t0 = time.perf_counter()
    srv = AllocationServer(obj, lam, gamma, config=cfg)
    t_build = time.perf_counter() - t0
    build_s = srv.snapshot_build_s
    n_warm = counts.run("warmup", srv.warmup)
    k1_warm = counts.by_step["warmup"]["dual_x_slab"]
    log(f"serve (a): snapshot build {srv.snapshot_build_s:.3f} s (routes of "
        f"{len(srv.source_ids())} sources and host dest/mask copies; the "
        f"server {t_build:.3f} s), warmup ran {n_warm} (slab, length) "
        f"shapes, K1 launches {k1_warm}")
    require(n_warm > 0 and k1_warm == n_warm,
            f"serve: warmup {n_warm} shapes, K1 launched {k1_warm}")
    # (b) bits at full width, every slab, and on the wide cell
    rng = np.random.default_rng(7)
    ids = srv.source_ids()
    picked = set(rng.choice(ids, size=SERVE_BITS, replace=False).tolist())
    for s in obj.lp.slabs:           # each slab's first and last row too
        sid = s.source_ids.cpu().numpy()
        picked.update(int(v) for v in sid[[0, -1]] if v >= 0)
    n_bits = served_bits("full width", srv, obj, sorted(picked), counts,
                         "bits")
    require(n_bits >= SERVE_BITS, "serve: fewer than 10,000 rows held")
    wsrv = AllocationServer(wide_out.objective, wide_out.lam, wide_out.gamma)
    require(max(s.width for s in wide_out.objective.lp.slabs) > 1024,
            "serve: the wide cell has no slab past 1,024")
    served_bits("the wide cell (3000 x 5000, nu = 1000)", wsrv,
                wide_out.objective, wsrv.source_ids().tolist(), counts,
                "bits")
    del wsrv
    micro, err = microbatch_records(obj, lam, gamma)
    # (c) one thread
    per = one_thread(srv, counts)
    # (d) export
    export = export_round_trip(obj, lam, gamma, counts)
    export_cli()
    # (e) warm re-solve at full width
    resolve, new = warm_resolve_phase(srv, obj, counts)
    resolve["queries_during"] = queries_during_resolve(srv)
    # (f) the frontend drill, at DRILL_LOAD x the capacity of 64-source
    # queries, in requests of DRILL_REQUEST sources
    capacity = per[64]["sources_per_s"] / DRILL_REQUEST
    drill = frontend_drill(srv, obj, capacity)
    k1 = counts.total("dual_x_slab")
    k2 = counts.total("ax_reduce_plan_x")
    log(f"serve: launches by run {counts.by_step} (the drill's apart); "
        f"K1 {k1}, K2 {k2}")
    require(k1 > 0 and k2 > 0, "serve: K1 or K2 never ran on the serving "
            "path")
    del srv, new
    torch.cuda.empty_cache()
    return ({"launches_serving": k1,
             "launches_serving_by_run": {
                 k: v["dual_x_slab"] for k, v in counts.by_step.items()},
             "serving_microbatch": micro, "serving_max_abs_err": err,
             "serving_one_thread": {str(k): v for k, v in per.items()},
             "serving_snapshot_build_s": build_s,
             "serving_export": export, "serving_warm_resolve": resolve,
             "serving_drill": drill},
            {"launches_serving": k2,
             "launches_serving_by_run": {
                 k: v["ax_reduce_plan_x"] for k, v in counts.by_step.items()}})


# phase 12: the solve's observability.  The profiled window of the
# full-width run (its first chunk, its length), and the loop's time outside
# the evaluation that PERF.md §5 had not split (1.677 - 1.3065 ms)
OBS_WINDOW = (2, 2)
UNSPLIT_MS = 0.37


def _trace_kind(name):
    """Which kernel a CUDA kernel event of a torch.profiler trace is: K1
    (`dual_x_kernel` / `dual_x_wide_kernel` with kGvals false), K3 (true),
    K2's item launch (`ax_items_kernel` over `XSrc`), K4's (`GSrc`), the
    Ax second pass, or the sweep's partial sums; demangled or not."""
    if "dual_x_kernel" in name or "dual_x_wide_kernel" in name:
        gvals = re.search(r"true>|Lb1E", name) is not None
        return "dual_grad_slab" if gvals else "dual_x_slab"
    if "ax_items_kernel" in name:
        return "ax_items_x" if "XSrc" in name else "ax_items_gvals"
    for kind in ("sum_items_kernel", "sum_partials_kernel"):
        if kind in name:
            return kind
    return "other"


HOOK_RANGES = ("ProfilerHook.prime", "ProfilerHook.drain")


def trace_kernels(path):
    """Of a Chrome trace that `ProfilerHook` exported: launches and device
    ms by `_trace_kind`, the other kernels' launches and device ms by name
    (its first 60 characters), largest first, and what the trace lost.
    The kernels launched inside the hook's opening and closing bursts
    (`HOOK_RANGES`) count as "hook".  `lost` counts the launches outside
    the bursts whose kernel is not in the trace, `lost_hook` those inside
    each burst (how much of its margin an edge took), and `skew_us` is
    the least time from a launch to its kernel's start on the trace's
    clock (below 0 when the card's timestamps read early)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["name"], e["ts"], e["ts"] + e.get("dur", 0))
             for e in events if e.get("name") in HOOK_RANGES
             and e.get("cat") != "gpu_user_annotation"]
    launches = {e.get("args", {}).get("correlation"): e for e in events
                if e.get("cat") == "cuda_runtime"
                and "LaunchKernel" in e.get("name", "")}
    burst = {c: name for c, e in launches.items()
             for name, a, b in spans if a <= e["ts"] <= b}
    hooked = set(burst)
    counts, ms, other, seen, skew = {}, {}, {}, set(), []
    for e in events:
        if e.get("cat") != "kernel":
            continue
        name = e.get("name", "")
        corr = e.get("args", {}).get("correlation")
        seen.add(corr)
        if corr in launches:
            skew.append(e["ts"] - launches[corr]["ts"])
        kind = "hook" if corr in hooked else _trace_kind(name)
        counts[kind] = counts.get(kind, 0) + 1
        ms[kind] = ms.get(kind, 0.0) + e.get("dur", 0) / 1e3
        if kind == "other":
            n, t = other.get(name[:60], (0, 0.0))
            other[name[:60]] = (n + 1, t + e.get("dur", 0) / 1e3)
    missing = set(launches) - seen
    lost = {"lost": len(missing - hooked),
            "lost_hook": {name.split(".")[1]: sum(
                burst[c] == name for c in missing & hooked)
                for name in HOOK_RANGES},
            "skew_us": round(min(skew), 2) if skew else None}
    return (counts, ms, sorted(other.items(), key=lambda kv: -kv[1][1]),
            lost)


def obs_main(args, out, records, tmp):
    """Phase 12 (a): phase 3's objective solved twice in turn, bare and
    with a run log, a memory sampler and a profiler over chunks 2-3: the
    same bits, the log valid, the trace's kernels equal to the launch
    counters over the window, the peak HBM between the census's argument
    bytes and the allocator's peak, the census's K1 and K2 bytes phase
    4's."""
    import numpy as np
    import torch
    from repro_torch.core import Maximizer
    from repro_torch.launch import census, report, solve
    from repro_torch.obs import (MemorySampler, ProfilerHook, Telemetry,
                                 load_run, validate_run)
    obj, dev = out.objective, out.lam.device
    cfg, crit = solve.solve_config(args)
    torch.cuda.reset_peak_memory_stats(dev)

    def timed(**hooks):
        snaps = []
        reset_counters()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = Maximizer(cfg).maximize(
            obj, criteria=crit, diagnostics_fn=lambda rec: snaps.append(
                read_counters()), **hooks)
        torch.cuda.synchronize(dev)
        return res, time.perf_counter() - t0, snaps

    bare, t_bare, _ = timed()

    def recorded(name, profiler=None):
        path = os.path.join(tmp, f"{name}.jsonl")
        tel = Telemetry.jsonl(path, stream=open(os.devnull, "w"))
        res, dt, snaps = timed(telemetry=tel, profiler=profiler,
                               sampler=MemorySampler(telemetry=tel,
                                                     device=dev))
        tel.close()
        return res, dt, snaps, path

    seen, t_seen, _, path = recorded("main")
    prof = ProfilerHook(os.path.join(tmp, "trace_main"),
                        start_chunk=OBS_WINDOW[0], num_chunks=OBS_WINDOW[1])
    profiled, t_prof, snaps, path_prof = recorded("main_profiled", prof)
    iters = bare.iterations_run

    def same(res):
        return (torch.equal(bare.lam, res.lam)
                and iters == res.iterations_run
                and bare.stop_reason == res.stop_reason
                and all(np.array_equal(a, b)
                        for a, b in zip(bare.stats, res.stats)))

    dual = float(bare.stats.dual_obj[-1])
    log(f"obs (a) main path, phase 3's objective, ms/iteration in turn: "
        f"bare {t_bare / iters * 1e3:.3f} ({iters} iterations, "
        f"{t_bare:.3f} s); run log + sampler {t_seen / iters * 1e3:.3f} "
        f"({t_seen / t_bare - 1:+.2%}); run log + sampler + profiler over "
        f"chunks {OBS_WINDOW[0]}-{OBS_WINDOW[0] + OBS_WINDOW[1] - 1} "
        f"{t_prof / iters * 1e3:.3f} ({t_prof / t_bare - 1:+.2%}); bit for "
        f"bit {same(seen)}, {same(profiled)}; stop {seen.stop_reason.value}, "
        f"final dual {dual!r}")
    require(same(seen) and same(profiled),
            "obs: an observed solve differs from the bare one")
    require(iters == out.result["iterations_run"]
            and dual == out.result["dual_obj_final"],
            f"obs: {iters} iterations, dual {dual!r}, not phase 3's")
    validate_run(path_prof)
    run = validate_run(path)
    checks = run.by_type("check")
    require([c["it"] for c in checks] == [d.it for d in seen.diagnostics],
            "obs: check events do not mirror the diagnostics")
    summary = report.summarize(run)
    rows = [summary["chunks"][k] for k in sorted(summary["chunks"], key=int)]
    execute = [r["execute"] * 1e3 for r in rows]
    host = [r["host"] * 1e3 for r in rows]
    in_spans = (sum(execute) + sum(host)) / iters
    log(f"obs (a) report.summarize: {len(rows)} chunks, {len(checks)} check "
        f"events; execute ms a chunk {[round(v, 3) for v in execute]}; host "
        f"ms a chunk {[round(v, 4) for v in host]}")
    log(f"obs (a) an iteration: execute {sum(execute) / iters:.4f} ms, host "
        f"{sum(host) / iters:.4f} ms, the rest of the loop "
        f"{t_seen / iters * 1e3 - in_spans:.4f} ms (bare run "
        f"{t_bare / iters * 1e3:.4f} ms in all; the unsplit share was "
        f"~{UNSPLIT_MS} ms, PERF.md §5)")
    first, n = OBS_WINDOW
    window = {k: snaps[first + n - 1][k] - snaps[first - 1][k]
              for k in ("dual_x_slab", "ax_reduce_plan_x")}
    counts, ms, other, lost = trace_kernels(prof.trace_paths[0])
    busy = sum(v for k, v in ms.items() if k != "hook")
    prof_chunks = report.summarize(load_run(path_prof))["chunks"]
    win_exec = sum(prof_chunks[str(c)]["execute"] * 1e3
                   for c in range(first, first + n))
    win_iters = n * crit.check_every     # the window's chunks are whole
    log(f"obs (a) trace {os.path.basename(prof.trace_paths[0])}: kernel "
        f"launches {counts}; launch counters over the window {window}; "
        f"lost from the trace {lost}; "
        f"device busy {busy:.3f} ms of the window's execute spans "
        f"{win_exec:.3f} ms (idle share {1 - busy / win_exec:.4f}, under "
        f"the profiler, the hook's bursts aside); device ms an "
        f"iteration by kind "
        f"{ {k: round(v / win_iters, 4) for k, v in ms.items() if k != 'hook'} }")
    log(f"obs (a) the other kernels, an iteration (launches, device ms): "
        + "; ".join(f"{name} {cnt / win_iters:.2f}, {t / win_iters:.4f}"
                    for name, (cnt, t) in other[:8]))
    require(counts.get("dual_x_slab", 0) == window["dual_x_slab"] > 0,
            f"obs: the trace's K1 launches {counts.get('dual_x_slab', 0)} "
            f"are not the counters' {window['dual_x_slab']} (lost {lost})")
    second = window["ax_reduce_plan_x"] if obj._work.multi.shape[0] else 0
    require(counts.get("ax_items_x", 0) == window["ax_reduce_plan_x"] > 0
            and counts.get("sum_items_kernel", 0) == second,
            f"obs: the trace's K2 launches (the items, then the second "
            f"pass) {counts} are not the counters' {window} (lost {lost})")
    est = [e for e in run.by_type("event")
           if e.get("kind") == "compiled_memory"]
    man = run.manifest
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"obs (a) memory: manifest peak_hbm_bytes {man['peak_hbm_bytes']}, "
        f"peak_rss_bytes {man['peak_rss_bytes']}, compiled_peak_bytes "
        f"{man['compiled_peak_bytes']} (estimates {est}); "
        f"max_memory_allocated {peak}")
    require(all(e["argument_bytes"] <= man["peak_hbm_bytes"] <= peak
                for e in est) and est,
            "obs: peak_hbm_bytes outside [census argument bytes, "
            "max_memory_allocated]")
    cen = census.evaluation_census(obj)
    k = cen["kernels"]
    log(f"obs (a) census of one evaluation: {cen['bytes_per_iteration']} "
        f"bytes ({cen['bytes_per_iteration'] / HBM_BYTES_PER_S * 1e3:.4f} "
        f"ms at 3.35 TB/s), {cen['flops_per_iteration']} float32 operations "
        f"at the fixed count, {cen['collective_bytes_per_iteration']} "
        f"collective bytes; by kernel "
        f"{ {name: v['bytes'] for name, v in k.items()} }")
    for name in ("dual_x_slab", "ax_reduce_plan_x"):
        require(k[name]["bytes"] == records[name]["bytes"],
                f"obs: the census's {name} bytes {k[name]['bytes']} are not "
                f"phase 4's {records[name]['bytes']}")
    log("obs (a) the census's K1 and K2 bytes equal phase 4's")


def obs_cli(tmp):
    """Phase 12 (b): the wide cell through the CLI's main with every
    observability flag; its census in aligned_gvals names K3 and K4."""
    import contextlib
    import io
    from repro_torch.launch import report, solve
    from repro_torch.obs import load_run, validate_run
    path = os.path.join(tmp, "wide.jsonl")
    argv = WIDE_ARGS + ["--certify", "--log-jsonl", path, "--profile-dir",
                        os.path.join(tmp, "trace_wide"), "--metrics-port",
                        "0", "--max-host-rss-mb", "1"]
    stdout, stderr = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(stdout), contextlib.redirect_stderr(stderr):
        solve.main(argv)
    lines = stdout.getvalue().strip().splitlines()
    require(len(lines) == 1, f"obs (b): stdout is not one object: {lines}")
    result = json.loads(lines[0])
    run = validate_run(path)
    guard = [e for e in run.by_type("memory") if e.get("reason") == "rss_guard"]
    series = run.by_type("metrics")[-1]["series"]
    mem = sorted(s for s in series if s.startswith("repro_memory_"))
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = report.main([path])
    log(f"obs (b) wide cell through the CLI: {result['iterations_run']} "
        f"iterations, certificate valid {result.get('certificate_valid')}, "
        f"peak_rss_bytes {result.get('peak_rss_bytes')}, peak_hbm_bytes "
        f"{result.get('peak_hbm_bytes')}; rss guard {len(guard)} event(s), "
        f"{stderr.getvalue().count('exceeds --max-host-rss-mb')} warning(s); "
        f"report rc {rc} ({len(text.getvalue().splitlines())} lines); "
        f"metrics {mem}; byte_census "
        f"{run.manifest['byte_census']['bytes_per_iteration']} bytes")
    require(result.get("peak_rss_bytes") and result.get("peak_hbm_bytes"),
            "obs (b): the result lacks its peaks")
    require(len(guard) == 1 and stderr.getvalue().count(
        "exceeds --max-host-rss-mb") == 1, "obs (b): the guard did not "
            "fire exactly once")
    require(rc == 0, "obs (b): report.main failed on the CLI's log")
    require("repro_memory_host_rss_bytes" in mem
            and "repro_memory_device_peak_bytes" in mem,
            "obs (b): the metrics digest lacks the memory series")
    path_g = os.path.join(tmp, "wide_gvals.jsonl")
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        solve.main(WIDE_ARGS + ["--ax-mode", "aligned_gvals", "--iterations",
                                "25", "--log-jsonl", path_g])
    kernels = list(load_run(path_g).manifest["byte_census"]["kernels"])
    log(f"obs (b) aligned_gvals census kernels: {kernels}")
    require("dual_grad_slab" in kernels and "ax_reduce_plan" in kernels,
            "obs (b): the aligned_gvals census does not name K3 and K4")


def obs_failing(args, out, tmp):
    """Phase 12 (c): a NaN objective (phase 8's) with a profiler window
    open stops DIVERGED and still leaves its trace."""
    import torch
    from repro_torch.core import HealthConfig, Maximizer, StopReason
    from repro_torch.launch import solve
    from repro_torch.obs import ProfilerHook
    from repro_torch.testing import NaNInjectingObjective
    cfg, crit = solve.solve_config(args)
    health = HealthConfig(max_retries=3)
    # the window opens at the last retry's chunk and is still open when
    # the solve gives up: the engine's finally block writes the trace
    prof = ProfilerHook(os.path.join(tmp, "trace_nan"),
                        start_chunk=health.max_retries, num_chunks=2)
    res = Maximizer(cfg).maximize(NaNInjectingObjective(out.objective),
                                  criteria=crit, health=health,
                                  profiler=prof)
    size = (os.path.getsize(prof.trace_paths[0]) if prof.trace_paths
            else 0)
    log(f"obs (c) NaN objective under a profiler window: "
        f"{res.stop_reason.value} after {len(res.health)} health records; "
        f"trace {prof.trace_paths} ({size} bytes)")
    require(res.stop_reason == StopReason.DIVERGED and size > 0
            and len(res.health) == health.max_retries + 1
            and bool(torch.isfinite(res.lam).all()),
            "obs (c): the failing run left no trace or did not diverge")


def obs_phase(args, out, records):
    """Phase 12: (a), (b), (c) in a temporary directory."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="obs_") as tmp:
        obs_main(args, out, records, tmp)
        obs_cli(tmp)
        obs_failing(args, out, tmp)


# phase 13: the port's solver examples, each in a process of its own as a
# user runs it, at the reference example's default sizes: (module, extra
# flags, the kernels its path must launch).  quickstart, moe_lp_routing and
# chaos_smoke's in-process guard build the reference's default objective
# (scatter: K3 and a PyTorch sum); the others run aligned (K1 + K2).
# allocation_server's tour also runs at --quick, the reference's own CI
# size, because at its default size its solve may end at the cap (below)
EXAMPLE_RUNS = (
    ("quickstart", [], ("dual_grad_slab",)),
    ("moe_lp_routing", [], ("dual_grad_slab",)),
    ("formulations_tour", [], ("dual_x_slab", "ax_reduce_plan_x")),
    ("matching_scale", [], ("dual_x_slab", "ax_reduce_plan_x")),
    ("chaos_smoke", [], ("dual_grad_slab",)),
    ("allocation_server", [], ("dual_x_slab", "ax_reduce_plan_x")),
    ("allocation_server", ["--quick"], ("dual_x_slab", "ax_reduce_plan_x")),
    ("allocation_server", ["--load-test", "--metrics-port", "0"],
     ("dual_x_slab", "ax_reduce_plan_x")),
)
EXAMPLE_TIMEOUT_S = 600
# allocation_server's multi_budget solve at its default size (agd at
# max_step 20, tol_rel_dual 1e-6) is chaotic in float32, and whether a
# check dips under 1e-6 before the 4,000-iteration cap is chance: on the
# tour's 5,000 x 200 instance the reference's plain sweep stops at 1,850,
# its own kernel path (the Pallas kernels, interpret mode) runs to the cap
# unconverged at a last relative change of 3.18e-6, and over seeds 1-5 the
# reference's plain sweep stops later than the port as often as earlier
# (tests/torch_stop_spread.py; ROADMAP queue C).  Such a run may end as the
# reference's kernel path ends: its JSON record at the cap, then "FAIL:
# solve did not converge".  That is recorded as a fault of the example's
# configuration, not passed over: the record must show the cap reached on
# the card, K1 and K2 launched, a finite dual and a last relative change
# under CAP_CREEP (still creeping, as the reference's, not diverging)
CAP_RUNS = {("allocation_server", ())}
CAP_CREEP = 1e-5
# quickstart's reference result (examples/quickstart.py, JAX on the CPU):
# its stop and final dual, held at one check and 1e-4 relative
QUICKSTART_REF = {"iterations_run": 400, "dual_final": -3737.0908}
QUICKSTART_CHECK = 50
QUICKSTART_RTOL = 1e-4


def example_criterion(name, r):
    """Each example's own pass criterion, read from its JSON result."""
    if name == "quickstart":
        stop = abs(r["iterations_run"] - QUICKSTART_REF["iterations_run"])
        dual = (abs(r["dual_final"] - QUICKSTART_REF["dual_final"])
                / abs(QUICKSTART_REF["dual_final"]))
        return (r["converged"] and r["simplex_ok"]
                and stop <= QUICKSTART_CHECK and dual <= QUICKSTART_RTOL,
                f"converged, simplex; stop {r['iterations_run']} within "
                f"{QUICKSTART_CHECK} of the reference's "
                f"{QUICKSTART_REF['iterations_run']}, dual rel err "
                f"{dual:.3e} <= {QUICKSTART_RTOL}")
    if name == "moe_lp_routing":
        return (r["balanced"] and r["lp_imbalance"] < r["greedy_imbalance"],
                "LP routing balanced better than greedy")
    if name == "formulations_tour":
        return (not r["not_converged"] and r["tightened_bind"],
                "every formulation converged, the tightened rows bind")
    if name == "matching_scale":
        return (r["distributed_rel_err"] < 1e-2,
                "distributed against single < 1e-2")
    if name == "chaos_smoke":
        return (r["dual_drift"] <= 1e-7 and r["health"]
                and r["health"][0][1] == "rollback",
                "drift <= 1e-7, a rollback record")
    if not r["converged"]:
        return (r["iterations_run"] == r["iterations_cap"]
                and r["stop_reason"] == "max_iterations"
                and math.isfinite(r["dual_final"])
                and r["rel_dual_last"] < CAP_CREEP,
                f"FAULT (recorded, ROADMAP queue C): the solve ran to its "
                f"cap of {r['iterations_cap']} unconverged, as the "
                f"reference's kernel path does; last relative change "
                f"{r['rel_dual_last']:.3e} < {CAP_CREEP}")
    if r["mode"] == "tour":
        return (r["certificate_valid"] and r["bitwise"]
                and r["warm_converged"] and r["warm_certificate_valid"],
                "VALID, bitwise, warm re-solve converged and VALID")
    return (r["errors"] == 0 and r["ok"] > 0
            and r["classified"] == r["submitted"]
            and r["refresh_status"] == "accepted",
            "0 ERROR, every request classified, refresh accepted")


def run_example(name, extra, module=None, env_extra=None):
    """`python -m repro_torch.examples.<name> --json extra` (or `-m module`)
    in a process group of its own (its children too), killed with them past
    the timeout, with `env_extra` added to its environment.  Exit 0 is
    required, except for a run of `CAP_RUNS` whose solve ended at its cap
    (its record on the line before the FAIL line).  Returns (its JSON
    result, seconds, its other output lines)."""
    import signal
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               **(env_extra or {}))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", module or f"repro_torch.examples.{name}",
         "--json", *extra], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=ROOT, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        require(False, f"examples: {name} {extra} ran past "
                f"{EXAMPLE_TIMEOUT_S} s:\n{out[-4000:]}")
    seconds = time.perf_counter() - t0
    lines = out.strip().splitlines()
    at_cap = (proc.returncode == 1 and (name, tuple(extra)) in CAP_RUNS
              and len(lines) >= 2
              and lines[-1] == "FAIL: solve did not converge"
              and lines[-2].startswith("{"))
    if at_cap:
        return json.loads(lines[-2]), seconds, lines[:-2] + lines[-1:]
    require(proc.returncode == 0 and lines,
            f"examples: {name} {extra} exited {proc.returncode}:\n"
            f"{out[-4000:]}")
    return json.loads(lines[-1]), seconds, lines[:-1]


# each example's instance, as its InstanceSpec's fields
EXAMPLE_SPECS = {
    "quickstart": dict(num_sources=2000, num_destinations=100,
                       avg_nnz_per_row=25, seed=0),
    "formulations_tour": dict(num_sources=5000, num_destinations=200,
                              avg_nnz_per_row=12, seed=7, num_families=2),
    "matching_scale": dict(num_sources=100_000, num_destinations=2000,
                           avg_nnz_per_row=100, seed=42),
    "chaos_smoke": dict(num_sources=2000, num_destinations=50,
                        avg_nnz_per_row=8, seed=11),
    "allocation_server": dict(num_sources=5000, num_destinations=200,
                              avg_nnz_per_row=10, seed=11, num_families=2),
}


def example_host_instances():
    """`EXAMPLE_SPECS` generated on the host (numpy), by example."""
    from repro_torch.core import InstanceSpec, generate
    return {name: generate(InstanceSpec(**spec))
            for name, spec in EXAMPLE_SPECS.items()}


def example_instances(hosts):
    """Each example's objective as the example builds it, on the card, from
    its host instance, with a dual from a 100-iteration solve of its own
    SolveConfig: [(what, obj, lam, gamma)]."""
    from repro_torch import formulations
    from repro_torch.convert import lp_to_torch
    from repro_torch.core import (MatchingObjective, Maximizer, SolveConfig,
                                  precondition)
    from repro_torch.examples import moe_lp_routing

    def lp(name, normalized=True):
        t = lp_to_torch(hosts[name], DEVICE)
        return precondition(t, row_norm=True)[0] if normalized else t

    tour_cfg = dict(gamma=0.05, gamma_init=0.8, gamma_decay_every=25,
                    max_step=20.0, initial_step=1e-3)
    objs = [
        ("quickstart", MatchingObjective(
            lp("quickstart"), proj_kind="boxcut", ax_mode="scatter"),
         tour_cfg),
        ("moe_lp_routing", MatchingObjective(
            moe_lp_routing.routing_lp(moe_lp_routing.make_affinity(0),
                                      moe_lp_routing.TOPK, DEVICE),
            proj_kind="boxcut", ax_mode="scatter"),
         dict(tour_cfg, gamma_init=0.4)),
        ("formulations_tour (multi_budget)", formulations.make_objective(
            "multi_budget", lp("formulations_tour", False),
            ax_mode="aligned", row_norm=True), tour_cfg),
        ("matching_scale", MatchingObjective(
            lp("matching_scale"), ax_mode="aligned"),
         dict(gamma=0.01, gamma_init=0.16, gamma_decay_every=25,
              max_step=1e-1, initial_step=1e-5)),
        ("chaos_smoke (guard)", MatchingObjective(
            lp("chaos_smoke"), ax_mode="scatter"),
         dict(gamma=0.01, max_step=1e-1, initial_step=1e-5)),
        ("allocation_server", formulations.make_objective(
            "multi_budget", lp("allocation_server", False),
            ax_mode="aligned", row_norm=True), tour_cfg),
    ]
    out = []
    for what, obj, cfg in objs:
        res = Maximizer(SolveConfig(iterations=100, **cfg)).maximize(obj)
        out.append((what, obj, res.lam, cfg["gamma"]))
    return out


def hold_example_kernels(what, obj, lam_flat, gamma):
    """The kernels of an example's path on its own objective against their
    plain versions: K3 (scatter) or K1 (aligned) on every slab at the
    dual's destination block, and, aligned, K2 over the whole plan fed the
    objective's x buffer after one evaluation.  Returns the log line."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ax_reduce import ax_reduce_plan_x
    m, J = obj.lp.m, obj.lp.num_destinations
    lam = lam_flat.reshape(-1)[:m * J].reshape(m, J).contiguous()
    g = torch.full((), gamma, dtype=torch.float32, device=lam.device)
    scatter = obj.ax_mode == "scatter"
    err_x, err_s = slab_errors(obj.lp.slabs, lam, g, obj.proj_iters,
                               gvals=scatter)
    k = "dual_grad_slab" if scatter else "dual_x_slab"
    widths = sorted({s.width for s in obj.lp.slabs})
    require(err_x <= 1e-4, f"examples {what}: {k} max |dx| {err_x} > 1e-4")
    require(err_s <= 1e-5, f"examples {what}: {k} scalars {err_s} > 1e-5")
    line = (f"examples {what}: {k} on its {len(obj.lp.slabs)} slabs "
            f"(widths {widths[0]}..{widths[-1]}, m {m}, J {J}) against the "
            f"plain version: max|dx| {err_x:.3e} (atol 1e-4), scalars rel "
            f"{err_s:.3e} (rtol 1e-5)")
    if not scatter:
        obj.calculate(lam_flat, g)
        plan, xbuf = obj._plan, obj._xbuf
        got = ax_reduce_plan_x(xbuf, plan, torch.full(
            (m, J), float("nan"), device=lam.device), obj._work)
        want = ref.ax_plan_x_ref(plan, xbuf)
        rel = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
        require(rel <= 1e-5, f"examples {what}: ax_reduce_plan_x rel err "
                f"{rel} > 1e-5")
        line += (f"; ax_reduce_plan_x over its {len(plan.buckets)} buckets: "
                 f"rel err {rel:.3e} (rtol 1e-5 of max(1, |ax|))")
    return line


def examples_phase():
    """Phase 13: every example of `EXAMPLE_RUNS`; each must exit 0 (or end
    at its cap as `CAP_RUNS` allows), meet its criterion and show launches
    of its path's kernels; then each example's kernels held against their
    plain versions on its own objective, in this process."""
    import torch
    from concurrent.futures import ThreadPoolExecutor
    # the host instances are generated while the examples run
    pool = ThreadPoolExecutor(1)
    hosts = pool.submit(example_host_instances)
    for name, extra, expect in EXAMPLE_RUNS:
        result, seconds, lines = run_example(name, extra)
        run = " ".join([name] + extra)
        for line in lines:
            log(f"  | {line}")
        ok, what = example_criterion(name, result)
        launches = result.get("launches", {})
        numbers = {k: v for k, v in result.items()
                   if k not in ("launches", "dual_trajectory",
                                "distributed_trajectory", "formulations",
                                "greedy_load", "lp_load")}
        log(f"examples {run}: {seconds:.1f} s; {json.dumps(numbers)}; "
            f"launches {launches}; criterion ({what}): {bool(ok)}")
        if name == "formulations_tour":
            for form, row in result["formulations"].items():
                log(f"examples {run} {form}: {row['iterations_run']} "
                    f"iterations in {row['seconds']:.2f} s "
                    f"({row['stop_reason']}), dual {row['dual_final']!r}")
        require(ok, f"examples: {run} missed its criterion ({what})")
        require(result.get("device", "").startswith("cuda"),
                f"examples: {run} did not run on the card")
        require(all(launches.get(k, 0) > 0 for k in expect),
                f"examples: {run}: a kernel of its path never ran "
                f"({expect}): {launches}")
    t0 = time.perf_counter()
    hosts = hosts.result()
    pool.shutdown()
    for what, obj, lam, gamma in example_instances(hosts):
        log(hold_example_kernels(what, obj, lam, gamma))
        del obj, lam
    del hosts
    torch.cuda.empty_cache()
    log(f"examples: kernels on the examples' objectives "
        f"{time.perf_counter() - t0:.1f} s")


# phase 14: the dense decoder's serving path at full width
LM_ARCH = "qwen3-1.7b"
LM_PARAMS = 1_720_837_120
LM_DECODE_T = 8
LM_BATCHES = (4, 32)
LM_MAX_SEQ = 64
LM_TIMED_STEPS = 32
LM_CPU_RTOL = 1e-4      # reduced float32, the card against the CPU


def _decode_after_prefill(model, params, toks):
    """(prefill logits, logits after decoding toks one at a time), both
    float32."""
    import torch
    B, T = toks.shape
    caches = model.zero_caches(B, T, toks.device)
    with torch.inference_mode():
        ref = model.prefill(params, {"tokens": toks}).float()
        for t in range(T):
            logits, caches = model.decode_step(params, caches,
                                               toks[:, t:t + 1], t)
    return ref, logits.float()


def decode_rates(model, params, gen, batches=LM_BATCHES):
    """Decode ms a step (CUDA events, mean of `LM_TIMED_STEPS` after 3
    warm-up steps) at positions 3.. of an `LM_MAX_SEQ` cache, tokens/s and
    host enqueue ms a step, at each batch; with the bytes of the caches."""
    import torch
    from repro_torch.models.layers import tree_tensors
    rates = {}
    for B in batches:
        caches = model.zero_caches(B, LM_MAX_SEQ, DEVICE)
        tok = torch.randint(0, model.cfg.vocab, (B, 1),
                            generator=gen).to(DEVICE)
        with torch.inference_mode():
            for t in range(3):
                model.decode_step(params, caches, tok, t)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            for t in range(LM_TIMED_STEPS):
                model.decode_step(params, caches, tok, 3 + t)
            end.record()
            t_enq = time.perf_counter() - t0
            end.synchronize()
        ms = start.elapsed_time(end) / LM_TIMED_STEPS
        rates[B] = {"decode_ms_per_step": ms,
                    "tokens_per_s": B / ms * 1e3,
                    "host_enqueue_ms_per_step":
                        t_enq / LM_TIMED_STEPS * 1e3,
                    "cache_bytes": sum(t.numel() * t.element_size()
                                       for t in tree_tensors(caches))}
        del caches
    return rates


def lm_phase():
    """Phase 14: qwen3-1.7b at full width in bfloat16 on the card, drawn
    from a seeded generator: its parameter count, serve_lm's five requests
    (greedy, batch-composition invariant), decode after T steps against
    prefill, the reduced config's float32 logits against the CPU's, and
    decode ms a step at each of `LM_BATCHES`."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.examples.serve_lm import requests
    from repro_torch.models import build_model
    from repro_torch.serving.engine import Engine, Request
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()    # earlier phases' tensors
    cfg = get_config(LM_ARCH)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.values())
    nbytes = sum(p.numel() * p.element_size() for p in params.values())
    log(f"lm: {LM_ARCH} at full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv} KV, d_ff "
        f"{cfg.d_ff}, vocabulary {cfg.vocab} padded to {cfg.padded_vocab}"
        f"), {cfg.param_dtype}: {n} parameters, {nbytes} bytes, drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    require(n == LM_PARAMS, f"lm: {n} parameters, want {LM_PARAMS}")

    # (a) serve_lm's five requests at batch 4, max_seq 64, greedy
    eng = Engine(model, params, batch=4, max_seq=LM_MAX_SEQ)
    t0 = time.perf_counter()
    done = eng.generate(requests())
    dt = time.perf_counter() - t0
    steps, step_s = eng.steps, eng.step_seconds
    total = sum(len(r.out) for r in done)
    alone = eng.generate([Request(prompt=list(done[0].prompt),
                                  max_new=done[0].max_new)])
    log(f"lm (a) serve_lm's requests at batch 4: {total} tokens in "
        f"{dt:.3f} s ({total / dt:.1f} tokens/s, {steps} steps, "
        f"{step_s / steps * 1e3:.3f} ms a step with its host read); "
        f"outputs {[r.out for r in done]}; request 0 alone "
        f"{alone[0].out == done[0].out}")
    require([len(r.out) for r in done] == [r.max_new for r in requests()],
            "lm (a): a request got the wrong number of tokens")
    require(alone[0].out == done[0].out,
            "lm (a): batch composition changed request 0's tokens")
    del eng

    # (b) decode after T steps against prefill, bfloat16
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, LM_DECODE_T),
                         generator=gen).to(DEVICE)
    ref, logits = _decode_after_prefill(model, params, toks)
    diff = float((logits - ref).abs().max())
    close = bool(torch.allclose(logits, ref, atol=2e-2, rtol=1e-2))
    log(f"lm (b) decode after {LM_DECODE_T} steps against prefill "
        f"(bfloat16, batch 2): max |diff| {diff:.6f} over logits up to "
        f"{float(ref.abs().max()):.3f}; within atol 2e-2 / rtol 1e-2: "
        f"{close}")
    require(close, "lm (b): decode after T steps is not prefill's, at "
            "atol 2e-2 / rtol 1e-2")

    # (c) reduced, float32: the card's logits against the CPU's
    small = cfg.reduced()
    m_cpu, m_gpu = build_model(small), build_model(small)
    p_cpu = m_cpu.init(torch.Generator().manual_seed(0))
    p_gpu = m_gpu.load_params({k: v.to(DEVICE) for k, v in p_cpu.items()})
    toks_s = torch.randint(0, small.vocab, (2, LM_DECODE_T), generator=gen)
    rel = []
    for (a, b) in zip(_decode_after_prefill(m_gpu, p_gpu, toks_s.to(DEVICE)),
                      _decode_after_prefill(m_cpu, p_cpu, toks_s)):
        rel.append(float((a.cpu() - b).abs().max() / b.abs().max()))
    log(f"lm (c) reduced {LM_ARCH} in float32, the card against the CPU: "
        f"prefill max |diff| / max |logit| {rel[0]:.3e}, after "
        f"{LM_DECODE_T} decode steps {rel[1]:.3e} (held at "
        f"{LM_CPU_RTOL})")
    require(max(rel) <= LM_CPU_RTOL,
            f"lm (c): the card's float32 logits leave the CPU's: {rel}")

    # (d) decode ms a step (CUDA events) at each batch
    rates = decode_rates(model, params, gen)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    for B, r in rates.items():
        log(f"lm (d) decode at batch {B}, positions 3-{2 + LM_TIMED_STEPS} "
            f"of {LM_MAX_SEQ}: {r['decode_ms_per_step']:.4f} ms a step "
            f"(CUDA events, mean of {LM_TIMED_STEPS}), "
            f"{r['tokens_per_s']:.1f} tokens/s, host enqueue "
            f"{r['host_enqueue_ms_per_step']:.4f} ms a step; bound "
            f"{bound_ms:.4f} ms (bytes: every weight read once a step)")
    log(f"lm: peak HBM allocated by this phase {peak} bytes "
        f"(torch.cuda.max_memory_allocated less the {base} bytes earlier "
        f"phases held at its start)")
    del model, params
    torch.cuda.empty_cache()
    return rates


# phase 15: every other family at its published width where one card holds
# it (llama4-scout's 48 layers at 109 B params do not: its full width at 2
# layers), jamba's 398 B reduced only
FAMILY_FULL = ("granite-moe-1b-a400m", "mamba2-780m", "seamless-m4t-medium",
               "pixtral-12b", "llama4-scout-17b-a16e")
FAMILY_LAYERS = {"llama4-scout-17b-a16e": 2}
FAMILY_REDUCED = ("granite-moe-1b-a400m", "llama4-scout-17b-a16e",
                  "mamba2-780m", "jamba-1.5-large-398b",
                  "seamless-m4t-medium", "pixtral-12b")
# decode after T steps against prefill in float32 at full width (MoE with
# the capacity factor raised to E, so that no token is dropped)
FAMILY_DECODE_VS_PREFILL = ("granite-moe-1b-a400m", "mamba2-780m")
FAMILY_FRAMES = 64          # seamless's frame stand-ins at prefill
FAMILY_SRC_LEN = 16         # enc-dec cross caches in the card-vs-CPU check
# the reduced configs' float32 logits, the card against the CPU, as a
# fraction of the largest: 1e-4, as the CPU tests hold seamless's against
# the reference (its sharp encoder softmax, tests/test_torch_lm_encdec.py)
FAMILY_CPU_RTOL = 1e-4
# phase 16: training
TRAIN_FULL = (("granite-moe-1b-a400m", 5), ("mamba2-780m", 5))
# the launcher's peak lr for the full-width runs: its default 3e-3 (sized
# for reduced()) exceeds the embedding's init scale (std 0.0026 at
# qwen3's vocabulary) and raised qwen3's loss 11.94 -> 12.02 in 10 steps;
# at 1e-3 qwen3, granite and mamba2 fell, at 3e-4 and 1e-4 barely moved
# (one H100, bfloat16 params, float32 AdamW state)
TRAIN_LR = "1e-3"
TRAIN_REDUCED = ("qwen3-1.7b",) + FAMILY_REDUCED
# each gradient, the card against the CPU, at this fraction of its largest
# entry: the card sums in other orders, and float32 order alone moves the
# reduced models' gradients by up to 3.3e-4 (the port against the
# reference on a CPU, tests/torch_lm_floor.py: jamba 3.3e-4, granite
# 2.4e-4; llama4 3.2e-4 card against CPU).  Reduced seamless's stacked
# init (fan-in 2) gives attention scores of std ~60 and near one-hot
# softmaxes, through which a score's rounding moves the attention
# weights' gradients: the reference sits up to 3.4e-3 from float64 on the
# CPU, the card 1.2e-2 from the CPU (dec/self/wk; its loss 1.4e-6).  A MoE
# router's top-k is discrete: a token whose top two experts' probabilities
# tie to float32 rounding goes to another expert in the other order, and
# moves that expert's gradient by its share (jamba's blk7/moe/wg: 1.3e-3,
# its loss 3.0e-7)
TRAIN_GRAD_RTOL = {"seamless-m4t-medium": 5e-2}
TRAIN_GRAD_DEFAULT = 1e-3
TRAIN_GRAD_MOE = 1e-2


def family_inputs(cfg, B, T, gen, frames=FAMILY_FRAMES):
    """Seeded tokens (B, T) and the config's frontend stand-ins: frames for
    an enc-dec, its `n_frontend_tokens` patches for a VLM."""
    import torch
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, T), generator=gen)}
    if cfg.frontend == "frames":
        batch["frames"] = torch.randn(B, frames, cfg.d_model, generator=gen)
    elif cfg.frontend == "patches":
        batch["patches"] = torch.randn(B, cfg.n_frontend_tokens or 16,
                                       cfg.d_model, generator=gen)
    return batch


def family_logits(model, params, batch, src_len=4096):
    """(prefill logits with the batch's frontend stand-ins, logits after
    decoding its tokens one at a time from zero caches), float32."""
    import torch
    toks = batch["tokens"]
    B, T = toks.shape
    caches = model.zero_caches(B, T, toks.device, src_len=src_len)
    with torch.inference_mode():
        pre = model.prefill(params, batch).float()
        for t in range(T):
            logits, caches = model.decode_step(params, caches,
                                               toks[:, t:t + 1], t)
    return pre, logits.float()


def _draw(cfg, moe_impl="einsum"):
    """A model of cfg with its params drawn on the card from seed 0, and
    the params' count and bytes."""
    import torch
    from repro_torch.models import build_model
    model = build_model(cfg, moe_impl=moe_impl)
    params = model.init(torch.Generator(DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    return (model, params, sum(p.numel() for p in params.values()),
            sum(p.numel() * p.element_size() for p in params.values()))


def _expert_bytes(params):
    return sum(p.numel() * p.element_size() for k, p in params.items()
               if "/moe/w" in k)


def family_full(arch, gen):
    """Phase 15 (a), (b), (d) for one config at its published width."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.examples.serve_lm import requests
    from repro_torch.models import build_model
    from repro_torch.serving.engine import Engine, Request
    t_arch = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cfg = get_config(arch)
    if arch in FAMILY_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=FAMILY_LAYERS[arch])
    model, params, n, nbytes = _draw(cfg)
    log(f"families: {arch} ({cfg.family}) at full width, {cfg.n_layers} of "
        f"{get_config(arch).n_layers} layers, d_model {cfg.d_model}, "
        f"vocabulary {cfg.vocab}, {cfg.n_experts} experts top-{cfg.top_k}"
        f", ssm state {cfg.ssm_state}, {cfg.n_enc_layers} encoder layers, "
        f"frontend {cfg.frontend}: {n} parameters, {nbytes} bytes "
        f"({cfg.param_dtype})")

    # (a) serve_lm's five requests at batch 4, max_seq 64, greedy
    rec = {"arch": arch, "params": n, "param_bytes": nbytes,
           "layers": cfg.n_layers}
    impls = ("einsum", "gather") if cfg.n_experts else ("einsum",)
    for impl in impls:
        m = model if impl == "einsum" else build_model(cfg, moe_impl=impl)
        if m is not model:
            m.load_params(params)
        eng = Engine(m, params, batch=4, max_seq=LM_MAX_SEQ)
        t0 = time.perf_counter()
        done = eng.generate(requests())
        dt = time.perf_counter() - t0
        total = sum(len(r.out) for r in done)
        alone = eng.generate([Request(prompt=list(done[0].prompt),
                                      max_new=done[0].max_new)])
        same = alone[0].out == done[0].out
        rec[f"serve_{impl}"] = [r.out for r in done]
        log(f"families (a) {arch} [{impl}] serve_lm's requests at batch 4:"
            f" {total} tokens in {dt:.3f} s ({total / dt:.1f} tokens/s, "
            f"{eng.steps} steps, {eng.step_seconds / eng.steps * 1e3:.3f} ms"
            f" a step with its host read); outputs {[r.out for r in done]};"
            f" request 0 alone the same: {same}")
        require([len(r.out) for r in done]
                == [r.max_new for r in requests()],
                f"families (a) {arch}: a request got the wrong number of "
                f"tokens")
        require(all(0 <= t < cfg.padded_vocab for r in done for t in r.out),
                f"families (a) {arch}: a token outside the vocabulary")
        if not cfg.n_experts:   # capacity drops make MoE depend on mates
            require(same, f"families (a) {arch}: batch composition changed "
                    f"request 0's tokens")
        del eng
    if cfg.n_experts:
        log(f"families (a) {arch}: einsum's and gather's tokens equal: "
            f"{rec['serve_einsum'] == rec['serve_gather']}")

    # (b) decode after T steps against prefill; frontend stand-ins
    batch = {k: v.to(DEVICE) for k, v in family_inputs(
        cfg, 2, LM_DECODE_T, gen).items()}
    if arch in FAMILY_DECODE_VS_PREFILL:
        only = {"tokens": batch["tokens"]}
        raise_cf = ({"moe_capacity_factor": float(cfg.n_experts)}
                    if cfg.n_experts else {})
        m16 = build_model(dataclasses.replace(cfg, **raise_cf))
        ref16, dec16 = family_logits(m16, m16.load_params(params), only)
        diff16 = float((dec16 - ref16).abs().max())
        del m16
        cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                    compute_dtype="float32", **raise_cf)
        m32 = build_model(cfg32)
        p32 = m32.load_params({k: v.float() for k, v in params.items()})
        ref, dec = family_logits(m32, p32, only)
        diff = float((dec - ref).abs().max())
        close = bool(torch.allclose(dec, ref, atol=2e-2, rtol=1e-2))
        cf = raise_cf.get("moe_capacity_factor", "-")
        log(f"families (b) {arch} decode after {LM_DECODE_T} steps against "
            f"prefill (batch 2, capacity factor {cf}): float32 max |diff| "
            f"{diff:.6f} over logits up to "
            f"{float(ref.abs().max()):.3f}, within atol 2e-2 / rtol 1e-2: "
            f"{close}; bfloat16 max |diff| {diff16:.6f}")
        require(close, f"families (b) {arch}: decode after T steps is not "
                f"prefill's at atol 2e-2 / rtol 1e-2 (float32)")
        rec["decode_vs_prefill_f32"], rec["decode_vs_prefill_bf16"] = \
            diff, diff16
        del m32, p32, ref, dec
        torch.cuda.empty_cache()
    if cfg.frontend:
        key = "frames" if cfg.frontend == "frames" else "patches"
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = model.prefill(params, batch).float()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            plain = (model.prefill(params, {"tokens": batch["tokens"],
                                            "frames": batch["frames"] * 0})
                     if key == "frames" else
                     model.prefill(params, {"tokens": batch["tokens"]}))
        moved = float((got - plain.float()).abs().max())
        log(f"families (b) {arch} prefill with {batch[key].shape[1]} "
            f"{key} (batch 2, {LM_DECODE_T} tokens): logits "
            f"{tuple(got.shape)}, finite {bool(got.isfinite().all())}, up "
            f"to {float(got.abs().max()):.3f}, in {dt * 1e3:.1f} ms; "
            f"without the {key} they move by up to {moved:.3f}")
        require(bool(got.isfinite().all()) and tuple(got.shape)
                == (2, cfg.padded_vocab) and moved > 0,
                f"families (b) {arch}: prefill with {key} failed")

    # (d) decode ms a step at batch 4 and 32, beside the bytes bound
    rates = decode_rates(model, params, gen)
    expert = _expert_bytes(params)
    peak = torch.cuda.max_memory_allocated() - base
    for B, r in rates.items():
        w_ms = nbytes / HBM_BYTES_PER_S * 1e3
        c_ms = (nbytes + r["cache_bytes"]) / HBM_BYTES_PER_S * 1e3
        a_ms = ((nbytes - expert + expert * cfg.top_k / max(cfg.n_experts, 1))
                / HBM_BYTES_PER_S * 1e3)
        active = ("" if not expert else
                  f", {a_ms:.4f} ms with only top-{cfg.top_k} of "
                  f"{cfg.n_experts} experts read")
        log(f"families (d) {arch} decode at batch {B}: "
            f"{r['decode_ms_per_step']:.4f} ms a step (CUDA events, mean of "
            f"{LM_TIMED_STEPS}), {r['tokens_per_s']:.1f} tokens/s, host "
            f"enqueue {r['host_enqueue_ms_per_step']:.4f} ms a step; bound "
            f"{w_ms:.4f} ms (bytes: every weight read once a step), "
            f"{c_ms:.4f} ms with the caches' {r['cache_bytes']} bytes read "
            f"too{active}")
        r.update(weights_bound_ms=w_ms, caches_bound_ms=c_ms)
    rec["decode"] = rates
    rec["peak_hbm_bytes"] = peak
    log(f"families: {arch} peak HBM allocated {peak} bytes (less the "
        f"{base} earlier phases held); {time.perf_counter() - t_arch:.1f} s")
    del model, params
    torch.cuda.empty_cache()
    return rec


def families_reduced(gen):
    """Phase 15 (c): every non-dense reduced config in float32, prefill and
    decode on the card against the CPU on the same weights.  Jamba's one
    period at d_model 8,192 holds four 16-expert MoE layers of ~9.7 B
    params each, more than the card: it runs reduced only."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    out = {}
    for arch in FAMILY_REDUCED:
        cfg = get_config(arch).reduced()
        m_cpu, m_gpu = build_model(cfg), build_model(cfg)
        p_cpu = m_cpu.init(torch.Generator().manual_seed(0))
        p_gpu = m_gpu.load_params({k: v.to(DEVICE) for k, v in p_cpu.items()})
        batch = family_inputs(cfg, 2, LM_DECODE_T, gen, frames=16)
        rel = []
        for a, b in zip(
                family_logits(m_gpu, p_gpu, {k: v.to(DEVICE) for k, v in
                                             batch.items()}, FAMILY_SRC_LEN),
                family_logits(m_cpu, p_cpu, batch, FAMILY_SRC_LEN)):
            rel.append(float((a.cpu() - b).abs().max() / b.abs().max()))
        out[arch] = rel
        log(f"families (c) reduced {arch} in float32, the card against the "
            f"CPU: prefill max |diff| / max |logit| {rel[0]:.3e}, after "
            f"{LM_DECODE_T} decode steps {rel[1]:.3e} (held at "
            f"{FAMILY_CPU_RTOL})")
        require(max(rel) <= FAMILY_CPU_RTOL,
                f"families (c) {arch}: the card's float32 logits leave the "
                f"CPU's: {rel}")
    return out


def families_phase():
    """Phase 15: the MoE, mamba2, hybrid, encoder-decoder and VLM families
    served on the card (see the module docstring)."""
    import torch
    gen = torch.Generator().manual_seed(15)
    recs = [family_full(arch, gen) for arch in FAMILY_FULL]
    families_reduced(gen)
    return recs


def train_reduced_grads():
    """Phase 16 (c): the reduced configs' loss and every gradient in
    float32, the card against the CPU on the same weights and batch."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import stream_for
    from repro_torch.models import build_model
    from repro_torch.training.trainer import value_and_grad
    for arch in TRAIN_REDUCED:
        cfg = get_config(arch).reduced()
        model = build_model(cfg)
        p_cpu = model.init(torch.Generator().manual_seed(0))
        batch = {k: torch.from_numpy(v)
                 for k, v in stream_for(cfg, 4, 32).next().items()}
        l_cpu, g_cpu = value_and_grad(model.loss, p_cpu, batch)
        l_gpu, g_gpu = value_and_grad(
            model.loss, {k: v.to(DEVICE) for k, v in p_cpu.items()},
            {k: v.to(DEVICE) for k, v in batch.items()})
        loss_rel = abs(float(l_gpu) - float(l_cpu)) / abs(float(l_cpu))
        worst, leaf = max((float((g_gpu[k].cpu() - g).abs().max()
                                 / g.abs().max().clamp(min=1e-30)), k)
                          for k, g in g_cpu.items())
        tol = TRAIN_GRAD_RTOL.get(arch, TRAIN_GRAD_MOE if cfg.n_experts
                                  else TRAIN_GRAD_DEFAULT)
        log(f"train (c) reduced {arch} in float32, the card against the "
            f"CPU: loss {float(l_gpu):.6f} vs {float(l_cpu):.6f} (relative "
            f"{loss_rel:.3e}, held at 1e-5), worst gradient {leaf} at "
            f"{worst:.3e} of its largest entry (held at {tol})")
        require(loss_rel <= 1e-5 and worst <= tol,
                f"train (c) {arch}: the card's loss or gradients leave the "
                f"CPU's")


def train_guard_and_resume():
    """Phase 16 (d): on the card, a poisoned batch (NaN patch stand-ins,
    reduced pixtral) is skipped with the params and optimizer state bit for
    bit; a reduced qwen3 run checkpointed at step 2 and resumed ends on the
    uninterrupted run's params, held at 1e-6 relative (the embedding's
    backward accumulates with float32 atomics, whose order does not
    repeat), and whether they came out bit for bit is printed."""
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import stream_for
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.training.trainer import Trainer, make_train_step
    cfg = get_config("pixtral-12b").reduced()
    model = build_model(cfg)
    opt = AdamW(state_dtype="float32")
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(model, opt, stream_for(cfg, 4, 32), ckpt_dir=d,
                     device=DEVICE)
        state = tr.run(1, resume=False)
    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in stream_for(cfg, 4, 32).next().items()}
    batch["patches"][0, 0, 0] = float("nan")
    new, m = make_train_step(model.loss, opt, lambda s: 1e-3)(state, batch)
    same = all(torch.equal(new.params[k], state.params[k])
               for k in state.params) and all(
        torch.equal(a[k], b[k]) for a, b in
        ((new.opt_state.mu, state.opt_state.mu),
         (new.opt_state.nu, state.opt_state.nu)) for k in a)
    log(f"train (d) NaN guard on the card: poisoned batch loss "
        f"{float(m.loss)}, skipped {float(m.skipped)}, params and "
        f"optimizer state bit for bit: {same}")
    require(float(m.skipped) == 1.0 and same,
            "train (d): the NaN guard let a poisoned batch through")

    cfg = get_config("qwen3-1.7b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(DEVICE).manual_seed(0))
    with tempfile.TemporaryDirectory() as d:
        def trainer(sub, every):
            return Trainer(model, opt, stream_for(cfg, 8, 128),
                           ckpt_dir=os.path.join(d, sub), ckpt_every=every,
                           lr_fn=cosine_schedule(3e-3, 2, 8), device=DEVICE)
        whole = trainer("a", 100)
        end = whole.run(4, state=whole.state_from(params), resume=False)
        first = trainer("b", 2)
        first.run(2, state=first.state_from(params), resume=False)
        second = trainer("b", 100)
        resumed = second.run(4, state=second.state_from(params))
    rel = max(float((resumed.params[k].float() - v.float()).abs().max()
                    / v.float().abs().max()) for k, v in end.params.items())
    bits = all(torch.equal(resumed.params[k], v)
               for k, v in end.params.items())
    log(f"train (d) reduced qwen3 checkpointed at step 2 and resumed to "
        f"step 4 on the card: losses {[h['loss'] for h in second.history]} "
        f"vs {[h['loss'] for h in whole.history[2:]]}; params' worst "
        f"relative difference {rel:.3e} (held at 1e-6), bit for bit: {bits}")
    require(int(resumed.step) == 4 and rel <= 1e-6,
            "train (d): the resumed run left the uninterrupted one")


def train_bound_ms(arch, n_params, tokens):
    """The least time a training step could take: 8 operations a token an
    active parameter (forward 2, backward 4, remat's second forward 2) at
    the bfloat16 peak; a MoE layer's experts count k of E.  Leaves out
    attention's S^2 terms (S = 128) and the optimizer (bytes)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    active = n_params
    if cfg.n_experts:
        moe = sum(cfg.layer_kind(i)[1] == "moe" for i in range(cfg.n_layers))
        expert = moe * 3 * cfg.n_experts * cfg.d_model * cfg.d_ff
        active = n_params - expert + expert * cfg.top_k / cfg.n_experts
    return 8 * active * tokens / BF16_OPS_PER_S * 1e3


def _train_checks(what, out, steps):
    losses = out["losses"]
    require(len(losses) == steps and out["skipped"] == 0
            and all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0],
            f"train {what}: want {steps} finite steps, none skipped, the "
            f"loss falling: {out}")


def train_phase():
    """Phase 16: training on the card (see the module docstring)."""
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        out, seconds, lines = run_example(
            "train", ["--arch", LM_ARCH, "--full-config", "--steps", "10",
                      "--lr", TRAIN_LR, "--ckpt-dir", d],
            module="repro_torch.launch.train")
        vocab = get_config(LM_ARCH).vocab
        log(f"train (a) python -m repro_torch.launch.train --arch {LM_ARCH} "
            f"--full-config --steps 10 --lr {TRAIN_LR} (batch "
            f"{out['batch']} x seq {out['seq']}, {out['param_dtype']} params, "
            f"{out['optstate_dtype']} AdamW state, remat {out['remat']}, "
            f"{out['params']} parameters): {lines[-1]}; losses "
            f"{out['losses']} from ln(vocab) = {math.log(vocab):.4f}; first "
            f"step {out['first_step_ms']:.1f} ms, then {out['step_ms']:.2f} "
            f"ms a step (median, host clock to the loss's read; bound "
            f"{train_bound_ms(LM_ARCH, out['params'], 8 * 128):.2f} ms, "
            f"operations), {out['tokens_per_s']:.1f} tokens/s, peak HBM "
            f"{out['peak_hbm_bytes']} bytes; {seconds:.1f} s as a process")
        _train_checks("(a)", out, 10)
        require(abs(out["losses"][0] - math.log(vocab)) < 1.0,
                f"train (a): the first loss is not near ln(vocab): {out}")
    for arch, steps in TRAIN_FULL:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            out = train.main(["--arch", arch, "--full-config", "--steps",
                              str(steps), "--lr", TRAIN_LR, "--ckpt-dir", d])
        log(f"train (b) {arch} at full width, {steps} steps, lr {TRAIN_LR} "
            f"(batch {out['batch']} x seq {out['seq']}, {out['param_dtype']} "
            f"params, {out['params']} parameters): losses {out['losses']}; "
            f"first step {out['first_step_ms']:.1f} ms, then "
            f"{out['step_ms']:.2f} ms a step (bound "
            f"{train_bound_ms(arch, out['params'], 8 * 128):.2f} ms, "
            f"operations), {out['tokens_per_s']:.1f} tokens/s, peak HBM "
            f"{out['peak_hbm_bytes']} bytes; {time.perf_counter() - t0:.1f} s")
        _train_checks(f"(b) {arch}", out, steps)
    torch.cuda.empty_cache()
    train_reduced_grads()
    train_guard_and_resume()
    with tempfile.TemporaryDirectory() as d:
        out, seconds, lines = run_example("train_lm", [],
                                          env_extra={"TMPDIR": d})
    log(f"train (e) python -m repro_torch.examples.train_lm --json: "
        f"{' / '.join(lines[-4:])}; {out['step_ms']:.2f} ms a step, "
        f"{out['tokens_per_s']:.1f} tokens/s; {seconds:.1f} s as a process")
    require(len(out["losses"]) == 300 and out["skipped"] == 0
            and out["last10"] < out["first10"],
            f"train (e): train_lm did not train: {out}")


def reset_counters():
    for fn in WRAPPERS.values():
        fn.launches = 0


def read_counters():
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def device_ms(fn, reps=20):
    """Mean device time in ms of one call of `fn`, its CUDA kernels'
    durations summed, from a window that torch.profiler traces for device
    activity alone; None if it records none.  Unlike `cuda_ms` it leaves
    out the host's time between launches, which decides tiny calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3
    return busy / reps if busy > 0 else None


def evaluation_timing(obj, lam, gamma, reps=10):
    """One dual evaluation at lambda, after warm-up: (synchronised ms and
    host enqueue ms, both without the profiler; device kernel ms from a
    window profiled for device activity alone, or None if it records no
    device time)."""
    import torch
    g = torch.full((), gamma, device=lam.device)
    for _ in range(3):
        obj.calculate(lam, g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        obj.calculate(lam, g)
    t_enq = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    return (t_all / reps * 1e3, t_enq / reps * 1e3,
            device_ms(lambda: obj.calculate(lam, g), reps))


def drive(args, inst, expect, what):
    """One run of the CLI's entry point on the generated instance, with
    every launch counter set to 0 just before and read just after; each
    kernel in `expect` must have launched.  Then the launches of one dual
    evaluation.  Returns (outcome, launches, launches per evaluation)."""
    import torch
    from repro_torch.launch import solve
    reset_counters()
    t0 = time.perf_counter()
    out = solve.run(args, log=lambda msg: log(f"  {msg}"), instance=inst)
    launches = read_counters()
    wall = time.perf_counter() - t0
    res = out.result
    iters = res["iterations_run"]
    log(f"{what} result: {json.dumps(res, sort_keys=True)}")
    log(f"{what}: {wall + out.generate_seconds:.1f} s end to end = generate "
        f"{out.generate_seconds:.1f} s (paid once) + set-up "
        f"{out.setup_seconds:.2f} s + solve loop {out.solve_seconds:.2f} s "
        f"({iters} iterations, "
        f"{out.solve_seconds / max(iters, 1) * 1e3:.3f} ms/iteration) + "
        f"certificate {out.certify_seconds:.2f} s; launches {launches}")
    require(all(launches[k] > 0 for k in expect),
            f"{what}: a kernel of the path never ran: {launches}")
    require(math.isfinite(res["dual_obj_final"]), f"{what}: non-finite dual")
    require(res["stop_reason"] == "converged",
            f"{what}: stop reason {res['stop_reason']}")
    lam = out.lam
    reset_counters()
    out.objective.calculate(lam, torch.full((), out.gamma, device=lam.device))
    per_eval = read_counters()
    log(f"{what}: launches of one dual evaluation: {per_eval}")
    t_eval, t_enq, busy = evaluation_timing(out.objective, lam, out.gamma)
    log(f"{what}: one dual evaluation at the final lambda {t_eval:.4f} ms "
        f"synchronised, host enqueue {t_enq:.4f} ms (no profiler); device "
        f"kernel time " + (
            "not measured (the profiler recorded none)" if busy is None else
            f"{busy:.4f} ms (torch.profiler, device activity only), idle "
            f"share {1 - busy / t_eval:.4f} of the unprofiled time"))
    return out, launches, per_eval


# phase 17: the compile-side tools (launch/op_cost.py, analysis.py,
# dryrun.py, sharding.py) on the card's own steps
TOOLS_DECODE_BATCH = 4
TOOLS_DECODE_POS = 3
TOOLS_TIMED = 10          # decode steps timed, the median held
TOOLS_TRAIN_TIMED = 5     # train steps timed, the median held
TOOLS_TRAIN_SHAPE = (8, 128)


def _median_ms(fn, reps, device):
    """Median ms of fn() over `reps` runs after one warm-up: CUDA events
    on the card, the host clock on the CPU."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        if device == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def walk_line(what, walk, measured_ms):
    """Log one walk beside its H100 roofline bound and the measured
    median; hold bound <= measured.  Returns the roofline."""
    cost = {"flops_per_device": walk["flops_per_device"],
            "bytes_per_device": walk["bytes_per_device"]}
    roof = _ANALYSIS.roofline(cost, walk["collectives"], 1)
    bound_ms = roof["bound_step_time_s"] * 1e3
    log(f"tools {what}: walker {walk['flops_per_device']:.6e} dot FLOPs, "
        f"{walk['bytes_per_device']:.6e} bytes (eager, unfused), "
        f"{walk['collective_bytes_per_device']:.0f} collective bytes; H100 "
        f"roofline t_compute {roof['t_compute_s'] * 1e3:.4f} ms, t_memory "
        f"{roof['t_memory_s'] * 1e3:.4f} ms, bound {bound_ms:.4f} ms "
        f"({roof['dominant']}); measured median {measured_ms:.4f} ms; "
        f"fallbacks {walk['fallbacks']}")
    require(bound_ms <= measured_ms,
            f"tools {what}: the roofline bound {bound_ms} ms exceeds the "
            f"measured {measured_ms} ms")
    return roof


def tools_decode(arch=LM_ARCH, device=DEVICE, backend="nccl", reduced=False):
    """Phase 17 (a) and (c): a one-rank process group (`backend`) and a
    1 x 1 DeviceMesh; the arch's params drawn on `device` and placed on it
    as DTensors by `param_pspecs` under the serving rules.  (c) one
    decode step at batch `TOOLS_DECODE_BATCH` equals the plain step's bit
    for bit; (a) the walker over that step, its H100 bound held at most
    the step's measured median, its bytes at least the weights' bytes."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import sharding
    from repro_torch.configs import get_config
    from repro_torch.launch import op_cost
    from repro_torch.launch.mesh import MeshSpec, device_mesh
    from repro_torch.models import build_model
    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0))
    nbytes = sum(p.numel() * p.element_size() for p in params.values())
    gen = torch.Generator().manual_seed(17)
    B = TOOLS_DECODE_BATCH
    toks = torch.randint(0, cfg.vocab, (B, 1), generator=gen).to(device)
    rules = sharding.SERVING_RULES
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = device_mesh(MeshSpec((1, 1), ("data", "model")), device)
        with sharding.use_mesh_rules(mesh, rules):
            specs = model.param_pspecs()
        placed = {k: distribute_tensor(
            v, mesh, sharding.placements_for(specs[k], mesh))
            for k, v in params.items()}

        def plain():
            caches = model.zero_caches(B, LM_MAX_SEQ, device)
            with torch.no_grad():
                return model.decode_step(params, caches, toks,
                                         TOOLS_DECODE_POS)[0]

        def sharded(p=placed):
            caches = model.zero_caches(B, LM_MAX_SEQ, device)
            with torch.no_grad(), sharding.use_mesh_rules(mesh, rules), \
                    implicit_replication():
                return model.decode_step(p, caches, toks,
                                         TOOLS_DECODE_POS)[0]
        want = plain()
        got = sharded()
        got = got.full_tensor() if isinstance(got, DTensor) else got
        same = torch.equal(got, want)
        log(f"tools (c) {cfg.name} decode step at batch {B}, params placed "
            f"as DTensors by param_pspecs (serving rules) on a 1 x 1 "
            f"{backend} mesh: logits bit for bit the plain step's: {same} "
            f"(max |diff| {float((got.float() - want.float()).abs().max())})")
        require(same, "tools (c): the sharded decode step differs from the "
                "plain one")
        walk = op_cost.analyze(sharded, placed)
        measured = _median_ms(sharded, TOOLS_TIMED, device)
        walk_line(f"(a) {cfg.name} decode step at batch {B} on the 1 x 1 "
                  f"mesh", walk, measured)
        log(f"tools (a) walker bytes {walk['bytes_per_device']:.6e} against "
            f"the weights' {nbytes} (phase 14's bound "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms x {HBM_BYTES_PER_S:.3e} "
            f"B/s)")
        require(walk["bytes_per_device"] >= nbytes,
                "tools (a): the walker's bytes are under the weights' bytes")
        del placed, walk
    finally:
        dist.destroy_process_group()
    del model, params
    if device == "cuda":
        torch.cuda.empty_cache()


def tools_train(arch=LM_ARCH, device=DEVICE, reduced=False,
                shape=TOOLS_TRAIN_SHAPE):
    """Phase 17 (b): the walker over one AdamW train step of phase 16's
    config at batch x seq `shape`, its H100 bound held at most the
    measured median step; its dot FLOPs beside `train_bound_ms`'s 8·N·D,
    and the two terms that part them: attention's S² products and the
    embedding."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import op_cost
    from repro_torch.launch.train import stream_for
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.training.trainer import TrainState, make_train_step
    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else cfg
    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0))
    opt = AdamW(state_dtype=cfg.optstate_dtype)
    step = make_train_step(model.loss, opt, cosine_schedule(1e-3, 5, 100))
    state = TrainState(step=torch.zeros((), dtype=torch.int32, device=device),
                       params=params, opt_state=opt.init(params))
    B, S = shape
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in stream_for(cfg, B, S).next().items()}
    walk = op_cost.analyze(step, state, batch)
    holder = [walk["out"][0]]
    del walk["out"]

    def one():
        holder[0] = step(holder[0], batch)[0]
    measured = _median_ms(one, TOOLS_TRAIN_TIMED, device)
    walk_line(f"(b) {cfg.name} train step at batch {B} x seq {S}", walk,
              measured)
    n = sum(p.numel() for p in params.values())
    eight = 8.0 * n * B * S
    # the walk's products by kind: a dense model's weights multiply as mm
    # (3-D activations fold), attention's scores and probs x V as bmm
    bmm = sum(r.flops for r in walk["records"] if r.op in ("bmm", "baddbmm"))
    mm = walk["flops_per_device"] - bmm
    norms = sum(p.numel() for k, p in params.items() if "norm" in k)
    table = 0 if cfg.tie_embeddings else cfg.padded_vocab * cfg.d_model
    short = 8.0 * (n - norms - table) * B * S - mm
    log(f"tools (b) walker dot FLOPs {walk['flops_per_device']:.6e} against "
        f"train_bound_ms's 8·N·D {eight:.6e} (N {n}, D {B * S}); where they "
        f"differ: attention's S² products (bmm), which 8·N·D leaves out, "
        f"{bmm:.6e}; the weights' products (mm) {mm:.6e}, "
        f"{short:.6e} under 8·(N - {norms} norm weights, elementwise - "
        f"{table} params of an untied input table, a gather"
        f"{'; the tied table is the logits weight, 8 a token' if cfg.tie_embeddings else ''}"
        f")·D where remat is on: torch's non-reentrant checkpoint stops "
        f"recomputing a period once the tensors its backward needs are "
        f"back, so the products after them are not run again")
    del state, holder, params, model, opt
    if device == "cuda":
        torch.cuda.empty_cache()


def tools_dryrun():
    """Phase 17 (d): the port's dry run, rank 0 of a fake process group:
    lp-matching on both production meshes and qwen3-1.7b decode_32k on
    (16, 16); per-device HBM, the three roofline terms, the dominant one.
    No FAIL."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    cells = [("lp-matching", "single",
              lambda m: dryrun.lower_lp(m)),
             ("lp-matching", "multipod",
              lambda m: dryrun.lower_lp(m)),
             (LM_ARCH + " decode_32k", "single",
              lambda m: dryrun.lower_cell(LM_ARCH, "decode_32k", m))]
    for what, mesh_name, run in cells:
        t0 = time.perf_counter()
        rec = run(make_production_mesh(multi_pod=mesh_name == "multipod"))
        r = rec["roofline"]
        log(f"tools (d) dry run {what} on {mesh_name} {rec['mesh']}: "
            f"{rec['status']}, HBM {rec['hbm_per_device_gb']:.4f} GB a "
            f"device, t_compute {r['t_compute_s']:.6e} s, t_memory "
            f"{r['t_memory_s']:.6e} s, t_collective {r['t_collective_s']:.6e}"
            f" s, dominant {r['dominant']}; collectives "
            f"{rec['collectives']}; {time.perf_counter() - t0:.1f} s")
        require(rec["status"] == "OK", f"tools (d): {what} did not pass")


def tools_phase():
    """Phase 17 (see the module docstring)."""
    tools_decode()
    tools_train()
    tools_dryrun()


def main() -> int:
    import argparse
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--kernel-times", metavar="ROOT",
        help="only time K1, K3 and K5 of the checkout at ROOT on the wide "
        "slabs (e.g. an unpacked copy of another commit) and print them")
    parser.add_argument("--rank-worker", metavar="SPEC",
                        help="one rank of phase 10 (spawned by it)")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    root = os.path.abspath(opts.kernel_times or ROOT)
    sys.path.insert(0, os.path.join(root, "src"))
    if opts.kernel_times:
        return kernel_times(root)
    if opts.rank_worker:
        spec = json.loads(opts.rank_worker)
        found = rank_worker(spec)
        with open(os.path.join(spec["out"], f"rank{spec['rank']}.json"),
                  "w") as f:
            json.dump(found, f)
        return 0
    from repro_torch.kernels import _build
    from repro_torch.launch import solve
    WRAPPERS.update(_wrappers())
    t_start = time.perf_counter()

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    _build.build()
    ptxas = _build.build_log()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
    spills = len(re.findall(r"[1-9]\d* bytes spill stores", ptxas))
    log(f"build: {_build.build_seconds():.1f} s (nvcc, sm_90a, in parallel); "
        f"ptxas: {len(regs)} kernels, at most {max(regs, default=0)} "
        f"registers, {spills} with spills; "
        + "; ".join(re.findall(r"== nvcc (\S+ \(rc=\d+, done after [\d.]+ s\))",
                               ptxas)))
    inst = ptxas_dual_x(ptxas)
    log("dual_x register-path instances (type L x VPT K1|K3: registers, "
        "spill store bytes): " + ", ".join(
            f"{d} {L}x{V} {'K3' if gv else 'K1'}: {r}, {sp}"
            for (d, L, V, gv), (r, sp) in sorted(inst.items())))
    log("wide and K5 instances (kernel type layout: registers, spill store "
        "bytes): " + ", ".join(f"{k}: {r}, {sp}" for k, (r, sp) in
                               sorted(ptxas_wide(ptxas).items())))

    # 3. the main path, through the CLI's entry point
    args = solve.build_parser().parse_args(MAIN_ARGS)
    inst = solve.generate_instance(args, log=lambda msg: log(f"  {msg}"))
    out, launches, per_eval = drive(
        args, inst, ("dual_x_slab", "ax_reduce_plan_x"), "main path")
    require(out.result["certificate_valid"] is True, "certificate not valid")
    lam, gamma = out.lam, out.gamma
    records = {}
    counts = {"dual_x_slab": (launches, per_eval),
              "ax_reduce_plan_x": (launches, per_eval)}

    # 4. K1, K2 against their plain versions, at the main path's shapes
    records["dual_x_slab"], steps = check_dual_x(out.objective, lam, gamma)
    records["ax_reduce_plan_x"] = check_ax_reduce(out.objective)
    repeatability(out.objective, gamma)

    # 5. the gvals path on the same instance
    args_g = solve.build_parser().parse_args(
        MAIN_ARGS + ["--ax-mode", "aligned_gvals"])
    out_g, launches_g, per_eval_g = drive(
        args_g, inst, ("dual_grad_slab", "ax_reduce_plan"),
        "main path, aligned_gvals")
    require(out_g.result["certificate_valid"] is True,
            "aligned_gvals certificate not valid")
    g_t = torch.full((), gamma, device=lam.device)
    require(calculate_bits_equal(out.objective.calculate(lam, g_t),
                                 out_g.objective.calculate(lam, g_t)),
            "aligned_gvals and aligned evaluations differ at the main path's "
            "lambda")
    log("aligned_gvals: one evaluation at the main path's final lambda equals "
        "aligned's bit for bit (g, grad, aux)")
    counts["dual_grad_slab"] = (launches_g, per_eval_g)
    counts["ax_reduce_plan"] = (launches_g, per_eval_g)
    records["dual_grad_slab"] = check_dual_grad(out_g.objective, lam, gamma,
                                                steps)
    records["ax_reduce_plan"] = check_ax_reduce_gvals(out_g.objective,
                                                      out.objective)
    single_gvals = (out_g.result, out_g.lam, out_g.solve_seconds)
    del out_g
    torch.cuda.empty_cache()
    xs, us, n5 = proj_path(out.objective, lam, gamma)
    require(n5 > 0, "proj_boxcut never ran on its path")
    log(f"proj path (ops.proj_boxcut on every slab's u): {n5} launches")
    counts["proj_boxcut"] = ({"proj_boxcut": n5}, {"proj_boxcut": n5})
    records["proj_boxcut"] = check_proj(out.objective, lam, gamma, xs, us)
    del xs, us
    torch.cuda.empty_cache()
    args_s = solve.build_parser().parse_args(
        [a for a in MAIN_ARGS if a != "--certify"] + ["--ax-mode", "scatter"])
    out_s, _, _ = drive(args_s, inst, ("dual_grad_slab",),
                        "main path, scatter")
    del out_s
    torch.cuda.empty_cache()

    # 6. rows wider than 1,024
    wide_recs, wide_out = wide_rows()
    for name, rec in wide_recs.items():
        records[name]["wide"] = rec

    # 7. parity with the reference's recorded run, every mode
    parity()

    # 8. the other update rules and the fault-tolerance path
    t_rules = time.perf_counter()
    by_rule = main_path_rules(args, inst, out.result["dual_obj_final"])
    torch.cuda.empty_cache()
    fault_tolerance(args, out.objective, out.lam,
                    out.result["iterations_run"])
    torch.cuda.empty_cache()
    rule_parity()
    cli_flags()
    log(f"phase 8 (rules): {time.perf_counter() - t_rules:.1f} s")
    for name in ("dual_x_slab", "ax_reduce_plan_x"):
        records[name]["launches_by_rule"] = {
            rule: n[name] for rule, n in by_rule.items()}

    # 9. the formulations
    t_forms = time.perf_counter()
    by_form = {"multi_budget pdhg (main path)":
               formulation_main_path(inst, out),
               "assignment_eq (main path)": formulation_assignment(inst)}
    torch.cuda.empty_cache()
    compiled_matching(out)
    torch.cuda.empty_cache()
    by_form.update(formulation_parity())
    log(f"phase 9 (formulations): {time.perf_counter() - t_forms:.1f} s")

    # 11. the allocation server and its frontend on phase 3's objective
    # and final lambda (run before phase 10, which frees them)
    t_serve = time.perf_counter()
    k1_serve, k2_serve = serve_phase(out, wide_out)
    records["dual_x_slab"].update(k1_serve)
    records["ax_reduce_plan_x"].update(k2_serve)
    del wide_out
    log(f"phase 11 (serve): {time.perf_counter() - t_serve:.1f} s")

    # 12. the solve's observability: phase 3's objective with a run log, a
    # sampler and a profiler window; the wide cell through the CLI's flags;
    # a failing run's trace (before phase 10, which frees phase 3's)
    t_obs = time.perf_counter()
    obs_phase(args, out, records)
    torch.cuda.empty_cache()
    log(f"phase 12 (obs): {time.perf_counter() - t_obs:.1f} s")
    single_main = (out.result, out.lam, out.solve_seconds)
    del out
    torch.cuda.empty_cache()
    for name, rec in records.items():
        rec["launches_by_formulation"] = {
            run: n[name] for run, n in by_form.items()}

    # 10. the distributed solve: one NCCL rank at full width, two ranks
    # on this card over gloo, NCCL over every card where there are more
    t_ranks = time.perf_counter()
    by_mode = distributed_one_rank(inst, single_main, single_gvals)
    del inst
    torch.cuda.empty_cache()
    for name, rec in records.items():
        rec["launches_distributed"] = {
            f"{mode}, one NCCL rank": n[name] for mode, n in by_mode.items()}
    ranks_parity("(b) two ranks on one card, gloo", 2, "gloo", False)
    cards = torch.cuda.device_count()
    if cards > 1:
        ranks_parity(f"(c) {cards} cards, NCCL", cards, "nccl", True)
    else:
        log("ranks (c): one card on this machine; the multi-card NCCL path "
            "was not run")
    log(f"phase 10 (ranks): {time.perf_counter() - t_ranks:.1f} s")

    # 13. the solver examples, each in a process of its own
    t_examples = time.perf_counter()
    examples_phase()
    log(f"phase 13 (examples): {time.perf_counter() - t_examples:.1f} s")

    # 14. the dense decoder's serving path at full width
    t_lm = time.perf_counter()
    lm_phase()
    log(f"phase 14 (lm): {time.perf_counter() - t_lm:.1f} s")

    # 15. the other families served; 16. training
    t_fam = time.perf_counter()
    families_phase()
    log(f"phase 15 (families): {time.perf_counter() - t_fam:.1f} s")
    t_train = time.perf_counter()
    train_phase()
    log(f"phase 16 (train): {time.perf_counter() - t_train:.1f} s")

    # 17. the compile-side tools: the op walker, a sharded step, dry run
    t_tools = time.perf_counter()
    tools_phase()
    log(f"phase 17 (tools): {time.perf_counter() - t_tools:.1f} s")

    kernels = []
    for name, rec in records.items():
        total, per = counts[name]
        rec["launches"] = total[name]
        rec["launches_per_iteration"] = per[name]
        kernels.append(rec)
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
