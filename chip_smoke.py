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

The last three lines of standard output are the card's name and power
limit, the kernels' JSON record, and {"ok": true, "device": {...}}.  Exits
non-zero, printing no result, when there is no card.

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
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
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


def check_dual_x(obj, lam, gamma):
    """K1 on every slab of the main path against its plain version and,
    bit for bit, its kernel-order plain version; the bisection's steps at
    the final lambda and at lambda = 0; one sweep timed at three layouts;
    the bound max(bytes, issue).  Returns the record and the steps."""
    import torch
    from repro_torch.kernels import dual_grad as dg
    from repro_torch.kernels import ref
    from repro_torch.kernels.dual_grad import dual_x_slab
    slabs = obj.lp.slabs
    g = torch.full((), gamma, dtype=torch.float32, device=lam.device)
    iters = obj.proj_iters
    err_x, err_s = 0.0, 0.0
    for s in slabs:
        x, cx, xsq = dual_x_slab(*s[:6], lam, g, iters=iters)
        xr, cxr, xsqr = ref.dual_x_ref(*s[:6], lam, g, iters)
        err_x = max(err_x, float((x - xr).abs().max()))
        for u, v in ((cx, cxr), (xsq, xsqr)):
            err_s = max(err_s, abs(float(u) - float(v)) / max(abs(float(v)), 1e-30))
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
    nbytes, real, padded, rows, ea, ec, eu = _slab_bytes(slabs, m, J)
    nbytes += padded * ec                     # x written
    rec = {"name": "dual_x_slab", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/dual_x.cu",
           "replaces": "src/repro/kernels/dual_grad.py:80",
           "max_abs_err": err_x, "ms": ms, "plain_ms": plain_ms,
           "library_ms": None}
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
    # bytes the function must move: a_dm, edge_idx and the x gather at the
    # real entries only (the kernel skips masked ones), the mask over every
    # plan entry, dest_ids per row, the (m, J) result written once
    real = sum(int(b.mask.sum()) for b in plan.buckets)
    entries = sum(b.mask.numel() for b in plan.buckets)
    prow = sum(b.dest_ids.numel() for b in plan.buckets)
    ea, ex = plan.buckets[0].a_dm.element_size(), x.element_size()
    nbytes = real * (ea * m + 4 + ex) + entries + prow * 4 + m * J * 4
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
            "item_entries": work.item_entries, "ms_by_table": sweep}


def _slab_bytes(slabs, m, J):
    """The bytes every slab kernel reads of the slabs: a, c, dest and ub at
    the real edges only (the kernels read them only where the mask is set),
    the mask over every padded entry, s per row, lambda once; and the
    counts behind them."""
    real = sum(int(s.mask.sum()) for s in slabs)
    padded = sum(s.n * s.width for s in slabs)
    rows = sum(s.n for s in slabs)
    ea, ec, eu = (slabs[0].a_vals.element_size(),
                  slabs[0].c_vals.element_size(), slabs[0].ub.element_size())
    nbytes = (real * (ea * m + ec + 4 + eu) + padded
              + rows * slabs[0].s.element_size() + m * J * 4)
    return nbytes, real, padded, rows, ea, ec, eu


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
    nbytes, real, padded, rows, ea, ec, eu = _slab_bytes(slabs, m, J)
    nbytes += padded * (ec + ea * m)          # x and gvals written
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
    # bytes: the m gvals and edge_idx at the real entries (the kernel skips
    # masked ones), the mask over every plan entry, dest_ids per row, the
    # (m, J) result written once
    real = sum(int(b.mask.sum()) for b in plan.buckets)
    entries = sum(b.mask.numel() for b in plan.buckets)
    prow = sum(b.dest_ids.numel() for b in plan.buckets)
    eg = gv.element_size()
    nbytes = real * (eg * m + 4) + entries + prow * 4 + m * J * 4
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
    base, real, padded, rows, ea, ec, eu = _slab_bytes([slab], m, J)
    plains = {"dual_x_slab": lambda: ref.dual_x_ref(*slab[:6], lam, g, iters),
              "dual_grad_slab": lambda: ref.dual_grad_ref(*slab[:6], lam, g,
                                                          iters),
              "proj_boxcut": lambda: ref.proj_boxcut_ref(
                  u, slab.ub, slab.s, slab.mask, iters)}
    work = {"dual_x_slab": (base + padded * ec, real_ops(real, m, False)),
            "dual_grad_slab": (base + padded * (ec + ea * m),
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
    scratch).  Returns {kernel name: {slab: times}}."""
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
    del out, inst

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
    return recs


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
                 max_iterations=None):
    """One perf_lp/tol_agd solve on the card from a fresh transfer of the
    instance, in `mode`; with `count`, of GlobalCountObjective, its count
    row normalized (row_scale 1/sqrt(real edges), as the reference's
    formulations compiler normalizes a global row) or, with `normalized`
    False, all ones as in the reference's class."""
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
    cfg = SolveConfig(iterations=30000, gamma=0.01, max_step=1e-1,
                      initial_step=1e-5)
    crit = StoppingCriteria(tol_rel_dual=1e-6, tol_infeas_rel=1e-4,
                            check_every=PARITY_CHECK,
                            max_iterations=max_iterations)
    t0 = time.perf_counter()
    res = Maximizer(cfg).maximize(obj, criteria=crit)
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


def main() -> int:
    import argparse
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--kernel-times", metavar="ROOT",
        help="only time K1, K3 and K5 of the checkout at ROOT on the wide "
        "slabs (e.g. an unpacked copy of another commit) and print them")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    root = os.path.abspath(opts.kernel_times or ROOT)
    sys.path.insert(0, os.path.join(root, "src"))
    if opts.kernel_times:
        return kernel_times(root)
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
    del out_g
    torch.cuda.empty_cache()
    xs, us, n5 = proj_path(out.objective, lam, gamma)
    require(n5 > 0, "proj_boxcut never ran on its path")
    log(f"proj path (ops.proj_boxcut on every slab's u): {n5} launches")
    counts["proj_boxcut"] = ({"proj_boxcut": n5}, {"proj_boxcut": n5})
    records["proj_boxcut"] = check_proj(out.objective, lam, gamma, xs, us)
    del out, xs, us
    torch.cuda.empty_cache()
    args_s = solve.build_parser().parse_args(
        [a for a in MAIN_ARGS if a != "--certify"] + ["--ax-mode", "scatter"])
    out_s, _, _ = drive(args_s, inst, ("dual_grad_slab",),
                        "main path, scatter")
    del out_s, inst
    torch.cuda.empty_cache()

    # 6. rows wider than 1,024
    for name, rec in wide_rows().items():
        records[name]["wide"] = rec

    # 7. parity with the reference's recorded run, every mode
    parity()

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
