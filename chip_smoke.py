#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU:  python3 chip_smoke.py

Run from the root of a checkout.  Imports the port (`src/repro_torch`) and
nothing of JAX or of the JAX package.  Phases, each failing loudly:

  1. device   the card's name and power limit (nvidia-smi), CUDA version
  2. build    nvcc builds every kernel from src/repro_torch/kernels/csrc
  3. main     the port's CLI entry point, in process, at 2M sources x 10k
              destinations (nu = 25): generate, row-normalize, agd to
              tolerance with adaptive continuation, certificate.  Every
              kernel's launch counter is set to 0 just before and read just
              after; each must have launched.  Then the counters of one
              dual evaluation (what an agd iteration runs once).
  4. kernels  each kernel against its plain PyTorch version on the card,
              on the main path's own tensors (every slab / every bucket in
              float32, bfloat16 copies of the widest and narrowest), with
              times (CUDA events, median of 20 after warm-up), the
              memory/operation bound, and a library yardstick where one
              PyTorch call computes the same function; then row norms
              and 50 main-path iterations, each twice, bit for bit
  5. parity   the reference's recorded perf_lp/tol_agd run (2000 x 1000,
              nu = 4, seed 42): converged, final dual within 1e-4 relative
              of -2340.3547, stopped within one check of where the
              reference's own ax modes stop, and a second run
              bit-identical to the first

The last three lines of standard output are the card's name and power
limit, the kernels' JSON record, and {"ok": true, "device": {...}}.  Exits
non-zero, printing no result, when there is no card.
"""
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
MAIN_ARGS = ["--sources", "2000000", "--destinations", "10000",
             "--nnz-per-row", "25", "--seed", "42",
             "--adaptive-continuation", "--tol-rel-dual", "1e-6",
             "--check-every", "25", "--iterations", "3000", "--certify",
             "--json", "--device", "cuda"]
PARITY_DUAL = -2340.354736328125       # perf_lp/tol_agd, bench_results.json
# where the reference's own ax modes stop on that instance (scatter 1600,
# sorted 1625, aligned and aligned_gvals 2150; JAX on a CPU): at
# tol_rel_dual 1e-6 the stopping check moves with the summation order alone
PARITY_ITERATIONS = (1600, 2150)


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


def check_dual_x(obj, lam, gamma):
    """K1 on every slab of the main path against its plain version."""
    import torch
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

    def kernel():
        for s in slabs:
            dual_x_slab(*s[:6], lam, g, iters=iters)

    def plain():
        for s in slabs:
            ref.dual_x_ref(*s[:6], lam, g, iters)

    ms = cuda_ms(kernel)
    plain_ms = cuda_ms(plain, reps=5, warmup=1)
    m, J = lam.shape
    # bytes the function must move: a, c, dest and ub at the real edges
    # only (the kernel reads them only where the mask is set), the mask and
    # the written x over every padded entry, s per row, lambda once
    real = sum(int(s.mask.sum()) for s in slabs)
    padded = sum(s.n * s.width for s in slabs)
    rows = sum(s.n for s in slabs)
    ea, ec, eu = (slabs[0].a_vals.element_size(),
                  slabs[0].c_vals.element_size(), slabs[0].ub.element_size())
    nbytes = (real * (ea * m + ec + 4 + eu) + padded * (1 + ec)
              + rows * slabs[0].s.element_size() + m * J * 4)
    ops = real * (2 * m + 12 + 4 * iters)
    bound_ms, bound_by = bound(nbytes, ops)
    log(f"dual_x_slab  one sweep ({len(slabs)} slabs, {real} real edges of "
        f"{padded}): {ms:.4f} ms; plain {plain_ms:.4f} ms; bound "
        f"{bound_ms:.4f} ms = max({nbytes} bytes / 3.35 TB/s, {ops} ops / "
        f"67 TFLOP/s); bytes = real*({ea}m + {ec} c + 4 dest + {eu} ub) + "
        f"padded*(1 mask + {ec} x) + {rows} rows*s + 4mJ")
    return {"name": "dual_x_slab", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dual_x.cu",
            "replaces": "src/repro/kernels/dual_grad.py:80",
            "max_abs_err": err_x, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def check_ax_reduce(obj):
    """K2 on every bucket of the main path's plan against its plain version,
    fed the main path's own x buffer."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ax_reduce import ax_reduce_bucket_x
    plan, x = obj._plan, obj._xbuf
    m, J = obj.lp.m, obj.lp.num_destinations
    out = torch.full((m, J), float("nan"), device=x.device)
    err = 0.0
    for b in plan.buckets:
        ax_reduce_bucket_x(x, b.a_dm, b.edge_idx, b.mask, b.dest_ids, out)
        want = ref.ax_reduce_x_ref(x, b.a_dm, b.edge_idx, b.mask).T
        got = out[:, b.dest_ids.long()]
        rel = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
        err = max(err, float((got - want).abs().max()))
        require(rel <= 1e-5, f"ax_reduce w={b.width}: rel err {rel} > 1e-5")
    require(not torch.isnan(out).any(),
            "ax_reduce: a destination was not written")
    full = ref.ax_plan_x_ref(plan, x)
    require(torch.allclose(out, full, rtol=1e-5, atol=1e-5), "ax assembly")
    log(f"ax_reduce_bucket_x  f32 all {len(plan.buckets)} buckets (widths "
        f"{plan.buckets[0].width}..{plan.buckets[-1].width}): max|d ax| "
        f"{err:.3e} (rtol 1e-5 of max(1, |ax|))")
    for b in (plan.buckets[0], plan.buckets[-1]):
        xb, ab = x.to(torch.bfloat16), b.a_dm.to(torch.bfloat16)
        ob = torch.zeros((m, J), device=x.device)
        ax_reduce_bucket_x(xb, ab, b.edge_idx, b.mask, b.dest_ids, ob)
        want = ref.ax_reduce_x_ref(xb, ab, b.edge_idx, b.mask).T
        got = ob[:, b.dest_ids.long()]
        rel = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
        require(rel <= 5e-2, f"ax_reduce bf16 w={b.width}: {rel}")
        log(f"ax_reduce_bucket_x  bf16 w={b.width}: rel err {rel:.3e} "
            f"(tol 5e-2)")

    ms = cuda_ms(lambda: ops.ax_aligned_x(plan, x))
    plain_ms = cuda_ms(lambda: ref.ax_plan_x_ref(plan, x), reps=5, warmup=1)
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
    require(torch.allclose(lib, out, rtol=1e-4, atol=1e-4), "CSR yardstick")
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
    log(f"ax_reduce_bucket_x  one Ax ({len(plan.buckets)} buckets, {real} "
        f"real entries of {entries}): {ms:.4f} ms; plain {plain_ms:.4f} ms; "
        f"CSR library {library_ms:.4f} ms; bound {bound_ms:.4f} ms = "
        f"{nbytes} bytes / 3.35 TB/s; bytes = real*({ea}m + 4 idx + {ex} x) "
        f"+ entries*1 mask + {prow} rows*4 dest + 4mJ")
    return {"name": "ax_reduce_bucket_x", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ax_reduce_x.cu",
            "replaces": "src/repro/kernels/ax_reduce.py:103",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


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


def parity():
    """The reference's recorded perf_lp/tol_agd run, on the card, twice from
    a fresh instance: the two runs must agree bit for bit (no atomics on
    the path, preconditioning included)."""
    import torch
    from repro_torch.convert import lp_to_torch
    from repro_torch.core import (InstanceSpec, MatchingObjective, Maximizer,
                                  SolveConfig, StoppingCriteria, generate,
                                  precondition, validate_lp)
    spec = InstanceSpec(num_sources=2000, num_destinations=1000,
                        avg_nnz_per_row=4.0, seed=42)
    lp_np = validate_lp(generate(spec))
    cfg = SolveConfig(iterations=30000, gamma=0.01, max_step=1e-1,
                      initial_step=1e-5)
    crit = StoppingCriteria(tol_rel_dual=1e-6, tol_infeas_rel=1e-4,
                            check_every=25)
    runs = []
    for _ in range(2):
        lp, _ = precondition(lp_to_torch(lp_np, "cuda"), row_norm=True)
        obj = MatchingObjective(lp, proj_kind="boxcut", proj_iters=20)
        t0 = time.perf_counter()
        res = Maximizer(cfg).maximize(obj, criteria=crit)
        torch.cuda.synchronize()
        runs.append((res, time.perf_counter() - t0))
    (res, dt), (again, _) = runs
    dual = float(res.stats.dual_obj[-1])
    rel = abs(dual - PARITY_DUAL) / abs(PARITY_DUAL)
    lo, hi = PARITY_ITERATIONS
    log(f"parity perf_lp/tol_agd: {res.stop_reason.value} after "
        f"{res.iterations_run} iterations (reference {lo}..{hi}, held "
        f"within one check of that); "
        f"dual {dual:.6f} vs {PARITY_DUAL:.6f} (rel {rel:.2e}, limit 1e-4); "
        f"{dt:.2f} s, {dt / max(res.iterations_run, 1) * 1e3:.3f} ms/iter")
    require(res.converged, "parity solve did not converge")
    require(rel <= 1e-4, f"parity dual off by {rel:.2e}")
    require(lo - crit.check_every <= res.iterations_run
            <= hi + crit.check_every,
            f"parity stopped at {res.iterations_run}, outside {lo}..{hi}")
    require(again.iterations_run == res.iterations_run
            and torch.equal(again.lam, res.lam),
            "two runs of the parity solve differ")
    log("parity: a second run from a fresh instance is bit-identical")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.ax_reduce import ax_reduce_bucket_x
    from repro_torch.kernels.dual_grad import dual_x_slab
    from repro_torch.launch import solve

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
        f"registers, {spills} with spills")

    # 3. the main path, through the CLI's entry point
    args = solve.build_parser().parse_args(MAIN_ARGS)
    dual_x_slab.launches = 0
    ax_reduce_bucket_x.launches = 0
    t0 = time.perf_counter()
    out = solve.run(args, log=lambda msg: log(f"  {msg}"))
    launches = {"dual_x_slab": dual_x_slab.launches,
                "ax_reduce_bucket_x": ax_reduce_bucket_x.launches}
    wall = time.perf_counter() - t0
    res = out.result
    log(f"main path result: {json.dumps(res, sort_keys=True)}")
    iters = res["iterations_run"]
    log(f"main path: {wall:.1f} s end to end = generate "
        f"{out.generate_seconds:.1f} s + set-up {out.setup_seconds:.2f} s + "
        f"solve loop {out.solve_seconds:.2f} s ({iters} iterations, "
        f"{out.solve_seconds / max(iters, 1) * 1e3:.3f} ms/iteration) + "
        f"certificate {out.certify_seconds:.2f} s; launches {launches}")
    require(all(n > 0 for n in launches.values()),
            f"a kernel never ran: {launches}")
    require(math.isfinite(res["dual_obj_final"]), "non-finite dual")
    require(res["stop_reason"] in ("converged", "max_iterations"),
            f"stop reason {res['stop_reason']}")
    require(res["certificate_valid"] is True, "certificate not valid")

    # launches of one dual evaluation (an agd iteration makes one)
    lam = out.lam
    dual_x_slab.launches = 0
    ax_reduce_bucket_x.launches = 0
    out.objective.calculate(lam, torch.full((), out.gamma, device=lam.device))
    per_iteration = {"dual_x_slab": dual_x_slab.launches,
                     "ax_reduce_bucket_x": ax_reduce_bucket_x.launches}
    log(f"launches of one dual evaluation: {per_iteration}")

    # 4. kernels against their plain versions, at the main path's shapes
    k1 = check_dual_x(out.objective, lam, out.gamma)
    k2 = check_ax_reduce(out.objective)
    repeatability(out.objective, out.gamma)
    del out
    torch.cuda.empty_cache()

    # 5. parity with the reference's recorded run
    parity()

    kernels = []
    for rec in (k1, k2):
        rec["launches"] = launches[rec["name"]]
        rec["launches_per_iteration"] = per_iteration[rec["name"]]
        kernels.append(rec)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
