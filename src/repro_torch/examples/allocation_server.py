"""Allocation-server tour: solve → certify → serve → warm re-solve; the
port of the reference's `examples/allocation_server.py`.

    PYTHONPATH=src python -m repro_torch.examples.allocation_server [--quick]

The production loop of the duals-to-decisions story (DESIGN.md §8) on one
Appendix-B instance with the multi_budget formulation (capacity + global
count/value caps):

  1. solve to tolerance through the shared engine;
  2. stream-extract the primal, round + repair it, and CERTIFY: a finite
     nonnegative duality gap over a feasible witness, every constraint
     family's slack within tolerance;
  3. stand up the λ-resident AllocationServer and serve random microbatch
     queries — decisions must be BITWISE equal to batch extraction;
  4. nudge the instance (tighten the count cap) and warm re-solve from
     the resident λ (γ-continuation skipped per the warm-start rule),
     then re-certify the updated duals.

Exit code is non-zero on an invalid certificate, a serving mismatch, or a
non-converged solve.  The solves run the aligned layout (K1 + K2); a
query runs K1 on its rows.

With `--load-test` the tour is replaced by the overload drill
(DESIGN.md §12): N concurrent clients drive the traffic-hardened
`ServerFrontend` at ~2× the measured single-thread capacity while a warm
re-solve lands mid-run, then the frontend drains.  Exit code is non-zero
if the server crashes (any ERROR response or dead client), if any
request past its deadline escapes TIMEOUT/SHED classification, if an OK
response exceeded its deadline, if the background refresh fails, or if
the drain leaves an unanswered request.

With `--metrics-port PORT` (0 = ephemeral) the load test also stands up
the live Prometheus `/metrics` plane (DESIGN.md §13) and scrapes it over
real HTTP *in the middle of the storm*: the exposition must parse, the
frontend latency histogram / queue depth / shed + timeout counters and
the host-memory gauges must be present, and the histogram's bucket
counts must be internally consistent — otherwise the drill fails.
"""
import threading
import time
import urllib.request

import numpy as np
import torch

from .. import formulations, primal
from ..convert import lp_to_numpy, lp_to_torch, resolve_device
from ..core import (InstanceSpec, Maximizer, SolveConfig, StoppingCriteria,
                    generate)
from ..obs import ExpositionError, parse_exposition
from ..primal import FrontendConfig, RequestStatus, ServerFrontend
from ._common import emit, fail, launch_counts, launches_since, parser


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _solve(args, dev, I, J, before):
    """The multi_budget instance solved to tolerance: (lp, obj, res, cfg,
    crit, seconds).  A solve that does not converge fails the run; with
    `--json` what it reached is printed first, one object on the line
    before the FAIL line."""
    spec = InstanceSpec(num_sources=I, num_destinations=J,
                        avg_nnz_per_row=10, seed=11, num_families=2)
    lp = lp_to_torch(generate(spec), dev)
    cfg = SolveConfig(iterations=2000 if args.quick else 4000, gamma=0.05,
                      gamma_init=0.8, gamma_decay_every=25,
                      max_step=20.0, initial_step=1e-3)
    crit = StoppingCriteria(tol_rel_dual=1e-5 if args.quick else 1e-6,
                            check_every=50)
    obj = formulations.make_objective("multi_budget", lp,
                                      ax_mode="aligned", row_norm=True)
    t0 = time.perf_counter()
    res = Maximizer(cfg).maximize(obj, criteria=crit)
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"instance: {I} sources x {J} destinations x {lp.m} families; "
          f"solved in {res.iterations_run} iters / {dt:.1f}s "
          f"({res.stop_reason.value})")
    if not res.converged:
        emit({"example": "allocation_server", "device": str(dev),
              "sources": I, "destinations": J, "converged": False,
              "iterations_run": res.iterations_run,
              "iterations_cap": cfg.iterations,
              "stop_reason": res.stop_reason.value,
              "dual_final": float(res.stats.dual_obj[-1]),
              "rel_dual_last": (res.diagnostics[-1].rel_dual
                                if res.diagnostics else None),
              "solve_seconds": dt, "launches": launches_since(before)},
             args)
        fail("solve did not converge")
    return lp, obj, res, cfg, crit, dt


def _scrape_metrics(url) -> int:
    """Mid-drill scrape of the live /metrics plane over HTTP (loopback),
    while the clients still hammer the frontend; fails the drill on an
    unparseable exposition or a missing required series.  Returns the
    number of series."""
    try:
        with urllib.request.urlopen(url, timeout=10.0) as resp:
            text = resp.read().decode("utf-8")
    except OSError as e:
        fail(f"/metrics scrape failed mid-drill: {e!r}")
    try:
        series = parse_exposition(text)
    except ExpositionError as e:
        fail(f"/metrics exposition unparseable mid-drill: {e}")
    required = [
        'repro_frontend_latency_seconds_bucket{status="ok",le="+Inf"}',
        "repro_frontend_queue_depth",
        'repro_frontend_requests_total{status="shed"}',
        'repro_frontend_requests_total{status="timeout"}',
        "repro_memory_host_rss_bytes",
        "repro_memory_host_peak_rss_bytes",
        "repro_server_query_latency_seconds_count",
    ]
    missing = [s for s in required if s not in series]
    if missing:
        fail(f"/metrics missing required series mid-drill: {missing}")
    if series["repro_memory_host_rss_bytes"] <= 0:
        fail("/metrics host RSS gauge is not positive")
    print(f"mid-drill /metrics scrape OK: {len(series)} series, "
          f"rss {series['repro_memory_host_rss_bytes'] / 2**20:.0f} MiB, "
          f"queue depth {series['repro_frontend_queue_depth']:.0f}")
    return len(series)


def load_test(args, dev, before) -> dict:
    """The overload drill: concurrent clients past capacity, a refresh
    mid-run, a graceful drain — every request classified, zero stranded."""
    I = args.sources or (600 if args.quick else 3_000)
    J = args.destinations or (30 if args.quick else 120)
    duration = args.duration or (3.0 if args.quick else 10.0)
    clients = args.clients
    lp, obj, res, cfg, crit, t_solve = _solve(args, dev, I, J, before)
    gamma = torch.tensor(cfg.gamma, device=dev)
    cert = primal.certify(obj, res.lam, gamma)

    srv = primal.AllocationServer(obj, res.lam, gamma, config=cfg,
                                  max_batch=64)
    srv.warmup()
    ids_pool = srv.source_ids()
    batch = min(8, len(ids_pool))
    rng = np.random.default_rng(0)

    # measure single-thread capacity, then offer 2x that across clients
    probes = 30
    t0 = time.perf_counter()
    for _ in range(probes):
        srv.query(rng.choice(ids_pool, size=batch, replace=False).tolist())
    per_query = (time.perf_counter() - t0) / probes
    qps_single = 1.0 / per_query
    deadline = max(20.0 * per_query, 0.05)
    offered = 2.0 * qps_single
    interval = clients / offered
    print(f"capacity ~{qps_single:.0f} q/s single-thread; offering "
          f"{offered:.0f} q/s across {clients} clients, "
          f"deadline {deadline * 1e3:.0f} ms")

    fe = ServerFrontend(srv, FrontendConfig(
        max_queue=64, max_batch=64, default_deadline_s=deadline,
        metrics_port=args.metrics_port))
    if fe.exporter is not None:
        print(f"live metrics plane: {fe.exporter.url}")
    results = [[] for _ in range(clients)]
    crashed = []

    def client(k):
        rng_k = np.random.default_rng(100 + k)
        end = time.monotonic() + duration
        next_t = time.monotonic()
        try:
            while time.monotonic() < end:
                ids = rng_k.choice(ids_pool, size=batch,
                                   replace=False).tolist()
                resp = fe.query(ids, deadline_s=deadline, timeout=60.0)
                results[k].append(resp)
                next_t += interval
                pause = next_t - time.monotonic()
                if pause > 0:
                    time.sleep(pause)
        except Exception as e:   # a client dying IS a server crash here
            crashed.append((k, repr(e)))

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    t_run = time.perf_counter()
    for t in threads:
        t.start()
    # land a warm re-solve in the middle of the storm: the refresh must
    # complete without stalling the query path
    time.sleep(duration / 3.0)
    tight = formulations.make_objective(
        "multi_budget", lp,
        params=dict(count_cap=0.9 * cert.slacks["count_cap"].used,
                    value_cap=cert.slacks["value_cap"].limit),
        ax_mode="aligned", row_norm=True)
    if not fe.refresh(criteria=crit, obj=tight):
        fail("refresh refused with no resolve in flight")
    n_series = (_scrape_metrics(fe.exporter.url)
                if fe.exporter is not None else 0)
    for t in threads:
        t.join(timeout=duration + 120.0)
    if any(t.is_alive() for t in threads):
        fail("a client thread hung — unanswered request")
    wall = time.perf_counter() - t_run
    refresh_status, res_w = fe.wait_refresh(timeout=300.0)
    snap = fe.drain()

    if crashed:
        fail(f"client crashed: {crashed}")
    flat = [r for rs in results for r in rs]
    errors = [r for r in flat if r.status is RequestStatus.ERROR]
    if errors:
        fail(f"{len(errors)} ERROR responses (first: "
             f"{errors[0].reason!r}) — the server must shed or time out "
             f"under overload, never fail")
    ok = [r for r in flat if r.status is RequestStatus.OK]
    late_ok = [r for r in ok if r.latency_s > deadline + 0.005]
    if late_ok:
        fail(f"{len(late_ok)} OK responses exceeded the deadline "
             f"without TIMEOUT classification")
    if not ok:
        fail("no request completed OK under overload")
    classified = (snap["ok_total"] + snap["shed_total"]
                  + snap["timeout_total"] + snap["error_total"])
    if classified != snap["submitted_total"]:
        fail(f"drain left unanswered requests: {snap['submitted_total']}"
             f" submitted, {classified} classified")
    if refresh_status != "accepted" or res_w is None or not res_w.converged:
        fail(f"mid-run warm refresh did not complete ({refresh_status})")

    lat = np.asarray([r.latency_s for r in ok])
    n = len(flat)
    p50, p99 = (float(np.percentile(lat, q)) for q in (50, 99))
    print(f"\nload test: {n} requests from {clients} clients in "
          f"{wall:.1f}s ({n / wall:.0f} q/s offered)")
    print(f"  OK {len(ok)} ({len(ok) / n:.0%})  p50 {p50 * 1e3:.1f} ms  "
          f"p99 {p99 * 1e3:.1f} ms (deadline {deadline * 1e3:.0f} ms)")
    print(f"  shed {snap['shed_total']:.0f}  timeout "
          f"{snap['timeout_total']:.0f}  batches {snap['batches_total']:.0f}"
          f"  — every request classified, refresh landed mid-run")
    print("\noverload drill OK")
    return {"mode": "load_test", "sources": I, "destinations": J,
            "iterations_run": res.iterations_run, "solve_seconds": t_solve,
            "capacity_qps": qps_single, "deadline_s": deadline,
            "requests": n, "ok": len(ok), "shed": snap["shed_total"],
            "timeout": snap["timeout_total"], "errors": len(errors),
            "classified": classified, "submitted": snap["submitted_total"],
            "ok_p50_ms": p50 * 1e3, "ok_p99_ms": p99 * 1e3,
            "refresh_status": refresh_status,
            "refresh_iterations": res_w.iterations_run,
            "metrics_series": n_series, "wall_seconds": wall}


def tour(args, dev, before) -> dict:
    """Solve, certify, serve bitwise, warm re-solve, re-certify."""
    I = args.sources or (600 if args.quick else 5_000)
    J = args.destinations or (30 if args.quick else 200)
    n_queries = args.queries or (25 if args.quick else 200)
    lp, obj, res, cfg, crit, t_solve = _solve(args, dev, I, J, before)
    gamma = torch.tensor(cfg.gamma, device=dev)

    # -- 2. extract, round, certify ------------------------------------
    xs = primal.extract_primal(obj, res.lam, gamma, chunk_rows=256)
    cert = primal.certify(obj, res.lam, gamma)
    print("\nfractional witness certificate:")
    print(primal.format_certificate(cert))
    if not cert.valid:
        fail("fractional certificate invalid")
    lp_host = lp_to_numpy(obj.lp)       # rounding runs on the host
    xhat = primal.greedy_repair(primal.threshold_round(xs, lp_host), lp_host,
                                xs_frac=xs,
                                global_rows=primal.global_row_caps(obj))
    cert_int = primal.certify(obj, res.lam, gamma, xs=xhat)
    print(f"\nintegral witness: value {cert_int.primal_value:.3f}, "
          f"gap {cert_int.gap:.3f}, valid={cert_int.valid}")
    if not cert_int.valid:
        fail("integral certificate invalid")

    # -- 3. serve microbatches, check bitwise parity -------------------
    srv = primal.AllocationServer(obj, res.lam, gamma, config=cfg,
                                  max_batch=64)
    rng = np.random.default_rng(0)
    all_ids = srv.source_ids()
    batch = min(32, len(all_ids))
    srv.warmup()                # cold-start control: every query shape once
    srv.reset_stats()
    for _ in range(n_queries):
        ids = rng.choice(all_ids, size=batch, replace=False).tolist()
        decisions = srv.query(ids)
        for sid in ids:
            d = decisions[sid]
            if not np.array_equal(d.x, xs[d.slab_index][d.row]):
                fail(f"served decision for source {sid} != batch extraction")
    st = srv.stats()
    print(f"\nserved {st.sources} sources in {st.queries} microbatch "
          f"queries: p50 {st.p50_ms:.2f} ms, p95 {st.p95_ms:.2f} ms, "
          f"{st.sources_per_s:.0f} sources/s — bitwise equal to batch "
          f"extraction")

    # -- 4. instance update + warm re-solve from the resident λ --------
    count_used = cert.slacks["count_cap"].used
    tight = formulations.make_objective(
        "multi_budget", lp,
        params=dict(count_cap=0.8 * count_used,
                    value_cap=cert.slacks["value_cap"].limit),
        ax_mode="aligned", row_norm=True)
    res_w = srv.warm_resolve(criteria=crit, obj=tight)
    print(f"\nwarm re-solve after tightening count cap to "
          f"{0.8 * count_used:.1f}: {res_w.iterations_run} iters "
          f"({res_w.stop_reason.value}, vs {res.iterations_run} cold), "
          f"gamma[0]={float(res_w.stats.gamma[0]):.3f} (no continuation)")
    if not res_w.converged:
        fail("warm re-solve did not converge")
    cert_w = primal.certify(tight, srv.lam, gamma)
    print("updated certificate: "
          f"gap {cert_w.gap:.3f} (rel {cert_w.gap_rel:.2e}), "
          f"count used {cert_w.slacks['count_cap'].used:.1f} / "
          f"{cert_w.slacks['count_cap'].limit:.1f}, valid={cert_w.valid}")
    if not cert_w.valid:
        fail("post-update certificate invalid")
    print("\nallocation server tour OK")
    return {"mode": "tour", "sources": I, "destinations": J,
            "families": lp.m, "iterations_run": res.iterations_run,
            "solve_seconds": t_solve,
            "dual_final": float(res.stats.dual_obj[-1]),
            "certificate_valid": bool(cert.valid), "gap": cert.gap,
            "gap_rel": cert.gap_rel, "primal_value": cert.primal_value,
            "count_used": count_used,
            "value_used": cert.slacks["value_cap"].used,
            "integral_valid": bool(cert_int.valid),
            "integral_value": cert_int.primal_value,
            "served_sources": st.sources, "queries": st.queries,
            "bitwise": True, "p50_ms": st.p50_ms, "p95_ms": st.p95_ms,
            "sources_per_s": st.sources_per_s,
            "warm_iterations": res_w.iterations_run,
            "warm_converged": bool(res_w.converged),
            "warm_gamma0": float(res_w.stats.gamma[0]),
            "warm_certificate_valid": bool(cert_w.valid),
            "warm_gap_rel": cert_w.gap_rel}


def main(argv=None) -> dict:
    ap = parser(__doc__)
    ap.add_argument("--quick", action="store_true",
                    help="small instance + looser tolerance (CI smoke)")
    ap.add_argument("--sources", type=int, default=None)
    ap.add_argument("--destinations", type=int, default=None)
    ap.add_argument("--queries", type=int, default=None)
    ap.add_argument("--load-test", action="store_true",
                    help="overload drill: concurrent clients past "
                         "capacity + mid-run refresh + drain")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--duration", type=float, default=None,
                    help="load-test duration in seconds")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="with --load-test: serve live /metrics on this "
                         "port (0 = ephemeral) and scrape it mid-drill")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    before = launch_counts()
    result = (load_test(args, dev, before) if args.load_test
              else tour(args, dev, before))
    result.update(example="allocation_server", device=str(dev),
                  converged=True, launches=launches_since(before))
    return emit(result, args)


if __name__ == "__main__":
    main()
