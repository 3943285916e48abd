"""One run of one cell of the benchmark of the PyTorch and CUDA port:

    python3 -m lpbench.run --workload <cell> --seed <n> --seconds <s> --trace 0|1

from the root of a checkout.  The cell (`BENCHMARK.json`'s `workloads`)
names a configuration (`lpbench/configs/<name>.json`: the instance, the
formulation, the rule, the criteria, the limits of the check) and a
traffic mix (`lpbench/traffic/<name>.json`).  A run:

  1. loads the program's kernels (built into the checkout's `build/` the
     first time);
  2. generates the configuration's instance on the card, relabelled by
     --seed (`instance.py`), and packs it into the program's slab layout;
  3. builds the program's objective (preconditioning, the Ax plan, the
     formulation's coupling rows);
  4. warms up with one solve as the window makes them;
  5. solves back to back, each through the program's `Maximizer` from
     the traffic mix's start (lam = 0), until --seconds have passed: the
     window closes at the end of the first solve that ends after that;
  6. judges up to MAX_JUDGED distinct answers against the plain
     reference (`reference/`), after the program's state is freed;
  7. prints one JSON line: with --trace 0 the cell's end-to-end metrics,
     with --trace 1 its per-layer metrics, read from a traced window
     (the engine's telemetry over every solve, a trace of the card's
     activity over the first, `trace.py`).

Every metric is a reader `lpbench/metrics/<name>.py` with `read(ctx)`,
found by the metric's name; it returns None when it finds nothing to
read, and the metric is then left out.  The run fails, and prints no
result, without a CUDA card, without the program in the checkout, or
when a module of JAX or of the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "lpbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# distinct answers judged at most, drawn from the seed
MAX_JUDGED = 3


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_cell(name: str, root: Path = ROOT):
    """(BENCHMARK.json, the cell, its configuration, its traffic mix)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads(
        (root / "lpbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, config, traffic


def cell_metrics(bench: dict, cell: str, per_layer: bool):
    """The metrics a run of `cell` reports: its end-to-end metrics, or its
    per-layer ones."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not per_layer:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved
                             else [])]


def reader(name: str):
    """The `read(ctx)` of metric `name`."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"lpbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def use_program(root: Path = ROOT) -> None:
    """Put the program (`src/repro_torch`) on the path; fail without it."""
    src = root / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        raise SystemExit(f"the program is not in this checkout "
                         f"({src / 'repro_torch'} is missing)")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))


def build_objective(config: dict, lp):
    """The program's objective of the configuration over the packed LP:
    the matching LP row-normalized under the x-carry aligned path (the
    paper's main path), or a formulation compiled onto it."""
    from repro_torch import formulations
    from repro_torch.core.objectives import MatchingObjective
    from repro_torch.core.preconditioning import precondition
    form = config["formulation"]
    if form["name"] == "matching":
        if config["row_norm"]:
            lp, _ = precondition(lp, row_norm=True)
        return MatchingObjective(lp, ax_mode=config["ax_mode"])
    return formulations.make_objective(
        form["name"], lp, params=form.get("params") or {},
        ax_mode=config["ax_mode"], row_norm=config["row_norm"])


def settings(config: dict):
    from repro_torch.core.types import SolveConfig, StoppingCriteria
    return (SolveConfig(**config["solve"]),
            StoppingCriteria(**config["criteria"]))


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def start(obj, traffic: dict, seed: int, k: int, device):
    """The dual the k-th solve of a run starts from (the traffic mix's
    `start`; "zero": a cold solve)."""
    import torch
    if traffic["start"] != "zero":
        raise SystemExit(f"unknown traffic start {traffic['start']!r}")
    return torch.zeros(obj.dual_shape, dtype=torch.float32, device=device)


def solve_once(obj, config, rule, lam0, telemetry=None):
    """One cold solve through the program's entry point, waited for."""
    from repro_torch.core.maximizer import Maximizer
    cfg, criteria = config
    sync(lam0.device)
    t0 = time.perf_counter()
    res = Maximizer(cfg, algorithm=rule).maximize(obj, initial_value=lam0,
                                                  criteria=criteria,
                                                  telemetry=telemetry)
    sync(res.lam.device)
    return res, time.perf_counter() - t0


def window(obj, config, rule, seconds: float, starts, telemetry=None,
           trace=None) -> dict:
    """Cold solves back to back, the k-th from `starts(k)`, until
    `seconds` have passed (the window closes at the end of the first solve
    that ends after them).  The first solve runs inside `trace` when one
    is given."""
    from repro_torch.core.types import StopReason
    # a solve completes at its tolerance, or at its count when the
    # configuration sets no tolerance
    done = {StopReason.CONVERGED} | (set() if config[1].has_tolerances
                                     else {StopReason.MAX_ITERATIONS})
    solves, raised = [], None
    t0 = time.perf_counter()
    while True:
        lam0 = starts(len(solves))
        try:
            if trace is not None and not solves:
                with trace:
                    res, dt = solve_once(obj, config, rule, lam0, telemetry)
            else:
                res, dt = solve_once(obj, config, rule, lam0, telemetry)
        except Exception as exc:          # a solve that raised is a failure
            raised = f"{type(exc).__name__}: {exc}"
            log(f"solve {len(solves)} raised {raised}")
            break
        solves.append({
            "seconds": dt, "iterations": int(res.iterations_run),
            "complete": res.stop_reason in done,
            "stop": res.stop_reason.value if res.stop_reason else None,
            "lam": res.lam, "dual": float(res.stats.dual_obj[-1]),
            "gamma": float(res.stats.gamma[-1])})
        if time.perf_counter() - t0 >= seconds:
            break
    return {"solves": solves, "raised": raised,
            "window_s": time.perf_counter() - t0}


def distinct_answers(solves, seed: int):
    """The distinct (lam bits, reported dual) of the window's solves; at
    most MAX_JUDGED of them, drawn from the seed, the last solve's always
    among them."""
    seen = {}
    for s in solves:
        key = (s["lam"].detach().cpu().numpy().tobytes(), s["dual"],
               s["gamma"])
        seen.setdefault(key, s)
    answers = list(seen.values())
    if len(answers) > MAX_JUDGED:
        keep = random.Random(seed).sample(answers[:-1], MAX_JUDGED - 1)
        answers = keep + [answers[-1]]
    return answers


def run_cell(bench, cell, config, traffic, seed: int, seconds: float,
             trace: bool, device, t_start: float = T_START) -> dict:
    """One run of `cell` on `device` (module doc); returns the result
    line's object.  On the CPU the program runs its plain versions and the
    device trace is skipped: a rehearsal, whose times are not the card's."""
    import torch

    from . import roofline
    from .instance import instance, to_port_lp
    from .reference.check import judge, verdict
    from .reference.lp import ReferenceLP
    device = torch.device(device)
    cuda = device.type == "cuda"
    use_program()
    if cuda:
        from repro_torch.kernels import _build
        _build.build()
        log(f"kernels loaded ({_build.build_seconds():.3f} s)")
    sync(device)
    t0 = time.perf_counter()
    raw = instance(config["instance"], seed, device)
    sync(device)
    t1 = time.perf_counter()
    lp = to_port_lp(raw, config["instance"]["min_width"])
    num_edges, num_sources = raw.num_edges, raw.sources.numel()
    raw = raw._replace(**{f: getattr(raw, f).cpu() for f in raw._fields
                          if f != "num_sources"})
    sync(device)
    t_gen = time.perf_counter()
    log(f"instance: {num_edges} edges, {num_sources} sources, "
        f"{len(lp.slabs)} slabs of widths {[s.width for s in lp.slabs]}; "
        f"start-up {t0 - t_start:.3f} s, generation {t1 - t0:.3f} s, "
        f"packing {t_gen - t1:.3f} s")
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    obj = build_objective(config, lp)
    del lp
    sync(device)
    build_s = time.perf_counter() - t_gen
    rule = config["rule"]
    solve_cfg = settings(config)

    def starts(k):
        return start(obj, traffic, seed, k, device)
    warm, warm_s = solve_once(obj, solve_cfg, rule, starts(-1))
    log(f"objective built in {build_s:.3f} s; warm-up solve "
        f"{warm.iterations_run} iterations, {warm.stop_reason.value}, "
        f"{warm_s:.3f} s")
    del warm
    tel = records = tracer = None
    if trace:
        from repro_torch.obs.telemetry import ListSink, Telemetry

        from .trace import DeviceTrace
        sink = ListSink()
        tel = Telemetry(sink=sink, stream=io.StringIO())
        records = sink.records
        if cuda:
            tracer = DeviceTrace(device)
            calculate = obj.calculate

            def traced_calculate(lam, gamma):
                tracer.enter()
                out = calculate(lam, gamma)
                tracer.exit()
                return out
            obj.calculate = traced_calculate
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    win = window(obj, solve_cfg, rule, seconds, starts, tel, tracer)
    solves = win["solves"]
    times = sorted(s["seconds"] for s in solves) or [0.0]
    log(f"window: {len(solves)} solves in {win['window_s']:.3f} s, each "
        f"{times[0]:.4f} / {times[len(times) // 2]:.4f} / {times[-1]:.4f} s "
        f"(least / median / most); iterations "
        f"{sorted({s['iterations'] for s in solves})}, stops "
        f"{sorted({str(s['stop']) for s in solves})}")
    answers = distinct_answers(solves, seed)
    for ans in answers:
        _, grad, _ = obj.calculate(ans["lam"], torch.tensor(
            ans["gamma"], dtype=torch.float32, device=device))
        ans["grad"] = grad.detach().reshape(-1).clone()
    sync(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    dual_rows = int(torch.tensor(obj.dual_shape).prod())
    del obj
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    # the reference, on the card the program has left
    t_ref = time.perf_counter()
    raw = raw._replace(**{f: getattr(raw, f).to(device) for f in raw._fields
                          if f != "num_sources"})
    ref = ReferenceLP(raw, config)
    readings = judge(ref, answers)
    limits = config["checks"]
    failed = sum(not s["complete"] for s in solves) + (win["raised"] is not
                                                         None)
    correct = (win["raised"] is None and bool(solves)
               and verdict(readings, limits))
    log(f"reference: {len(answers)} distinct answer(s) judged in "
        f"{time.perf_counter() - t_ref:.3f} s")
    del ref, raw
    ctx = {"solves": solves, "records": records, "setup_s": setup_s,
           "build_s": build_s, "trace": tracer.reduce() if tracer else None,
           "evaluation_bytes": roofline.evaluation_bytes(
               num_edges, num_sources, config["instance"]["num_families"],
               dual_rows),
           "hbm_bytes_per_s": roofline.HBM_BYTES_PER_S}
    if ctx["trace"] is not None:
        tr = ctx["trace"]
        log(f"trace: {tr['events']} device events, "
            f"{len(tr.get('calculate_s', []))} evaluations marked, window "
            f"{tr.get('window_s')} s, busy {tr.get('busy_s')} s")
    metrics = {}
    for m in cell_metrics(bench, cell["name"], trace):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(solves)
              + (win["raised"] is not None), "failed": int(failed),
              "metrics": metrics, "device": dev}
    tr = ctx["trace"]
    if trace and tr and "busy_s" in tr:
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {k: {"value": readings[k], "limit": limits[k]}
                        for k in limits}
    return result


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    bench, cell, config, traffic = load_cell(args.workload)
    import torch

    # one process with one host thread: steadier times on a host whose
    # cores other machines share
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell["chips"]):
        log(f"{args.workload} needs {cell['chips']} CUDA card(s); this "
            f"machine has {torch.cuda.device_count()}")
        return 2
    print(f"device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)
    result = run_cell(bench, cell, config, traffic, args.seed, args.seconds,
                      bool(args.trace), "cuda:0")
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or of the JAX package were loaded: {found}")
        return 3
    for k, v in result["checks"].items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
