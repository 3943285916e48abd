"""Helpers of the example parity tests (`tests/test_torch_examples*.py`):
run a reference example (`examples/*.py`, JAX on the CPU) in a subprocess
beside the port's run, and read the numbers it prints."""
import contextlib
import io
import os
import re
import runpy
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def start_reference(script, *args, pallas=False):
    """`python examples/<script> args` with JAX on the CPU, one thread, as
    a Popen whose stdout is read by `reference_output`.  With `pallas` the
    example runs on the reference's kernel path
    (`tests/torch_reference_pallas.py`)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env["XLA_FLAGS"] = " ".join(
        [env.get("XLA_FLAGS", ""), "--xla_cpu_multi_thread_eigen=false"]
    ).strip()
    wrap = ([os.path.join(ROOT, "tests", "torch_reference_pallas.py")]
            if pallas else [])
    return subprocess.Popen(
        [sys.executable, *wrap, os.path.join(ROOT, "examples", script),
         *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT)


def reference_output(proc, timeout=600):
    out, _ = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, f"reference example failed:\n{out}"
    return out


def run_reference_in_process(script):
    """`examples/<script>` run in this process (`runpy`), its output
    swallowed; returns its globals."""
    with contextlib.redirect_stdout(io.StringIO()):
        return runpy.run_path(os.path.join(ROOT, "examples", script))


@contextlib.contextmanager
def one_torch_thread():
    """The port's CPU runs on one thread: the tests run several files at
    once, and at these sizes more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


_NAME = re.compile(r"^\s*(\S+): λ = \[")
_STOP = re.compile(r"(\d+) iters in [\d.]+s \((\w+)\), dual (-?[\d.]+), "
                   r"infeas ([\d.e+-]+)")
_ROW = re.compile(r"coupling row (\S+): ([\d.]+) / ([\d.]+) "
                  r"\((binding|slack)\)")


def parse_tour(text):
    """formulations_tour's rows: {name: {iterations_run, stop_reason,
    dual_final, infeas_final, usage {label: [used, limit]}, binding
    {label: bool}}}."""
    rows, cur = {}, None
    for line in text.splitlines():
        m = _NAME.match(line)
        if m:
            cur = rows[m.group(1)] = {"usage": {}, "binding": {}}
            continue
        m = _STOP.search(line)
        if m and cur is not None:
            cur.update(iterations_run=int(m.group(1)),
                       stop_reason=m.group(2),
                       dual_final=float(m.group(3)),
                       infeas_final=float(m.group(4)))
            continue
        m = _ROW.search(line)
        if m and cur is not None:
            cur["usage"][m.group(1)] = [float(m.group(2)),
                                        float(m.group(3))]
            cur["binding"][m.group(1)] = m.group(4) == "binding"
    return rows


def parse_allocation_tour(text):
    """allocation_server's tour: the numbers its lines print."""
    def find(pattern, cast=float):
        m = re.search(pattern, text)
        assert m, f"no {pattern!r} in the reference's output:\n{text}"
        return tuple(cast(g) for g in m.groups())
    return {
        "iterations_run": find(r"solved in (\d+) iters", int)[0],
        "certificate_valid": "certificate: VALID" in text,
        "gap": find(r"duality gap\s+([\d.]+)")[0],
        "gap_rel": find(r"duality gap\s+[\d.]+\s+\(relative ([\d.e+-]+)\)")[0],
        "served_sources": find(r"served (\d+) sources", int)[0],
        "bitwise": "bitwise equal to batch extraction" in text,
        "warm_iterations": find(r"warm re-solve after tightening count cap "
                                r"to [\d.]+: (\d+) iters", int)[0],
        "warm_gap": find(r"updated certificate: gap ([\d.]+)")[0],
        "warm_valid": "valid=True\n\nallocation server tour OK" in text,
    }
