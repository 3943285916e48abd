"""The port's CLI `--formulation` against the reference CLI's, at 2,000 ×
100 on the CPU.

For global_count, multi_budget and assignment_eq, a fixed 400 agd
iterations with `--certify --json`: the instance fingerprint, the
formulation, the iterations, the stop reason and the certificate's
verdict exact (VALID for the inequality formulations, INVALID for
assignment_eq, whose shrunk witness breaks Σx = s in both), the final
dual within 1e-4 relative (a fixed agd run; λ itself drifts, ROADMAP
queue C), and the logged row slices equal.  `--warm-start` loads at the
formulation's dual shape.
"""
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SIZE = ["--sources", "2000", "--destinations", "100"]
REF, PORT = "repro.launch.solve", "repro_torch.launch.solve"


def _cli(module, *flags, ok=True):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    extra = ["--device", "cpu"] if module == PORT else []
    out = subprocess.run([sys.executable, "-m", module, *SIZE, *flags,
                          "--json", *extra], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    if not ok:
        assert out.returncode != 0
        return out.stderr
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


def _slices(log):
    return re.search(r"formulation '\w+': .*", log).group(0)


@pytest.fixture(scope="module", params=["global_count", "multi_budget",
                                        "assignment_eq"])
def runs(request):
    flags = ["--iterations", "400", "--certify", "--formulation",
             request.param]
    with ThreadPoolExecutor(2) as pool:     # the two CLIs side by side
        ref, port = pool.map(lambda mod: _cli(mod, *flags), (REF, PORT))
    return request.param, ref, port


def test_formulation_results_agree(runs):
    name, (ref, ref_log), (port, port_log) = runs
    assert set(port) == set(ref)
    assert port["formulation"] == ref["formulation"] == name
    for key in ("fingerprint", "iterations_run", "stop_reason",
                "certificate_valid", "gamma_final"):
        assert port[key] == ref[key], key
    assert port["certificate_valid"] is (name != "assignment_eq")
    assert (abs(port["dual_obj_final"] - ref["dual_obj_final"])
            <= 1e-4 * abs(ref["dual_obj_final"]))
    assert _slices(port_log) == _slices(ref_log)


def test_certificate_lists_the_families(runs):
    name, (_, ref_log), (_, port_log) = runs
    families = [re.findall(r"^family (\S+)", log, re.M)
                for log in (ref_log, port_log)]
    assert families[0] == families[1]
    assert len(families[1]) == {"global_count": 3, "multi_budget": 4,
                                "assignment_eq": 2}[name]


def test_warm_start_at_the_formulation_shape(tmp_path):
    dump = str(tmp_path / "mb.npz")
    flags = ["--iterations", "200", "--formulation", "multi_budget"]
    first, _ = _cli(PORT, *flags, "--save-duals", dump)
    warm, _ = _cli(PORT, *flags, "--warm-start", dump)
    assert warm["dual_obj_first"] > first["dual_obj_first"]
    err = _cli(PORT, "--iterations", "10", "--warm-start", dump, ok=False)
    assert "needs (1, 100)" in err and "(102,)" in err
