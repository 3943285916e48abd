"""The port's CLI flags of the update rules and the fault-tolerance path
against the reference CLI's, at 2,000 × 100 on the CPU.

  * `--algorithm pdhg|bb|pga --json`: the `algorithm` field, the stop
    reason and the certificate's validity exact, the final dual within
    1e-4 relative (the stopping iteration at tol_rel_dual 1e-6 is float32
    noise, ROADMAP queue C);
  * `--save-duals` then `--warm-start` skips continuation with the
    reference's reason;
  * `--checkpoint-dir` then `--resume` ends on the uninterrupted run's
    bits, and `--resume` refuses what the reference refuses: no
    directory, another rule, another instance.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
SIZE = ["--sources", "2000", "--destinations", "100"]
TOL = ["--tol-rel-dual", "1e-6", "--check-every", "25", "--iterations",
       "1500"]
WARM_REASON = ("warm start: duals already at gamma=0.01 on this instance; "
               "continuation skipped")


def _cli(module, *flags, ok=True):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    extra = ["--device", "cpu"] if module.startswith("repro_torch") else []
    out = subprocess.run([sys.executable, "-m", module, *SIZE, *flags,
                          "--json", *extra], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    if not ok:
        assert out.returncode != 0
        return out.stderr
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


REF, PORT = "repro.launch.solve", "repro_torch.launch.solve"


@pytest.fixture(scope="module", params=["pdhg", "bb", "pga"])
def rule_runs(request):
    flags = [*TOL, "--certify", "--algorithm", request.param]
    return request.param, _cli(REF, *flags)[0], _cli(PORT, *flags)[0]


def test_rule_results_agree(rule_runs):
    rule, ref, port = rule_runs
    assert set(port) == set(ref)
    assert port["algorithm"] == ref["algorithm"] == rule
    for key in ("fingerprint", "stop_reason", "certificate_valid",
                "health_events", "gamma_final"):
        assert port[key] == ref[key], key
    assert port["stop_reason"] == "converged"
    assert port["certificate_valid"] is True
    assert (abs(port["dual_obj_final"] - ref["dual_obj_final"])
            <= 1e-4 * abs(ref["dual_obj_final"]))


def test_warm_start_skips_continuation_as_reference(tmp_path):
    flags = [*TOL, "--adaptive-continuation"]
    runs = {}
    for module in (REF, PORT):
        dump = str(tmp_path / f"{module}.npz")
        first, _ = _cli(module, *flags, "--save-duals", dump)
        assert first["saved_duals"] == dump
        warm, log = _cli(module, *flags, "--warm-start", dump)
        assert WARM_REASON in log
        runs[module] = (first, warm)
    (r1, rw), (t1, tw) = runs[REF], runs[PORT]
    assert tw["iterations_run"] < t1["iterations_run"]
    assert tw["gamma_final"] == rw["gamma_final"]
    assert (abs(tw["dual_obj_final"] - rw["dual_obj_final"])
            <= 1e-4 * abs(rw["dual_obj_final"]))
    with np.load(tmp_path / f"{PORT}.npz") as z:
        assert float(z["achieved_gamma"]) == pytest.approx(0.01)
        assert str(z["fingerprint"]) == t1["fingerprint"]


def test_resume_ends_on_the_uninterrupted_bits(tmp_path):
    ck, ck_full = str(tmp_path / "ck"), str(tmp_path / "full")
    pdhg = ["--algorithm", "pdhg", "--check-every", "25"]
    part, _ = _cli(PORT, *pdhg, "--iterations", "100", "--checkpoint-dir", ck)
    assert part["iterations_run"] == 100
    res, log = _cli(PORT, *pdhg, "--iterations", "200", "--checkpoint-dir",
                    ck, "--resume", "--save-duals", str(tmp_path / "a.npz"))
    assert "resumed from checkpoint step 100" in log
    assert res["iterations_run"] == 200     # counted from the start
    full, _ = _cli(PORT, *pdhg, "--iterations", "200", "--checkpoint-dir",
                   ck_full, "--save-duals", str(tmp_path / "b.npz"))
    assert res["dual_obj_final"] == full["dual_obj_final"]
    with np.load(tmp_path / "a.npz") as a, np.load(tmp_path / "b.npz") as b:
        np.testing.assert_array_equal(a["lam"], b["lam"])


def test_resume_refusals_match_reference(tmp_path):
    for module in (REF, PORT):
        err = _cli(module, "--resume", ok=False)
        assert "--resume requires --checkpoint-dir" in err
    msgs = {}
    for module in (REF, PORT):
        ck = str(tmp_path / module)
        _cli(module, "--algorithm", "pdhg", "--iterations", "50",
             "--checkpoint-dir", ck)
        err = _cli(module, "--algorithm", "bb", "--iterations", "100",
                   "--checkpoint-dir", ck, "--resume", ok=False)
        line = next(ln for ln in err.splitlines()
                    if ln.startswith("--resume refused"))
        msgs[module] = line.replace(ck, "DIR")
        err = _cli(module, "--algorithm", "pdhg", "--iterations", "100",
                   "--seed", "43", "--checkpoint-dir", ck, "--resume",
                   ok=False)
        assert "written for a different instance" in err
    assert msgs[PORT] == msgs[REF]
    assert "update rule 'pdhg', but this run uses 'bb'" in msgs[PORT]
