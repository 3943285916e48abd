"""The port's CLI (`python -m repro_torch.launch.solve --device cpu`)
against the reference's (`python -m repro.launch.solve`), same flags.

Exact: the instance fingerprint, the stop reason, the certificate's
validity.  The final dual within 1e-5 relative.  The stopping iteration
within ±50, two checks: at --tol-rel-dual 1e-6 the stop is decided at ~10
float32 ulps of the dual, and the reference's own `scatter` and `aligned`
lowerings stop 50 iterations apart on this instance (ROADMAP queue C).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FLAGS = ["--sources", "2000", "--destinations", "100", "--tol-rel-dual",
         "1e-6", "--check-every", "25", "--iterations", "1500", "--certify",
         "--json"]


def _run(module, extra=()):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-m", module, *FLAGS, *extra],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def results():
    return (_run("repro.launch.solve"),
            _run("repro_torch.launch.solve", ["--device", "cpu"]))


def test_same_keys(results):
    ref, port = results
    assert set(port) == set(ref)


def test_exact_fields_agree(results):
    ref, port = results
    for key in ("fingerprint", "stop_reason", "certificate_valid",
                "formulation", "algorithm"):
        assert port[key] == ref[key], key
    assert port["certificate_valid"] is True


def test_trajectory_agrees(results):
    ref, port = results
    assert abs(port["iterations_run"] - ref["iterations_run"]) <= 50
    assert (abs(port["dual_obj_final"] - ref["dual_obj_final"])
            <= 1e-5 * abs(ref["dual_obj_final"]))
    assert port["gamma_final"] == ref["gamma_final"]


def test_cuda_device_raises_without_card(monkeypatch):
    """The default device is the card; with none the entry point raises
    instead of falling back to the CPU."""
    import torch
    from repro_torch.launch import solve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = solve.build_parser().parse_args(["--sources", "50",
                                            "--destinations", "5"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        solve.run(args)
