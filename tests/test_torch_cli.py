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


EXPORT = ["--sources", "2000", "--destinations", "100", "--iterations",
          "100", "--chunk-rows", "300", "--json"]


def test_export_primal_matches_reference_shards(tmp_path):
    """`--export-primal` writes the reference CLI's shards: the same
    names, slab indices, starts, source ids, dest ids and masks exactly,
    x within 1e-3 (after 100 iterations at γ = 0.01 the two packages' λ
    differ by float32 noise, which u = −(aᵀλ + c)/γ scales by 1/γ), and x
    equal bit for bit to the port's own extraction at its final λ."""
    import numpy as np
    from repro_torch.launch import solve
    from repro_torch.primal import extract_primal, read_shards
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    out = subprocess.run(
        [sys.executable, "-m", "repro.launch.solve", *EXPORT,
         "--export-primal", str(ref_dir)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    args = solve.build_parser().parse_args(
        EXPORT + ["--export-primal", str(port_dir), "--device", "cpu"])
    logs = []
    outcome = solve.run(args, log=logs.append)
    port = outcome.result
    assert port["export_shards"] == ref["export_shards"] > 1
    assert any(line.startswith(f"exported {port['export_shards']} decision "
                               f"shards (2000 sources)") for line in logs)
    names = sorted(p.name for p in port_dir.iterdir())
    assert names == sorted(p.name for p in ref_dir.iterdir())
    for name in names:
        with np.load(port_dir / name) as a, np.load(ref_dir / name) as b:
            assert sorted(a.files) == sorted(b.files)
            for f in a.files:
                if f == "x":
                    np.testing.assert_allclose(a[f], b[f], rtol=0, atol=1e-3)
                else:
                    np.testing.assert_array_equal(a[f], b[f])
    obj = outcome.objective
    xs = read_shards([str(port_dir / n) for n in names], len(obj.lp.slabs))
    for a, b in zip(xs, extract_primal(obj, outcome.lam, outcome.gamma)):
        np.testing.assert_array_equal(a, b)


def test_export_primal_skipped_when_preempted(tmp_path, monkeypatch):
    """A preempted solve exports nothing (resume it first)."""
    from repro_torch.launch import solve
    monkeypatch.setattr(solve._Checkpoints, "preempted", lambda self: True)
    args = solve.build_parser().parse_args(
        ["--sources", "300", "--destinations", "20", "--iterations", "100",
         "--check-every", "25", "--checkpoint-dir", str(tmp_path / "ck"),
         "--export-primal", str(tmp_path / "x"), "--device", "cpu"])
    logs = []
    res = solve.run(args, log=logs.append).result
    assert res["stop_reason"] == "preempted"
    assert "export_shards" not in res and not (tmp_path / "x").exists()
    assert any(line.startswith("skipping primal export") for line in logs)
