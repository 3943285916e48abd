"""The port's CLI under ranks on the CPU: `python -m torch.distributed.run
--standalone --nproc-per-node 2 -m repro_torch.launch.solve --device cpu`
(gloo) at 2,000 x 100 for a fixed 100 iterations, with and without
`--lambda-sharded` (on the CLI's (2, 1) grid the "model" axis has one
rank, as in the reference CLI).

Rank 0 alone prints, one JSON object; its final dual within 1e-4
relative of the reference CLI's at the same flags (the dual of a fixed
iteration count, not a stop decided at float32 noise).  `--lambda-sharded`
with another formulation is refused, as the reference refuses it.  Duals
saved under two ranks warm-start a run on one.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
FLAGS = ["--sources", "2000", "--destinations", "100", "--iterations", "100",
         "--json"]


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1")


def _run(cmd, ok=True):
    out = subprocess.run(cmd, cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=300)
    if ok:
        assert out.returncode == 0, out.stderr[-3000:]
    return out


def _ranks(n, extra=()):
    return _run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", str(n), "-m", "repro_torch.launch.solve",
                 "--device", "cpu", *FLAGS, *extra])


@pytest.fixture(scope="module")
def reference():
    out = _run([sys.executable, "-m", "repro.launch.solve", *FLAGS])
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("extra", [[], ["--lambda-sharded"]],
                         ids=["replicated", "lambda-sharded"])
def test_two_ranks_match_reference_cli(reference, extra):
    out = _ranks(2, extra)
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, out.stdout
    port = json.loads(lines[0])
    assert port["iterations_run"] == reference["iterations_run"] == 100
    assert port["fingerprint"] == reference["fingerprint"]
    assert (abs(port["dual_obj_final"] - reference["dual_obj_final"])
            <= 1e-4 * abs(reference["dual_obj_final"]))
    assert "ranks: 2 on a (2, 1) grid" in out.stderr


def test_lambda_sharded_refused_for_other_formulations():
    out = _run([sys.executable, "-m", "repro_torch.launch.solve", "--device",
                "cpu", "--lambda-sharded", "--formulation", "multi_budget",
                *FLAGS], ok=False)
    assert out.returncode == 2
    assert "--lambda-sharded is only supported" in out.stderr


def test_duals_saved_by_two_ranks_warm_start_one(tmp_path):
    path = tmp_path / "duals.npz"
    saved = json.loads(_ranks(2, ["--save-duals", str(path)]).stdout)
    with np.load(path) as z:
        lam = z["lam"]
    assert lam.shape == (1, 100) and np.isfinite(lam).all()
    out = _run([sys.executable, "-m", "repro_torch.launch.solve", "--device",
                "cpu", *FLAGS, "--warm-start", str(path)])
    warm = json.loads(out.stdout.strip().splitlines()[-1])
    # the first evaluation is at the saved duals: next to where the two
    # ranks ended, far from a cold start's first dual
    rel = (abs(warm["dual_obj_first"] - saved["dual_obj_final"])
           / abs(saved["dual_obj_final"]))
    assert rel < 1e-3, (warm["dual_obj_first"], saved["dual_obj_final"])
    assert abs(saved["dual_obj_first"] - saved["dual_obj_final"]) > 100
