"""The port's multi-pod dry run (`repro_torch.launch.dryrun`) against the
JAX package's `repro.launch.dryrun`.

The reference runs in a subprocess: `repro/launch/dryrun.py` sets
XLA_FLAGS (512 host devices) at import, which must not reach this
process or the subprocesses other tests start from it.  Both walk a
reduced-width qwen3-1.7b (2 layers, d_model 256, 16 heads of 64, 8 K/V
heads, d_ff 512, vocab 4,096: the same `overrides`) at train_4k and
decode_32k on the (16, 16) mesh, and the LP solver's iteration: per-device
argument bytes equal exactly (the same shards: params, AdamW moments,
counters, batch; caches; the LP's slab, b and λ), dot FLOPs per device
within 10 % (measured: train 0.994, decode 1.0, LP 1.0 of the
reference's), and the LP's all-reduce is m·J + 2 floats, 40,008 bytes at
J = 10,000, in both.  The SKIP set of every arch × shape equals the
reference's `cell_applicable`.  No test leaves a process group up.
"""
import json
import os
import subprocess
import sys

import pytest
import torch.distributed as dist

from repro.configs import arch_ids as r_arch_ids
from repro.configs import get_config as r_get_config
from repro.models import SHAPES as R_SHAPES
from repro.models import cell_applicable as r_cell_applicable
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import SHAPES, cell_applicable

OVERRIDES = {"d_model": 256, "n_heads": 16, "n_kv": 8, "head_dim": 64,
             "d_ff": 512, "n_layers": 2, "vocab": 4096}
FLOPS_TOL = 0.10
LP_ALL_REDUCE = (10_000 + 2) * 4

_REFERENCE = r"""
import json, sys
from repro.launch import dryrun            # sets XLA_FLAGS first
from repro.launch.mesh import make_production_mesh
over = json.loads(sys.argv[1])
mesh = make_production_mesh()
out = {s: dryrun.lower_cell("qwen3-1.7b", s, mesh, overrides=over)
       for s in ("train_4k", "decode_32k")}
out["lp"] = dryrun.lower_lp(mesh)
keep = ("status", "memory", "cost", "collectives")
print("RESULT " + json.dumps({k: {f: v.get(f) for f in keep}
                              for k, v in out.items()}))
"""


@pytest.fixture(autouse=True)
def no_group_left():
    yield
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def reference():
    """The reference's three records, from a subprocess started at once so
    that it runs while the port walks."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, json.dumps(OVERRIDES)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    holder = {}

    def get():
        if not holder:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            line = next(ln for ln in out.splitlines()
                        if ln.startswith("RESULT "))
            holder.update(json.loads(line[len("RESULT "):]))
        return holder
    yield get
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_cell_equals_reference(reference, shape):
    got = dryrun.lower_cell("qwen3-1.7b", shape, make_production_mesh(),
                            overrides=OVERRIDES)
    want = reference()[shape]
    assert got["status"] == want["status"] == "OK"
    assert (got["memory"]["argument_size_in_bytes"]
            == want["memory"]["argument_size_in_bytes"])
    ratio = (got["cost"]["flops_per_device"]
             / want["cost"]["flops_per_device"])
    assert abs(ratio - 1) <= FLOPS_TOL, ratio
    assert got["n_devices"] == 256 and got["mesh"] == [16, 16]
    r = got["roofline"]
    assert r["bound_step_time_s"] == max(r["t_compute_s"], r["t_memory_s"],
                                         r["t_collective_s"]) > 0
    json.dumps(got)                         # a record the CLI can write


def test_lp_equals_reference(reference):
    got = dryrun.lower_lp(make_production_mesh())
    want = reference()["lp"]
    assert (got["memory"]["argument_size_in_bytes"]
            == want["memory"]["argument_size_in_bytes"])
    assert (got["collectives"]["all-reduce"]
            == want["collectives"]["all-reduce"] == LP_ALL_REDUCE)
    assert got["cost"]["flops_per_device"] == pytest.approx(
        want["cost"]["flops_per_device"], rel=FLOPS_TOL)


def test_lp_multipod_and_lambda_sharded():
    multi = dryrun.lower_lp(make_production_mesh(multi_pod=True))
    assert multi["n_devices"] == 512
    assert multi["collectives"]["all-reduce"] == LP_ALL_REDUCE
    lam = dryrun.lower_lp(make_production_mesh(), lambda_axis="model")
    # λ's 625 columns a rank gathered, the reduce-scatter of 16 blocks
    assert lam["collectives"]["all-gather"] == 625 * 4
    assert lam["collectives"]["reduce-scatter"] == 16 * (625 + 2) * 4


def test_skip_set_equals_reference():
    mesh = make_production_mesh()
    for arch in r_arch_ids():
        for name in R_SHAPES:
            ok, _ = r_cell_applicable(r_get_config(arch), R_SHAPES[name])
            if not ok:
                got = dryrun.lower_cell(arch, name, mesh)
                assert got["status"] == "SKIP", (arch, name)
            else:
                assert cell_applicable(get_config(arch), SHAPES[name])[0]


def test_cli_writes_results(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "RESULTS", str(tmp_path))
    assert dryrun.main(["--arch", "lp-matching", "--mesh", "both"]) == 0
    for mesh in ("single", "multipod"):
        with open(tmp_path / mesh / "lp-matching__solve.json") as f:
            rec = json.load(f)
        assert rec["status"] == "OK" and rec["mesh_name"] == mesh
    assert "0 FAIL" in capsys.readouterr().out
    # cached on the second call
    assert dryrun.main(["--arch", "lp-matching", "--mesh", "single"]) == 0
    assert "[cache]" in capsys.readouterr().out
