"""The port's CLI against the reference's, same flags as test_torch_cli.py,
in the gvals modes: `--ax-mode aligned_gvals` and `--ax-mode scatter`.

The same holds as in the default mode (test_torch_cli.py): exact
fingerprint, stop reason and certificate validity, the final dual within
1e-5 relative, the stopping iteration within ±50 (two checks: at
--tol-rel-dual 1e-6 the stop is decided at ~10 float32 ulps of the dual),
and the same γ at the end.
"""
import pytest

from test_torch_cli import _run


@pytest.fixture(scope="module", params=["aligned_gvals", "scatter"])
def results(request):
    mode = ["--ax-mode", request.param]
    return (_run("repro.launch.solve", mode),
            _run("repro_torch.launch.solve", ["--device", "cpu", *mode]))


def test_mode_same_keys_and_exact_fields(results):
    ref, port = results
    assert set(port) == set(ref)
    for key in ("fingerprint", "stop_reason", "certificate_valid",
                "formulation", "algorithm"):
        assert port[key] == ref[key], key
    assert port["certificate_valid"] is True


def test_mode_trajectory_agrees(results):
    ref, port = results
    assert abs(port["iterations_run"] - ref["iterations_run"]) <= 50
    assert (abs(port["dual_obj_final"] - ref["dual_obj_final"])
            <= 1e-5 * abs(ref["dual_obj_final"]))
    assert port["gamma_final"] == ref["gamma_final"]
