"""The port's chaos smoke (`repro_torch.examples.chaos_smoke --quick`):
three runs of `python -m repro_torch.launch.solve` (uninterrupted, SIGTERM
after the first checkpoint, `--resume`) whose resumed duals drift ≤ 1e-7
from the uninterrupted run's, then an in-process NaN chunk under the
health guard that is rolled back and runs to its cap — the reference
example's criteria (`examples/chaos_smoke.py --quick`: drift 0.000e+00,
health [('nonfinite', 'rollback')])."""
import contextlib
import io

from repro_torch.examples import chaos_smoke
from torch_examples_ref import one_torch_thread


def test_chaos_smoke_resumes_bitwise_and_rolls_back(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # the three CLI runs
    with one_torch_thread(), contextlib.redirect_stdout(io.StringIO()) as out:
        got = chaos_smoke.main(["--device", "cpu", "--quick", "--json"])
    assert got["dual_drift"] <= 1e-7
    assert got["health"] == [["nonfinite", "rollback"]]
    assert got["guarded_stop_reason"] == "max_iterations"
    assert got["guarded_iterations"] == 120
    assert "preempted at iteration" in got["interrupted_last_line"]
    assert "chaos smoke: all checks passed" in out.getvalue()
