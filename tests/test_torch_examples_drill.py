"""The port's allocation-server overload drill (`repro_torch.examples.
allocation_server --load-test --quick --metrics-port 0`) held to the
reference example's pass criteria: no ERROR, no OK past its deadline,
every request classified, the refresh accepted and converged, the
mid-drill /metrics scrape parsed with the required series.
"""
from repro_torch.examples import allocation_server
from torch_examples_ref import one_torch_thread


def test_overload_drill_meets_the_reference_criteria(capsys):
    with one_torch_thread():
        got = allocation_server.main(
            ["--device", "cpu", "--load-test", "--quick", "--metrics-port",
             "0"])
    out = capsys.readouterr().out
    assert "mid-drill /metrics scrape OK" in out
    assert "overload drill OK" in out
    assert got["errors"] == 0 and got["ok"] > 0
    assert got["classified"] == got["submitted"] == got["requests"]
    assert got["refresh_status"] == "accepted"
    assert got["metrics_series"] > 0
