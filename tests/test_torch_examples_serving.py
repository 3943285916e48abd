"""The port's allocation-server example (`repro_torch.examples.
allocation_server --quick`) against the reference's
(`examples/allocation_server.py --quick`, a subprocess, JAX on the CPU,
run beside the port's).

Tour: both solves converge and stop within one check (50) of each other;
both certificates VALID, the duality gap at 1e-3 relative; every served
row bitwise equal to batch extraction in both; the warm re-solve within
one check of the reference's (100) and its certificate VALID, its gap at
1e-3.
"""
import contextlib
import io

import numpy as np
import pytest

from repro_torch.examples import allocation_server
from torch_examples_ref import (one_torch_thread, parse_allocation_tour,
                                reference_output, start_reference)

CHECK = 50
TOL_GAP = 1e-3


@pytest.fixture(scope="module")
def tours():
    proc = start_reference("allocation_server.py", "--quick")
    try:
        with one_torch_thread(), contextlib.redirect_stdout(io.StringIO()):
            got = allocation_server.main(["--device", "cpu", "--quick"])
    finally:
        ref = parse_allocation_tour(reference_output(proc))
    return got, ref


def test_tour_solve_and_certificate_match_reference(tours):
    got, ref = tours
    assert abs(got["iterations_run"] - ref["iterations_run"]) <= CHECK
    assert got["certificate_valid"] and ref["certificate_valid"]
    np.testing.assert_allclose(got["gap"], ref["gap"], rtol=TOL_GAP)
    np.testing.assert_allclose(got["gap_rel"], ref["gap_rel"], rtol=TOL_GAP)
    assert got["integral_valid"]


def test_tour_serving_is_bitwise_in_both(tours):
    got, ref = tours
    assert got["bitwise"] and ref["bitwise"]
    assert got["served_sources"] == ref["served_sources"] == 25 * 32


def test_tour_warm_resolve_matches_reference(tours):
    got, ref = tours
    assert got["warm_converged"]
    assert abs(got["warm_iterations"] - ref["warm_iterations"]) <= CHECK
    assert got["warm_iterations"] < got["iterations_run"]
    assert got["warm_certificate_valid"] and ref["warm_valid"]
