"""The port's MoE-routing example against the reference's
(`examples/moe_lp_routing.py`, run in process with `runpy`, JAX on the
CPU).

`route()` is fed the reference's own affinity: the greedy loads equal, the
greedy captured affinity at 1e-6 relative (a float32 sum of 2,048 gates in
another order), the LP's loads and captured affinity at 1e-3 relative, and
the LP's imbalance below greedy's.
"""
import contextlib
import io

import numpy as np

from repro_torch.examples import moe_lp_routing
from torch_examples_ref import one_torch_thread, run_reference_in_process

TOL_USAGE = 1e-3


def test_moe_routing_matches_reference():
    ref = run_reference_in_process("moe_lp_routing.py")
    with one_torch_thread():
        got = moe_lp_routing.route(np.asarray(ref["affinity"]), ref["TOPK"],
                                   "cpu")
    np.testing.assert_array_equal(got["greedy_load"], ref["greedy_load"])
    np.testing.assert_allclose(got["greedy_value"], ref["greedy_value"],
                               rtol=1e-6)
    np.testing.assert_allclose(got["lp_load"], ref["lp_load"],
                               rtol=TOL_USAGE, atol=TOL_USAGE * 128)
    np.testing.assert_allclose(got["lp_value"], ref["lp_value"],
                               rtol=TOL_USAGE)
    assert got["lp_imbalance"] < got["greedy_imbalance"]
    assert got["lp_max_load"] <= got["capacity"] * (1 + TOL_USAGE)


def test_moe_routing_main_draws_its_own_affinity():
    with one_torch_thread(), contextlib.redirect_stdout(io.StringIO()):
        got = moe_lp_routing.main(["--device", "cpu"])
    assert got["balanced"] and got["lp_imbalance"] < got["greedy_imbalance"]
    assert sum(got["greedy_load"]) == 1024 * 2
