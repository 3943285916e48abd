"""The port's quickstart example against the reference's
(`examples/quickstart.py`, run in process with `runpy`, JAX on the CPU),
every example's refusal to fall back to the CPU, and the two packages'
`MatchingObjective` defaults.

quickstart: the stop within one check (50), the first and final duals at
1e-4 relative (ROADMAP queue C), the total allocation at 1e-3.
"""
import importlib

import numpy as np
import pytest
import torch

from repro.core import MatchingObjective as RMatching
from repro_torch.core import MatchingObjective
from repro_torch.examples import quickstart
from torch_examples_ref import one_torch_thread, run_reference_in_process

TOL_DUAL = 1e-4
TOL_USAGE = 1e-3
CHECK = 50


def test_matching_objective_defaults_differ_as_recorded():
    """The reference builds scatter by default, the port aligned (ROADMAP
    queue C); the port's examples name the reference example's mode."""
    import jax
    import jax.numpy as jnp
    from repro_torch.convert import lp_to_torch
    from repro_torch.core import InstanceSpec, generate
    lp = generate(InstanceSpec(num_sources=20, num_destinations=4,
                               avg_nnz_per_row=2, seed=0))
    r = RMatching(jax.tree.map(jnp.asarray, lp)).ax_mode
    t = MatchingObjective(lp_to_torch(lp, "cpu")).ax_mode
    assert (r, t) == ("scatter", "aligned")


EXAMPLES = ("quickstart", "moe_lp_routing", "formulations_tour",
            "matching_scale", "chaos_smoke", "allocation_server", "serve_lm")


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_refuse_to_fall_back_to_the_cpu(name):
    """`--device` defaults to the card; without one the example raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])


def test_quickstart_matches_reference(capsys):
    ref = run_reference_in_process("quickstart.py")
    with one_torch_thread():
        got = quickstart.main(["--device", "cpu", "--json"])
    res, d = ref["result"], np.asarray(ref["d"])
    assert got["converged"] and res.converged
    assert got["edges"] == int(sum(int(np.asarray(s.mask).sum())
                                   for s in ref["lp"].slabs))
    assert got["slab_widths"] == [s.width for s in ref["lp"].slabs]
    assert abs(got["iterations_run"] - res.iterations_run) <= CHECK
    np.testing.assert_allclose(got["dual_first"], d[0], rtol=TOL_DUAL)
    np.testing.assert_allclose(got["dual_final"], d[-1], rtol=TOL_DUAL)
    np.testing.assert_allclose(got["total_allocation"], ref["total"],
                               rtol=TOL_USAGE)
    assert got["simplex_ok"]
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("{")
