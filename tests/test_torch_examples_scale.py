"""The port's matching_scale example (`repro_torch.examples.
matching_scale --sources 20000 --iterations 100`) against the reference's
trajectory: the reference example's single-device solve
(`examples/matching_scale.py`: its instance, row normalization,
SolveConfig and aligned objective), run in a thread beside the port's.

Held: the dual at every 25th iteration and at the last at 1e-4 relative
(ROADMAP queue C; measured ≤ 3.5e-5 over the whole trajectory: at this
example's max_step 0.1 the packages do not part, unlike agd at 10-20),
and the port's distributed run on a one-rank gloo group against its
single-device run at the example's own criterion, < 1e-2 (it is 0).
"""
import contextlib
import io
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import torch.distributed as dist

from repro.core import InstanceSpec as RSpec
from repro.core import MatchingObjective as RMatching
from repro.core import Maximizer as RMaximizer
from repro.core import SolveConfig as RConfig
from repro.core import generate as rgenerate
from repro.core import precondition as rprecondition
from repro_torch.examples import matching_scale
from torch_examples_ref import one_torch_thread

SOURCES, ITERATIONS = 20000, 100
TOL_DUAL = 1e-4


def _reference_trajectory():
    spec = RSpec(num_sources=SOURCES, num_destinations=2000,
                 avg_nnz_per_row=max(SOURCES * 0.001, 8), seed=42)
    lp = rprecondition(jax.tree.map(jnp.asarray, rgenerate(spec)),
                       row_norm=True)[0]
    cfg = RConfig(iterations=ITERATIONS, gamma=0.01, gamma_init=0.16,
                  gamma_decay_every=25, max_step=1e-1, initial_step=1e-5)
    res = RMaximizer(cfg).maximize(RMatching(lp, ax_mode="aligned"))
    return np.asarray(res.stats.dual_obj, np.float64)


def test_matching_scale_matches_reference_trajectory():
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(_reference_trajectory)
        with one_torch_thread(), contextlib.redirect_stdout(io.StringIO()):
            got = matching_scale.main(
                ["--device", "cpu", "--sources", str(SOURCES),
                 "--iterations", str(ITERATIONS), "--json"])
        want = ref.result()
    d = np.asarray(got["dual_trajectory"])
    assert d.shape == want.shape == (ITERATIONS,)
    at = list(range(0, ITERATIONS, 25)) + [ITERATIONS - 1]
    np.testing.assert_allclose(d[at], want[at], rtol=TOL_DUAL)
    assert got["distributed_rel_err"] < 1e-2
    assert got["ranks"] == 1
    assert not dist.is_initialized()      # the example's group is gone
