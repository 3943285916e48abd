"""The port's host-side instance code against the JAX package's.

Generation, slab packing and the value-carrying plan are copied numpy, so
every packed array must be bit-identical (np.array_equal).  Validation
must find the same problems.  Preconditioning runs in torch against jnp:
rtol 1e-6 (float32 sums in another order).  The config dataclasses carry
the same fields and defaults.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import instance as rinst
from repro.core import preconditioning as rprec
from repro.core import types as rtypes
from repro_torch.convert import lp_to_torch
from repro_torch.core import instance as tinst
from repro_torch.core import preconditioning as tprec
from repro_torch.core import types as ttypes

SPECS = [
    dict(num_sources=120, num_destinations=19, avg_nnz_per_row=9, seed=11,
         num_families=2),
    dict(num_sources=2000, num_destinations=100, avg_nnz_per_row=8, seed=42),
    dict(num_sources=700, num_destinations=41, avg_nnz_per_row=5, seed=3,
         num_families=3, min_width=8, budget_s=2.0),
]


def _pair(kw):
    return rinst.generate(rinst.InstanceSpec(**kw)), \
        tinst.generate(tinst.InstanceSpec(**kw))


def _assert_same_tree(a, b):
    la, lb = jax.tree.leaves(a), [x for x in _leaves(b)]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(x, y)


def _leaves(t):
    if isinstance(t, tuple):
        for v in t:
            yield from _leaves(v)
    elif t is not None:
        yield t


@pytest.mark.parametrize("kw", SPECS)
def test_generate_bit_identical(kw):
    r, t = _pair(kw)
    assert len(r.slabs) == len(t.slabs)
    _assert_same_tree(r, t)


@pytest.mark.parametrize("kw", SPECS)
def test_pack_slabs_bit_identical(kw):
    spec_r, spec_t = rinst.InstanceSpec(**kw), tinst.InstanceSpec(**kw)
    src, dst = rinst._edges(spec_r)
    value, a = rinst._coefficients(spec_r, src, dst)
    _assert_same_tree(rinst.pack_slabs(src, dst, value, a, spec_r),
                      tinst.pack_slabs(src, dst, value, a, spec_t))


@pytest.mark.parametrize("kw", SPECS)
def test_build_ax_plan_bit_identical(kw):
    r, t = _pair(kw)
    _assert_same_tree(rinst.build_ax_plan(r, carry_values=True),
                      tinst.build_ax_plan(t))


@pytest.mark.parametrize("kw", SPECS)
def test_build_ax_plan_index_only_bit_identical(kw):
    r, t = _pair(kw)
    plan_t = tinst.build_ax_plan(t, carry_values=False)
    assert all(b.a_dm is None for b in plan_t.buckets)
    _assert_same_tree(rinst.build_ax_plan(r, carry_values=False), plan_t)


def test_validate_lp_same_problems():
    r, t = _pair(SPECS[0])
    assert tinst.validate_lp(t) is t
    bad_b = t.b.copy()
    bad_b[0, 0] = np.nan
    bad_b[1, 2] = -1.0
    s0 = t.slabs[0]
    bad_s = s0._replace(s=np.full_like(s0.s, -1.0),
                        dest_idx=np.where(s0.mask, 99, 0).astype(np.int32))
    bad_t = t._replace(b=bad_b, slabs=(bad_s,) + t.slabs[1:])
    bad_r = r._replace(b=bad_b, slabs=(rtypes.Slab(*bad_s),) + r.slabs[1:])
    with pytest.raises(tinst.LPValidationError) as et:
        tinst.validate_lp(bad_t)
    with pytest.raises(rinst.LPValidationError) as er:
        rinst.validate_lp(bad_r)
    assert et.value.problems == er.value.problems
    assert len(et.value.problems) == 4


@pytest.mark.parametrize("kw", SPECS)
def test_precondition_matches(kw):
    r, t = _pair(kw)
    lp_r, (rs, _) = jax.jit(rprec.precondition)(jax.tree.map(jnp.asarray, r))
    lp_t, (ts, _) = tprec.precondition(lp_to_torch(t, "cpu"), row_norm=True)
    np.testing.assert_allclose(ts.d.numpy(), np.asarray(rs.d), rtol=1e-6)
    np.testing.assert_allclose(lp_t.b.numpy(), np.asarray(lp_r.b), rtol=1e-6)
    for sr, st in zip(lp_r.slabs, lp_t.slabs):
        np.testing.assert_allclose(st.a_vals.numpy(), np.asarray(sr.a_vals),
                                   rtol=1e-6, atol=1e-12)


def test_primal_scale_matches():
    r, t = _pair(SPECS[2])
    lp_r, sr = jax.jit(rprec.primal_scale)(jax.tree.map(jnp.asarray, r))
    lp_t, st = tprec.primal_scale(lp_to_torch(t, "cpu"))
    for a, b in zip(sr.v, st.v):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    for a, b in zip(lp_r.slabs, lp_t.slabs):
        for f in ("a_vals", "c_vals", "ub", "s"):
            np.testing.assert_allclose(getattr(b, f).numpy(),
                                       np.asarray(getattr(a, f)), rtol=1e-6)
    back = tprec.undo_primal_scaling([s.ub for s in lp_t.slabs], st)
    for x, s in zip(back, lp_to_torch(t, "cpu").slabs):
        np.testing.assert_allclose(x.numpy(), s.ub.numpy(), rtol=1e-6)


@pytest.mark.parametrize("name", ["SolveConfig", "StoppingCriteria",
                                  "HealthConfig", "InstanceSpec"])
def test_config_fields_and_defaults(name):
    mod_r = rinst if name == "InstanceSpec" else rtypes
    mod_t = tinst if name == "InstanceSpec" else ttypes
    fr = {f.name: f.default for f in dataclasses.fields(getattr(mod_r, name))}
    ft = {f.name: f.default for f in dataclasses.fields(getattr(mod_t, name))}
    assert fr.keys() == ft.keys()
    for k in fr:
        if k == "dtype":
            assert ft[k] == torch.float32
        else:
            assert fr[k] == ft[k], k


def test_stop_reasons_and_records_match():
    assert ({e.name: e.value for e in rtypes.StopReason}
            == {e.name: e.value for e in ttypes.StopReason})
    for name in ("ConvergenceCheck", "SolveState", "IterStats"):
        assert getattr(rtypes, name)._fields == getattr(ttypes, name)._fields
