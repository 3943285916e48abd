"""C2: `repro_torch.core` exports `gram_condition_number` and `HealthRecord`
as `repro.core` does, and κ(AAᵀ) equals the reference's.

Both functions get the same LP (one generated instance, raw and
row-normalized by the port), so they sum the same float32 products into
the same float64 Gram in the same order: κ is held at rtol 1e-10.  The
products are float32 in both packages, and on a Gram with near-null
directions their rounding sets the smallest eigenvalue kept (κ ~1e11 at
two families here, ~3e4 at one); the port keeps that arithmetic.
"""
import numpy as np
import pytest

import repro.core as rcore
import repro_torch.core as tcore
from repro_torch.convert import lp_to_numpy, lp_to_torch

RTOL = 1e-10
SPECS = {"one_family": dict(num_sources=120, num_destinations=15,
                            avg_nnz_per_row=6, seed=5, num_families=1),
         "two_families": dict(num_sources=120, num_destinations=15,
                              avg_nnz_per_row=6, seed=5, num_families=2)}


@pytest.mark.parametrize("name", ["gram_condition_number", "HealthRecord"])
def test_core_exports_reference_names(name):
    assert hasattr(rcore, name)
    assert hasattr(tcore, name)
    assert name in tcore.__all__


def test_health_record_fields_match_reference():
    assert tcore.HealthRecord._fields == rcore.HealthRecord._fields


@pytest.mark.parametrize("row_norm", [False, True], ids=["raw", "row_norm"])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_gram_condition_number_matches_reference(spec, row_norm):
    lp = lp_to_torch(tcore.generate(tcore.InstanceSpec(**SPECS[spec])), "cpu")
    if row_norm:
        lp = tcore.precondition(lp, row_norm=True)[0]
    got = tcore.gram_condition_number(lp)
    want = rcore.gram_condition_number(lp_to_numpy(lp))
    assert np.isfinite(got) and got >= 1.0
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_gram_condition_number_reads_numpy_leaves():
    lp_np = tcore.generate(tcore.InstanceSpec(**SPECS["one_family"]))
    assert (tcore.gram_condition_number(lp_np)
            == tcore.gram_condition_number(lp_to_torch(lp_np, "cpu")))


def test_row_normalization_lowers_the_condition_number():
    """Lemma 5.1's direction on a one-family instance, whose κ (~3e4) the
    float32 rounding does not decide."""
    lp = lp_to_torch(tcore.generate(tcore.InstanceSpec(
        **SPECS["one_family"])), "cpu")
    raw = tcore.gram_condition_number(lp)
    scaled = tcore.gram_condition_number(
        tcore.precondition(lp, row_norm=True)[0])
    assert scaled < raw
