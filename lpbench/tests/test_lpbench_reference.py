"""The plain reference against a case worked by hand, and the byte bound
of the roofline against a count by hand."""
import math

import pytest
import torch

from lpbench.instance import Raw
from lpbench.reference.check import judge, verdict
from lpbench.reference.lp import ReferenceLP, kkt_residual
from lpbench.roofline import evaluation_bytes


def hand_raw(a=(1.0, 1.0, 1.0)):
    """Two sources, two destinations, m = 1: edges (0, 0), (0, 1), (1, 0)
    of value 2, 1, 3; ub = s = 1; b = (1, 1)."""
    i64 = torch.int64
    return Raw(num_sources=2,
               src=torch.tensor([0, 0, 1], dtype=i64),
               dst=torch.tensor([0, 1, 0], dtype=i64),
               value=torch.tensor([2.0, 1.0, 3.0]),
               a=torch.tensor([list(a)]),
               ub=torch.ones(3), sources=torch.tensor([0, 1], dtype=i64),
               start=torch.tensor([0, 2], dtype=i64),
               deg=torch.tensor([2, 1], dtype=i64), s=torch.ones(2),
               b=torch.tensor([[1.0, 1.0]]))


MATCHING = {"row_norm": False, "coupling_rows": []}
COUNT = {"row_norm": False, "coupling_rows": [
    {"label": "count_cap", "weight": "count", "limit_frac": 0.5,
     "of": "sum_s"}]}


def test_matching_by_hand():
    """At lam = (0.5, 0.25), gamma = 1: u = (1.5, 0.75 | 2.5); source 0
    is over its budget, tau = 0.625, x = (0.875, 0.125 | 1)."""
    ref = ReferenceLP(hand_raw(), MATCHING)
    lam = torch.tensor([[0.5, 0.25]])
    g, grad = ref.evaluate(lam, 1.0)
    assert grad.tolist() == pytest.approx([0.875, -0.875], abs=1e-15)
    # c'x = -4.875, |x|^2 / 2 = 0.890625, lam'grad = 0.21875
    assert g == pytest.approx(-3.765625, abs=1e-14)
    assert kkt_residual(lam, grad) == pytest.approx(math.sqrt(0.828125))


def test_count_row_by_hand():
    """A count row at half of sum s (limit 1) with mu = 0.1 shifts every u
    by -0.1: source 0's tau moves with it, x stays, sum x = 2."""
    ref = ReferenceLP(hand_raw(), COUNT)
    g, grad = ref.evaluate(torch.tensor([0.5, 0.25, 0.1],
                                        dtype=torch.float64), 1.0)
    assert grad.tolist() == pytest.approx([0.875, -0.875, 1.0], abs=1e-14)
    assert g == pytest.approx(-3.665625, abs=1e-14)


def test_row_normalization_by_hand():
    """Row norms |A_j| = (sqrt 2, 1): a' and b' are divided by them."""
    ref = ReferenceLP(hand_raw(), {"row_norm": True, "coupling_rows": []})
    assert ref.b.reshape(-1).tolist() == pytest.approx([2 ** -0.5, 1.0])
    value = {"row_norm": True, "coupling_rows": [
        {"label": "value_cap", "weight": "value", "limit_frac": 0.4,
         "of": "sum_s_max_value"}]}
    ref = ReferenceLP(hand_raw(), value)
    # 0.4 · (1 · max(2, 1) + 1 · 3) over |value| = sqrt(14)
    assert float(ref.limits[0]) == pytest.approx(0.4 * 5 / 14 ** 0.5)


def test_projection_meets_the_budget():
    g = torch.Generator().manual_seed(3)
    u = torch.randn((64, 16), generator=g, dtype=torch.float64) * 3
    ub = torch.rand((64, 16), generator=g, dtype=torch.float64) + 0.2
    s = torch.rand(64, generator=g, dtype=torch.float64) * 4
    ref = ReferenceLP(hand_raw(), MATCHING)
    x = ref._boxcut(u, ub, s)
    assert bool(((x >= 0) & (x <= ub)).all())
    free = torch.minimum(torch.clamp_min(u, 0), ub).sum(1)
    tight = free > s
    assert torch.allclose(x.sum(1)[tight], s[tight], rtol=0, atol=1e-12)
    assert torch.equal(x[~tight], torch.minimum(torch.clamp_min(u, 0),
                                                ub)[~tight])


def test_judge_reads_each_number():
    """The reference's own answer reads 0 on dual_rel and grad_rel; lam =
    0 reads kkt_rel 1; a wrong reported value or gradient reads its
    gap."""
    ref = ReferenceLP(hand_raw(), MATCHING)
    lam = torch.tensor([[0.5, 0.25]])
    g, grad = ref.evaluate(lam, 1.0)
    good = judge(ref, [{"lam": lam, "dual": g, "gamma": 1.0, "grad": grad}])
    assert good["dual_rel"] == 0.0 and good["grad_rel"] == 0.0
    zero = torch.zeros_like(lam)
    g0, grad0 = ref.evaluate(zero, 1.0)
    assert judge(ref, [{"lam": zero, "dual": g0, "gamma": 1.0,
                        "grad": grad0}])["kkt_rel"] == 1.0
    bad = judge(ref, [{"lam": lam, "dual": g * 1.01, "gamma": 1.0,
                       "grad": grad + 0.1}])
    assert bad["dual_rel"] == pytest.approx(0.01)
    assert bad["grad_rel"] == pytest.approx(0.1 * 2 ** 0.5 / 2 ** 0.5)
    limits = {"dual_rel": 1e-3, "grad_rel": 1e-3, "kkt_rel": 2.0}
    assert verdict(good, limits) and not verdict(bad, limits)
    assert not verdict(dict(good, dual_rel=float("nan")), limits)


def test_byte_bound_by_hand():
    """3 real edges at m = 2: 3 · (8 + 12) = 60; 2 sources: 8; 4 dual
    rows read and written: 32."""
    assert evaluation_bytes(3, 2, 2, 4) == 60 + 8 + 32
    # the main path's instance at seed 42 of the program's generator
    assert evaluation_bytes(50_012_864, 2_000_000, 1, 10_000) == \
        50_012_864 * 16 + 8_000_000 + 80_000
