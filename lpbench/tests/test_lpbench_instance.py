"""The benchmark's generator: deterministic by seed, and the Appendix B
law on a tiny instance, and its packing into the program's slabs."""
import pytest
import torch

from lpbench.instance import (generate, hash_lognormal, instance, relabel,
                              splitmix64, to_port_lp)

SPEC = {"num_sources": 400, "num_destinations": 30, "avg_nnz_per_row": 6,
        "num_families": 2, "c_max": 10.0, "breadth_sigma": 1.0,
        "value_sigma": 0.5, "noise_sigma": 0.25, "scale_sigma": 1.0,
        "rho_low": 0.5, "rho_high": 1.0, "rhs_eps": 1e-3, "budget_s": 1.0,
        "box_ub": 1.0, "min_width": 4}
BIG_SEED = 2**31 + 12345


@pytest.fixture(scope="module")
def raw():
    return generate(SPEC, BIG_SEED, "cpu")


def test_same_seed_same_arrays(raw):
    again = generate(SPEC, BIG_SEED, "cpu")
    for f in raw._fields:
        a, b = getattr(raw, f), getattr(again, f)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f
    other = generate(SPEC, BIG_SEED + 1, "cpu")
    assert not torch.equal(raw.value[:10], other.value[:10])


def test_edges_distinct_and_sorted(raw):
    J = SPEC["num_destinations"]
    key = raw.src * J + raw.dst
    assert torch.all(key[1:] > key[:-1])          # sorted, no repeat
    assert raw.src.min() >= 0 and raw.src.max() < SPEC["num_sources"]
    # sources, their first edge and degree describe the edge list
    assert int(raw.deg.sum()) == raw.num_edges
    assert torch.equal(raw.src[raw.start], raw.sources)
    assert raw.num_edges == pytest.approx(
        SPEC["num_sources"] * SPEC["avg_nnz_per_row"], rel=0.25)


def test_value_and_coefficient_law(raw):
    assert bool((raw.value > 0).all())
    assert float(raw.value.max()) <= SPEC["c_max"]
    # a_k = s_kj · value: the ratio is one number per (family, destination)
    ratio = (raw.a / raw.value[None, :]).double()
    for k in range(SPEC["num_families"]):
        for j in torch.unique(raw.dst)[:10].tolist():
            r = ratio[k, raw.dst == j]
            assert float(r.max() - r.min()) <= 1e-6 * float(r.max())
    assert bool((raw.b > 0).all())


def test_greedy_rhs(raw):
    """b_kj / rho_kj lies between rhs_eps and the load of every source's
    largest-a_k edge; summed over j, at most the whole greedy load."""
    for k in range(SPEC["num_families"]):
        best = torch.zeros(raw.sources.numel(), dtype=torch.float64)
        row = torch.repeat_interleave(torch.arange(raw.sources.numel()),
                                      raw.deg)
        best = best.scatter_reduce(0, row, raw.a[k].double(), "amax")
        total = float(best.sum()) + SPEC["rhs_eps"] * SPEC["num_destinations"]
        b = raw.b[k].double()
        assert float(b.sum()) <= total * 1.0000001
        assert float(b.sum()) >= SPEC["rho_low"] * (total - SPEC["rhs_eps"]
                                                   * SPEC["num_destinations"])


def test_hash_noise_is_keyed_by_edge():
    src = torch.tensor([0, 1, 5, 5], dtype=torch.int64)
    dst = torch.tensor([3, 3, 7, 7], dtype=torch.int64)
    eps = hash_lognormal(9, src, dst, 0.25)
    assert eps[2] == eps[3] and eps[0] != eps[1]
    # splitmix64 of 0 (the published first output for seed 0)
    assert int(splitmix64(torch.tensor([0]))[0]) & (2**64 - 1) == \
        0xE220A8397B1DCDAF


def test_port_slabs_hold_every_edge_once(raw):
    lp = to_port_lp(raw, SPEC["min_width"])
    seen = []
    for s in lp.slabs:
        assert s.width >= SPEC["min_width"]
        assert s.width & (s.width - 1) == 0
        deg = s.mask.sum(1)
        assert bool((deg > s.width // 2).all() | (s.width == SPEC["min_width"]))
        src = s.source_ids.long()[:, None].expand_as(s.mask)[s.mask]
        seen.append(src * SPEC["num_destinations"]
                    + s.dest_idx.long()[s.mask])
        assert torch.equal(-s.c_vals[s.mask],
                           raw.value[torch.isin(raw.src, s.source_ids.long())])
    key = torch.sort(torch.cat(seen)).values
    assert torch.equal(key, raw.src * SPEC["num_destinations"] + raw.dst)
    assert torch.equal(lp.b, raw.b)


def test_relabelled_instance_is_the_same_lp(raw):
    """Another seed renames sources and destinations: the same multiset of
    values, degrees and right-hand sides, in another order."""
    other = relabel(raw, 7)
    assert torch.equal(torch.sort(other.value).values,
                       torch.sort(raw.value).values)
    assert torch.equal(torch.sort(other.deg).values,
                       torch.sort(raw.deg).values)
    assert torch.equal(torch.sort(other.b.reshape(-1)).values,
                       torch.sort(raw.b.reshape(-1)).values)
    assert not torch.equal(other.value, raw.value)
    J = SPEC["num_destinations"]
    key = other.src * J + other.dst
    assert torch.all(key[1:] > key[:-1])
    assert torch.equal(other.src[other.start], other.sources)
    spec = dict(SPEC, instance_seed=BIG_SEED)
    assert torch.equal(instance(spec, 7, "cpu").value, other.value)
