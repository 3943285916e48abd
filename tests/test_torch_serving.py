"""The port's serving subsystem (`repro_torch.primal`: row-subset recovery,
streaming extraction, the shard round trip, the allocation server and its
warm-resolve hook) against the JAX package's, mirroring
tests/test_primal_serving.py for `matching` and `multi_budget`.

One instance (150 × 16, ν = 10, seed 3, two families) is generated by
both packages from the same spec.  Tolerances: the port's served and
extracted rows equal its own `primal` bit for bit (the load-bearing claim:
per-row math is independent of the batch split); against the reference,
x within 1e-5 at γ = 0.1 (x resolves to an ulp of u, ROADMAP queue C, so
no smaller γ); routing and layout (slab indices, starts, source ids, dest
ids, masks, shard names) exactly.
"""
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import formulations as rformulations
from repro import primal as rprimal
from repro.core import MatchingObjective as RMatching
from repro.core import instance as rinst
from repro.core import precondition as rprecondition
from repro_torch import formulations, primal
from repro_torch.convert import lp_to_torch
from repro_torch.core import (InstanceSpec, MatchingObjective, Maximizer,
                              SolveConfig, StoppingCriteria, generate,
                              precondition)
from repro_torch.testing import ExplodingObjective, SlowObjective

SPEC = dict(num_sources=150, num_destinations=16, avg_nnz_per_row=10,
            seed=3, num_families=2)
GAMMA_PARITY = 0.1
TOL_X = 1e-5
CFG = SolveConfig(iterations=8000, gamma=0.05, gamma_init=0.8,
                  gamma_decay_every=25, max_step=20.0, initial_step=1e-3)
CRIT = StoppingCriteria(tol_rel_dual=1e-6, check_every=50)
GAMMA = CFG.gamma
FORMS = ("matching", "multi_budget")


@pytest.fixture(scope="module")
def lps():
    lp_r = jax.tree.map(jnp.asarray, rinst.generate(rinst.InstanceSpec(**SPEC)))
    lp_t = lp_to_torch(generate(InstanceSpec(**SPEC)), "cpu")
    return lp_r, lp_t


def _objectives(lps, form):
    lp_r, lp_t = lps
    if form == "matching":
        return (RMatching(rprecondition(lp_r, row_norm=True)[0],
                          ax_mode="aligned"),
                MatchingObjective(precondition(lp_t, row_norm=True)[0],
                                  ax_mode="aligned"))
    return (rformulations.make_objective(form, lp_r, ax_mode="aligned",
                                         row_norm=True),
            formulations.make_objective(form, lp_t, ax_mode="aligned",
                                        row_norm=True))


@pytest.fixture(scope="module", params=FORMS)
def pair(request, lps):
    """(form, reference objective, port objective, a random λ ≥ 0)."""
    obj_r, obj_t = _objectives(lps, request.param)
    lam = np.random.default_rng(0).uniform(
        0.0, 0.5, size=obj_t.dual_shape).astype(np.float32)
    return request.param, obj_r, obj_t, lam


@pytest.fixture(scope="module")
def solved_mb(lps):
    """The port's multi_budget objective and its converged SolveResult."""
    obj = formulations.make_objective("multi_budget", lps[1],
                                      ax_mode="aligned", row_norm=True)
    res = Maximizer(CFG).maximize(obj, criteria=CRIT)
    assert res.converged
    return obj, res


def _full(obj, lam, gamma):
    return [x.numpy() for x in obj.primal(torch.as_tensor(lam),
                                          torch.tensor(gamma))]


class TestPrimalRows:
    def test_bitwise_vs_own_primal_and_near_reference(self, pair):
        _, obj_r, obj_t, lam = pair
        full = _full(obj_t, lam, GAMMA_PARITY)
        rng = np.random.default_rng(1)
        for si, slab in enumerate(obj_t.lp.slabs):
            rows = rng.choice(slab.n, size=min(7, slab.n), replace=False)
            x = obj_t.primal_rows(torch.from_numpy(lam),
                                  torch.tensor(GAMMA_PARITY), si,
                                  torch.from_numpy(rows)).numpy()
            np.testing.assert_array_equal(x, full[si][rows])
            x_r = np.asarray(obj_r.primal_rows(
                jnp.asarray(lam), jnp.float32(GAMMA_PARITY), si,
                jnp.asarray(rows)))
            np.testing.assert_allclose(x, x_r, rtol=0, atol=TOL_X)

    def test_duplicate_rows_allowed(self, pair):
        _, _, obj_t, lam = pair
        x = obj_t.primal_rows(torch.from_numpy(lam),
                              torch.tensor(GAMMA_PARITY), 0,
                              torch.tensor([0, 0, 1, 1])).numpy()
        np.testing.assert_array_equal(x[0], x[1])
        np.testing.assert_array_equal(x[2], x[3])


class TestStreamingExtraction:
    def test_chunks_match_reference(self, pair):
        """chunk_rows 13 leaves a clamped tail window in every slab."""
        _, obj_r, obj_t, lam = pair
        assert all(s.n % 13 for s in obj_t.lp.slabs)
        got = list(primal.iter_primal_chunks(obj_t, lam, GAMMA_PARITY,
                                             chunk_rows=13))
        ref = list(rprimal.iter_primal_chunks(
            obj_r, jnp.asarray(lam), jnp.float32(GAMMA_PARITY),
            chunk_rows=13))
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert (a.slab_index, a.start) == (b.slab_index, b.start)
            for f in ("source_ids", "dest_idx", "mask"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert a.x.shape == b.x.shape == a.dest_idx.shape
            np.testing.assert_allclose(a.x, b.x, rtol=0, atol=TOL_X)

    def test_chunked_equals_batch_bitwise(self, pair):
        _, _, obj_t, lam = pair
        full = _full(obj_t, lam, GAMMA_PARITY)
        for rows in (1, 17, 4096):
            xs = primal.extract_primal(obj_t, lam, GAMMA_PARITY,
                                       chunk_rows=rows)
            for a, b in zip(full, xs):
                np.testing.assert_array_equal(a, b)

    def test_chunk_stream_covers_each_row_once(self, pair):
        _, _, obj_t, lam = pair
        seen = {si: np.zeros(s.n, int) for si, s in enumerate(obj_t.lp.slabs)}
        for ch in primal.iter_primal_chunks(obj_t, lam, GAMMA_PARITY,
                                            chunk_rows=13):
            seen[ch.slab_index][ch.start:ch.start + len(ch.x)] += 1
        assert all((c == 1).all() for c in seen.values())

    def test_write_shards_matches_reference(self, pair, tmp_path):
        _, obj_r, obj_t, lam = pair
        paths = primal.write_shards(obj_t, lam, GAMMA_PARITY,
                                    str(tmp_path / "port"), chunk_rows=23)
        ref = rprimal.write_shards(obj_r, jnp.asarray(lam),
                                   jnp.float32(GAMMA_PARITY),
                                   str(tmp_path / "ref"), chunk_rows=23)
        assert ([os.path.basename(p) for p in paths]
                == [os.path.basename(p) for p in ref])
        for p, q in zip(paths, ref):
            with np.load(p) as a, np.load(q) as b:
                assert sorted(a.files) == sorted(b.files)
                for f in a.files:
                    if f == "x":
                        np.testing.assert_allclose(a[f], b[f], rtol=0,
                                                   atol=TOL_X)
                    else:
                        np.testing.assert_array_equal(a[f], b[f])
                        assert a[f].dtype == b[f].dtype

    def test_shard_round_trip_with_rounder(self, pair, tmp_path):
        _, _, obj_t, lam = pair
        paths = primal.write_shards(
            obj_t, lam, GAMMA_PARITY, str(tmp_path), chunk_rows=23,
            rounder=lambda ch: np.where(ch.x > 0.5, 1.0, 0.0))
        full = _full(obj_t, lam, GAMMA_PARITY)
        n = len(obj_t.lp.slabs)
        for a, b in zip(full, primal.read_shards(paths, n)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(full, primal.read_shards(paths, n, key="x_round")):
            np.testing.assert_array_equal(np.where(a > 0.5, 1.0, 0.0), b)


def _rewrite(path, **changes):
    with np.load(path) as z:
        payload = {k: z[k] for k in z.files}
    for k, v in changes.items():
        if v is None:
            payload.pop(k)
        else:
            payload[k] = v(payload)
    np.savez(path, **payload)


def _truncate(path):
    size = os.path.getsize(path)
    with open(path, "rb+") as f:
        f.truncate(max(size // 2, 1))


def _garbage(path):
    with open(path, "wb") as f:
        f.write(b"definitely not a zipfile")


# case -> (damage(paths) -> the offending path, key read, message)
DAMAGE = {
    "missing": (lambda p: (os.remove(p[0]), p[0])[1], "x", "shard missing"),
    "truncated": (lambda p: (_truncate(p[0]), p[0])[1], "x", "unreadable"),
    "garbage": (lambda p: (_garbage(p[1]), p[1])[1], "x", "unreadable"),
    "missing_key": (lambda p: p[0], "x_round", "missing array 'x_round'"),
    "missing_meta": (lambda p: (_rewrite(p[0], start=None), p[0])[1], "x",
                     "missing array 'start'"),
    "slab_out_of_range": (lambda p: (_rewrite(
        p[0], slab_index=lambda z: np.int64(99)), p[0])[1], "x",
        "out of range"),
    "not_2d": (lambda p: (_rewrite(p[0], x=lambda z: z["x"].reshape(-1)),
                          p[0])[1], "x", "expected \\(rows, w\\)"),
}


class TestReadShardsHardening:
    """A damaged export fails loudly, naming the offending shard."""

    @pytest.fixture()
    def shards(self, lps, tmp_path):
        _, obj = _objectives(lps, "multi_budget")
        lam = np.zeros(obj.dual_shape, np.float32)
        paths = primal.write_shards(obj, lam, GAMMA, str(tmp_path),
                                    chunk_rows=40)
        assert len(paths) >= 3
        return obj, paths

    @pytest.mark.parametrize("case", sorted(DAMAGE))
    def test_damage_named(self, shards, case):
        obj, paths = shards
        damage, key, msg = DAMAGE[case]
        bad = damage(paths)
        with pytest.raises(ValueError, match=msg) as e:
            primal.read_shards(paths, len(obj.lp.slabs), key=key)
        assert bad in str(e.value)

    def test_width_mismatch_named(self, shards):
        obj, paths = shards
        by_slab = {}
        for p in paths:
            with np.load(p) as z:
                by_slab.setdefault(int(z["slab_index"]), []).append(p)
        bad = next(v for v in by_slab.values() if len(v) >= 2)[1]
        _rewrite(bad, x=lambda z: z["x"][:, :-1])
        with pytest.raises(ValueError, match="width mismatch") as e:
            primal.read_shards(paths, len(obj.lp.slabs))
        assert bad in str(e.value)

    def test_clean_export_round_trips(self, shards):
        obj, paths = shards
        xs = primal.read_shards(paths, len(obj.lp.slabs))
        assert all(x is not None for x in xs)
        # a partial export leaves the unexported slabs None
        part = primal.read_shards(paths[:1], len(obj.lp.slabs))
        assert part[0] is not None and part[-1] is None


class TestAllocationServer:
    def test_query_bitwise_vs_extraction(self, pair):
        _, _, obj_t, lam = pair
        xs = primal.extract_primal(obj_t, lam, GAMMA, chunk_rows=64)
        srv = primal.AllocationServer(obj_t, lam, GAMMA, max_batch=8)
        ids = srv.source_ids()
        picked = np.random.default_rng(2).choice(
            ids, size=40, replace=False).tolist()
        decisions = srv.query(picked)
        assert set(decisions) == set(picked)
        for sid, d in decisions.items():
            assert d.source_id == sid
            np.testing.assert_array_equal(d.x, xs[d.slab_index][d.row])
            slab = obj_t.lp.slabs[d.slab_index]
            assert int(slab.source_ids[d.row]) == sid
            np.testing.assert_array_equal(d.dest_idx,
                                          slab.dest_idx[d.row].numpy())
            np.testing.assert_array_equal(d.mask, slab.mask[d.row].numpy())

    def test_routes_match_reference(self, pair):
        _, obj_r, obj_t, lam = pair
        srv = primal.AllocationServer(obj_t, lam, GAMMA)
        ref = rprimal.AllocationServer(obj_r, jnp.asarray(lam), GAMMA)
        np.testing.assert_array_equal(srv.source_ids(), ref.source_ids())
        probe = [int(srv.source_ids()[0]), -5, 10 ** 9, 3]
        assert srv.unknown_sources(probe) == ref.unknown_sources(probe)

    def test_warmup_and_metric_keys_match_reference(self, pair):
        _, obj_r, obj_t, lam = pair
        srv = primal.AllocationServer(obj_t, lam, GAMMA, max_batch=16)
        ref = rprimal.AllocationServer(obj_r, jnp.asarray(lam), GAMMA,
                                       max_batch=16)
        assert srv.warmup() == ref.warmup() > 0
        assert srv.metrics_snapshot().keys() == ref.metrics_snapshot().keys()
        assert srv.metrics_snapshot()["warmup_kernels_total"] == \
            ref.metrics_snapshot()["warmup_kernels_total"]
        assert primal.QueryStats._fields == rprimal.QueryStats._fields
        assert primal.DecisionRow._fields == rprimal.DecisionRow._fields

    def test_latency_stats_recorded(self, pair):
        _, _, obj_t, lam = pair
        srv = primal.AllocationServer(obj_t, lam, GAMMA)
        ids = srv.source_ids()[:5].tolist()
        srv.query(ids)
        srv.query(ids)
        st = srv.stats()
        assert st.queries == 2 and st.sources == 10
        assert st.mean_ms > 0 and st.sources_per_s > 0
        srv.reset_stats()
        assert srv.stats().queries == 0
        assert srv.metrics_snapshot()["queries_total"] == 2  # lifetime

    def test_unknown_source_raises(self, pair):
        _, _, obj_t, lam = pair
        srv = primal.AllocationServer(obj_t, lam, GAMMA)
        with pytest.raises(KeyError):
            srv.query([int(srv.source_ids()[0]), 10 ** 9])
        assert srv.stats().queries == 0

    def test_update_duals(self, pair):
        _, _, obj_t, lam = pair
        srv = primal.AllocationServer(obj_t, lam, GAMMA)
        with pytest.raises(ValueError, match="dual shape"):
            srv.update_duals(torch.zeros(3))
        lam2 = lam * 0.5
        srv.update_duals(lam2)
        xs = primal.extract_primal(obj_t, lam2, GAMMA)
        for d in srv.query(srv.source_ids()[:9].tolist()).values():
            np.testing.assert_array_equal(d.x, xs[d.slab_index][d.row])

    def test_server_owns_its_duals(self, pair):
        _, _, obj_t, lam = pair
        mine = torch.from_numpy(lam.copy())
        srv = primal.AllocationServer(obj_t, mine, GAMMA)
        mine.zero_()
        np.testing.assert_array_equal(srv.lam.numpy(), lam)


class TestWarmResolve:
    def test_skips_continuation_and_starts_at_the_optimum(self, solved_mb):
        obj, res = solved_mb
        srv = primal.AllocationServer(obj, res.lam, GAMMA, config=CFG)
        warm = srv.warm_resolve(criteria=CRIT)
        assert warm is not None and warm.converged
        # continuation stripped: the very first iteration runs at target γ
        assert float(warm.stats.gamma[0]) == pytest.approx(CFG.gamma)
        # the head start: the first step is already at the cold solve's
        # final dual (the cold start's first one is far from it)
        final = float(res.stats.dual_obj[-1])
        assert abs(float(warm.stats.dual_obj[0]) - final) <= \
            1e-3 * abs(final)
        assert abs(float(res.stats.dual_obj[0]) - final) > 1e-1 * abs(final)
        np.testing.assert_array_equal(srv.lam.numpy(), warm.lam.numpy())
        assert srv.metrics_snapshot()["resolve_successes_total"] == 1

    def test_instance_update_with_certificate(self, solved_mb, lps):
        obj, res = solved_mb
        srv = primal.AllocationServer(obj, res.lam, GAMMA, config=CFG)
        used = primal.certify(obj, res.lam, GAMMA).slacks["count_cap"].used
        tight = formulations.make_objective(
            "multi_budget", lps[1], params=dict(count_cap=0.8 * used),
            ax_mode="aligned", row_norm=True)
        warm = srv.warm_resolve(criteria=CRIT, obj=tight,
                                require_certificate=True)
        assert warm is not None and warm.converged
        assert srv.obj is tight
        cert = primal.certify(tight, srv.lam, GAMMA)
        assert cert.valid
        assert cert.slacks["count_cap"].used <= 0.8 * used * (1 + 1e-6)
        xs = primal.extract_primal(tight, srv.lam, GAMMA)
        for d in srv.query(srv.source_ids()[::7].tolist()).values():
            np.testing.assert_array_equal(d.x, xs[d.slab_index][d.row])

    def test_rejects_shape_change(self, solved_mb, lps):
        obj, res = solved_mb
        srv = primal.AllocationServer(obj, res.lam, GAMMA, config=CFG)
        other = formulations.make_objective("matching", lps[1],
                                            row_norm=True)
        with pytest.raises(ValueError, match="dual shape"):
            srv.warm_resolve(obj=other)

    def test_failure_keeps_serving_then_backoff_then_force(self, solved_mb):
        obj, res = solved_mb
        srv = primal.AllocationServer(obj, res.lam, GAMMA, config=CFG,
                                      retry_backoff_s=60.0)
        before = srv.query(srv.source_ids()[:6].tolist())
        lam0 = srv.lam.clone()
        assert srv.warm_resolve(criteria=CRIT,
                                obj=ExplodingObjective(obj)) is None
        assert "RuntimeError" in srv.last_failure_reason
        st = srv.stats()
        assert st.degraded and st.resolve_failures == 1
        assert st.consecutive_failures == 1
        assert srv.obj is obj                      # last-good pair kept
        assert torch.equal(srv.lam, lam0)
        after = srv.query(srv.source_ids()[:6].tolist())
        for sid in before:
            np.testing.assert_array_equal(before[sid].x, after[sid].x)
        # inside the backoff window a retry is skipped, not attempted
        assert srv.warm_resolve(criteria=CRIT) is None
        snap = srv.metrics_snapshot()
        assert snap["resolve_skipped_total"] == 1
        assert snap["resolve_attempts_total"] == 1 and snap["degraded"] == 1
        # force bypasses the gate; success clears the degraded state
        warm = srv.warm_resolve(criteria=CRIT, force=True)
        assert warm is not None and warm.converged
        st = srv.stats()
        assert not st.degraded and st.consecutive_failures == 0
        assert st.resolve_failures == 1

    def test_backoff_doubles_and_caps(self, solved_mb):
        obj, res = solved_mb
        srv = primal.AllocationServer(obj, res.lam, GAMMA, config=CFG,
                                      retry_backoff_s=1.0, max_backoff_s=3.0)
        boom = ExplodingObjective(obj)
        waits = []
        for _ in range(4):
            srv.warm_resolve(obj=boom, force=True)
            waits.append(srv._next_retry_at - time.monotonic())
        assert [round(w) for w in waits] == [1, 2, 3, 3]

    def test_second_resolve_in_flight_is_skipped(self, solved_mb):
        obj, res = solved_mb
        srv = primal.AllocationServer(obj, res.lam, GAMMA, config=CFG)
        slow = SlowObjective(obj, delay_s=0.02, slow_calculate=True,
                             slow_primal_rows=False)
        out = {}
        t = threading.Thread(target=lambda: out.setdefault(
            "res", srv.warm_resolve(
                criteria=StoppingCriteria(max_iterations=40), obj=slow)))
        t.start()
        while slow.calls == 0 and t.is_alive():
            t.join(0.005)
        assert srv.warm_resolve(criteria=CRIT) is None
        t.join(60.0)
        assert not t.is_alive()
        assert out["res"] is not None and slow.calls > 0
        snap = srv.metrics_snapshot()
        assert snap["resolve_skipped_total"] == 1
        assert snap["resolve_successes_total"] == 1
        assert srv.obj is slow

    def test_require_certificate_rejects_invalid(self, lps):
        """assignment_eq's witness breaks Σx = s under the repair, so its
        certificate is INVALID in both packages: the re-solve is refused
        and the served pair stays."""
        obj = formulations.make_objective("assignment_eq", lps[1],
                                          ax_mode="aligned", row_norm=True)
        srv = primal.AllocationServer(
            obj, torch.zeros(obj.dual_shape), GAMMA,
            config=SolveConfig(iterations=20, gamma=GAMMA, max_step=0.5))
        assert srv.warm_resolve(require_certificate=True) is None
        assert srv.last_failure_reason == \
            "re-solved duals failed certification"
        assert float(srv.lam.abs().max()) == 0.0
        assert srv.warm_resolve(force=True) is not None   # no cert asked
