"""The port's traffic-hardened serving frontend (`repro_torch.primal.
frontend`, DESIGN.md §12), mirroring tests/test_frontend.py on the port.

Covers the admission/batching/deadline/drain state machine end to end:
every submitted request terminates in exactly one of OK / SHED /
TIMEOUT / ERROR, OK responses are bitwise equal to a direct
`AllocationServer.query`, overload sheds at the door, deadline misses
classify TIMEOUT (both expired-in-queue and computed-too-late), drain
leaves zero unanswered tickets, and a background refresh never stalls
the query path.

TestResolveRace pins the server's snapshot contract itself: queries
racing a `warm_resolve` objective swap each see ONE coherent (obj, λ)
pair — bitwise equal to either the pre-swap or the post-swap
extraction, never a torn mix.

Every record the port's frontend emits validates under the port's schema
and under the reference's (`repro.obs.schema.validate_event`).  The
instance (80 × 12, ν = 8, seed 11, two families) is the reference test's,
generated by the port; every wait has its own timeout.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.obs.schema import validate_event as ref_validate_event
from repro_torch import formulations
from repro_torch import primal
from repro_torch.convert import lp_to_torch
from repro_torch.core import (InstanceSpec, Maximizer, SolveConfig,
                              StoppingCriteria, generate)
from repro_torch.obs import ListSink, Telemetry
from repro_torch.obs.schema import validate_event
from repro_torch.primal import (FrontendConfig, RequestStatus,
                                ServerFrontend)
from repro_torch.testing import SlowObjective


@pytest.fixture(scope="module")
def lp():
    spec = InstanceSpec(num_sources=80, num_destinations=12,
                        avg_nnz_per_row=8, seed=11, num_families=2)
    return lp_to_torch(generate(spec), "cpu")


CFG = SolveConfig(iterations=8000, gamma=0.05, gamma_init=0.8,
                  gamma_decay_every=25, max_step=20.0, initial_step=1e-3)
CRIT = StoppingCriteria(tol_rel_dual=1e-6, check_every=50)
GAMMA = CFG.gamma


@pytest.fixture(scope="module")
def solved(lp):
    obj = formulations.make_objective("multi_budget", lp,
                                      ax_mode="aligned", row_norm=True)
    res = Maximizer(CFG).maximize(obj, criteria=CRIT)
    assert res.converged
    return obj, res


def _server(obj, res, **kw):
    srv = primal.AllocationServer(obj, res.lam, GAMMA, config=CFG, **kw)
    srv.warmup()
    return srv


def _slow_server(obj, res, delay_s, **kw):
    slow = SlowObjective(obj, delay_s=delay_s)
    srv = primal.AllocationServer(slow, res.lam, GAMMA, config=CFG, **kw)
    return srv


class TestOkPath:
    def test_ok_bitwise_vs_direct_query(self, solved):
        obj, res = solved
        srv = _server(obj, res)
        fe = ServerFrontend(srv)
        ids = srv.source_ids()[:12].tolist()
        direct = srv.query(ids)
        resp = fe.query(ids, deadline_s=30.0, timeout=60.0)
        assert resp.status is RequestStatus.OK
        assert set(resp.decisions) == set(ids)
        for sid in ids:
            np.testing.assert_array_equal(resp.decisions[sid].x,
                                          direct[sid].x)
            assert resp.decisions[sid].row == direct[sid].row
        fe.drain(timeout=30.0)

    def test_coalescing_batches_queued_requests(self, solved):
        obj, res = solved
        srv = _server(obj, res)
        fe = ServerFrontend(srv, FrontendConfig(max_batch=64),
                            start=False)
        ids = srv.source_ids()
        tickets = [fe.submit(ids[i * 2:i * 2 + 2].tolist(),
                             deadline_s=30.0) for i in range(5)]
        fe._worker.start()   # everything queued before dispatch begins
        responses = [t.result(timeout=60.0) for t in tickets]
        assert all(r.status is RequestStatus.OK for r in responses)
        st = fe.stats()
        assert st.batches == 1       # 5 requests coalesced into one batch
        assert st.ok == 5 and st.admitted == 5
        # each response carries exactly its own sources
        for i, r in enumerate(responses):
            assert set(r.decisions) == set(ids[i * 2:i * 2 + 2].tolist())
        fe.drain(timeout=30.0)

    def test_unknown_source_is_error_at_admission(self, solved):
        obj, res = solved
        srv = _server(obj, res)
        fe = ServerFrontend(srv)
        t = fe.submit([10 ** 9], deadline_s=5.0)
        assert t.done()              # refused synchronously, no queueing
        resp = t.result(timeout=1.0)
        assert resp.status is RequestStatus.ERROR
        assert "unknown source" in resp.reason
        fe.drain(timeout=30.0)


class TestShedding:
    def test_est_wait_gate_sheds_hopeless_deadlines(self, solved):
        obj, res = solved
        srv = _server(obj, res)
        # pretend batches take 5s: anything with a 100ms deadline is
        # predicted to time out and must shed at the door
        fe = ServerFrontend(srv, FrontendConfig(
            initial_batch_estimate_s=5.0))
        resp = fe.query(srv.source_ids()[:2].tolist(), deadline_s=0.1,
                        timeout=30.0)
        assert resp.status is RequestStatus.SHED
        assert resp.reason.startswith("est_wait")
        assert resp.latency_s < 1.0   # immediate, not a 100ms timeout
        fe.drain(timeout=30.0)

    def test_queue_full_sheds(self, solved):
        obj, res = solved
        srv = _slow_server(obj, res, delay_s=0.3)
        fe = ServerFrontend(srv, FrontendConfig(
            max_queue=2, max_wait_s=0.0))
        ids = srv.source_ids()
        tickets = [fe.submit([int(ids[i])], deadline_s=30.0)
                   for i in range(8)]
        responses = [t.result(timeout=60.0) for t in tickets]
        statuses = [r.status for r in responses]
        shed = [r for r in responses if r.status is RequestStatus.SHED]
        assert shed and all(r.reason == "queue_full" for r in shed)
        assert any(s is RequestStatus.OK for s in statuses)
        assert all(s in (RequestStatus.OK, RequestStatus.SHED)
                   for s in statuses)   # nothing unclassified, no errors
        fe.drain(timeout=30.0)


class TestDeadlines:
    def test_expired_in_queue_is_timeout_without_device_work(self, solved):
        obj, res = solved
        srv = _slow_server(obj, res, delay_s=0.4)
        fe = ServerFrontend(srv, FrontendConfig(max_wait_s=0.0))
        ids = srv.source_ids()
        a = fe.submit([int(ids[0])], deadline_s=30.0)
        time.sleep(0.1)   # the slow batch for `a` is now executing
        b = fe.submit([int(ids[1])], deadline_s=0.05)
        rb = b.result(timeout=60.0)
        assert rb.status is RequestStatus.TIMEOUT
        assert rb.reason == "expired in queue"
        assert a.result(timeout=60.0).status is RequestStatus.OK
        fe.drain(timeout=30.0)

    def test_completed_past_deadline_is_timeout(self, solved):
        obj, res = solved
        srv = _slow_server(obj, res, delay_s=0.3)
        fe = ServerFrontend(srv, FrontendConfig(max_wait_s=0.0))
        t = fe.submit([int(srv.source_ids()[0])], deadline_s=0.05)
        resp = t.result(timeout=60.0)
        assert resp.status is RequestStatus.TIMEOUT
        assert resp.reason == "completed past deadline"
        assert resp.latency_s > 0.05
        fe.drain(timeout=30.0)


class TestDrain:
    def test_drain_flushes_and_refuses_new_work(self, solved):
        obj, res = solved
        srv = _slow_server(obj, res, delay_s=0.1)
        fe = ServerFrontend(srv, FrontendConfig(max_wait_s=0.0))
        ids = srv.source_ids()
        tickets = [fe.submit([int(ids[i])], deadline_s=30.0)
                   for i in range(3)]
        snap = fe.drain(timeout=30.0)
        assert all(t.done() for t in tickets)    # zero unanswered tickets
        assert all(t.result(timeout=1.0).status is RequestStatus.OK for t in tickets)
        assert snap["queue_depth"] == 0 and snap["draining"] == 1
        late = fe.submit([int(ids[0])], deadline_s=5.0)
        resp = late.result(timeout=1.0)
        assert resp.status is RequestStatus.SHED
        assert resp.reason == "draining"

    def test_drain_timeout_sheds_leftovers(self, solved):
        obj, res = solved
        srv = _slow_server(obj, res, delay_s=0.5)
        fe = ServerFrontend(srv, FrontendConfig(max_wait_s=0.0))
        ids = srv.source_ids()
        tickets = [fe.submit([int(ids[i])], deadline_s=30.0)
                   for i in range(3)]
        fe.drain(timeout=0.05)   # far too short for three 0.5s batches
        # leftovers were force-resolved SHED; the in-flight batch still
        # completes its ticket — wait for the dispatch thread to finish
        deadline = time.monotonic() + 30.0
        while (not all(t.done() for t in tickets)
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert all(t.done() for t in tickets)
        statuses = [t.result(timeout=1.0).status for t in tickets]
        assert RequestStatus.SHED in statuses
        shed = [t.result(timeout=1.0) for t in tickets
                if t.result(timeout=1.0).status is RequestStatus.SHED]
        assert all(r.reason == "drain_timeout" for r in shed)


class TestRefresh:
    def test_refresh_never_stalls_queries(self, solved, lp):
        obj, res = solved
        used = primal.certify(obj, res.lam, GAMMA).slacks["count_cap"].used
        tight = formulations.make_objective(
            "multi_budget", lp, params=dict(count_cap=0.9 * used),
            ax_mode="aligned", row_norm=True)
        srv = _server(obj, res)
        fe = ServerFrontend(srv)
        ids = srv.source_ids()[:6].tolist()
        assert fe.refresh(criteria=CRIT, obj=tight)
        # while the resolve (solve + kernel warmup for the new objective)
        # runs in the background, queries keep being answered
        served = 0
        while fe.refresh_in_flight() and served < 50:
            resp = fe.query(ids, deadline_s=30.0, timeout=60.0)
            assert resp.status is RequestStatus.OK
            served += 1
        assert served > 0            # queries completed DURING the resolve
        status, result = fe.wait_refresh(timeout=120.0)
        assert status == "accepted" and result.converged
        # a second refresh while one is in flight is refused, not queued
        assert fe.refresh(criteria=CRIT)
        if fe.refresh_in_flight():
            assert fe.refresh(criteria=CRIT) is False
        fe.wait_refresh(timeout=120.0)
        fe.drain(timeout=30.0)

    def test_refresh_shape_mismatch_raises_synchronously(self, solved, lp):
        obj, res = solved
        srv = _server(obj, res)
        fe = ServerFrontend(srv)
        other = formulations.make_objective("matching", lp, row_norm=True)
        with pytest.raises(ValueError, match="dual shape"):
            fe.refresh(obj=other)
        fe.drain(timeout=30.0)


class TestTelemetryEvents:
    def test_shed_timeout_queue_depth_drain_events_validate(self, solved):
        obj, res = solved
        sink = ListSink()
        tel = Telemetry(sink=sink, stream=open("/dev/null", "w"))
        srv = _slow_server(obj, res, delay_s=0.2)
        fe = ServerFrontend(srv, FrontendConfig(
            max_queue=1, max_wait_s=0.0), telemetry=tel)
        ids = srv.source_ids()
        tickets = [fe.submit([int(ids[i])], deadline_s=0.05)
                   for i in range(5)]
        for t in tickets:
            t.result(timeout=60.0)
        fe.drain(timeout=30.0)
        for rec in sink.records:
            validate_event(rec)      # every record schema-clean, under
            ref_validate_event(rec)  # both packages' schemas
        types = {r["type"] for r in sink.records}
        assert "shed" in types or "timeout" in types
        assert "queue_depth" in types
        assert "drain" in types
        drain = [r for r in sink.records if r["type"] == "drain"][-1]
        assert drain["pending"] == 0

    def test_metrics_snapshot_accounts_every_request(self, solved):
        obj, res = solved
        srv = _server(obj, res)
        fe = ServerFrontend(srv)
        ids = srv.source_ids()
        for i in range(4):
            fe.query([int(ids[i])], deadline_s=30.0, timeout=60.0)
        fe.submit([10 ** 9]).result(timeout=1.0)     # ERROR
        snap = fe.drain(timeout=30.0)
        classified = (snap["ok_total"] + snap["shed_total"]
                      + snap["timeout_total"] + snap["error_total"])
        assert classified == snap["submitted_total"] == 5


class TestResolveRace:
    """Satellite: queries racing a warm_resolve objective swap must each
    see one coherent (obj, λ) pair — all rows bitwise equal to the
    pre-swap extraction or all bitwise equal to the post-swap one."""

    def test_concurrent_queries_never_see_torn_pair(self, solved, lp):
        obj, res = solved
        srv = _server(obj, res, max_batch=8)
        used = primal.certify(obj, res.lam, GAMMA).slacks["count_cap"].used
        tight = formulations.make_objective(
            "multi_budget", lp, params=dict(count_cap=0.8 * used),
            ax_mode="aligned", row_norm=True)
        xs_before = [np.asarray(x) for x in
                     primal.extract_primal(obj, res.lam, GAMMA)]
        ids = srv.source_ids()
        rng = np.random.default_rng(7)
        stop = threading.Event()
        results, errors = [], []

        def hammer():
            while not stop.is_set():
                picked = rng.choice(ids, size=6, replace=False).tolist()
                try:
                    decisions = srv.query(picked)
                except Exception as e:   # any exception fails the test
                    errors.append(e)
                    return
                results.append([(d.slab_index, d.row, np.array(d.x))
                                for d in decisions.values()])
                # yield between queries: four threads spinning on the
                # interpreter lock would starve the re-solve for minutes
                stop.wait(0.01)

        threads = [threading.Thread(target=hammer) for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.1)          # some queries land before the swap
        warm = srv.warm_resolve(criteria=CRIT, obj=tight)
        stop.set()
        for t in threads:
            t.join(timeout=60.0)
        assert not errors, errors
        assert warm is not None and warm.converged
        xs_after = [np.asarray(x) for x in
                    primal.extract_primal(srv.obj, srv.lam, GAMMA)]
        assert results
        for rows in results:
            before = all(np.array_equal(x, xs_before[si][r])
                         for si, r, x in rows)
            after = all(np.array_equal(x, xs_after[si][r])
                        for si, r, x in rows)
            assert before or after, "torn (obj, λ) pair observed"
        # a post-swap query is guaranteed to serve the new pair
        final = srv.query(ids[:4].tolist())
        for d in final.values():
            np.testing.assert_array_equal(d.x, xs_after[d.slab_index][d.row])
