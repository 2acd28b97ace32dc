"""The port's SLO layer (``repro_torch.serving.slo``: trace, simulate,
admission, planner, and the scheduler's hooks) against the JAX
package's, on the CPU.

Twins of ``tests/test_slo.py``'s 20 tests, each run on the port
(``device="cpu"``), most also holding the port's answer to the
reference's on the same seeded input; then the cross-package checks:

* a recorded trace gives the same event sequence in both packages (the
  clock ``t`` and the measured ``*_s`` fields left out), plain and under
  a fault plan with retries (fault / retry / recovery events);
* each package's reader loads the other's file into equal rows;
* ``CostModel.from_trace`` on one trace gives equal scalars in both;
* ``simulate`` / ``replay`` give equal ``SimReport``s, ``sweep`` and
  ``frontier`` the same rows;
* a stream under backpressure, weighted fairness and shed-on-deadline
  gets the same admission decisions, in the same order, with the same
  reasons (and the same completion estimates, offer for offer).

Tolerance: exact everywhere, floats included — both packages run the
same pure-Python arithmetic on the same inputs.
"""
import dataclasses
import json

import pytest

from test_torch_serving_pair import (BOTH, J, T, client, masked, payload,
                            random_graph, server, slo_module)


def _stream(P, n, seed=0):
    return P.gen.random_graph_stream(n, seed=seed)


def _serve_traced(P, path, n=6, **opts):
    c = client(P, max_batch=4, steps_per_round=16, trace_path=str(path),
               **opts)
    results = c.enumerate_many(_stream(P, n))
    c.server.close_trace()
    return str(path), results, c


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """One recorded 8-request trace per package (same stream, same
    policy): {package name: (path, results)}."""
    d = tmp_path_factory.mktemp("slo")
    out = {}
    for P in BOTH:
        p, results, _ = _serve_traced(P, d / f"{P.name}.jsonl", n=8)
        out[P.name] = (p, results)
    return out


def _asdict(x):
    return dataclasses.asdict(x)


def _report(rep) -> dict:
    """A ``SimReport`` as plain data (its result class is per package)."""
    return dict(results={k: _asdict(v) for k, v in rep.results.items()},
                wall_s=rep.wall_s, busy_steps=rep.busy_steps,
                total_lane_steps=rep.total_lane_steps,
                compiles=rep.compiles, rounds=rep.rounds,
                timed_out=rep.timed_out,
                skipped_events=rep.skipped_events,
                occupancy=rep.occupancy,
                mean_latency_s=rep.mean_latency_s,
                mean_service_s=rep.mean_service_s)


# ---------------------------------------------------------------------------
# trace record -> read round-trip
# ---------------------------------------------------------------------------

def test_trace_round_trip(traces):
    """Every request appears once as admit and once as result; the
    merged rows carry the measured split and match the delivered
    results; the poll ledger is cumulative and monotone."""
    p, results = traces["torch"]
    events = T.slo.read_trace(p)
    admits = [e for e in events if e["event"] == "admit"]
    res_ev = [e for e in events if e["event"] == "result"]
    polls = [e for e in events if e["event"] == "poll"]
    assert len(admits) == len(results) == len(res_ev) == 8
    assert polls, "continuous serve must emit poll events"
    rows = T.slo.load_requests(p)
    assert [r.rid for r in rows] == sorted(r.rid for r in rows)
    by_rid = {r.rid: r for r in results}
    for row in rows:
        res = by_rid[row.rid]
        assert row.status == res.status == "done"
        assert row.steps == int(res.steps)
        assert row.metric == int(res.metric)
        assert row.latency_s == pytest.approx(res.latency_s, abs=1e-5)
        assert row.admitted and row.reason == "ok"
    for a, b in zip(polls, polls[1:]):
        assert b["busy_steps"] >= a["busy_steps"]
        assert b["total_lane_steps"] >= a["total_lane_steps"]
        assert b["exec_s"] >= a["exec_s"]


def test_trace_version_gate(tmp_path):
    p = tmp_path / "bad.jsonl"
    p.write_text('{"event": "meta", "version": 999, "t": 0.0}\n')
    with pytest.raises(ValueError, match="version"):
        T.slo.read_trace(str(p))
    jt, tt = slo_module(J, "trace"), slo_module(T, "trace")
    assert tt.TRACE_VERSION == jt.TRACE_VERSION
    assert tt.SUPPORTED_TRACE_VERSIONS == jt.SUPPORTED_TRACE_VERSIONS


def test_trace_lazy_no_file(tmp_path):
    p = tmp_path / "never.jsonl"
    server(T, trace_path=str(p))
    assert not p.exists()


def test_trace_records_rejections(tmp_path):
    """Rejected requests land in the trace as admit events with
    ``admitted=False`` and the typed reason, their results as
    ``status == "rejected"`` with zero counters; the same rows as the
    reference's trace of the same stream."""
    rows = {}
    for P in BOTH:
        p = str(tmp_path / f"rej-{P.name}.jsonl")
        srv = server(P, dict(max_batch=4),
                     admission=P.slo.AdmissionPolicy(max_pending=1),
                     trace_path=p)
        for g in _stream(P, 4, seed=1):
            srv.admit(g)
        srv.drain()
        srv.close_trace()
        rows[P.name] = T.slo.load_requests(p)
    rejected = [r for r in rows["torch"] if not r.admitted]
    assert rejected and all(r.reason == "backpressure" for r in rejected)
    assert all(r.status == "rejected" and r.steps == 0 for r in rejected)
    strip = [{k: v for k, v in _asdict(r).items()
              if k != "t_arrival" and not k.endswith("_s")}
             for r in rows["torch"]]
    assert strip == [{k: v for k, v in _asdict(r).items()
                      if k != "t_arrival" and not k.endswith("_s")}
                     for r in rows["jax"]]


# ---------------------------------------------------------------------------
# simulator (pure host arithmetic: the two packages' reports must be equal)
# ---------------------------------------------------------------------------

def _sim_reqs(P, n=8, steps=64, stagger=0.0, **kw):
    return [P.slo.SimRequest(rid=i, arrival_s=i * stagger, n_u=10, n_v=20,
                             steps=steps, **kw) for i in range(n)]


def _simulate(P, reqs, policy_kw, cost=None, **kw):
    cost = P.slo.CostModel(**cost) if cost else None
    return P.slo.simulate(reqs, P.serving.BucketPolicy(**policy_kw), cost,
                          **kw)


def test_simulate_deterministic_and_conserving():
    pol = dict(max_batch=4, steps_per_round=16)
    a = _simulate(T, _sim_reqs(T), pol)
    b = _simulate(T, _sim_reqs(T), pol)
    assert len(a.results) == 8
    assert a.wall_s == b.wall_s
    assert [r.latency_s for r in a.results.values()] \
        == [r.latency_s for r in b.results.values()]
    assert 0.0 <= a.occupancy <= 1.0
    assert a.busy_steps == 8 * 64
    assert _report(a) == _report(_simulate(J, _sim_reqs(J), pol))


def test_simulate_one_compile_per_executable_identity():
    pol = dict(max_batch=4, steps_per_round=16)
    assert _simulate(T, _sim_reqs(T, 8), pol).compiles == 1
    mixed = {P.name: _sim_reqs(P, 8) + [P.slo.SimRequest(
        rid=100, arrival_s=0.0, n_u=40, n_v=80, steps=64)] for P in BOTH}
    two = _simulate(T, mixed["torch"], pol)
    assert two.compiles == 2
    assert _report(two) == _report(_simulate(J, mixed["jax"], pol))


def test_simulate_priority_overtakes():
    pol = dict(max_batch=1, steps_per_round=16)
    reps = {}
    for P in BOTH:
        reqs = [P.slo.SimRequest(rid=i, arrival_s=0.0, n_u=10, n_v=20,
                                 steps=64, priority=(5 if i == 3 else 0))
                for i in range(4)]
        reps[P.name] = _simulate(P, reqs, pol)
    rep = reps["torch"]
    assert rep.results[3].queue_s < max(rep.results[i].queue_s
                                        for i in range(3))
    assert _report(rep) == _report(reps["jax"])


def test_simulate_models_pending_deadline_expiry():
    pol = dict(max_batch=1, steps_per_round=16)
    cost = dict(steps_per_s=1e3, compile_s=0.0)
    reps = {P.name: _simulate(P, _sim_reqs(P, 4, steps=500, deadline_s=0.75),
                              pol, cost, model_deadlines=True)
            for P in BOTH}
    rep = reps["torch"]
    assert rep.timed_out > 0
    assert any(not r.timed_out for r in rep.results.values())
    assert _report(rep) == _report(reps["jax"])


def test_replay_matches_measured_trace(traces):
    """Same-policy replay of the port's recorded trace predicts its
    measured mean service and latency within the reference's structural
    tolerance (0.2x-5x), and its occupancy within 0.3."""
    reader = T.slo.TraceReader(traces["torch"][0])
    cost = reader.cost_model()
    assert cost.source.startswith("trace")
    rep = T.slo.replay(reader.requests,
                       T.serving.BucketPolicy(max_batch=4,
                                              steps_per_round=16),
                       cost, polls=reader.polls())
    cmp = T.slo.compare_trace(reader.requests, rep)
    assert cmp["n"] == 8
    assert 0.2 <= cmp["latency_ratio"] <= 5.0
    assert 0.2 <= cmp["service_ratio"] <= 5.0
    assert abs(rep.occupancy - reader.occupancy()) < 0.3


def test_cost_model_from_bench_artifact(tmp_path):
    p = tmp_path / "artifact.json"
    p.write_text(json.dumps(dict(rows=[
        dict(level="engine", steps_per_s=5e4, compile_s=0.5, steps=120,
             n_u=10, n_v=20),
        dict(level="engine", steps_per_s=7e4, compile_s=0.3, steps=200,
             n_u=16, n_v=32),
        dict(level="serving", steps_per_s=9e9),     # ignored: not engine
    ])))
    cost = T.slo.CostModel.from_bench(str(p))
    assert cost.steps_per_s == pytest.approx(6e4)
    assert cost.compile_s == pytest.approx(0.4)
    assert cost.source.startswith("bench:")
    assert _asdict(cost) == _asdict(J.slo.CostModel.from_bench(str(p)))
    with pytest.raises(ValueError, match="engine"):
        bad = tmp_path / "empty.json"
        bad.write_text('{"rows": []}')
        T.slo.CostModel.from_bench(str(bad))


def test_default_scalars_are_the_references():
    """The fallback scalars are the JAX package's, so both packages make
    the same decisions with an uncalibrated cost model."""
    for k in ("DEFAULT_STEPS_PER_S", "DEFAULT_COMPILE_S",
              "DEFAULT_ROUND_OVERHEAD_S", "DEFAULT_STEP_DENSITY"):
        assert getattr(slo_module(T, "simulate"), k) \
            == getattr(slo_module(J, "simulate"), k), k
    assert _asdict(T.slo.CostModel()) == _asdict(J.slo.CostModel())
    assert slo_module(T, "simulate").UNREPLAYABLE_STATUSES \
        == slo_module(J, "simulate").UNREPLAYABLE_STATUSES


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

def _statuses(P, admissions, policy, graphs_seed, n, tenants=None,
              deadlines=None, **kw):
    """Admit ``n`` graphs of the seeded stream under ``policy``, drain;
    returns (server, rids, results)."""
    srv = server(P, dict(max_batch=4),
                 admission=P.slo.AdmissionPolicy(**admissions), **kw)
    gs = _stream(P, n, seed=graphs_seed)
    rids = [srv.admit(g, tenant=(tenants[i] if tenants else "default"),
                      deadline_s=(deadlines[i] if deadlines else None))
            for i, g in enumerate(gs)]
    got = srv.drain()
    return srv, rids, got


def test_backpressure_bounds_pending():
    runs = {P.name: _statuses(P, dict(max_pending=2), None, 2, 5)
            for P in BOTH}
    srv, rids, got = runs["torch"]
    statuses = [got[r].status for r in rids]
    assert statuses.count("rejected") == 3
    assert statuses.count("done") == 2
    st = srv.stats()
    assert st["admitted"] == 2 and st["rejected"] == 3
    assert st["rejected_backpressure"] == 3 and st["shed"] == 0
    for r in rids:
        if got[r].status == "rejected":
            assert got[r].reject_reason == "backpressure"
            assert got[r].steps == 0 and got[r].metric == 0
    jsrv, jrids, jgot = runs["jax"]
    assert [payload(got[r]) for r in rids] \
        == [payload(jgot[r]) for r in jrids]


def test_fairness_caps_chatty_tenant():
    tenants = ["a"] * 6 + ["b"] * 2
    runs = {P.name: _statuses(P, dict(tenant_weights={"a": 1.0, "b": 1.0},
                                      fairness_pending_cap=4),
                              None, 3, 8, tenants=tenants)
            for P in BOTH}
    srv, rids, got = runs["torch"]
    a_status = [got[r].status for r in rids[:6]]
    assert "rejected" in a_status
    assert all(got[r].status == "done" for r in rids[6:])
    pt = srv.stats()["per_tenant"]
    assert pt["a"]["rejected"] == a_status.count("rejected")
    assert pt["a"]["admitted"] + pt["a"]["rejected"] == 6
    assert pt["b"]["admitted"] == 2 and pt["b"]["completed"] == 2
    jsrv, jrids, jgot = runs["jax"]
    assert pt == jsrv.stats()["per_tenant"]
    assert [payload(got[r]) for r in rids] \
        == [payload(jgot[r]) for r in jrids]


def test_shed_on_deadline_rejects_predicted_miss():
    """A cold bucket + an impossible deadline sheds at admit; a request
    with no deadline never sheds."""
    for P in BOTH:
        cost = P.slo.CostModel(steps_per_s=1e4, compile_s=10.0)
        srv = server(P, dict(max_batch=4),
                     admission=P.slo.AdmissionPolicy(shed_on_deadline=True,
                                                     cost=cost))
        g1, g2 = _stream(P, 2, seed=4)
        shed_rid = srv.admit(g1, deadline_s=0.001)
        free_rid = srv.admit(g2)
        got = srv.drain()
        assert got[shed_rid].status == "rejected", P.name
        assert got[shed_rid].reject_reason == "shed"
        assert got[free_rid].status == "done"
        assert srv.stats()["shed"] == 1


def test_rejected_results_typed_per_engine():
    """Every registered engine delivers rejection through its own result
    type with zeroed counters, and nothing runs for it."""
    from repro_torch.core.engine import get_engine, list_engines
    for name in list_engines():
        eng = get_engine(name)
        g = (T.gen.random_unipartite(10, 0.3, seed=5) if eng.unipartite
             else random_graph(T, 8, 16, 0.3, 5, canonical=True))
        srv = server(T, dict(max_batch=2), engine=name,
                     admission=T.slo.AdmissionPolicy(max_pending=0))
        rid = srv.admit(g)
        res = srv.reap()[rid]
        assert isinstance(res, eng.result_type), name
        assert res.status == "rejected" and res.rejected, name
        assert res.reject_reason == "backpressure", name
        assert res.steps == 0 and res.metric == 0, name
        assert srv.cache.misses == 0, f"{name}: rejection ran"


def test_admission_controller_estimates_monotone():
    ctl = T.slo.AdmissionController(T.slo.AdmissionPolicy(
        cost=T.slo.CostModel(steps_per_s=1e4, compile_s=2.0)))
    kw = dict(n_u=10, n_v=20, bucket=(16, 32), lanes=4)
    cold_small = ctl.estimate_completion_s(backlog_steps=0, **kw)
    cold_big = ctl.estimate_completion_s(backlog_steps=10_000, **kw)
    assert cold_big > cold_small
    ctl._seen_buckets.add((16, 32))
    warm = ctl.estimate_completion_s(backlog_steps=0, **kw)
    assert cold_small - warm == pytest.approx(2.0)


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------

def _sweep(P, path):
    reader = P.slo.TraceReader(path)
    base = P.serving.BucketPolicy(max_batch=4, steps_per_round=16)
    cands = P.slo.candidate_policies(base, steps_per_round=(0, 16),
                                     max_batch=(2, 4))
    return P.slo.sweep(reader.requests, cands, reader.cost_model())


def test_planner_sweep_and_frontier(traces):
    rows = _sweep(T, traces["torch"][0])
    assert len(rows) == 4
    for r in rows:
        assert r["predicted_mean_latency_s"] >= 0
        assert 0.0 <= r["predicted_occupancy"] <= 1.0
    front = T.slo.frontier(rows)
    assert 1 <= len(front) <= len(rows)
    for f in front:
        for o in rows:
            better_lat = o["predicted_mean_latency_s"] \
                < f["predicted_mean_latency_s"]
            no_worse = (o["predicted_mean_latency_s"]
                        <= f["predicted_mean_latency_s"]
                        and o["predicted_occupancy"]
                        >= f["predicted_occupancy"])
            assert not (no_worse and (better_lat or o[
                "predicted_occupancy"] > f["predicted_occupancy"]))


def test_candidate_policies_inherit_base():
    base = T.serving.BucketPolicy(big_graph_threshold=99, steps_per_call=3)
    for pol in T.slo.candidate_policies(base, steps_per_round=(8,),
                                        max_batch=(2,)):
        assert pol.big_graph_threshold == 99
        assert pol.steps_per_call == 3
    assert slo_module(T, "planner").describe(base) \
        == slo_module(J, "planner").describe(
        J.serving.BucketPolicy(big_graph_threshold=99, steps_per_call=3))


# ---------------------------------------------------------------------------
# identical payloads when the SLO layer is off or merely observing
# ---------------------------------------------------------------------------

def test_slo_off_and_observing_identical_payloads(tmp_path):
    """Bare vs trace-recording vs permissive-admission port clients:
    identical payloads request for request, equal to the reference's
    bare client."""
    ref = [payload(r) for r in client(J, max_batch=4, steps_per_round=16)
           .enumerate_many(_stream(J, 8, seed=6))]
    graphs = _stream(T, 8, seed=6)
    bare = client(T, max_batch=4, steps_per_round=16)
    assert [payload(r) for r in bare.enumerate_many(graphs)] == ref
    traced = client(T, max_batch=4, steps_per_round=16,
                    trace_path=str(tmp_path / "t.jsonl"))
    assert [payload(r) for r in traced.enumerate_many(graphs)] == ref
    permissive = client(T, max_batch=4, steps_per_round=16,
                        admission=T.slo.AdmissionPolicy(max_pending=10_000))
    assert [payload(r) for r in permissive.enumerate_many(graphs)] == ref
    assert permissive.stats()["admitted"] == 8
    assert permissive.stats()["rejected"] == 0


def test_reset_stats_zeros_monotonic_keeps_gauges():
    c = client(T, max_batch=4, steps_per_round=16)
    c.enumerate_many(_stream(T, 4, seed=7))
    st = c.stats()
    assert st["batches"] > 0 and st["misses"] > 0
    entries_before = c.server.cache.stats()["entries"]
    c.server.reset_stats()
    st2 = c.stats()
    assert st2["batches"] == 0 and st2["busy_steps"] == 0
    assert st2["misses"] == 0 and st2["hits"] == 0
    assert st2["admitted"] == 0 and st2["per_tenant"] == {}
    assert st2["occupancy"] == 0.0
    assert c.server.cache.stats()["entries"] == entries_before
    assert st2["engine"] == st["engine"]
    assert st2["executor"] == st["executor"]
    c.enumerate_many(_stream(T, 4, seed=7))
    st3 = c.stats()
    assert st3["batches"] > 0
    assert st3["misses"] == 0 and st3["hits"] > 0
    # the admission ledger resets with the server's
    srv = server(T, dict(max_batch=4),
                 admission=T.slo.AdmissionPolicy(max_pending=1))
    for g in _stream(T, 3, seed=7):
        srv.admit(g)
    assert srv.stats()["rejected_backpressure"] == 2
    srv.reset_stats()
    st4 = srv.stats()
    assert st4["rejected"] == st4["rejected_backpressure"] == 0
    assert srv.admission.stats()["admitted"] == 0


def test_admission_policy_frozen_and_default_off():
    pol = T.slo.AdmissionPolicy()
    assert pol.max_pending is None and not pol.shed_on_deadline
    with pytest.raises(dataclasses.FrozenInstanceError):
        pol.max_pending = 3


# ---------------------------------------------------------------------------
# cross-package: traces, readers, cost model, replay, planner, decisions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chaos", [False, True], ids=["plain", "faults"])
def test_trace_events_match_across_packages(tmp_path, chaos):
    """The same stream traced by both packages: the same events in the
    same order (``t`` and measured ``*_s`` left out).  Under a fault
    plan with retries the fault / retry / recovery events (checkpoints,
    the failover) match too."""
    events = {}
    for P in BOTH:
        kw = {}
        if chaos:
            kw = dict(retry=P.serving.RetryPolicy(max_attempts=4,
                                                  backoff_s=1e-5,
                                                  checkpoint_interval=2),
                      fault_injector=P.serving.FaultPlan(
                          seed=3, launch_rate=0.2, corrupt_done_rate=0.1,
                          device_lost_after=6))
        p, _, _ = _serve_traced(P, tmp_path / f"{P.name}.jsonl", n=6, **kw)
        events[P.name] = P.slo.read_trace(p)
    kinds = {e["event"] for e in events["torch"]}
    assert {"admit", "result", "poll"} <= kinds
    if chaos:
        assert {"fault", "retry", "recovery"} <= kinds
    assert masked(events["torch"]) == masked(events["jax"])


def test_readers_load_each_others_trace(traces):
    """Each package's reader loads the other's file: equal rows, equal
    poll series, equal final occupancy."""
    for path, _ in traces.values():
        jr, tr = J.slo.TraceReader(path), T.slo.TraceReader(path)
        assert [_asdict(r) for r in tr.requests] \
            == [_asdict(r) for r in jr.requests]
        assert tr.polls() == jr.polls() and tr.events == jr.events
        assert tr.occupancy() == jr.occupancy()


def test_cost_model_from_trace_matches(traces):
    """``CostModel.from_trace`` on one trace: equal scalars in both
    packages, with the poll ledger and without it."""
    for path, _ in traces.values():
        jr, tr = J.slo.TraceReader(path), T.slo.TraceReader(path)
        assert _asdict(tr.cost_model()) == _asdict(jr.cost_model())
        assert _asdict(T.slo.CostModel.from_trace(tr.requests)) \
            == _asdict(J.slo.CostModel.from_trace(jr.requests))


def test_simulate_and_replay_match(traces):
    """``replay`` of one trace under several policies, and ``simulate``
    of its records: equal ``SimReport``s and ``compare_trace`` rows."""
    path = traces["torch"][0]
    readers = {P.name: P.slo.TraceReader(path) for P in BOTH}
    for pol in (dict(max_batch=4, steps_per_round=16),
                dict(max_batch=2, steps_per_round=0),
                dict(max_batch=8, steps_per_round=64, mode="linear")):
        reps = {}
        for P in BOTH:
            r = readers[P.name]
            rep = P.slo.replay(r.requests, P.serving.BucketPolicy(**pol),
                               polls=r.polls(), events=r.events,
                               model_deadlines=True)
            reps[P.name] = (_report(rep),
                            P.slo.compare_trace(r.requests, rep))
        assert reps["torch"] == reps["jax"], pol
    sims = {}
    for P in BOTH:
        r = readers[P.name]
        cost = r.cost_model()
        reqs = [P.slo.SimRequest.from_record(x, cost) for x in r.requests]
        sims[P.name] = _report(P.slo.simulate(
            reqs, P.serving.BucketPolicy(max_batch=4), cost))
    assert sims["torch"] == sims["jax"]


def test_sweep_and_frontier_match(traces):
    for path, _ in traces.values():
        rows = {P.name: _sweep(P, path) for P in BOTH}
        assert rows["torch"] == rows["jax"]
        assert T.slo.frontier(rows["torch"]) == J.slo.frontier(rows["jax"])


def test_admission_decisions_match_across_packages(tmp_path):
    """A stream under backpressure, weighted per-tenant fairness and
    shed-on-deadline at once, with a poll between two waves of admits:
    the same verdicts in the same order with the same reasons (trace
    admit events, routing log, per-request results, the admission
    ledger) in both packages."""
    tenants = ["a", "a", "a", "a", "b", "c", "a", "b", "a", "c", "b", "a"]
    # deadlines long enough never to expire on the clock: the slow cost
    # model alone makes the shed layer refuse some of them at admit
    deadlines = [None, 300.0, None, 900.0, 120.0, None, 600.0, None, 60.0,
                 None, 1000.0, 200.0]
    got = {}
    for P in BOTH:
        pol = P.slo.AdmissionPolicy(
            max_pending=4, tenant_weights={"a": 1.0, "b": 2.0},
            shed_on_deadline=True, shed_slack=1.5,
            cost=P.slo.CostModel(steps_per_s=4.0, compile_s=20.0))
        p = str(tmp_path / f"adm-{P.name}.jsonl")
        srv = server(P, dict(max_batch=2, steps_per_round=16),
                     admission=pol, trace_path=p)
        gs = _stream(P, 12, seed=11)
        rids = []
        for i, g in enumerate(gs):
            rids.append(srv.admit(g, tenant=tenants[i],
                                  deadline_s=deadlines[i]))
            if i == 5:
                srv.poll()
        res = srv.drain()
        srv.close_trace()
        st = srv.stats()
        admits = [e for e in P.slo.read_trace(p) if e["event"] == "admit"]
        got[P.name] = dict(
            admits=masked(admits), log=srv.routing_log,
            results=[(res[r].status, res[r].reject_reason) for r in rids
                     if r in res],
            ledger={k: st[k] for k in ("admitted", "rejected", "shed",
                                       "rejected_backpressure",
                                       "rejected_fairness", "per_tenant")})
    reasons = [a["reason"] for a in got["torch"]["admits"]]
    assert {"ok", "backpressure", "fairness", "shed"} <= set(reasons), \
        reasons
    assert got["torch"] == got["jax"]


def test_admission_controller_offers_match():
    """The controllers alone, offer for offer over a scripted sequence:
    equal ``Decision``s (completion estimates included) and counters."""
    seq = []
    for i in range(40):
        seq.append(dict(n_u=4 + i % 9, n_v=16 + (i * 7) % 40,
                        bucket=(8 << (i % 3), 32), route="lane",
                        tenant="abc"[i % 3],
                        deadline_s=(None if i % 4 == 0 else 0.001 * i),
                        pending=i % 7,
                        tenants_pending={"a": i % 3, "b": i % 5},
                        backlog_steps=37 * i, lanes=1 + i % 4))
    out = {}
    for P in BOTH:
        ctl = P.slo.AdmissionController(P.slo.AdmissionPolicy(
            max_pending=6, tenant_weights={"a": 3.0, "b": 1.0},
            default_weight=0.5, shed_on_deadline=True, shed_slack=0.9))
        out[P.name] = ([_asdict(ctl.offer(**kw)) for kw in seq],
                       ctl.stats())
    assert out["torch"] == out["jax"]
