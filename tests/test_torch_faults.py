"""The port's fault-injection and recovery layer
(``repro_torch.serving.faults`` / ``.recovery`` and the scheduler's
recovery ladder) against the JAX package's, on the CPU.

Twins of ``tests/test_faults.py``'s tests on ``LocalExecutor`` (a chaos
stream through ``ShardedExecutor`` on a CPU mesh of 4 is in
``tests/test_torch_sharded_executor.py``), parametrised over
the dense, compact, ``mce`` and ``count`` engines where the reference's
are, and over the engines for the device-lost failover as well.  For one
``FaultPlan`` seed the two packages must give identical injector logs
(site, ordinal, kind, in order), identical payloads (every result field
but the measured ``*_s`` times: ``n_max``, ``cs``, ``count``, status,
``fail_reason`` and so the failed rid), the same routing log and the
same recovery counters (retries, checkpoints, quarantined, failovers,
...).  Tolerance: exact.

Beyond the twins: a snapshot never aliases the pool it was taken from;
every engine's state survives snapshot -> host -> restore bit for bit;
the default failover target is on the failed executor's device; a
plain ``RuntimeError`` from a launch is not retried; the big lane can
fail alone.
"""
import time

import numpy as np
import pytest
import torch

from test_torch_serving_pair import (BOTH, LEDGER_KEYS, J, T, payload,
                            random_graph, server)
from repro_torch.serving import scheduler as t_scheduler
from repro_torch.serving.recovery import restore_state, snapshot_state

ENGINES = ("dense", "compact", "count", "mce")


def _graphs(P, engine, n=4):
    if engine == "mce":
        return [P.gen.random_unipartite(8 + i, 0.3, seed=40 + i,
                                        name=f"uni{i}") for i in range(n)]
    return [random_graph(P, 5 + i, 10 + i, 0.35, 40 + i, canonical=True)
            for i in range(n)]


def _serve(P, *, engine="dense", n=4, retry=None, plan=None, policy=None,
           graphs=None, **kw):
    """Serve the seeded stream through ``P``'s server; ``retry`` /
    ``plan`` are keyword dicts of ``P``'s ``RetryPolicy`` /
    ``FaultPlan``.  Returns (server, {rid: result})."""
    srv = server(
        P, policy or dict(max_batch=2, steps_per_round=16), engine=engine,
        retry=None if retry is None else P.serving.RetryPolicy(**retry),
        fault_injector=None if plan is None else P.serving.FaultPlan(**plan),
        **kw)
    gs = graphs(P) if graphs else _graphs(P, engine, n)
    rids = [srv.admit(g) for g in gs]
    got = srv.drain()
    return srv, {r: got[r] for r in rids}


def _payloads(got) -> dict:
    return {r: payload(v) for r, v in got.items()}


def _record(srv, got) -> dict:
    """What must match across packages: payloads, every injector's log,
    the recovery ledger, the routing log."""
    st = srv.stats()
    return dict(payloads=_payloads(got),
                logs=[i.log for i in srv._injectors],
                ledger={k: st[k] for k in LEDGER_KEYS},
                routing=srv.routing_log)


def _both(**kw):
    """The same serve in both packages; returns the port's (server,
    results) after asserting it matches the reference's record."""
    runs = {P.name: _serve(P, **kw) for P in BOTH}
    assert _record(*runs["torch"]) == _record(*runs["jax"])
    return runs["torch"]


# ---------------------------------------------------------------------------
# determinism + transient-fault identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_transient_faults_are_byte_identical(engine):
    """25 % launch faults + retry: every payload identical to the
    fault-free run, and the chaos run identical to the reference's."""
    _, base = _serve(T, engine=engine)
    srv, chaos = _both(engine=engine,
                       retry=dict(max_attempts=5, backoff_s=1e-5),
                       plan=dict(seed=2, launch_rate=0.25))
    assert _payloads(base) == _payloads(chaos)
    s = srv.stats()
    assert s["faults_injected"] > 0 and s["retries"] > 0
    assert s["failed"] == 0 and s["quarantined"] == 0


def test_fault_schedule_is_deterministic():
    """Same seed, same stream -> identical log, retries and payloads
    (and the reference's); another seed -> another schedule."""
    kw = dict(retry=dict(max_attempts=5, backoff_s=1e-5),
              plan=dict(seed=7, launch_rate=0.25))
    runs = []
    for _ in range(2):
        srv, got = _serve(T, **kw)
        runs.append((srv._injectors[0].log, srv.stats()["retries"],
                     _payloads(got)))
    assert runs[0] == runs[1]
    jsrv, jgot = _serve(J, **kw)
    assert runs[0] == (jsrv._injectors[0].log, jsrv.stats()["retries"],
                       _payloads(jgot))
    srv3, _ = _serve(T, retry=kw["retry"], plan=dict(seed=8,
                                                     launch_rate=0.25))
    assert srv3._injectors[0].log != runs[0][0]


def test_corrupted_done_mask_reads_are_recovered():
    """Transient scoreboard corruption: verified reads keep demux honest;
    the reads are re-read, never retried."""
    _, base = _serve(T)
    srv, chaos = _both(retry=dict(max_attempts=3, backoff_s=1e-5),
                       plan=dict(seed=2, corrupt_done_rate=0.15))
    assert _payloads(base) == _payloads(chaos)
    assert srv.stats()["faults_injected"] > 0
    assert srv.stats()["retries"] == 0


def test_compile_faults_retry_without_poisoning_the_cache():
    """Injected first-call failures are retried; the executable cache
    keeps no failed entry and ``misses`` equals the clean run's."""
    srv0, base = _serve(T)
    srv, chaos = _both(retry=dict(max_attempts=5, backoff_s=1e-5),
                       plan=dict(seed=3, compile_rate=0.3))
    assert _payloads(base) == _payloads(chaos)
    assert srv.stats()["misses"] == srv0.stats()["misses"]
    assert srv.stats()["entries"] == srv0.stats()["entries"]


# ---------------------------------------------------------------------------
# device-lost failover
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_device_lost_fails_over_with_identical_payloads(engine,
                                                        monkeypatch):
    """A persistent device loss mid-stream: one failover, lanes resumed
    from their checkpoints (on the new executor's device), every payload
    identical to the fault-free run and to the reference's chaos run."""
    restored = []

    def spy(state, device):
        restored.append(torch.device(device))
        return restore_state(state, device)
    monkeypatch.setattr(t_scheduler, "restore_state", spy)
    _, base = _serve(T, engine=engine)
    srv, chaos = _both(engine=engine,
                       retry=dict(max_attempts=3, backoff_s=1e-5,
                                  checkpoint_interval=2),
                       plan=dict(seed=1, device_lost_after=4))
    assert _payloads(base) == _payloads(chaos)
    s = srv.stats()
    assert s["failovers"] == 1 and s["checkpoints"] > 0
    assert restored and all(d.type == "cpu" for d in restored)
    assert isinstance(srv.executor, T.serving.FaultInjector)
    assert isinstance(srv.executor.inner, T.serving.LocalExecutor)
    assert srv.executor.device == srv.executor.inner.device \
        == torch.device("cpu")
    fo = [e for e in srv.routing_log if e["event"] == "failover"]
    assert len(fo) == 1 and "device-lost" in fo[0]["reason"]


def test_device_lost_without_retry_policy_raises():
    with pytest.raises(T.serving.DeviceLostError):
        _serve(T, plan=dict(seed=1, device_lost_after=1))


def test_failover_can_target_an_explicit_executor():
    runs = {P.name: _serve(P, retry=dict(max_attempts=3, backoff_s=1e-5,
                                         checkpoint_interval=1),
                           plan=dict(seed=2, device_lost_after=3),
                           failover_executor=P.serving.LocalExecutor(
                               big_workers=2, **P.extra))
            for P in BOTH}
    assert _record(*runs["torch"]) == _record(*runs["jax"])
    _, base = _serve(T)
    srv, chaos = runs["torch"]
    assert _payloads(base) == _payloads(chaos)
    assert srv.stats()["failovers"] == 1
    assert srv.executor.inner.big_workers == 2


def test_default_failover_target_is_on_the_failed_device():
    """Without ``failover_executor`` the new executor is a fresh
    ``LocalExecutor`` on the failed one's device: with the failed
    executor on the CPU that is the CPU (a default ``"cuda"`` target
    would raise here, with no card), never a plain-version stand-in."""
    srv, got = _serve(T, retry=dict(max_attempts=3, backoff_s=1e-5,
                                    checkpoint_interval=1),
                      plan=dict(seed=2, device_lost_after=3))
    assert srv.stats()["failovers"] == 1
    inner = srv.executor.inner
    assert type(inner) is T.serving.LocalExecutor
    assert inner.device == torch.device("cpu")
    assert all(p.pool.state.lvl.device == inner.device
               for p in srv._pools.values())
    assert all(r.status == "done" for r in got.values())


# ---------------------------------------------------------------------------
# poison quarantine
# ---------------------------------------------------------------------------

def test_poison_quarantine_isolates_exactly_the_culprit():
    """Bisection isolates the poisoned request (the same rid as the
    reference's), it completes as ``failed`` with a ``fail_reason``, and
    every innocent payload matches the clean run."""
    _, base = _serve(T)
    srv, chaos = _both(retry=dict(max_attempts=2, backoff_s=1e-5),
                       plan=dict(seed=1, poison_nth_install=2))
    failed = {r: v for r, v in chaos.items() if v.status == "failed"}
    assert len(failed) == 1
    (rid, res), = failed.items()
    assert "quarantine" in res.fail_reason
    assert res.metric == 0 and res.bicliques is None
    for r, v in chaos.items():
        if r != rid:
            assert payload(v) == payload(base[r])
    s = srv.stats()
    assert s["quarantined"] == 1 and s["failed"] == 1
    assert s["failovers"] == 0
    assert [e for e in srv.routing_log if e["event"] == "quarantine"]


def test_transient_streak_exonerates_all_suspects():
    """max_attempts=1 makes every transient fault look like poison; the
    solo confirm probe exonerates the suspects instead of failing an
    innocent request."""
    _, base = _serve(T, n=2)
    srv, chaos = _both(n=2, retry=dict(max_attempts=1, backoff_s=1e-5),
                       plan=dict(seed=5, launch_rate=0.15))
    assert srv.stats()["failed"] == 0
    assert _payloads(base) == _payloads(chaos)


def test_big_lane_fails_alone():
    """Every request on the big lane (``big_graph_threshold=1``): a big
    round that fails ``max_attempts`` times fails that request alone
    (``big-graph round failed``), the others match the fault-free run,
    and the log, payloads and counters match the reference's."""
    pol = dict(max_batch=2, steps_per_round=16, big_graph_threshold=1)
    _, base = _serve(T, n=3, policy=pol)
    srv, chaos = _both(n=3, policy=pol,
                       retry=dict(max_attempts=2, backoff_s=1e-5),
                       plan=dict(seed=1, launch_rate=0.5))
    failed = [r for r, v in chaos.items() if v.status == "failed"]
    assert failed and len(failed) < len(chaos)
    for r, v in chaos.items():
        if r in failed:
            assert "big-graph round failed" in v.fail_reason
        else:
            assert payload(v) == payload(base[r])
    assert srv.stats()["quarantined"] == len(failed)
    assert {e["site"] for e in srv._injectors[0].log} == {"big"}


# ---------------------------------------------------------------------------
# disabled-path identity
# ---------------------------------------------------------------------------

def test_off_by_default_is_byte_identical():
    srv1, got1 = _serve(T)
    srv2, got2 = _serve(T)
    assert srv1.stats() == srv2.stats()
    assert _payloads(got1) == _payloads(got2)
    for key in ("retries", "faults_injected", "checkpoints",
                "quarantined", "failovers", "failed", "step_capped"):
        assert srv1.stats()[key] == 0


def test_retry_policy_alone_changes_nothing():
    """A retry policy with no injector: payloads identical to the bare
    server; checkpoints are taken (as many as the reference takes) but
    never restored."""
    _, base = _serve(T)
    srv, got = _both(retry=dict(max_attempts=3, checkpoint_interval=2))
    assert _payloads(base) == _payloads(got)
    assert srv.stats()["retries"] == 0
    assert srv.stats()["checkpoints"] > 0


# ---------------------------------------------------------------------------
# retry policy mechanics
# ---------------------------------------------------------------------------

def test_retry_backoff_is_deterministic_and_bounded():
    kw = dict(backoff_s=0.01, backoff_mult=2.0, max_backoff_s=0.05,
              jitter=0.5, seed=3)
    pol = T.serving.RetryPolicy(**kw)
    a = [pol.delay_s("site", k) for k in range(1, 8)]
    assert a == [pol.delay_s("site", k) for k in range(1, 8)]
    assert a != [pol.delay_s("other", k) for k in range(1, 8)]
    for k, d in enumerate(a, start=1):
        base = min(0.01 * 2.0 ** (k - 1), 0.05)
        assert base * 0.5 <= d <= base * 1.5
    jpol = J.serving.RetryPolicy(**kw)
    assert a == [jpol.delay_s("site", k) for k in range(1, 8)]
    assert T.serving.RetryPolicy().retry_on == (T.serving.FaultError,)


def test_retry_is_deadline_aware():
    """A huge backoff is clamped to the earliest live deadline."""
    srv = server(T, dict(max_batch=2, steps_per_round=16),
                 retry=T.serving.RetryPolicy(max_attempts=4, backoff_s=30.0,
                                             jitter=0.0),
                 fault_injector=T.serving.FaultPlan(seed=1, launch_rate=0.5))
    t0 = time.perf_counter()
    for g in _graphs(T, "dense", n=2):
        srv.admit(g, deadline_s=0.5)
    srv.drain()
    assert time.perf_counter() - t0 < 10.0, \
        "retry slept past the live deadline"


def test_verified_read_recovers_transient_corruption():
    truth = np.array([True, False, True, False])
    seq = iter([truth, np.array([True, True, True, False]), truth,
                truth, truth])
    val, mismatches = T.serving.verified_read(lambda: next(seq))
    assert np.array_equal(val, truth)
    assert mismatches == 2
    clean = iter([truth] * 3)
    val, mismatches = T.serving.verified_read(lambda: next(clean))
    assert np.array_equal(val, truth) and mismatches == 0


class _Flaky:
    """A round callable whose first ``fails`` calls raise."""

    def __init__(self, fails: int = 1):
        self.calls = 0
        self.fails = fails

    def __call__(self, c, s):
        self.calls += 1
        if self.calls <= self.fails:
            raise T.serving.TransientLaunchError("injected first-call "
                                                 "failure")
        return s + c


def test_failed_compile_never_poisons_the_cache():
    """A raising first call leaves NO entry behind and rolls the miss
    back; retrying the same entry re-commits on success."""
    cache = T.serving.ExecutableCache()
    entry = cache.get_entry("k", lambda: _Flaky())
    one = torch.tensor(1.0)
    with pytest.raises(T.serving.TransientLaunchError):
        entry(one, one)
    st = cache.stats()
    assert st["entries"] == 0, "failed first call left a poisoned entry"
    assert st["misses"] == 0, "failed first call counted as a compile"
    assert not entry.compiled and entry.compile_s == 0.0
    assert float(entry(one, one)) == 2.0
    st = cache.stats()
    assert st["entries"] == 1 and st["misses"] == 1
    assert cache.get_entry("k", lambda: 1 / 0) is entry
    assert cache.stats()["hits"] == 1


def test_failed_compile_then_fresh_get_builds_anew():
    cache = T.serving.ExecutableCache()
    bad = cache.get_entry("k", lambda: _Flaky())
    one = torch.tensor(1.0)
    with pytest.raises(T.serving.TransientLaunchError):
        bad(one, one)
    good = cache.get_entry("k", lambda: _Flaky(fails=0))
    assert good is not bad
    assert float(good(one, one)) == 2.0
    assert cache.stats()["entries"] == 1 and cache.stats()["misses"] == 1
    bad(one, one)
    assert cache.get_entry("k", lambda: 1 / 0) is good
    assert cache.stats()["entries"] == 1


# ---------------------------------------------------------------------------
# beyond the twins: snapshots, real errors
# ---------------------------------------------------------------------------

def _running_pool(engine):
    """A 2-lane CPU pool of the engine, both lanes installed and one
    round in: (executor, pool, cache)."""
    ex = T.serving.LocalExecutor(device="cpu")
    eng = T.root.get_engine(engine)
    gs = _graphs(T, engine, n=2)
    g = max(gs, key=lambda x: (x.n_u, x.n_v))
    b = T.serving.plan_bucket(g.canonical() if eng.canonicalize else g,
                              T.serving.BucketPolicy())
    cfg = eng.config(b.n_u, b.n_v, b.depth)
    pool = ex.new_pool(cfg, 2, engine=eng)
    ex.install(pool, [0, 1],
               [eng.fresh_lane_state(cfg, x.n_u, "cpu") for x in gs],
               [eng.make_context(x, cfg, "cpu") for x in gs])
    cache = T.serving.ExecutableCache()
    ex.run_round(pool, cache, 2)
    return ex, pool, cache, eng, cfg, gs


@pytest.mark.parametrize("engine", ENGINES)
def test_snapshot_round_trips_bit_for_bit(engine):
    """snapshot -> host -> restore gives every leaf back bit for bit,
    dtype included (the word leaves as int32 bit patterns)."""
    ex, pool, _, _, _, _ = _running_pool(engine)
    lane = ex.lane(pool, 0)
    snap = snapshot_state(lane)
    assert all(isinstance(x, np.ndarray) and x.flags.owndata
               for x in snap)
    back = restore_state(snap, "cpu")
    assert type(back) is type(lane)
    for f, a, b in zip(lane._fields, lane, back):
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b), f


@pytest.mark.parametrize("engine", ENGINES)
def test_snapshot_does_not_alias_the_pool(engine):
    """A checkpoint taken, then two more rounds and an install on the
    same pool: the snapshot is unchanged while the lane moved on."""
    ex, pool, cache, eng, cfg, gs = _running_pool(engine)
    store = T.serving.CheckpointStore()
    store.put(7, ex.lane(pool, 0), queue_s=0.0, service_s=0.0,
              compile_s=0.0)
    kept = [x.copy() for x in store.get(7).state]
    steps0 = int(ex.lane(pool, 0).steps)
    ex.run_round(pool, cache, 2)
    ex.run_round(pool, cache, 2)
    ex.install(pool, [1], [eng.fresh_lane_state(cfg, gs[1].n_u, "cpu")],
               [eng.make_context(gs[1], cfg, "cpu")])
    assert int(ex.lane(pool, 0).steps) > steps0 or bool(
        eng.done(ex.lane(pool, 0)))
    for f, a, b in zip(ex.lane(pool, 0)._fields, kept,
                       store.get(7).state):
        np.testing.assert_array_equal(a, b, err_msg=f, strict=True)


class _BrokenExecutor(T.serving.LocalExecutor):
    """A local executor whose round raises a plain ``RuntimeError`` (a
    real kernel error, not an injected fault)."""

    def run_round(self, pool, cache, budget, unroll=1):
        raise RuntimeError("CUDA error: an illegal memory access")


def test_real_launch_error_is_not_retried():
    """``retry_on`` stays ``(FaultError,)``: a real launch error
    propagates at once — no retry, no quarantine, no failover."""
    srv = server(T, dict(max_batch=2, steps_per_round=16),
                 executor=_BrokenExecutor(device="cpu"),
                 retry=T.serving.RetryPolicy(max_attempts=5,
                                             backoff_s=1e-5),
                 fault_injector=T.serving.FaultPlan(seed=1))
    for g in _graphs(T, "dense", n=2):
        srv.admit(g)
    with pytest.raises(RuntimeError, match="illegal memory access") as e:
        srv.drain()
    assert not isinstance(e.value, T.serving.FaultError)
    s = srv.stats()
    assert s["retries"] == s["quarantined"] == s["failovers"] == 0
