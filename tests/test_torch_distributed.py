"""The port's work-stealing rounds (``repro_torch.core.distributed``) and
big-graph lane against the JAX package's, on one device.

* The re-deal helpers on the same queues: equal flat lists and deals.
* The worker states after EVERY round: the port's ``make_round_fn`` (4
  workers on one CPU device) against the reference's on a one-device CPU
  mesh (``jax.devices()[:1]``), stealing on and off, every leaf and the
  telemetry equal (tolerance: exact), for the dense engine (torch-op
  path, and the K3 pool path's plain version) and for ``mce`` / ``count``.
* Exactly once: every root task is executed once across barriers
  (``tests/test_workstealing.py``'s invariant), here 4 workers on one
  device, stealing on and off, totals = the serial oracle.
* The big lane served through both clients (``tests/test_executors.py``'s
  local big-lane case): equal payloads, decoded bicliques, routing log,
  ``big_busy_per_worker``; the step cap on the big route in both forms;
  ``launch/mbe_run.py`` through both packages; the ``cumbe`` config.
"""
import dataclasses
from collections import Counter

import numpy as np
import jax
import pytest
import torch
from jax.sharding import Mesh

import repro
import repro_torch
from repro import configs as j_configs
from repro.configs import cumbe as j_cumbe
from repro.core import distributed as jdd
from repro.core.engine import get_engine as j_get
from repro.data import generators as jgen
from repro.launch import mbe_run as j_mbe_run
from repro_torch import configs as t_configs
from repro_torch.configs import cumbe as t_cumbe
from repro_torch.baselines.mbea import enumerate_mbea
from repro_torch.core import distributed as tdd
from repro_torch.core import engine_dense as ted
from repro_torch.core.engine import get_engine as t_get
from repro_torch.data import generators as tgen
from repro_torch.launch import mbe_run as t_mbe_run

W = 4
MESH = Mesh(np.array(jax.devices()[:1]), ("workers",))
T_MESH = tdd.Mesh(["cpu"], ("workers",))


def _np(j):
    return {f: np.asarray(getattr(j, f)) for f in j._fields}


def _assert_leaves(j, t, msg):
    a, b = _np(j), ted.state_to_numpy(t)
    assert set(a) == set(b), msg
    for f in a:
        assert a[f].dtype == b[f].dtype, f"{msg}:{f} dtype"
        np.testing.assert_array_equal(a[f], b[f], err_msg=f"{msg}:{f}",
                                      strict=True)


def test_flatten_and_deal_match_the_reference():
    rng = np.random.default_rng(0)
    for Wk, T in ((1, 5), (4, 9), (7, 16)):
        tasks = rng.integers(-1, 40, (Wk, T)).astype(np.int32)
        n_tasks = rng.integers(0, T + 1, Wk).astype(np.int32)
        tpos = np.minimum(rng.integers(0, T + 1, Wk), n_tasks) \
            .astype(np.int32)
        jf, jt = jdd._flatten_pending(tasks, tpos, n_tasks)
        tf, tt = tdd._flatten_pending(torch.from_numpy(tasks),
                                      torch.from_numpy(tpos),
                                      torch.from_numpy(n_tasks))
        np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
        assert int(jt) == int(tt)
        deal = tdd._deal_strided(tf, tt, Wk, T)
        for w in range(Wk):
            jtasks, jn = jdd._deal_strided(jf, jt, w, Wk, T)
            np.testing.assert_array_equal(np.asarray(jtasks),
                                          deal[0][w].numpy())
            assert int(jn) == int(deal[1][w])


def _pair(engine, name, graphs=None, **cfg_kw):
    """(reference graph, port graph, reference cfg, port cfg)."""
    jg, tg = graphs if graphs else (jgen.dataset_suite("test")[name],
                                    tgen.dataset_suite("test")[name])
    je, te = j_get(engine), t_get(engine)
    return jg, tg, je.make_config(jg, **cfg_kw), te.make_config(tg, **cfg_kw)


def _rounds(engine, jg, tg, jcfg, tcfg, ws, spr, *, spc=1):
    """Both packages' rounds in lockstep from the same strided deal;
    every leaf and the telemetry equal after every round.  Returns the
    port's per-round states."""
    je, te = j_get(engine), t_get(engine)
    dist_j = jdd.DistConfig(steps_per_round=spr, workers_per_device=W,
                            work_stealing=ws, steps_per_call=spc)
    dist_t = tdd.DistConfig(steps_per_round=spr, workers_per_device=W,
                            work_stealing=ws, steps_per_call=spc)
    jfn, nw, T = jdd.make_round_fn(jcfg, MESH, ("workers",), dist_j,
                                   with_telemetry=True, engine=je)
    tfn, tnw, tT = tdd.make_round_fn(tcfg, T_MESH, ("workers",), dist_t,
                                     with_telemetry=True, engine=te)
    assert (nw, T) == (tnw, tT)
    jctx, tctx = je.make_context(jg, jcfg), te.make_context(tg, tcfg, "cpu")
    per = []
    for w in range(W):
        tasks = np.arange(w, jg.n_u, W, dtype=np.int32)
        pad = np.full(T, -1, np.int32)
        pad[: len(tasks)] = tasks
        per.append(je.init_state(jcfg, tasks)._replace(
            tasks=jax.numpy.asarray(pad)))
    js = jax.tree.map(lambda *xs: jax.numpy.stack(xs), *per)
    ts = tdd.strided_states(te, tcfg, tg.n_u, W, "cpu")
    _assert_leaves(js, ts, "deal")
    states = []
    for r in range(200):
        js, jtel = jfn(jctx, js)
        ts, ttel = tfn(tctx, ts)
        ts = ts.gather()
        msg = f"{engine} ws={ws} round {r}"
        _assert_leaves(js, ts, msg)
        for k in ("busy_steps", "pending"):
            np.testing.assert_array_equal(np.asarray(jtel[k]),
                                          ttel[k].numpy(), err_msg=msg)
        states.append(ts)
        if bool(te.done(ts).all()):
            break
    assert bool(np.asarray(je.done(js)).all()) and len(states) > 2
    return states


@pytest.mark.parametrize("ws", [True, False])
@pytest.mark.parametrize("kernel_impl", ["jnp", "pallas"])
def test_dense_worker_states_after_every_round(ws, kernel_impl):
    """Dense engine, ``order_mode="deg"``: on the port's side
    ``kernel_impl="pallas"`` runs every round as the K3 pool segment on
    one shared adjacency (its plain version on the CPU); the reference
    runs its vmapped ``run``."""
    jg, tg, jcfg, tcfg = _pair("dense", "community-tiny")
    tcfg = dataclasses.replace(tcfg, kernel_impl=kernel_impl)
    states = _rounds("dense", jg, tg, jcfg, tcfg, ws, spr=24)
    tot = tdd.totals(states[-1])
    ref = ted.enumerate_dense(tg, device="cpu")
    assert (tot["n_max"], tot["cs"]) == \
        (int(ref.n_max), int(ref.cs) % (1 << 32))


@pytest.mark.parametrize("engine,kw", [
    ("mce", dict(order_mode="deg")), ("mce", dict(order_mode="input")),
    ("count", dict(count_pq=(2, 2))), ("count", dict(count_pq=(3, 2)))])
def test_engine_worker_states_after_every_round(engine, kw):
    if engine == "mce":
        graphs = (jgen.random_unipartite(24, 0.3, seed=3),
                  tgen.random_unipartite(24, 0.3, seed=3))
        jg, tg, jcfg, tcfg = _pair(engine, None, graphs, **kw)
    else:
        jg, tg, jcfg, tcfg = _pair(engine, "ucforum-like", **kw)
    _rounds(engine, jg, tg, jcfg, tcfg, True, spr=16, spc=3)


def _pending(state) -> Counter:
    out = Counter()
    for w in range(state.tasks.shape[0]):
        t, n = int(state.tpos[w]), int(state.n_tasks[w])
        out.update(state.tasks[w, t:n].tolist())
    return out


@pytest.mark.parametrize("ws", [True, False])
def test_every_root_task_runs_exactly_once(ws):
    """``tests/test_workstealing.py``'s invariant with 4 workers on one
    device: the tasks consumed per round (pending before minus pending
    after) sum to the root set with multiplicity one, and the totals are
    the serial oracle's and the single lane's."""
    g = tgen.dataset_suite("test")["community-tiny"]
    cfg = ted.make_config(g)
    dist = tdd.DistConfig(steps_per_round=24, workers_per_device=W,
                          work_stealing=ws)
    init, roundf, _ = tdd.make_distributed_runner(g, cfg, T_MESH, None,
                                                  dist)
    state = init().gather()
    pend = _pending(state)
    assert sorted(pend.elements()) == list(range(cfg.m_real))
    executed = Counter()
    for _ in range(dist.max_rounds):
        state = roundf(state).gather()
        after = _pending(state)
        consumed = pend - after
        assert sum(consumed.values()) == \
            sum(pend.values()) - sum(after.values())
        executed.update(consumed)
        pend = after
        if bool(ted._done(state).all()):
            break
    assert not pend
    assert all(v == 1 for v in executed.values())
    assert sorted(executed.elements()) == list(range(cfg.m_real))
    tot = tdd.totals(state)
    ref = ted.enumerate_dense(g, device="cpu")
    assert tot["n_max"] == len(enumerate_mbea(g))
    assert tot["cs"] == int(ref.cs) % (1 << 32)


def test_runner_loop_and_one_device_only():
    """The runner's driver on a one-device mesh; the same driver on a
    CPU mesh of 2 devices (3 workers each, see
    ``tests/test_torch_mesh.py``) gives the same totals."""
    g = tgen.dataset_suite("test")["ucforum-like"]
    cfg = ted.make_config(g)
    dist = tdd.DistConfig(steps_per_round=16, workers_per_device=3)
    _, _, driver = tdd.make_distributed_runner(g, cfg, T_MESH, None, dist)
    state, log = driver()
    assert tdd.totals(state)["n_max"] == len(enumerate_mbea(g))
    assert log[-1]["done"] == 3 and len(log) > 1
    mesh2 = tdd.Mesh(["cpu"] * 2, ("workers",))
    _, _, driver2 = tdd.make_distributed_runner(g, cfg, mesh2, None, dist)
    state2, log2 = driver2()
    assert log2[-1]["done"] == 6
    assert {k: v for k, v in tdd.totals(state2).items() if k != "steps"} \
        == {k: v for k, v in tdd.totals(state).items() if k != "steps"}


def _payload(r):
    return {k: getattr(r, k) for k in r.__dataclass_fields__
            if not k.endswith("_s")}


def _both(kw, jgraphs, tgraphs):
    """The same stream through both clients: payloads, routing and the
    big lane's per-worker busy steps equal."""
    jc = repro.MBEClient(repro.MBEOptions(**kw))
    tc = repro_torch.MBEClient(repro_torch.MBEOptions(device="cpu", **kw))
    jr, tr = jc.enumerate_many(jgraphs), tc.enumerate_many(tgraphs)
    assert [_payload(r) for r in tr] == [_payload(r) for r in jr]
    assert tc.routing_log == jc.routing_log
    js, ts = jc.stats(), tc.stats()
    for k in ("big_busy_per_worker", "big_imbalance", "batches",
              "busy_steps", "total_lane_steps", "launches", "misses",
              "hits", "pending", "in_flight"):
        assert ts[k] == js[k], k
    return tr, ts


@pytest.mark.parametrize("ws", [True, False])
def test_local_big_lane_through_both_clients(ws):
    """``tests/test_executors.py``'s local big-lane case: one heavy graph
    as 4 stealing workers, with a light graph on the lane route beside
    it, collected bicliques included."""
    kw = dict(bucket_mode="pow2", steps_per_round=32, big_graph_threshold=16,
              collect=True, collect_cap=2048, big_workers=4,
              work_stealing=ws)
    jh = jgen.dense_small(18, 36, p=0.5, seed=7, name="heavy")
    th = tgen.dense_small(18, 36, p=0.5, seed=7, name="heavy")
    jl = jgen.random_bipartite(8, 20, 0.25, seed=0, name="light")
    tl = tgen.random_bipartite(8, 20, 0.25, seed=0, name="light")
    tr, ts = _both(kw, [jh, jl], [th, tl])
    ref = ted.enumerate_dense(th.canonical(), collect_cap=2048, device="cpu")
    assert (tr[0].n_max, tr[0].cs) == (int(ref.n_max),
                                       int(ref.cs) % (1 << 32))
    assert not tr[0].truncated and len(tr[0].bicliques) == tr[0].n_max
    assert len(ts["big_busy_per_worker"]) == 4
    assert sum(b > 0 for b in ts["big_busy_per_worker"]) >= 2


@pytest.mark.parametrize("engine,kw", [
    ("compact", {}), ("mce", dict(collect=True, collect_cap=256)),
    ("count", dict(count_p=2, count_q=3))])
def test_other_engines_through_the_big_lane(engine, kw):
    if engine == "mce":
        jgs = [jgen.random_unipartite(n, 0.3, seed=n) for n in (14, 30)]
        tgs = [tgen.random_unipartite(n, 0.3, seed=n) for n in (14, 30)]
    else:
        names = ["corp-leadership", "ucforum-like"]
        jgs = [jgen.dataset_suite("test")[n] for n in names]
        tgs = [tgen.dataset_suite("test")[n] for n in names]
    _both(dict(engine=engine, big_graph_threshold=1, steps_per_round=64,
               big_workers=4, **kw), jgs, tgs)


@pytest.mark.parametrize("strict", [False, True])
def test_big_lane_step_cap(strict):
    """A runaway routed-big graph: a typed ``step_capped`` result (the
    light request still served), or evict-then-raise under
    ``strict_step_cap``; both packages alike."""
    out = []
    for pkg, gen, kw in ((repro, jgen, {}),
                         (repro_torch, tgen, dict(device="cpu"))):
        heavy = gen.dense_small(16, 32, p=0.55, seed=3, name="runaway")
        light = gen.random_bipartite(8, 20, 0.2, seed=0, name="light")
        c = pkg.MBEClient(pkg.MBEOptions(
            steps_per_round=64, big_graph_threshold=14, max_graph_steps=256,
            big_workers=2, strict_step_cap=strict, **kw))
        rid_h, rid_l = c.server.admit(heavy), c.server.admit(light)
        if strict:
            with pytest.raises(RuntimeError, match="max_graph_steps"):
                c.server.drain()
            got = c.server.drain()
        else:
            got = c.server.drain()
        assert c.stats()["in_flight"] == 0
        out.append(({k: _payload(v) for k, v in got.items()},
                    c.routing_log, c.stats()["big_busy_per_worker"]))
        if not strict:
            assert got[rid_h].status == "step_capped"
        assert rid_l in got
    assert out[0] == out[1]


def test_mbe_run_through_both_packages():
    argv = ["--suite", "test", "--workers", "3", "--steps-per-round", "32"]
    j = j_mbe_run.main(argv)
    t = t_mbe_run.main(argv, device="cpu")
    for k in ("metric", "nodes", "rounds", "imbalance", "engine", "n_max"):
        assert t[k] == j[k], k
    t2 = t_mbe_run.main(argv + ["--no-work-stealing"], device="cpu")
    assert (t2["metric"], t2["n_max"]) == (t["metric"], t["n_max"])


def test_cumbe_config_matches_the_reference():
    for name in ("CONFIG", "SMOKE"):
        assert dataclasses.asdict(getattr(t_cumbe, name)) == \
            dataclasses.asdict(getattr(j_cumbe, name))
    assert dataclasses.asdict(t_configs.get_config("cumbe")) == \
        dataclasses.asdict(j_configs.get_config("cumbe"))
    assert t_configs.get_config("cumbe").engine_config() == \
        ted.EngineConfig(**dataclasses.asdict(
            j_configs.get_config("cumbe").engine_config()))
