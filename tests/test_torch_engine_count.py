"""The port's (p,q)-biclique counting engine
(``repro_torch.core.engine_count``) and its oracle against the JAX
package's.

* The oracle ``count_pq_bicliques`` on the reference tests' own graphs
  (``tests/test_engine_count.py``) at (p, q) in (1,1), (1,2), (2,2),
  (2,3), (3,2).
* The engine's final state on ``dataset_suite("test")`` at the same
  (p, q): every ``CountState`` leaf equal to the JAX engine's
  (tolerance: exact), the count equal to the oracle; and a count past
  2**31 - 1 that wraps the int32 accumulator as the reference's does.
* A served stream through both clients: equal payloads, routing, stats
  and cache keys ((p, q) rides the config into the key).
"""
import dataclasses

import numpy as np
import pytest
from _graphs import random_graph

import repro
import repro_torch
from repro.baselines import oracles as j_oracles
from repro.core.engine import get_engine as j_get
from repro.core.graph import BipartiteGraph as JGraph
from repro.data import generators as jgen
from repro_torch.baselines import oracles as t_oracles
from repro_torch.core import engine_dense as ted
from repro_torch.core.engine import get_engine as t_get
from repro_torch.core.graph import BipartiteGraph
from repro_torch.data import generators as tgen

J_COUNT, T_COUNT = j_get("count"), t_get("count")
PQ = [(1, 1), (1, 2), (2, 2), (2, 3), (3, 2)]
# the reference tests' own suite (tests/test_engine_count.py::_suite)
REF_SUITE = [(6, 9, 0.5, 1), (10, 14, 0.3, 2), (12, 8, 0.45, 3),
             (5, 5, 0.7, 4), (16, 10, 0.25, 5)]
NAMES = sorted(tgen.dataset_suite("test"))


def _port(g):
    return BipartiteGraph.from_edges(g.n_u, g.n_v, g.edges, name=g.name)


def _assert_leaves(j, t, msg):
    a = {f: np.asarray(getattr(j, f)) for f in j._fields}
    b = ted.state_to_numpy(t)
    assert set(a) == set(b), msg
    for f in a:
        assert a[f].dtype == b[f].dtype, f"{msg}:{f} dtype"
        np.testing.assert_array_equal(a[f], b[f], err_msg=f"{msg}:{f}",
                                      strict=True)


@pytest.mark.parametrize("p,q", PQ)
def test_oracle_matches_the_reference(p, q):
    for case in REF_SUITE:
        g = random_graph(*case)
        assert t_oracles.count_pq_bicliques(_port(g), p, q) == \
            j_oracles.count_pq_bicliques(g, p, q), (case, p, q)
    with pytest.raises(ValueError, match="p and q"):
        t_oracles.count_pq_bicliques(_port(g), 0, q)


@pytest.mark.parametrize("p,q", PQ)
@pytest.mark.parametrize("name", NAMES)
def test_final_state_matches_jax(name, p, q):
    jg, tg = jgen.dataset_suite("test")[name], tgen.dataset_suite("test")[name]
    js = J_COUNT.enumerate(jg, count_pq=(p, q))
    ts = T_COUNT.enumerate(tg, count_pq=(p, q), device="cpu")
    _assert_leaves(js, ts, f"{name} ({p}, {q})")
    assert int(ts.count) == t_oracles.count_pq_bicliques(tg, p, q)
    cfg = T_COUNT.make_config(tg, count_pq=(p, q))
    assert T_COUNT.finish(cfg, ts, n_u=tg.n_u, n_v=tg.n_v) == \
        J_COUNT.finish(J_COUNT.make_config(jg, count_pq=(p, q)), js,
                       n_u=jg.n_u, n_v=jg.n_v)


def test_counter_wraps_as_the_reference():
    """K_{40,64} at (1, 8): every root adds C(64, 8) clamped to 2**31 - 1,
    so the int32 accumulator wraps; both packages wrap alike."""
    edges = [(u, v) for u in range(40) for v in range(64)]
    jg = JGraph.from_edges(40, 64, edges)
    tg = BipartiteGraph.from_edges(40, 64, edges)
    js = J_COUNT.enumerate(jg, count_pq=(1, 8))
    ts = T_COUNT.enumerate(tg, count_pq=(1, 8), device="cpu")
    _assert_leaves(js, ts, "K_{40,64}")
    assert int(ts.count) != t_oracles.count_pq_bicliques(tg, 1, 8)


def test_degenerate_pq_raises():
    g = tgen.dataset_suite("test")["corp-leadership"]
    for pq in ((0, 2), (2, 0)):
        with pytest.raises(ValueError, match="p >= 1 and q >= 1"):
            T_COUNT.enumerate(g, count_pq=pq, device="cpu")


def test_stream_through_both_clients():
    kw = dict(engine="count", count_p=2, count_q=3, max_batch=2,
              steps_per_round=64)
    jc = repro.MBEClient(repro.MBEOptions(**kw))
    tc = repro_torch.MBEClient(repro_torch.MBEOptions(device="cpu", **kw))
    a = jc.enumerate_many([jgen.dataset_suite("test")[n] for n in NAMES])
    b = tc.enumerate_many([tgen.dataset_suite("test")[n] for n in NAMES])
    fields = ("rid", "name", "status", "count", "p", "q", "steps", "nodes",
              "metric")
    assert [[getattr(r, f) for f in fields] for r in b] == \
        [[getattr(r, f) for f in fields] for r in a]
    assert all(type(r).__name__ == "CountResult" for r in b)
    assert tc.routing_log == jc.routing_log
    for k in ("batches", "busy_steps", "total_lane_steps", "launches",
              "misses", "hits", "engine"):
        assert tc.stats()[k] == jc.stats()[k], k
    keys = list(tc.server.cache._entries)
    assert [(k[0][0], dataclasses.astuple(k[0][1])) + k[1:] for k in keys] \
        == [(k[0][0], dataclasses.astuple(k[0][1])) + k[1:]
            for k in jc.server.cache._entries]
    assert all(k[0][1].count_pq == (2, 3) for k in keys)
