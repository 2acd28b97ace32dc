"""The port's maximal clique engine (``repro_torch.core.engine_mce``) and
its oracle against the JAX package's.

* The oracles: ``enumerate_maximal_cliques`` / ``cliques_to_key_set`` on
  the reference tests' own graphs (``tests/test_engine_mce.py``).
* The engine's final state: the same ``random_unipartite`` graphs (n 24
  to 48) through both packages, for each order mode and each selection
  path — the torch-op path (``kernel_impl="jnp"``), the kernel path
  (``"pallas"``: K4's packed kind, JAX's in interpret mode, the port's
  plain version on CPU tensors) and the unfused path with
  ``impl="pallas"`` (K5) — every ``CliqueState`` leaf, the result fields
  and the decoded cliques equal (tolerance: exact; words as uint32).
* A served stream through both clients (``engine="mce"``): equal
  payloads, cliques, routing and stats.
"""
import numpy as np
import pytest

import repro
import repro_torch
from repro.baselines import oracles as j_oracles
from repro.core.engine import get_engine as j_get
from repro.data import generators as jgen
from repro_torch.baselines import oracles as t_oracles
from repro_torch.core import engine_dense as ted
from repro_torch.core.engine import get_engine as t_get
from repro_torch.data import generators as tgen

J_MCE, T_MCE = j_get("mce"), t_get("mce")
# (n, p, seed) of random_unipartite
CASES = [(24, 0.3, 1), (36, 0.25, 2), (48, 0.2, 3)]
# the reference tests' own suite (tests/test_engine_mce.py::_suite)
REF_SUITE = [(6, 0.5, 1), (10, 0.35, 2), (13, 0.3, 3), (16, 0.25, 4),
             (9, 0.6, 5)]


def _assert_leaves(j, t, msg):
    a = {f: np.asarray(getattr(j, f)) for f in j._fields}
    b = ted.state_to_numpy(t)
    assert set(a) == set(b), msg
    for f in a:
        assert a[f].dtype == b[f].dtype, f"{msg}:{f} dtype"
        np.testing.assert_array_equal(a[f], b[f], err_msg=f"{msg}:{f}",
                                      strict=True)


@pytest.mark.parametrize("case", REF_SUITE)
def test_oracle_matches_the_reference(case):
    jg, tg = jgen.random_unipartite(*case[:2], seed=case[2]), \
        tgen.random_unipartite(*case[:2], seed=case[2])
    got = t_oracles.enumerate_maximal_cliques(tg)
    assert got == j_oracles.enumerate_maximal_cliques(jg)
    assert t_oracles.cliques_to_key_set(got) == \
        j_oracles.cliques_to_key_set(got)


PATHS = {"torch ops": dict(kernel_impl="jnp"),
         "K4 packed": dict(kernel_impl="pallas"),
         "K5 unfused": dict(kernel_impl="jnp", impl="pallas")}


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("mode", ["deg", "deg_nocache", "input"])
@pytest.mark.parametrize("case", CASES)
def test_final_state_matches_jax(case, mode, path):
    n, p, seed = case
    jg, tg = jgen.random_unipartite(n, p, seed=seed), \
        tgen.random_unipartite(n, p, seed=seed)
    kw = dict(order_mode=mode, collect_cap=256, **PATHS[path])
    js = J_MCE.enumerate(jg, **kw)
    ts = T_MCE.enumerate(tg, device="cpu", **kw)
    _assert_leaves(js, ts, f"{case} {mode} {path}")
    jcfg, tcfg = J_MCE.make_config(jg, **kw), T_MCE.make_config(tg, **kw)
    jf = J_MCE.finish(jcfg, js, n_u=n, n_v=n, collect=True)
    tf = T_MCE.finish(tcfg, ts, n_u=n, n_v=n, collect=True)
    assert tf == jf
    assert set(tf["cliques"]) == t_oracles.cliques_to_key_set(
        t_oracles.enumerate_maximal_cliques(tg))


def test_stream_through_both_clients():
    kw = dict(engine="mce", collect=True, collect_cap=256, max_batch=2,
              steps_per_round=128)
    jr = repro.MBEClient(repro.MBEOptions(**kw))
    tr = repro_torch.MBEClient(repro_torch.MBEOptions(device="cpu", **kw))
    jgs = [jgen.random_unipartite(*c[:2], seed=c[2]) for c in REF_SUITE]
    tgs = [tgen.random_unipartite(*c[:2], seed=c[2]) for c in REF_SUITE]
    a, b = jr.enumerate_many(jgs), tr.enumerate_many(tgs)
    fields = ("rid", "name", "status", "n_max", "cs", "steps", "nodes",
              "cliques", "truncated", "metric")
    assert [[getattr(r, f) for f in fields] for r in b] == \
        [[getattr(r, f) for f in fields] for r in a]
    assert all(type(r).__name__ == "CliqueResult" for r in b)
    assert tr.routing_log == jr.routing_log
    for k in ("batches", "busy_steps", "total_lane_steps", "launches",
              "misses", "hits", "engine"):
        assert tr.stats()[k] == jr.stats()[k], k


def test_rejects_non_square_and_pads_safely():
    with pytest.raises(ValueError, match="n_u == n_v"):
        T_MCE.enumerate(tgen.random_bipartite(4, 6, 0.5, seed=0),
                        device="cpu")
    g = tgen.random_unipartite(9, 0.45, seed=13)
    ref = len(t_oracles.enumerate_maximal_cliques(g))
    for mode in ("exact", "pow2"):
        r = repro_torch.MBEClient(repro_torch.MBEOptions(
            engine="mce", bucket_mode=mode, device="cpu")).enumerate(g)
        assert r.n_max == ref, mode
