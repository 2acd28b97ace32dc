"""The port's dense engine (``repro_torch.core.engine_dense``) against the
JAX package's, leaf for leaf at every segment boundary.

Both packages get the same graphs (``dataset_suite("test")`` builds
identical ``adj_u`` words in each) and advance in segments of a bounded
step budget; after every segment all 19 ``DenseState`` leaves must be
equal (tolerance: exact; words compared as uint32).  JAX runs its jnp
path here; ``test_torch_engine_kernel_path.py`` holds the port's kernel
path against JAX's Pallas interpret mode.  Final ``n_max``/``cs`` must
equal the JAX package's serial oracle."""
import dataclasses

import numpy as np
import jax
import pytest
import torch

from repro.baselines.mbea import enumerate_mbea
from repro.core import engine_dense as jed
from repro.data.generators import dataset_suite as j_suite
from repro_torch.baselines.mbea import pair_checksum_sum
from repro_torch.core import engine_dense as ted
from repro_torch.data.generators import dataset_suite as t_suite

MODES = ["deg", "deg_nocache", "input"]
J_GRAPHS = j_suite("test")
T_GRAPHS = t_suite("test")


def _jax_np(s):
    return {f: np.asarray(getattr(s, f)) for f in s._fields}


def _assert_leaves(j, t, msg):
    a, b = _jax_np(j), ted.state_to_numpy(t)
    for f in a:
        assert a[f].dtype == b[f].dtype, f"{msg}:{f} dtype"
        np.testing.assert_array_equal(a[f], b[f], err_msg=f"{msg}:{f}")


def _lockstep(name, seg_steps=40, unroll=1, **cfg_kw):
    """Advance both engines in bounded segments from the same fresh state,
    comparing every leaf at every boundary; returns the final port
    state."""
    jg, tg = J_GRAPHS[name], T_GRAPHS[name]
    np.testing.assert_array_equal(jg.adj_u, tg.adj_u)
    jcfg = jed.make_config(jg, **cfg_kw)
    tcfg = ted.make_config(tg, **cfg_kw)
    jctx = jed.make_context(jg, jcfg)
    tctx = ted.make_context(tg, tcfg, "cpu")
    _assert_leaves(jctx, tctx, f"{name} ctx")
    tasks = np.arange(jg.n_u, dtype=np.int32)
    js, ts = jed.init_state(jcfg, tasks), ted.init_state(tcfg, tasks, "cpu")
    run_j = jax.jit(lambda st: jed.run(jctx, jcfg, st, max_steps=seg_steps,
                                       unroll=unroll))
    seg = 0
    while not bool(jed._done(js)):
        js = run_j(js)
        ts = ted.run(tctx, tcfg, ts, max_steps=seg_steps, unroll=unroll)
        _assert_leaves(js, ts, f"{name} {cfg_kw} seg {seg}")
        seg += 1
    assert bool(ted._done(ts)) and seg > 1
    return tg, ts


def _oracle(g):
    bic = enumerate_mbea(g)
    return len(bic), pair_checksum_sum(bic, g.n_u, g.n_v)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(T_GRAPHS))
def test_leaves_match_jax_jnp_every_boundary(name, mode):
    g, s = _lockstep(name, order_mode=mode, kernel_impl="jnp")
    assert (int(s.n_max), int(s.cs) % (1 << 32)) == _oracle(g)


def test_start_from_a_shared_mid_run_state():
    """state_from_numpy / context_from_numpy carry a JAX mid-run state
    into the port; both continue to identical leaves."""
    jg = J_GRAPHS["community-tiny"]
    cfg_kw = dict(order_mode="deg", kernel_impl="jnp", collect_cap=8)
    jcfg = jed.make_config(jg, **cfg_kw)
    jctx = jed.make_context(jg, jcfg)
    js = jed.init_state(jcfg, np.arange(jg.n_u, dtype=np.int32))
    js = jax.jit(lambda st: jed.run(jctx, jcfg, st, max_steps=57))(js)
    tctx = ted.context_from_numpy(
        jed.GraphContext(*[np.asarray(x) for x in jctx]), "cpu")
    ts = ted.state_from_numpy(
        jed.DenseState(*[np.asarray(x) for x in js]), "cpu")
    _assert_leaves(js, ts, "converted")
    tcfg = ted.EngineConfig(**dataclasses.asdict(jcfg))
    js2 = jax.jit(lambda st: jed.run(jctx, jcfg, st, max_steps=64))(js)
    ts2 = ted.run(tctx, tcfg, ts, max_steps=64)
    _assert_leaves(js2, ts2, "continued")
    # the port's run is functional: its input state is untouched
    _assert_leaves(js, ts, "input unchanged")


def test_collected_bicliques_and_lane_surgery_match_jax():
    jg = J_GRAPHS["corp-leadership"]
    tg = T_GRAPHS["corp-leadership"]
    kw = dict(order_mode="deg", kernel_impl="jnp", collect_cap=256)
    jcfg, tcfg = jed.make_config(jg, **kw), ted.make_config(tg, **kw)
    js = jed.enumerate_dense(jg, collect_cap=256, kernel_impl="jnp")
    ts = ted.enumerate_dense(tg, collect_cap=256, kernel_impl="jnp",
                             device="cpu")
    assert ted.collected_bicliques(tcfg, ts, tg.n_u, tg.n_v) == \
        jed.collected_bicliques(jcfg, js, jg.n_u, jg.n_v)
    # replace_lanes: rows idx take the new lanes, the others stay put
    tctx = ted.make_context(tg, tcfg, "cpu")
    fresh = ted.init_state(tcfg, np.arange(tg.n_u, dtype=np.int32), "cpu")
    batch = ted._stack([fresh] * 3)
    bctx = ted._stack([tctx] * 3)
    b2, c2 = ted.replace_lanes(batch, bctx, [2], ted._stack([ts]),
                               ted._stack([tctx]))
    assert torch.equal(b2.cs[2], ts.cs) and torch.equal(b2.cs[0], fresh.cs)
    assert torch.equal(batch.cs[2], fresh.cs)       # functional
    b3, _ = ted.replace_lane(b2, c2, 2, fresh, tctx)
    for x, y in zip(b3, batch):
        assert torch.equal(x, y)


@pytest.mark.parametrize("ctx_batched", [False, True])
def test_run_batch_matches_jax_vmap(ctx_batched):
    names = ["ucforum-like", "powerlaw-tiny", "unicode-like"]
    n_u = max(T_GRAPHS[n].n_u for n in names)
    n_v = max(T_GRAPHS[n].n_v for n in names)
    kw = dict(n_u=n_u, n_v=n_v, m_real=n_u, depth=n_u + 2,
              order_mode="deg", kernel_impl="jnp")
    jcfg, tcfg = jed.EngineConfig(**kw), ted.EngineConfig(**kw)
    if ctx_batched:
        jctx = jax.tree.map(lambda *x: jax.numpy.stack(x), *[
            jed.make_context(J_GRAPHS[n], jcfg) for n in names])
        tasks = [np.arange(J_GRAPHS[n].n_u, dtype=np.int32) for n in names]
    else:
        g = J_GRAPHS["ucforum-like"]
        jctx = jed.make_context(g, jcfg)
        tasks = [np.arange(i, g.n_u, 3, dtype=np.int32) for i in range(3)]
    t_len = max(len(t) for t in tasks)
    states = []
    for t in tasks:
        pad = np.full(t_len, -1, np.int32)
        pad[: len(t)] = t
        states.append(jed.init_state(jcfg, pad)._replace(
            n_tasks=np.int32(len(t))))
    js = jax.tree.map(lambda *x: np.stack(x), *[
        jax.tree.map(np.asarray, s) for s in states])
    tctx = ted.context_from_numpy(
        jed.GraphContext(*[np.asarray(x) for x in jctx]), "cpu")
    ts = ted.state_from_numpy(jed.DenseState(*js), "cpu")
    run_j = jax.jit(lambda st: jed.run_batch(jctx, jcfg, st, max_steps=90,
                                             ctx_batched=ctx_batched,
                                             unroll=2))
    while True:
        js = run_j(js)
        ts = ted.run_batch(tctx, tcfg, ts, max_steps=90,
                           ctx_batched=ctx_batched, unroll=2)
        _assert_leaves(js, ts, f"run_batch ctx_batched={ctx_batched}")
        if bool(np.all(np.asarray(jed._done(js)))):
            break
