"""The port's compact-array engine (``repro_torch.core.engine_compact``)
against the JAX package's, leaf for leaf at every segment boundary.

Both packages get the same graphs (``dataset_suite("test")``) and advance
in segments of a bounded step budget; after every segment all 21
``CompactState`` leaves must be equal (tolerance: exact; words compared
as uint32).  ``kernel_impl="pallas"`` runs JAX's Pallas kernels in
interpret mode and the port's kernel wrappers on CPU tensors (their
plain versions); ``"jnp"`` the torch-op path.  Final ``n_max``/``cs``
must equal the JAX package's serial oracle and the port's dense engine."""
import dataclasses

import numpy as np
import jax
import pytest
import torch

from repro.core import engine_compact as jec
from repro.core import engine_dense as jed
from repro.core.engine import COMPACT as J_COMPACT
from repro_torch.core import engine_compact as tec
from repro_torch.core import engine_dense as ted
from repro_torch.core.engine import COMPACT
from test_torch_engine_dense import J_GRAPHS, T_GRAPHS, _oracle


def _assert_leaves(j, t, msg):
    a = {f: np.asarray(getattr(j, f)) for f in j._fields}
    b = tec.state_to_numpy(t)
    for f in a:
        assert a[f].dtype == b[f].dtype, f"{msg}:{f} dtype"
        np.testing.assert_array_equal(a[f], b[f], err_msg=f"{msg}:{f}",
                                      strict=True)


def _lockstep(name, seg_steps=40, unroll=1, **cfg_kw):
    jg, tg = J_GRAPHS[name], T_GRAPHS[name]
    jcfg = jed.make_config(jg, **cfg_kw)
    tcfg = ted.make_config(tg, **cfg_kw)
    jctx = jec.make_context(jg, jcfg)
    tctx = tec.make_context(tg, tcfg, "cpu")
    _assert_leaves(jctx, tctx, f"{name} ctx")
    tasks = np.arange(jg.n_u, dtype=np.int32)
    js, ts = jec.init_state(jcfg, tasks), tec.init_state(tcfg, tasks, "cpu")
    run_j = jax.jit(lambda st: jec.run(jctx, jcfg, st, max_steps=seg_steps,
                                       unroll=unroll))
    seg = 0
    while not bool(jec._done(js)):
        js = run_j(js)
        ts = tec.run(tctx, tcfg, ts, max_steps=seg_steps, unroll=unroll)
        _assert_leaves(js, ts, f"{name} {cfg_kw} seg {seg}")
        seg += 1
    assert bool(ted._done(ts)) and seg > 1
    return tg, ts


@pytest.mark.parametrize("mode", ["deg", "input"])
@pytest.mark.parametrize("kernel_impl", ["jnp", "pallas"])
@pytest.mark.parametrize("name", sorted(T_GRAPHS))
def test_leaves_match_jax_every_boundary(name, kernel_impl, mode):
    g, s = _lockstep(name, order_mode=mode, kernel_impl=kernel_impl)
    got = (int(s.n_max), int(s.cs) % (1 << 32))
    assert got == _oracle(g)
    d = ted.enumerate_dense(g, order_mode=mode, kernel_impl="jnp",
                            device="cpu")
    assert got == (int(d.n_max), int(d.cs) % (1 << 32))


def test_unfused_pallas_impl_matches_jax_interpret():
    """The unfused path with ``impl="pallas"``: JAX's intersect_count
    kernel in interpret mode against the port's gathered intersect_count
    wrapper (three calls a step), with ``unroll``."""
    _lockstep("corp-leadership", seg_steps=30, unroll=3, order_mode="deg",
              kernel_impl="jnp", impl="pallas")


@pytest.mark.parametrize("ctx_batched", [False, True])
def test_run_batch_matches_jax(ctx_batched):
    names = ["ucforum-like", "powerlaw-tiny", "unicode-like"]
    n_u = max(T_GRAPHS[n].n_u for n in names)
    n_v = max(T_GRAPHS[n].n_v for n in names)
    kw = dict(n_u=n_u, n_v=n_v, m_real=n_u, depth=n_u + 2,
              order_mode="deg", kernel_impl="pallas", collect_cap=4)
    jcfg, tcfg = jed.EngineConfig(**kw), ted.EngineConfig(**kw)
    if ctx_batched:
        jctx = jax.tree.map(lambda *x: jax.numpy.stack(x), *[
            jec.make_context(J_GRAPHS[n], jcfg) for n in names])
        tasks = [np.arange(J_GRAPHS[n].n_u, dtype=np.int32) for n in names]
    else:
        g = J_GRAPHS["ucforum-like"]
        jcfg = dataclasses.replace(jcfg, m_real=g.n_u)
        tcfg = dataclasses.replace(tcfg, m_real=g.n_u)
        jctx = jec.make_context(g, jcfg)
        tasks = [np.arange(i, g.n_u, 3, dtype=np.int32) for i in range(3)]
    t_len = max(len(t) for t in tasks)
    states = []
    for t in tasks:
        pad = np.full(t_len, -1, np.int32)
        pad[: len(t)] = t
        states.append(jec.init_state(jcfg, pad)._replace(
            n_tasks=np.int32(len(t))))
    js = jax.tree.map(lambda *x: np.stack(x), *[
        jax.tree.map(np.asarray, s) for s in states])
    tctx = tec.context_from_numpy(
        jec.CompactContext(*[np.asarray(x) for x in jctx]), "cpu")
    ts = tec.state_from_numpy(jec.CompactState(*js), "cpu")
    run_j = jax.jit(lambda st: J_COMPACT.run_batch(
        jctx, jcfg, st, max_steps=90, ctx_batched=ctx_batched, unroll=2))
    while True:
        js = run_j(js)
        ts = COMPACT.run_batch(tctx, tcfg, ts, max_steps=90,
                               ctx_batched=ctx_batched, unroll=2)
        _assert_leaves(js, ts, f"run_batch ctx_batched={ctx_batched}")
        if bool(np.all(np.asarray(jec._done(js)))):
            break


def test_mid_run_state_collect_and_functional_step():
    """state_from_numpy / context_from_numpy carry a JAX mid-run state into
    the port, both continue to identical leaves, ``step`` and ``run`` leave
    their input untouched, and the collect buffer decodes to JAX's
    bicliques."""
    jg = J_GRAPHS["community-tiny"]
    jcfg = jed.make_config(jg, order_mode="deg", kernel_impl="jnp",
                           collect_cap=256)
    jctx = jec.make_context(jg, jcfg)
    js = jec.init_state(jcfg, np.arange(jg.n_u, dtype=np.int32))
    js = jax.jit(lambda st: jec.run(jctx, jcfg, st, max_steps=57))(js)
    tctx = tec.context_from_numpy(
        jec.CompactContext(*[np.asarray(x) for x in jctx]), "cpu")
    ts = tec.state_from_numpy(jec.CompactState(*[np.asarray(x) for x in js]),
                              "cpu")
    _assert_leaves(js, ts, "converted")
    tcfg = ted.EngineConfig(**dataclasses.asdict(jcfg))
    _assert_leaves(jec.step(jctx, jcfg, js), tec.step(tctx, tcfg, ts),
                   "one step")
    js2 = jax.jit(lambda st: jec.run(jctx, jcfg, st))(js)
    ts2 = tec.run(tctx, tcfg, ts)
    _assert_leaves(js2, ts2, "continued")
    _assert_leaves(js, ts, "input unchanged")
    assert ted.collected_bicliques(tcfg, ts2, jg.n_u, jg.n_v) == \
        jed.collected_bicliques(jcfg, js2, jg.n_u, jg.n_v)


def test_enumerate_compact_and_engine_enumerate():
    g = T_GRAPHS["powerlaw-tiny"]
    a = tec.enumerate_compact(g, device="cpu")
    b = COMPACT.enumerate(g, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert (int(a.n_max), int(a.cs) % (1 << 32)) == _oracle(g)
