"""The port's multi-lane pool path (``resident_pool``, plain version on CPU
tensors) against the JAX package's pool kernel in Pallas interpret mode:
pool widths 1/4/8, ``steps_per_call`` 1/4, both context layouts,
rebalance off and on, every leaf at every round boundary, plus the
scoreboard, the rebalance invariants, the Hopper gate arithmetic and the
cache-key extension.  Tolerance: exact."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import engine_dense as jed
from repro.data.generators import random_graph_stream as j_stream
from repro.kernels.resident_pool import resident_pool_segment as j_pool_seg
from repro_torch.core import engine_dense as ted
from repro_torch.kernels import resident_pool as tpool
from repro_torch.kernels.resident_step import ops as tstep
from repro_torch.serving.cache import ExecutableCache
from test_torch_engine_dense import _assert_leaves

# bucket 16 x 64 graphs of random_graph_stream(8, seed=1): 75, 214, 97
# and 21 engine steps
GRAPHS = [g.canonical() for g in j_stream(8, seed=1)
          if g.canonical().n_u <= 16 and g.canonical().n_v <= 64
          and g.canonical().n_u != 15]


def _pool(width, ctx_batched, **cfg_kw):
    kw = dict(n_u=16, n_v=64, m_real=16, depth=18, collect_cap=3,
              kernel_impl="pallas", **cfg_kw)
    jcfg, tcfg = jed.EngineConfig(**kw), ted.EngineConfig(**kw)
    if ctx_batched:
        lanes = (GRAPHS * 2)[:width]
        jctx = jax.tree.map(lambda *x: jnp.stack(x), *[
            jed.make_context(g, jcfg) for g in lanes])
        tasks = [np.arange(g.n_u, dtype=np.int32) for g in lanes]
    else:
        g = GRAPHS[1]
        jctx = jed.make_context(g, jcfg)
        tasks = [np.arange(i, g.n_u, width, dtype=np.int32)
                 for i in range(width)]
    states = []
    for t in tasks:
        pad = np.full(16, -1, np.int32)
        pad[: len(t)] = t
        states.append(jed.init_state(jcfg, pad)._replace(
            n_tasks=jnp.int32(len(t))))
    js = jax.tree.map(lambda *x: jnp.stack(x), *states)
    tctx = ted.context_from_numpy(
        jed.GraphContext(*[np.asarray(x) for x in jctx]), "cpu")
    ts = ted.state_from_numpy(jed.DenseState(*[np.asarray(x) for x in js]),
                              "cpu")
    return jcfg, tcfg, jctx, tctx, js, ts


@pytest.mark.parametrize("width,spc,ctx_batched,rebalance", [
    (1, 1, True, False), (1, 4, False, True),
    (4, 1, False, False), (4, 4, True, True),
    (8, 1, True, True), (8, 4, False, False)])
def test_pool_matches_jax_pallas_interpret(width, spc, ctx_batched,
                                           rebalance):
    jcfg, tcfg, jctx, tctx, js, ts = _pool(
        width, ctx_batched, resident_rebalance=rebalance)
    assert ted.pool_lanes(tcfg, width, "cpu") == width
    run_j = jax.jit(lambda st: jed.run_batch(
        jctx, jcfg, st, max_steps=23, ctx_batched=ctx_batched, unroll=spc))
    rounds = 0
    while not bool(np.all(np.asarray(jed._done(js)))):
        js = run_j(js)
        ts = ted.run_batch(tctx, tcfg, ts, max_steps=23,
                           ctx_batched=ctx_batched, unroll=spc)
        _assert_leaves(js, ts, f"round {rounds}")
        rounds += 1
    assert rounds > 1


@pytest.mark.parametrize("ctx_batched", [False, True])
def test_scoreboard_matches_jax_segment(ctx_batched):
    """One segment at a time from the same state: the port's
    ``resident_pool_segment`` equals JAX's pool kernel (interpret) in
    every leaf and in the (lanes, 2) scoreboard [done, spc - advanced],
    with per-lane budgets some lanes hit mid-segment."""
    jcfg, tcfg, jctx, tctx, js, ts = _pool(4, ctx_batched)
    start = np.zeros(4, np.int32)
    budget = np.array([5, 40, 1 << 30, 13], np.int32)
    for seg in range(6):
        js, jb = j_pool_seg(jctx, jcfg, js, start=jnp.asarray(start),
                            budget=jnp.asarray(budget), steps_per_call=4,
                            ctx_batched=ctx_batched, interpret=True)
        ts, tb = tpool.resident_pool_segment(
            tctx, tcfg, ts, start=torch.from_numpy(start),
            budget=torch.from_numpy(budget), steps_per_call=4,
            ctx_batched=ctx_batched)
        _assert_leaves(js, ts, f"segment {seg}")
        np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
        assert tb.shape == (4, tpool.BOARD_SLOTS)


def test_rebalance_conserves_budget_and_freezes_done_lanes():
    start = torch.zeros(4, dtype=torch.int32)
    bud = torch.tensor([10, 10, 10, 10], dtype=torch.int32)
    steps = torch.tensor([3, 10, 10, 1], dtype=torch.int32)
    board = torch.tensor([[1, 0], [0, 0], [0, 0], [1, 0]], dtype=torch.int32)
    new = ted._rebalance_budgets(start, bud, steps, board)
    # finished lanes freeze at their use, busy lanes split 7 + 9 = 16
    assert new.tolist() == [3, 18, 18, 1]
    assert int(new.sum()) <= int(bud.sum())
    j = jed._rebalance_budgets(jnp.zeros(4, jnp.int32), jnp.full(4, 10),
                               jed.DenseState(*[None] * 5 + [None] * 6
                                              + [jnp.asarray(steps.numpy())]
                                              + [None] * 7),
                               jnp.asarray(board.numpy()))
    np.testing.assert_array_equal(np.asarray(j), new.numpy())


def test_hopper_gate_arithmetic():
    """The residency gate is the shared-memory working set, not the
    TPU's VMEM budget: stacks live in device memory, so the 512 x 2048
    and 1024 x 4096 buckets both pass; only the former fits its
    adjacency (128 KB) in one CTA's shared memory, the latter (512 KB)
    runs on a cluster of 4 CTAs of 256 rows, 128 KB each."""
    def cfg(nu, nv):
        return ted.EngineConfig(n_u=nu, n_v=nv, m_real=nu, depth=nu + 2)
    small, large = cfg(512, 2048), cfg(1024, 4096)
    # 704 B of reduction slots and mbarrier, then L, L' (2 WV) and P, P',
    # Q, R, R', nz (6 WU) words and the cstack row + new counts (2 NU)
    assert tstep.resident_smem_base(small) == 704 + 4 * (
        2 * 64 + 6 * 16 + 2 * 512)
    assert tstep.resident_stage_adj(small)
    assert tstep.resident_cluster(small) == 1
    assert tstep.resident_smem_bytes(small) == \
        tstep.resident_smem_base(small) + 512 * 64 * 4
    assert not tstep.resident_stage_adj(large)
    assert tstep.resident_supported(large)
    assert tstep.resident_cluster(large) == 4 and tstep.resident_staged(large)
    assert tstep.resident_smem_base(large, 4) == 704 + 4 * (
        2 * 128 + 6 * 8 + 2 * 256)
    assert tstep.resident_smem_bytes(large) == \
        tstep.resident_smem_base(large, 4) + 256 * 128 * 4 <= 232_448
    assert tpool.resident_pool_supported(small, 8)
    assert not tpool.resident_pool_supported(small, 0)
    assert not tstep.resident_supported(cfg(60_000, 64))
    # one lane's cstack alone exceeds a block's shared memory
    assert 4 * small.depth * small.n_u > 232_448


def test_pool_lanes_and_cache_key_extension():
    base = dict(n_u=16, n_v=64, m_real=16, depth=18)
    auto = ted.EngineConfig(kernel_impl="auto", **base)
    pallas = ted.EngineConfig(kernel_impl="pallas", **base)
    assert ted.pool_lanes(auto, 4, "cpu") == 0        # auto on CPU = jnp
    assert ted.pool_lanes(pallas, 4, "cpu") == 4
    assert ted.pool_lanes(ted.EngineConfig(kernel_impl="pallas",
                                           resident_lanes=0, **base),
                          4, "cpu") == 0
    assert ted.pool_lanes(ted.EngineConfig(kernel_impl="pallas",
                                           resident_lanes=2, **base),
                          4, "cpu") == 0
    cache = ExecutableCache()
    cache.get_round(auto, 4, 8, device="cpu")
    cache.get_round(pallas, 4, 8, device="cpu")
    keys = list(cache._entries)
    assert keys[0] == (auto, 4, 8)
    assert keys[1] == (pallas, 4, 8, ("pool", 4))
