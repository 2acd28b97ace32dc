"""The resident lane kernels' in-place entry (``LaneRun``, through
``lane_run`` and ``pool_run``) and the run loops built on it.

On the CPU the in-place entry runs the plain version into the buffers it
was handed: ``run`` and ``run_batch`` (pool and per-lane routes) never
write the caller's ``DenseState``, and the in-place entry, segment after
segment, equals the functional entry and the JAX package's
``resident_segment`` / ``resident_pool_segment`` in Pallas interpret
mode, leaf for leaf and scoreboard for scoreboard, in all three order
modes.  On the card (``gpu``): the in-place kernels against the plain
version at every segment boundary at 512 x 2048 (one CTA a lane) and
1024 x 4096 (a cluster of CTAs a lane), and the caller's state unchanged.
Tolerance: exact (every leaf is integer).  Run the card's tests with:

    python -m pytest -q -m gpu tests/test_torch_resident_inplace.py

The JAX package is imported inside the CPU tests only: the machine with
the card has no JAX."""
import numpy as np
import pytest
import torch

from repro_torch.core import engine_dense as ed
from repro_torch.core.engine import DENSE
from repro_torch.data.generators import dataset_suite
from repro_torch.kernels.resident_pool.ops import (pool_run,
                                                   resident_pool_segment)
from repro_torch.kernels.resident_pool.ref import resident_pool_segment_ref
from repro_torch.kernels.resident_step.ops import (S_BUDGET, S_STEPS,
                                                   lane_run, pack,
                                                   resident_cluster,
                                                   resident_segment, unpack)
from repro_torch.kernels.resident_step.ref import resident_segment_ref
from repro_torch.serving.buckets import BucketPolicy, plan_bucket
from repro_torch.serving.executor import _stack

MODES = ["deg", "deg_nocache", "input"]


def _snapshot(s):
    return [x.clone() for x in s]


def _unchanged(s, snap):
    for name, x, y in zip(s._fields, s, snap):
        assert torch.equal(x, y), f"caller's leaf {name} was written"


def _equal(a, b, what):
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), f"{what}: leaf {name} differs"


# ---------------------------------------------------------------------------
# CPU: the plain version behind the in-place entry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["run", "pool", "per_lane"])
def test_run_loops_leave_the_callers_state_unchanged(route):
    from test_torch_resident_pool import _pool
    kw = {} if route != "per_lane" else dict(resident_lanes=0)
    _, cfg, _, ctx, _, s = _pool(4, False, **kw)
    if route == "run":
        s = ed._lane(s, 1)
        snap = _snapshot(s)
        out = ed.run(ctx, cfg, s, max_steps=23, unroll=4)
        steps = int(out.steps)
    else:
        assert ed.pool_lanes(cfg, 4, "cpu") == (4 if route == "pool" else 0)
        snap = _snapshot(s)
        out = ed.run_batch(ctx, cfg, s, max_steps=23, unroll=4)
        steps = int(out.steps.sum())
    _unchanged(s, snap)
    assert steps > 0
    for x, y in zip(out, s):
        assert x.data_ptr() != y.data_ptr() or x.numel() == 0


@pytest.mark.parametrize("mode", MODES)
def test_inplace_pool_entry_matches_functional_and_jax(mode):
    import jax.numpy as jnp
    from repro.kernels.resident_pool import resident_pool_segment as j_seg
    from test_torch_engine_dense import _assert_leaves
    from test_torch_resident_pool import _pool
    jcfg, tcfg, jctx, tctx, js, ts = _pool(4, True, order_mode=mode)
    start = np.zeros(4, np.int32)
    budget = np.array([6, 40, 1 << 30, 13], np.int32)
    own = ed._owned(ts)
    p = pack(own, torch.from_numpy(start), torch.from_numpy(budget))
    loop = pool_run(tctx, tcfg, own, p, 4, ctx_batched=True)
    for seg in range(5):
        js, jb = j_seg(jctx, jcfg, js, start=jnp.asarray(start),
                       budget=jnp.asarray(budget), steps_per_call=4,
                       ctx_batched=True, interpret=True)
        ts, tb = resident_pool_segment(
            tctx, tcfg, ts, start=torch.from_numpy(start),
            budget=torch.from_numpy(budget), steps_per_call=4,
            ctx_batched=True)
        board = loop.launch()
        si = unpack(own, p)
        _assert_leaves(js, si, f"{mode} in place, segment {seg}")
        _equal(si, ts, f"{mode} in place vs functional, segment {seg}")
        np.testing.assert_array_equal(np.asarray(jb), board.numpy())
        assert torch.equal(board, tb)
    assert loop.active() == bool(ed._active(ts, torch.from_numpy(start),
                                            torch.from_numpy(budget)).any())


@pytest.mark.parametrize("mode", MODES)
def test_inplace_lane_entry_matches_functional_and_jax(mode):
    import jax
    from repro.kernels.resident_step import resident_segment as j_seg
    from test_torch_engine_dense import _assert_leaves
    from test_torch_resident_pool import _pool
    jcfg, tcfg, jctx, tctx, js, ts = _pool(2, False, order_mode=mode)
    js = jax.tree.map(lambda x: x[1], js)
    ts = ed._lane(ts, 1)
    own = ed._owned(ts)
    p = pack(own, 0, 1 << 30)
    loop = lane_run(tctx, tcfg, own, p, 3)
    for seg in range(5):
        js = j_seg(jctx, jcfg, js, start=0, budget=1 << 30,
                   steps_per_call=3, interpret=True)
        ts = resident_segment(tctx, tcfg, ts, start=0, budget=1 << 30,
                              steps_per_call=3)
        loop.launch()
        si = unpack(own, p)
        _assert_leaves(js, si, f"{mode} in place, segment {seg}")
        _equal(si, ts, f"{mode} in place vs functional, segment {seg}")


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


BUCKETS = {"512x2048": ("bench", ["dblp-like", "youtube-like"]),
           "1024x4096": ("large", ["dblp-large"])}


def _bucket(card, bucket, mode, shared):
    """(cfg, ctx, state) of a bucket's pool, 300 steps in: per-lane
    contexts (one lane a graph) or one shared context whose root tasks
    are dealt to two lanes."""
    suite, names = BUCKETS[bucket]
    gs = [dataset_suite(suite)[n].canonical() for n in names]
    cfg = plan_bucket(gs[0], BucketPolicy()).engine_config(
        order_mode=mode, collect_cap=4)
    if shared:
        g = gs[0]
        ctx = DENSE.make_context(g, cfg, card)
        parts = [np.arange(i, g.n_u, 2, dtype=np.int32) for i in range(2)]
        sts = []
        for t in parts:
            pad = np.full(cfg.n_u, -1, np.int32)
            pad[: len(t)] = t
            sts.append(ed.init_state(cfg, pad, card)._replace(
                n_tasks=torch.tensor(len(t), dtype=torch.int32,
                                     device=card)))
        s = _stack(sts)
    else:
        ctx = _stack([DENSE.make_context(g, cfg, card) for g in gs])
        s = _stack([DENSE.fresh_lane_state(cfg, g.n_u, card) for g in gs])
    s = ed.run_batch(ctx, cfg, s, max_steps=300, ctx_batched=not shared,
                     unroll=16)
    return cfg, ctx, s


@pytest.mark.gpu
@pytest.mark.parametrize("spc", [1, 16])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bucket", list(BUCKETS))
def test_inplace_kernels_match_plain_on_the_card(card, bucket, mode, spc):
    """Every leaf and the scoreboard equal the plain version's at every
    segment boundary, shared and per-lane context, rebalance off and on;
    the single-lane kernel likewise on lane 0."""
    for shared in (False, True):
        cfg, ctx, s = _bucket(card, bucket, mode, shared)
        assert resident_cluster(cfg) == (4 if bucket == "1024x4096" else 1)
        batched = not shared
        for rebalance in (False, True):
            start = s.steps.clone()
            bud = torch.full_like(start, 8 * spc if rebalance else 1 << 30)
            own = ed._owned(s)
            p = pack(own, start, bud)
            loop = pool_run(ctx, cfg, own, p, spc, ctx_batched=batched)
            sr = s
            for seg in range(4):
                bk = loop.launch()
                sr, br = resident_pool_segment_ref(
                    ctx, cfg, sr, start=start, budget=bud,
                    steps_per_call=spc, ctx_batched=batched)
                what = (f"{bucket} {mode} spc={spc} shared={shared} "
                        f"rebalance={rebalance} segment {seg}")
                _equal(unpack(own, p), sr, what)
                assert torch.equal(bk, br), what
                if rebalance:
                    bud = ed._rebalance_budgets(start, bud, sr.steps, br)
                    p.scal[:, S_BUDGET] = ed._rebalance_budgets(
                        start, p.scal[:, S_BUDGET], p.scal[:, S_STEPS], bk)
        lane = ed._lane(s, 0)
        lctx = ctx if shared else ed._lane(ctx, 0)
        own = ed._owned(lane)
        p = pack(own, own.steps, 1 << 30)
        loop = lane_run(lctx, cfg, own, p, spc)
        sr = lane
        for seg in range(4):
            loop.launch()
            sr = resident_segment_ref(lctx, cfg, sr, start=lane.steps,
                                      budget=1 << 30, steps_per_call=spc)
            _equal(unpack(own, p), sr,
                   f"{bucket} {mode} spc={spc} lane, segment {seg}")


@pytest.mark.gpu
@pytest.mark.parametrize("bucket", list(BUCKETS))
def test_run_loops_leave_the_callers_state_unchanged_on_the_card(card,
                                                                 bucket):
    cfg, ctx, s = _bucket(card, bucket, "deg", shared=False)
    snap = _snapshot(s)
    out = ed.run_batch(ctx, cfg, s, max_steps=200, ctx_batched=True,
                       unroll=16)
    _unchanged(s, snap)
    lane, lctx = ed._lane(s, 0), ed._lane(ctx, 0)
    lsnap = _snapshot(lane)
    one = ed.run(lctx, cfg, lane, max_steps=200, unroll=16)
    _unchanged(lane, lsnap)
    _equal(one, ed._lane(out, 0), f"{bucket}: run vs run_batch lane 0")
    # the functional entries too
    start = s.steps.clone()
    resident_pool_segment(ctx, cfg, s, start=start, budget=1 << 30,
                          steps_per_call=16, ctx_batched=True)
    resident_segment(lctx, cfg, lane, start=lane.steps, budget=1 << 30,
                     steps_per_call=16)
    _unchanged(s, snap)
    _unchanged(lane, lsnap)
