"""The port's CUDA kernels against their plain torch-op versions on the
card (tolerance: exact — every output is integer).  Without a CUDA device
every test skips, decided inside the ``card`` fixture so that all test
workers collect the same tests.  Run on the card with:

    python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py

This file imports no JAX: the machine with the card has none."""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch import MBEClient, MBEOptions
from repro_torch.core import bitset
from repro_torch.core import engine_dense as ed
from repro_torch.core.engine import DENSE
from repro_torch.data.generators import dataset_suite, random_graph_stream
from repro_torch.kernels import fused_check as fc
from repro_torch.kernels import fused_select as fs
from repro_torch.kernels.fused_check import (fused_check_packed,
                                             fused_check_packed_ref)
from repro_torch.kernels.intersect_count import intersect_count
from repro_torch.kernels.resident_pool import (resident_pool_segment,
                                               resident_pool_segment_ref)
from repro_torch.kernels.resident_step import (resident_segment,
                                               resident_segment_ref)
from repro_torch.serving.executor import _stack

pytestmark = pytest.mark.gpu

MODES = ["deg", "deg_nocache", "input"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


def _equal(a, b, what):
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), f"{what}: leaf {name} differs"


@pytest.mark.parametrize("n,w", [(32, 1), (100, 3), (512, 64), (1024, 128)])
@pytest.mark.parametrize("with_counts", [False, True])
def test_fused_check_matches_plain(card, n, w, with_counts):
    rng = np.random.default_rng(n + w)
    adj = rng.integers(0, 1 << 32, size=(n, w), dtype=np.uint64) \
        & rng.integers(0, 1 << 32, size=(n, w), dtype=np.uint64)
    mask = rng.integers(0, 1 << 32, size=(w,), dtype=np.uint64)
    adj[::3] |= mask
    nw = (n + 31) // 32
    q = rng.integers(0, 1 << 32, size=(nw,), dtype=np.uint64)
    p = rng.integers(0, 1 << 32, size=(nw,), dtype=np.uint64) & ~q
    if n % 32:
        q[-1] &= (1 << (n % 32)) - 1
        p[-1] &= (1 << (n % 32)) - 1
    args = [bitset.from_u32(x.astype(np.uint32), card)
            for x in (adj, mask)]
    nlp = bitset.count(args[1])
    act = [bitset.from_u32(x.astype(np.uint32), card) for x in (q, p)]
    got = fused_check_packed(args[0], args[1], nlp, *act, impl="pallas",
                             with_counts=with_counts)
    want = fused_check_packed_ref(args[0], args[1], nlp, *act,
                                  with_counts=with_counts)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)


def _pool(card, mode, cap=3):
    gs = [g.canonical() for g in random_graph_stream(8, seed=1)
          if g.canonical().n_u <= 16 and g.canonical().n_v <= 64]
    cfg = ed.EngineConfig(n_u=16, n_v=64, m_real=16, depth=18,
                          order_mode=mode, collect_cap=cap)
    ctx = _stack([DENSE.make_context(g, cfg, card) for g in gs])
    s = _stack([DENSE.fresh_lane_state(cfg, g.n_u, card) for g in gs])
    return cfg, ctx, s


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("spc", [1, 4])
def test_resident_pool_matches_plain(card, mode, spc):
    cfg, ctx, s = _pool(card, mode)
    start = s.steps.clone()
    budget = torch.tensor([1 << 30, 50, 7, 1 << 30, 90],
                          dtype=torch.int32, device=card)[: s.lvl.shape[0]]
    sk = sr = s
    for seg in range(200):
        if not bool(ed._active(sk, start, budget).any()):
            break
        sk, bk = resident_pool_segment(ctx, cfg, sk, start=start,
                                       budget=budget, steps_per_call=spc,
                                       ctx_batched=True)
        sr, br = resident_pool_segment_ref(ctx, cfg, sr, start=start,
                                           budget=budget,
                                           steps_per_call=spc,
                                           ctx_batched=True)
        _equal(sk, sr, f"segment {seg}")
        assert torch.equal(bk, br)


@pytest.mark.parametrize("mode", MODES)
def test_resident_step_matches_plain(card, mode):
    cfg, ctx, s = _pool(card, mode)
    lane, lctx = ed._lane(s, 2), ed._lane(ctx, 2)
    start = lane.steps.clone()
    sk = sr = lane
    while bool(ed._active(sk, start, 1 << 30)):
        sk = resident_segment(lctx, cfg, sk, start=start, budget=1 << 30,
                              steps_per_call=5)
        sr = resident_segment_ref(lctx, cfg, sr, start=start,
                                  budget=1 << 30, steps_per_call=5)
        _equal(sk, sr, "lane")


def test_dblp_large_bucket_reads_adjacency_from_device_memory(card):
    """1024 x 4096: the adjacency (512 KB) does not fit in shared memory,
    so the lane body reads it from device memory."""
    from repro_torch.kernels.resident_step.ops import resident_stage_adj
    g = dataset_suite("large")["dblp-large"]
    cfg = ed.EngineConfig(n_u=1024, n_v=4096, m_real=1024, depth=1026)
    assert not resident_stage_adj(cfg)
    ctx = _stack([DENSE.make_context(g, cfg, card)])
    s = _stack([DENSE.fresh_lane_state(cfg, g.n_u, card)])
    s = ed.run_batch(ctx, cfg, s, max_steps=200, ctx_batched=True,
                     unroll=8)
    start = s.steps.clone()
    sk, bk = resident_pool_segment(ctx, cfg, s, start=start, budget=1 << 30,
                                   steps_per_call=8, ctx_batched=True)
    sr, br = resident_pool_segment_ref(ctx, cfg, s, start=start,
                                       budget=1 << 30, steps_per_call=8,
                                       ctx_batched=True)
    _equal(sk, sr, "1024x4096")
    assert torch.equal(bk, br)


@pytest.mark.parametrize("mode", ["deg", "input"])
def test_per_step_fused_check_pool_equals_cpu(card, mode):
    """Residency off: every engine step of the pool launches the
    lane-batched fused_check kernel; the states equal the plain path's."""
    cfg, ctx, s = _pool(card, mode)
    cfg = dataclasses.replace(cfg, kernel_impl="pallas", resident=False)
    on_card = ed.run_batch(ctx, cfg, s, max_steps=150, ctx_batched=True,
                           unroll=3)
    cpu = ed.run_batch(ed.GraphContext(*[x.cpu() for x in ctx]), cfg,
                       ed.DenseState(*[x.cpu() for x in s]), max_steps=150,
                       ctx_batched=True, unroll=3)
    _equal(ed.DenseState(*[x.cpu() for x in on_card]), cpu, "per-step")


@pytest.mark.parametrize("kw", [
    dict(order_mode="deg_nocache", kernel_impl="pallas", resident=False),
    dict(kernel_impl="jnp", impl="pallas")])
def test_k4_k5_dense_paths_equal_cpu(card, kw):
    """The dense paths that need K4 (packed selection, residency off) and
    K5 (unfused, impl='pallas') run on the card and equal the same path on
    the CPU (the kernel path's plain versions)."""
    g = dataset_suite("test")["corp-leadership"]
    on_card = ed.enumerate_dense(g, device="cuda", **kw)
    cpu = ed.enumerate_dense(g, device="cpu", **kw)
    _equal(ed.DenseState(*[x.cpu() for x in on_card]), cpu, str(kw))


def _rows(n, w, seed, dev):
    rng = np.random.default_rng(seed)
    adj = rng.integers(0, 1 << 32, size=(n, w), dtype=np.uint64) \
        & rng.integers(0, 1 << 32, size=(n, w), dtype=np.uint64)
    mask = rng.integers(0, 1 << 32, size=(w,), dtype=np.uint64)
    adj[::3] |= mask
    adj[1::7] = 0
    return (bitset.from_u32(adj.astype(np.uint32), dev),
            bitset.from_u32(mask.astype(np.uint32), dev),
            torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev),
            torch.from_numpy((rng.random(n) < 0.4).astype(np.int32)).to(dev))


SHAPES = [(100, 5), (128, 8), (512, 64), (1024, 128)]


@pytest.mark.parametrize("n,w", SHAPES)
def test_intersect_count_matches_plain(card, n, w):
    adj, mask, idx, _ = _rows(n, w, n + w, card)
    for i in (None, idx, torch.stack([idx, idx.flip(0)])):
        m = mask if i is None or i.dim() == 1 else torch.stack([mask, ~mask])
        got = intersect_count(adj, m, idx=i, impl="pallas")
        want = intersect_count(adj.cpu(), m.cpu(),
                               idx=None if i is None else i.cpu())
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("n,w", SHAPES)
@pytest.mark.parametrize("tied", [False, True])
def test_fused_select_matches_plain(card, n, w, tied):
    adj, mask, idx, act = _rows(n, w, 2 * n + w, card)
    if tied:
        adj = adj[:1].expand(n, w).contiguous()
    words = bitset.from_bool(act > 0)
    adj8 = torch.stack([adj, adj.flip(0)] * 4)
    for lanes, a in ((1, adj), (8, adj), (8, adj8)):
        def rep(t):
            return t if lanes == 1 else torch.stack([t] * lanes)
        p = torch.tensor(n // 3, dtype=torch.int32, device=card)
        calls = {
            fs.fused_select: (a, rep(mask), rep(act)),
            fs.fused_select_packed: (a, rep(mask), rep(words)),
            fs.fused_select_prefix: (a, rep(mask), rep(p)),
            fs.fused_select_gathered: (a, rep(idx), rep(mask), rep(act)),
            fs.fused_select_gathered_prefix: (a, rep(idx), rep(mask),
                                              rep(p)),
        }
        for fn, args in calls.items():
            got = fn(*args, impl="pallas")
            want = fn(*[x.cpu() for x in args])
            assert all(torch.equal(x.cpu(), y) for x, y in zip(got, want)), \
                fn.__name__
    # nothing active: the (-1, INT32_MAX) sentinel
    zero = torch.zeros((), dtype=torch.int32, device=card)
    for got in (fs.fused_select_prefix(adj, mask, zero, impl="pallas"),
                fs.fused_select(adj, mask, torch.zeros_like(act),
                                impl="pallas")):
        assert (int(got[0]), int(got[1])) == (-1, 0x7FFFFFFF)


@pytest.mark.parametrize("n,w", SHAPES)
@pytest.mark.parametrize("with_counts", [False, True])
def test_fused_check_other_kinds_match_plain(card, n, w, with_counts):
    adj, mask, idx, act = _rows(n, w, 3 * n + w, card)
    nlp = bitset.count(mask)
    qa, pa = act, 1 - act
    idx2 = torch.cat([idx.flip(0), idx])
    q_hi = torch.tensor(n // 2, dtype=torch.int32, device=card)
    p_hi = torch.tensor(n - 3, dtype=torch.int32, device=card)
    calls = {
        fc.fused_check: ((adj, mask, nlp, qa, pa), {}),
        fc.fused_check_prefix2: ((adj, mask, nlp, q_hi, p_hi),
                                 dict(split=n // 2)),
        fc.fused_check_gathered: ((adj, idx, mask, nlp, qa, pa), {}),
        fc.fused_check_gathered_prefix2: (
            (adj, idx2, mask, nlp, q_hi, p_hi), {}),
    }
    for fn, (args, kw) in calls.items():
        got = fn(*args, impl="pallas", with_counts=with_counts, **kw)
        want = fn(*[x.cpu() for x in args], with_counts=with_counts, **kw)
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a.cpu(), b), \
                fn.__name__
    # 8 lanes, per-lane adjacency, through the compact engine's layout
    adj8 = torch.stack([adj, adj.flip(0)] * 4)
    m8 = torch.stack([mask, adj[3], mask & ~adj[5], adj[0]] * 2)
    args = (adj8, torch.stack([idx2] * 8), m8, bitset.count(m8),
            torch.arange(8, dtype=torch.int32, device=card) * (n // 8),
            torch.arange(8, 0, -1, dtype=torch.int32, device=card) * (n // 8))
    got = fc.fused_check_gathered_prefix2(*args, impl="pallas",
                                          with_counts=with_counts)
    want = fc.fused_check_gathered_prefix2(*[x.cpu() for x in args],
                                           with_counts=with_counts)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a.cpu(), b)


@pytest.mark.parametrize("kw", [dict(), dict(kernel_impl="jnp",
                                              impl="pallas")])
def test_compact_engine_on_the_card_equals_cpu(card, kw):
    graphs = random_graph_stream(8, seed=1)
    opts = MBEOptions(engine="compact", steps_per_call=4, **kw)
    on_card = MBEClient(opts).enumerate_many(graphs)
    cpu = MBEClient(dataclasses.replace(opts, device="cpu")) \
        .enumerate_many(graphs)
    assert [(r.n_max, r.cs, r.steps, r.nodes) for r in on_card] == \
        [(r.n_max, r.cs, r.steps, r.nodes) for r in cpu]


def test_client_on_the_card_equals_cpu(card):
    graphs = random_graph_stream(8, seed=1)
    for opts in (MBEOptions(), MBEOptions(resident_lanes=0),
                 MBEOptions(steps_per_call=4, resident_rebalance=True)):
        on_card = MBEClient(opts).enumerate_many(graphs)
        cpu = MBEClient(dataclasses.replace(opts, device="cpu")) \
            .enumerate_many(graphs)
        assert [(r.n_max, r.cs, r.steps, r.nodes) for r in on_card] == \
            [(r.n_max, r.cs, r.steps, r.nodes) for r in cpu]


# -- K1 and K4 as row tiles (csrc/rows.cuh): tile edges, the scratch
# reset, two streams, past the residency gate, one kernel a call --------

ROW_EDGES = {"ties": (100, 5), "p0": (100, 5), "p1": (100, 5),
             "pn": (100, 5), "lastbit": (100, 5), "ragged33": (33, 8),
             "idx_range": (100, 5), "empty": (100, 5), "wide": (512, 64)}


def _row_case(case, per_lane, seed, dev, n_w=None):
    """Two lanes of K1 / K4 operands at a tile edge (as chip_smoke.py's
    ``row_case_inputs``)."""
    n, w = n_w or ROW_EDGES[case]
    L = 2
    g = torch.Generator(device=dev).manual_seed(seed)

    def words(*shape):
        def one():
            return torch.randint(-(1 << 31), 1 << 31, shape, generator=g,
                                 device=dev, dtype=torch.int32)
        return one() & one()

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    def bound(hi, lo=0):
        return torch.randint(lo, hi + 1, (L,), generator=g, device=dev,
                             dtype=torch.int32)

    adj = words(L if per_lane else 1, n, w)
    mask = words(L, w)
    adj[:, ::7] |= mask[:, None, :] if per_lane else mask[:1, None, :]
    adj[:, 3::11] = 0
    idx = torch.argsort(rand(L, n), dim=-1).to(torch.int32)
    act = (rand(L, n) < 0.5).to(torch.int32)
    qa = (rand(L, n) < 0.4).to(torch.int32)
    pa = ((rand(L, n) < 0.6) & (qa == 0)).to(torch.int32)
    split = n // 2
    pb, q_hi, p_hi = bound(n, 1), bound(split), bound(n - split)
    if case == "ties":
        mask[:, 0] |= 1
        adj[:, :, 0] |= 1
        adj[:, [40, 70, 99]] = 0
        idx = torch.arange(n, dtype=torch.int32, device=dev).expand(L, n)
        act[:] = 1
        pb[:] = n
    elif case == "p0":
        act[:] = qa[:] = pa[:] = 0
        pb[:] = q_hi[:] = p_hi[:] = 0
    elif case == "p1":
        act[:] = qa[:] = pa[:] = 0
        act[:, 0] = qa[:, 0] = 1
        pa[:, split] = 1
        pb[:] = q_hi[:] = p_hi[:] = 1
    elif case == "pn":
        act[:] = 1
        pb[:] = n
        q_hi[:] = split
        p_hi[:] = n - split
    elif case == "lastbit":
        act[:] = qa[:] = pa[:] = 0
        act[:, n - 2] = pa[:, n - 2] = 1
        qa[:, n - 3] = 1
        pb[:] = n - 1
        q_hi[:] = split
        p_hi[:] = n - split - 1
    elif case == "idx_range":
        idx[:, :6] = torch.tensor([-1, -n, -n - 3, n, n + 5, -(1 << 30)],
                                  dtype=torch.int32, device=dev)
        idx[:, -3:] = torch.tensor([1 << 30, -2, n - 1], dtype=torch.int32,
                                   device=dev)
    elif case == "empty":
        mask[:] = 0
    idx = idx.contiguous()
    a = adj if per_lane else adj[0]
    nlp = bitset.count(mask)
    idx2 = torch.cat([idx.flip(-1), idx], dim=-1).contiguous()
    wc = dict(with_counts=True)
    return {
        fs.fused_select: ((a, mask, act), {}),
        fs.fused_select_packed: ((a, mask, bitset.from_bool(act > 0)), {}),
        fs.fused_select_prefix: ((a, mask, pb), {}),
        fs.fused_select_gathered: ((a, idx, mask, act), {}),
        fs.fused_select_gathered_prefix: ((a, idx, mask, pb), {}),
        fc.fused_check_packed: ((a, mask, nlp, bitset.from_bool(qa > 0),
                                 bitset.from_bool(pa > 0)), wc),
        fc.fused_check: ((a, mask, nlp, qa, pa), wc),
        fc.fused_check_prefix2: ((a, mask, nlp, q_hi, p_hi),
                                 dict(wc, split=split)),
        fc.fused_check_gathered: ((a, idx, mask, nlp, qa, pa), wc),
        fc.fused_check_gathered_prefix2: ((a, idx2, mask, nlp, q_hi, p_hi),
                                          wc),
    }


def _same(got, want):
    return all((a is None and b is None) or (
        a is not None and b is not None and a.dtype == b.dtype
        and torch.equal(a, b)) for a, b in zip(got, want))


@pytest.mark.parametrize("case", list(ROW_EDGES))
@pytest.mark.parametrize("per_lane", [False, True])
def test_row_kernels_at_tile_edges_match_plain(card, case, per_lane):
    calls = _row_case(case, per_lane, len(case) + per_lane, card)
    for fn, (args, kw) in calls.items():
        got = fn(*args, impl="pallas", **kw)
        want = fn(*args, impl="jnp", **kw)
        assert _same(got, want), (fn.__name__, case, per_lane)


def test_row_kernels_past_the_residency_gate(card):
    """K1 and K4 at 26,000 rows of 813 words (scalar loads, a row walked
    in 4 chunks), every kind."""
    calls = _row_case("wide", False, 5, card, n_w=(26_000, 813))
    for fn, (args, kw) in calls.items():
        assert _same(fn(*args, impl="pallas", **kw),
                     fn(*args, impl="jnp", **kw)), fn.__name__


def _alternating(card):
    calls = _row_case("wide", True, 11, card)
    (a, m, nlp, qw, pw), _ = calls[fc.fused_check_packed]
    _, _, act = calls[fs.fused_select][0]
    counts = fc.fused_check_packed(a, m, nlp, qw, pw, impl="jnp",
                                   with_counts=True)[4]
    q_on = bitset.from_bool(counts == nlp[:, None])
    late = act.clone()
    late[:, :256] = 0
    seq = [(q_on, act), (torch.zeros_like(q_on), late), (q_on, act)]

    def k1(q, impl):
        return fc.fused_check_packed(a, m, nlp, q, pw, impl=impl)

    def k4(x, impl):
        return fs.fused_select(a, m, x, impl=impl)
    return seq, k1, k4


def test_row_kernels_scratch_reset_between_calls(card):
    """Back-to-back calls (no sync between) whose violation flags
    alternate true, false, true and whose argmins differ: each reads its
    own result, so every launch left its scratch slots zeroed."""
    seq, k1, k4 = _alternating(card)
    got = [(k1(q, "pallas"), k4(x, "pallas")) for q, x in seq]
    want = [(k1(q, "jnp"), k4(x, "jnp")) for q, x in seq]
    assert [g[0][0].tolist() for g in got] == [[True] * 2, [False] * 2,
                                               [True] * 2]
    assert got[0][1][0].tolist() != got[1][1][0].tolist()
    for (g1, g4), (w1, w4) in zip(got, want):
        assert _same(g1, w1) and _same(g4, w4)


def test_row_kernels_on_two_streams_at_once(card):
    seq, k1, k4 = _alternating(card)
    want = [(k1(q, "jnp"), k4(x, "jnp")) for q, x in seq[:2]]
    streams = [torch.cuda.Stream(card), torch.cuda.Stream(card)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(card))
    outs = [[], []]
    for _ in range(20):
        for k, s in enumerate(streams):
            with torch.cuda.stream(s):
                q, x = seq[k]
                outs[k].append((k1(q, "pallas"), k4(x, "pallas")))
    torch.cuda.synchronize()
    for k in (0, 1):
        for g1, g4 in outs[k]:
            assert _same(g1, want[k][0]) and _same(g4, want[k][1])


# The profiler drops a device event stamped before its window opened, and
# the card's kernel timestamps, converted to the host clock, can run
# milliseconds behind it (chip_profile_windows.py: kept kernels stamped
# before their own launch calls; windows opened with no wait lose some,
# windows opened with this one lose none).  So every counted call waits
# this long after the window opens.
PROFILE_SETTLE_S = 0.05


def test_row_kernels_one_device_kernel_per_call(card):
    from torch.profiler import ProfilerActivity, profile
    calls = _row_case("wide", True, 3, card)
    for fn, (args, kw) in calls.items():
        fn(*args, impl="pallas", **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_SETTLE_S)
            for _ in range(5):
                fn(*args, impl="pallas", **kw)
            torch.cuda.synchronize()
        seen = {e.key: e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}
        name = "fused_check_kernel" if "check" in fn.__name__ \
            else "fused_select_kernel"
        assert sum(seen.values()) == 5 and all(name in k for k in seen), \
            (fn.__name__, seen)


# -- K5 on the row tiles ----------------------------------------------------

K5_NS = [1, 31, 32, 33, 63, 64, 65, 512, 1024]
K5_WS = [1, 5, 64]


def _k5_case(n, w, lanes, per_lane, seed, dev, unaligned=False):
    """K5 operands (as chip_smoke.py's ``k5_operands``): ``lanes`` lanes
    (0: no lane dim), an idx with negative and out-of-range entries;
    ``unaligned`` puts adj and mask 4 bytes past a 16-byte boundary."""
    g = torch.Generator(device=dev).manual_seed(seed)
    L = max(lanes, 1)

    def words(*shape):
        x = torch.randint(-(1 << 31), 1 << 31, shape, generator=g,
                          device=dev, dtype=torch.int32)
        x &= torch.randint(-(1 << 31), 1 << 31, shape, generator=g,
                           device=dev, dtype=torch.int32)
        if unaligned:
            buf = torch.empty(x.numel() + 4, dtype=torch.int32, device=dev)
            buf[1:1 + x.numel()].view(shape).copy_(x)
            x = buf[1:1 + x.numel()].view(shape)
        return x
    adj = words(L if per_lane else 1, n, w)
    mask = words(L, w)
    adj[:, ::7] |= mask[:, None, :] if per_lane else mask[:1, None, :]
    idx = torch.argsort(torch.rand(L, n, generator=g, device=dev),
                        dim=-1).to(torch.int32)
    edge = torch.tensor([-1, -n, -n - 3, n, n + 5, -(1 << 30), 1 << 30],
                        dtype=torch.int32, device=dev)[:n]
    idx[:, :len(edge)] = edge
    a = adj if per_lane else adj[0]
    if lanes == 0:
        return a, mask[0], idx[0].contiguous()
    return a, mask, idx.contiguous()


@pytest.mark.parametrize("w", K5_WS)
@pytest.mark.parametrize("n", K5_NS)
def test_intersect_count_at_tile_edges_matches_plain(card, n, w):
    """K5 at n across the 32-row tiles' edges, w % 4 != 0 and w = 1 (one-
    word loads) and 16-byte units, no lane dim and 1 to 3 lanes with
    shared and per-lane adjacency, rows in order and through idx, and
    operands off 16-byte boundaries."""
    for lanes, per_lane in ((0, False), (1, True), (2, False), (3, True)):
        a, m, i = _k5_case(n, w, lanes, per_lane, n + w + lanes, card)
        for ix in (None, i):
            got = intersect_count(a, m, idx=ix, impl="pallas")
            want = intersect_count(a, m, idx=ix, impl="jnp")
            assert torch.equal(got, want), (n, w, lanes, per_lane, ix is None)
    a, m, i = _k5_case(n, 64, 2, True, n, card, unaligned=True)
    assert a.data_ptr() % 16 and m.data_ptr() % 16
    assert torch.equal(intersect_count(a, m, idx=i, impl="pallas"),
                       intersect_count(a, m, idx=i, impl="jnp"))


def test_intersect_count_past_the_residency_gate(card):
    """2 lanes of 26,000 rows of 813 words: one-word loads, a row walked
    in 4 chunks."""
    a, m, i = _k5_case(26_000, 813, 2, False, 5, card)
    for ix in (None, i):
        assert torch.equal(intersect_count(a, m, idx=ix, impl="pallas"),
                           intersect_count(a, m, idx=ix, impl="jnp"))


def test_intersect_count_one_device_kernel_per_call(card):
    from torch.profiler import ProfilerActivity, profile
    a, m, i = _k5_case(512, 64, 2, True, 3, card)
    n = intersect_count.launches
    intersect_count(a, m, idx=i, impl="pallas")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_SETTLE_S)
        for _ in range(5):
            intersect_count(a, m, idx=i, impl="pallas")
        torch.cuda.synchronize()
    seen = {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}
    assert sum(seen.values()) == 5 and all(
        "intersect_count_kernel" in k for k in seen), seen
    assert intersect_count.launches == n + 6
