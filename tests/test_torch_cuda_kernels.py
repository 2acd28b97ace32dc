"""The port's CUDA kernels against their plain torch-op versions on the
card (tolerance: exact — every output is integer).  Without a CUDA device
every test skips, decided inside the ``card`` fixture so that all test
workers collect the same tests.  Run on the card with:

    python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py

This file imports no JAX: the machine with the card has none."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import MBEClient, MBEOptions
from repro_torch.core import bitset
from repro_torch.core import engine_dense as ed
from repro_torch.core.engine import DENSE
from repro_torch.data.generators import dataset_suite, random_graph_stream
from repro_torch.kernels.fused_check import (fused_check_packed,
                                             fused_check_packed_ref)
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


def test_unported_kernel_paths_raise_on_the_card(card):
    g = dataset_suite("test")["corp-leadership"]
    with pytest.raises(NotImplementedError, match="K4"):
        ed.enumerate_dense(g, order_mode="deg_nocache", resident=False,
                           device="cuda")
    with pytest.raises(NotImplementedError, match="K5"):
        ed.enumerate_dense(g, kernel_impl="jnp", impl="pallas",
                           device="cuda")


def test_client_on_the_card_equals_cpu(card):
    graphs = random_graph_stream(8, seed=1)
    for opts in (MBEOptions(), MBEOptions(resident_lanes=0),
                 MBEOptions(steps_per_call=4, resident_rebalance=True)):
        on_card = MBEClient(opts).enumerate_many(graphs)
        cpu = MBEClient(dataclasses.replace(opts, device="cpu")) \
            .enumerate_many(graphs)
        assert [(r.n_max, r.cs, r.steps, r.nodes) for r in on_card] == \
            [(r.n_max, r.cs, r.steps, r.nodes) for r in cpu]
