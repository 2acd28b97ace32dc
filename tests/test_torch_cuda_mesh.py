"""The MBE mesh on the card (``gpu``-marked: without a CUDA device every
test skips, decided inside the ``card`` fixture).

* The heavy + small stream (``tests/test_executors.py``'s, cut to 8
  graphs) through ``ShardedExecutor`` on a mesh of every visible card,
  against ``LocalExecutor`` on card 0: the same (n_max, cs) and decoded
  bicliques, the heavy graph's workers busy on every card.
* With two or more cards: on every card but the first (``cuda:1`` ..),
  while ``cuda:0`` is the current device, K1, K3 and K4 launches equal
  to their plain versions; K2 (a lane run to its end) and K5 equal to
  theirs; K7's forward (bf16 and fp32), its fused bf16 backward and its
  fp32 dq / dkv against ``flash_fwd_ref`` / ``flash_bwd_ref`` at the
  port's K7 tolerances (element-wise 3e-2 / 1e-4 and per row 1e-2 /
  1e-5 forward, per row and scaled 1e-2 / 1e-5 backward), each output
  on its card, and the current device unchanged after it (the launchers
  enter their tensors' device; skips with one card).
* With two or more cards: the hybrid family (zamba2's smoke config)
  prefilled at model=2 over ``cuda:0`` and ``cuda:1``, each K7 forward
  call held on the card that ran it, the logits against one card.

This file imports no JAX: the machine with the card has none."""
import numpy as np
import pytest
import torch

from repro_torch.baselines.mbea import bicliques_to_key_set
from repro_torch.core import bitset
from repro_torch.core import engine_dense as ed
from repro_torch.core.engine import DENSE
from repro_torch.data.generators import (dense_small, random_bipartite,
                                         random_graph_stream)
from repro_torch.kernels import fused_select as fs
from repro_torch.kernels.flash_attention import (flash_bwd, flash_bwd_ref,
                                                 flash_fwd, flash_fwd_ref)
from repro_torch.kernels.flash_attention.ops import _pack
from repro_torch.kernels.intersect_count import intersect_count
from repro_torch.kernels.intersect_count.ref import intersect_count_ref
from repro_torch.kernels.fused_check import (fused_check_packed,
                                             fused_check_packed_ref)
from repro_torch.kernels.resident_pool import (resident_pool_segment,
                                               resident_pool_segment_ref)
from repro_torch.kernels.resident_step import (resident_segment,
                                               resident_segment_ref)
from repro_torch.serving import (BucketPolicy, LocalExecutor, MBEServer,
                                 ShardedExecutor)
from repro_torch.serving.executor import _stack
from repro_torch.sharding.axes import mbe_serve_mesh

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the mesh runs only on the card")
    return torch.device("cuda", 0)


@pytest.fixture
def second_card(card):
    if torch.cuda.device_count() < 2:
        pytest.skip("one card visible: no launch on cuda:1 to check")
    return torch.device("cuda", 1)


def _stream():
    heavy = dense_small(18, 36, p=0.5, seed=7, name="heavy")
    rng = np.random.default_rng(0)
    return [heavy] + [random_bipartite(int(rng.integers(6, 14)),
                                       int(rng.integers(16, 30)), p=0.2,
                                       seed=1000 + i, name=f"small{i}")
                      for i in range(7)]


def test_stream_on_every_card_against_local(card):
    pol = BucketPolicy(mode="pow2", max_batch=8, steps_per_round=32,
                       big_graph_threshold=16)
    mesh = mbe_serve_mesh()
    assert mesh.size == torch.cuda.device_count()
    runs = []
    for ex in (ShardedExecutor(mesh), LocalExecutor(device="cuda")):
        srv = MBEServer(pol, collect_cap=4096, collect=True, executor=ex)
        res = srv.serve(_stream())
        runs.append([(r.n_max, r.cs, bicliques_to_key_set(r.bicliques))
                     for r in res])
        if ex.name == "sharded":
            st = srv.stats()
            busy = np.array(st["big_busy_per_worker"])
            assert busy.shape == (mesh.size,) and (busy > 0).all()
            assert all(e["lanes"] % mesh.size == 0
                       for e in srv.routing_log if e["event"] == "pool")
    assert runs[0] == runs[1]


def _k7_on(dev, dtype):
    """K7 fwd and bwd on ``dev`` against their plain versions: (1, 1000)
    tokens, 8 heads over 4 kv heads, hd 128, causal."""
    g = torch.Generator(device=dev).manual_seed(11)
    q, do = (torch.randn(1, 1000, 8, 128, generator=g, device=dev)
             .to(dtype) for _ in range(2))
    k, v = (torch.randn(1, 1000, 4, 128, generator=g, device=dev).to(dtype)
            for _ in range(2))
    qp, kp, vp = (x.contiguous() for x in _pack(q, k, v))
    dop = _pack(do, k, v)[0].contiguous()
    kw = dict(causal=True, scale=128 ** -0.5, sq=1000, sk=1000)
    n = flash_fwd.launches
    o, lse = flash_fwd(qp, kp, vp, **kw)
    assert flash_fwd.launches == n + 1 and o.device == dev
    ro, rl = flash_fwd_ref(qp, kp, vp, **kw)
    tol, row_tol = (3e-2, 1e-2) if dtype == torch.bfloat16 else (1e-4, 1e-5)
    torch.testing.assert_close(o.float(), ro.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, rl, rtol=1e-4, atol=1e-4)
    dD = (dop.float() * ro.float()).sum(-1)
    before = (flash_bwd.fused_launches, flash_bwd.dq_launches,
              flash_bwd.dkv_launches)
    got = flash_bwd(qp, kp, vp, dop, rl, dD, **kw)
    want = flash_bwd_ref(qp, kp, vp, dop, rl, dD, **kw)
    after = (flash_bwd.fused_launches, flash_bwd.dq_launches,
             flash_bwd.dkv_launches)
    assert [a - b for a, b in zip(after, before)] == (
        [1, 0, 0] if dtype == torch.bfloat16 else [0, 1, 1])
    for name, x, ref in zip(("dq", "dk", "dv"), got, want):
        assert x.device == dev and torch.isfinite(x).all(), name
        x, ref = x.float(), ref.float()
        rn = ref.norm(dim=-1)
        keep = rn >= 1e-2 * rn.median()
        row = float(((x - ref).norm(dim=-1)[keep] / rn[keep]).max())
        assert row <= row_tol, (name, row)
        assert float((x - ref).abs().max() / ref.abs().max()) <= row_tol
    o_rows = (o.float() - ro.float()).norm(dim=-1) / ro.float().norm(dim=-1)
    assert float(o_rows.max()) <= row_tol


def test_launches_on_the_second_card(second_card):
    torch.cuda.set_device(0)
    for i in range(1, torch.cuda.device_count()):
        _launches_on(torch.device("cuda", i))
    assert torch.cuda.current_device() == 0


def _launches_on(dev):
    rng = np.random.default_rng(5)
    n, w = 512, 64
    adj = rng.integers(0, 1 << 32, size=(n, w), dtype=np.uint64) \
        & rng.integers(0, 1 << 32, size=(n, w), dtype=np.uint64)
    mask = rng.integers(0, 1 << 32, size=(w,), dtype=np.uint64)
    adj[::3] |= mask
    a, m = (bitset.from_u32(x.astype(np.uint32), dev) for x in (adj, mask))
    nw = n // 32
    q = bitset.from_u32(rng.integers(0, 1 << 32, size=(nw,),
                                     dtype=np.uint64).astype(np.uint32), dev)
    p = ~q
    # K1
    got = fused_check_packed(a, m, bitset.count(m), q, p, impl="pallas",
                             with_counts=True)
    want = fused_check_packed_ref(a, m, bitset.count(m), q, p,
                                  with_counts=True)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert all(x.device == dev for x in got)
    # K4
    got = fs.fused_select_packed(a, m, q, impl="pallas")
    want = fs.fused_select_packed(a.cpu(), m.cpu(), q.cpu())
    assert all(torch.equal(x.cpu(), y) for x, y in zip(got, want))
    # K5
    before = intersect_count.launches
    got = intersect_count(a, m, impl="pallas")
    assert intersect_count.launches == before + 1 and got.device == dev
    assert torch.equal(got, intersect_count_ref(a, m))
    # K3: a pool of 8 lanes, run to the end in segments of 4 steps
    gs = [g.canonical() for g in random_graph_stream(8, seed=1)
          if g.canonical().n_u <= 16 and g.canonical().n_v <= 64]
    cfg = ed.EngineConfig(n_u=16, n_v=64, m_real=16, depth=18)
    ctx = _stack([DENSE.make_context(g, cfg, dev) for g in gs])
    s = _stack([DENSE.fresh_lane_state(cfg, g.n_u, dev) for g in gs])
    start = s.steps.clone()
    sk = sr = s
    before = resident_pool_segment.launches
    while bool(ed._active(sk, start, 1 << 30).any()):
        sk, bk = resident_pool_segment(ctx, cfg, sk, start=start,
                                       budget=1 << 30, steps_per_call=4,
                                       ctx_batched=True)
        sr, br = resident_pool_segment_ref(ctx, cfg, sr, start=start,
                                           budget=1 << 30,
                                           steps_per_call=4,
                                           ctx_batched=True)
        for name, x, y in zip(sk._fields, sk, sr):
            assert torch.equal(x, y), name
        assert torch.equal(bk, br)
    assert resident_pool_segment.launches > before
    # K2: the pool's first lane alone, run to its end
    lane, lctx = ed._lane(s, 0), ed._lane(ctx, 0)
    lstart = lane.steps.clone()
    lk = lr = lane
    before = resident_segment.launches
    while bool(ed._active(lk, lstart, 1 << 30)):
        lk = resident_segment(lctx, cfg, lk, start=lstart, budget=1 << 30,
                              steps_per_call=4)
        lr = resident_segment_ref(lctx, cfg, lr, start=lstart,
                                  budget=1 << 30, steps_per_call=4)
        for name, x, y in zip(lk._fields, lk, lr):
            assert torch.equal(x, y), name
    assert resident_segment.launches > before
    # K7 forward, fused bf16 backward, fp32 dq / dkv
    for dtype in (torch.bfloat16, torch.float32):
        _k7_on(dev, dtype)
    torch.cuda.synchronize(dev)


def test_hybrid_prefill_with_k7_on_the_second_card(second_card,
                                                    monkeypatch):
    """zamba2's smoke config (bf16, hd 16) prefilled at model=2 over
    ``cuda:0`` and ``cuda:1``: a card runs its SSM heads and its 2 of the
    shared block's 4 heads, whose K7 forward calls (2 applications a
    card) are each held against ``flash_fwd_ref`` on the card that ran
    them (3e-2 element-wise, lse 1e-4); the logits against the same
    forward on ``cuda:0`` alone within ||dlogit|| / ||logit|| 0.1 at
    every position (``chip_smoke.py``'s LM_LOGIT_RTOL)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.layers import init_params, shard_params
    from repro_torch.sharding.auto import make_rules
    from repro_torch.sharding.axes import use_rules
    cfg = dataclasses.replace(configs.get_smoke("zamba2-7b"),
                              attn_impl="pallas")
    specs = M.param_specs(cfg)
    p = init_params(specs, 0, device="cuda:0")
    mesh = Mesh(["cuda:0", "cuda:1"], ("data", "model"), (1, 2))
    rules = make_rules(cfg, mesh, ShapeSpec("prefill", 64, 2, "prefill"))
    toks = torch.randint(0, cfg.vocab, (2, 64), device="cuda:0",
                         generator=torch.Generator(device="cuda:0")
                         .manual_seed(3))
    real, cards = ops._fwd, []

    def held(q, k, v, causal, scale):
        o, saved = real(q, k, v, causal, scale)
        qp, kp, vp, op, lse = saved
        ro, rl = flash_fwd_ref(qp, kp, vp, causal=causal,
                               scale=q.shape[-1] ** -0.5 if scale is None
                               else scale, sq=q.shape[1], sk=k.shape[1])
        torch.testing.assert_close(op.float(), ro.float(), rtol=3e-2,
                                   atol=3e-2)
        torch.testing.assert_close(lse, rl, rtol=1e-4, atol=1e-4)
        cards.append(q.device.index)
        return o, saved
    monkeypatch.setattr(ops, "_fwd", held)
    n = flash_fwd.launches
    with torch.no_grad(), use_rules(rules):
        got = M.forward(cfg, shard_params(p, specs, rules), toks)[0]
    assert sorted(cards) == [0, 0, 1, 1]
    assert flash_fwd.launches - n == 4
    with torch.no_grad():
        want = M.forward(cfg, p, toks)[0].float()
    rel = (got.float() - want).norm(dim=-1) / want.norm(dim=-1)
    assert bool(torch.isfinite(got).all()) and float(rel.max()) <= 0.1
