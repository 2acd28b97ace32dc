"""The MBE mesh on the card (``gpu``-marked: without a CUDA device every
test skips, decided inside the ``card`` fixture).

* The heavy + small stream (``tests/test_executors.py``'s, cut to 8
  graphs) through ``ShardedExecutor`` on a mesh of every visible card,
  against ``LocalExecutor`` on card 0: the same (n_max, cs) and decoded
  bicliques, the heavy graph's workers busy on every card.
* With two or more cards: one K1, K3 and K4 launch on ``cuda:1``
  while ``cuda:0`` is the current device, each equal to its plain
  version, and the current device unchanged after it (the launchers
  enter their tensors' device; skips with one card).

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
from repro_torch.kernels.fused_check import (fused_check_packed,
                                             fused_check_packed_ref)
from repro_torch.kernels.resident_pool import (resident_pool_segment,
                                               resident_pool_segment_ref)
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


def test_launches_on_the_second_card(second_card):
    dev = second_card
    torch.cuda.set_device(0)
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
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0
