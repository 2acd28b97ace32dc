"""The port's packed fused check (``repro_torch.kernels.fused_check``)
against the JAX package's ``fused_check_packed``: the same numpy-seeded
inputs, padded and unpadded shapes, with and without counts.  JAX runs
its Pallas kernel in interpret mode and its jnp oracle; the port runs its
wrapper on CPU tensors (the plain version).  Tolerance: exact."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.fused_check.ops import fused_check_packed as j_fcp
from repro_torch.core import bitset as tb
from repro_torch.kernels.fused_check import (fused_check_packed,
                                             fused_check_packed_ref)


def _inputs(n, w, seed):
    rng = np.random.default_rng(seed)
    adj = (rng.integers(0, 1 << 32, size=(n, w), dtype=np.uint64)
           & rng.integers(0, 1 << 32, size=(n, w), dtype=np.uint64))
    mask = (rng.integers(0, 1 << 32, size=(w,), dtype=np.uint64)
            & rng.integers(0, 1 << 32, size=(w,), dtype=np.uint64))
    adj[::5] |= mask                # rows with c == |L'|
    adj[2::7] = 0                   # rows with c == 0
    nw = (n + 31) // 32
    q = rng.integers(0, 1 << 32, size=(nw,), dtype=np.uint64)
    p = rng.integers(0, 1 << 32, size=(nw,), dtype=np.uint64) & ~q
    if n % 32:                      # bits >= N stay clear
        q[-1] &= (1 << (n % 32)) - 1
        p[-1] &= (1 << (n % 32)) - 1
    nlp = int(sum(bin(int(x)).count("1") for x in mask))
    return [x.astype(np.uint32) for x in (adj, mask, q, p)], nlp


def _torch(arrs, nlp):
    adj, mask, q, p = (tb.from_u32(a) for a in arrs)
    return adj, mask, torch.tensor(nlp, dtype=torch.int32), q, p


def _assert_same(port, ref):
    viol, full, part, nz, counts = port
    assert bool(viol) == bool(ref[0])
    for a, b in zip((full, part, nz), ref[1:4]):
        np.testing.assert_array_equal(tb.to_u32(a), np.asarray(b))
    if ref[4] is None:
        assert counts is None
    else:
        np.testing.assert_array_equal(counts.numpy(), np.asarray(ref[4]))


@pytest.mark.parametrize("n,w", [(32, 1), (100, 5), (256, 8)])
@pytest.mark.parametrize("with_counts", [False, True])
def test_port_matches_jax_pallas_interpret(n, w, with_counts):
    arrs, nlp = _inputs(n, w, seed=n * 31 + w)
    ref = j_fcp(*(jnp.asarray(a) for a in arrs[:2]), jnp.int32(nlp),
                *(jnp.asarray(a) for a in arrs[2:]), impl="pallas",
                interpret=True, with_counts=with_counts)
    port = fused_check_packed(*_torch(arrs, nlp), impl="pallas",
                              with_counts=with_counts)
    _assert_same(port, ref)


@pytest.mark.parametrize("seed", range(3))
def test_port_matches_jax_jnp(seed):
    arrs, nlp = _inputs(77, 3, seed)
    ref = j_fcp(*(jnp.asarray(a) for a in arrs[:2]), jnp.int32(nlp),
                *(jnp.asarray(a) for a in arrs[2:]), impl="jnp",
                with_counts=True)
    _assert_same(fused_check_packed_ref(*_torch(arrs, nlp),
                                        with_counts=True), ref)


def test_lane_batched_equals_per_lane():
    """The per-step engine path calls the wrapper with a lane dim (shared
    or per-lane adjacency); each lane must equal its own unbatched call."""
    lanes = [_inputs(70, 3, seed) for seed in range(3)]
    per = [fused_check_packed(*_torch(a, n), impl="pallas",
                              with_counts=True) for a, n in lanes]
    ts = [_torch(a, n) for a, n in lanes]
    adj_b = torch.stack([t[0] for t in ts])
    stacked = [torch.stack([t[i] for t in ts]) for i in range(1, 5)]
    got = fused_check_packed(adj_b, *stacked, impl="pallas",
                             with_counts=True)
    for i, want in enumerate(per):
        for a, b in zip(got, want):
            assert torch.equal(a[i], b)
    shared = fused_check_packed(ts[0][0], *stacked, impl="pallas",
                                with_counts=True)
    for a, b in zip(shared, per[0]):
        assert torch.equal(a[0], b)


# -- the dense and prefix2 kinds and the gathered wrappers -------------------

from repro.kernels.fused_check import ops as jops          # noqa: E402
from repro_torch.kernels import fused_check as tops        # noqa: E402


def _dense_inputs(n, w, seed):
    (adj, mask, q, p), nlp = _inputs(n, w, seed)
    rng = np.random.default_rng(seed + 1)
    qa = (rng.random(n) < 0.5).astype(np.int32)
    pa = ((rng.random(n) < 0.6) & (qa == 0)).astype(np.int32)
    idx = rng.permutation(n).astype(np.int32)
    return adj, mask, nlp, qa, pa, idx


def _flags_equal(port, ref):
    assert bool(port[0]) == bool(ref[0])
    for a, b in zip(port[1:4], ref[1:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if ref[4] is None:
        assert port[4] is None
    else:
        np.testing.assert_array_equal(port[4].numpy(), np.asarray(ref[4]))


@pytest.mark.parametrize("kind", ["dense", "prefix2", "gathered",
                                  "gathered_prefix2"])
@pytest.mark.parametrize("with_counts", [False, True])
def test_other_kinds_match_jax_pallas_interpret(kind, with_counts):
    n, w = 100, 5
    adj, mask, nlp, qa, pa, idx = _dense_inputs(n, w, seed=11)
    ja, jm, jn = jnp.asarray(adj), jnp.asarray(mask), jnp.int32(nlp)
    ta, tm = tb.from_u32(adj), tb.from_u32(mask)
    tn = torch.tensor(nlp, dtype=torch.int32)
    kw = dict(impl="pallas", interpret=True, with_counts=with_counts)
    tkw = dict(impl="pallas", with_counts=with_counts)
    if kind == "dense":
        ref = jops.fused_check(ja, jm, jn, jnp.asarray(qa), jnp.asarray(pa),
                               **kw)
        port = tops.fused_check(ta, tm, tn, torch.from_numpy(qa),
                                torch.from_numpy(pa), **tkw)
    elif kind == "prefix2":
        ref = jops.fused_check_prefix2(ja, jm, jn, jnp.int32(31),
                                       jnp.int32(40), split=50, **kw)
        port = tops.fused_check_prefix2(ta, tm, tn, torch.tensor(31),
                                        torch.tensor(40), split=50, **tkw)
    elif kind == "gathered":
        ref = jops.fused_check_gathered(ja, jnp.asarray(idx), jm, jn,
                                        jnp.asarray(qa), jnp.asarray(pa),
                                        **kw)
        port = tops.fused_check_gathered(ta, torch.from_numpy(idx), tm, tn,
                                         torch.from_numpy(qa),
                                         torch.from_numpy(pa), **tkw)
    else:   # [Q ++ P'] of length 2N with split N, as the compact engine
        idx2 = np.concatenate([idx[::-1], idx]).astype(np.int32)
        ref = jops.fused_check_gathered_prefix2(
            ja, jnp.asarray(idx2), jm, jn, jnp.int32(37), jnp.int32(60),
            **kw)
        port = tops.fused_check_gathered_prefix2(
            ta, torch.from_numpy(idx2), tm, tn, torch.tensor(37),
            torch.tensor(60), **tkw)
    _flags_equal(port, ref)


def test_prefix2_edges_and_lanes():
    """q_hi = p_hi = 0 (nothing active), |L'| = 0, and one lane-batched
    call (shared and per-lane adjacency) equal to per-lane calls."""
    n = 64
    adj, mask, nlp, _, _, idx = _dense_inputs(n, 3, seed=5)
    idx2 = torch.from_numpy(np.concatenate([idx, idx]).astype(np.int32))
    ta, tm = tb.from_u32(adj), tb.from_u32(mask)
    zero = torch.tensor(0, dtype=torch.int32)
    viol, full, part, nz, _ = tops.fused_check_gathered_prefix2(
        ta, idx2, tm, torch.tensor(nlp), zero, zero, impl="pallas")
    assert not bool(viol) and not full.any() and not part.any()
    ref = jops.fused_check_gathered_prefix2(
        jnp.asarray(adj), jnp.asarray(idx2.numpy()), jnp.zeros(3, jnp.uint32),
        jnp.int32(0), jnp.int32(n), jnp.int32(n), impl="jnp",
        with_counts=True)
    _flags_equal(tops.fused_check_gathered_prefix2(
        ta, idx2, torch.zeros(3, dtype=torch.int32), zero,
        torch.tensor(n), torch.tensor(n), impl="pallas", with_counts=True),
        ref)
    masks = torch.stack([tm, tm & ~ta[3], ta[9]])
    nlps = tb.count(masks)
    q_hi = torch.tensor([0, 20, 64], dtype=torch.int32)
    p_hi = torch.tensor([64, 0, 33], dtype=torch.int32)
    idxs = torch.stack([idx2, idx2.flip(0), idx2])
    adjs = torch.stack([ta, ta.flip(0), ta])
    for adj_b in (adjs, ta):
        got = tops.fused_check_gathered_prefix2(adj_b, idxs, masks, nlps,
                                                q_hi, p_hi, impl="pallas",
                                                with_counts=True)
        for b in range(3):
            one = tops.fused_check_gathered_prefix2(
                adj_b if adj_b.dim() == 2 else adj_b[b], idxs[b], masks[b],
                nlps[b], q_hi[b], p_hi[b], impl="pallas", with_counts=True)
            for x, y in zip(got, one):
                assert torch.equal(x[b], y)
