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
