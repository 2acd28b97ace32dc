"""The port's intersect-count primitive (``repro_torch.kernels.
intersect_count``) against the JAX package's: the same numpy-seeded
inputs through JAX's Pallas kernel in interpret mode (and its jnp oracle)
and the port's wrapper on CPU tensors (its plain version), plain and
gathered through an index vector, lane-batched equal to per-lane.
Tolerance: exact (integer counts)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.intersect_count.ops import intersect_count as j_ic
from repro.kernels.intersect_count.ref import (
    intersect_count_gathered_ref as j_icg)
from repro_torch.core import bitset as tb
from repro_torch.kernels.intersect_count import (intersect_count,
                                                 intersect_count_gathered_ref)


def _inputs(n, w, seed):
    rng = np.random.default_rng(seed)
    adj = (rng.integers(0, 1 << 32, size=(n, w), dtype=np.uint64)
           & rng.integers(0, 1 << 32, size=(n, w), dtype=np.uint64))
    mask = rng.integers(0, 1 << 32, size=(w,), dtype=np.uint64)
    adj[::5] |= mask
    adj[2::7] = 0
    idx = rng.permutation(n).astype(np.int32)
    return adj.astype(np.uint32), mask.astype(np.uint32), idx


@pytest.mark.parametrize("n,w", [(32, 1), (100, 5), (256, 8)])
def test_port_matches_jax_pallas_interpret(n, w):
    adj, mask, idx = _inputs(n, w, seed=n + w)
    want = j_ic(jnp.asarray(adj), jnp.asarray(mask), impl="pallas",
                interpret=True)
    got = intersect_count(tb.from_u32(adj), tb.from_u32(mask),
                          impl="pallas")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert j_ic(jnp.asarray(adj), jnp.asarray(mask), impl="jnp").tolist() \
        == got.tolist()


@pytest.mark.parametrize("seed", range(2))
def test_gathered_matches_jax(seed):
    """Rows read through ``idx`` in position order, out-of-range indices
    by JAX's gather rule (wrap once, then clamp)."""
    adj, mask, idx = _inputs(70, 3, seed)
    idx = np.concatenate([idx, [-1, -70, 69, 75, -200]]).astype(np.int32)
    want = j_icg(jnp.asarray(adj), jnp.asarray(idx), jnp.asarray(mask))
    got = intersect_count(tb.from_u32(adj), tb.from_u32(mask),
                          idx=torch.from_numpy(idx), impl="pallas")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lane_batched_equals_per_lane():
    lanes = [_inputs(64, 4, seed) for seed in range(3)]
    adj = torch.stack([tb.from_u32(a) for a, _, _ in lanes])
    mask = torch.stack([tb.from_u32(m) for _, m, _ in lanes])
    idx = torch.stack([torch.from_numpy(i) for _, _, i in lanes])
    got = intersect_count(adj, mask, idx=idx, impl="pallas")
    shared = intersect_count(adj[0], mask, idx=idx, impl="pallas")
    for b in range(3):
        assert torch.equal(got[b], intersect_count_gathered_ref(
            adj[b], idx[b], mask[b]))
        assert torch.equal(shared[b], intersect_count(
            adj[0], mask[b], idx=idx[b], impl="pallas"))
