"""The port's fused candidate selection (``repro_torch.kernels.
fused_select``) against the JAX package's, every activity kind (dense,
packed, prefix) and both gathered wrappers: the same numpy-seeded inputs
through JAX's Pallas kernel in interpret mode and its jnp oracle, and the
port's wrappers on CPU tensors (their plain versions).  Covers
first-minimum ties, the ``(-1, INT32_MAX)`` sentinel, ``p = 0`` and
lane-batched calls equal to per-lane ones.  Tolerance: exact."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.fused_select import ops as jops
from repro_torch.core import bitset as tb
from repro_torch.kernels import fused_select as tops

INF = 0x7FFFFFFF


def _inputs(n, w, seed, tied=False):
    rng = np.random.default_rng(seed)
    adj = (rng.integers(0, 1 << 32, size=(n, w), dtype=np.uint64)
           & rng.integers(0, 1 << 32, size=(n, w), dtype=np.uint64))
    mask = rng.integers(0, 1 << 32, size=(w,), dtype=np.uint64)
    if tied:
        adj[:] = adj[0]             # every row ties
    act = (rng.random(n) < 0.4).astype(np.int32)
    return adj.astype(np.uint32), mask.astype(np.uint32), act, \
        rng.permutation(n).astype(np.int32)


def _words(act):
    return tb.to_u32(tb.from_bool(torch.from_numpy(act > 0)))


def _call_both(kind, adj, mask, act, idx, p, impl):
    """(JAX (idx, val), port (idx, val)) of one kind."""
    ja, jm = jnp.asarray(adj), jnp.asarray(mask)
    ta, tm = tb.from_u32(adj), tb.from_u32(mask)
    kw = dict(impl="pallas", interpret=True) if impl == "pallas" \
        else dict(impl="jnp")
    if kind == "dense":
        j = jops.fused_select(ja, jm, jnp.asarray(act), **kw)
        t = tops.fused_select(ta, tm, torch.from_numpy(act), impl="pallas")
    elif kind == "packed":
        j = jops.fused_select_packed(ja, jm, jnp.asarray(_words(act)), **kw)
        t = tops.fused_select_packed(ta, tm, tb.from_u32(_words(act)),
                                     impl="pallas")
    elif kind == "prefix":
        j = jops.fused_select_prefix(ja, jm, jnp.int32(p), **kw)
        t = tops.fused_select_prefix(ta, tm, torch.tensor(p, dtype=torch.int32),
                                     impl="pallas")
    elif kind == "gathered":
        j = jops.fused_select_gathered(ja, jnp.asarray(idx), jm,
                                       jnp.asarray(act), **kw)
        t = tops.fused_select_gathered(ta, torch.from_numpy(idx), tm,
                                       torch.from_numpy(act), impl="pallas")
    else:
        j = jops.fused_select_gathered_prefix(ja, jnp.asarray(idx), jm,
                                              jnp.int32(p), **kw)
        t = tops.fused_select_gathered_prefix(
            ta, torch.from_numpy(idx), tm, torch.tensor(p, dtype=torch.int32),
            impl="pallas")
    return tuple(int(x) for x in j), tuple(int(x) for x in t)


KINDS = ["dense", "packed", "prefix", "gathered", "gathered_prefix"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,w,tied", [(96, 3, False), (100, 5, True)])
def test_port_matches_jax_pallas_interpret(kind, n, w, tied):
    adj, mask, act, idx = _inputs(n, w, seed=n + w, tied=tied)
    j, t = _call_both(kind, adj, mask, act, idx, p=n // 3, impl="pallas")
    assert t == j
    if tied and kind in ("prefix", "gathered_prefix"):
        assert t[0] == 0                    # the first of the tied rows


@pytest.mark.parametrize("kind", KINDS)
def test_no_active_row_gives_the_sentinel(kind):
    adj, mask, act, idx = _inputs(64, 2, seed=3)
    act[:] = 0
    j, t = _call_both(kind, adj, mask, act, idx, p=0, impl="jnp")
    assert t == j == (-1, INF)


def test_lane_batched_equals_per_lane():
    """One call over three lanes (shared and per-lane adjacency) equals
    three calls, for every kind."""
    lanes = [_inputs(70, 3, seed) for seed in range(3)]
    adj = torch.stack([tb.from_u32(a) for a, *_ in lanes])
    mask = torch.stack([tb.from_u32(m) for _, m, *_ in lanes])
    act = torch.stack([torch.from_numpy(a) for *_, a, _ in lanes])
    words = tb.from_bool(act > 0)
    idx = torch.stack([torch.from_numpy(i) for *_, i in lanes])
    p = torch.tensor([0, 17, 70], dtype=torch.int32)
    calls = {
        "dense": lambda a, b: tops.fused_select(a, mask[b], act[b]),
        "packed": lambda a, b: tops.fused_select_packed(a, mask[b],
                                                        words[b]),
        "prefix": lambda a, b: tops.fused_select_prefix(a, mask[b], p[b]),
        "gathered": lambda a, b: tops.fused_select_gathered(
            a, idx[b], mask[b], act[b]),
        "gathered_prefix": lambda a, b: tops.fused_select_gathered_prefix(
            a, idx[b], mask[b], p[b]),
    }
    batched = {
        "dense": lambda a: tops.fused_select(a, mask, act),
        "packed": lambda a: tops.fused_select_packed(a, mask, words),
        "prefix": lambda a: tops.fused_select_prefix(a, mask, p),
        "gathered": lambda a: tops.fused_select_gathered(a, idx, mask, act),
        "gathered_prefix": lambda a: tops.fused_select_gathered_prefix(
            a, idx, mask, p),
    }
    for kind in KINDS:
        per_lane = batched[kind](adj)
        shared = batched[kind](adj[0])
        for b in range(3):
            want = calls[kind](adj[b], b)
            assert [int(x[b]) for x in per_lane] == [int(x) for x in want]
            want0 = calls[kind](adj[0], b)
            assert [int(x[b]) for x in shared] == [int(x) for x in want0]
    # lane 0 has p = 0: the sentinel, unclamped, beside busy lanes
    for kind in ("prefix", "gathered_prefix"):
        i, v = batched[kind](adj)
        assert (int(i[0]), int(v[0])) == (-1, INF) and int(i[2]) >= 0
