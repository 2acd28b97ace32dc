"""The port's torch bitset (``repro_torch.core.bitset``) against the JAX
twin (``repro.core.bitset``): every function on the same numpy-seeded
random words, bit for bit (tolerance: exact), plus the cases of
``tests/test_bitset.py`` on the port."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import bitset as jb
from repro_torch.core import bitset as tb


def _words(seed, shape, density=0.5):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
    if density < 0.5:
        w &= rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
    w = w.astype(np.uint32)
    w.reshape(-1, shape[-1])[0] = 0                 # an empty set
    return w


def _u32(x):
    return tb.to_u32(x)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("nw", [1, 7])
def test_word_functions_match_jax(seed, nw):
    w = _words(seed, (6, nw))
    tw, jw = tb.from_u32(w), jnp.asarray(w)
    np.testing.assert_array_equal(tb.popcount(tw).numpy(),
                                  np.asarray(jb.popcount(jw)))
    np.testing.assert_array_equal(tb.count(tw).numpy(),
                                  np.asarray(jb.count(jw)))
    np.testing.assert_array_equal(tb.first_member(tw).numpy(),
                                  np.asarray(jb.first_member(jw)))
    np.testing.assert_array_equal(_u32(tb.checksum(tw)),
                                  np.asarray(jb.checksum(jw)))
    w2 = _words(seed + 100, (6, nw), density=0.25)
    np.testing.assert_array_equal(
        _u32(tb.pair_checksum(tw, tb.from_u32(w2))),
        np.asarray(jb.pair_checksum(jw, jnp.asarray(w2))))
    np.testing.assert_array_equal(
        tb.is_subset(tw, tb.from_u32(w2)).numpy(),
        np.asarray(jb.is_subset(jw, jnp.asarray(w2))))
    np.testing.assert_array_equal(tb.equal(tw, tw).numpy(),
                                  np.asarray(jb.equal(jw, jw)))
    n = 32 * nw - 5
    np.testing.assert_array_equal(tb.to_bool(tw, n).numpy(),
                                  np.asarray(jb.to_bool(jw, n)))
    b = tb.to_bool(tw, n)
    np.testing.assert_array_equal(_u32(tb.from_bool(b)),
                                  np.asarray(jb.from_bool(jnp.asarray(
                                      b.numpy()))))
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 9, size=(6, n)).astype(np.int32)
    np.testing.assert_array_equal(
        tb.masked_argmin(torch.from_numpy(vals), tw).numpy(),
        np.asarray(jb.masked_argmin(jnp.asarray(vals), jw)))
    rows = _words(seed + 7, (9, nw))
    np.testing.assert_array_equal(
        tb.intersect_count(tb.from_u32(rows), tw[1]).numpy(),
        np.asarray(jb.intersect_count(jnp.asarray(rows), jw[1])))
    for k in (0, 1, 15, 28, 31):
        np.testing.assert_array_equal(_u32(tb.shr(tw, k)), w >> np.uint32(k))


@pytest.mark.parametrize("i", [-1, 0, 31, 32, 63, 69])
def test_singleton_member_add_remove_match_jax(i):
    nw = 3
    np.testing.assert_array_equal(_u32(tb.singleton(torch.tensor(i), nw)),
                                  np.asarray(jb.singleton(jnp.int32(i), nw)))
    if i < 0:
        return          # add/remove/member take members of the universe
    w = _words(i, (nw,))
    tw, jw = tb.from_u32(w), jnp.asarray(w)
    np.testing.assert_array_equal(_u32(tb.add(tw, i)),
                                  np.asarray(jb.add(jw, jnp.int32(i))))
    np.testing.assert_array_equal(_u32(tb.remove(tw, i)),
                                  np.asarray(jb.remove(jw, jnp.int32(i))))
    assert bool(tb.member(tw, i)) == bool(jb.member(jw, jnp.int32(i)))


def test_lane_batched_singleton_and_negative_floor_semantics():
    idx = torch.tensor([-1, 0, 33, 95])
    got = _u32(tb.singleton(idx, 3))
    want = np.stack([np.asarray(jb.singleton(jnp.int32(int(i)), 3))
                     for i in idx])
    np.testing.assert_array_equal(got, want)
    # masked_argmin of an empty set is 0, first_member of one is -1
    empty = torch.zeros(2, dtype=torch.int32)
    assert int(tb.masked_argmin(torch.arange(40, dtype=torch.int32),
                                empty)) == 0
    assert int(tb.first_member(empty)) == -1


def test_iota_and_wraparound():
    for n in (5, 32, 33, 100):
        for upto in (0, 1, n // 2, n):
            got = set(tb.unpack(_u32(tb.iota_mask(n, upto)), n))
            assert got == set(range(upto)), (n, upto)
            np.testing.assert_array_equal(
                _u32(tb.iota_mask(n, upto)),
                np.asarray(jb.iota_mask(n, jnp.int32(upto))))
    x = torch.tensor([(1 << 32) - 1, 1 << 32, (1 << 31)], dtype=torch.int64)
    np.testing.assert_array_equal(_u32(tb.wrap32(x)),
                                  np.array([0xFFFFFFFF, 0, 1 << 31],
                                           dtype=np.uint32))


# ---- the reference suite's cases, on the port ------------------------------

def test_pack_unpack_and_bool_roundtrip():
    rng = np.random.default_rng(0)
    for n in (1, 31, 32, 33, 130):
        members = set(rng.choice(n, size=n // 3, replace=False).tolist())
        w = tb.pack_indices(members, n)
        assert set(tb.unpack(w, n)) == members
        tw = tb.from_u32(w)
        assert int(tb.count(tw)) == len(members)
        for i in range(n):
            assert bool(tb.member(tw, i)) == (i in members)
        mask = np.zeros(n, bool)
        mask[list(members)] = True
        back = tb.to_bool(tb.from_bool(torch.from_numpy(mask)), n)
        assert (back.numpy() == mask).all()
        assert int(tb.first_member(tw)) == (min(members) if members
                                            else -1)


def test_add_remove_singleton():
    n = 70
    w = tb.from_u32(tb.pack_indices([3, 40], n))
    w = tb.add(w, 69)
    assert set(tb.unpack(_u32(w), n)) == {3, 40, 69}
    w = tb.remove(w, 40)
    assert set(tb.unpack(_u32(w), n)) == {3, 69}
    s = tb.singleton(torch.tensor(33), tb.n_words(n))
    assert tb.unpack(_u32(s), n) == [33]


def test_subset_equal_and_checksum_order_independent():
    n = 64
    a = tb.from_u32(tb.pack_indices([1, 5, 9], n))
    b = tb.from_u32(tb.pack_indices([9, 5, 1], n))
    c = tb.from_u32(tb.pack_indices([1, 5, 10], n))
    assert bool(tb.equal(a, b)) and not bool(tb.equal(a, c))
    assert bool(tb.is_subset(a, a | c)) and not bool(tb.is_subset(a, c))
    assert int(tb.checksum(a)) == int(tb.checksum(b))
    assert int(tb.checksum(a)) != int(tb.checksum(c))


def test_intersect_count_matches_python():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 2 ** 32, size=(17, 4), dtype=np.uint32)
    mask = rng.integers(0, 2 ** 32, size=(4,), dtype=np.uint32)
    got = tb.intersect_count(tb.from_u32(rows), tb.from_u32(mask)).numpy()
    for i in range(17):
        exp = bin(int.from_bytes((rows[i] & mask).tobytes(),
                                 "little")).count("1")
        assert got[i] == exp
