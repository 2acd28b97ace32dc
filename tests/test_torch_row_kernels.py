"""The row-tile kernels K1 (``fused_check``) and K4 (``fused_select``):
their launch plan, and their plain versions against the JAX package at
the tile edges the CUDA kernels have to get right.

* The launch plan (``dispatch.plan_rows``), pure Python: every row in
  exactly one tile, tiles on multiples of 32, each tile's rows and each
  row's units covered once by the thread groups exactly as
  ``csrc/rows.cuh`` walks them, thread and shared-memory limits, grid.y.
* The plain versions (the wrappers on CPU tensors) against JAX's Pallas
  kernels in interpret mode, every kind, shared and per-lane adjacency,
  two lanes a call (JAX called once a lane): ties at the minimum across
  tiles, p = 0 / 1 / n, packed activity with one bit in the last ragged
  word, n = 33 (one row in the last tile), negative and out-of-range
  ``idx``, |L'| = 0.  Tolerance: exact (integer outputs)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.fused_check import ops as jfc
from repro.kernels.fused_select import ops as jfs
from repro_torch.core import bitset as tb
from repro_torch.kernels import fused_check as tfc
from repro_torch.kernels import fused_select as tfs
from repro_torch.kernels.dispatch import (MAX_GRID_Y, MAX_ROW_THREADS,
                                          MAX_SMEM_BYTES, RMAX, ROW_THREADS,
                                          ROW_THREADS_LONG, ROW_TILE,
                                          plan_rows)

# -- the launch plan ---------------------------------------------------------

PLAN_NS = [1, 31, 32, 33, 100, 257, 512, 1000, 1024, 26_000, 32_768]
PLAN_WS = [1, 5, 8, 64, 128, 1024]
# (rows a CTA, threads at most): the default and the sweep's points
KNOBS = [(ROW_TILE, None), (32, 128), (64, 256), (128, 512),
         (256, 512), (256, 128), (16, 64)]


def _covered_once(idx, size):
    counts = np.bincount(idx[(idx >= 0) & (idx < size)], minlength=size)
    return bool((counts == 1).all())


@pytest.mark.parametrize("w", PLAN_WS)
@pytest.mark.parametrize("lanes", [1, 2, 8])
def test_row_plan_covers_every_row_once(w, lanes):
    for n in PLAN_NS:
        for vec in (True, False):
            for rows, max_threads in KNOBS:
                p = plan_rows(n, w, lanes, vec, rows, max_threads)
                where = f"n={n} w={w} lanes={lanes} vec={vec} knobs=" \
                        f"{(rows, max_threads)}: {p}"
                # tiles: multiples of 32, every row in exactly one
                starts = np.arange(p.tiles) * p.rows
                assert p.rows % 32 == 0 and (starts % 32 == 0).all(), where
                assert starts[-1] < n <= starts[-1] + p.rows, where
                # threads and groups, as the kernels' checks (plan_ok)
                assert p.threads % 32 == 0, where
                assert 32 <= p.threads <= min(1024, MAX_ROW_THREADS), where
                assert p.threads >= p.rows, where
                assert p.group in (1, 2, 4, 8, 16, 32), where
                ng = p.threads // p.group
                assert p.rows % ng == 0, where
                rpg = p.rows // ng
                assert 1 <= rpg <= RMAX, where
                # the tile's rows: group gi owns rows gi + j * ng, j < rpg
                gi, j = np.meshgrid(np.arange(ng), np.arange(rpg))
                assert _covered_once((gi + j * ng).ravel(), p.rows), where
                # a row's units: lane gl of chunk c, unit k reads
                # (c * chunk + k) * group + gl, the rest masked off
                assert p.vec == (vec and w % 4 == 0), where
                assert p.units == (w // 4 if p.vec else w), where
                assert p.chunk in (1, 2, 4, 8), where
                c, k, gl = np.meshgrid(np.arange(p.nchunks),
                                       np.arange(p.chunk),
                                       np.arange(p.group), indexing="ij")
                u = ((c * p.chunk + k) * p.group + gl).ravel()
                assert _covered_once(u, p.units), where
                assert (u >= 0).all() and len(set(u.tolist())) == len(u)
                assert p.smem_bytes <= MAX_SMEM_BYTES, where
                assert p.lanes == lanes <= MAX_GRID_Y, where
                assert p.tiles < 1 << 31, where


def test_row_plan_refuses_what_the_grid_cannot_hold():
    with pytest.raises(ValueError):
        plan_rows(64, 8, MAX_GRID_Y + 1)
    with pytest.raises(ValueError):
        plan_rows(0, 8, 1)
    assert plan_rows(64, 8, MAX_GRID_Y).lanes == MAX_GRID_Y


def test_default_plan_spreads_the_timed_shapes():
    """At the timed shapes (2 lanes x 512 rows, 1 x 1,024 rows of 64
    words) the default plan launches 32 CTAs, each thread with one
    16-byte unit a row, the mask slice in registers."""
    for n, lanes in ((512, 2), (1024, 1)):
        p = plan_rows(n, 64, lanes)
        assert p.tiles * p.lanes == 32
        assert (p.vec, p.units, p.group, p.chunk, p.nchunks) == \
            (True, 16, 16, 1, 1)
        assert p.threads == ROW_THREADS
    # past the residency gate, a ragged width: one-word loads, a row in
    # chunks, fewer threads with RMAX rows each
    p = plan_rows(26_000, 813, 1)
    assert (p.vec, p.group, p.chunk, p.nchunks, p.threads) == \
        (False, 32, 8, 4, ROW_THREADS_LONG)


# -- the plain versions against the JAX package at the tile edges ------------

LANES = 2
CASES = ["ties", "p0", "p1", "pn", "lastbit", "ragged33", "idx_range",
         "empty"]


def _case(case, per_lane, seed):
    """numpy operands of both kernels for ``LANES`` lanes: adjacency
    (lanes or 1, n, w), mask (lanes, w), idx (lanes, n), dense activity
    act / q / p (lanes, n), the prefix bound pb, the prefix2 bounds
    (q_hi, p_hi) with split = n // 2."""
    n, w = (33, 8) if case == "ragged33" else (100, 5)
    rng = np.random.default_rng(seed)

    def words(*shape):
        return (rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
                & rng.integers(0, 1 << 32, size=shape, dtype=np.uint64))

    adj = words(LANES if per_lane else 1, n, w)
    mask = words(LANES, w)
    adj[:, ::7] |= mask[:, None, :] if per_lane else mask[:1, None, :]
    adj[:, 3::11] = 0
    idx = np.stack([rng.permutation(n) for _ in range(LANES)])
    act = (rng.random((LANES, n)) < 0.5).astype(np.int32)
    qa = (rng.random((LANES, n)) < 0.4).astype(np.int32)
    pa = ((rng.random((LANES, n)) < 0.6) & (qa == 0)).astype(np.int32)
    split = n // 2
    pb = rng.integers(1, n + 1, size=LANES)
    q_hi = rng.integers(0, split + 1, size=LANES)
    p_hi = rng.integers(0, n - split + 1, size=LANES)
    if case == "ties":
        # every row meets the mask but rows 40, 70 and 99: the minimum 0
        # first in tile 1, equal in tiles 2 and 3 (positions = rows)
        mask[:, 0] |= 1
        adj[:, :, 0] |= 1
        adj[:, [40, 70, 99]] = 0
        idx = np.stack([np.arange(n)] * LANES)
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
        # every activity word 0 but one bit in the last, ragged word
        act[:] = qa[:] = pa[:] = 0
        act[:, n - 2] = pa[:, n - 2] = 1
        qa[:, n - 3] = 1
        pb[:] = n - 1
        q_hi[:] = split
        p_hi[:] = n - split - 1
    elif case == "idx_range":
        idx[:, :6] = [-1, -n, -n - 3, n, n + 5, -(1 << 30)]
        idx[:, -3:] = [1 << 30, -2, n - 1]
    elif case == "empty":
        mask[:] = 0
    return dict(n=n, w=w, split=split, adj=adj.astype(np.uint32),
                mask=mask.astype(np.uint32), idx=idx.astype(np.int32),
                act=act, qa=qa, pa=pa, pb=pb.astype(np.int32),
                q_hi=q_hi.astype(np.int32), p_hi=p_hi.astype(np.int32))


def _port_adj(x):
    a = tb.from_u32(x["adj"])
    return a if a.shape[0] == LANES else a[0]


def _lane_adj(x, b):
    return jnp.asarray(x["adj"][b if x["adj"].shape[0] == LANES else 0])


def _words(act):
    return tb.from_bool(torch.from_numpy(act > 0))


JAX = dict(impl="pallas", interpret=True)
SELECT_KINDS = ["dense", "packed", "prefix", "gathered", "gathered_prefix"]


def _select_port(kind, x):
    a, m = _port_adj(x), tb.from_u32(x["mask"])
    idx, act = torch.from_numpy(x["idx"]), torch.from_numpy(x["act"])
    pb = torch.from_numpy(x["pb"])
    return {"dense": lambda: tfs.fused_select(a, m, act),
            "packed": lambda: tfs.fused_select_packed(a, m, _words(x["act"])),
            "prefix": lambda: tfs.fused_select_prefix(a, m, pb),
            "gathered": lambda: tfs.fused_select_gathered(a, idx, m, act),
            "gathered_prefix": lambda: tfs.fused_select_gathered_prefix(
                a, idx, m, pb)}[kind]()


def _select_jax(kind, x, b):
    a, m = _lane_adj(x, b), jnp.asarray(x["mask"][b])
    idx, act = jnp.asarray(x["idx"][b]), jnp.asarray(x["act"][b])
    pb = jnp.int32(x["pb"][b])
    if kind == "dense":
        return jfs.fused_select(a, m, act, **JAX)
    if kind == "packed":
        w = jnp.asarray(tb.to_u32(_words(x["act"][b])))
        return jfs.fused_select_packed(a, m, w, **JAX)
    if kind == "prefix":
        return jfs.fused_select_prefix(a, m, pb, **JAX)
    if kind == "gathered":
        return jfs.fused_select_gathered(a, idx, m, act, **JAX)
    return jfs.fused_select_gathered_prefix(a, idx, m, pb, **JAX)


@pytest.mark.parametrize("per_lane", [False, True],
                         ids=["shared_adj", "per_lane_adj"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kind", SELECT_KINDS)
def test_fused_select_plain_matches_jax_at_tile_edges(kind, case, per_lane):
    x = _case(case, per_lane, seed=len(kind) + 7 * len(case))
    got_idx, got_val = _select_port(kind, x)
    for b in range(LANES):
        want = tuple(int(v) for v in _select_jax(kind, x, b))
        assert (int(got_idx[b]), int(got_val[b])) == want, (kind, case, b)
    if case == "ties" and kind in ("dense", "packed", "prefix"):
        assert got_idx.tolist() == [40] * LANES     # the first minimum
    if case == "p0":
        assert got_idx.tolist() == [-1] * LANES
        assert got_val.tolist() == [0x7FFFFFFF] * LANES


CHECK_KINDS = ["packed", "dense", "prefix2", "gathered", "gathered_prefix2"]


def _check_port(kind, x):
    a, m = _port_adj(x), tb.from_u32(x["mask"])
    nlp = tb.count(m)
    idx = torch.from_numpy(x["idx"])
    qa, pa = torch.from_numpy(x["qa"]), torch.from_numpy(x["pa"])
    q_hi, p_hi = torch.from_numpy(x["q_hi"]), torch.from_numpy(x["p_hi"])
    kw = dict(with_counts=True)
    if kind == "packed":
        return tfc.fused_check_packed(a, m, nlp, _words(x["qa"]),
                                      _words(x["pa"]), **kw)
    if kind == "dense":
        return tfc.fused_check(a, m, nlp, qa, pa, **kw)
    if kind == "prefix2":
        return tfc.fused_check_prefix2(a, m, nlp, q_hi, p_hi,
                                       split=x["split"], **kw)
    if kind == "gathered":
        return tfc.fused_check_gathered(a, idx, m, nlp, qa, pa, **kw)
    return tfc.fused_check_gathered_prefix2(a, idx, m, nlp, q_hi, p_hi,
                                            **kw)


def _check_jax(kind, x, b):
    a, m = _lane_adj(x, b), jnp.asarray(x["mask"][b])
    nlp = jnp.int32(int(tb.count(tb.from_u32(x["mask"][b]))))
    idx = jnp.asarray(x["idx"][b])
    qa, pa = jnp.asarray(x["qa"][b]), jnp.asarray(x["pa"][b])
    q_hi, p_hi = jnp.int32(x["q_hi"][b]), jnp.int32(x["p_hi"][b])
    kw = dict(JAX, with_counts=True)
    if kind == "packed":
        return jfc.fused_check_packed(
            a, m, nlp, jnp.asarray(tb.to_u32(_words(x["qa"][b]))),
            jnp.asarray(tb.to_u32(_words(x["pa"][b]))), **kw)
    if kind == "dense":
        return jfc.fused_check(a, m, nlp, qa, pa, **kw)
    if kind == "prefix2":
        return jfc.fused_check_prefix2(a, m, nlp, q_hi, p_hi,
                                       split=x["split"], **kw)
    if kind == "gathered":
        return jfc.fused_check_gathered(a, idx, m, nlp, qa, pa, **kw)
    return jfc.fused_check_gathered_prefix2(a, idx, m, nlp, q_hi, p_hi,
                                            **kw)


@pytest.mark.parametrize("per_lane", [False, True],
                         ids=["shared_adj", "per_lane_adj"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kind", CHECK_KINDS)
def test_fused_check_plain_matches_jax_at_tile_edges(kind, case, per_lane):
    x = _case(case, per_lane, seed=3 * len(kind) + len(case))
    got = _check_port(kind, x)
    for b in range(LANES):
        want = _check_jax(kind, x, b)
        assert bool(got[0][b]) == bool(want[0]), (kind, case, b, "viol")
        for name, g, j in zip(("full", "part", "nz", "counts"), got[1:],
                              want[1:]):
            g = tb.to_u32(g[b]) if kind == "packed" and name != "counts" \
                else g[b].numpy()
            np.testing.assert_array_equal(g, np.asarray(j),
                                          err_msg=f"{kind} {case} {b} "
                                                  f"{name}")
    if case == "empty":
        # |L'| = 0: every count is 0 == |L'|, so nz is empty
        assert not got[3].any()
