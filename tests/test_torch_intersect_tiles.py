"""K5 (``intersect_count``) on the row tiles: its plain version against the
JAX package at the tile edges the CUDA kernel has to get right, its packed
argument block against ``csrc/intersect_count.cu``'s ``CountArgs``, and
its launch plan over the shapes K5 is called at.

* The plain version (the wrapper on CPU tensors) against JAX's Pallas
  kernel in interpret mode (``intersect_count_pallas`` through the JAX
  wrapper, on the rows in order and on the rows JAX gathers through
  ``idx``) and JAX's gathered reference, at n across the 32-row tiles'
  edges, w = 1, 5 (w % 4 != 0: one-word loads) and 8, an ``idx`` with
  negative and out-of-range entries, shared and per-lane adjacency, two
  lanes a call (JAX called once a lane).  Tolerance: exact (integer
  counts).
* The argument block: ``ops.FIELDS`` against the struct in the CUDA
  source, field for field, and what ``_launch`` packs for a call (with
  the C library and the stream query replaced by stand-ins).
* The plan: every row position written exactly once, each row's units
  read once, as the kernel walks them."""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.intersect_count.ops import intersect_count as j_ic
from repro.kernels.intersect_count.ref import (
    intersect_count_gathered_ref as j_icg)
from repro_torch.core import bitset as tb
from repro_torch.kernels import dispatch
from repro_torch.kernels.intersect_count import intersect_count
from repro_torch.kernels.intersect_count import ops as k5_ops

LANES = 2
TILE_NS = [1, 31, 32, 33, 63, 64, 65]
WS = [1, 5, 8]


def _case(n, w, per_lane, seed):
    """numpy operands for ``LANES`` lanes: adjacency (lanes or 1, n, w),
    masks (lanes, w), idx (lanes, n) with negative and out-of-range
    entries in front."""
    rng = np.random.default_rng(seed)

    def words(*shape):
        return (rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
                & rng.integers(0, 1 << 32, size=shape, dtype=np.uint64))
    adj = words(LANES if per_lane else 1, n, w)
    mask = words(LANES, w)
    adj[:, ::7] |= mask[:, None, :] if per_lane else mask[:1, None, :]
    adj[:, 3::11] = 0
    idx = np.stack([rng.permutation(n) for _ in range(LANES)])
    edge = [-1, -n, -n - 3, n, n + 5, -(1 << 30), 1 << 30][:n]
    idx[:, :len(edge)] = edge
    return (adj.astype(np.uint32), mask.astype(np.uint32),
            idx.astype(np.int32))


def _jax_gather(adj, idx):
    """The rows JAX's indexing reads for ``idx`` (negative indices wrap
    once, out-of-range ones clamp)."""
    return np.asarray(jnp.asarray(adj)[jnp.asarray(idx)])


@pytest.mark.parametrize("per_lane", [False, True],
                         ids=["shared_adj", "per_lane_adj"])
@pytest.mark.parametrize("w", WS)
@pytest.mark.parametrize("n", TILE_NS)
def test_k5_plain_matches_jax_at_tile_edges(n, w, per_lane):
    adj, mask, idx = _case(n, w, per_lane, seed=97 * n + 5 * w + per_lane)
    a = tb.from_u32(adj)
    a = a if per_lane else a[0]
    m = tb.from_u32(mask)
    got = intersect_count(a, m).numpy()
    got_idx = intersect_count(a, m, idx=torch.from_numpy(idx)).numpy()
    for b in range(LANES):
        lane_adj = adj[b if per_lane else 0]
        want = j_ic(jnp.asarray(lane_adj), jnp.asarray(mask[b]),
                    impl="pallas", interpret=True)
        np.testing.assert_array_equal(got[b], np.asarray(want))
        rows = _jax_gather(lane_adj, idx[b])
        want_idx = j_ic(jnp.asarray(rows), jnp.asarray(mask[b]),
                        impl="pallas", interpret=True)
        np.testing.assert_array_equal(got_idx[b], np.asarray(want_idx))
        np.testing.assert_array_equal(
            got_idx[b], np.asarray(j_icg(jnp.asarray(lane_adj),
                                         jnp.asarray(idx[b]),
                                         jnp.asarray(mask[b]))))


# -- the packed argument block ----------------------------------------------

CSRC = pathlib.Path(k5_ops.__file__).resolve().parents[2] / "csrc"


def _struct_fields(name):
    """Field names of ``struct name`` in csrc/intersect_count.cu, in order,
    and how many of them are pointers."""
    src = (CSRC / "intersect_count.cu").read_text()
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    names, pointers = [], 0
    for decl in body.split(";"):
        decl = re.sub(r"//.*", "", decl).strip()
        if not decl:
            continue
        if "*" in decl:                  # one pointer a declaration
            pointers += 1
            names.append(decl.rsplit("*", 1)[1].strip())
        else:                            # long long a, b, ...
            rest = re.match(r"long long\s+(.*)", decl, re.S).group(1)
            names += [f.strip() for f in rest.split(",")]
    return names, pointers


def test_k5_argument_block_matches_count_args():
    names, pointers = _struct_fields("CountArgs")
    assert tuple(names) == k5_ops.FIELDS
    assert pointers == 5
    assert k5_ops._ARGS.size == 8 * len(k5_ops.FIELDS) == 136
    assert k5_ops._ARGS.format == "<5Q12q"


class _Lib:
    """Stands in for the kernel library: records the argument block."""

    def __init__(self):
        self.blocks = []

    def rt_intersect_count(self, block):
        self.blocks.append(block)
        return 0


@pytest.mark.parametrize("per_lane,with_idx", [(False, False), (True, True),
                                               (False, True)])
def test_k5_launch_packs_one_block(monkeypatch, per_lane, with_idx):
    adj, mask, idx = _case(100, 8, per_lane, seed=3)
    a = tb.from_u32(adj)
    a = a if per_lane else a[0]
    m = tb.from_u32(mask)
    i = torch.from_numpy(idx) if with_idx else None
    lib = _Lib()
    monkeypatch.setattr(k5_ops._build, "library", lambda: lib)
    monkeypatch.setattr(k5_ops, "current_stream_ptr", lambda index: 4242)
    counts = k5_ops._launch(a, m, i)
    assert counts.shape == (LANES, 100) and counts.dtype == torch.int32
    (block,) = lib.blocks
    f = dict(zip(k5_ops.FIELDS, k5_ops._ARGS.unpack(block)))
    assert f["adj"] == a.data_ptr() and f["mask"] == m.data_ptr()
    assert f["idx"] == (i.data_ptr() if with_idx else 0)
    assert f["counts"] == counts.data_ptr() and f["stream"] == 4242
    assert (f["adj_stride"], f["n_adj"], f["n"], f["w"], f["lanes"]) == \
        ((100 * 8 if per_lane else 0), 100, 100, 8, LANES)
    vec = dispatch.aligned16(a, m, 8)
    plan = dispatch.plan_rows(100, 8, LANES, vec)
    assert tuple(f[k] for k in k5_ops.FIELDS[10:]) == tuple(
        int(x) for x in plan[:7])
    # a second call of the same signature reuses its checks and plans
    k5_ops._launch(a, m, i)
    assert len(lib.blocks) == 2 and lib.blocks[0][40:] == lib.blocks[1][40:]


def test_k5_launch_refuses_bad_operands(monkeypatch):
    adj, mask, idx = _case(64, 4, False, seed=4)
    a, m = tb.from_u32(adj)[0], tb.from_u32(mask)
    monkeypatch.setattr(k5_ops._build, "library", lambda: _Lib())
    monkeypatch.setattr(k5_ops, "current_stream_ptr", lambda index: 0)
    with pytest.raises(ValueError, match="mask"):
        k5_ops._launch(a, m.to(torch.int64))
    with pytest.raises(ValueError, match="idx"):
        k5_ops._launch(a, m, torch.from_numpy(idx).to(torch.int64))
    with pytest.raises(ValueError, match="idx"):
        k5_ops._launch(a, m, torch.from_numpy(idx)[:1])
    with pytest.raises(ValueError, match="adj"):
        k5_ops._launch(tb.from_u32(adj)[:, :, :2].expand(3, 64, 2), m[:, :2])


# -- the launch plan over K5's shapes -----------------------------------------

K5_SHAPES = [(1, 1, 1), (31, 5, 2), (33, 8, 1), (65, 64, 2), (512, 64, 1),
             (512, 64, 2), (1024, 128, 1), (512, 5, 8), (26_000, 813, 2)]


@pytest.mark.parametrize("n,w,lanes", K5_SHAPES)
@pytest.mark.parametrize("vec", [True, False])
def test_k5_plan_writes_every_position_once(n, w, lanes, vec):
    """Walk the kernel's index math under the plan ``_signature`` keeps:
    group gi of a tile's ng groups owns rows gi + j ng (j < rpg), lane 0
    writes their counts; lane gl reads units (c chunk + k) group + gl."""
    adj = torch.zeros((n, w), dtype=torch.int32)
    mask = torch.zeros((lanes, w), dtype=torch.int32)
    sig = k5_ops._signature(adj, mask, None)
    p = sig.plans[vec]
    assert p == dispatch.plan_rows(n, w, lanes, vec)
    assert sig.ints == (0, n, n, w, lanes)
    ng = p.threads // p.group
    rpg = p.rows // ng
    assert 1 <= rpg <= dispatch.RMAX and p.rows % ng == 0
    gi, j, tile = np.meshgrid(np.arange(ng), np.arange(rpg),
                              np.arange(p.tiles), indexing="ij")
    pos = (tile * p.rows + gi + j * ng).ravel()
    written = np.bincount(pos[pos < n], minlength=n)
    assert (written == 1).all()
    c, k, gl = np.meshgrid(np.arange(p.nchunks), np.arange(p.chunk),
                           np.arange(p.group), indexing="ij")
    u = ((c * p.chunk + k) * p.group + gl).ravel()
    read = np.bincount(u[u < p.units], minlength=p.units)
    assert (read == 1).all()
    assert p.units == (w // 4 if p.vec else w)
    assert p.tiles * p.rows >= n > (p.tiles - 1) * p.rows
    assert p.threads <= dispatch.MAX_ROW_THREADS and p.lanes == lanes


def test_k5_default_plan_spreads_its_path_shape():
    """At the compact unfused path's shape (1 lane, 512 positions of 64
    words) K5 launches 16 CTAs of 32 rows, one 16-byte unit a thread and
    row, where the older plan launched 2 of 256 rows."""
    adj = torch.zeros((1, 512, 64), dtype=torch.int32)
    mask = torch.zeros((1, 64), dtype=torch.int32)
    idx = torch.zeros((1, 512), dtype=torch.int32)
    p = k5_ops._signature(adj, mask, idx).plans[True]
    assert (p.tiles, p.lanes, p.rows) == (16, 1, 32)
    assert (p.vec, p.units, p.group, p.chunk, p.nchunks) == \
        (True, 16, 16, 1, 1)
