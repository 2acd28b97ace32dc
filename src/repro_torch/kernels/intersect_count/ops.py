"""Dispatch wrapper for the intersect-count primitive.

Twin of ``src/repro/kernels/intersect_count/ops.py``.  It replaces the
Pallas kernel ``src/repro/kernels/intersect_count/kernel.py:_kernel``
(``intersect_count_pallas``) with ``csrc/intersect_count.cu``.

``impl`` follows ``kernels.dispatch``: on a CUDA tensor the kernel path
launches the CUDA kernel, on a CPU tensor it runs ``ref.py``.  Every
launch adds one to ``intersect_count.launches``.  Leading lane dims on
``mask`` (and ``idx``) are covered by ONE launch (grid (row tiles,
lanes), ``dispatch.plan_rows``), with a shared (N, W) or per-lane
(..., N, W) adjacency; a call is that one kernel on the current stream,
with no host sync.
"""
from __future__ import annotations

import struct
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import (Outputs, aligned16,
                                          current_stream_ptr, expect,
                                          expect_i32, lane_layout, plan_rows,
                                          use_kernel)
from repro_torch.kernels.intersect_count.ref import (
    intersect_count_gathered_ref, intersect_count_ref)

# csrc/intersect_count.cu:CountArgs, field for field (8 bytes each): 5
# pointers, then 12 int64 fields (the call's, then the plan's)
FIELDS = ("adj", "mask", "idx", "counts", "stream",
          "adj_stride", "n_adj", "n", "w", "lanes",
          "rows", "threads", "group", "units", "chunk", "nchunks", "vec")
_ARGS = struct.Struct("<5Q12q")
_I32 = torch.int32
_WHAT = "intersect_count"


class _Sig(NamedTuple):
    """What one call signature (operand shapes) fixes, checked and
    computed once: the output's layout, the launch's integer fields and
    the launch plans (one-word and 16-byte loads)."""
    out: Outputs
    ints: tuple         # adj_stride, n_adj, n, w, lanes
    plans: tuple        # (one-word plan, 16-byte plan)


_sigs: dict = {}


def _signature(adj, mask, idx) -> _Sig:
    lead = tuple(mask.shape[:-1])
    batch, adj_stride = lane_layout(adj, lead, _WHAT)
    n_adj, w = adj.shape[-2:]
    n = n_adj if idx is None else idx.shape[-1]
    expect(mask, _WHAT, "mask", mask.dtype, lead + (w,), mask.device)
    if idx is not None:
        expect(idx, _WHAT, "idx", idx.dtype, lead + (n,), idx.device)
    return _Sig(Outputs([(_I32, lead + (n,))]),
                (adj_stride, n_adj, n, w, batch),
                (plan_rows(n, w, batch, False), plan_rows(n, w, batch, True)))


def _launch(adj, mask, idx=None):
    """One launch of ``csrc/intersect_count.cu`` over every lane: the
    operands checked (shapes once per call signature, dtype, device and
    layout every call), the counts in one allocation, one packed argument
    block, one C call and nothing else on the device."""
    dev = adj.device
    if not (adj.dtype is _I32 and mask.dtype is _I32 and mask.device == dev
            and adj.is_contiguous() and mask.is_contiguous()):
        for name, t in (("adj", adj), ("mask", mask)):
            expect(t, _WHAT, name, _I32, t.shape, dev)
    if idx is not None:
        expect_i32(idx, _WHAT, "idx", idx.shape, dev)
    key = (adj.shape, mask.shape, None if idx is None else idx.shape)
    sig = _sigs.get(key)
    if sig is None:
        sig = _sigs[key] = _signature(adj, mask, idx)
    counts, = sig.out.alloc(dev)
    plan = sig.plans[aligned16(adj, mask, sig.ints[3])]
    args = _ARGS.pack(
        adj.data_ptr(), mask.data_ptr(), 0 if idx is None else idx.data_ptr(),
        counts.data_ptr(), current_stream_ptr(dev.index), *sig.ints,
        *plan[:7])
    rc = _build.library().rt_intersect_count(args)
    if rc:
        _build.check(rc, f"{_WHAT} launch")
    return counts


def intersect_count(adj, mask, *, idx=None, impl: str = "auto"):
    """counts[i] = popcount(adj[i] & mask), or with ``idx`` (..., M) the
    counts of the gathered rows ``adj[idx]`` in position order, read
    through ``idx`` on the card (JAX's gather rule: a negative index wraps
    once, then clamps)."""
    if not use_kernel(impl, adj.device):
        if idx is None:
            return intersect_count_ref(adj, mask)
        return intersect_count_gathered_ref(adj, idx, mask)
    counts = _launch(adj, mask, idx)
    intersect_count.launches += 1
    return counts


intersect_count.launches = 0
