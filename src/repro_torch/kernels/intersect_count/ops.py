"""Dispatch wrapper for the intersect-count primitive.

Twin of ``src/repro/kernels/intersect_count/ops.py``.  It replaces the
Pallas kernel ``src/repro/kernels/intersect_count/kernel.py:_kernel``
(``intersect_count_pallas``) with ``csrc/intersect_count.cu``.

``impl`` follows ``kernels.dispatch``: on a CUDA tensor the kernel path
launches the CUDA kernel, on a CPU tensor it runs ``ref.py``.  Every
launch adds one to ``intersect_count.launches``.  Leading lane dims on
``mask`` (and ``idx``) are covered by ONE launch (grid.y = lanes), with a
shared (N, W) or per-lane (..., N, W) adjacency.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import (expect, lane_layout, plan_blocks,
                                          use_kernel)
from repro_torch.kernels.intersect_count.ref import (
    intersect_count_gathered_ref, intersect_count_ref)

_I32 = torch.int32


def intersect_count(adj, mask, *, idx=None, impl: str = "auto"):
    """counts[i] = popcount(adj[i] & mask), or with ``idx`` (..., M) the
    counts of the gathered rows ``adj[idx]`` in position order, read
    through ``idx`` on the card (JAX's gather rule: a negative index wraps
    once, then clamps)."""
    if not use_kernel(impl, adj.device):
        if idx is None:
            return intersect_count_ref(adj, mask)
        return intersect_count_gathered_ref(adj, idx, mask)
    what = "intersect_count"
    dev = adj.device
    lead = tuple(mask.shape[:-1])
    batch, adj_stride = lane_layout(adj, lead, what)
    n_adj, w = adj.shape[-2:]
    n = n_adj if idx is None else idx.shape[-1]
    expect(adj, what, "adj", _I32, adj.shape, dev)
    expect(mask, what, "mask", _I32, lead + (w,), dev)
    if idx is not None:
        expect(idx, what, "idx", _I32, lead + (n,), dev)
    counts = torch.empty(lead + (n,), dtype=_I32, device=dev)
    plan = plan_blocks(w)
    rc = _build.library().rt_intersect_count(
        adj.data_ptr(), adj_stride, n_adj, mask.data_ptr(), _build.ptr(idx),
        counts.data_ptr(), batch, n, w, plan.threads, plan.group,
        _build.stream_ptr(dev))
    _build.check(rc, "intersect_count launch")
    intersect_count.launches += 1
    return counts


intersect_count.launches = 0
