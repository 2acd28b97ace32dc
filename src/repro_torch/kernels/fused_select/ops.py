"""Dispatch wrappers for fused candidate selection.

Twin of ``src/repro/kernels/fused_select/ops.py``.  They replace the
Pallas kernel ``src/repro/kernels/fused_select/kernel.py:_kernel``
(``fused_select_pallas``, every ``act_kind``) and the gathered wrappers
over it with ``csrc/fused_select.cu``:

* ``fused_select``         — dense (..., N) 0/1 activity;
* ``fused_select_packed``  — packed activity words (the dense engine's
  pmask row);
* ``fused_select_prefix``  — rows [0, p) active, ``p`` one int per lane;
* ``fused_select_gathered`` / ``fused_select_gathered_prefix`` — the same
  over the rows ``adj[idx]`` (the compact array's order), read through
  ``idx`` on the card instead of gathered first; the index returned is a
  POSITION into ``idx``.

``impl`` follows ``kernels.dispatch``: on a CUDA tensor the kernel path
launches the CUDA kernel, on a CPU tensor it runs ``ref.py``.  Each
wrapper counts its own launches (``<wrapper>.launches``).  Leading lane
dims are covered by ONE launch (one block per lane), with a shared
(N, W) or per-lane (..., N, W) adjacency.  Returns ``(idx, val)`` int32
per lane, ``(-1, INT32_MAX)`` where no row is active.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import (expect, lane_layout, plan_blocks,
                                          use_kernel)
from repro_torch.kernels.fused_select.ref import (
    fused_select_gathered_prefix_ref, fused_select_gathered_ref,
    fused_select_packed_ref, fused_select_prefix_ref, fused_select_ref)

_I32 = torch.int32
KINDS = {"dense": 0, "packed": 1, "prefix": 2}
# one block per lane loops over all of its rows: the widest block
THREADS = 512


def _launch(what, kind, adj, mask, act, idx=None):
    dev = adj.device
    lead = tuple(mask.shape[:-1])
    batch, adj_stride = lane_layout(adj, lead, what)
    n_adj, w = adj.shape[-2:]
    n = n_adj if idx is None else idx.shape[-1]
    act = torch.as_tensor(act, dtype=_I32, device=dev)
    act_shape = {"dense": lead + (n,), "packed": lead + ((n + 31) // 32,),
                 "prefix": lead}[kind]
    expect(adj, what, "adj", _I32, adj.shape, dev)
    expect(mask, what, "mask", _I32, lead + (w,), dev)
    expect(act, what, "activity", _I32, act_shape, dev)
    if idx is not None:
        expect(idx, what, "idx", _I32, lead + (n,), dev)
    out_idx = torch.empty(lead, dtype=_I32, device=dev)
    out_val = torch.empty(lead, dtype=_I32, device=dev)
    plan = plan_blocks(w, threads=THREADS)
    rc = _build.library().rt_fused_select(
        adj.data_ptr(), adj_stride, n_adj, mask.data_ptr(), _build.ptr(idx),
        act.data_ptr(), KINDS[kind], out_idx.data_ptr(), out_val.data_ptr(),
        batch, n, w, plan.threads, plan.group, _build.stream_ptr(dev))
    _build.check(rc, f"{what} launch")
    return out_idx, out_val


def fused_select(adj, mask, active, *, impl: str = "auto"):
    """First active row minimising popcount(adj & mask); ``active``
    (..., N) 0/1."""
    if not use_kernel(impl, adj.device):
        return fused_select_ref(adj, mask, active)
    out = _launch("fused_select", "dense", adj, mask, active)
    fused_select.launches += 1
    return out


def fused_select_packed(adj, mask, act_words, *, impl: str = "auto"):
    """``fused_select`` with packed activity words (..., ceil(N/32))
    (bits >= N ignored)."""
    if not use_kernel(impl, adj.device):
        return fused_select_packed_ref(adj, mask, act_words)
    out = _launch("fused_select_packed", "packed", adj, mask, act_words)
    fused_select_packed.launches += 1
    return out


def fused_select_prefix(adj, mask, p, *, impl: str = "auto"):
    """``fused_select`` with rows [0, p) active (``p`` (...) int32)."""
    if not use_kernel(impl, adj.device):
        return fused_select_prefix_ref(adj, mask, p)
    out = _launch("fused_select_prefix", "prefix", adj, mask, p)
    fused_select_prefix.launches += 1
    return out


def fused_select_gathered(adj, idx, mask, active, *, impl: str = "auto"):
    """``fused_select`` over the rows ``adj[idx]`` (idx (..., M) int32),
    dense activity (..., M) in position order."""
    if not use_kernel(impl, adj.device):
        return fused_select_gathered_ref(adj, idx, mask, active)
    out = _launch("fused_select_gathered", "dense", adj, mask, active, idx)
    fused_select_gathered.launches += 1
    return out


def fused_select_gathered_prefix(adj, idx, mask, p, *, impl: str = "auto"):
    """``fused_select_gathered`` with positions [0, p) active: the
    compact engine's level pointer as the activity."""
    if not use_kernel(impl, adj.device):
        return fused_select_gathered_prefix_ref(adj, idx, mask, p)
    out = _launch("fused_select_gathered_prefix", "prefix", adj, mask, p,
                  idx)
    fused_select_gathered_prefix.launches += 1
    return out


for _f in (fused_select, fused_select_packed, fused_select_prefix,
           fused_select_gathered, fused_select_gathered_prefix):
    _f.launches = 0
