"""Dispatch wrappers for the fused check/partition kernel.

Twin of ``src/repro/kernels/fused_check/ops.py``.  They replace the
Pallas kernel ``src/repro/kernels/fused_check/kernel.py:_kernel``
(``fused_check_pallas``, every ``act_kind``) and the gathered wrappers
over it with ``csrc/fused_check.cu``:

* ``fused_check``        — dense (..., N) activity in, bool flags out;
* ``fused_check_packed`` — packed activity words in AND out (the dense
  engine's qmask/pmask rows);
* ``fused_check_prefix2`` — rows [0, q_hi) of [0, split) q-active, rows
  [split, split + p_hi) p-active, bool flags out;
* ``fused_check_gathered`` / ``fused_check_gathered_prefix2`` — the same
  over the rows ``adj[idx]`` (the compact engine's [Q ++ P'] order), read
  through ``idx`` on the card instead of gathered first; prefix2 splits
  at ``len(idx) // 2``.

``impl`` follows ``kernels.dispatch``: on a CUDA tensor the kernel path
launches the CUDA kernel, on a CPU tensor it runs ``ref.py``.  Each
wrapper counts its own launches (``<wrapper>.launches``).  Leading lane
dims (``mask`` (..., W), ``n_mask`` (...), activity per lane) are covered
by ONE launch (grid.y = lanes), with a shared (N, W) or per-lane
(..., N, W) adjacency.  Every wrapper returns
``(viol bool, full, part, nz, counts | None)``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import (expect, lane_layout, plan_blocks,
                                          use_kernel)
from repro_torch.kernels.fused_check.ref import (
    fused_check_gathered_prefix2_ref, fused_check_gathered_ref,
    fused_check_packed_ref, fused_check_prefix2_ref, fused_check_ref)

_I32 = torch.int32
KINDS = {"packed": 0, "dense": 1, "prefix2": 2}


def _launch(what, kind, adj, mask, n_mask, q, p, *, with_counts, idx=None,
            split=0):
    dev = adj.device
    lead = tuple(mask.shape[:-1])
    batch, adj_stride = lane_layout(adj, lead, what)
    n_adj, w = adj.shape[-2:]
    n = n_adj if idx is None else idx.shape[-1]
    nw = (n + 31) // 32
    n_mask = torch.as_tensor(n_mask, dtype=_I32, device=dev)
    q = torch.as_tensor(q, dtype=_I32, device=dev)
    p = torch.as_tensor(p, dtype=_I32, device=dev)
    act_shape = {"packed": lead + (nw,), "dense": lead + (n,),
                 "prefix2": lead}[kind]
    expect(adj, what, "adj", _I32, adj.shape, dev)
    expect(mask, what, "mask", _I32, lead + (w,), dev)
    expect(n_mask, what, "n_mask", _I32, lead, dev)
    expect(q, what, "q activity", _I32, act_shape, dev)
    expect(p, what, "p activity", _I32, act_shape, dev)
    if idx is not None:
        expect(idx, what, "idx", _I32, lead + (n,), dev)
    viol = torch.zeros(lead, dtype=_I32, device=dev)
    if kind == "packed":
        full = torch.empty(lead + (nw,), dtype=_I32, device=dev)
    else:
        full = torch.empty(lead + (n,), dtype=torch.bool, device=dev)
    part = torch.empty_like(full)
    nz = torch.empty_like(full)
    counts = (torch.empty(lead + (n,), dtype=_I32, device=dev)
              if with_counts else None)
    plan = plan_blocks(w)
    rc = _build.library().rt_fused_check(
        adj.data_ptr(), adj_stride, n_adj, mask.data_ptr(),
        n_mask.data_ptr(), _build.ptr(idx), q.data_ptr(), p.data_ptr(),
        KINDS[kind], split, viol.data_ptr(), full.data_ptr(),
        part.data_ptr(), nz.data_ptr(), _build.ptr(counts), batch, n, w,
        plan.threads, plan.group, _build.stream_ptr(dev))
    _build.check(rc, f"{what} launch")
    return viol != 0, full, part, nz, counts


def fused_check(adj, mask, n_mask, q_act, p_act, *, impl: str = "auto",
                with_counts: bool = False):
    """Q-violation flag + full/partial/nonzero bool flags (+ counts) from
    ONE pass over the adjacency against the L' ``mask``; ``n_mask`` =
    |L'|, ``q_act``/``p_act`` (..., N) 0/1."""
    if not use_kernel(impl, adj.device):
        return fused_check_ref(adj, mask, n_mask, q_act, p_act,
                               with_counts=with_counts)
    out = _launch("fused_check", "dense", adj, mask, n_mask, q_act, p_act,
                  with_counts=with_counts)
    fused_check.launches += 1
    return out


def fused_check_packed(adj, mask, n_mask, q_words, p_words, *,
                       impl: str = "auto", with_counts: bool = False):
    """``fused_check`` with packed activity: ``q_words``/``p_words``
    (..., ceil(N/32)) bitsets (bits >= N clear) in, the full/part/nz flags
    as words of the same shape out (int32 patterns); counts (..., N)."""
    if not use_kernel(impl, adj.device):
        return fused_check_packed_ref(adj, mask, n_mask, q_words, p_words,
                                      with_counts=with_counts)
    out = _launch("fused_check_packed", "packed", adj, mask, n_mask,
                  q_words, p_words, with_counts=with_counts)
    fused_check_packed.launches += 1
    return out


def fused_check_prefix2(adj, mask, n_mask, q_hi, p_hi, *, split: int,
                        impl: str = "auto", with_counts: bool = False):
    """``fused_check`` over a [first half ++ second half] row layout with
    prefix activity: rows [0, q_hi) of [0, split) q-active, rows
    [split, split + p_hi) p-active (``q_hi``/``p_hi`` one int per lane)."""
    if not use_kernel(impl, adj.device):
        return fused_check_prefix2_ref(adj, mask, n_mask, q_hi, p_hi,
                                       split=split, with_counts=with_counts)
    out = _launch("fused_check_prefix2", "prefix2", adj, mask, n_mask, q_hi,
                  p_hi, with_counts=with_counts, split=split)
    fused_check_prefix2.launches += 1
    return out


def fused_check_gathered(adj, idx, mask, n_mask, q_act, p_act, *,
                         impl: str = "auto", with_counts: bool = False):
    """``fused_check`` over the rows ``adj[idx]`` (idx (..., M) int32),
    activity and flags in position order."""
    if not use_kernel(impl, adj.device):
        return fused_check_gathered_ref(adj, idx, mask, n_mask, q_act, p_act,
                                        with_counts=with_counts)
    out = _launch("fused_check_gathered", "dense", adj, mask, n_mask, q_act,
                  p_act, with_counts=with_counts, idx=idx)
    fused_check_gathered.launches += 1
    return out


def fused_check_gathered_prefix2(adj, idx, mask, n_mask, q_hi, p_hi, *,
                                 impl: str = "auto",
                                 with_counts: bool = False):
    """``fused_check_gathered`` over the compact engine's [Q ++ P'] index
    vector with the two level pointers as the activity bounds
    (split = len(idx) // 2)."""
    if not use_kernel(impl, adj.device):
        return fused_check_gathered_prefix2_ref(
            adj, idx, mask, n_mask, q_hi, p_hi, with_counts=with_counts)
    out = _launch("fused_check_gathered_prefix2", "prefix2", adj, mask,
                  n_mask, q_hi, p_hi, with_counts=with_counts, idx=idx,
                  split=idx.shape[-1] // 2)
    fused_check_gathered_prefix2.launches += 1
    return out


for _f in (fused_check, fused_check_packed, fused_check_prefix2,
           fused_check_gathered, fused_check_gathered_prefix2):
    _f.launches = 0
