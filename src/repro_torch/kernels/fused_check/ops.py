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
by ONE launch (grid (row tiles, lanes), ``dispatch.plan_rows``), with a
shared (N, W) or per-lane (..., N, W) adjacency; a call is that one
kernel on the current stream, with no host sync.  Every wrapper returns
``(viol bool, full, part, nz, counts | None)``.
"""
from __future__ import annotations

import struct
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import (Outputs, aligned16, as_i32,
                                          current_stream_ptr, expect,
                                          expect_i32, lane_layout, on_device,
                                          plan_rows, row_scratch, use_kernel)
from repro_torch.kernels.fused_check.ref import (
    fused_check_gathered_prefix2_ref, fused_check_gathered_ref,
    fused_check_packed_ref, fused_check_prefix2_ref, fused_check_ref)

KINDS = {"packed": 0, "dense": 1, "prefix2": 2}
# csrc/fused_check.cu:CheckArgs: 13 pointers, then 14 int64 fields
_ARGS = struct.Struct("<13Q14q")
_I32 = torch.int32


class _Sig(NamedTuple):
    """What one call signature (kind, operand shapes, split, counts) fixes,
    checked and computed once: the outputs' layout, the launch's integer
    fields and the launch plans (one-word and 16-byte loads)."""
    out: Outputs
    ints: tuple         # adj_stride, n_adj, n, w, kind, split, lanes
    plans: tuple        # (one-word plan, 16-byte plan)


_sigs: dict = {}


def _signature(what, kind, adj, mask, n_mask, q, p, idx, split,
               with_counts) -> _Sig:
    dev = adj.device
    lead = tuple(mask.shape[:-1])
    batch, adj_stride = lane_layout(adj, lead, what)
    n_adj, w = adj.shape[-2:]
    n = n_adj if idx is None else idx.shape[-1]
    nw = (n + 31) // 32
    act_shape = {"packed": lead + (nw,), "dense": lead + (n,),
                 "prefix2": lead}[kind]
    expect(mask, what, "mask", mask.dtype, lead + (w,), mask.device)
    expect(n_mask, what, "n_mask", n_mask.dtype, lead, n_mask.device)
    expect(q, what, "q activity", q.dtype, act_shape, q.device)
    expect(p, what, "p activity", p.dtype, act_shape, p.device)
    if idx is not None:
        expect(idx, what, "idx", idx.dtype, lead + (n,), dev)
    flags = ((_I32, lead + (nw,)) if kind == "packed"
             else (torch.bool, lead + (n,)))
    specs = [(torch.bool, lead), flags, flags, flags]
    if with_counts:
        specs.append((_I32, lead + (n,)))
    return _Sig(Outputs(specs),
                (adj_stride, n_adj, n, w, KINDS[kind], split, batch),
                (plan_rows(n, w, batch, False), plan_rows(n, w, batch, True)))


def _launch(what, kind, adj, mask, n_mask, q, p, *, with_counts, idx=None,
            split=0, plan=None):
    """One launch of ``csrc/fused_check.cu`` over every lane: the operands
    checked (shapes once per call signature, dtype, device and layout
    every call), the outputs in one allocation, one packed argument
    block, one C call and nothing else on the device (the violation flag
    is folded inside the kernel).  ``plan`` overrides ``plan_rows``'s."""
    dev = adj.device
    n_mask, q, p = as_i32(n_mask, dev), as_i32(q, dev), as_i32(p, dev)
    if not (adj.dtype is _I32 and mask.dtype is _I32
            and n_mask.dtype is _I32 and q.dtype is _I32 and p.dtype is _I32
            and mask.device == dev and n_mask.device == dev
            and q.device == dev and p.device == dev
            and adj.is_contiguous() and mask.is_contiguous()
            and n_mask.is_contiguous() and q.is_contiguous()
            and p.is_contiguous()):
        for name, t in (("adj", adj), ("mask", mask), ("n_mask", n_mask),
                        ("q activity", q), ("p activity", p)):
            expect(t, what, name, _I32, t.shape, dev)
    if idx is not None:
        expect_i32(idx, what, "idx", idx.shape, dev)
    key = (what, kind, adj.shape, mask.shape, n_mask.shape, q.shape,
           p.shape, None if idx is None else idx.shape, split, with_counts)
    sig = _sigs.get(key)
    if sig is None:
        sig = _sigs[key] = _signature(what, kind, adj, mask, n_mask, q, p,
                                      idx, split, with_counts)
    outs = sig.out.alloc(dev)
    counts = outs[4] if with_counts else None
    if plan is None:
        plan = sig.plans[aligned16(adj, mask, sig.ints[3])]
    stream = current_stream_ptr(dev.index)
    scratch = row_scratch("fused_check", dev, stream, sig.ints[6], 2)
    args = _ARGS.pack(
        adj.data_ptr(), mask.data_ptr(), n_mask.data_ptr(),
        0 if idx is None else idx.data_ptr(), q.data_ptr(), p.data_ptr(),
        outs[0].data_ptr(), outs[1].data_ptr(), outs[2].data_ptr(),
        outs[3].data_ptr(), 0 if counts is None else counts.data_ptr(),
        scratch.data_ptr(), stream, *sig.ints, *plan[:7])
    with on_device(dev):
        rc = _build.library().rt_fused_check(args)
    if rc:
        _build.check(rc, f"{what} launch")
    return outs[0], outs[1], outs[2], outs[3], counts


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
