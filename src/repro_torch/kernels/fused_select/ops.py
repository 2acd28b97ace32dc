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
dims are covered by ONE launch (grid (row tiles, lanes),
``dispatch.plan_rows``), with a shared (N, W) or per-lane (..., N, W)
adjacency; a call is that one kernel on the current stream, with no host
sync.  Returns ``(idx, val)`` int32 per lane, ``(-1, INT32_MAX)`` where no
row is active.
"""
from __future__ import annotations

import struct
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import (Outputs, aligned16, as_i32,
                                          current_stream_ptr, expect,
                                          expect_i32, lane_layout, plan_rows,
                                          row_scratch, use_kernel)
from repro_torch.kernels.fused_select.ref import (
    fused_select_gathered_prefix_ref, fused_select_gathered_ref,
    fused_select_packed_ref, fused_select_prefix_ref, fused_select_ref)

KINDS = {"dense": 0, "packed": 1, "prefix": 2}
# csrc/fused_select.cu:SelectArgs: 8 pointers, then 13 int64 fields
_ARGS = struct.Struct("<8Q13q")
_I32 = torch.int32


class _Sig(NamedTuple):
    """What one call signature (kind and operand shapes) fixes, checked
    and computed once: the outputs' layout, the launch's integer fields
    and the launch plans (one-word and 16-byte loads)."""
    out: Outputs
    ints: tuple         # adj_stride, n_adj, n, w, kind, lanes
    plans: tuple        # (one-word plan, 16-byte plan)


_sigs: dict = {}


def _signature(what, kind, adj, mask, act, idx) -> _Sig:
    dev = adj.device
    lead = tuple(mask.shape[:-1])
    batch, adj_stride = lane_layout(adj, lead, what)
    n_adj, w = adj.shape[-2:]
    n = n_adj if idx is None else idx.shape[-1]
    act_shape = {"dense": lead + (n,), "packed": lead + ((n + 31) // 32,),
                 "prefix": lead}[kind]
    expect(mask, what, "mask", mask.dtype, lead + (w,), mask.device)
    expect(act, what, "activity", act.dtype, act_shape, act.device)
    if idx is not None:
        expect(idx, what, "idx", idx.dtype, lead + (n,), dev)
    return _Sig(Outputs([(_I32, lead)] * 2),
                (adj_stride, n_adj, n, w, KINDS[kind], batch),
                (plan_rows(n, w, batch, False), plan_rows(n, w, batch, True)))


def _launch(what, kind, adj, mask, act, idx=None, plan=None):
    """One launch of ``csrc/fused_select.cu`` over every lane: the
    operands checked (shapes once per call signature, dtype, device and
    layout every call), (idx, val) in one allocation, one packed argument
    block, one C call and nothing else on the device (the lanes' CTAs
    fold their minima inside the kernel).  ``plan`` overrides
    ``plan_rows``'s."""
    dev = adj.device
    act = as_i32(act, dev)
    if not (adj.dtype is _I32 and mask.dtype is _I32 and act.dtype is _I32
            and mask.device == dev and act.device == dev
            and adj.is_contiguous() and mask.is_contiguous()
            and act.is_contiguous()):
        for name, t in (("adj", adj), ("mask", mask), ("activity", act)):
            expect(t, what, name, _I32, t.shape, dev)
    if idx is not None:
        expect_i32(idx, what, "idx", idx.shape, dev)
    key = (what, kind, adj.shape, mask.shape, act.shape,
           None if idx is None else idx.shape)
    sig = _sigs.get(key)
    if sig is None:
        sig = _sigs[key] = _signature(what, kind, adj, mask, act, idx)
    out_idx, out_val = sig.out.alloc(dev)
    if plan is None:
        plan = sig.plans[aligned16(adj, mask, sig.ints[3])]
    stream = current_stream_ptr(dev.index)
    scratch = row_scratch("fused_select", dev, stream, sig.ints[5], 4)
    args = _ARGS.pack(
        adj.data_ptr(), mask.data_ptr(),
        0 if idx is None else idx.data_ptr(), act.data_ptr(),
        out_idx.data_ptr(), out_val.data_ptr(), scratch.data_ptr(), stream,
        *sig.ints, *plan[:7])
    rc = _build.library().rt_fused_select(args)
    if rc:
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
