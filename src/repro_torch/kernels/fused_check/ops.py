"""Dispatch wrapper for the fused check/partition kernel, packed kind.

Twin of ``src/repro/kernels/fused_check/ops.py`` (``fused_check_packed``
only; the dense, prefix2 and gathered kinds come with the compact engine,
ROADMAP Queue 2 K6).  It replaces the Pallas kernel
``src/repro/kernels/fused_check/kernel.py:_kernel`` (``fused_check_pallas``,
``act_kind="packed"``) with ``csrc/fused_check.cu``.

``impl`` follows ``kernels.dispatch``: on a CUDA tensor the kernel path
launches the CUDA kernel, on a CPU tensor it runs ``ref.py``.  Every
launch adds one to ``fused_check_packed.launches``.

Lane batching: the per-step engine path advances a whole pool per step,
so the wrapper also takes leading lane dims (``mask`` (B, W), ``n_mask``
(B,), ``q_words``/``p_words`` (B, NW)) with a shared (N, W) or per-lane
(B, N, W) adjacency, and covers every lane in ONE launch (grid.y = B).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import plan_blocks, use_kernel
from repro_torch.kernels.fused_check.ref import fused_check_packed_ref


def _expect(t, name, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"fused_check_packed: {name} must be a contiguous {dtype} "
            f"tensor of shape {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}")


def fused_check_packed(adj, mask, n_mask, q_words, p_words, *,
                       impl: str = "auto", with_counts: bool = False):
    """Q-violation flag + packed full/partial/nonzero words (+ counts)
    from ONE pass over the (N, W) adjacency against the L' ``mask``.

    ``n_mask`` = popcount(mask) = |L'|; ``q_words``/``p_words`` are
    (ceil(N/32),) activity bitsets (bits >= N clear).  Returns
    ``(viol bool, full, part, nz, counts | None)`` with the flag words as
    (ceil(N/32),) int32 patterns and counts as (N,) int32."""
    if not use_kernel(impl, adj.device):
        return fused_check_packed_ref(adj, mask, n_mask, q_words, p_words,
                                      with_counts=with_counts)
    dev = adj.device
    lead = tuple(mask.shape[:-1])
    batch = 1
    for d in lead:
        batch *= d
    n, w = adj.shape[-2:]
    nw = (n + 31) // 32
    if adj.dim() == 2:
        adj_stride = 0
    elif tuple(adj.shape[:-2]) == lead:
        adj_stride = n * w
    else:
        raise ValueError(f"fused_check_packed: adj {tuple(adj.shape)} does "
                         f"not match lane dims {lead}")
    n_mask = torch.as_tensor(n_mask, dtype=torch.int32, device=dev)
    _expect(adj, "adj", torch.int32, adj.shape, dev)
    _expect(mask, "mask", torch.int32, lead + (w,), dev)
    _expect(n_mask, "n_mask", torch.int32, lead, dev)
    _expect(q_words, "q_words", torch.int32, lead + (nw,), dev)
    _expect(p_words, "p_words", torch.int32, lead + (nw,), dev)
    viol = torch.zeros(lead, dtype=torch.int32, device=dev)
    full = torch.empty(lead + (nw,), dtype=torch.int32, device=dev)
    part = torch.empty_like(full)
    nz = torch.empty_like(full)
    counts = (torch.empty(lead + (n,), dtype=torch.int32, device=dev)
              if with_counts else None)
    plan = plan_blocks(w)
    lib = _build.library()
    rc = lib.rt_fused_check(
        adj.data_ptr(), adj_stride, mask.data_ptr(), n_mask.data_ptr(),
        q_words.data_ptr(), p_words.data_ptr(), viol.data_ptr(),
        full.data_ptr(), part.data_ptr(), nz.data_ptr(),
        counts.data_ptr() if counts is not None else None,
        batch, n, w, plan.threads, plan.group, _build.stream_ptr(dev))
    _build.check(rc, "fused_check launch")
    fused_check_packed.launches += 1
    return viol != 0, full, part, nz, counts


fused_check_packed.launches = 0
