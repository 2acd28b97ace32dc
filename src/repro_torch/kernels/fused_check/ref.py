"""Plain torch-op version of the fused check/partition kernel.

Twin of ``src/repro/kernels/fused_check/ref.py`` (``fused_check_ref``,
``fused_check_packed_ref``, ``fused_check_prefix2_ref``) plus the
gathered forms over the rows ``adj[idx]``.  Computes the same outputs as
the kernel from one materialised counts vector.  Every argument may carry
leading lane dims; ``adj`` is then either one shared (N, W) adjacency or
a per-lane (..., N, W) one.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitset
from repro_torch.kernels.dispatch import take_rows


def fused_check_ref(adj, mask, n_mask, q_act, p_act, *,
                    with_counts: bool = False):
    """adj (N, W), mask (W,), n_mask () i32, q_act/p_act (N,) 0/1.
    -> (viol bool, full/part/nz (N,) bool, counts (N,) i32 | None)."""
    c = bitset.intersect_count(adj, mask)
    nlp = torch.as_tensor(n_mask, dtype=torch.int32,
                          device=c.device)[..., None]
    eq = c == nlp
    viol = torch.any((q_act > 0) & eq, dim=-1)
    full = (p_act > 0) & eq
    part = (p_act > 0) & (c > 0) & (c < nlp)
    nz = c > 0
    return viol, full, part, nz, (c if with_counts else None)


def fused_check_packed_ref(adj, mask, n_mask, q_words, p_words, *,
                           with_counts: bool = False):
    """Packed oracle: the dense oracle over expanded activity, flags
    packed back to words."""
    n = adj.shape[-2]
    qb = bitset.to_bool(q_words, n)
    pb = bitset.to_bool(p_words, n)
    viol, full, part, nz, counts = fused_check_ref(
        adj, mask, n_mask, qb.to(torch.int32), pb.to(torch.int32),
        with_counts=with_counts)
    return (viol, bitset.from_bool(full), bitset.from_bool(part),
            bitset.from_bool(nz), counts)


def fused_check_prefix2_ref(adj, mask, n_mask, q_hi, p_hi, *, split: int,
                            with_counts: bool = False):
    """Prefix2 oracle: rows [0, q_hi) of [0, split) q-active, rows
    [split, split + p_hi) p-active (``q_hi``/``p_hi`` one int per lane):
    the compact engine's concatenated [Q ++ P] layout."""
    dev = adj.device
    pos = torch.arange(adj.shape[-2], dtype=torch.int32, device=dev)
    q_hi = torch.as_tensor(q_hi, dtype=torch.int32, device=dev)[..., None]
    p_hi = torch.as_tensor(p_hi, dtype=torch.int32, device=dev)[..., None]
    q_act = (pos < split) & (pos < q_hi)
    p_act = (pos >= split) & (pos - split < p_hi)
    return fused_check_ref(adj, mask, n_mask, q_act.to(torch.int32),
                           p_act.to(torch.int32), with_counts=with_counts)


def fused_check_gathered_ref(adj, idx, mask, n_mask, q_act, p_act, *,
                             with_counts: bool = False):
    """``fused_check_ref`` over the gathered rows ``adj[idx]``."""
    return fused_check_ref(take_rows(adj, idx), mask, n_mask, q_act, p_act,
                           with_counts=with_counts)


def fused_check_gathered_prefix2_ref(adj, idx, mask, n_mask, q_hi, p_hi, *,
                                     with_counts: bool = False):
    """``fused_check_prefix2_ref`` over the gathered rows ``adj[idx]``
    with split = len(idx) // 2."""
    return fused_check_prefix2_ref(take_rows(adj, idx), mask, n_mask, q_hi,
                                   p_hi, split=idx.shape[-1] // 2,
                                   with_counts=with_counts)
