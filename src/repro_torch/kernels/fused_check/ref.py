"""Plain torch-op version of the fused check/partition kernel (packed kind).

Twin of ``src/repro/kernels/fused_check/ref.py`` (``fused_check_ref`` and
``fused_check_packed_ref``).  Computes the same outputs as the kernel
from one materialised counts vector.  Every argument may carry leading
lane dims; ``adj`` is then either one shared (N, W) adjacency or a
per-lane (..., N, W) one.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitset


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
