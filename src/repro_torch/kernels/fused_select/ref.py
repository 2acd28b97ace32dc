"""Plain torch-op version of fused candidate selection.

Twin of ``src/repro/kernels/fused_select/ref.py``: counts + first masked
argmin, ``(-1, INT32_MAX)`` when nothing is active, for every activity
kind (dense, packed, prefix) and the gathered forms over the rows
``adj[idx]`` (the index returned is then a POSITION into ``idx``).
Leading lane dims are allowed on every argument; ``adj`` is then shared
(N, W) or per lane (..., N, W).
"""
from __future__ import annotations

import torch

from repro_torch.core import bitset
from repro_torch.kernels.dispatch import take_rows

_INF = 0x7FFFFFFF


def fused_select_ref(adj, mask, active):
    """Dense activity: ``active`` (..., N) 0/1."""
    counts = bitset.intersect_count(adj, mask)
    masked = torch.where(active > 0, counts, torch.full_like(counts, _INF))
    val = masked.min(dim=-1).values
    idx = torch.where(val == _INF, torch.full_like(val, -1),
                      torch.argmin(masked, dim=-1).to(torch.int32))
    return idx, val


def fused_select_packed_ref(adj, mask, act_words):
    """Packed-activity oracle: the dense oracle over the expanded set."""
    n = adj.shape[-2]
    return fused_select_ref(adj, mask,
                            bitset.to_bool(act_words, n).to(torch.int32))


def _prefix(n: int, p, device) -> torch.Tensor:
    p = torch.as_tensor(p, dtype=torch.int32, device=device)
    return (torch.arange(n, dtype=torch.int32, device=device)
            < p[..., None]).to(torch.int32)


def fused_select_prefix_ref(adj, mask, p):
    """Prefix-activity oracle: rows [0, p) active (``p`` per lane)."""
    return fused_select_ref(adj, mask, _prefix(adj.shape[-2], p, adj.device))


def fused_select_gathered_ref(adj, idx, mask, active):
    """``fused_select_ref`` over the gathered rows ``adj[idx]``."""
    return fused_select_ref(take_rows(adj, idx), mask, active)


def fused_select_gathered_prefix_ref(adj, idx, mask, p):
    """``fused_select_prefix_ref`` over the gathered rows ``adj[idx]``."""
    return fused_select_prefix_ref(take_rows(adj, idx), mask, p)
