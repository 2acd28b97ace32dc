"""Plain torch-op version of fused candidate selection.

Twin of ``src/repro/kernels/fused_select/ref.py``: counts + first masked
argmin, ``(-1, INT32_MAX)`` when nothing is active.  Leading lane dims
are allowed on every argument.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitset

_INF = 0x7FFFFFFF


def fused_select_ref(adj, mask, active):
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
