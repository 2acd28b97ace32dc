"""Plain torch-op version of the intersect-count primitive.

Twin of ``src/repro/kernels/intersect_count/ref.py``:
``counts[i] = popcount(adj[i] & mask)``.
"""
from __future__ import annotations

from repro_torch.core import bitset


def intersect_count_ref(adj, mask):
    """adj (..., N, W) int32 words, mask (..., W) -> (..., N) int32."""
    return bitset.intersect_count(adj, mask)
