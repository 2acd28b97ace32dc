"""Plain torch-op version of the intersect-count primitive.

Twin of ``src/repro/kernels/intersect_count/ref.py``:
``counts[i] = popcount(adj[i] & mask)``, and the gathered form over the
rows ``adj[idx]`` that the compact engine reads.  Leading lane dims are
allowed; ``adj`` is then shared (N, W) or per lane (..., N, W).
"""
from __future__ import annotations

from repro_torch.core import bitset
from repro_torch.kernels.dispatch import take_rows


def intersect_count_ref(adj, mask):
    """adj (..., N, W) int32 words, mask (..., W) -> (..., N) int32."""
    return bitset.intersect_count(adj, mask)


def intersect_count_gathered_ref(adj, idx, mask):
    """Counts for the gathered rows ``adj[idx]`` (JAX's gather rule):
    idx (..., M) int32 -> (..., M) int32."""
    return intersect_count_ref(take_rows(adj, idx), mask)
