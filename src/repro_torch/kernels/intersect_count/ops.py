"""Dispatch wrapper for the intersect-count primitive (not yet ported).

Twin of ``src/repro/kernels/intersect_count/ops.py``.  The Pallas kernel
``src/repro/kernels/intersect_count/kernel.py:_kernel`` is ROADMAP
Queue 2 K5, still to port: ``impl="pallas"`` on a CUDA tensor raises; on
a CPU tensor it runs the plain version.
"""
from __future__ import annotations

from repro_torch.kernels.dispatch import resolve_impl
from repro_torch.kernels.intersect_count.ref import intersect_count_ref


def intersect_count(adj, mask, *, impl: str = "auto"):
    """counts[i] = popcount(adj[i] & mask)."""
    if resolve_impl(impl, adj.device) == "pallas" \
            and adj.device.type == "cuda":
        raise NotImplementedError(
            "intersect_count has no CUDA kernel yet (ROADMAP Queue 2 K5): "
            "the unfused path with impl='pallas' needs it; use impl='jnp'")
    return intersect_count_ref(adj, mask)
