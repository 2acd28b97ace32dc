"""Dispatch wrapper for fused candidate selection (not yet ported).

Twin of ``src/repro/kernels/fused_select/ops.py``.  The Pallas kernel
``src/repro/kernels/fused_select/kernel.py:_kernel`` is ROADMAP Queue 2
K4, still to port: on a CPU tensor the kernel path runs the plain
version (as interpret mode did), on a CUDA tensor it raises.
"""
from __future__ import annotations

from repro_torch.kernels.dispatch import resolve_impl
from repro_torch.kernels.fused_select.ref import fused_select_packed_ref


def fused_select_packed(adj, mask, act_words, *, impl: str = "auto"):
    """First active row minimising popcount(adj & mask): (idx, val)."""
    if resolve_impl(impl, adj.device) == "pallas" \
            and adj.device.type == "cuda":
        raise NotImplementedError(
            "fused_select has no CUDA kernel yet (ROADMAP Queue 2 K4): "
            "order_mode='deg_nocache' with residency off needs it; use "
            "kernel_impl='jnp' or the resident path")
    return fused_select_packed_ref(adj, mask, act_words)
