"""Fused candidate selection (K4, and its gathered kinds of K6): ops
wrappers + plain versions."""
from repro_torch.kernels.fused_select.ops import (  # noqa: F401
    fused_select, fused_select_gathered, fused_select_gathered_prefix,
    fused_select_packed, fused_select_prefix)
from repro_torch.kernels.fused_select.ref import (  # noqa: F401
    fused_select_gathered_prefix_ref, fused_select_gathered_ref,
    fused_select_packed_ref, fused_select_prefix_ref, fused_select_ref)
