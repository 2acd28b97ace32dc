"""Fused check/partition kernel (K1, and its gathered kinds of K6): ops
wrappers + plain versions."""
from repro_torch.kernels.fused_check.ops import (  # noqa: F401
    fused_check, fused_check_gathered, fused_check_gathered_prefix2,
    fused_check_packed, fused_check_prefix2)
from repro_torch.kernels.fused_check.ref import (  # noqa: F401
    fused_check_gathered_prefix2_ref, fused_check_gathered_ref,
    fused_check_packed_ref, fused_check_prefix2_ref, fused_check_ref)
