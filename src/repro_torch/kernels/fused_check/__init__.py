"""Fused check/partition kernel (packed kind): ops wrapper + plain version."""
from repro_torch.kernels.fused_check.ops import fused_check_packed  # noqa: F401
from repro_torch.kernels.fused_check.ref import (  # noqa: F401
    fused_check_packed_ref, fused_check_ref)
