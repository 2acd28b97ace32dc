"""Resident multi-step segment kernel (one lane): ops wrapper + plain version."""
from repro_torch.kernels.resident_step.ops import (  # noqa: F401
    SCAL_SLOTS, resident_segment, resident_state_bytes, resident_supported)
from repro_torch.kernels.resident_step.ref import (  # noqa: F401
    resident_segment_ref)
