"""Multi-lane resident pool kernel: ops wrapper + plain version."""
from repro_torch.kernels.resident_pool.ops import (  # noqa: F401
    B_DONE, B_LEFT, BOARD_SLOTS, resident_pool_segment,
    resident_pool_supported)
from repro_torch.kernels.resident_pool.ref import (  # noqa: F401
    resident_pool_segment_ref)
