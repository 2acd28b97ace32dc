"""Intersect-count kernel (K5): ops wrapper + plain versions."""
from repro_torch.kernels.intersect_count.ops import (  # noqa: F401
    intersect_count)
from repro_torch.kernels.intersect_count.ref import (  # noqa: F401
    intersect_count_gathered_ref, intersect_count_ref)
