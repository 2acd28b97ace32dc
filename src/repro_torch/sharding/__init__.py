"""Mesh axis names (twin of ``src/repro/sharding``, its MBE part)."""
from repro_torch.sharding.axes import MBE_LANE_AXIS, mbe_serve_mesh  # noqa: F401
