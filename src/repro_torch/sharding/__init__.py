"""Logical-axis sharding of the port (twin of ``src/repro/sharding``):
the rule tables and sharded leaves (``axes``), their per-architecture
adaptation (``auto``), and the collectives over a mesh axis
(``collectives``)."""
from repro_torch.sharding.axes import MBE_LANE_AXIS, mbe_serve_mesh  # noqa: F401
