"""Checkpoints in the reference's on-disk format (twin of
``src/repro/checkpoint``)."""
from repro_torch.checkpoint.store import (  # noqa: F401
    CheckpointManager, latest_step, restore, save)
