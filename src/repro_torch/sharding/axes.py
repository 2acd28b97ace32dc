"""Mesh axis names of the port.

Twin of ``src/repro/sharding/axes.py``, its MBE part: the serving mesh
axis and ``mbe_serve_mesh``.  The logical-axis rules of the LM layouts
(``Rules``, ``train_rules``, ``serve_rules``) wait for ROADMAP Queue 1
item 12c.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.dispatch import check_device
from repro_torch.launch.mesh import Mesh, local_devices

# The serving executors (repro_torch.serving.executor) place graph lanes
# on a 1-D mesh of their own: ``ShardedExecutor`` shards a bucket's lane
# pool over it and the big-graph lane spreads ONE graph's root tasks over
# the same axis.
MBE_LANE_AXIS = "mbe_lanes"


def mbe_serve_mesh(n_devices: Optional[int] = None,
                   axis: str = MBE_LANE_AXIS, device="cuda") -> Mesh:
    """1-D serving mesh over the first ``n_devices`` distinct visible
    cards (every one when None; fewer visible raises, as the reference
    does).  On the CPU (``device="cpu"``) the mesh holds ``n_devices``
    shards (default 1) of the one CPU device: the port's counterpart of
    the reference tests' forced host devices."""
    dev = check_device(device)
    if dev.type == "cpu":
        return Mesh([torch.device("cpu")] * (n_devices or 1), (axis,))
    devs = local_devices(dev)
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"mbe_serve_mesh: asked for {n_devices} devices but only "
                f"{len(devs)} are visible")
        devs = devs[:n_devices]
    return Mesh(devs, (axis,))
