"""Device meshes.

Twin of ``src/repro/launch/mesh.py``.  The port has no
``jax.sharding.Mesh``: ``Mesh`` is an ordered tuple of ``torch.device``s
laid out row-major over named axes.  It hashes and compares by value, so
the serving layer's cache keys can carry it, and nothing is placed on a
device when one is built.  ``make_production_mesh`` (the 16 x 16 pod
layout) waits for the LM mesh of ROADMAP Queue 1 item 12c.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.dispatch import check_device


class Mesh:
    """``devices`` (flattened row-major) over ``axis_names`` with
    ``shape`` (one size per axis; a 1-D mesh by default).  A device may
    appear more than once: a CPU mesh of N shards is N entries of the one
    CPU device, and an explicit list may repeat one card (a rehearsal of
    a several-card mesh on one card)."""

    __slots__ = ("devices", "axis_names", "_sizes")

    def __init__(self, devices, axis_names, shape=None):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        sizes = (len(self.devices),) if shape is None else tuple(shape)
        if len(sizes) != len(self.axis_names) or \
                math.prod(sizes) != len(self.devices) or not self.devices:
            raise ValueError(f"mesh shape {sizes} over axes "
                             f"{self.axis_names} does not hold "
                             f"{len(self.devices)} devices")
        self._sizes = sizes

    @property
    def shape(self) -> dict[str, int]:
        """Size per axis name (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self._sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    def _key(self):
        return self.devices, self.axis_names, self._sizes

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"{self.shape})")


def local_devices(device="cuda") -> list[torch.device]:
    """Every visible card (``device="cuda"``, which needs one), or the one
    CPU device."""
    dev = check_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_local_mesh(model: int = 1, device="cuda") -> Mesh:
    """Whatever this host has, as (data, model)."""
    devs = local_devices(device)
    n = len(devs)
    assert n % model == 0, (n, model)
    return Mesh(devs, ("data", "model"), (n // model, model))


def mesh_axis_sizes(mesh: Mesh) -> dict[str, int]:
    return dict(mesh.shape)
