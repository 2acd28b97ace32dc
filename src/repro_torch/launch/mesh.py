"""Device meshes.

Twin of ``src/repro/launch/mesh.py``.  The port has no
``jax.sharding.Mesh``: ``Mesh`` is an ordered tuple of ``torch.device``s
laid out row-major over named axes.  It hashes and compares by value, so
the serving layer's cache keys can carry it, and nothing is placed on a
device when one is built.  ``make_local_mesh`` lays the LM's ``(data,
model)`` mesh over every visible card, over N shards of the CPU device
(the port's counterpart of the reference tests' forced host devices) or,
with ``shards=``, over N shards of one card (a rehearsal of a
several-card mesh on one card).  ``make_production_mesh`` is the
reference's pod layout, 16 x 16 (two pods: 2 x 16 x 16), over entries of
one device, by default ``meta``: the dry run (``launch/dryrun.py``)
traces a cell on it, allocating nothing.
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

    def shape_of(self, axes) -> int:
        """The number of devices along ``axes`` (one name or several)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape[a] for a in axes)

    def coords(self, k: int) -> dict[str, int]:
        """Device ``k``'s index along each axis (row-major)."""
        out = {}
        for a, n in zip(reversed(self.axis_names), reversed(self._sizes)):
            k, out[a] = divmod(k, n)
        return {a: out[a] for a in self.axis_names}

    def index(self, coords: dict[str, int]) -> int:
        """The device index at ``coords`` (every axis named)."""
        k = 0
        for a, n in zip(self.axis_names, self._sizes):
            k = k * n + coords[a]
        return k

    def group(self, k: int, axes) -> list[int]:
        """The devices that share device ``k``'s coordinates on every axis
        but ``axes``, row-major over ``axes`` (a collective's
        participants, device ``k`` among them)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        c = self.coords(k)
        out = [c]
        for a in axes:
            out = [dict(x, **{a: i}) for x in out
                   for i in range(self.shape[a])]
        return [self.index(x) for x in out]

    def take(self, axis: str, i: int) -> "Mesh":
        """The sub-mesh at index ``i`` of ``axis`` (that axis at size 1)."""
        ks = [k for k in range(self.size) if self.coords(k)[axis] == i]
        return Mesh([self.devices[k] for k in ks], self.axis_names,
                    [1 if a == axis else n
                     for a, n in zip(self.axis_names, self._sizes)])

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


def make_production_mesh(multi_pod: bool = False, device="meta") -> Mesh:
    """16 x 16 = 256 chips a pod over ``("data", "model")``; ``multi_pod``
    adds a leading 2-pod axis, ``("pod", "data", "model")``.  Every entry
    is ``device`` (``meta``: shapes and dtypes, no storage)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh([torch.device(device)] * math.prod(shape), axes, shape)


def make_local_mesh(model: int = 1, device="cuda",
                    shards: int | None = None) -> Mesh:
    """Whatever this host has, as (data, model): every visible card
    (``device="cuda"``); one named card (``"cuda:1"``); ``model`` shards
    of the CPU device (``"cpu"``); or ``shards`` shards of the one device
    named (``device="cuda:0", shards=4``: a rehearsal of four cards on
    one).  ``model`` must divide the device count."""
    dev = check_device(device)
    if dev.type == "cuda" and dev.index is None and shards is None:
        devs = local_devices(dev)
    else:
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
        n = shards if shards is not None else \
            model if dev.type == "cpu" else 1
        devs = [dev] * n
    n = len(devs)
    if model < 1 or n % model:
        raise ValueError(f"make_local_mesh: model={model} does not divide "
                         f"the {n} devices of {device!r}")
    return Mesh(devs, ("data", "model"), (n // model, model))


def mesh_axis_sizes(mesh: Mesh) -> dict[str, int]:
    return dict(mesh.shape)
