"""Logical-axis sharding rules, and the port's sharded leaves.

Twin of ``src/repro/sharding/axes.py``.  Every tensor dimension in the
model stack carries a *logical* name (``act_batch``, ``p_ff``,
``cache_seq``, ...).  A ``Rules`` table maps logical names to mesh axes
for the current execution mode (``train_rules`` / ``serve_rules``, the
reference's tables letter for letter); ``use_rules`` makes a table
current for a thread, and models never name mesh axes directly.

The port has no GSPMD.  One process drives every device (as the MBE mesh
does, ``core/distributed.py``), and a tensor split over a mesh is one
tensor a shard, each on its own device:

* ``NamedSharding(mesh, spec)`` names that split (``spec``: per dim the
  mesh axes it is split over, or None); ``shard`` cuts a whole tensor
  into its ``Shards``.
* ``Shards`` holds a leaf's distinct shards, each once, on its *home*
  device (index 0 of every mesh axis the leaf is replicated over).  A
  device computes on ``local(k)``: its shard copied to it (a copy that
  autograd carries back, so a replicated leaf's grads from every device
  sum into its one home shard), with the dims split over ``gather`` axes
  gathered whole (the FSDP all-gather; its backward is the
  reduce-scatter of the grads).
* ``constrain(x, *logical)`` lays a whole tensor out over the mesh: one
  part a device, its slice under the current rules (``act_seq`` too:
  the residual stream's sequence split, Megatron sequence parallelism;
  a caller that needs a dim whole names it None); a list of parts (one
  a device) is already laid out and passes as it is.
* ``lead()`` makes the controller run device 0's share only (the dry
  run's count of one device's program): ``run_range`` / ``each`` give
  device 0 alone, a leaf's ``leaf_parts`` is its device-0 shard, and
  what device 0 would read of other shards (an FSDP gather, a ``take``'s
  pieces, a collective's result: ``sharding/collectives.py``) is made in
  its shape by ``stand_in``.  This module alone reads the switch.
* A recorder (``launch/hlo_stats.py``'s counter, installed with
  ``recording``) hears of every collective and every piece moved between
  devices (``report``); with none installed ``report`` does nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional

import torch

from repro_torch.kernels.dispatch import check_device
from repro_torch.launch.mesh import Mesh, local_devices

# ---------------------------------------------------------------------------
# MBE serving mesh axis
# ---------------------------------------------------------------------------
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


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Rules:
    table: dict[str, tuple[str, ...] | None]
    mesh: Optional[Mesh] = None

    def axes(self, name: str | None):
        if name is None:
            return None
        if name not in self.table:
            raise KeyError(f"unknown logical axis {name!r}")
        return self.table[name]


_STATE = threading.local()


def current_rules() -> Optional[Rules]:
    return getattr(_STATE, "rules", None)


def _lead_only() -> bool:
    return getattr(_STATE, "lead", False)


@contextlib.contextmanager
def lead(on: bool = True):
    """The controller runs device 0's share only (see the module
    docstring)."""
    prev = _lead_only()
    _STATE.lead = on
    try:
        yield
    finally:
        _STATE.lead = prev


def run_range(mesh: Mesh) -> range:
    """The devices whose share the controller runs: all, or under
    ``lead()`` device 0."""
    return range(1) if _lead_only() else range(mesh.size)


def each(mesh: Mesh, fn, over=None) -> list:
    """``[fn(k) for k in over]`` (default: every device of ``mesh``), one
    value a device; under ``lead()`` ``fn(over[0])`` only, standing for
    every one's."""
    over = range(mesh.size) if over is None else over
    if len(run_range(mesh)) < mesh.size:
        return [fn(over[0])] * len(over)
    return [fn(k) for k in over]


_RECORDERS: list = []


@contextlib.contextmanager
def recording(rec):
    """Install ``rec`` (with ``collective(kind, operand_bytes,
    out_bytes)`` and a ``paused()`` context) as the recorder ``report``
    tells."""
    _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        _RECORDERS.remove(rec)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def report(kind: str, operand: torch.Tensor, out_bytes: int) -> None:
    """A collective ``kind`` of ``operand`` (the device's part) that
    writes ``out_bytes``, told to the installed recorder, if any."""
    if _RECORDERS:
        _RECORDERS[-1].collective(kind, _nbytes(operand), out_bytes)


def stand_in(kind: str, x: torch.Tensor, shape) -> torch.Tensor:
    """Under ``lead()``: what device 0 receives by collective ``kind`` of
    its part ``x``, a new tensor of ``shape`` (made outside the
    recorder's count), reported."""
    with (_RECORDERS[-1].paused() if _RECORDERS
          else contextlib.nullcontext()):
        out = x.new_empty(shape)
    report(kind, x, _nbytes(out))
    return out


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    prev = current_rules()
    _STATE.rules = rules
    try:
        yield rules
    finally:
        _STATE.rules = prev


def spec_for(logical: tuple[str | None, ...],
             rules: Optional[Rules] = None) -> tuple:
    """Per dim, the mesh axes the rules split it over (None: whole); the
    reference's ``PartitionSpec`` as a tuple."""
    r = rules or current_rules()
    if r is None:
        return ()
    return tuple(r.axes(n) for n in logical)


def mesh_rules() -> Optional[Rules]:
    """The current rules when they name a mesh of more than one device
    (a one-device mesh runs the plain one-device path), else None."""
    r = current_rules()
    return r if r is not None and r.mesh is not None \
        and r.mesh.size > 1 else None


def _axes_of(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A split of a tensor over ``mesh``: ``spec`` gives per dim the mesh
    axes it is split over (several axes: row-major over them), or None."""
    mesh: Mesh
    spec: tuple

    def __post_init__(self):
        used = [a for e in self.spec for a in _axes_of(e)]
        if len(used) != len(set(used)):
            raise ValueError(f"mesh axis used twice in spec {self.spec}")

    @property
    def split_axes(self) -> tuple[str, ...]:
        """The mesh axes some dim is split over, in mesh order."""
        used = {a for e in self.spec for a in _axes_of(e)}
        return tuple(a for a in self.mesh.axis_names if a in used)

    def n_shards(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.split_axes)

    def shard_index(self, coords: dict[str, int]) -> int:
        """Row-major index of the shard at mesh ``coords``."""
        i = 0
        for a in self.split_axes:
            i = i * self.mesh.shape[a] + coords[a]
        return i

    def home(self, i: int) -> int:
        """The device that holds shard ``i``: its coordinates on the split
        axes, 0 on the others."""
        c = {a: 0 for a in self.mesh.axis_names}
        for a in reversed(self.split_axes):
            i, c[a] = divmod(i, self.mesh.shape[a])
        return self.mesh.index(c)

    def slices(self, shape, coords: dict[str, int]) -> tuple[slice, ...]:
        """The index of the shard at mesh ``coords`` in a whole tensor of
        ``shape`` (a dim that its axes do not divide raises)."""
        out = []
        for d, n in enumerate(shape):
            axes = _axes_of(self.spec[d]) if d < len(self.spec) else ()
            m, j = 1, 0
            for a in axes:
                m, j = m * self.mesh.shape[a], j * self.mesh.shape[a] \
                    + coords[a]
            if n % m:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                                 f"over {axes} ({m} ways)")
            out.append(slice(j * (n // m), (j + 1) * (n // m)))
        return tuple(out)

    def shard(self, x: torch.Tensor) -> "Shards":
        """``x`` cut into its shards, each copied to its home device (a
        copy even on ``x``'s own device: the optimizer updates shards in
        place)."""
        parts = []
        for i in range(self.n_shards()):
            k = self.home(i)
            piece = x[self.slices(x.shape, self.mesh.coords(k))]
            parts.append(torch.empty(piece.shape, dtype=x.dtype,
                                     device=self.mesh.devices[k])
                         .copy_(piece))
        return Shards(parts, self, tuple(x.shape))


def named_sharding(logical: tuple[str | None, ...],
                   rules: Optional[Rules] = None) -> NamedSharding:
    r = rules or current_rules()
    assert r is not None and r.mesh is not None
    return NamedSharding(r.mesh, spec_for(logical, r))


class Shards:
    """One leaf split over a mesh: ``parts`` its distinct shards (row-major
    over ``sharding.split_axes``), each on its home device; ``shape`` the
    whole leaf's."""

    __slots__ = ("parts", "sharding", "shape", "views", "taken")

    def __init__(self, parts, sharding: NamedSharding, shape, views=None,
                 taken=None):
        self.parts = list(parts)
        self.sharding = sharding
        self.shape = tuple(shape)
        # {gather axes: every device's ``local`` view}, copied by ``place``
        self.views = views or {}
        # a placed leaf's memo of what ``take`` gave each device (None: not
        # placed, nothing kept); a stacked leaf's, {layer: its layer's memo}
        self.taken = taken

    @property
    def dtype(self):
        return self.parts[0].dtype

    def dim(self) -> int:
        return len(self.shape)

    def like(self, parts) -> "Shards":
        """The same split over new ``parts`` (e.g. grads or moments)."""
        return Shards(parts, self.sharding, self.shape)

    def unbind0(self) -> list["Shards"]:
        """The leaf's slices along dim 0 (a layer each), dim 0 whole:
        one ``unbind`` a shard (its backward stacks the grads once).  A
        placed leaf's layers keep their ``take`` results in its memo."""
        sh = NamedSharding(self.sharding.mesh, self.sharding.spec[1:])
        rows = [p.unbind(0) for p in self.parts]
        views = {g: [p.unbind(0) for p in v] for g, v in self.views.items()}
        memo = self.taken
        return [Shards([r[i] for r in rows], sh, self.shape[1:],
                       {g: [r[i] for r in vs] for g, vs in views.items()},
                       None if memo is None else memo.setdefault(i, {}))
                for i in range(self.shape[0])]

    def place(self, gather=()) -> "Shards":
        """The same leaf with every device's ``local(k, gather)`` view
        copied to it once, for a loop that reads the same weights every
        step; a device's replicas of one shard share the tensor.  What
        ``take`` gives a device is kept too, on its first call: where
        that is cut from one shard on the device's own card it is a view
        of the shard, else a copy, held beside the device's shard for as
        long as the placed leaf lives (serving zamba2's ``in_proj``: a
        device's heads' z / x / dt columns and B / C, about as many
        columns again as its shard; ``chip_smoke.py``'s served loop
        logs the peak by card)."""
        mesh, g = self.sharding.mesh, tuple(gather)
        memo, views = {}, []
        for d in range(mesh.size):
            c = mesh.coords(d)
            key = (mesh.devices[d],) + tuple(
                c[a] for a in self.sharding.split_axes if a not in g)
            if key not in memo:
                memo[key] = self.local(d, g)
            views.append(memo[key])
        return Shards(self.parts, self.sharding, self.shape, {g: views},
                      {})

    def _gathered(self, gather) -> list[tuple[int, tuple[str, ...]]]:
        """The dims split over axes of ``gather`` and their axes."""
        gdims = []
        for d, e in enumerate(self.sharding.spec):
            ax = _axes_of(e)
            if any(a in gather for a in ax):
                if not all(a in gather for a in ax):
                    raise ValueError(f"dim {d} is split over {ax}: "
                                     f"gathering part of it is not "
                                     f"supported")
                gdims.append((d, ax))
        return gdims

    def _build(self, gdims, i, cc, dev, cut) -> torch.Tensor:
        """The shard at mesh coordinates ``cc``, cut by ``cut`` on its
        home device and copied to ``dev``, the dims ``gdims[i:]``
        gathered over their axes."""
        if i == len(gdims):
            part = self.parts[self.sharding.shard_index(cc)]
            return (part[cut] if cut else part).to(dev)
        d, ax = gdims[i]
        mesh = self.sharding.mesh
        pieces = [self._build(gdims, i + 1, dict(cc, **dict(zip(ax, ix))),
                              dev, cut)
                  for ix in _iter_coords(mesh, ax)]
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, d)

    def local(self, k: int, gather=()) -> torch.Tensor:
        """What device ``k`` computes with: its shard, on its device, with
        every dim split over an axis of ``gather`` gathered whole (the
        copy ``place`` made, where it made one)."""
        placed = self.views.get(tuple(gather))
        if placed is not None:
            return placed[k]
        return self._piece(self._gathered(gather), k, self.sharding.mesh
                           .coords(k), ())

    def _piece(self, gdims, k, cc, cut) -> torch.Tensor:
        """``_build`` for device ``k``; under ``lead()`` device 0's own
        shard cut by ``cut``, or a stand-in of that shape for another's (a
        collective-permute), all-gathered over ``gdims``."""
        mesh = self.sharding.mesh
        if not _lead_only():
            return self._build(gdims, 0, cc, mesh.devices[k], cut)
        from repro_torch.sharding import collectives as C
        own = self.parts[0]
        x = own[cut] if cut else own
        if self.sharding.shard_index(cc):      # another device's shard
            x = stand_in("collective-permute", x, x.shape)
        for d, ax in gdims:
            x = C.one_device(x, "all-gather", mesh.shape_of(ax), d)
        return x

    def take(self, k: int, dim: int, ranges, gather=(),
             index: dict | None = None) -> torch.Tensor:
        """Device ``k``'s view of the whole leaf's indices ``ranges``
        (``(start, stop)`` pairs, concatenated in order) along ``dim``,
        whatever axes that dim is split over; the other dims as
        ``local(k, gather)`` gives them, after ``index`` ({dim: slice} of
        dims kept whole).  Each piece is cut on the device that holds it
        and only the piece is copied to ``k``: a device holds no more of
        the leaf than it asks for (a layer's columns of a split
        projection; the slices of its heads)."""
        memo = self.taken
        index = index or {}
        key = (k, dim, tuple(map(tuple, ranges)), tuple(gather),
               tuple(sorted((d, s.start, s.stop) for d, s in index.items())))
        if memo is not None and key in memo:
            return memo[key]
        sh, mesh = self.sharding, self.sharding.mesh
        ax = _axes_of(sh.spec[dim]) if dim < len(sh.spec) else ()
        gdims = self._gathered(gather)
        if any(d == dim for d, _ in gdims) or any(
                d < len(sh.spec) and _axes_of(sh.spec[d]) for d in index):
            raise ValueError(f"take: dim {dim} / index {index} of a leaf "
                             f"split {sh.spec} over gather {gather}")
        w = self.shape[dim] // mesh.shape_of(ax)
        cut = [slice(None)] * len(self.shape)
        for d, s in index.items():
            cut[d] = s
        pieces = []
        for j, lo, n, _ in range_pieces(ranges, w):
            cc = dict(mesh.coords(k), **_unravel(mesh, ax, j))
            cut[dim] = slice(lo, lo + n)
            pieces.append(self._piece(gdims, k, cc, tuple(cut)))
        out = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)
        if memo is not None:
            memo[key] = out
        return out

    def full(self, device=None) -> torch.Tensor:
        """The whole leaf, assembled on ``device`` (default: the first
        shard's)."""
        dev = self.parts[0].device if device is None else device
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        mesh = self.sharding.mesh
        for i, p in enumerate(self.parts):
            c = mesh.coords(self.sharding.home(i))
            out[self.sharding.slices(self.shape, c)] = p.to(dev)
        return out


def range_pieces(ranges, w: int):
    """The pieces of ``(start, stop)`` ranges (in order, adjacent ones
    merged) of a dim laid out in equal chunks of ``w``: (chunk, start in
    the chunk, length, offset in the concatenation of the ranges)."""
    merged = []
    for a, b in ranges:
        if merged and merged[-1][1] == a:
            merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    off = 0
    for a, b in merged:
        for j in range(a // w, (b - 1) // w + 1):
            lo, hi = max(a, j * w), min(b, (j + 1) * w)
            yield j, lo - j * w, hi - lo, off
            off += hi - lo


def _unravel(mesh: Mesh, axes, j: int) -> dict[str, int]:
    """Index ``j``, row-major over ``axes``, as coordinates."""
    out = {}
    for a in reversed(tuple(axes)):
        j, out[a] = divmod(j, mesh.shape[a])
    return out


def leaf_parts(x) -> list[torch.Tensor]:
    """A leaf's tensors: a sharded leaf's shards (under ``lead()``: its
    device-0 shard, the first), or the tensor itself."""
    if isinstance(x, Shards):
        return x.parts[:1] if _lead_only() else x.parts
    return [x]


def leaf_like(x, parts):
    """``parts`` (one a tensor of ``leaf_parts(x)``) in the form of leaf
    ``x``: a ``Shards`` of the same split (under ``lead()`` the other
    shards kept as they are), or the one tensor."""
    if isinstance(x, Shards):
        return x.like(list(parts) + x.parts[len(parts):])
    return parts[0]


def _iter_coords(mesh: Mesh, axes):
    """Row-major index tuples over ``axes``."""
    out = [()]
    for a in axes:
        out = [x + (i,) for x in out for i in range(mesh.shape[a])]
    return out


def constrain(x, *logical: str | None):
    """Lay ``x`` out by logical dim names under the current rules (a
    no-op without a mesh of several devices).  A whole tensor becomes one
    part a device of the mesh, its device's slice on that device; a list
    (one part a device) is already laid out and is returned as it is."""
    r = mesh_rules()
    if r is None or not isinstance(x, torch.Tensor):
        return x
    assert len(logical) == x.dim(), (logical, tuple(x.shape))
    sh = NamedSharding(r.mesh, spec_for(logical, r))
    mesh = r.mesh
    return each(mesh, lambda k: x[sh.slices(x.shape, mesh.coords(k))]
                .to(mesh.devices[k]))


# ---------------------------------------------------------------------------
# rule tables
# ---------------------------------------------------------------------------

def _batch_axes(multi_pod: bool) -> tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def train_rules(mesh: Mesh, multi_pod: bool = False,
                fsdp: bool = True) -> Rules:
    b = _batch_axes(multi_pod)
    return Rules(mesh=mesh, table={
        # activations
        "act_batch": b,
        # Megatron-style sequence parallelism: the residual stream between
        # sub-blocks holds S / model positions a device
        "act_seq": ("model",),
        "act_embed": None,
        "act_heads": ("model",),
        "act_kv": ("model",),
        "act_ff": ("model",),
        "act_vocab": ("model",),
        "act_expert": ("model",),
        "act_group": b,          # MoE dispatch groups follow the batch
        "act_inner": ("model",),  # ssm / mlstm inner width
        # params
        "p_embed": ("data",) if fsdp else None,
        "p_vocab": ("model",),
        "p_heads": ("model",),
        "p_kv": ("model",),
        "p_ff": ("model",),
        "p_expert": ("model",),
        "p_inner": ("model",),
        "p_none": None,
        # caches unused in training
        "cache_seq": None,
        "cache_batch": b,
    })


def serve_rules(mesh: Mesh, multi_pod: bool = False,
                batch_shardable: bool = True) -> Rules:
    b = _batch_axes(multi_pod)
    # long-context single-sequence decode: the cache's sequence dim takes
    # every axis the batch cannot use
    if batch_shardable:
        cache_seq = ("model",)
        batch = b
    else:
        cache_seq = (_batch_axes(multi_pod) + ("model",))
        batch = None
    return Rules(mesh=mesh, table={
        "act_batch": batch,
        # prefill: the residual stream shards over (model x seq); decode
        # has no seq dim so the entry is inert there
        "act_seq": ("model",),
        "act_embed": None,
        "act_heads": ("model",),
        "act_kv": ("model",),
        "act_ff": ("model",),
        "act_vocab": ("model",),
        "act_expert": ("model",),
        "act_group": batch,
        "act_inner": ("model",),
        "p_embed": None,          # TP-only: no per-step weight gathers
        "p_vocab": ("model",),
        "p_heads": ("model",),
        "p_kv": ("model",),
        "p_ff": ("model",),
        "p_expert": ("model",),
        "p_inner": ("model",),
        "p_none": None,
        "cache_seq": cache_seq,
        "cache_batch": batch,
    })
