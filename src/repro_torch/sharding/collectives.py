"""Collectives over a named mesh axis, as copies between devices.

The reference has none of its own: GSPMD inserts them.  The port drives
every device from one process, so a value laid out over a mesh is a
list with one part a device (``mesh.devices`` order), and a collective
over an axis is explicit: each device's result is built from the parts
of its group (the devices that differ from it only along that axis)
copied to it with ``.to(device)``, then added or concatenated in group
order, so every member computes the same numbers.  Autograd carries the
copies backward, so each collective's backward is its transpose with no
code of its own: the grads of an all-gather are reduce-scattered back to
their shards, those of a reduce-scatter all-gathered, those of an
all-reduce summed over the group.

Members of a group on one device (the CPU's shards, or a rehearsal of
several cards on one) share one result tensor instead of computing it
again.

**One device's program** (``sharding.axes.lead()``, the dry run's:
``launch/dryrun.py`` on ``meta`` tensors).  Where the controller runs
device 0's share alone (``axes.run_range``), a collective takes device
0's part and makes the result of its shape (an all-gather's n parts, a
reduce-scatter's chunk) without reading the others'.  Every collective
made so, forward and backward, and every piece ``take`` / ``put`` move
between devices, is told to the installed recorder (``axes.report``).
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.sharding.axes import (each, range_pieces, report,
                                       run_range, stand_in)


class _OneDevice(torch.autograd.Function):
    """Device 0's result of a collective of its part: a stand-in of the
    result's shape, the collective (and its transpose in the backward)
    reported."""

    @staticmethod
    def forward(ctx, x, kind, n, dim):
        ctx.kind, ctx.n, ctx.dim = kind, n, dim
        shape = list(x.shape)
        if kind == "all-gather":
            shape[dim] *= n
        elif kind == "reduce-scatter":
            shape[dim] //= n
        return stand_in(kind, x, shape)

    @staticmethod
    def backward(ctx, g):
        # the transposes: all-reduce <-> all-reduce, all-gather <->
        # reduce-scatter
        back = {"all-reduce": "all-reduce", "all-gather": "reduce-scatter",
                "reduce-scatter": "all-gather"}[ctx.kind]
        return one_device(g, back, ctx.n, ctx.dim), None, None, None


def one_device(x: torch.Tensor, kind: str, n: int, dim: int = 0
               ) -> torch.Tensor:
    """Device 0's result of collective ``kind`` over ``n`` parts (device
    0's ``x``) along ``dim``, made in its shape and reported."""
    return _OneDevice.apply(x, kind, n, dim)


def _lead(xs: list, mesh: Mesh, axis, kind: str, dim: int = 0):
    """Where the controller runs device 0 alone, device 0's result (in
    every device's place); else None."""
    if len(run_range(mesh)) == mesh.size:
        return None
    return [one_device(xs[0], kind, mesh.shape_of(axis),
                       dim % xs[0].dim())] * mesh.size


def _per_device(xs: list, mesh: Mesh, axis, build) -> list:
    """``build(group, device)`` for each device's group over ``axis``,
    computed once per (group, physical device)."""
    out, memo = [], {}
    for k in range(mesh.size):
        g = tuple(mesh.group(k, axis))
        key = (g, mesh.devices[k])
        if key not in memo:
            memo[key] = build(g, mesh.devices[k])
        out.append(memo[key])
    return out


def all_reduce(xs: list, mesh: Mesh, axis) -> list:
    """Each device: the sum of its group's parts."""
    if mesh.shape_of(axis) == 1:
        return list(xs)
    if (one := _lead(xs, mesh, axis, "all-reduce")) is not None:
        return one

    def build(g, dev):
        acc = xs[g[0]].to(dev)
        for j in g[1:]:
            acc = acc + xs[j].to(dev)
        return acc
    return _per_device(xs, mesh, axis, build)


def all_gather(xs: list, mesh: Mesh, axis, dim: int) -> list:
    """Each device: its group's parts concatenated along ``dim``."""
    if mesh.shape_of(axis) == 1:
        return list(xs)
    if (one := _lead(xs, mesh, axis, "all-gather", dim)) is not None:
        return one
    return _per_device(xs, mesh, axis, lambda g, dev: torch.cat(
        [xs[j].to(dev) for j in g], dim=dim))


def reduce_scatter(xs: list, mesh: Mesh, axis, dim: int, dtype=None
                   ) -> list:
    """Each device: its own chunk (by its index in the group) along
    ``dim`` of the sum of its group's parts, rounded to ``dtype`` (default:
    the parts') once, after the sum: parts summed in fp32 and rounded to
    bf16 so (the xLSTM's partial products) round as one device's product
    does.  The row-parallel output's layout where ``act_seq`` splits the
    sequence over the same axes (Megatron sequence parallelism:
    ``models/model.py`` ``_seq_sum``), and the P split of the xLSTM's q /
    k.  Each part is split once, so the backward's copies bring every
    chunk's grad back to the part's device and concatenate them there:
    the all-gather of the grads.  A group on one device sums once and
    splits the sum (the same numbers: the adds are elementwise)."""
    n = mesh.shape_of(axis)
    if n == 1:
        out = list(xs)
    elif (one := _lead(xs, mesh, axis, "reduce-scatter", dim)) is not None:
        out = one
    else:
        chunks, whole, out = {}, {}, []
        for k in range(mesh.size):
            g = tuple(mesh.group(k, axis))
            i = g.index(k)
            dev = mesh.devices[k]
            if all(mesh.devices[j] == dev for j in g):
                # the group on one device: one sum, split once
                if g not in whole:
                    acc = xs[g[0]]
                    for j in g[1:]:
                        acc = acc + xs[j]
                    whole[g] = acc.chunk(n, dim=dim)
                out.append(whole[g][i])
                continue
            acc = None
            for j in g:
                if j not in chunks:
                    chunks[j] = xs[j].chunk(n, dim=dim)
                c = chunks[j][i].to(dev)
                acc = c if acc is None else acc + c
            out.append(acc)
    if dtype is None:
        return out
    return each(mesh, lambda k: out[k].to(dtype))


def gather_one(parts: list, mesh: Mesh, k: int, axis, dim: int
               ) -> torch.Tensor:
    """Device ``k``'s share of an all-gather: ``parts`` (its group's
    parts over ``axis``, in group order) concatenated along ``dim`` on
    its device.  For a frame of one device (a remat frame), whose inputs
    are the parts: it gathers them inside the frame, and the backward
    gathers them again."""
    if len(parts) == 1:
        return parts[0]
    if len(run_range(mesh)) < mesh.size:
        return one_device(parts[0], "all-gather", len(parts),
                          dim % parts[0].dim())
    dev = mesh.devices[k]
    return torch.cat([p.to(dev) for p in parts], dim=dim)


def _pieces(xs: list, mesh: Mesh, k: int, axis, dim: int, ranges):
    """(member, start, length, offset) of each piece of ``ranges`` (of
    the whole tensor laid out over device ``k``'s group along ``axis``,
    member i holding its i-th equal chunk along ``dim``): where it lies
    and where it starts in the concatenation of the ranges."""
    g = mesh.group(k, axis)
    for i, lo, n, off in range_pieces(ranges, xs[g[0]].shape[dim]):
        yield g[i], lo, n, off


def take(xs: list, mesh: Mesh, k: int, axis, dim: int, ranges
         ) -> torch.Tensor:
    """Device ``k``: indices ``ranges`` (``(start, stop)`` pairs,
    concatenated in order) along ``dim`` of the tensor laid out over its
    group along ``axis``, each piece cut where it lies and copied to
    ``k``."""
    dev = mesh.devices[k]
    parts = []
    for j, lo, n, _ in _pieces(xs, mesh, k, axis, dim, ranges):
        piece = xs[j].narrow(dim, lo, n)
        if j != k:                    # cut on device j, sent to k
            report("collective-permute", piece, piece.nbytes)
        parts.append(piece.to(dev))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def put(xs: list, mesh: Mesh, k: int, axis, dim: int, ranges,
        value: torch.Tensor) -> None:
    """``take``'s inverse, in place: ``value``'s pieces written into the
    parts of device ``k``'s group that hold ``ranges``."""
    for j, lo, n, off in _pieces(xs, mesh, k, axis, dim, ranges):
        piece = value.narrow(dim, off, n)
        if j != k:                    # sent from k to device j
            report("collective-permute", piece, piece.nbytes)
        xs[j].narrow(dim, lo, n).copy_(piece)
