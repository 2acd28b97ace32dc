"""Shared impl-dispatch rules and the Hopper launch plan.

Twin of ``src/repro/kernels/dispatch.py``.  Every kernel op takes
``impl`` with the reference's three values, decided from the DEVICE of
the tensors instead of the JAX default backend:

* ``"jnp"``    — the plain torch-op version (``ref.py``) on either device;
  an explicit caller's choice.
* ``"pallas"`` — the kernel path.  On a CUDA tensor the ops wrapper
  launches the hand-written CUDA kernel (or raises); on a CPU tensor it
  runs the plain version, which takes the place of Pallas interpret mode.
* ``"auto"``   — ``"pallas"`` on a CUDA tensor, ``"jnp"`` on a CPU one.

``plan_rows`` is the Hopper launch plan of the row-tile kernels K1
(``fused_check``), K4 (``fused_select``) and K5 (``intersect_count``):
rows a CTA, threads, the thread group that reduces one adjacency row and
how a thread walks it (see ``csrc/rows.cuh``); ``row_scratch`` the zeroed
per-lane slots the cross-CTA fold of K1 and K4 uses; ``Outputs`` one
allocation for a call's outputs.
``expect`` and ``lane_layout`` are the operand checks every wrapper makes
before a launch; ``take_rows`` is the gather rule of the ``idx``
(compact-array) kinds.  ``on_device`` is the one place a launch enters
its tensors' CUDA device: every wrapper makes its C call inside it, so a
launch on ``cuda:1`` runs with that device current (the C entries key
their shared-memory records by ``cudaGetDevice``) on that device's
stream, whatever device the caller has current.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

IMPLS = ("auto", "jnp", "pallas")

WARP = 32
# one H100 block may hold at most 227 KB of dynamic shared memory
MAX_SMEM_BYTES = 232_448


def resolve_impl(impl: str, device) -> str:
    """Map ``impl`` to ``"jnp"``/``"pallas"`` for tensors on ``device``."""
    if impl == "auto":
        return "pallas" if torch.device(device).type == "cuda" else "jnp"
    if impl not in ("jnp", "pallas"):
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    return impl


def use_kernel(impl: str, device) -> bool:
    """Whether an ops wrapper must launch its CUDA kernel: the kernel path
    was chosen AND the tensors lie on a CUDA device.  A CPU tensor takes
    the plain version; nothing ever falls back from CUDA to the CPU."""
    if impl == "pallas" and isinstance(device, torch.device):
        return device.type == "cuda"
    return (resolve_impl(impl, device) == "pallas"
            and torch.device(device).type == "cuda")


def check_device(device) -> torch.device:
    """Resolve a user-facing device string; ``"cuda"`` without a card
    raises instead of continuing on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is present; "
            f"pass device='cpu' to run the plain torch-op path")
    return dev


class on_device:
    """``with on_device(t.device):`` around a kernel's C call: makes the
    tensors' CUDA device current for the launch and gives the caller's
    back after it (one device query when it already is current; nothing
    for a device that is not a numbered CUDA device)."""

    __slots__ = ("index", "prev")

    def __init__(self, device: torch.device):
        self.index = device.index if device.type == "cuda" else None
        self.prev = self.index

    def __enter__(self):
        if self.index is not None:
            self.prev = torch.cuda.current_device()
            if self.index != self.prev:
                torch.cuda.set_device(self.index)
        return self

    def __exit__(self, *exc):
        if self.index != self.prev:
            torch.cuda.set_device(self.prev)
        return False


def take_rows(adj: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``adj[idx]`` under JAX's gather rule (a negative index wraps once,
    then the index is clamped into range) for a shared (N, W) or a
    per-lane (..., N, W) adjacency with ``idx`` (..., M) -> (..., M, W).
    The plain versions of the gathered kernels read rows through it, and
    the kernels apply the same rule to each index."""
    n = adj.shape[-2]
    i = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1).to(torch.int64)
    if adj.dim() == 2:
        return adj[i]
    return torch.gather(adj, -2, i[..., None].expand(*i.shape, adj.shape[-1]))


def as_i32(x, device) -> torch.Tensor:
    """``x`` as an int32 tensor on ``device``: an int32 tensor already
    there is returned as it is (no ``torch.as_tensor`` call)."""
    if isinstance(x, torch.Tensor) and x.dtype is torch.int32 \
            and x.device == device:
        return x
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def expect_i32(t: torch.Tensor, what: str, name: str, shape,
               device) -> None:
    """``expect(t, ..., torch.int32, shape, device)`` with the common case
    (the check passes) in one expression."""
    if t.dtype is not torch.int32 or t.shape != shape \
            or t.device != device or not t.is_contiguous():
        expect(t, what, name, torch.int32, shape, device)


def expect(t: torch.Tensor, what: str, name: str, dtype, shape,
           device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (every wrapper checks its operands before a launch)."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{what}: {name} must be a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} "
            f"on {t.device}")


def lane_layout(adj: torch.Tensor, lead: tuple, what: str) -> tuple[int, int]:
    """(lanes, adjacency stride in words) of a lane-batched launch: the
    adjacency is shared (N, W) (stride 0) or per lane (*lead, N, W)."""
    batch = 1
    for d in lead:
        batch *= d
    if adj.dim() == 2:
        return batch, 0
    if tuple(adj.shape[:-2]) == lead:
        return batch, adj.shape[-2] * adj.shape[-1]
    raise ValueError(f"{what}: adj {tuple(adj.shape)} does not match lane "
                     f"dims {lead}")


def _pow2_ceil(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


# ---- the row-tile kernels K1, K4 and K5 (csrc/rows.cuh) -------------------

ROW_TILE = 32           # rows a CTA (chip_smoke.py's sweep, PERF.md)
ROW_THREADS = 256       # threads a CTA, at most (the same sweep)
ROW_THREADS_LONG = 128  # the same for rows walked in several chunks
RMAX = 8                # rows a thread group owns in a tile, at most
LOADS = 8               # units a thread keeps in flight
MAX_ROW_THREADS = 512   # csrc/rows.cuh:MAX_THREADS (__launch_bounds__)
MAX_TILE_ROWS = 256     # csrc/rows.cuh:MAX_ROWS
MAX_GRID_Y = 65_535     # lanes ride on grid.y
# static shared memory of a K1 CTA (the tile's counts); K4 takes less
ROW_SMEM_BYTES = 4 * MAX_TILE_ROWS


class RowPlan(NamedTuple):
    rows: int           # rows a CTA: a power of two, 32 <= rows <= 256
    threads: int        # threads a CTA (a multiple of 32, >= rows)
    group: int          # threads reducing one row (power of two <= 32)
    units: int          # loads a row: w / 4 (16-byte units) or w (words)
    chunk: int          # units a thread holds in registers (1, 2, 4, 8)
    nchunks: int        # chunks a thread walks a row in
    vec: bool           # 16-byte units
    tiles: int          # grid.x = ceil(n / rows)
    lanes: int          # grid.y
    smem_bytes: int     # static shared memory a CTA


@functools.lru_cache(maxsize=4096)
def plan_rows(n: int, w: int, lanes: int, vec: bool = True,
              rows: int = ROW_TILE,
              max_threads: int | None = None) -> RowPlan:
    """Launch plan of K1 / K4 / K5 over ``lanes`` lanes of ``n`` rows of ``w``
    words (``vec``: the operands allow 16-byte loads; it also needs
    ``w % 4 == 0``).  ``rows`` (a tile) and ``max_threads`` are the sweep's
    knobs (by default ROW_THREADS, or ROW_THREADS_LONG where a thread
    walks a row in several chunks: fewer threads, more rows each); the
    plan keeps every constraint of ``csrc/rows.cuh``: each group owns
    1..RMAX rows, a thread per row for K1's flags, at most
    MAX_ROW_THREADS threads, tiles on whole packed words."""
    if n < 1 or w < 1 or lanes < 1:
        raise ValueError(f"plan_rows: n={n}, w={w}, lanes={lanes} must be "
                         f">= 1")
    if lanes > MAX_GRID_Y:
        raise ValueError(f"plan_rows: {lanes} lanes exceed grid.y's "
                         f"{MAX_GRID_Y}")
    vec = bool(vec) and w % 4 == 0
    units = w // 4 if vec else w
    group = min(WARP, _pow2_ceil(units))
    per_thread = -(-units // group)
    chunk = min(LOADS, _pow2_ceil(per_thread))
    nchunks = -(-per_thread // chunk)
    if max_threads is None:
        max_threads = ROW_THREADS if nchunks == 1 else ROW_THREADS_LONG
    rows = min(MAX_TILE_ROWS, max(WARP, _pow2_ceil(rows)))
    while rows * group > RMAX * MAX_ROW_THREADS:
        rows //= 2
    threads = min(_pow2_ceil(max(max_threads, WARP)), MAX_ROW_THREADS,
                  rows * group)
    threads = max(threads, rows, rows * group // RMAX, WARP)
    tiles = -(-n // rows)
    if tiles >= 1 << 31:
        raise ValueError(f"plan_rows: {n} rows exceed grid.x")
    return RowPlan(rows, threads, group, units, chunk, nchunks, vec, tiles,
                   lanes, ROW_SMEM_BYTES)


def aligned16(adj: torch.Tensor, mask: torch.Tensor, w: int) -> bool:
    """Whether K1 / K4 / K5 may read 16-byte units: w % 4 == 0 (every row and
    per-lane block then starts on 16 bytes) and both bases aligned."""
    return w % 4 == 0 and adj.data_ptr() % 16 == 0 \
        and mask.data_ptr() % 16 == 0


_scratch: dict = {}


def row_scratch(kernel: str, device: torch.device, stream: int,
                lanes: int, words: int) -> torch.Tensor:
    """The zeroed int32 scratch of ``kernel``'s cross-CTA fold on
    ``stream`` (``words`` a lane): allocated once per (kernel, device,
    stream) and grown when a call has more lanes.  The kernels leave it
    zeroed after every launch; launches on one stream run in order, and
    another stream gets its own buffer."""
    key = (kernel, device.index, stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < lanes * words:
        buf = torch.zeros(max(lanes, 64) * words, dtype=torch.int32,
                          device=device)
        _scratch[key] = buf
    return buf


def current_stream_ptr(index: int) -> int:
    """The raw current stream of CUDA device ``index`` (PyTorch's own fast
    query where this build has it)."""
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _strides(shape) -> tuple:
    out, acc = [], 1
    for d in reversed(shape):
        out.append(acc)
        acc *= d
    return tuple(reversed(out))


class Outputs:
    """A call's outputs as views of ONE int32 buffer: ``specs`` is
    ``[(dtype, shape), ...]`` (int32 or bool) in return order; the int32
    tensors come first in the buffer, then the bool ones (viewed as
    bytes)."""

    def __init__(self, specs):
        self.views = []
        i32 = b8 = 0
        n_i32 = sum(_numel(s) for d, s in specs if d is torch.int32)
        for dtype, shape in specs:
            shape = tuple(shape)
            if dtype is torch.int32:
                self.views.append((True, shape, _strides(shape), i32))
                i32 += _numel(shape)
            elif dtype is torch.bool:
                self.views.append((False, shape, _strides(shape),
                                   4 * n_i32 + b8))
                b8 += _numel(shape)
            else:
                raise ValueError(f"Outputs: dtype {dtype}")
        self.words = max(1, n_i32 + -(-b8 // 4))
        self.bools = b8 > 0

    def alloc(self, device) -> list:
        buf = torch.empty(self.words, dtype=torch.int32, device=device)
        b8 = buf.view(torch.bool) if self.bools else None
        return [(buf if is_i32 else b8).as_strided(shape, strides, off)
                for is_i32, shape, strides, off in self.views]


def _numel(shape) -> int:
    out = 1
    for d in shape:
        out *= d
    return out
