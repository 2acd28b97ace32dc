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

``plan_blocks`` is the Hopper launch plan of the row-accumulate kernels:
threads per block, the thread group that reduces one adjacency row
(``group`` lanes, a power of two up to a warp), and the shared memory a
block needs.
"""
from __future__ import annotations

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


class LaunchPlan(NamedTuple):
    threads: int        # threads per block (a multiple of 32)
    group: int          # threads reducing one row (power of two <= 32)


def _pow2_ceil(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def plan_blocks(w: int, threads: int = 256) -> LaunchPlan:
    """Launch plan for an AND+popcount pass over rows of ``w`` words:
    ``group`` lanes share one row so that narrow rows (w < 32 words) do
    not idle most of a warp and wide rows read coalesced,
    ``threads / group`` rows in flight per block."""
    return LaunchPlan(threads=threads, group=min(WARP, _pow2_ceil(max(w, 1))))
