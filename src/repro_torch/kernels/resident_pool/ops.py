"""Dispatch wrapper for the multi-lane resident pool segment kernel.

Twin of ``src/repro/kernels/resident_pool/ops.py``.  It replaces the
Pallas kernel ``src/repro/kernels/resident_pool/kernel.py:
resident_pool_kernel`` (built by ``make_resident_pool_call``) with
``rt_resident_pool`` (``csrc/resident_pool.cu``): the same CUDA lane body
as the single-lane kernel, one CTA (or one cluster of CTAs) per lane (the
paper's thread-block-per-task layout), plus the ``(lanes, 2)`` scoreboard
``[done, steps_per_call - advanced]``.

``pool_run`` is the run loop's handle (``resident_step.ops.LaneRun``):
every launch advances all lanes of a ``Packed`` pool IN PLACE (CUDA
tensor) or runs the plain version into the same buffers (CPU tensor).
``resident_pool_segment`` / ``packed_pool_segment`` are the functional
entries: one clone, then one in-place launch.  Every launch (in
``LaneRun.launch``, the one place ``rt_resident_pool`` is called) adds one
to ``resident_pool_segment.launches``.

The TPU gate's "two concurrent grid cells" argument does not apply: all
lanes run at once, each on its own shared memory, and the stacks live in
device memory, so the per-lane gate of
``resident_step.ops.resident_supported`` is the whole gate.
"""
from __future__ import annotations

from repro_torch.kernels.resident_step.ops import (LaneRun, clone_packed,
                                                   pack, resident_supported,
                                                   unpack)

B_DONE, B_LEFT = range(2)
BOARD_SLOTS = 2


def resident_pool_supported(cfg, lanes: int,
                            t_len: int | None = None) -> bool:
    """Whether a ``lanes``-wide pool of ``cfg`` states fits the kernel."""
    return lanes >= 1 and resident_supported(cfg, t_len, lanes)


def pool_run(g, cfg, s, p, steps_per_call: int, *, ctx_batched: bool,
             impl: str = "pallas", **kw) -> LaneRun:
    """The pool run loop's handle on K3 (``s`` supplies the task lists)."""
    return LaneRun(g, cfg, s, p, steps_per_call, lanes=s.tasks.shape[0],
                   counter=resident_pool_segment, ctx_batched=ctx_batched,
                   impl=impl, **kw)


def packed_pool_segment(g, cfg, s, p, steps_per_call: int, *,
                        ctx_batched: bool, impl: str = "pallas"):
    """One pool segment on a ``Packed`` pool, functional: ``p`` is cloned
    once, then advanced in place by ONE K3 launch (CUDA tensor) or the
    plain version (CPU tensor).  Returns ``(Packed, board)``."""
    q = clone_packed(p)
    board = pool_run(g, cfg, s, q, steps_per_call, ctx_batched=ctx_batched,
                     impl=impl, flag=False).launch()
    return q, board


def resident_pool_segment(g, cfg, s, *, start, budget,
                          steps_per_call: int = 1,
                          ctx_batched: bool = False, impl: str = "pallas"):
    """Advance every lane of ``s`` by up to ``steps_per_call`` guarded
    steps; returns ``(state, board)``.  ``start``/``budget`` broadcast to
    per-lane columns of the scalar block."""
    out, board = packed_pool_segment(g, cfg, s, pack(s, start, budget),
                                     steps_per_call,
                                     ctx_batched=ctx_batched, impl=impl)
    return unpack(s, out), board


resident_pool_segment.launches = 0
