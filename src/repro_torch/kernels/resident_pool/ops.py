"""Dispatch wrapper for the multi-lane resident pool segment kernel.

Twin of ``src/repro/kernels/resident_pool/ops.py``.  It replaces the
Pallas kernel ``src/repro/kernels/resident_pool/kernel.py:
resident_pool_kernel`` (built by ``make_resident_pool_call``) with
``rt_resident_pool`` (``csrc/resident_pool.cu``): the same CUDA lane body
as the single-lane kernel, one block per lane (the paper's
thread-block-per-task layout), plus the ``(lanes, 2)`` scoreboard
``[done, steps_per_call - advanced]``.

``resident_pool_segment`` advances every lane of a batched state in ONE
launch (CUDA tensor) or runs the plain version (CPU tensor);
``packed_pool_segment`` is the same decision on a ``Packed`` pool, for
the engine's run loop.  Every launch (in ``packed_pool_segment``, the one
place ``rt_resident_pool`` is called) adds one to
``resident_pool_segment.launches``.

The TPU gate's "two concurrent grid cells" argument does not apply: all
lane blocks run at once, each with its own shared memory, and the
stacks live in device memory, so the per-lane gate of
``resident_step.ops.resident_supported`` is the whole gate.
"""
from __future__ import annotations

from repro_torch.kernels.dispatch import use_kernel
from repro_torch.kernels.resident_step.ops import (S_BUDGET, S_START,
                                                   lane_launch, pack,
                                                   resident_supported,
                                                   unpack)

B_DONE, B_LEFT = range(2)
BOARD_SLOTS = 2


def resident_pool_supported(cfg, lanes: int,
                            t_len: int | None = None) -> bool:
    """Whether a ``lanes``-wide pool of ``cfg`` states fits the kernel."""
    return lanes >= 1 and resident_supported(cfg, t_len, lanes)


def packed_pool_segment(g, cfg, s, p, steps_per_call: int, *,
                        ctx_batched: bool, impl: str = "pallas"):
    """One pool segment on a ``Packed`` pool (``s`` supplies the task
    lists): ONE K3 launch on a CUDA tensor, the plain version on a CPU
    one.  Returns ``(Packed, board)``; the run loop calls this once per
    segment."""
    if use_kernel(impl, p.scal.device):
        out, board = lane_launch(g, cfg, s.tasks, p, steps_per_call,
                                 lanes=s.tasks.shape[0],
                                 ctx_batched=ctx_batched)
        resident_pool_segment.launches += 1
        return out, board
    from repro_torch.kernels.resident_pool.ref import (
        resident_pool_segment_ref)
    start, budget = p.scal[:, S_START], p.scal[:, S_BUDGET]
    st, board = resident_pool_segment_ref(
        g, cfg, unpack(s, p), start=start, budget=budget,
        steps_per_call=steps_per_call, ctx_batched=ctx_batched)
    return pack(st, start, budget), board


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
