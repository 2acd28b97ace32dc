"""Plain torch-op version of the pool segment.

Twin of ``src/repro/kernels/resident_pool/ref.py``: every lane advanced
by ``steps_per_call`` guarded torch-op steps (the lane dim is explicit,
where the reference vmaps the single-lane oracle), and the scoreboard
recomputed from the before/after states with the kernel's formulas.
"""
from __future__ import annotations

import dataclasses

import torch


def resident_pool_segment_ref(g, cfg, s, *, start, budget,
                              steps_per_call: int = 1,
                              ctx_batched: bool = False):
    """Returns ``(state, board)`` like the kernel wrapper."""
    from repro_torch.core import engine_dense as ed

    cfg_jnp = dataclasses.replace(cfg, kernel_impl="jnp")
    s2 = ed.guarded_steps(g, cfg_jnp, s, start=start, budget=budget,
                          n_steps=steps_per_call, ctx_batched=ctx_batched)
    adv = s2.steps - s.steps
    board = torch.stack([ed._done(s2).to(torch.int32),
                         steps_per_call - adv], dim=1).to(torch.int32)
    return s2, board
