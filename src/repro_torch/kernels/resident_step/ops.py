"""Dispatch wrapper for the resident multi-step segment kernel (one lane).

Twin of ``src/repro/kernels/resident_step/ops.py``.  It replaces the
Pallas kernel ``src/repro/kernels/resident_step/kernel.py:resident_kernel``
(built by ``make_resident_call``) with the CUDA lane body in
``csrc/resident_lane.cuh``, launched by ``rt_resident_step``
(``csrc/resident_step.cu``) on a grid of one block.

``resident_segment(g, cfg, s, ...)`` advances one dense-engine lane by up
to ``steps_per_call`` guarded steps in ONE launch and returns a fresh
``DenseState``; on a CPU tensor it runs the plain version (``ref.py``).
``packed_segment`` is the same decision on a ``Packed`` state, for the
engine's run loop.
Every single-lane launch (``lane_launch(lanes=None)``, the one place
``rt_resident_step`` is called) adds one to ``resident_segment.launches``.

The state travels as a ``Packed`` block: the twelve cursor scalars in
one (..., 16) int32 row (``S_*`` slots; ``cs`` as its int32 bit pattern)
plus the eight stacks.  The engine's run loops pack once, launch many
times and unpack once, so per-segment host work is one launch.

**Residency gate, re-derived for Hopper** (``resident_supported``).  The
TPU kernel kept the whole lane state in ~6 MiB of VMEM.  An H100 block
has at most 232,448 B of shared memory, and one lane's ``cstack`` alone
is 4·(n_u+2)·n_u bytes (1,052,672 B at n_u = 512).  So the CUDA design
keeps the stacks, ``xstack`` and the collect buffers in device memory
(hot rows stay in L2) and holds only the working set in shared memory:

    reduction scratch 33·8 B (rounded to 272) + 32 scalars·4 B
    + rows L, L' (2·WV) and P, P', Q, R, full, part, nz, R' (8·WU) words
    + the counts row c2 (NU int32)               -> ``resident_smem_base``

plus, only when it also fits, the adjacency itself (NU·WV·4 B: 128 KB at
512 x 2048 stays on chip; 512 KB at 1024 x 4096 is read from device
memory/L2).  The gate is ``resident_smem_base <= 232,448`` (n_u up to
about 55,000 at n_v = n_u) and the lanes' device-memory footprint
(input + output state per launch) under ``DEVICE_STATE_BYTES``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import (MAX_SMEM_BYTES, plan_blocks,
                                          use_kernel)

S_LVL, S_FORCED, S_TPOS, S_STEPS, S_NODES, S_NMAX, S_MAXFAIL, S_CS, \
    S_OUTN, S_NTASKS, S_START, S_BUDGET = range(12)
SCAL_SLOTS = 16

ORDER_MODES = {"deg": 0, "deg_nocache": 1, "input": 2}
LANE_THREADS = 512

# device memory the lane state of one launch may take (input + output
# copies of every lane): far below 80 GB, a guard against absurd pools
DEVICE_STATE_BYTES = 16 << 30


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def resident_smem_base(cfg) -> int:
    """Shared-memory bytes of the lane kernel WITHOUT the staged
    adjacency (``csrc/resident_lane.cuh:lane_smem_layout``)."""
    words = 2 * cfg.wv + 8 * cfg.wu + cfg.n_u
    return _round_up(272 + 4 * 32 + 4 * words, 16)


def resident_stage_adj(cfg) -> bool:
    """Whether the adjacency is staged in shared memory too."""
    return resident_smem_base(cfg) + 4 * cfg.n_u * cfg.wv <= MAX_SMEM_BYTES


def resident_smem_bytes(cfg) -> int:
    return resident_smem_base(cfg) + (
        4 * cfg.n_u * cfg.wv if resident_stage_adj(cfg) else 0)


def resident_state_bytes(cfg, t_len: int | None = None,
                         lanes: int = 1) -> int:
    """Device-memory bytes one launch touches for ``lanes`` lanes: the
    context once plus every lane's state and collect buffers, read once
    (input) and written once (fresh output)."""
    t = cfg.n_u if t_len is None else t_len
    ctx = cfg.n_u * cfg.wv + 3 * cfg.n_u + cfg.wv
    state = cfg.depth * (cfg.wv + cfg.n_u + 3 * cfg.wu + 1) + t
    out = cfg.collect_cap * (cfg.wv + cfg.wu) + SCAL_SLOTS
    return 4 * (ctx + lanes * 2 * (state + out))


def resident_supported(cfg, t_len: int | None = None,
                       lanes: int = 1) -> bool:
    """Whether the lane kernel can run ``lanes`` lanes of ``cfg``."""
    return (resident_smem_base(cfg) <= MAX_SMEM_BYTES
            and resident_state_bytes(cfg, t_len, lanes)
            <= DEVICE_STATE_BYTES)


class Packed(NamedTuple):
    """Kernel-side lane state: the scalar block + the mutable stacks (the
    read-only task list travels separately)."""
    scal: torch.Tensor      # (..., 16) int32
    lmask: torch.Tensor     # (..., D, WV)
    cstack: torch.Tensor    # (..., D, NU)
    pmask: torch.Tensor     # (..., D, WU)
    qmask: torch.Tensor
    rmask: torch.Tensor
    xstack: torch.Tensor    # (..., D)
    out_l: torch.Tensor     # (..., C, WV)
    out_r: torch.Tensor     # (..., C, WU)


def pack(s, start, budget) -> Packed:
    """DenseState (+ run-loop start/budget) -> ``Packed``."""
    lead = tuple(s.lvl.shape)
    dev = s.lvl.device

    def col(v):
        return torch.as_tensor(v, dtype=torch.int32,
                               device=dev).expand(lead)

    zero = torch.zeros(lead, dtype=torch.int32, device=dev)
    scal = torch.stack(
        [col(s.lvl), col(s.forced_x), col(s.tpos), col(s.steps),
         col(s.nodes), col(s.n_max), col(s.max_fail), col(s.cs),
         col(s.out_n), col(s.n_tasks), col(start), col(budget),
         zero, zero, zero, zero], dim=-1)
    return Packed(scal, s.lmask, s.cstack, s.pmask, s.qmask, s.rmask,
                  s.xstack, s.out_l, s.out_r)


def unpack(s, p: Packed):
    """``Packed`` -> DenseState (task list taken from ``s``)."""
    sc = p.scal
    return s._replace(
        lmask=p.lmask, cstack=p.cstack, pmask=p.pmask, qmask=p.qmask,
        rmask=p.rmask, xstack=p.xstack, out_l=p.out_l, out_r=p.out_r,
        lvl=sc[..., S_LVL], forced_x=sc[..., S_FORCED],
        tpos=sc[..., S_TPOS], steps=sc[..., S_STEPS],
        nodes=sc[..., S_NODES], n_max=sc[..., S_NMAX],
        max_fail=sc[..., S_MAXFAIL], cs=sc[..., S_CS],
        out_n=sc[..., S_OUTN])


def _fresh_like(p: Packed) -> Packed:
    """Fresh output blocks for a launch: ONE allocation carved into
    16-byte-aligned views (launches stay functional: the input state is
    never written)."""
    sizes = [t.numel() for t in p]
    offs, total = [], 0
    for n in sizes:
        offs.append(total)
        total += _round_up(n, 4)
    flat = torch.empty(total, dtype=torch.int32, device=p.scal.device)
    return Packed(*[flat[o:o + t.numel()].view(t.shape)
                    for o, t in zip(offs, p)])


def _check(t, name, shape, dev):
    if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape) \
            or t.device != dev or not t.is_contiguous():
        raise ValueError(
            f"resident kernel: {name} must be a contiguous int32 tensor of "
            f"shape {tuple(shape)} on {dev}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def lane_launch(g, cfg, tasks, p: Packed, steps_per_call: int, *,
                lanes: int | None, ctx_batched: bool = False):
    """Launch the CUDA lane body: ``lanes=None`` is the single-lane entry
    (K2, ``rt_resident_step``), an int the pool entry (K3,
    ``rt_resident_pool``, grid = lanes, returns the scoreboard too).
    Returns ``(Packed, board | None)``."""
    dev = p.scal.device
    nu, wu, wv, D, C = cfg.n_u, cfg.wu, cfg.wv, cfg.depth, cfg.collect_cap
    lead = () if lanes is None else (lanes,)
    t_len = tasks.shape[-1]
    _check(tasks, "tasks", lead + (t_len,), dev)
    for name, t, shape in zip(
            Packed._fields, p,
            [(SCAL_SLOTS,), (D, wv), (D, nu), (D, wu), (D, wu), (D, wu),
             (D,), (C, wv), (C, wu)]):
        _check(t, name, lead + shape, dev)
    clead = lead if ctx_batched else ()
    _check(g.adj, "adj", clead + (nu, wv), dev)
    for name in ("order", "rank", "root_counts"):
        _check(getattr(g, name), name, clead + (nu,), dev)
    _check(g.l_root, "l_root", clead + (wv,), dev)
    if not resident_supported(cfg, t_len, lanes or 1):
        raise ValueError(f"resident kernel: config {cfg} exceeds the "
                         f"Hopper residency gate")
    out = _fresh_like(p)
    plan = plan_blocks(wv, threads=LANE_THREADS)
    lane_args = [
        p.scal.data_ptr(), g.adj.data_ptr(), g.order.data_ptr(),
        g.rank.data_ptr(), g.root_counts.data_ptr(), g.l_root.data_ptr(),
        int(ctx_batched), tasks.data_ptr(),
        *[t.data_ptr() for t in p[1:]],
        *[t.data_ptr() for t in out],
        nu, wu, wv, D, C, t_len, cfg.m_real, ORDER_MODES[cfg.order_mode],
        int(steps_per_call), plan.threads, plan.group,
        int(resident_stage_adj(cfg)), resident_smem_bytes(cfg)]
    lib = _build.library()
    stream = _build.stream_ptr(dev)
    if lanes is None:
        rc = lib.rt_resident_step(*lane_args, stream)
        _build.check(rc, "resident_step launch")
        resident_segment.launches += 1
        return out, None
    board = torch.empty((lanes, 2), dtype=torch.int32, device=dev)
    rc = lib.rt_resident_pool(board.data_ptr(), *lane_args, lanes, stream)
    _build.check(rc, "resident_pool launch")
    return out, board


def packed_segment(g, cfg, s, p: Packed, steps_per_call: int, *,
                   impl: str = "pallas") -> Packed:
    """One single-lane segment on a ``Packed`` state (``s`` supplies the
    task list): the kernel on a CUDA tensor, the plain version on a CPU
    one.  The run loop calls this once per segment."""
    if use_kernel(impl, p.scal.device):
        return lane_launch(g, cfg, s.tasks, p, steps_per_call, lanes=None)[0]
    from repro_torch.kernels.resident_step.ref import resident_segment_ref
    start, budget = p.scal[..., S_START], p.scal[..., S_BUDGET]
    st = resident_segment_ref(g, cfg, unpack(s, p), start=start,
                              budget=budget, steps_per_call=steps_per_call)
    return pack(st, start, budget)


def resident_segment(g, cfg, s, *, start, budget, steps_per_call: int = 1,
                     impl: str = "pallas"):
    """Advance lane state ``s`` by up to ``steps_per_call`` engine steps,
    each guarded by ``~done & (steps - start < budget)``."""
    return unpack(s, packed_segment(g, cfg, s, pack(s, start, budget),
                                    steps_per_call, impl=impl))


resident_segment.launches = 0
