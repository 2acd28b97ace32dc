"""Dispatch wrapper for the resident multi-step segment kernel (one lane).

Twin of ``src/repro/kernels/resident_step/ops.py``.  It replaces the
Pallas kernel ``src/repro/kernels/resident_step/kernel.py:resident_kernel``
(built by ``make_resident_call``) with the CUDA lane body in
``csrc/resident_lane.cuh``, launched by ``rt_resident_step``
(``csrc/resident_step.cu``) for one lane.

The kernel advances the state it is handed IN PLACE.  ``LaneRun`` is one
run loop's handle on it: the operands are checked, the launch arguments
built (one ``LaneArgs`` struct, passed by pointer) and the scoreboard and
the "still active" flag allocated once, so each launch is one C call,
made with the state's device current (``dispatch.on_device``, as is the
flag read's stream sync).  On
a CPU tensor a launch runs the plain version (``ref.py``) and writes its
result into the same buffers.  The functional entries ``resident_segment``
and ``packed_segment`` clone the state once, then launch in place, as the
JAX package's functional API reads.  Every single-lane launch (in
``LaneRun.launch``, the one place ``rt_resident_step`` is called) adds one
to ``resident_segment.launches``.

The state travels as a ``Packed`` block: the twelve cursor scalars in
one (..., 16) int32 row (``S_*`` slots; ``cs`` as its int32 bit pattern)
plus the eight stacks.  The engine's run loops copy the caller's state
once, pack it, launch many times on it and unpack once.

**Residency gate, re-derived for Hopper** (``resident_supported``).  The
TPU kernel kept the whole lane state in ~6 MiB of VMEM.  An H100 block
has at most 232,448 B of shared memory, and one lane's ``cstack`` alone
is 4·(n_u+2)·n_u bytes (1,052,672 B at n_u = 512).  So the stacks,
``xstack`` and the collect buffers live in device memory, and shared
memory holds the working set of a CTA that owns ``rl`` rows:

    reduction scratch and the copy's mbarrier 704 B
    + L, L' (2·WV) and P, P', Q, R, R', nz (6·wl) words
    + the level's cstack row and the new counts (2·rl int32)
                                            -> ``resident_smem_base``

plus the CTA's rows of the adjacency (rl·WV·4 B).  At 512 x 2048 one CTA
holds all 128 KB of it (``resident_stage_adj``).  At 1024 x 4096 (512 KB)
the lane runs on a cluster of 4 CTAs, 256 rows each
(``resident_cluster``); an adjacency no cluster of 8 holds is read from
device memory by one CTA.  The gate is ``resident_smem_base <= 232,448``
(n_u up to about 25,700 at n_v = n_u) and the lanes' device-memory
footprint under ``DEVICE_STATE_BYTES``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import (MAX_SMEM_BYTES, on_device,
                                          use_kernel)

S_LVL, S_FORCED, S_TPOS, S_STEPS, S_NODES, S_NMAX, S_MAXFAIL, S_CS, \
    S_OUTN, S_NTASKS, S_START, S_BUDGET = range(12)
SCAL_SLOTS = 16

ORDER_MODES = {"deg": 0, "deg_nocache": 1, "input": 2}
CLUSTER_SIZES = (1, 2, 4, 8)
MAX_THREADS = 512
# csrc/resident_lane.cuh: reduction slots, cluster slots, mbarrier
SMEM_HEAD_BYTES = 704

# device memory the lane state of a run loop may take (the caller's state
# and the loop's private copy of every lane): far below 80 GB, a guard
# against absurd pools
DEVICE_STATE_BYTES = 16 << 30


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _smem_base(rows: int, wv: int) -> int:
    """``csrc/resident_lane.cuh:smem_base_bytes`` for a CTA of ``rows``."""
    wl = (rows + 31) // 32
    return _round_up(SMEM_HEAD_BYTES + 4 * (2 * wv + 6 * wl + 2 * rows), 16)


def resident_smem_base(cfg, cluster: int = 1) -> int:
    """Shared-memory bytes of one CTA of a ``cluster``-CTA lane WITHOUT
    its rows of the adjacency."""
    return _smem_base(cfg.n_u // cluster, cfg.wv)


def resident_stage_adj(cfg) -> bool:
    """Whether the whole adjacency fits one CTA's shared memory."""
    return resident_smem_base(cfg) + 4 * cfg.n_u * cfg.wv <= MAX_SMEM_BYTES


def resident_cluster(cfg) -> int:
    """CTAs per lane: 1 when the adjacency fits one CTA, else the fewest
    (2, 4 or 8) whose shared memory holds it, each CTA owning whole mask
    words of rows; 1 (adjacency read from device memory) when none
    does."""
    if resident_stage_adj(cfg):
        return 1
    for c in CLUSTER_SIZES[1:]:
        rows = cfg.n_u // c
        if cfg.n_u % (32 * c) == 0 and \
                resident_smem_base(cfg, c) + 4 * rows * cfg.wv \
                <= MAX_SMEM_BYTES:
            return c
    return 1


def resident_staged(cfg) -> bool:
    """Whether the lane's adjacency lives in shared memory (one CTA or a
    cluster)."""
    return resident_stage_adj(cfg) or resident_cluster(cfg) > 1


def resident_smem_bytes(cfg) -> int:
    c = resident_cluster(cfg)
    rows = cfg.n_u // c
    return resident_smem_base(cfg, c) + (
        4 * rows * cfg.wv if resident_staged(cfg) else 0)


def lane_threads(cfg) -> int:
    """Threads per CTA: one warp per 32 rows of the CTA's slice (the
    counts pass gives each lane one row), at least 128, at most 512; at
    512 x 2048 (512) and the 1024 x 4096 cluster (256 a CTA) the fastest
    of 128 / 256 / 512 in ``chip_smoke.py``'s sweep."""
    rows = cfg.n_u // resident_cluster(cfg)
    return max(128, min(MAX_THREADS, _round_up(rows, 32)))


def resident_state_bytes(cfg, t_len: int | None = None,
                         lanes: int = 1) -> int:
    """Device-memory bytes of a run loop over ``lanes`` lanes: the
    context once plus every lane's state and collect buffers twice (the
    caller's and the loop's private copy)."""
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
    """DenseState (+ run-loop start/budget) -> ``Packed``: a new scalar
    block; the stacks are ``s``'s own tensors."""
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
    """``Packed`` -> DenseState (task list taken from ``s``).  The cursor
    leaves are copied out of the scalar block (one copy), so no leaf
    aliases it."""
    lvl, forced_x, tpos, steps, nodes, n_max, max_fail, cs, out_n = \
        p.scal[..., :S_NTASKS].movedim(-1, 0).clone().unbind(0)
    return s._replace(
        lmask=p.lmask, cstack=p.cstack, pmask=p.pmask, qmask=p.qmask,
        rmask=p.rmask, xstack=p.xstack, out_l=p.out_l, out_r=p.out_r,
        lvl=lvl, forced_x=forced_x, tpos=tpos, steps=steps, nodes=nodes,
        n_max=n_max, max_fail=max_fail, cs=cs, out_n=out_n)


def clone_packed(p: Packed) -> Packed:
    return Packed(*[t.clone() for t in p])


def packed_active(p: Packed) -> torch.Tensor:
    """Per-lane ``~done & (steps - start < budget)`` of a ``Packed``."""
    sc = p.scal
    done = (sc[..., S_LVL] < 0) & (sc[..., S_TPOS] >= sc[..., S_NTASKS])
    return (~done) & (sc[..., S_STEPS] - sc[..., S_START]
                      < sc[..., S_BUDGET])


def _check(t, name, shape, dev):
    if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape) \
            or t.device != dev or not t.is_contiguous():
        raise ValueError(
            f"resident kernel: {name} must be a contiguous int32 tensor of "
            f"shape {tuple(shape)} on {dev}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


_PTRS = ("scal", "adj", "order", "rank", "rc", "lroot", "tasks", "lmask",
         "cstack", "pmask", "qmask", "rmask", "xstack", "outl", "outr",
         "board", "flag")
_INTS = ("nu", "wu", "wv", "depth", "cap", "t_len", "m_real", "order_mode",
         "spc", "ctx_batched", "lanes", "threads", "cluster", "staged",
         "smem_bytes")


class LaneArgs(ctypes.Structure):
    """``csrc/resident_lane.cuh:LaneArgs``, field for field."""
    _fields_ = [(n, ctypes.c_void_p) for n in _PTRS] + \
               [(n, ctypes.c_int) for n in _INTS]


class LaneRun:
    """One run loop's launches of the lane kernel on ``p``, which every
    launch advances IN PLACE by up to ``steps_per_call`` guarded steps.

    ``lanes=None`` is the single-lane entry (K2, ``rt_resident_step``); an
    int the pool entry (K3, ``rt_resident_pool``, which also fills the
    ``(lanes, 2)`` scoreboard).  ``s`` supplies the task list and
    ``n_tasks``; ``counter`` is the wrapper whose ``launches`` each launch
    adds one to.  ``flag``: the kernel also sets a host-mapped word when a
    lane is still active, so ``active()`` after a launch is one stream
    sync and one read.  ``threads`` overrides ``lane_threads``."""

    def __init__(self, g, cfg, s, p: Packed, steps_per_call: int, *,
                 lanes: int | None, counter, ctx_batched: bool = False,
                 impl: str = "pallas", flag: bool = True,
                 threads: int | None = None):
        self.g, self.cfg, self.s, self.p = g, cfg, s, p
        self.spc = int(steps_per_call)
        self.lanes, self.ctx_batched = lanes, ctx_batched
        self.counter = counter
        self.board = None
        self.launched = False
        dev = p.scal.device
        self.kernel = use_kernel(impl, dev)
        if not self.kernel:
            return
        nu, wu, wv, D, C = cfg.n_u, cfg.wu, cfg.wv, cfg.depth, \
            cfg.collect_cap
        lead = () if lanes is None else (lanes,)
        tasks = s.tasks
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
        if lanes is not None:
            self.board = torch.empty((lanes, 2), dtype=torch.int32,
                                     device=dev)
        self.flag = (torch.zeros(1, dtype=torch.int32, pin_memory=True)
                     if flag else None)
        self.flag_word = None if self.flag is None else self.flag.numpy()
        a = LaneArgs()
        for name, t in (("scal", p.scal), ("adj", g.adj),
                        ("order", g.order), ("rank", g.rank),
                        ("rc", g.root_counts), ("lroot", g.l_root),
                        ("tasks", tasks), ("lmask", p.lmask),
                        ("cstack", p.cstack), ("pmask", p.pmask),
                        ("qmask", p.qmask), ("rmask", p.rmask),
                        ("xstack", p.xstack), ("outl", p.out_l),
                        ("outr", p.out_r), ("board", self.board),
                        ("flag", self.flag)):
            setattr(a, name, None if t is None else t.data_ptr())
        a.nu, a.wu, a.wv, a.depth, a.cap = nu, wu, wv, D, C
        a.t_len, a.m_real = t_len, cfg.m_real
        a.order_mode, a.spc = ORDER_MODES[cfg.order_mode], self.spc
        a.ctx_batched, a.lanes = int(ctx_batched), lanes or 1
        a.threads = threads or lane_threads(cfg)
        a.cluster = resident_cluster(cfg)
        a.staged = int(resident_staged(cfg))
        a.smem_bytes = resident_smem_bytes(cfg)
        self.args = a
        self.addr = ctypes.addressof(a)
        lib = _build.library()
        self.fn = lib.rt_resident_step if lanes is None \
            else lib.rt_resident_pool
        self.what = "resident_step launch" if lanes is None \
            else "resident_pool launch"
        self.device = dev
        self.stream = torch.cuda.current_stream(dev)
        self.stream_ptr = self.stream.cuda_stream
        self.seq = 0

    def launch(self):
        """One segment, in place.  Returns the scoreboard (pool) or
        None."""
        self.launched = True
        if not self.kernel:
            return self._plain()
        self.seq = self.seq % 0x7FFFFFFE + 1
        with on_device(self.device):
            rc = self.fn(self.addr, self.seq, self.stream_ptr)
        if rc:
            _build.check(rc, self.what)
        self.counter.launches += 1
        return self.board

    def active(self, fresh: bool = False) -> bool:
        """Whether any lane is still active: after a kernel launch the
        flag it set (one stream sync, one host read), else (or with
        ``fresh``, after the caller changed the budgets) computed from
        the scalar block."""
        if self.kernel and self.launched and not fresh \
                and self.flag is not None:
            with on_device(self.device):
                self.stream.synchronize()
            return int(self.flag_word[0]) == self.seq
        return bool(packed_active(self.p).any())

    def _plain(self):
        """The plain version on CPU tensors, written into ``p``."""
        p, sc = self.p, self.p.scal
        start, budget = sc[..., S_START], sc[..., S_BUDGET]
        st = unpack(self.s, p)
        if self.lanes is None:
            from repro_torch.kernels.resident_step.ref import (
                resident_segment_ref)
            st = resident_segment_ref(self.g, self.cfg, st, start=start,
                                      budget=budget,
                                      steps_per_call=self.spc)
            board = None
        else:
            from repro_torch.kernels.resident_pool.ref import (
                resident_pool_segment_ref)
            st, board = resident_pool_segment_ref(
                self.g, self.cfg, st, start=start, budget=budget,
                steps_per_call=self.spc, ctx_batched=self.ctx_batched)
        for dst, src in zip(p, pack(st, start, budget)):
            dst.copy_(src)
        return board


def lane_run(g, cfg, s, p: Packed, steps_per_call: int, *,
             impl: str = "pallas", **kw) -> LaneRun:
    """The single-lane run loop's handle on K2 (see ``LaneRun``)."""
    return LaneRun(g, cfg, s, p, steps_per_call, lanes=None,
                   counter=resident_segment, impl=impl, **kw)


def packed_segment(g, cfg, s, p: Packed, steps_per_call: int, *,
                   impl: str = "pallas") -> Packed:
    """One single-lane segment on a ``Packed`` state (``s`` supplies the
    task list), functional: ``p`` is cloned once, then advanced in place
    (the kernel on a CUDA tensor, the plain version on a CPU one)."""
    q = clone_packed(p)
    lane_run(g, cfg, s, q, steps_per_call, impl=impl, flag=False).launch()
    return q


def resident_segment(g, cfg, s, *, start, budget, steps_per_call: int = 1,
                     impl: str = "pallas"):
    """Advance lane state ``s`` by up to ``steps_per_call`` engine steps,
    each guarded by ``~done & (steps - start < budget)`` (functional)."""
    return unpack(s, packed_segment(g, cfg, s, pack(s, start, budget),
                                    steps_per_call, impl=impl))


resident_segment.launches = 0
