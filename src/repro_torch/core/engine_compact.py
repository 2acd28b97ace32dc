"""Compact-array MBE engine on torch tensors — the paper-faithful one.

Twin of ``src/repro/core/engine_compact.py``: cuMBE's compact array
(§III-B, Fig. 3) — ``P`` one permutation of U with a level pointer per
depth (the live candidates at level l are ``P[0 : p_ptr[l]]``), the
lookup table ``lookup[v]`` = position of v in P, the append-only ``Q``
with per-level counts ``q_ptr``, and R as a per-level bitmask stack.
Every ``CompactState`` leaf and the write order of each branch are the
reference's, bit for bit.

What changed in the translation (as in ``engine_dense``):

* **Lanes are explicit.**  ``_step_lanes`` computes the three branch
  deltas (backtrack, init task, candidate) for every lane, selects per
  lane by ``_case_id`` on the device and guards each lane by
  ``~done & (steps - start < budget)``; no host sync inside a segment.
  The run loop is the engines' shared ``engine_dense._torch_loop``.
* **Index semantics are written out.**  A JAX gather clamps an
  out-of-range index (a negative one wraps once) and ``.at[i].set`` drops
  an out-of-range write; torch raises instead.  Each gather and scatter
  below says which case it is in: provably in range, or clamped/dropped
  explicitly (``_put``).
* **Kernel paths follow the tensors' device** (``cfg.fused_on``).  The
  kernel path makes ONE launch per call site for all lanes:
  ``fused_select_gathered_prefix`` over ``adj[P]`` and
  ``fused_check_gathered_prefix2`` over ``adj[Q ++ P']``, both reading
  the rows through the index vector (K6) instead of gathering them.  The
  unfused path calls ``intersect_count`` with ``idx`` (K5 with
  ``impl="pallas"`` on the card).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import bitset
from repro_torch.core.engine_dense import (  # shared cfg and lane helpers
    EngineConfig, _add_u32, _done, _gather, _lanes, _leaf_to_torch, _owned,
    _setrow, _torch_loop, _unlane, make_config)
# the NumPy bridge back serves both engines' states (word leaves as uint32)
from repro_torch.core.engine_dense import state_to_numpy  # noqa: F401
from repro_torch.core.graph import BipartiteGraph
from repro_torch.kernels.dispatch import check_device
from repro_torch.kernels.fused_check.ops import fused_check_gathered_prefix2
from repro_torch.kernels.fused_select.ops import fused_select_gathered_prefix
from repro_torch.kernels.intersect_count.ops import intersect_count

_INF = 0x7FFFFFFF
_I32 = torch.int32


class CompactContext(NamedTuple):
    adj: torch.Tensor        # (NU, WV) int32 words
    order: torch.Tensor      # (NU,) root order (degree ascending), -1 pad
    p_static: torch.Tensor   # (NU,) initial P layout (reversed order)
    lk_static: torch.Tensor  # (NU,) lookup for p_static
    q_static: torch.Tensor   # (NU,) initial Q layout (= order)
    l_root: torch.Tensor     # (WV,) int32 words


class CompactState(NamedTuple):
    P: torch.Tensor          # (NU,) the compact array
    lookup: torch.Tensor     # (NU,) the lookup table
    p_ptr: torch.Tensor      # (D,) level pointers
    Q: torch.Tensor          # (NU,) append-only compact array
    q_ptr: torch.Tensor      # (D,)
    lmask: torch.Tensor      # (D, WV)
    rmask: torch.Tensor      # (D, WU)
    xstack: torch.Tensor     # (D,)
    lvl: torch.Tensor
    forced_x: torch.Tensor
    tasks: torch.Tensor
    n_tasks: torch.Tensor
    tpos: torch.Tensor
    steps: torch.Tensor
    nodes: torch.Tensor
    n_max: torch.Tensor
    max_fail: torch.Tensor
    cs: torch.Tensor         # () int32 pattern of the uint32 fingerprint
    out_n: torch.Tensor
    out_l: torch.Tensor      # (C, WV)
    out_r: torch.Tensor      # (C, WU)


# ---------------------------------------------------------------------------
# host-side setup and NumPy bridges
# ---------------------------------------------------------------------------

def make_context(g: BipartiteGraph, cfg: EngineConfig,
                 device="cuda") -> CompactContext:
    """The reference's ``make_context`` (same NumPy arithmetic), placed on
    ``device`` (the card unless the caller asks for the CPU)."""
    assert g.n_u <= cfg.n_u and g.n_v <= cfg.n_v
    adj = np.zeros((cfg.n_u, cfg.wv), dtype=np.uint32)
    src_rows = np.asarray(g.adj_u, dtype=np.uint32)
    adj[: g.n_u, : src_rows.shape[1]] = src_rows
    deg = np.unpackbits(adj[: g.n_u].view(np.uint8), axis=1) \
        .sum(axis=1, dtype=np.int64)
    order_real = np.argsort(deg, kind="stable").astype(np.int32)
    m = g.n_u
    order = np.full(cfg.n_u, -1, dtype=np.int32)
    order[:m] = order_real
    p_static = np.arange(cfg.n_u, dtype=np.int32)
    p_static[:m] = order_real[::-1]
    p_static[m:] = np.setdiff1d(np.arange(cfg.n_u, dtype=np.int32),
                                order_real)
    lk_static = np.empty(cfg.n_u, dtype=np.int32)
    lk_static[p_static] = np.arange(cfg.n_u, dtype=np.int32)
    q_static = np.arange(cfg.n_u, dtype=np.int32)
    q_static[:m] = order_real
    l_root = np.zeros(cfg.wv, dtype=np.uint32)
    fm = bitset.full_mask(g.n_v)
    l_root[: fm.shape[0]] = fm
    return context_from_numpy(
        CompactContext(adj=adj, order=order, p_static=p_static,
                       lk_static=lk_static, q_static=q_static,
                       l_root=l_root), device)


def init_state(cfg: EngineConfig, tasks: np.ndarray,
               device="cuda") -> CompactState:
    """Fresh worker state with a task list (indices into the root order)
    on ``device``."""
    device = check_device(device)
    t = np.full(max(len(tasks), 1), -1, dtype=np.int32)
    t[: len(tasks)] = np.asarray(tasks, dtype=np.int32)
    D, WU, WV, C, NU = cfg.depth, cfg.wu, cfg.wv, cfg.collect_cap, cfg.n_u

    def z(*shape):
        return torch.zeros(shape, dtype=_I32, device=device)

    def sc(v):
        return torch.tensor(v, dtype=_I32, device=device)

    return CompactState(
        P=torch.arange(NU, dtype=_I32, device=device),
        lookup=torch.arange(NU, dtype=_I32, device=device),
        p_ptr=z(D), Q=z(NU), q_ptr=z(D), lmask=z(D, WV), rmask=z(D, WU),
        xstack=torch.full((D,), -1, dtype=_I32, device=device),
        lvl=sc(-1), forced_x=sc(-1),
        tasks=torch.from_numpy(t).to(device), n_tasks=sc(len(tasks)),
        tpos=sc(0), steps=sc(0), nodes=sc(0), n_max=sc(0), max_fail=sc(0),
        cs=sc(0), out_n=sc(0), out_l=z(C, WV), out_r=z(C, WU))


def context_from_numpy(leaves, device="cuda") -> CompactContext:
    """Any object with the ``CompactContext`` fields as arrays (NumPy, or
    a reference context after ``np.asarray``) -> port tensors on
    ``device``."""
    device = check_device(device)
    return CompactContext(*[_leaf_to_torch(f, getattr(leaves, f), device)
                            for f in CompactContext._fields])


def state_from_numpy(leaves, device="cuda") -> CompactState:
    """Any object with the ``CompactState`` fields as arrays -> port state
    on ``device`` (uint32 words become int32 bit patterns)."""
    device = check_device(device)
    return CompactState(*[_leaf_to_torch(f, getattr(leaves, f), device)
                          for f in CompactState._fields])


# ---------------------------------------------------------------------------
# one guarded engine step over a lane dim
# ---------------------------------------------------------------------------

def _put(t: torch.Tensor, ar: torch.Tensor, i: torch.Tensor,
         val: torch.Tensor, en: torch.Tensor) -> None:
    """In place: ``t[b, i[b]] = val[b]`` where ``en[b]``, with JAX's
    ``.at[i].set`` rule: a negative ``i`` wraps once, and a write still out
    of range is dropped."""
    size = t.shape[1]
    i = torch.where(i < 0, i + size, i)
    ok = en & (i >= 0) & (i < size)
    _setrow(t, ar, i.clamp(0, size - 1), val, ok)


def _candidate(g, cfg, s, ar, lvl_safe, batched):
    """The candidate branch (``_branch_candidate``) for every lane, read
    from the state before any write."""
    dev = s.lvl.device
    NU, WU = cfg.n_u, cfg.wu
    fused = cfg.fused_on(dev)
    pos = torch.arange(NU, dtype=_I32, device=dev)
    L = s.lmask[ar, lvl_safe]
    p = s.p_ptr[ar, lvl_safe]
    forced = s.forced_x >= 0
    pm1 = (p - 1).clamp(min=0)

    # step 1: candidate selection (through the compact array); i_x is a
    # position in [0, NU): < p <= NU, or 0
    if cfg.order_mode == "deg":
        if fused:
            # the (-1, INT_MAX) sentinel occurs only when p == 0, where
            # the result is discarded or the forced root overrides x
            i_x, _ = fused_select_gathered_prefix(g.adj, s.P, L, p,
                                                  impl="pallas")
            i_x = i_x.clamp(min=0)
        else:
            c_sel = intersect_count(g.adj, L, idx=s.P, impl=cfg.impl)
            i_x = torch.argmin(torch.where(pos < p[:, None], c_sel,
                                           torch.full_like(c_sel, _INF)),
                               dim=-1).to(_I32)
    else:
        i_x = pm1                           # pop from the region end
    # swap selected to region end, decrement pointer (skip when forced);
    # a, b are entries of the permutation P: vertices in [0, NU)
    a = s.P[ar, i_x]
    b = s.P[ar, pm1]
    P_sw = s.P.clone()
    P_sw[ar, i_x] = b
    P_sw[ar, pm1] = a
    lk_sw = s.lookup.clone()
    lk_sw[ar, b] = i_x
    lk_sw[ar, a] = pm1
    x = torch.where(forced, s.forced_x, a)
    f_col = forced[:, None]
    P1 = torch.where(f_col, s.P, P_sw)
    lookup1 = torch.where(f_col, s.lookup, lk_sw)
    p_work = torch.where(forced, p, p - 1)

    # step 2: L' (x >= 0: a forced root or an entry of P)
    Lp = L & _gather(g.adj, ar, x, batched)
    nLp = bitset.count(Lp)
    nonempty = nLp > 0

    # steps 3+4: maximality check via Q + maximal expansion via P'
    q_lvl = s.q_ptr[ar, lvl_safe]
    if fused:
        viol_f, full2, part2, _, _ = fused_check_gathered_prefix2(
            g.adj, torch.cat([s.Q, P1], dim=-1), Lp, nLp, q_lvl, p_work,
            impl="pallas")
        viol = viol_f & nonempty
        fullb = full2[:, NU:]                   # per-position flags
        partb = part2[:, NU:]
    else:
        n_col = nLp[:, None]
        c_q = intersect_count(g.adj, Lp, idx=s.Q, impl=cfg.impl)
        viol = torch.any((pos < q_lvl[:, None]) & (c_q == n_col),
                         dim=-1) & nonempty
        c_p = intersect_count(g.adj, Lp, idx=P1, impl=cfg.impl)
        act = pos < p_work[:, None]
        fullb = act & (c_p == n_col)
        partb = act & (c_p > 0) & (c_p < n_col)
    is_max = nonempty & ~viol
    # per-vertex flags: P1 is a permutation, so the scatter is unique
    fullv = torch.zeros_like(fullb).scatter_(-1, P1.long(), fullb)
    Rp = s.rmask[ar, lvl_safe] | bitset.singleton(x, WU) \
        | bitset.from_bool(fullv)
    has_child = is_max & torch.any(partb, dim=-1)

    # descend: stable-compact survivors to the region front
    key = torch.where(pos < p_work[:, None],
                      torch.where(partb, 0, 1), 2)
    perm = torch.argsort(key, dim=-1, stable=True)
    P_child = torch.gather(P1, -1, perm)
    lk_child = torch.zeros_like(s.lookup).scatter_(
        -1, P_child.long(), pos.expand_as(P_child).contiguous())
    hc = has_child[:, None]
    return dict(
        x=x, Lp=Lp, Rp=Rp, p=p, p_work=p_work, forced=forced, q_lvl=q_lvl,
        P2=torch.where(hc, P_child, P1),
        lookup2=torch.where(hc, lk_child, lookup1),
        n_part=partb.sum(dim=-1, dtype=_I32),
        has_child=has_child, is_max=is_max, viol=viol,
        cs_inc=bitset.pair_checksum(Lp, Rp))


def _step_lanes(g, cfg, s, act: torch.Tensor, batched: bool) -> None:
    """In place: one engine step on every lane of the batched state ``s``
    whose ``act`` flag is set (``step`` of the reference, the branch chosen
    per lane by ``_case_id``).  ``batched`` says whether ``g`` carries the
    lane dim too."""
    B = s.lvl.shape[0]
    dev = s.lvl.device
    D, C = cfg.depth, cfg.collect_cap
    ar = torch.arange(B, device=dev)
    lvl = s.lvl
    lvl_safe = lvl.clamp(min=0)
    # _case_id: p_empty comes from the level pointer, not a popcount
    p_empty = s.p_ptr[ar, lvl_safe] == 0
    back = p_empty & (s.forced_x < 0)
    c0 = act & (lvl >= 0) & back                    # backtrack
    c1 = act & (lvl < 0)                            # init task
    c2 = act & (lvl >= 0) & ~back                   # candidate

    # case 0: backtrack -- x (xstack[parent]) appended to Q at the parent
    # level; safe0 is in [0, D)
    nl0 = lvl - 1
    safe0 = nl0.clamp(min=0)
    do0 = c0 & (nl0 >= 0)
    qp0 = s.q_ptr[ar, safe0]
    x0 = s.xstack[ar, safe0]

    # case 1: initialise the next root task; tpos >= 0, the task index is
    # clipped into the root order
    T = s.tasks.shape[-1]
    idx = s.tasks[ar, s.tpos.clamp(max=T - 1)]
    x1 = _gather(g.order, ar, idx.clamp(0, cfg.n_u - 1), batched)

    # case 2: process a candidate (every lane; discarded outside c2)
    d = _candidate(g, cfg, s, ar, lvl_safe, batched)
    has = c2 & d["has_child"]
    child = (lvl + 1).clamp(max=D - 1)

    # apply: every branch writes only its own lanes; within the candidate
    # branch the reference's write order (p_ptr[lvl] before p_ptr[child],
    # q_ptr[child] before q_ptr[lvl])
    c1c, c2c = c1[:, None], c2[:, None]
    s.P.copy_(torch.where(c1c, g.p_static,
                          torch.where(c2c, d["P2"], s.P)))
    s.lookup.copy_(torch.where(c1c, g.lk_static,
                               torch.where(c2c, d["lookup2"], s.lookup)))
    s.Q.copy_(torch.where(c1c, g.q_static, s.Q))
    _put(s.Q, ar, qp0, x0, do0)                     # drop if qp0 >= NU
    _put(s.Q, ar, d["q_lvl"], d["x"], c2 & ~d["has_child"])
    zero = torch.zeros_like(lvl)
    _setrow(s.p_ptr, ar, zero, cfg.m_real - 1 - idx, c1)
    _setrow(s.p_ptr, ar, lvl_safe,
            torch.where(d["forced"], zero, d["p_work"]), c2)
    _setrow(s.p_ptr, ar, child, d["n_part"], has)
    _setrow(s.q_ptr, ar, safe0, qp0 + 1, do0)
    _setrow(s.q_ptr, ar, zero, idx, c1)
    _setrow(s.q_ptr, ar, child, d["q_lvl"], has)
    _setrow(s.q_ptr, ar, lvl_safe, d["q_lvl"] + 1, c2 & ~d["has_child"])
    _setrow(s.lmask, ar, torch.where(c1, zero, child),
            torch.where(c1c, g.l_root, d["Lp"]), c1 | has)
    _setrow(s.rmask, ar, torch.where(c1, zero, child),
            torch.where(c1c, torch.zeros_like(d["Rp"]), d["Rp"]), c1 | has)
    _setrow(s.xstack, ar, lvl_safe, d["x"], has)
    w_idx = s.out_n.clamp(max=C - 1)
    write = c2 & d["is_max"] & (s.out_n < C)
    _setrow(s.out_l, ar, w_idx, d["Lp"], write)
    _setrow(s.out_r, ar, w_idx, d["Rp"], write)

    hit = c2 & d["is_max"]
    s.cs.copy_(torch.where(hit, _add_u32(s.cs, d["cs_inc"]), s.cs))
    s.lvl.copy_(torch.where(c0, nl0, torch.where(
        c1, zero, torch.where(has, lvl + 1, lvl))))
    s.forced_x.copy_(torch.where(c1, x1, torch.where(
        c2, torch.full_like(lvl, -1), s.forced_x)))
    s.tpos.add_(c1.to(_I32))
    s.steps.add_(act.to(_I32))
    s.nodes.add_(c2.to(_I32))
    s.n_max.add_(hit.to(_I32))
    s.max_fail.add_((c2 & d["viol"]).to(_I32))
    s.out_n.add_(write.to(_I32))


def step(g: CompactContext, cfg: EngineConfig,
         s: CompactState) -> CompactState:
    """One engine step of an unbatched lane (functional)."""
    s1 = _owned(_lanes(s))
    _step_lanes(g, cfg, s1, torch.ones(1, dtype=torch.bool,
                                       device=s.lvl.device), batched=False)
    return _unlane(s1)


def run(g: CompactContext, cfg: EngineConfig, s: CompactState,
        max_steps: int | None = None, unroll: int = 1) -> CompactState:
    """Run one lane until done or the budget expires (resumable):
    segments of ``unroll`` guarded steps, one host read per segment."""
    budget = cfg.max_steps if max_steps is None else max_steps
    return _unlane(_torch_loop(g, cfg, _lanes(s), budget, unroll,
                               batched=False, step_lanes=_step_lanes))


def run_batch(g: CompactContext, cfg: EngineConfig, s: CompactState,
              max_steps: int | None = None, ctx_batched: bool = False,
              unroll: int = 1) -> CompactState:
    """``run`` over a leading lane dim: one graph shared by B workers
    (``ctx_batched=False``) or B graphs of one bucket (``True``)."""
    budget = cfg.max_steps if max_steps is None else max_steps
    return _torch_loop(g, cfg, s, budget, unroll, batched=ctx_batched,
                       step_lanes=_step_lanes)


def enumerate_compact(g: BipartiteGraph, order_mode: str = "deg",
                      collect_cap: int = 1, impl: str = "jnp",
                      kernel_impl: str = "auto",
                      device: str = "cuda") -> CompactState:
    """Full single-worker enumeration on ``device`` (the card unless the
    caller asks for the CPU). Returns the final CompactState."""
    dev = check_device(device)
    cfg = make_config(g, order_mode=order_mode, collect_cap=collect_cap,
                      impl=impl, kernel_impl=kernel_impl)
    ctx = make_context(g, cfg, dev)
    s0 = init_state(cfg, np.arange(g.n_u, dtype=np.int32), dev)
    out = run(ctx, cfg, s0)
    assert bool(_done(out)), "step budget exhausted"
    return out
