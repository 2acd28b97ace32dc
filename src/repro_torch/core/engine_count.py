"""(p,q)-biclique counting engine on torch tensors.

Twin of ``src/repro/core/engine_count.py``: counts the pairs (R ⊆ U,
L ⊆ V) with |R| = p, |L| = q and every edge of R × L present, without
materializing any: the whole answer is one scalar accumulator.  Root
task i holds the p-subsets of U whose minimum-order member is root i; a
combination DFS pops the first candidate, shrinks L' = L ∩ N(x), adds
C(|L'|, q) from a host-made lookup table at depth p and descends only
while the branch is still viable.  Every ``CountState`` leaf and the
write order of each branch are the reference's, bit for bit.

What changed in the translation (as in ``engine_dense``): lanes are an
explicit leading dim and ``_step_lanes`` computes the three branches
(backtrack, init task, candidate) for every lane and selects per lane on
the device; the run loop is the engines' shared
``engine_dense._torch_loop``.  No kernel is on this engine's path, in
the reference either.  The counter is int32 and wraps past 2**31 - 1 as
the reference's does (the sum is taken in int64 and wrapped explicitly).

Registered as ``"count"`` (lazily, on the first registry lookup that
misses).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import bitset
from repro_torch.core.engine import Engine, register_engine
from repro_torch.core.engine_dense import (EngineConfig, _gather, _lanes,
                                           _leaf_to_torch, _owned, _setrow,
                                           _unlane)
from repro_torch.core.graph import BipartiteGraph
from repro_torch.core.results import CountResult
from repro_torch.kernels.dispatch import check_device

_I32 = torch.int32
_I32_MAX = np.iinfo(np.int32).max


class CountContext(NamedTuple):
    adj: torch.Tensor       # (NU, WV) int32 words
    order: torch.Tensor     # (NU,) root order (degree ascending), -1 pad
    rank: torch.Tensor      # (NU,) rank[v]; padding vertices 2*NU
    binom_q: torch.Tensor   # (NV+1,) C(k, q), clamped at int32 max


class CountState(NamedTuple):
    lmask: torch.Tensor     # (D, WV) common neighborhood per level
    pmask: torch.Tensor     # (D, WU) remaining candidates per level
    lvl: torch.Tensor       # () -1 = between tasks; r = lvl+1 chosen
    tasks: torch.Tensor     # (T,)
    n_tasks: torch.Tensor
    tpos: torch.Tensor
    steps: torch.Tensor
    nodes: torch.Tensor
    count: torch.Tensor     # () int32 accumulator


# ---------------------------------------------------------------------------
# host-side setup and NumPy bridges
# ---------------------------------------------------------------------------

def make_context(g: BipartiteGraph, cfg: EngineConfig,
                 device="cuda") -> CountContext:
    """The reference's ``make_context`` (same NumPy arithmetic), placed on
    ``device``."""
    assert g.n_u <= cfg.n_u and g.n_v <= cfg.n_v
    _, q = cfg.count_pq
    adj = np.zeros((cfg.n_u, cfg.wv), dtype=np.uint32)
    src = np.asarray(g.adj_u, dtype=np.uint32)
    adj[: g.n_u, : src.shape[1]] = src
    deg = np.unpackbits(adj[: g.n_u].view(np.uint8), axis=1) \
        .sum(axis=1, dtype=np.int64)
    order_real = np.argsort(deg, kind="stable").astype(np.int32)
    order = np.full(cfg.n_u, -1, dtype=np.int32)
    order[: g.n_u] = order_real
    rank = np.full(cfg.n_u, 2 * cfg.n_u, dtype=np.int32)
    rank[order_real] = np.arange(g.n_u, dtype=np.int32)
    binom = np.array([min(math.comb(k, q), _I32_MAX) if k >= q else 0
                      for k in range(cfg.n_v + 1)], dtype=np.int32)
    return context_from_numpy(
        CountContext(adj=adj, order=order, rank=rank, binom_q=binom),
        device)


def init_state(cfg: EngineConfig, tasks: np.ndarray,
               device="cuda") -> CountState:
    """Fresh worker state with a task list on ``device``."""
    device = check_device(device)
    t = np.full(max(len(tasks), 1), -1, dtype=np.int32)
    t[: len(tasks)] = np.asarray(tasks, dtype=np.int32)

    def sc(v):
        return torch.tensor(v, dtype=_I32, device=device)

    return CountState(
        lmask=torch.zeros((cfg.depth, cfg.wv), dtype=_I32, device=device),
        pmask=torch.zeros((cfg.depth, cfg.wu), dtype=_I32, device=device),
        lvl=sc(-1), tasks=torch.from_numpy(t).to(device),
        n_tasks=sc(len(tasks)), tpos=sc(0), steps=sc(0), nodes=sc(0),
        count=sc(0))


def context_from_numpy(leaves, device="cuda") -> CountContext:
    """Any object with the ``CountContext`` fields as arrays -> port
    tensors on ``device``."""
    device = check_device(device)
    return CountContext(*[_leaf_to_torch(f, getattr(leaves, f), device)
                          for f in CountContext._fields])


def state_from_numpy(leaves, device="cuda") -> CountState:
    """Any object with the ``CountState`` fields as arrays -> port state
    on ``device``."""
    device = check_device(device)
    return CountState(*[_leaf_to_torch(f, getattr(leaves, f), device)
                        for f in CountState._fields])


# ---------------------------------------------------------------------------
# one guarded engine step over a lane dim
# ---------------------------------------------------------------------------

def _binom(g, ar, k, cfg, batched):
    """``binom_q[clip(k, 0, NV)]`` per lane."""
    return _gather(g.binom_q, ar, k.clamp(0, cfg.n_v), batched)


def _step_lanes(g, cfg, s, act: torch.Tensor, batched: bool) -> None:
    """In place: one engine step on every lane of the batched state ``s``
    whose ``act`` flag is set (``step`` of the reference, the branch
    chosen per lane by ``_case_id``).  ``batched``: ``g`` carries the lane
    dim too."""
    p, q = cfg.count_pq
    B = s.lvl.shape[0]
    dev = s.lvl.device
    NU, D = cfg.n_u, cfg.depth
    ar = torch.arange(B, device=dev)
    lvl = s.lvl
    lvl_safe = lvl.clamp(min=0)
    pm = s.pmask[ar, lvl_safe]
    p_empty = bitset.count(pm) == 0
    c0 = act & (lvl >= 0) & p_empty                  # backtrack
    c1 = act & (lvl < 0)                             # init task
    c2 = act & (lvl >= 0) & ~p_empty                 # candidate
    zero = torch.zeros_like(lvl)

    # case 1: initialise the next root task
    T = s.tasks.shape[-1]
    idx = s.tasks[ar, s.tpos.clamp(max=T - 1)]
    x1 = _gather(g.order, ar, idx.clamp(0, NU - 1), batched)
    L0 = _gather(g.adj, ar, x1, batched)             # -1 wraps, as in JAX
    nL0 = bitset.count(L0)
    idx_col = idx[:, None]
    P0 = bitset.from_bool((g.rank > idx_col) & (g.rank < cfg.m_real))
    if p == 1:
        inc1 = _binom(g, ar, nL0, cfg, batched)
        P0 = torch.zeros_like(P0)
    else:
        inc1 = zero
        P0 = torch.where((nL0 >= q)[:, None], P0, torch.zeros_like(P0))

    # case 2: process a candidate (the first member of P)
    x = bitset.first_member(pm)
    pm_after = pm & ~bitset.singleton(x.clamp(min=0), cfg.wu)
    Lp = s.lmask[ar, lvl_safe] & _gather(g.adj, ar, x.clamp(0, NU - 1),
                                         batched)
    nLp = bitset.count(Lp)
    at_p = (lvl + 2) == p
    inc2 = torch.where(at_p, _binom(g, ar, nLp, cfg, batched), zero)
    need = p - (lvl + 2)
    viable = ~at_p & (nLp >= q) & (bitset.count(pm_after) >= need)
    child = (lvl + 1).clamp(max=D - 1)

    # apply in the reference's write order: lmask[child]; pmask[lvl]
    # before pmask[child] (child == lvl at the last level)
    has = c2 & viable
    _setrow(s.lmask, ar, torch.where(c1, zero, child),
            torch.where(c1[:, None], L0, Lp), c1 | has)
    _setrow(s.pmask, ar, lvl_safe, pm_after, c2)
    _setrow(s.pmask, ar, torch.where(c1, zero, child),
            torch.where(c1[:, None], P0, pm_after), c1 | has)
    inc = torch.where(c1, inc1, torch.where(c2, inc2, zero))
    s.count.copy_(bitset.wrap32(s.count.to(torch.int64)
                                + inc.to(torch.int64)))
    s.lvl.copy_(torch.where(c0, lvl - 1, torch.where(
        c1, zero, torch.where(has, lvl + 1, lvl))))
    s.tpos.add_(c1.to(_I32))
    s.steps.add_(act.to(_I32))
    s.nodes.add_((c1 | c2).to(_I32))


def step(g: CountContext, cfg: EngineConfig, s: CountState) -> CountState:
    """One engine step of an unbatched lane (functional)."""
    s1 = _owned(_lanes(s))
    _step_lanes(g, cfg, s1, torch.ones(1, dtype=torch.bool,
                                       device=s.lvl.device), batched=False)
    return _unlane(s1)


# ---------------------------------------------------------------------------
# the Engine registration
# ---------------------------------------------------------------------------

class CountEngine(Engine):
    """(p,q)-biclique counting: scalar accumulator, no collect buffers."""

    name = "count"
    result_type = CountResult
    collectable = False
    canonicalize = False        # (p, q) is side-specific

    def config(self, n_u, n_v, depth, *, m_real=None, **kw):
        kw.setdefault("count_pq", (2, 2))
        p, q = kw["count_pq"]
        if p < 1 or q < 1:
            raise ValueError(f"count engine needs p >= 1 and q >= 1, "
                             f"got (p, q) = ({p}, {q})")
        kw["collect_cap"] = 1   # nothing is materialized
        return super().config(n_u, n_v, depth, m_real=m_real, **kw)

    def make_context(self, g, cfg, device="cuda"):
        return make_context(g, cfg, device)

    def init_state(self, cfg, tasks, device="cuda"):
        return init_state(cfg, tasks, device)

    def dummy_context(self, cfg, device="cuda"):
        device = check_device(device)

        def z(*shape):
            return torch.zeros(shape, dtype=_I32, device=device)
        return CountContext(adj=z(cfg.n_u, cfg.wv), order=z(cfg.n_u),
                            rank=z(cfg.n_u), binom_q=z(cfg.n_v + 1))

    def step(self, ctx, cfg, s):
        return step(ctx, cfg, s)

    def step_lanes(self, ctx, cfg, s, act, batched):
        _step_lanes(ctx, cfg, s, act, batched)

    def collected(self, cfg, s, n_u, n_v):
        return []               # nothing is materialized

    # -- result schema --------------------------------------------------
    def counters(self, s) -> dict:
        return dict(count=int(s.count), nodes=int(s.nodes),
                    steps=int(s.steps))

    def stacked_counters(self, stacked) -> dict:
        return dict(count=int(stacked.count.to(torch.int64).sum()),
                    nodes=int(stacked.nodes.to(torch.int64).sum()),
                    steps=int(stacked.steps.to(torch.int64).sum()))

    def finish(self, cfg, s, *, n_u, n_v, swapped=False, collect=False):
        p, q = cfg.count_pq
        out = self.counters(s)
        out.update(p=p, q=q)
        return out

    def finish_workers(self, cfg, stacked, n_workers, *, n_u, n_v,
                       swapped=False, collect=False):
        p, q = cfg.count_pq
        out = self.stacked_counters(stacked)
        out.update(p=p, q=q)
        return out

    def partial(self, counters, cfg=None):
        c = counters or {}
        p, q = cfg.count_pq if cfg is not None else (0, 0)
        return dict(count=int(c.get("count", 0)),
                    nodes=int(c.get("nodes", 0)),
                    steps=int(c.get("steps", 0)), p=p, q=q)

    # -- convenience ----------------------------------------------------
    def count(self, g: BipartiteGraph, p: int = 2, q: int = 2,
              **kw) -> int:
        """Direct exact-shape count of the (p,q)-bicliques of ``g``."""
        out = self.enumerate(g, count_pq=(p, q), **kw)
        return int(out.count)


COUNT = register_engine(CountEngine())
