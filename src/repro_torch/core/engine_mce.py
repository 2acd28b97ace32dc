"""Maximal clique enumeration engine on torch tensors.

Twin of ``src/repro/core/engine_mce.py``: Bron–Kerbosch with vertex-order
root decomposition over a symmetric bipartite embed
(``graph.unipartite_graph``).  Root task i is vertex v_i of the degree
order with R = {v_i}, P = N(v_i) ∩ {later roots}, X = N(v_i) ∩ {earlier
roots}; a candidate step picks x ∈ P, pops it and descends with R + x,
P ∩ N(x), X ∩ N(x); an empty P reports R when X is empty, then
backtracks and moves the parent's expanded candidate into its X.  Every
``CliqueState`` leaf and the write order of each branch are the
reference's, bit for bit.

What changed in the translation (as in ``engine_dense``): lanes are an
explicit leading dim, ``_step_lanes`` computes the three branches for
every lane and selects per lane on the device, and the run loop is the
engines' shared ``engine_dense._torch_loop``.  Candidate selection
(``order_mode`` 'deg' / 'deg_nocache') follows the tensors' device
(``cfg.fused_on``): on the kernel path ONE launch of K4's packed kind
(``fused_select_packed(adj, P, P)``) covers every lane; otherwise
``intersect_count`` (K5 with ``impl="pallas"`` on the card) and a masked
argmin.

Registered as ``"mce"`` (lazily, on the first registry lookup that
misses).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import bitset
from repro_torch.core.engine import Engine, register_engine
from repro_torch.core.engine_dense import (EngineConfig, _add_u32, _gather,
                                           _lanes, _leaf_to_torch, _owned,
                                           _setrow, _unlane)
from repro_torch.core.graph import BipartiteGraph
from repro_torch.core.results import CliqueResult
from repro_torch.kernels.dispatch import check_device
from repro_torch.kernels.fused_select.ops import fused_select_packed
from repro_torch.kernels.intersect_count.ops import intersect_count

_I32 = torch.int32


class CliqueContext(NamedTuple):
    adj: torch.Tensor       # (NU, WU) int32 words: symmetric neighbor masks
    order: torch.Tensor     # (NU,) root order (degree ascending), -1 pad
    rank: torch.Tensor      # (NU,) rank[v]; padding rank = 2*NU


class CliqueState(NamedTuple):
    pmask: torch.Tensor     # (D, WU) BK candidate set per level
    xmask: torch.Tensor     # (D, WU) BK excluded set per level
    rmask: torch.Tensor     # (D, WU) current clique per level
    xstack: torch.Tensor    # (D,) candidate expanded at each level
    lvl: torch.Tensor       # () -1 = between tasks
    tasks: torch.Tensor     # (T,)
    n_tasks: torch.Tensor
    tpos: torch.Tensor
    steps: torch.Tensor
    nodes: torch.Tensor
    n_max: torch.Tensor
    cs: torch.Tensor        # () int32 pattern of the uint32 fingerprint
    out_n: torch.Tensor
    out_r: torch.Tensor     # (C, WU) collected clique masks


# ---------------------------------------------------------------------------
# host-side setup and NumPy bridges
# ---------------------------------------------------------------------------

def make_context(g: BipartiteGraph, cfg: EngineConfig,
                 device="cuda") -> CliqueContext:
    """The reference's ``make_context`` (same NumPy arithmetic), placed on
    ``device``."""
    if g.n_u != g.n_v:
        raise ValueError(
            f"the mce engine enumerates unipartite graphs submitted as "
            f"symmetric embeds (n_u == n_v, see graph.unipartite_graph); "
            f"got n_u={g.n_u}, n_v={g.n_v}")
    assert g.n_u <= cfg.n_u
    adj = np.zeros((cfg.n_u, cfg.wu), dtype=np.uint32)
    src = np.asarray(g.adj_v, dtype=np.uint32)
    adj[: g.n_u, : src.shape[1]] = src
    for v in range(g.n_u):      # defensively drop self-loops (not cliques)
        adj[v, v // 32] &= ~(np.uint32(1) << np.uint32(v % 32))
    deg = np.unpackbits(adj[: g.n_u].view(np.uint8), axis=1) \
        .sum(axis=1, dtype=np.int64)
    order_real = np.argsort(deg, kind="stable").astype(np.int32)
    order = np.full(cfg.n_u, -1, dtype=np.int32)
    order[: g.n_u] = order_real
    rank = np.full(cfg.n_u, 2 * cfg.n_u, dtype=np.int32)
    rank[order_real] = np.arange(g.n_u, dtype=np.int32)
    return context_from_numpy(
        CliqueContext(adj=adj, order=order, rank=rank), device)


def init_state(cfg: EngineConfig, tasks: np.ndarray,
               device="cuda") -> CliqueState:
    """Fresh worker state with a task list on ``device``."""
    device = check_device(device)
    t = np.full(max(len(tasks), 1), -1, dtype=np.int32)
    t[: len(tasks)] = np.asarray(tasks, dtype=np.int32)
    D, WU, C = cfg.depth, cfg.wu, cfg.collect_cap

    def z(*shape):
        return torch.zeros(shape, dtype=_I32, device=device)

    def sc(v):
        return torch.tensor(v, dtype=_I32, device=device)

    return CliqueState(
        pmask=z(D, WU), xmask=z(D, WU), rmask=z(D, WU),
        xstack=torch.full((D,), -1, dtype=_I32, device=device),
        lvl=sc(-1), tasks=torch.from_numpy(t).to(device),
        n_tasks=sc(len(tasks)), tpos=sc(0), steps=sc(0), nodes=sc(0),
        n_max=sc(0), cs=sc(0), out_n=sc(0), out_r=z(C, WU))


def context_from_numpy(leaves, device="cuda") -> CliqueContext:
    """Any object with the ``CliqueContext`` fields as arrays -> port
    tensors on ``device``."""
    device = check_device(device)
    return CliqueContext(*[_leaf_to_torch(f, getattr(leaves, f), device)
                           for f in CliqueContext._fields])


def state_from_numpy(leaves, device="cuda") -> CliqueState:
    """Any object with the ``CliqueState`` fields as arrays -> port state
    on ``device``."""
    device = check_device(device)
    return CliqueState(*[_leaf_to_torch(f, getattr(leaves, f), device)
                         for f in CliqueState._fields])


# ---------------------------------------------------------------------------
# one guarded engine step over a lane dim
# ---------------------------------------------------------------------------

def _select(g, cfg, pm):
    """``_branch_candidate``'s step 1 for every lane: the candidate x."""
    if cfg.order_mode == "input":
        return bitset.first_member(pm)
    if cfg.fused_on(pm.device):
        x, _ = fused_select_packed(g.adj, pm, pm, impl="pallas")
        return x
    return bitset.masked_argmin(intersect_count(g.adj, pm, impl=cfg.impl),
                                pm)


def _step_lanes(g, cfg, s, act: torch.Tensor, batched: bool) -> None:
    """In place: one engine step on every lane of the batched state ``s``
    whose ``act`` flag is set (``step`` of the reference, the branch
    chosen per lane by ``_case_id``).  ``batched``: ``g`` carries the lane
    dim too."""
    B = s.lvl.shape[0]
    dev = s.lvl.device
    NU, WU, D, C = cfg.n_u, cfg.wu, cfg.depth, cfg.collect_cap
    ar = torch.arange(B, device=dev)
    lvl = s.lvl
    lvl_safe = lvl.clamp(min=0)
    pm = s.pmask[ar, lvl_safe]
    p_empty = bitset.count(pm) == 0
    c0 = act & (lvl >= 0) & p_empty                  # report + backtrack
    c1 = act & (lvl < 0)                             # init task
    c2 = act & (lvl >= 0) & ~p_empty                 # expand a candidate
    zero = torch.zeros_like(lvl)

    # case 0: R is maximal iff X is empty; then backtrack, moving the
    # parent's expanded candidate into its X
    maximal = bitset.count(s.xmask[ar, lvl_safe]) == 0
    R = s.rmask[ar, lvl_safe]
    nl0 = lvl - 1
    safe0 = nl0.clamp(min=0)
    x0 = s.xstack[ar, safe0]
    x_new = s.xmask[ar, safe0] | bitset.singleton(x0.clamp(min=0), WU)

    # case 1: initialise the next root task
    T = s.tasks.shape[-1]
    idx = s.tasks[ar, s.tpos.clamp(max=T - 1)]
    x1 = _gather(g.order, ar, idx.clamp(0, NU - 1), batched)
    nbr1 = _gather(g.adj, ar, x1, batched)           # -1 wraps, as in JAX
    idx_col = idx[:, None]
    in_later = (g.rank > idx_col) & (g.rank < cfg.m_real)
    in_earlier = g.rank < idx_col

    # case 2: expand a candidate
    x2 = _select(g, cfg, pm)
    x2s = x2.clamp(0, NU - 1)
    pm_after = pm & ~bitset.singleton(x2.clamp(min=0), WU)
    nbr2 = _gather(g.adj, ar, x2s, batched)
    child = (lvl + 1).clamp(max=D - 1)

    # apply (each branch writes only its own lanes; case 2 writes
    # pmask[lvl] before pmask[child])
    _setrow(s.xmask, ar, safe0, x_new, c0 & (nl0 >= 0))
    w_idx = s.out_n.clamp(max=C - 1)
    write = c0 & maximal & (s.out_n < C)
    _setrow(s.out_r, ar, w_idx, R, write)
    c1c = c1[:, None]
    _setrow(s.pmask, ar, lvl_safe, pm_after, c2)
    _setrow(s.pmask, ar, torch.where(c1, zero, child),
            torch.where(c1c, nbr1 & bitset.from_bool(in_later),
                        pm_after & nbr2), c1 | c2)
    _setrow(s.xmask, ar, torch.where(c1, zero, child),
            torch.where(c1c, nbr1 & bitset.from_bool(in_earlier),
                        s.xmask[ar, lvl_safe] & nbr2), c1 | c2)
    _setrow(s.rmask, ar, torch.where(c1, zero, child),
            torch.where(c1c, bitset.singleton(x1, WU),
                        R | bitset.singleton(x2s, WU)), c1 | c2)
    _setrow(s.xstack, ar, lvl_safe, x2, c2)

    hit = c0 & maximal
    s.cs.copy_(torch.where(hit, _add_u32(s.cs, bitset.pair_checksum(R, R)),
                           s.cs))
    s.lvl.copy_(torch.where(c0, nl0, torch.where(
        c1, zero, torch.where(c2, lvl + 1, lvl))))
    s.tpos.add_(c1.to(_I32))
    s.steps.add_(act.to(_I32))
    s.nodes.add_((c1 | c2).to(_I32))
    s.n_max.add_(hit.to(_I32))
    s.out_n.add_(write.to(_I32))


def step(g: CliqueContext, cfg: EngineConfig,
         s: CliqueState) -> CliqueState:
    """One engine step of an unbatched lane (functional)."""
    s1 = _owned(_lanes(s))
    _step_lanes(g, cfg, s1, torch.ones(1, dtype=torch.bool,
                                       device=s.lvl.device), batched=False)
    return _unlane(s1)


def collected_cliques(cfg: EngineConfig, s: CliqueState,
                      n: int) -> list[tuple]:
    """Decode the collect buffer into vertex tuples."""
    cnt = int(s.out_n)
    assert cnt <= cfg.collect_cap, "collect buffer overflowed"
    rows = bitset.to_u32(s.out_r)
    return [tuple(bitset.unpack(rows[i], n)) for i in range(cnt)]


# ---------------------------------------------------------------------------
# the Engine registration
# ---------------------------------------------------------------------------

class MceEngine(Engine):
    """Bron–Kerbosch maximal clique enumeration on unipartite embeds."""

    name = "mce"
    result_type = CliqueResult
    canonicalize = False        # the embed is square; nothing to gain
    unipartite = True

    def make_context(self, g, cfg, device="cuda"):
        return make_context(g, cfg, device)

    def init_state(self, cfg, tasks, device="cuda"):
        return init_state(cfg, tasks, device)

    def dummy_context(self, cfg, device="cuda"):
        device = check_device(device)

        def z(*shape):
            return torch.zeros(shape, dtype=_I32, device=device)
        return CliqueContext(adj=z(cfg.n_u, cfg.wu), order=z(cfg.n_u),
                             rank=z(cfg.n_u))

    def step(self, ctx, cfg, s):
        return step(ctx, cfg, s)

    def step_lanes(self, ctx, cfg, s, act, batched):
        _step_lanes(ctx, cfg, s, act, batched)

    def collected(self, cfg, s, n_u, n_v):
        return collected_cliques(cfg, s, n_u)

    # -- result schema: the base MBE scalars, other payload key names ---
    def finish(self, cfg, s, *, n_u, n_v, swapped=False, collect=False):
        out = self.counters(s)
        out.update(cliques=None, truncated=False)
        if collect:
            out["cliques"] = self.collected(cfg, s, n_u, n_v)
            out["truncated"] = int(s.n_max) > int(s.out_n)
        return out

    def finish_workers(self, cfg, stacked, n_workers, *, n_u, n_v,
                       swapped=False, collect=False):
        out = self.stacked_counters(stacked)
        out.update(cliques=None, truncated=False)
        if collect:
            cl, truncated = self._collect_workers(cfg, stacked, n_workers,
                                                  n_u, n_v)
            out["cliques"] = cl
            out["truncated"] = truncated
        return out

    def partial(self, counters, cfg=None):
        c = counters or {}
        return dict(n_max=int(c.get("n_max", 0)), cs=int(c.get("cs", 0)),
                    nodes=int(c.get("nodes", 0)),
                    steps=int(c.get("steps", 0)),
                    cliques=None, truncated=False)


MCE = register_engine(MceEngine())
