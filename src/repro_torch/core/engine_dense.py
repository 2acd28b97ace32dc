"""Dense-bitset MBE engine on torch tensors.

Twin of ``src/repro/core/engine_dense.py``: the paper's recursion-free DFS
as per-level packed bitmask stacks (``lmask/pmask/qmask/rmask``), a
counts cache (``cstack``) and cursor scalars, advanced one engine step at
a time.  The step semantics, the write order of ``_apply_delta`` and
every ``DenseState`` leaf are the reference's, bit for bit.

What changed in the translation:

* **Lanes are explicit.**  ``vmap`` becomes a leading lane dim on every
  state leaf; ``_step_lanes`` advances all lanes at once.  Like ``vmap``
  of ``lax.switch`` it computes the three branch deltas (backtrack, init
  task, candidate) for every lane and selects by case on the device, so a
  step never syncs with the host.  Each lane's step is guarded by the run
  loop's predicate ``~done & (steps - start < budget)``.
* **Loops run on the host.**  ``lax.while_loop`` becomes a Python loop
  with ONE ``any(active)`` read per segment (a segment is ``unroll``
  guarded steps, or one resident-kernel launch).  This is correct and
  launch-bound: a CUDA graph or an in-kernel loop is later work.
* **Kernel paths follow the tensors' device** (``kernels.dispatch``):
  ``kernel_impl="auto"`` takes the CUDA kernels on a CUDA tensor and the
  torch-op path on a CPU one; ``"jnp"`` is the torch-op path anywhere;
  ``"pallas"`` is the kernel path, whose ops wrappers run their plain
  versions on a CPU tensor (the stand-in for interpret mode).  So the
  reference's ``cfg.fused``/``cfg.resident_active`` properties become
  ``cfg.fused_on(device)``/``cfg.resident_active_on(device)``.
* **Words are int32 bit patterns** (``core.bitset``); ``cs`` is the int32
  pattern of the uint32 fingerprint (``state_to_numpy`` shows it as
  uint32, ``Engine.counters`` as the unsigned int).
* **State updates are in place** on tensors a loop owns: every public
  entry point clones its input state first, so callers see functional
  semantics.

The hand-written CUDA kernels on this engine's paths are
``fused_check`` (the per-step check pass when residency is off),
``fused_select`` (its packed kind: ``deg_nocache`` selection when
residency is off), ``intersect_count`` (the unfused path with
``impl="pallas"``), ``resident_step`` (``run``) and ``resident_pool``
(``run_batch`` pools).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import bitset
from repro_torch.core.graph import BipartiteGraph
from repro_torch.kernels.dispatch import check_device, resolve_impl
from repro_torch.kernels.fused_check.ops import fused_check_packed
from repro_torch.kernels.fused_select.ops import fused_select_packed
from repro_torch.kernels.intersect_count.ops import intersect_count
from repro_torch.kernels.resident_pool.ops import (pool_run,
                                                   resident_pool_supported)
from repro_torch.kernels.resident_step.ops import (S_BUDGET, S_STEPS,
                                                   lane_run, pack,
                                                   resident_supported,
                                                   unpack)

_INF = 0x7FFFFFFF
_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The reference's config, field for field (so cache keys and options
    compare one for one); see ``src/repro/core/engine_dense.py``."""
    n_u: int
    n_v: int
    m_real: int
    depth: int
    collect_cap: int = 1
    order_mode: str = "deg"     # 'deg' | 'deg_nocache' | 'input'
    impl: str = "jnp"           # intersect_count impl on the unfused path
    kernel_impl: str = "auto"   # 'jnp' | 'pallas' | 'auto' (by device)
    max_steps: int = 1 << 30
    resident: bool = True       # kernel path: back run/run_batch with the
    #                             resident segment kernels when they fit
    count_pq: tuple[int, int] = (2, 2)
    resident_lanes: int | str = "auto"
    resident_rebalance: bool = False

    def fused_on(self, device) -> bool:
        """Whether branches take the kernel path for tensors on
        ``device``."""
        return resolve_impl(self.kernel_impl, device) == "pallas"

    def resident_active_on(self, device) -> bool:
        """Whether ``run`` backs its loop with the resident segment
        kernel: kernel path, opted in, and the Hopper gate passes."""
        return self.fused_on(device) and self.resident \
            and resident_supported(self)

    @property
    def wu(self) -> int:
        return bitset.n_words(self.n_u)

    @property
    def wv(self) -> int:
        return bitset.n_words(self.n_v)


class GraphContext(NamedTuple):
    """Device-resident graph data shared by all workers."""
    adj: torch.Tensor       # (NU, WV) int32 words
    order: torch.Tensor     # (NU,) int32 root order, -1 pad
    rank: torch.Tensor      # (NU,) int32; padding vertices 2*NU
    l_root: torch.Tensor    # (WV,) int32 words: all real V vertices
    root_counts: torch.Tensor   # (NU,) int32 degrees


class DenseState(NamedTuple):
    lmask: torch.Tensor     # (D, WV)
    cstack: torch.Tensor    # (D, NU) int32 counts cache
    pmask: torch.Tensor     # (D, WU)
    qmask: torch.Tensor     # (D, WU)
    rmask: torch.Tensor     # (D, WU)
    xstack: torch.Tensor    # (D,)
    lvl: torch.Tensor       # () -1 = between tasks
    forced_x: torch.Tensor  # () -1 = none
    tasks: torch.Tensor     # (T,)
    n_tasks: torch.Tensor
    tpos: torch.Tensor
    steps: torch.Tensor
    nodes: torch.Tensor
    n_max: torch.Tensor
    max_fail: torch.Tensor
    cs: torch.Tensor        # () int32 pattern of the uint32 fingerprint
    out_n: torch.Tensor
    out_l: torch.Tensor     # (C, WV)
    out_r: torch.Tensor     # (C, WU)


# leaves that hold packed words (uint32 at the NumPy boundary)
WORD_LEAVES = frozenset(("adj", "l_root", "lmask", "pmask", "qmask",
                         "rmask", "xmask", "cs", "out_l", "out_r"))


# ---------------------------------------------------------------------------
# host-side setup and NumPy bridges
# ---------------------------------------------------------------------------

def make_context(g: BipartiteGraph, cfg: EngineConfig,
                 device="cuda") -> GraphContext:
    """The reference's ``make_context`` (same NumPy arithmetic), placed on
    ``device`` (the card unless the caller asks for the CPU)."""
    assert g.n_u <= cfg.n_u and g.n_v <= cfg.n_v
    adj = np.zeros((cfg.n_u, cfg.wv), dtype=np.uint32)
    src_rows = np.asarray(g.adj_u, dtype=np.uint32)
    adj[: g.n_u, : src_rows.shape[1]] = src_rows
    deg = np.unpackbits(adj[: g.n_u].view(np.uint8), axis=1) \
        .sum(axis=1, dtype=np.int64)
    order_real = np.argsort(deg, kind="stable").astype(np.int32)
    order = np.full(cfg.n_u, -1, dtype=np.int32)
    order[:g.n_u] = order_real
    rank = np.full(cfg.n_u, 2 * cfg.n_u, dtype=np.int32)
    rank[order_real] = np.arange(g.n_u, dtype=np.int32)
    l_root = np.zeros(cfg.wv, dtype=np.uint32)
    fm = bitset.full_mask(g.n_v)
    l_root[: fm.shape[0]] = fm
    rc = np.zeros(cfg.n_u, dtype=np.int32)
    rc[: g.n_u] = deg.astype(np.int32)
    return context_from_numpy(
        GraphContext(adj=adj, order=order, rank=rank, l_root=l_root,
                     root_counts=rc), device)


def init_state(cfg: EngineConfig, tasks: np.ndarray,
               device="cuda") -> DenseState:
    """Fresh worker state with a task list (indices into the root order)
    on ``device``."""
    device = check_device(device)
    t = np.full(max(len(tasks), 1), -1, dtype=np.int32)
    t[: len(tasks)] = np.asarray(tasks, dtype=np.int32)
    D, WU, WV, C = cfg.depth, cfg.wu, cfg.wv, cfg.collect_cap

    def z(*shape):
        return torch.zeros(shape, dtype=_I32, device=device)

    def sc(v):
        return torch.tensor(v, dtype=_I32, device=device)

    return DenseState(
        lmask=z(D, WV), cstack=z(D, cfg.n_u), pmask=z(D, WU),
        qmask=z(D, WU), rmask=z(D, WU),
        xstack=torch.full((D,), -1, dtype=_I32, device=device),
        lvl=sc(-1), forced_x=sc(-1),
        tasks=torch.from_numpy(t).to(device), n_tasks=sc(len(tasks)),
        tpos=sc(0), steps=sc(0), nodes=sc(0), n_max=sc(0), max_fail=sc(0),
        cs=sc(0), out_n=sc(0), out_l=z(C, WV), out_r=z(C, WU))


def _leaf_to_torch(name: str, a, device) -> torch.Tensor:
    a = np.asarray(a)
    if name in WORD_LEAVES:
        return bitset.from_u32(a, device)
    return torch.from_numpy(np.array(a, dtype=np.int32, order="C")).to(device)


def context_from_numpy(leaves, device="cuda") -> GraphContext:
    """Any object with the ``GraphContext`` fields as arrays (NumPy, or a
    reference ``GraphContext`` after ``np.asarray``) -> port tensors on
    ``device``."""
    device = check_device(device)
    return GraphContext(*[_leaf_to_torch(f, getattr(leaves, f), device)
                          for f in GraphContext._fields])


def state_from_numpy(leaves, device="cuda") -> DenseState:
    """Any object with the ``DenseState`` fields as arrays -> port state
    on ``device`` (uint32 words become int32 bit patterns)."""
    device = check_device(device)
    return DenseState(*[_leaf_to_torch(f, getattr(leaves, f), device)
                        for f in DenseState._fields])


def state_to_numpy(s) -> dict[str, np.ndarray]:
    """Port state (or context) -> {field: NumPy array}, word leaves and
    ``cs`` as uint32, the rest as int32: the reference's dtypes."""
    out = {}
    for f in s._fields:
        x = getattr(s, f)
        out[f] = (bitset.to_u32(x) if f in WORD_LEAVES
                  else x.detach().cpu().numpy().astype(np.int32))
    return out


# ---------------------------------------------------------------------------
# one guarded engine step over a lane dim
# ---------------------------------------------------------------------------

def _gather(t: torch.Tensor, ar: torch.Tensor, i: torch.Tensor,
            batched: bool) -> torch.Tensor:
    """Row ``i[b]`` of lane b's ``t`` (a shared ``t`` has no lane dim)."""
    return t[ar, i] if batched else t[i]


def _setrow(stack: torch.Tensor, ar: torch.Tensor, idx: torch.Tensor,
            row: torch.Tensor, en: torch.Tensor) -> None:
    """In place: ``stack[b, idx[b]] = row[b]`` where ``en[b]``."""
    cur = stack[ar, idx]
    cond = en.view(en.shape + (1,) * (cur.dim() - 1))
    stack[ar, idx] = torch.where(cond, row, cur)


def _add_u32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """uint32 wraparound add of int32 bit patterns."""
    return bitset.wrap32((a.to(torch.int64) & 0xFFFFFFFF)
                         + (b.to(torch.int64) & 0xFFFFFFFF))


def _done(s) -> torch.Tensor:
    return (s.lvl < 0) & (s.tpos >= s.n_tasks)


def _active(s, start, budget) -> torch.Tensor:
    return (~_done(s)) & (s.steps - start < budget)


def _candidate(g, cfg, s, ar, lvl, lvl_safe, pm, batched):
    """The candidate branch (``_branch_candidate``) for every lane."""
    dev = pm.device
    NU, WU, D = cfg.n_u, cfg.wu, cfg.depth
    fused = cfg.fused_on(dev)
    L = s.lmask[ar, lvl_safe]
    forced = s.forced_x >= 0

    # step 1: candidate selection
    if cfg.order_mode == "deg":
        x_sel = bitset.masked_argmin(s.cstack[ar, lvl_safe], pm)
    elif cfg.order_mode == "deg_nocache":
        if fused:
            x_sel, _ = fused_select_packed(g.adj, L, pm, impl="pallas")
        else:
            x_sel = bitset.masked_argmin(
                intersect_count(g.adj, L, impl=cfg.impl), pm)
    else:   # 'input'
        x_sel = bitset.first_member(pm)
    x = torch.where(forced, s.forced_x, x_sel)
    xm = x.clamp(min=0)
    pm_after = pm & ~bitset.singleton(xm, WU)

    # step 2: L' = L & N(x)  (x >= -1; -1 wraps to the last row, as a
    # negative index does in the reference)
    Lp = L & _gather(g.adj, ar, x, batched)
    nLp = bitset.count(Lp)
    nonempty = nLp > 0

    # steps 3+4: maximality check + expansion partition + Q' filter
    q_cur = s.qmask[ar, lvl_safe]
    if fused:
        with_counts = cfg.order_mode == "deg"
        viol_f, fullw, part_row, q_keep, c2 = fused_check_packed(
            g.adj, Lp, nLp, q_cur, pm_after, impl="pallas",
            with_counts=with_counts)
        viol = viol_f & nonempty
        c_row = c2 if with_counts else torch.zeros(
            (Lp.shape[0], NU), dtype=_I32, device=dev)
    else:
        qb = bitset.to_bool(q_cur, NU)
        pb = bitset.to_bool(pm_after, NU)
        c2 = intersect_count(g.adj, Lp, impl=cfg.impl)
        n_col = nLp[:, None]
        eq = c2 == n_col
        viol = torch.any(qb & eq, dim=-1) & nonempty
        fullw = bitset.from_bool(pb & eq)
        part_row = bitset.from_bool(pb & (c2 > 0) & (c2 < n_col))
        c_row = c2
        q_keep = bitset.from_bool(c2 > 0)
    has_part = torch.any(part_row != 0, dim=-1)
    is_max = nonempty & ~viol
    Rp = s.rmask[ar, lvl_safe] | bitset.singleton(x, WU) | fullw
    has_child = is_max & has_part
    pm_final = torch.where(forced[:, None], torch.zeros_like(pm_after),
                           pm_after)
    return dict(
        x=x, Lp=Lp, c_row=c_row, pm_final=pm_final, part_row=part_row,
        q_row=torch.where(has_child[:, None], q_cur & q_keep,
                          q_cur | bitset.singleton(xm, WU)),
        q_idx=torch.where(has_child, (lvl + 1).clamp(max=D - 1), lvl_safe),
        Rp=Rp, has_child=has_child,
        child=(lvl + 1).clamp(max=D - 1),
        nl=torch.where(has_child, lvl + 1, lvl),
        is_max=is_max, viol=viol,
        cs_inc=bitset.pair_checksum(Lp, Rp))


def _step_lanes(g, cfg, s, act: torch.Tensor, batched: bool) -> None:
    """In place: one engine step on every lane of the batched state ``s``
    whose ``act`` flag is set (``step`` + ``_apply_delta`` of the
    reference, the branch chosen per lane by ``_case_id``).  ``batched``
    says whether ``g`` carries the lane dim too."""
    B = s.lvl.shape[0]
    dev = s.lvl.device
    NU, WU, D, C = cfg.n_u, cfg.wu, cfg.depth, cfg.collect_cap
    ar = torch.arange(B, device=dev)
    lvl, tpos = s.lvl, s.tpos
    lvl_safe = lvl.clamp(min=0)
    pm = s.pmask[ar, lvl_safe]
    p_empty = bitset.count(pm) == 0
    c0 = act & (lvl >= 0) & p_empty & (s.forced_x < 0)      # backtrack
    c1 = act & (lvl < 0)                                     # init task
    c2m = act & (lvl >= 0) & ~(p_empty & (s.forced_x < 0))   # candidate

    # case 0: backtrack — x moves to Q at the parent level
    nl0 = lvl - 1
    safe0 = nl0.clamp(min=0)
    x0 = s.xstack[ar, safe0]
    q0 = s.qmask[ar, safe0] | bitset.singleton(x0.clamp(min=0), WU)

    # case 1: initialise the next root task
    T = s.tasks.shape[-1]
    idx = s.tasks[ar, tpos.clamp(max=T - 1)]
    x1 = _gather(g.order, ar, idx.clamp(0, NU - 1), batched)
    rank = g.rank
    idx_col = idx[:, None]
    p1 = bitset.from_bool((rank > idx_col) & (rank < cfg.m_real))
    q1 = bitset.from_bool(rank < idx_col)

    # case 2: process a candidate
    d = _candidate(g, cfg, s, ar, lvl, lvl_safe, pm, batched)

    # apply the merged delta in the reference's write order
    en_c = c1 | (c2m & d["has_child"])
    child = torch.where(c1, torch.zeros_like(lvl), d["child"])
    c1c = c1[:, None]
    _setrow(s.lmask, ar, child, torch.where(c1c, g.l_root, d["Lp"]), en_c)
    _setrow(s.cstack, ar, child,
            torch.where(c1c, g.root_counts, d["c_row"]), en_c)
    _setrow(s.pmask, ar, lvl_safe, d["pm_final"], c2m)
    _setrow(s.pmask, ar, child, torch.where(c1c, p1, d["part_row"]), en_c)
    q_idx = torch.where(c0, safe0,
                        torch.where(c1, torch.zeros_like(lvl), d["q_idx"]))
    q_row = torch.where(c0[:, None], q0, torch.where(c1c, q1, d["q_row"]))
    _setrow(s.qmask, ar, q_idx, q_row, (c0 & (nl0 >= 0)) | c1 | c2m)
    _setrow(s.rmask, ar, child,
            torch.where(c1c, torch.zeros_like(d["Rp"]), d["Rp"]), en_c)
    _setrow(s.xstack, ar, lvl_safe, d["x"], c2m & d["has_child"])
    w_idx = s.out_n.clamp(max=C - 1)
    write = c2m & d["is_max"] & (s.out_n < C)
    _setrow(s.out_l, ar, w_idx, d["Lp"], write)
    _setrow(s.out_r, ar, w_idx, d["Rp"], write)

    hit = c2m & d["is_max"]
    s.cs.copy_(torch.where(hit, _add_u32(s.cs, d["cs_inc"]), s.cs))
    s.lvl.copy_(torch.where(c0, nl0, torch.where(
        c1, torch.zeros_like(lvl), torch.where(c2m, d["nl"], lvl))))
    s.forced_x.copy_(torch.where(c1, x1, torch.where(
        c2m, torch.full_like(lvl, -1), s.forced_x)))
    s.tpos.add_(c1.to(_I32))
    s.steps.add_(act.to(_I32))
    s.nodes.add_(c2m.to(_I32))
    s.n_max.add_(hit.to(_I32))
    s.max_fail.add_((c2m & d["viol"]).to(_I32))
    s.out_n.add_(write.to(_I32))


def _owned(s):
    """A private copy of every leaf (the loops update it in place)."""
    return type(s)(*[x.clone() for x in s])


def _lanes(s):
    """Unbatched state -> one-lane batched view (and back)."""
    return type(s)(*[x.unsqueeze(0) for x in s])


def _unlane(s):
    return type(s)(*[x.squeeze(0) for x in s])


def step(g: GraphContext, cfg: EngineConfig, s: DenseState) -> DenseState:
    """One engine step of an unbatched lane (functional)."""
    s1 = _owned(_lanes(s))
    _step_lanes(g, cfg, s1, torch.ones(1, dtype=torch.bool,
                                       device=s.lvl.device), batched=False)
    return _unlane(s1)


def guarded_steps(g, cfg: EngineConfig, s, *, start, budget, n_steps: int,
                  ctx_batched: bool = False):
    """``n_steps`` steps, each guarded by ``~done & (steps - start <
    budget)``, with no host sync: the plain version of one resident
    segment.  ``s`` is one lane or a batch (leading lane dim)."""
    single = s.lvl.dim() == 0
    st = _owned(_lanes(s) if single else s)
    start = torch.as_tensor(start, dtype=_I32, device=st.lvl.device)
    budget = torch.as_tensor(budget, dtype=_I32, device=st.lvl.device)
    for _ in range(n_steps):
        _step_lanes(g, cfg, st, _active(st, start, budget),
                    batched=ctx_batched and not single)
    return _unlane(st) if single else st


def _torch_loop(g, cfg, s, budget, unroll: int, batched: bool,
                step_lanes=None):
    """The torch-op run loop over a batched state: segments of ``unroll``
    guarded steps, one host read of ``any(active)`` per segment.  Every
    engine without a resident kernel runs on it with its own
    ``step_lanes`` (this engine's ``_step_lanes`` by default)."""
    step_lanes = step_lanes or _step_lanes
    st = _owned(s)
    start = st.steps.clone()
    while bool(_active(st, start, budget).any()):
        for _ in range(unroll):
            step_lanes(g, cfg, st, _active(st, start, budget), batched)
    return st


# ---------------------------------------------------------------------------
# run loops
# ---------------------------------------------------------------------------

def run(g: GraphContext, cfg: EngineConfig, s: DenseState,
        max_steps: int | None = None, unroll: int = 1) -> DenseState:
    """Run one lane until its tasks are done or the step budget is spent
    (resumable).  On the resident kernel path the loop copies ``s`` once
    and each segment of ``unroll`` guarded steps is ONE in-place launch of
    the single-lane kernel on that copy (the plain version on the CPU);
    otherwise segments of the torch-op step (with the per-step
    ``fused_check`` kernel on the kernel path)."""
    budget = cfg.max_steps if max_steps is None else max_steps
    if cfg.resident_active_on(s.lvl.device):
        own = _owned(s)
        p = pack(own, own.steps, budget)
        loop = lane_run(g, cfg, own, p, unroll)
        while loop.active():
            loop.launch()
        return unpack(own, p)
    return _unlane(_torch_loop(g, cfg, _lanes(s), budget, unroll,
                               batched=False))


def pool_lanes(cfg: EngineConfig, batch: int, device) -> int:
    """Pool width the multi-lane resident kernel would run ``batch`` lanes
    at on ``device``, or 0 when the per-lane layout applies (kernel path
    and ``resident`` required, ``resident_lanes`` 'auto' or a cap >= the
    batch, and the Hopper gate)."""
    if batch <= 0 or not (cfg.fused_on(device) and cfg.resident):
        return 0
    rl = cfg.resident_lanes
    if rl != "auto":
        if int(rl) < 2 or batch > int(rl):
            return 0
    return batch if resident_pool_supported(cfg, batch) else 0


# per-lane donations are clamped well under int32 range before summing
_REBALANCE_CLAMP = 1 << 24


def _rebalance_budgets(start: torch.Tensor, bud: torch.Tensor,
                       steps: torch.Tensor,
                       board: torch.Tensor) -> torch.Tensor:
    """Segment-boundary budget rebalance from the pool scoreboard:
    finished lanes donate their unused budget (clamped), the surplus is
    split evenly (floor) over busy lanes, finished lanes freeze at
    ``used``.  ``steps`` is the per-lane step column."""
    used = steps - start
    finished = board[:, 0] > 0
    rem = (bud - used).clamp(0, _REBALANCE_CLAMP)
    surplus = torch.where(finished, rem, torch.zeros_like(rem)).sum()
    n_busy = (~finished).to(_I32).sum().clamp(min=1)
    grant = torch.div(surplus, n_busy, rounding_mode="floor")
    new_bud = torch.where(finished, used, bud + grant)
    return new_bud.clamp(max=1 << 30).to(_I32)


def _run_batch_pool(gs, cfg: EngineConfig, ss, budget: int,
                    ctx_batched: bool, unroll: int) -> list:
    """Pool-kernel backing for ``run_batch``, over one pool or several
    (the shards of a mesh, each on its own device): each run loop copies
    its state once, then ONE in-place launch of the pool kernel (the
    plain version on the CPU) advances every lane of a pool by an
    ``unroll``-step segment, until no lane is active.  The scalar block
    (cursor, per-lane start and budget columns) stays on the device
    across the loop; the host reads one ``any(active)`` per pool and
    segment (the flag the launch set).  The pools go in lockstep: one
    launch on every pool still active, then every such pool's flag read,
    so the devices run a segment at once while the host waits on the
    first.  With ``cfg.resident_rebalance`` the budget column is
    rewritten from the scoreboard between segments, and ``any(active)``
    is recomputed from it."""
    runs = []
    for g, s in zip(gs, ss):
        own = _owned(s)
        start = own.steps.clone()
        p = pack(own, start, torch.full_like(start, budget))
        loop = pool_run(g, cfg, own, p, unroll, ctx_batched=ctx_batched)
        runs.append([own, start, p, loop, loop.active()])
    while any(r[4] for r in runs):
        live = [r for r in runs if r[4]]
        boards = [r[3].launch() for r in live]
        for (_, start, p, _, _), board in zip(live, boards):
            if cfg.resident_rebalance:
                p.scal[:, S_BUDGET] = _rebalance_budgets(
                    start, p.scal[:, S_BUDGET], p.scal[:, S_STEPS], board)
        for r in live:
            r[4] = r[3].active(fresh=cfg.resident_rebalance)
    return [unpack(own, p) for own, _, p, _, _ in runs]


def _lane(t, i: int):
    return type(t)(*[x[i] for x in t])


def _stack(items):
    return type(items[0])(*[torch.stack(xs) for xs in zip(*items)])


def run_batch(g: GraphContext, cfg: EngineConfig, s: DenseState,
              max_steps: int | None = None,
              ctx_batched: bool = False, unroll: int = 1) -> DenseState:
    """``run`` over a leading lane dim of worker states: one graph shared
    by B workers (``ctx_batched=False``) or B graphs of one bucket
    (``ctx_batched=True``).  On the resident kernel path the pool kernel
    advances the whole batch per launch whenever ``pool_lanes`` admits
    it; with ``resident_lanes=0/1`` each lane runs on the single-lane
    kernel (the reference's vmap of ``run``: lanes are independent, so
    lane-by-lane gives the same states); otherwise the torch-op loop
    (per-step ``fused_check`` on the kernel path) runs all lanes at
    once."""
    B = s.lvl.shape[0]
    dev = s.lvl.device
    budget = cfg.max_steps if max_steps is None else max_steps
    if pool_lanes(cfg, B, dev):
        return _run_batch_pool([g], cfg, [s], budget, ctx_batched,
                               unroll)[0]
    if cfg.resident_active_on(dev) and not resident_supported(cfg, lanes=B):
        cfg = dataclasses.replace(cfg, resident=False)
    if cfg.resident_active_on(dev):
        return _stack([run(_lane(g, i) if ctx_batched else g, cfg,
                           _lane(s, i), max_steps=max_steps, unroll=unroll)
                       for i in range(B)])
    return _torch_loop(g, cfg, s, budget, unroll, batched=ctx_batched)


def run_batch_shards(gs, cfg: EngineConfig, ss, max_steps: int | None = None,
                     ctx_batched: bool = False, unroll: int = 1) -> list:
    """``run_batch`` on every shard of a mesh (``gs[d]``, ``ss[d]`` on
    shard d's device): on the pool-kernel path every shard advances in
    the same segments (``_run_batch_pool``); otherwise one shard after
    another."""
    budget = cfg.max_steps if max_steps is None else max_steps
    if all(pool_lanes(cfg, s.lvl.shape[0], s.lvl.device) for s in ss):
        return _run_batch_pool(gs, cfg, ss, budget, ctx_batched, unroll)
    return [run_batch(g, cfg, s, max_steps=max_steps,
                      ctx_batched=ctx_batched, unroll=unroll)
            for g, s in zip(gs, ss)]


def replace_lane(batch_state: DenseState, batch_ctx: GraphContext, i: int,
                 lane_state: DenseState, lane_ctx: GraphContext
                 ) -> tuple[DenseState, GraphContext]:
    """Row surgery: a copy of the batch with lane ``i`` replaced (every
    other lane's rows untouched).  The reference's ``sharding`` re-pin
    has no counterpart: ``ShardedExecutor`` writes each row into its
    own shard."""
    return replace_lanes(batch_state, batch_ctx, [i],
                         _stack([lane_state]), _stack([lane_ctx]))


def replace_lanes(batch_state: DenseState, batch_ctx: GraphContext, idx,
                  lane_states: DenseState, lane_ctxs: GraphContext
                  ) -> tuple[DenseState, GraphContext]:
    """Vectorised ``replace_lane``: one scatter per leaf into a copy."""
    ii = torch.as_tensor(np.asarray(idx, dtype=np.int64),
                         device=batch_state.lvl.device)

    def put(b, lanes):
        out = b.clone()
        out[ii] = lanes.to(out.device)
        return out

    return (type(batch_state)(*map(put, batch_state, lane_states)),
            type(batch_ctx)(*map(put, batch_ctx, lane_ctxs)))


# ---------------------------------------------------------------------------
# convenience: single-worker full enumeration
# ---------------------------------------------------------------------------

def make_config(g: BipartiteGraph, **kw) -> EngineConfig:
    return EngineConfig(n_u=g.n_u, n_v=g.n_v, m_real=g.n_u,
                        depth=g.n_u + 2, **kw)


def enumerate_dense(g: BipartiteGraph, order_mode: str = "deg",
                    collect_cap: int = 1, impl: str = "jnp",
                    kernel_impl: str = "auto", device: str = "cuda",
                    **kw) -> DenseState:
    """Full single-worker enumeration on ``device`` (the card unless the
    caller asks for the CPU). Returns the final DenseState."""
    dev = check_device(device)
    cfg = make_config(g, order_mode=order_mode, collect_cap=collect_cap,
                      impl=impl, kernel_impl=kernel_impl, **kw)
    ctx = make_context(g, cfg, dev)
    s0 = init_state(cfg, np.arange(g.n_u, dtype=np.int32), dev)
    out = run(ctx, cfg, s0)
    assert bool(_done(out)), "step budget exhausted"
    return out


def collected_bicliques(cfg: EngineConfig, s: DenseState,
                        n_u: int, n_v: int) -> list[tuple[tuple, tuple]]:
    """Decode the collect buffer into (L members, R members) tuples."""
    n = int(s.out_n)
    assert n <= cfg.collect_cap, "collect buffer overflowed"
    ol = bitset.to_u32(s.out_l)
    orr = bitset.to_u32(s.out_r)
    return [(tuple(bitset.unpack(ol[i], n_v)),
             tuple(bitset.unpack(orr[i], n_u))) for i in range(n)]
