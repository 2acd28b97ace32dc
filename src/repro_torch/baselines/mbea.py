"""CPU oracle implementations of MBE.

Twin of ``src/repro/baselines/mbea.py``: a NumPy copy of the oracles, so
the port and ``chip_smoke.py`` check results without importing the JAX
package.  Three reference points:

* ``enumerate_bruteforce`` — closure-based exhaustive enumeration; ground
  truth for tiny graphs (tests the oracle itself).
* ``enumerate_mbea``       — a faithful transcription of the paper's
  Algorithm 1 (Zhang et al.'s MBEA), with the iMBEA/ooMBE-style degeneracy
  candidate ordering as an option. This is the *serial CPU baseline*
  (ooMBE stand-in) and the correctness oracle for the JAX engines.
* ``enumerate_parallel``   — ParMBE stand-in: the same search with
  first-level subtrees fanned out over a process pool (coarse-grained tasks,
  exactly the decomposition cuMBE assigns to thread blocks).

Adjacency is held as Python big-int bitmasks: ``&`` and ``int.bit_count()``
are C-speed, which keeps the oracle usable on benchmark-scale graphs.

Convention (applied consistently across oracles and JAX engines): a reported
maximal biclique has **both sides non-empty**.
"""
from __future__ import annotations

import multiprocessing
import os
import sys
from concurrent.futures import ProcessPoolExecutor
from typing import Iterable

import numpy as np

from repro_torch.core.graph import BipartiteGraph


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _adj_ints(g: BipartiteGraph) -> list[int]:
    """adj_u rows as Python ints (bitmask over V)."""
    out = []
    for u in range(g.n_u):
        out.append(int.from_bytes(g.adj_u[u].tobytes(), "little"))
    return out


def _mask_to_tuple(mask: int) -> tuple[int, ...]:
    out = []
    i = 0
    while mask:
        if mask & 1:
            out.append(i)
        mask >>= 1
        i += 1
    return tuple(out)


def bicliques_to_key_set(bicliques: Iterable[tuple]) -> set:
    """Canonical, order-independent key set for comparing enumerations.

    Accepts (L_members, R_members) pairs in any iterable/int-mask form.
    """
    keys = set()
    for L, R in bicliques:
        lk = _mask_to_tuple(L) if isinstance(L, int) else tuple(sorted(L))
        rk = _mask_to_tuple(R) if isinstance(R, int) else tuple(sorted(R))
        keys.add((lk, rk))
    return keys


# ---------------------------------------------------------------------------
# brute force (ground truth for tiny graphs)
# ---------------------------------------------------------------------------

def enumerate_bruteforce(g: BipartiteGraph) -> list[tuple[tuple, tuple]]:
    """All maximal bicliques (L ⊆ V, R ⊆ U), both sides non-empty.

    Uses the closure characterization: (L, R) is a maximal biclique iff
    L = N(R) and R = N(L). Enumerate closures of all non-empty R ⊆ U.
    O(2^|U|) — tiny graphs only.
    """
    assert g.n_u <= 20, "brute force limited to |U| <= 20"
    adj = _adj_ints(g)
    full_v = (1 << g.n_v) - 1
    # V-side adjacency as ints over U
    adj_v = [int.from_bytes(g.adj_v[v].tobytes(), "little")
             for v in range(g.n_v)]
    seen = set()
    out = []
    for r_mask in range(1, 1 << g.n_u):
        # L = common neighbours of R
        l_mask = full_v
        rm = r_mask
        u = 0
        while rm:
            if rm & 1:
                l_mask &= adj[u]
                if not l_mask:
                    break
            rm >>= 1
            u += 1
        if not l_mask:
            continue
        # R* = common neighbours of L
        r_closed = (1 << g.n_u) - 1
        lm = l_mask
        v = 0
        while lm:
            if lm & 1:
                r_closed &= adj_v[v]
            lm >>= 1
            v += 1
        key = (l_mask, r_closed)
        if key not in seen:
            seen.add(key)
            out.append((_mask_to_tuple(l_mask), _mask_to_tuple(r_closed)))
    return out


# ---------------------------------------------------------------------------
# Algorithm 1 (paper transcription)
# ---------------------------------------------------------------------------

def _mbea_rec(adj: list[int], L: int, R: tuple, P: list, Q: list,
              order: str, sink) -> None:
    """One recursion level of the paper's Algorithm 1.

    ``P`` is consumed back-to-front (``pop()``); for the degeneracy order the
    level's P is sorted by descending |N(v) ∩ L| once on entry so pops take
    the smallest first — equivalent to iMBEA's per-level re-selection since
    L is fixed within a level.
    """
    if order == "degeneracy":
        P = sorted(P, key=lambda v: -( (adj[v] & L).bit_count() ))
    else:
        P = list(P)
    Q = list(Q)
    while P:
        x = P.pop()                       # Step 1: candidate selection
        Lp = L & adj[x]                   # Step 2: L' construction
        Rp = R + (x,)
        if Lp:
            nLp = Lp.bit_count()
            # Step 3: maximality checking against Q
            is_maximal = True
            Qp = []
            for v in Q:
                c = (adj[v] & Lp).bit_count()
                if c == nLp:
                    is_maximal = False
                    break
                if c > 0:
                    Qp.append(v)
            if is_maximal:
                # Step 4: maximal expansion over remaining P
                Pp = []
                R_extra = []
                for v in P:
                    c = (adj[v] & Lp).bit_count()
                    if c == nLp:
                        R_extra.append(v)
                    elif c > 0:
                        Pp.append(v)
                sink(Lp, Rp + tuple(R_extra))
                if Pp:
                    _mbea_rec(adj, Lp, Rp + tuple(R_extra), Pp, Qp,
                              order, sink)
        Q.append(x)                       # move tested vertex to Q


def enumerate_mbea(g: BipartiteGraph, order: str = "degeneracy",
                   collect: bool = True):
    """Run Algorithm 1. Returns list of (L_mask:int, R:tuple) if ``collect``
    else just the count."""
    sys.setrecursionlimit(max(10000, 4 * g.n_u + 100))
    adj = _adj_ints(g)
    L0 = (1 << g.n_v) - 1
    P0 = list(range(g.n_u))
    out = []
    n = [0]
    if collect:
        def sink(Lp, Rp):
            out.append((Lp, Rp))
    else:
        def sink(Lp, Rp):
            n[0] += 1
    _mbea_rec(adj, L0, tuple(), P0, [], order, sink)
    return out if collect else n[0]


def count_mbea(g: BipartiteGraph, order: str = "degeneracy") -> int:
    return enumerate_mbea(g, order=order, collect=False)


# ---------------------------------------------------------------------------
# ParMBE stand-in: process-parallel over first-level subtrees
# ---------------------------------------------------------------------------

_PAR_STATE: dict = {}


def _par_init(adj, n_v, order):
    _PAR_STATE["adj"] = adj
    _PAR_STATE["n_v"] = n_v
    _PAR_STATE["order"] = order


def _par_task(args) -> int:
    """Process one first-level candidate x_i given the candidates are taken
    in a fixed global order: P for the subtree is the candidates *after* x in
    that order, Q the ones before (exactly the state Algorithm 1 would have
    when popping x at the root)."""
    (i, root_order) = args
    adj = _PAR_STATE["adj"]
    n_v = _PAR_STATE["n_v"]
    order = _PAR_STATE["order"]
    sys.setrecursionlimit(100000)
    x = root_order[i]
    Q = list(root_order[:i])
    P = list(root_order[i + 1:])
    L0 = (1 << n_v) - 1
    cnt = [0]

    def sink(Lp, Rp):
        cnt[0] += 1

    Lp = L0 & adj[x]
    if not Lp:
        return 0
    nLp = Lp.bit_count()
    Qp = []
    for v in Q:
        c = (adj[v] & Lp).bit_count()
        if c == nLp:
            return 0                      # not maximal
        if c > 0:
            Qp.append(v)
    Pp, R_extra = [], []
    for v in reversed(P):  # reversed: match pop() order of the serial code
        c = (adj[v] & Lp).bit_count()
        if c == nLp:
            R_extra.append(v)
        elif c > 0:
            Pp.append(v)
    cnt[0] += 1
    if Pp:
        _mbea_rec(adj, Lp, (x,) + tuple(R_extra), Pp, Qp, order, sink)
    return cnt[0]


def enumerate_parallel(g: BipartiteGraph, workers: int | None = None,
                       order: str = "degeneracy") -> int:
    """Count maximal bicliques with first-level subtrees over a process pool.

    This mirrors ParMBE's (and cuMBE's) coarse-grained decomposition: the
    root-level candidate list is fixed up front; subtree i sees Q = roots
    before i, P = roots after i.  The pool is started with ``spawn`` (a
    fork of a process that holds a CUDA context or torch's thread pools
    can deadlock); the workers run only this module's big-int search and
    never touch the card.
    """
    adj = _adj_ints(g)
    L0 = (1 << g.n_v) - 1
    roots = list(range(g.n_u))
    if order == "degeneracy":
        roots.sort(key=lambda v: (adj[v] & L0).bit_count())
    workers = workers or min(os.cpu_count() or 2, 16)
    if g.n_u == 0:
        return 0
    args = [(i, roots) for i in range(len(roots))]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(
            max_workers=workers, mp_context=ctx, initializer=_par_init,
            initargs=(adj, g.n_v, order)) as ex:
        counts = list(ex.map(_par_task, args,
                             chunksize=max(1, len(args) // (workers * 8))))
    return int(sum(counts))


def pair_checksum_sum(bicliques, n_u: int, n_v: int) -> int:
    """The engines' ``cs`` fingerprint of an oracle enumeration: the
    uint32 sum of ``bitset.pair_checksum`` over every (L, R) biclique
    (``L`` a V-side int mask, ``R`` a tuple of U vertices), computed in
    NumPy with explicit 2**32 wraparound."""
    from repro_torch.core.bitset_host import n_words
    wv, wu = n_words(n_v), n_words(n_u)
    total = 0
    for lmask, r in bicliques:
        lw = np.frombuffer(int(lmask).to_bytes(4 * wv, "little"),
                           dtype=np.uint32)
        rw = np.zeros(wu, dtype=np.uint32)
        for u in r:
            rw[u // 32] |= np.uint32(1) << np.uint32(u % 32)
        total += pair_checksum_np(lw, rw)
    return total % (1 << 32)


def checksum_np(words: np.ndarray) -> int:
    """``bitset.checksum`` in NumPy uint32 arithmetic."""
    w = np.asarray(words, dtype=np.uint32)
    with np.errstate(over="ignore"):
        mult = (np.arange(w.shape[-1], dtype=np.uint32)
                * np.uint32(0x9E3779B9) + np.uint32(0x85EBCA6B))
        h = w * mult
        h = h ^ (h >> np.uint32(15))
        h = h * np.uint32(0x2545F491)
        h = h ^ (h >> np.uint32(13))
    return int(h.astype(np.uint64).sum() % (1 << 32))


def pair_checksum_np(l_words: np.ndarray, r_words: np.ndarray) -> int:
    """``bitset.pair_checksum`` in NumPy uint32 arithmetic."""
    m = 0xFFFFFFFF
    x = ((checksum_np(l_words) * 0x85EBCA6B) & m) \
        ^ ((checksum_np(r_words) * 0xC2B2AE35) & m)
    x ^= x >> 16
    x = (x * 0x7FEB352D) & m
    return x ^ (x >> 15)
