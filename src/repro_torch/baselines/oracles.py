"""CPU oracles for the non-MBE engines (differential testing).

Twin of ``src/repro/baselines/oracles.py``: a copy with no JAX package
import, so ``chip_smoke.py`` holds the ``count`` and ``mce`` engines to
it on the card.  Slow, obviously-correct Python over big-int bitmasks:

* ``count_pq_bicliques``       — exact (p,q)-biclique count: for every
  p-subset of U, C(|common neighborhood|, q). Polynomial in C(n_u, p).
* ``enumerate_maximal_cliques`` — textbook recursive Bron–Kerbosch with
  pivoting over a symmetric bipartite embed (``graph.unipartite_graph``).
"""
from __future__ import annotations

from itertools import combinations
from math import comb

from repro_torch.core.graph import BipartiteGraph


def _adj_u_ints(g: BipartiteGraph) -> list[int]:
    return [int.from_bytes(g.adj_u[u].tobytes(), "little")
            for u in range(g.n_u)]


def count_pq_bicliques(g: BipartiteGraph, p: int, q: int) -> int:
    """Number of (p,q)-bicliques: p U-vertices all adjacent to the same
    q V-vertices (complete bipartite subgraphs K_{p,q}, unordered)."""
    if p < 1 or q < 1:
        raise ValueError(f"p and q must be >= 1, got ({p}, {q})")
    adj = _adj_u_ints(g)
    total = 0
    for sub in combinations(range(g.n_u), p):
        common = adj[sub[0]]
        for u in sub[1:]:
            common &= adj[u]
            if not common:
                break
        k = common.bit_count()
        if k >= q:
            total += comb(k, q)
    return total


def enumerate_maximal_cliques(g: BipartiteGraph) -> list[tuple[int, ...]]:
    """All maximal cliques of a symmetric bipartite embed, as sorted
    vertex tuples (self-loops ignored). Bron–Kerbosch with pivoting."""
    if g.n_u != g.n_v:
        raise ValueError(
            f"expected a symmetric unipartite embed (n_u == n_v); "
            f"got n_u={g.n_u}, n_v={g.n_v}")
    n = g.n_u
    adj = _adj_u_ints(g)
    adj = [adj[v] & ~(1 << v) for v in range(n)]    # strip self-loops
    out: list[tuple[int, ...]] = []

    def bk(r: int, p: int, x: int) -> None:
        if p == 0 and x == 0:
            out.append(tuple(v for v in range(n) if (r >> v) & 1))
            return
        pool = p | x
        pivot = max((v for v in range(n) if (pool >> v) & 1),
                    key=lambda v: (adj[v] & p).bit_count())
        for v in range(n):
            bit = 1 << v
            if not (p & bit) or (adj[pivot] & bit):
                continue
            bk(r | bit, p & adj[v], x & adj[v])
            p &= ~bit
            x |= bit

    bk(0, (1 << n) - 1 if n else 0, 0)
    return sorted(out)


def cliques_to_key_set(cliques) -> set:
    """Order-independent comparison key for clique lists."""
    return {tuple(sorted(int(v) for v in c)) for c in cliques}
