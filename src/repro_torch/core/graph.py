"""Bipartite graph container used by every MBE engine.

Twin of ``src/repro/core/graph.py``: a NumPy-only copy, so the
port never imports the JAX package.

A bipartite graph G = (U ∪ V, E). Following the paper we enumerate maximal
bicliques (L ⊆ V, R ⊆ U); the recursion branches on U-side candidates, so
|U| bounds the recursion depth and U should be the *smaller* side (the paper
assumes |V| > |U|; ``BipartiteGraph.canonical`` swaps sides if needed).

Adjacency is stored both ways as packed uint32 bitsets (see ``bitset.py``):
  adj_u : (|U|, ceil(|V|/32))   neighbours in V of each u
  adj_v : (|V|, ceil(|U|/32))   neighbours in U of each v

Engines may pad |U| / |V| to lane-friendly multiples; padding vertices have
empty neighbourhoods and are masked out of P at the root.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core import bitset_host as bitset


@dataclasses.dataclass(frozen=True)
class BipartiteGraph:
    n_u: int
    n_v: int
    adj_u: np.ndarray  # (n_u, n_words(n_v)) uint32
    adj_v: np.ndarray  # (n_v, n_words(n_u)) uint32
    edges: np.ndarray  # (m, 2) int64 (u, v) — kept for oracles / datasets
    name: str = "graph"

    # ------------------------------------------------------------------
    @staticmethod
    def from_edges(n_u: int, n_v: int, edges: Iterable[tuple[int, int]],
                   name: str = "graph") -> "BipartiteGraph":
        e = np.asarray(sorted(set((int(u), int(v)) for u, v in edges)),
                       dtype=np.int64)
        if e.size == 0:
            e = e.reshape(0, 2)
        adj_u = np.zeros((n_u, bitset.n_words(n_v)), dtype=np.uint32)
        adj_v = np.zeros((n_v, bitset.n_words(n_u)), dtype=np.uint32)
        for u, v in e:
            adj_u[u, v // 32] |= np.uint32(1) << np.uint32(v % 32)
            adj_v[v, u // 32] |= np.uint32(1) << np.uint32(u % 32)
        return BipartiteGraph(n_u=n_u, n_v=n_v, adj_u=adj_u, adj_v=adj_v,
                              edges=e, name=name)

    # ------------------------------------------------------------------
    @property
    def n_edges(self) -> int:
        return int(self.edges.shape[0])

    @property
    def edge_density(self) -> float:
        # The paper's Table-I formula: 2|E| / (|L| * |R|).
        denom = max(self.n_u * self.n_v, 1)
        return 2.0 * self.n_edges / denom

    def neighbors_u(self, u: int) -> list[int]:
        return bitset.unpack(self.adj_u[u], self.n_v)

    def neighbors_v(self, v: int) -> list[int]:
        return bitset.unpack(self.adj_v[v], self.n_u)

    def swapped(self) -> "BipartiteGraph":
        """Swap the two sides (U <-> V)."""
        return BipartiteGraph(
            n_u=self.n_v, n_v=self.n_u, adj_u=self.adj_v.copy(),
            adj_v=self.adj_u.copy(), edges=self.edges[:, ::-1].copy(),
            name=self.name)

    def canonical(self) -> "BipartiteGraph":
        """Return an orientation with |U| <= |V| (paper's assumption,
        minimizing recursion depth / compact-array height)."""
        return self.swapped() if self.n_u > self.n_v else self

    def padded(self, mult_u: int = 1, mult_v: int = 1) -> "BipartiteGraph":
        """Pad both sides up to multiples (isolated padding vertices)."""
        nu = ((self.n_u + mult_u - 1) // mult_u) * mult_u
        nv = ((self.n_v + mult_v - 1) // mult_v) * mult_v
        if nu == self.n_u and nv == self.n_v:
            return self
        adj_u = np.zeros((nu, bitset.n_words(nv)), dtype=np.uint32)
        adj_v = np.zeros((nv, bitset.n_words(nu)), dtype=np.uint32)
        # re-pack because word counts may change
        g = BipartiteGraph.from_edges(nu, nv, [tuple(x) for x in self.edges],
                                      name=self.name)
        adj_u[:, :] = g.adj_u
        adj_v[:, :] = g.adj_v
        return BipartiteGraph(n_u=nu, n_v=nv, adj_u=adj_u, adj_v=adj_v,
                              edges=self.edges, name=self.name)

    def degree_u(self) -> np.ndarray:
        return np.array([bin(int.from_bytes(r.tobytes(), "little")).count("1")
                         for r in self.adj_u], dtype=np.int64)

    def stats(self) -> dict:
        return dict(name=self.name, n_u=self.n_u, n_v=self.n_v,
                    n_edges=self.n_edges, edge_density=self.edge_density)


def unipartite_graph(n: int, edges: Iterable[tuple[int, int]],
                     name: str = "graph") -> BipartiteGraph:
    """Embed an undirected graph as a symmetric bipartite graph.

    Both sides are the same vertex set (n_u == n_v == n); every edge
    (a, b) is materialized in both directions and self-loops are
    dropped, so ``adj_u == adj_v`` is the packed symmetric adjacency
    matrix. This is the submission format of unipartite engines
    (``mce``): they read one side's masks and never touch the other.
    """
    es = set()
    for a, b in edges:
        a, b = int(a), int(b)
        if a == b:
            continue
        es.add((a, b))
        es.add((b, a))
    return BipartiteGraph.from_edges(n, n, es, name=name)


def validate(g: BipartiteGraph) -> None:
    """Invariant check: adj_u and adj_v describe the same edge set."""
    for u in range(g.n_u):
        for v in g.neighbors_u(u):
            assert bitset.unpack(g.adj_v[v], g.n_u).count(u) == 1
    es = {(int(u), int(v)) for u, v in g.edges}
    for u in range(g.n_u):
        for v in g.neighbors_u(u):
            assert (u, v) in es
