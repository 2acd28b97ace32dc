"""Bipartite graph generators reproducing the *structure classes* of the

Twin of ``src/repro/data/generators.py``: a NumPy-only copy, so the
port never imports the JAX package.
paper's Table I datasets.

The paper evaluates on 13 public datasets (DBLP-author, Marvel, YouTube,
BookCrossing, movielens, ...). Those files are not available offline, so the
benchmark suite generates synthetic graphs in the same structural families —
the properties the paper's analysis keys on:

* community-rich ultra-sparse graphs (DBLP-author, DBpedia_locations):
  many small dense communities, few inter-community edges. These stress
  coarse-grained task fetching.
* power-law graphs (Marvel, YouTube, IMDB, stackoverflow): skewed degree
  distribution -> heavy workload imbalance across first-level subtrees.
  These stress work stealing.
* biclique-dense graphs (BookCrossing, movielens-u-i): nMB >> |E|; these are
  where cuMBE shines.
* tiny dense graphs (corporate-leadership, UCforum, Unicode): work-stealing
  overhead regime.

``load_konect`` reads the real thing (KONECT out.* edge-list format) when a
path is supplied, so runs on real hardware can use the paper's datasets
unmodified.

All generators guarantee min-degree >= 1 on both sides and return the
canonical orientation (|U| <= |V|).
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch.core.graph import BipartiteGraph, unipartite_graph


def _ensure_min_degree(n_u, n_v, edges, rng):
    es = set(edges)
    deg_u = np.zeros(n_u, dtype=np.int64)
    deg_v = np.zeros(n_v, dtype=np.int64)
    for u, v in es:
        deg_u[u] += 1
        deg_v[v] += 1
    for u in range(n_u):
        if deg_u[u] == 0:
            v = int(rng.integers(n_v))
            es.add((u, v))
            deg_v[v] += 1
    for v in range(n_v):
        if deg_v[v] == 0:
            u = int(rng.integers(n_u))
            es.add((u, v))
    return es


def random_bipartite(n_u: int, n_v: int, p: float, seed: int = 0,
                     name: str | None = None) -> BipartiteGraph:
    """Erdos–Renyi bipartite G(n_u, n_v, p)."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n_u, n_v)) < p
    us, vs = np.nonzero(mask)
    es = _ensure_min_degree(n_u, n_v, set(zip(us.tolist(), vs.tolist())), rng)
    g = BipartiteGraph.from_edges(n_u, n_v, es,
                                  name=name or f"er_{n_u}x{n_v}_p{p}")
    return g.canonical()


def powerlaw_bipartite(n_u: int, n_v: int, m_edges: int, alpha: float = 1.6,
                       seed: int = 0, name: str | None = None
                       ) -> BipartiteGraph:
    """Skewed degree distribution on both sides (Marvel/YouTube-like)."""
    rng = np.random.default_rng(seed)
    pu = (np.arange(1, n_u + 1, dtype=np.float64)) ** (-alpha)
    pv = (np.arange(1, n_v + 1, dtype=np.float64)) ** (-alpha)
    pu /= pu.sum()
    pv /= pv.sum()
    us = rng.choice(n_u, size=m_edges, p=pu)
    vs = rng.choice(n_v, size=m_edges, p=pv)
    es = _ensure_min_degree(n_u, n_v, set(zip(us.tolist(), vs.tolist())), rng)
    g = BipartiteGraph.from_edges(
        n_u, n_v, es, name=name or f"pl_{n_u}x{n_v}_m{m_edges}")
    return g.canonical()


def community_bipartite(n_u: int, n_v: int, n_comm: int, p_in: float = 0.6,
                        p_out_edges: int = 0, seed: int = 0,
                        name: str | None = None) -> BipartiteGraph:
    """Community-rich sparse graph (DBLP-author-like): n_comm blocks, dense
    inside, a sprinkle of cross-community edges."""
    rng = np.random.default_rng(seed)
    es = set()
    bu = np.array_split(np.arange(n_u), n_comm)
    bv = np.array_split(np.arange(n_v), n_comm)
    for cu, cv in zip(bu, bv):
        if len(cu) == 0 or len(cv) == 0:
            continue
        mask = rng.random((len(cu), len(cv))) < p_in
        ui, vi = np.nonzero(mask)
        for a, b in zip(cu[ui].tolist(), cv[vi].tolist()):
            es.add((a, b))
    for _ in range(p_out_edges):
        es.add((int(rng.integers(n_u)), int(rng.integers(n_v))))
    es = _ensure_min_degree(n_u, n_v, es, rng)
    g = BipartiteGraph.from_edges(
        n_u, n_v, es, name=name or f"comm_{n_u}x{n_v}_c{n_comm}")
    return g.canonical()


def dense_small(n_u: int, n_v: int, p: float = 0.4, seed: int = 0,
                name: str | None = None) -> BipartiteGraph:
    """Tiny dense graph (corporate-leadership-like)."""
    return random_bipartite(n_u, n_v, p, seed=seed,
                            name=name or f"dense_{n_u}x{n_v}")


def load_konect(path: str, name: str | None = None) -> BipartiteGraph:
    """Load a KONECT-format bipartite edge list (``out.<name>`` file).

    Lines: ``u v [weight [time]]``, 1-indexed; comment lines start with %.
    """
    us, vs = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("%") or line.startswith("#"):
                continue
            parts = line.split()
            us.append(int(parts[0]) - 1)
            vs.append(int(parts[1]) - 1)
    n_u = max(us) + 1
    n_v = max(vs) + 1
    g = BipartiteGraph.from_edges(
        n_u, n_v, zip(us, vs),
        name=name or os.path.basename(path))
    return g.canonical()


def random_unipartite(n: int, p: float, seed: int = 0,
                      name: str | None = None) -> BipartiteGraph:
    """Erdos–Renyi undirected G(n, p) as a symmetric bipartite embed
    (the ``mce`` engine's submission format)."""
    rng = np.random.default_rng(seed)
    mask = np.triu(rng.random((n, n)) < p, k=1)
    a, b = np.nonzero(mask)
    es = set(zip(a.tolist(), b.tolist()))
    deg = np.zeros(n, dtype=np.int64)
    for x, y in es:
        deg[x] += 1
        deg[y] += 1
    for v in range(n):      # keep min-degree >= 1 like the bipartite gens
        if deg[v] == 0:
            w = int(rng.integers(n - 1))
            w += w >= v
            es.add((min(v, w), max(v, w)))
            deg[w] += 1
    return unipartite_graph(n, es, name=name or f"uni_er_{n}_p{p}")


def random_graph_stream(n_requests: int, seed: int = 0
                        ) -> list[BipartiteGraph]:
    """Mixed-size serving request stream cycling the four Table-I structure
    families at randomized small shapes (the serving layer/benchmark's
    synthetic traffic model)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_requests):
        kind = i % 4
        n_u = int(rng.integers(6, 26))
        n_v = int(rng.integers(n_u, 3 * n_u + 1))
        s = int(rng.integers(1 << 30))
        if kind == 0:
            g = dense_small(n_u, n_v, p=0.35, seed=s, name=f"req{i}-dense")
        elif kind == 1:
            g = random_bipartite(n_u, n_v, p=0.15, seed=s,
                                 name=f"req{i}-er")
        elif kind == 2:
            g = powerlaw_bipartite(n_u, n_v, m_edges=3 * n_u, seed=s,
                                   name=f"req{i}-pl")
        else:
            g = community_bipartite(n_u, n_v, n_comm=3, p_in=0.5,
                                    p_out_edges=4, seed=s,
                                    name=f"req{i}-comm")
        out.append(g)
    return out


def dataset_suite(scale: str = "bench") -> dict[str, BipartiteGraph]:
    """Named synthetic datasets mirroring the paper's Table I families.

    ``scale``:
      * "test"  — tiny graphs for correctness tests (oracle-checkable).
      * "bench" — CPU-benchmarkable sizes (seconds per engine).
      * "large" — stress sizes for the distributed runner.
    """
    if scale == "test":
        return {
            "corp-leadership": dense_small(12, 10, p=0.45, seed=1),
            "unicode-like": random_bipartite(24, 40, p=0.06, seed=2,
                                             name="unicode-like"),
            "ucforum-like": random_bipartite(20, 36, p=0.18, seed=3,
                                             name="ucforum-like"),
            "community-tiny": community_bipartite(18, 30, n_comm=3,
                                                  p_in=0.7, p_out_edges=6,
                                                  seed=4,
                                                  name="community-tiny"),
            "powerlaw-tiny": powerlaw_bipartite(20, 40, m_edges=90, seed=5,
                                                name="powerlaw-tiny"),
        }
    if scale == "bench":
        return {
            # community-rich sparse (DBLP/DBpedia family)
            "dblp-like": community_bipartite(512, 1536, n_comm=64,
                                             p_in=0.6, p_out_edges=128,
                                             seed=11, name="dblp-like"),
            # power-law, imbalance-heavy (Marvel/YouTube family)
            "marvel-like": powerlaw_bipartite(256, 512, m_edges=7000,
                                              alpha=1.35, seed=12,
                                              name="marvel-like"),
            "youtube-like": powerlaw_bipartite(384, 1280, m_edges=9000,
                                               alpha=1.45, seed=13,
                                               name="youtube-like"),
            # biclique-dense (BookCrossing/movielens-u-i family)
            "movielens-like": random_bipartite(224, 448, p=0.085, seed=14,
                                               name="movielens-like"),
            "bookx-like": powerlaw_bipartite(320, 960, m_edges=10000,
                                             alpha=1.25, seed=15,
                                             name="bookx-like"),
            # small dense (work-stealing overhead regime)
            "corp-leadership": dense_small(24, 20, p=0.21, seed=16,
                                           name="corp-leadership"),
            "ucforum-like": random_bipartite(128, 222, p=0.09, seed=17,
                                             name="ucforum-like"),
            "unicode-like": random_bipartite(64, 154, p=0.03, seed=18,
                                             name="unicode-like"),
        }
    if scale == "large":
        return {
            "dblp-large": community_bipartite(1024, 4096, n_comm=128,
                                              p_in=0.5, p_out_edges=512,
                                              seed=21, name="dblp-large"),
            "powerlaw-large": powerlaw_bipartite(1024, 4096, m_edges=20000,
                                                 alpha=1.6, seed=22,
                                                 name="powerlaw-large"),
            "er-large": random_bipartite(512, 2048, p=0.02, seed=23,
                                         name="er-large"),
        }
    raise ValueError(f"unknown scale {scale!r}")
