"""Add your own engine to the PyTorch / CUDA port: the registration
walkthrough.

    PYTHONPATH=src python examples/torch/custom_engine.py [--device cpu]

Twin of ``examples/custom_engine.py``.  The port's serving stack
(buckets, executable cache, executors, big-graph routing, futures,
cancellation, deadlines, ``stats()``) talks to workloads only through
the ``Engine`` contract (``repro_torch.core.engine``), so registering an
engine makes it a config-selectable axis, ``MBEOptions(engine="yours")``,
with every serving behaviour inherited.  A from-scratch engine gives its
identity and traits (``name``, ``result_type``, ``canonicalize``,
``unipartite``, ``collectable``), its state and context, the
construction hooks (``make_context``, ``init_state``,
``fresh_lane_state``, ``config``), the execution hooks (``step``,
``done``), the result schema (``counters``, ``finish``, ``partial``) and
calls ``register_engine`` at module bottom; ``repro_torch.core.
engine_count`` and ``engine_mce`` are the two implementations to crib
from.

This stub registers an "edges" engine, (1,1)-biclique counting, i.e.
|E|, by specialising the count engine's config hook, then serves it
through the client front door.
"""
import argparse

from repro_torch import CountResult, MBEClient, MBEOptions, list_engines
from repro_torch.core.engine import register_engine
from repro_torch.core.engine_count import CountEngine
from repro_torch.core.graph import BipartiteGraph


class EdgeCountEngine(CountEngine):
    """(1,1)-biclique counting: every edge is a K_{1,1}."""

    name = "edges"
    result_type = CountResult

    def config(self, n_u, n_v, depth, *, m_real=None, **kw):
        # pin the workload, whatever the client's count_p/count_q say
        kw["count_pq"] = (1, 1)
        return super().config(n_u, n_v, depth, m_real=m_real, **kw)


EDGES = register_engine(EdgeCountEngine())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device
    print(f"registered engines: {list_engines()}")
    g = BipartiteGraph.from_edges(
        4, 5, [(0, 0), (0, 1), (1, 1), (2, 3), (3, 4), (3, 0)], name="demo")
    res = MBEClient(MBEOptions(engine="edges", device=dev)).enumerate(g)
    assert isinstance(res, CountResult)
    assert res.count == len(g.edges) == res.metric
    print(f"[{g.name}] edges engine: count={res.count} (|E|={len(g.edges)}) "
          f"status={res.status}")
    print("custom engine served through the same front door — done.")
    return res


if __name__ == "__main__":
    main()
