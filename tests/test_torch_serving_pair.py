"""Shared helpers of the serving-layer port tests (``test_torch_slo.py``,
``test_torch_faults.py``, ``test_torch_serve_mbe.py``); this module holds
no test.  One namespace per package, so a test builds the same server,
policy or graph in the JAX package (``J``, on its one CPU device) and in
the port (``T``, with ``device="cpu"``) and compares what comes out."""
import importlib
import types

import numpy as np

import repro
import repro_torch
from repro import serving as j_serving
from repro.core import graph as j_graph
from repro.data import generators as j_gen
from repro.launch import serve as j_serve
from repro.serving import slo as j_slo
from repro_torch import serving as t_serving
from repro_torch.core import graph as t_graph
from repro_torch.data import generators as t_gen
from repro_torch.launch import serve as t_serve
from repro_torch.serving import slo as t_slo

J = types.SimpleNamespace(name="jax", root=repro, serving=j_serving,
                          slo=j_slo, gen=j_gen, graph=j_graph,
                          serve=j_serve.serve, extra={})
T = types.SimpleNamespace(name="torch", root=repro_torch, serving=t_serving,
                          slo=t_slo, gen=t_gen, graph=t_graph,
                          serve=lambda argv: t_serve.serve(argv,
                                                           device="cpu"),
                          extra=dict(device="cpu"))
BOTH = (J, T)


def slo_module(P, name):
    """``P``'s ``serving.slo.<name>`` module (the package re-exports
    functions under the names ``simulate`` and ``trace``)."""
    return importlib.import_module(f"{P.slo.__name__}.{name}")


def server(P, policy=None, **kw):
    """``P``'s ``MBEServer`` over ``BucketPolicy(**policy)``."""
    return P.serving.MBEServer(P.serving.BucketPolicy(**(policy or {})),
                               **kw, **P.extra)


def client(P, **opts):
    return P.root.MBEClient(P.root.MBEOptions(**opts, **P.extra))


def random_graph(P, n_u, n_v, density, seed, canonical=False):
    """``tests/_graphs.py``'s seeded graph, built with ``P``'s classes."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n_u, n_v)) < density
    edges = list(zip(*np.nonzero(mask))) or [(0, 0)]
    g = P.graph.BipartiteGraph.from_edges(n_u, n_v, edges)
    return g.canonical() if canonical else g


def payload(r) -> dict:
    """Every result field but the measured ``*_s`` times."""
    return {k: getattr(r, k) for k in r.__dataclass_fields__
            if not k.endswith("_s")}


def masked(events) -> list[dict]:
    """Trace events with the clock ``t`` and the measured ``*_s`` fields
    left out (``deadline_s`` is an input and stays)."""
    return [{k: v for k, v in e.items()
             if k != "t" and (k == "deadline_s" or not k.endswith("_s"))}
            for e in events]


# the stats() keys two runs of one stream must agree on: scheduling,
# admission and recovery counters, and the executor's name
LEDGER_KEYS = ("retries", "faults_injected", "checkpoints", "quarantined",
               "failovers", "failed", "step_capped", "batches", "lanes",
               "misses", "hits", "busy_steps", "total_lane_steps",
               "launches", "admitted", "rejected", "shed",
               "rejected_backpressure", "rejected_fairness", "per_tenant",
               "timed_out", "cancelled", "executor")
