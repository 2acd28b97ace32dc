"""repro_torch — the PyTorch / CUDA port of the MBE system, beside the
JAX reference package ``repro``.

Public surface (a subset of ``repro``'s, restricted to what this port
serves so far — see ``ROADMAP.md``):

    from repro_torch import MBEClient, MBEOptions, BipartiteGraph

    g = BipartiteGraph.from_edges(3, 4, [(0, 0), (0, 1), (1, 1), (2, 3)])
    res = MBEClient(MBEOptions(collect=True, collect_cap=8)).enumerate(g)
    print(res.n_max, res.bicliques)

The package imports ``torch`` and ``numpy`` only: never ``jax``, never
``repro``.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""
from repro_torch.api import (MBEClient, MBEFuture, MBEOptions,  # noqa: F401
                             engines, imbalance)
from repro_torch.core.engine import (Engine, get_engine,  # noqa: F401
                                     list_engines, register_engine)
from repro_torch.core.graph import (BipartiteGraph,  # noqa: F401
                                    unipartite_graph)
from repro_torch.core.results import (CliqueResult,  # noqa: F401
                                      CountResult, EngineResult, MBEResult)
from repro_torch.serving.buckets import BucketPolicy  # noqa: F401
from repro_torch.serving.scheduler import MBEServer  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "__version__",
    "MBEClient",
    "MBEOptions",
    "MBEFuture",
    "EngineResult",
    "MBEResult",
    "CountResult",
    "CliqueResult",
    "BipartiteGraph",
    "unipartite_graph",
    "Engine",
    "engines",
    "get_engine",
    "register_engine",
    "list_engines",
    "MBEServer",
    "BucketPolicy",
    "imbalance",
]
