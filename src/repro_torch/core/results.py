"""Result schema for the Engine contract (DESIGN.md §10).

Twin of ``src/repro/core/results.py``: a NumPy-only copy, so the
port never imports the JAX package.

Every request served through ``MBEServer``/``MBEClient`` terminates in an
``EngineResult``: the scheduler owns the *lifecycle* fields (request id,
timing attribution, cancelled/timed-out flags) and the engine owns the
*payload* fields (what the workload computed).  Engines declare their
concrete result type via ``Engine.result_type`` and the scheduler
constructs results exclusively through ``Engine.make_result`` — the
serving stack never names a concrete result class, which is what lets
one scheduler serve enumeration, counting and clique workloads without
engine-specific branches.

Variants:

* ``MBEResult``    — maximal biclique enumeration (``dense``/``compact``
  engines): count + order-independent fingerprint + optional decoded
  bicliques.
* ``CountResult``  — (p,q)-biclique counting (``count`` engine): one
  scalar accumulator, nothing materialized.
* ``CliqueResult`` — maximal clique enumeration on unipartite graphs
  (``mce`` engine): count + fingerprint + optional decoded cliques.

All result dataclasses are keyword-only: the scheduler assembles them
from an engine payload dict merged with its own timing dict, so field
order is not part of the contract.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True, kw_only=True)
class EngineResult:
    """Lifecycle + accounting fields shared by every workload."""

    rid: int
    name: str
    nodes: int                  # search-tree nodes visited
    steps: int                  # engine loop iterations (summed over
    #                             workers for big-graph requests)
    latency_s: float            # queue_s + service_s + compile_s: the sum
    #                             of the request's attributed components
    #                             (host gaps between rounds and other
    #                             buckets' rounds are not attributed)
    queue_s: float = 0.0        # admit -> lane placement
    service_s: float = 0.0      # execution wall while resident in a lane
    #                             (compilation excluded)
    compile_s: float = 0.0      # XLA compile time incurred while resident
    #                             (0.0 when the executable was cached)
    cancelled: bool = False     # request was cancelled (pending or
    #                             in-flight); counters are the progress
    #                             made before eviction
    timed_out: bool = False     # request's deadline expired before it
    #                             finished; same partial-progress contract
    rejected: bool = False      # refused at admit time by the admission
    #                             controller (serving.slo.admission):
    #                             never placed, never compiled — zero
    #                             counters by construction
    reject_reason: str = ""     # 'backpressure' | 'fairness' | 'shed'
    #                             when rejected, else ''
    failed: bool = False        # request could not be computed: quarantined
    #                             as poison after exhausting retries, or
    #                             unrecoverable executor failure; counters
    #                             are the progress before the failure
    fail_reason: str = ""       # human-readable cause when failed, else ''
    step_capped: bool = False   # request exceeded max_graph_steps and was
    #                             evicted (scheduler.enforce_step_cap);
    #                             counters are the progress at eviction

    @property
    def status(self) -> str:
        """Terminal lifecycle state: done | cancelled | timed_out |
        rejected | failed | step_capped."""
        if self.rejected:
            return "rejected"
        if self.failed:
            return "failed"
        if self.step_capped:
            return "step_capped"
        if self.cancelled:
            return "cancelled"
        if self.timed_out:
            return "timed_out"
        return "done"

    @property
    def metric(self) -> int:
        """The workload's headline scalar (for engine-agnostic reporting:
        bicliques/cliques found, or the subgraph count)."""
        return 0


@dataclasses.dataclass(frozen=True, kw_only=True)
class MBEResult(EngineResult):
    """Maximal biclique enumeration (``dense`` / ``compact`` engines)."""

    n_max: int                  # maximal bicliques found
    cs: int                     # enumeration fingerprint (order-independent,
    #                             computed in the canonical orientation)
    bicliques: list | None = None   # decoded (L ⊆ V, R ⊆ U) tuples when
    #                             collecting, in the orientation the graph
    #                             was SUBMITTED in (demux un-swaps if the
    #                             server canonicalized); None for flagged
    #                             results — a partial collect buffer is
    #                             not an answer
    truncated: bool = False     # collecting AND n_max exceeded the collect
    #                             buffer: the bicliques list is
    #                             honest-but-short (always False when the
    #                             server is not collecting)

    @property
    def metric(self) -> int:
        return self.n_max


@dataclasses.dataclass(frozen=True, kw_only=True)
class CountResult(EngineResult):
    """(p,q)-biclique counting (``count`` engine): no materialization,
    no collect buffers — one scalar per request."""

    count: int                  # number of (p,q)-bicliques
    p: int = 0                  # the applied (p, q); 0/0 on flagged
    q: int = 0                  # results that never reached a lane config

    @property
    def metric(self) -> int:
        return self.count


@dataclasses.dataclass(frozen=True, kw_only=True)
class CliqueResult(EngineResult):
    """Maximal clique enumeration on unipartite graphs (``mce`` engine)."""

    n_max: int                  # maximal cliques found
    cs: int                     # enumeration fingerprint
    cliques: list | None = None     # decoded vertex tuples when collecting
    truncated: bool = False     # collect buffer overflow (honest-but-short)

    @property
    def metric(self) -> int:
        return self.n_max
