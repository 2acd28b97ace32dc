"""One front door: the ``MBEClient`` enumeration API.

Twin of ``src/repro/api.py``: ``MBEClient``, ``MBEOptions`` and
``MBEFuture`` over one ``MBEServer``:

    from repro_torch import MBEClient, MBEOptions

    res = MBEClient(MBEOptions()).enumerate(graph)       # on the card
    res = MBEClient(MBEOptions(device="cpu")).enumerate(graph)

``MBEOptions`` keeps every reference field and default and adds one
port-only field, ``device`` (default ``"cuda"``), threaded through the
server, the executor and the engine.  ``device="cuda"`` without a card
raises; nothing continues on the CPU in its place.  ``mesh`` (None, N or
``"auto"``) serves through ``ShardedExecutor`` on
``sharding.axes.mbe_serve_mesh``: N distinct cards (``"auto"``: every
visible one), or, with ``device="cpu"``, N shards of the CPU; a
``launch.mesh.Mesh`` names its devices itself.

The port serves every registered engine (``dense``, ``compact``,
``count``, ``mce``) on the local route and on the work-stealing
big-graph route (``big_graph_threshold``, ``big_workers``,
``work_stealing``: the routed graph's root tasks on ``big_workers``
workers of the device, or ``workers_per_device`` on every device of a
mesh), with the SLO layer (``admission``:
backpressure, weighted per-tenant fairness through
``submit(..., tenant=)``, shed-on-deadline; ``trace_path``: the JSONL
request trace) and the fault-tolerance layer (``retry``: retries,
checkpoints, quarantine and the one failover, which stays on the same
device; ``fault_injector``: a deterministic ``FaultPlan``), on one
device or over a mesh (``mesh``, ``workers_per_device``: lane pools and
the big lane's workers split over the devices).
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch.core.engine import Engine, get_engine, list_engines
from repro_torch.core.graph import BipartiteGraph, unipartite_graph
from repro_torch.core.results import (CliqueResult, CountResult,
                                      EngineResult, MBEResult)
from repro_torch.kernels.dispatch import check_device
from repro_torch.launch.mesh import Mesh
from repro_torch.serving.buckets import BucketPolicy
from repro_torch.serving.cache import ExecutableCache
from repro_torch.serving.executor import LocalExecutor, ShardedExecutor
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.recovery import RetryPolicy
from repro_torch.serving.scheduler import MBEServer, imbalance
from repro_torch.serving.slo.admission import AdmissionPolicy


def engines() -> list[str]:
    """Names of every registered engine."""
    return list_engines()


@dataclasses.dataclass(frozen=True)
class MBEOptions:
    """Every knob of the enumeration service (the reference's fields and
    defaults, see ``src/repro/api.py``) plus ``device``."""

    # -- engine ---------------------------------------------------------
    engine: str = "dense"
    count_p: int = 2
    count_q: int = 2
    order_mode: str = "deg"
    impl: str = "jnp"
    kernel_impl: str = "auto"     # 'auto' | 'jnp' | 'pallas', by device
    collect: bool = False
    collect_cap: int = 1
    resident_lanes: int | str = "auto"
    resident_rebalance: bool = False

    # -- shape bucketing / batching ------------------------------------
    bucket_mode: str = "pow2"
    step_u: int = 8
    step_v: int = 32
    min_u: int = 4
    min_v: int = 16
    max_batch: int = 8
    pad_batch: bool = True

    # -- scheduling -----------------------------------------------------
    steps_per_round: int = 0
    steps_per_call: int = 1
    big_graph_threshold: int | None = None
    max_graph_steps: int | None = None
    cache_capacity: int | None = ExecutableCache.DEFAULT_CAPACITY

    # -- SLO layer (serving.slo), fault tolerance (serving.faults /
    # serving.recovery): all off by default ------------------------------
    admission: AdmissionPolicy | None = None
    trace_path: str | None = None
    retry: RetryPolicy | None = None
    fault_injector: FaultPlan | None = None
    strict_step_cap: bool = False

    # -- placement --------------------------------------------------------
    mesh: int | str | Mesh | None = None   # None = one local device; N
    #                               = N devices; "auto" = every visible
    #                               one; a Mesh = those devices (an
    #                               explicit list, e.g. a rehearsal that
    #                               repeats one card)
    workers_per_device: int = 1
    big_workers: int = 4
    work_stealing: bool = True

    # -- port only ----------------------------------------------------------
    device: str = "cuda"          # where lanes, kernels and results run;
    #                               'cuda' needs a card (no silent CPU
    #                               fallback), the tests pass 'cpu'

    def __post_init__(self):
        get_engine(self.engine)

    def engine_params(self) -> dict:
        return dict(count_pq=(self.count_p, self.count_q))

    def bucket_policy(self) -> BucketPolicy:
        return BucketPolicy(
            mode=self.bucket_mode, step_u=self.step_u, step_v=self.step_v,
            min_u=self.min_u, min_v=self.min_v, max_batch=self.max_batch,
            pad_batch=self.pad_batch, steps_per_round=self.steps_per_round,
            steps_per_call=self.steps_per_call,
            big_graph_threshold=self.big_graph_threshold)

    def make_executor(self):
        if isinstance(self.mesh, Mesh):     # names its devices itself
            mesh = self.mesh
        else:
            device = str(check_device(self.device))
            if self.mesh is None:
                return LocalExecutor(big_workers=self.big_workers,
                                     work_stealing=self.work_stealing,
                                     device=device)
            from repro_torch.sharding.axes import mbe_serve_mesh
            mesh = mbe_serve_mesh(
                None if self.mesh == "auto" else int(self.mesh),
                device=device)
        return ShardedExecutor(
            mesh,
            big_workers_per_device=self.workers_per_device,
            work_stealing=self.work_stealing)

    def make_server(self) -> MBEServer:
        return MBEServer(
            self.bucket_policy(), collect_cap=self.collect_cap,
            collect=self.collect, order_mode=self.order_mode,
            impl=self.impl, kernel_impl=self.kernel_impl,
            max_graph_steps=self.max_graph_steps,
            executor=self.make_executor(),
            cache_capacity=self.cache_capacity,
            engine=get_engine(self.engine),
            engine_params=self.engine_params(),
            resident_lanes=self.resident_lanes,
            resident_rebalance=self.resident_rebalance,
            admission=self.admission,
            trace_path=self.trace_path,
            retry=self.retry,
            fault_injector=self.fault_injector,
            strict_step_cap=self.strict_step_cap)


class MBEFuture:
    """Handle for one submitted request.

    Single-process cooperative future: ``result()`` drives the client's
    scheduling loop (``server.poll``) until this request completes, so
    other in-flight requests make progress while you wait.  ``done()``
    and ``cancel()`` never run a scheduling round.

    The terminal result is *claimed* by the future on first
    retrieval: it moves out of the client's mailbox onto the future
    object (``result()`` stays idempotent), so a long-lived client only
    holds results whose futures have not been asked yet.
    """

    __slots__ = ("_client", "rid", "name", "_result")

    def __init__(self, client: "MBEClient", rid: int, name: str):
        self._client = client
        self.rid = rid
        self.name = name
        self._result: EngineResult | None = None

    def _claim(self) -> EngineResult | None:
        if self._result is None:
            res = self._client._mailbox.pop(self.rid, None)
            if res is not None:
                self._result = res
                self._client._watched.discard(self.rid)
        return self._result

    def done(self) -> bool:
        """Whether a terminal result (done/cancelled/timed_out) is
        available."""
        if self._claim() is not None:
            return True
        self._client._harvest()
        return self._claim() is not None

    def cancel(self) -> bool:
        """Cancel the request: pending requests are dropped before any
        compile, in-flight requests have their lane evicted and refilled.
        Returns False when the result already exists (too late)."""
        if self.done():
            return False
        ok = self._client.server.cancel(self.rid)
        self._client._harvest()
        return ok

    def result(self, timeout: float | None = None) -> EngineResult:
        """Block until the request reaches a terminal state and return its
        result (check ``result.status`` — a cancelled or
        deadline-expired request returns a flagged result rather than
        raising).  ``timeout`` bounds the wait in seconds; on expiry the
        request keeps running and ``TimeoutError`` is raised."""
        t0 = time.perf_counter()
        while True:
            if self.done():
                return self._result
            if not self._client.server.has_work():
                raise KeyError(
                    f"request {self.rid} is unknown to the server "
                    f"(no pending work and no stashed result)")
            if timeout is not None \
                    and time.perf_counter() - t0 > timeout:
                raise TimeoutError(
                    f"request {self.rid} ({self.name}) not done within "
                    f"{timeout}s (still being served; cancel() to stop)")
            self._client.poll()

    def __repr__(self) -> str:
        state = "pending"
        if self._result is not None \
                or self.rid in self._client._mailbox:
            state = "done"
        return f"<MBEFuture rid={self.rid} {self.name!r} {state}>"


class MBEClient:
    """The single public entry point for maximal biclique enumeration.

    One client owns one ``MBEServer`` (and therefore one executable
    cache, one executor, one set of lane pools); submit any mix of
    graphs and the scheduler buckets, batches, routes and refills
    underneath.  See ``MBEOptions`` for the execution-path knobs and the
    module docstring for usage.
    """

    def __init__(self, options: MBEOptions | None = None, **overrides):
        if options is None:
            options = MBEOptions(**overrides)
        elif overrides:
            options = dataclasses.replace(options, **overrides)
        self.options = options
        self.server = options.make_server()
        # mailbox: terminal results awaiting their future's first
        # retrieval.  Only rids with an outstanding (unclaimed) future are
        # retained — completion batches delivered to direct poll()/drain()
        # callers pass through without accumulating — so the client's
        # footprint is bounded by the futures the caller is still holding.
        self._mailbox: dict[int, EngineResult] = {}
        self._watched: set[int] = set()
        # completion sink: results land in the mailbox at delivery time no
        # matter WHO drove the scheduling loop — futures stay coherent
        # even when the low-level server surface is driven directly
        self.server.add_completion_sink(self._on_complete)

    # ------------------------------------------------------------------
    def _on_complete(self, batch: dict[int, EngineResult]) -> None:
        for rid, res in batch.items():
            if rid in self._watched:
                self._mailbox[rid] = res

    def _harvest(self) -> None:
        self.server.reap()          # stashed results flow through the sink

    def submit(self, g: BipartiteGraph, priority: int = 0,
               deadline_s: float | None = None,
               tenant: str = "default") -> MBEFuture:
        """Enqueue one graph; returns an ``MBEFuture``.  ``priority``
        reorders placement within a bucket (higher first); ``deadline_s``
        bounds the request's wall-clock lifetime; ``tenant`` is the
        accounting + fairness identity (``stats()['per_tenant']``, the
        admission controller's weighted queue shares).  With
        ``MBEOptions.admission`` set the request may be refused here —
        its future then resolves to a result with
        ``status == "rejected"`` (check ``result.reject_reason``)."""
        rid = self.server.admit(g, priority=priority,
                                deadline_s=deadline_s, tenant=tenant)
        self._watched.add(rid)
        return MBEFuture(self, rid, g.name)

    def enumerate(self, g: BipartiteGraph, priority: int = 0,
                  deadline_s: float | None = None) -> EngineResult:
        """Synchronous single-graph enumeration through the serving
        stack (byte-identical to the engine's direct ``enumerate``)."""
        return self.submit(g, priority=priority,
                           deadline_s=deadline_s).result()

    def enumerate_many(self, graphs: list[BipartiteGraph]
                       ) -> list[EngineResult]:
        """Batched enumeration of a whole stream; results in submit
        order.  Shapes are bucketed so the stream shares executables."""
        futs = [self.submit(g) for g in graphs]
        self.server.drain()
        return [f.result() for f in futs]

    def poll(self) -> dict[int, EngineResult]:
        """One scheduling round; returns the requests that completed this
        round (results for outstanding futures are also kept claimable)."""
        return self.server.poll()

    def drain(self) -> dict[int, EngineResult]:
        """Serve everything pending; returns everything that completed."""
        return self.server.drain()

    # ------------------------------------------------------------------
    @property
    def routing_log(self) -> list[dict]:
        return self.server.routing_log

    def stats(self) -> dict:
        """Server stats plus the client-level load-balance summary:
        ``big_imbalance`` is max/mean per-worker busy steps on the
        big-graph lane (``serving.imbalance`` — the zero-guarded metric
        ``launch/mbe_run.py`` reports)."""
        return self.server.stats()


__all__ = ["MBEClient", "MBEFuture", "MBEOptions", "MBEResult",
           "EngineResult", "CountResult", "CliqueResult", "engines",
           "unipartite_graph", "imbalance", "Engine", "get_engine",
           "list_engines"]
