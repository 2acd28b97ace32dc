"""Continuous-batching MBE scheduler: slot admission + mid-flight refill.

Twin of ``src/repro/serving/scheduler.py``: ``Request``,
``_PendingQueue``, ``_LanePool`` (refill / run_round / step cap / demux),
the big-graph route (``_BigSlot``, ``_start_big`` / ``_poll_big`` /
``_demux_big``: a request whose canonical ``n_u`` meets
``BucketPolicy.big_graph_threshold`` runs as work-stealing workers on the
executor's device) and ``MBEServer`` with admit / poll / drain / flush /
serve / cancel / deadlines / reap / stats / reset_stats, over the
``LocalExecutor``.  See the reference module for the slot model, the
routing and the accounting.

The SLO hooks (``serving.slo``: the admission offer in ``admit``, the
trace's admit / poll / result events) and the recovery ladder
(``serving.faults`` / ``serving.recovery``: ``_with_retry``, verified
done-mask reads, quarantine bisection, checkpoints every K polls, the
one device-lost failover with checkpoint resume) are the reference's,
call for call, so one ``FaultPlan`` gives the same injector log in both
packages.  Recovery never leaves the device: the default failover
target is a ``LocalExecutor`` on the failed executor's device, and a
restored checkpoint goes to the device of the executor that installs
it.  ``stats()`` keeps the reference's full ``STATS_SCHEMA`` key set.
"""
from __future__ import annotations

import bisect
import dataclasses
import time

import numpy as np

from repro_torch.core.engine import Engine, get_engine
from repro_torch.core.graph import BipartiteGraph
from repro_torch.core.results import EngineResult, MBEResult  # noqa: F401
from repro_torch.serving.buckets import (BucketPolicy, BucketSpec,
                                         plan_bucket, plan_route)
from repro_torch.serving.cache import ExecutableCache
from repro_torch.serving.executor import (BigGraphLane, Executor,
                                          LocalExecutor)
from repro_torch.serving.faults import (DeviceLostError, FaultInjector,
                                        FaultPlan)
from repro_torch.serving.recovery import (CheckpointStore, RetryPolicy,
                                          restore_state, verified_read)
from repro_torch.serving.slo.admission import (AdmissionController,
                                               AdmissionPolicy)
from repro_torch.serving.slo.trace import TraceRecorder


def imbalance(per_worker) -> float:
    """Workload imbalance max/mean over per-worker busy steps.

    The mean is guarded against zero WITHOUT clamping it to 1: the old
    ``max() / max(mean(), 1)`` formula silently understated imbalance
    whenever 0 < mean < 1 (e.g. one worker with 8 busy steps among 15
    idle ones reported 8x instead of the true 16x).  An all-idle vector
    reports 1.0 (no work is trivially balanced)."""
    a = np.asarray(per_worker, dtype=np.float64).ravel()
    if a.size == 0:
        return 1.0
    mean = float(a.mean())
    return float(a.max()) / mean if mean > 0 else 1.0


# The stats() contract: every key the dict carries and its type, for all
# executors (local / sharded) and all routes (lane pool / big graph) and
# every registered engine.  tests/test_stats_contract.py asserts a served
# server's stats() matches this schema exactly — add the key HERE when
# adding a stat, or the contract test fails by design.
STATS_SCHEMA: dict[str, type | tuple] = dict(
    batches=int, lanes=int, pad_lanes=int, pending=int, in_flight=int,
    busy_steps=int, total_lane_steps=int, idle_lane_steps=int,
    occupancy=float, kernel_impl=str, steps_per_call=int,
    steps_per_poll=float, resident_lanes=(int, str), launches=int,
    launches_per_poll=float, rebalanced_steps=int, executor=str,
    engine=str, cancelled=int, timed_out=int,
    admitted=int, rejected=int, shed=int, rejected_backpressure=int,
    rejected_fairness=int, per_tenant=dict,
    big_busy_per_worker=list, big_imbalance=float,
    failed=int, step_capped=int, retries=int, faults_injected=int,
    checkpoints=int, quarantined=int, failovers=int,
    hits=int, misses=int, entries=int, evictions=int)

# Monotonic counters (reset by ``MBEServer.reset_stats``); everything
# else in STATS_SCHEMA is a gauge or a configuration echo.
MONOTONIC_STATS = frozenset((
    "batches", "lanes", "pad_lanes", "busy_steps", "total_lane_steps",
    "idle_lane_steps", "launches", "rebalanced_steps", "cancelled",
    "timed_out", "admitted", "rejected", "shed",
    "rejected_backpressure", "rejected_fairness",
    "failed", "step_capped", "retries", "faults_injected",
    "checkpoints", "quarantined", "failovers",
    "hits", "misses", "evictions"))


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int
    graph: BipartiteGraph       # served orientation (canonical when the
    #                             engine allows transposition)
    bucket: BucketSpec
    swapped: bool               # True if submit() transposed the graph
    t_admit: float = 0.0        # perf_counter stamp at admission
    big: bool = False           # routed to the work-stealing big-graph lane
    priority: int = 0           # higher pops first within a bucket queue
    deadline: float | None = None   # absolute perf_counter expiry (admit
    #                             stamp + deadline_s), None = no deadline
    deadline_s: float | None = None  # the submitted relative budget (for
    #                             tracing/estimation; deadline is absolute)
    tenant: str = "default"     # accounting + fairness identity


class _PendingQueue:
    """Priority-aware pending queue: pops the highest ``priority`` first,
    FIFO (admission order) within a priority level.  Keeps the deque
    interface the scheduler already speaks (``append``/``popleft``/
    ``len``) plus the lifecycle hooks (``remove``/``expired``)."""

    __slots__ = ("_items",)

    def __init__(self):
        # sorted ascending by (-priority, rid): head = highest priority,
        # earliest admission
        self._items: list[tuple[tuple[int, int], Request]] = []

    def append(self, req: Request) -> None:
        bisect.insort(self._items, ((-req.priority, req.rid), req))

    def popleft(self) -> Request:
        return self._items.pop(0)[1]

    def remove(self, rid: int) -> Request | None:
        """Drop (and return) the queued request with this rid, if any."""
        for j, (_, r) in enumerate(self._items):
            if r.rid == rid:
                return self._items.pop(j)[1]
        return None

    def expired(self, now: float) -> list[Request]:
        """Drop (and return) every queued request whose deadline passed."""
        out = [r for _, r in self._items
               if r.deadline is not None and now >= r.deadline]
        for r in out:
            self.remove(r.rid)
        return out

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        return (r for _, r in self._items)


class _LanePool:
    """Host-side half of one bucket's live pool: per-slot bookkeeping
    (which request occupies each lane, latency accumulators) around the
    executor-owned device pool."""

    def __init__(self, server: "MBEServer", bucket: BucketSpec,
                 n_lanes: int):
        self.bucket = bucket
        self.cfg = server._engine_config(bucket)
        self.B = n_lanes
        self.pool = server.executor.new_pool(self.cfg, n_lanes,
                                             engine=server.engine)
        self.reqs: list[Request | None] = [None] * n_lanes
        self._queue_s = [0.0] * n_lanes
        self._service_s = [0.0] * n_lanes
        self._compile_s = [0.0] * n_lanes

    # ------------------------------------------------------------------
    def n_live(self) -> int:
        return sum(r is not None for r in self.reqs)

    def refill(self, queue: "_PendingQueue", server: "MBEServer") -> int:
        """Place queued requests into free lanes (one batched row scatter,
        not one full-pool copy per lane).  The queue pops highest-priority
        first, so a later high-priority admit overtakes the FIFO backlog
        at placement time."""
        idx, states, ctxs = [], [], []
        for i in range(self.B):
            if self.reqs[i] is not None or not queue:
                continue
            r = queue.popleft()
            idx.append(i)
            dev = server.executor.device
            ctxs.append(server.engine.make_context(r.graph, self.cfg, dev))
            snap = server._resume.pop(r.rid, None)
            if snap is not None:
                # failover / quarantine-exoneration resume: the lane
                # restarts from its last host-side checkpoint, on this
                # executor's device (engines are deterministic, so the
                # rounds replayed since the snapshot are bit-identical)
                states.append(restore_state(snap.state, dev))
                self._queue_s[i] = snap.queue_s
                self._service_s[i] = snap.service_s
                self._compile_s[i] = snap.compile_s
            else:
                states.append(server.engine.fresh_lane_state(
                    self.cfg, r.graph.n_u, dev))
                self._queue_s[i] = time.perf_counter() - r.t_admit
                self._service_s[i] = 0.0
                self._compile_s[i] = 0.0
            self.reqs[i] = r
        if idx:
            server.executor.install(self.pool, idx, states, ctxs)
        return len(idx)

    def run_round(self, server: "MBEServer") -> bool:
        """One bounded executor round over all lanes; occupancy
        accounting.  Returns False when the recovery layer consumed the
        round instead (retries exhausted -> quarantine)."""
        budget = server._round_budget()
        tel = server._run_pool_round(self, budget)
        if tel is None:
            return False
        exec_s = max(tel.wall_s - tel.compile_s, 0.0)
        adv = tel.adv                                   # per-lane steps
        busy = int(adv.sum())
        crit = int(adv.max()) if self.B else 0          # round critical path
        server._n_rounds += 1
        server._busy_steps += busy
        server._total_lane_steps += self.B * crit
        server._exec_wall_s += exec_s
        # launch accounting: the round's critical path ran ceil(crit/spc)
        # compiled segments, each costing launches_per_segment kernel
        # dispatches (1 per pool on the multi-lane path, B on vmap)
        spc = max(server.policy.steps_per_call, 1)
        segments = (crit + spc - 1) // spc
        server._n_launches += \
            segments * server.executor.launches_per_segment(self.pool)
        if server.resident_rebalance and budget is not None:
            # steps a lane ran beyond its own round budget came from
            # donated surplus (the scoreboard rebalance)
            server._rebalanced_steps += int(np.maximum(adv - budget,
                                                       0).sum())
        for i, r in enumerate(self.reqs):
            if r is None:
                continue
            self._service_s[i] += exec_s
            self._compile_s[i] += tel.compile_s
        return True

    def enforce_step_cap(self, server: "MBEServer") -> None:
        """Terminate lanes that blew ``max_graph_steps`` with a typed
        ``status="step_capped"`` result (the ``rejected``/``timed_out``
        pattern): a runaway graph never aborts the caller's ``poll()``.
        ``MBEServer(strict_step_cap=True)`` preserves the historical
        evict-then-raise instead.

        Called AFTER demux, so results computed in the offending round are
        already delivered; eviction (dummy state surgery) frees the slot
        and keeps the server serviceable, so queued and in-flight requests
        are never lost to a runaway graph."""
        cap = server.max_graph_steps
        if cap is None:
            return
        done = server._pool_done_mask(self)
        steps = server.executor.steps(self.pool)
        dead = [i for i, r in enumerate(self.reqs)
                if r is not None and not done[i] and int(steps[i]) >= cap]
        if not dead:
            return
        if server.strict_step_cap:
            names = [f"request {self.reqs[i].rid} "
                     f"({self.reqs[i].graph.name})" for i in dead]
            for i in dead:
                server.executor.evict(self.pool, i)
                self.reqs[i] = None
            raise RuntimeError(
                f"{'; '.join(names)} exceeded max_graph_steps={cap} "
                f"without finishing; evicted (other requests remain "
                f"servable)")
        for i in dead:
            r = self.reqs[i]
            counters = server._lane_counters(
                server.executor.lane(self.pool, i))
            server.executor.evict(self.pool, i)
            self.reqs[i] = None
            server._completed[r.rid] = server._flagged_result(
                r, queue_s=self._queue_s[i],
                service_s=self._service_s[i],
                compile_s=self._compile_s[i], counters=counters,
                step_capped=True)

    def demux(self, server: "MBEServer") -> dict[int, EngineResult]:
        """Decode every finished lane into a result and free its slot.
        The payload comes from ``Engine.finish`` — the scheduler never
        names a concrete result class."""
        done = server._pool_done_mask(self)
        results: dict[int, EngineResult] = {}
        for i, r in enumerate(self.reqs):
            if r is None or not done[i]:
                continue
            lane = server.executor.lane(self.pool, i)
            payload = server.engine.finish(
                self.cfg, lane, n_u=r.graph.n_u, n_v=r.graph.n_v,
                swapped=r.swapped, collect=server.collect)
            results[r.rid] = server.engine.make_result(
                rid=r.rid, name=r.graph.name,
                latency_s=(self._queue_s[i] + self._service_s[i]
                           + self._compile_s[i]),
                queue_s=self._queue_s[i],
                service_s=self._service_s[i],
                compile_s=self._compile_s[i], **payload)
            self.reqs[i] = None
        return results


class _BigSlot:
    """Host-side bookkeeping for the active big-graph request: the
    work-stealing lane plus the request's latency accumulators."""

    def __init__(self, lane: BigGraphLane, req: Request, queue_s: float):
        self.lane = lane
        self.req = req
        self.queue_s = queue_s
        self.service_s = 0.0
        self.compile_s = 0.0


class MBEServer:
    """Continuous-batching multi-graph MBE serving (main path)."""

    def __init__(self, policy: BucketPolicy | None = None,
                 collect_cap: int = 1, collect: bool = False,
                 order_mode: str = "deg", impl: str = "jnp",
                 kernel_impl: str = "auto",
                 max_graph_steps: int | None = None,
                 executor: Executor | None = None,
                 cache_capacity: int | None =
                 ExecutableCache.DEFAULT_CAPACITY,
                 engine: str | Engine = "dense",
                 engine_params: dict | None = None,
                 resident_lanes: int | str = "auto",
                 resident_rebalance: bool = False,
                 admission: AdmissionController | AdmissionPolicy
                 | None = None,
                 trace_path: str | None = None,
                 retry: RetryPolicy | None = None,
                 fault_injector: FaultPlan | None = None,
                 strict_step_cap: bool = False,
                 failover_executor: Executor | None = None,
                 device: str = "cuda"):
        self.policy = policy or BucketPolicy()
        self.collect_cap = collect_cap
        self.collect = collect
        self.engine_params = dict(engine_params or {})
        self.order_mode = order_mode
        self.impl = impl
        self.kernel_impl = kernel_impl
        self.resident_lanes = resident_lanes
        self.resident_rebalance = resident_rebalance
        self.max_graph_steps = max_graph_steps
        self.strict_step_cap = strict_step_cap
        self.executor = executor or LocalExecutor(device=device)
        # fault / recovery (serving.faults, serving.recovery) and the SLO
        # layer (serving.slo): all OFF by default, and then the admit /
        # poll / demux paths take no extra branch
        self.retry = retry
        self.failover_executor = failover_executor
        self._injectors: list[FaultInjector] = []
        if fault_injector is not None:
            self.executor = FaultInjector(self.executor, fault_injector)
            self._injectors.append(self.executor)
        self._ckpt = CheckpointStore() if retry is not None else None
        self._resume: dict[int, object] = {}    # rid -> LaneSnapshot to
        #                                         restore at next placement
        self._poll_i = 0
        self._failed_over = False
        self.engine = get_engine(engine)
        self.cache = ExecutableCache(capacity=cache_capacity)
        self.admission = (AdmissionController(admission)
                          if isinstance(admission, AdmissionPolicy)
                          else admission)
        self.trace = TraceRecorder(trace_path) if trace_path else None
        self.routing_log: list[dict] = []
        self._queues: dict[BucketSpec, _PendingQueue] = {}
        self._pools: dict[BucketSpec, _LanePool] = {}
        self._big_queue: _PendingQueue = _PendingQueue()
        self._big: _BigSlot | None = None
        self._completed: dict[int, EngineResult] = {}
        self._next_rid = 0
        self._rid_tenant: dict[int, str] = {}
        self._sinks: list = []
        self.reset_stats()

    # ------------------------------------------------------------------
    def admit(self, g: BipartiteGraph, priority: int = 0,
              deadline_s: float | None = None,
              tenant: str = "default") -> int:
        """Enqueue one graph; returns the request id used to demux (see
        the reference for canonicalisation, priority and deadlines).
        With an admission controller attached the request may be refused
        here: it never queues, and its typed ``status == "rejected"``
        result is delivered by the next ``poll`` / ``reap``."""
        gc = g.canonical() if self.engine.canonicalize else g
        if gc.n_u < 1:
            raise ValueError("empty graphs are not servable")
        rid = self._next_rid
        self._next_rid += 1
        route = plan_route(gc, self.policy)
        bucket = plan_bucket(gc, self.policy)
        t0 = time.perf_counter()
        req = Request(rid, gc, bucket,
                      swapped=self.engine.canonicalize and g.n_u > g.n_v,
                      t_admit=t0, big=route == "big", priority=priority,
                      deadline=None if deadline_s is None
                      else t0 + float(deadline_s),
                      deadline_s=deadline_s, tenant=tenant)
        self._rid_tenant[rid] = tenant
        if self.admission is not None:
            decision = self._offer_admission(req)
            if not decision.admitted:
                self._n_rejected += 1
                self._tenant_stat(tenant, "rejected")
                self._completed[rid] = self._flagged_result(
                    req, queue_s=0.0, rejected=True,
                    reject_reason=decision.reason)
                if self.trace is not None:
                    self.trace.admit(
                        rid=rid, name=gc.name, n_u=gc.n_u, n_v=gc.n_v,
                        engine=self.engine.name, route=route,
                        bucket=(bucket.n_u, bucket.n_v),
                        priority=priority, deadline_s=deadline_s,
                        tenant=tenant, admitted=False,
                        reason=decision.reason)
                return rid
        self._n_admitted += 1
        self._tenant_stat(tenant, "admitted")
        if self.trace is not None:
            self.trace.admit(
                rid=rid, name=gc.name, n_u=gc.n_u, n_v=gc.n_v,
                engine=self.engine.name, route=route,
                bucket=(bucket.n_u, bucket.n_v), priority=priority,
                deadline_s=deadline_s, tenant=tenant, admitted=True)
        thr = self.policy.big_graph_threshold
        if req.big:
            self._big_queue.append(req)
            self.routing_log.append(dict(
                event="route", rid=rid, graph=gc.name, route="big",
                bucket=(bucket.n_u, bucket.n_v),
                executor=self.executor.name,
                reason=f"n_u={gc.n_u} >= big_graph_threshold={thr}: "
                       f"root tasks spread over mesh workers with "
                       f"work stealing"))
        else:
            self._queues.setdefault(bucket, _PendingQueue()).append(req)
            self.routing_log.append(dict(
                event="route", rid=rid, graph=gc.name, route="lane",
                bucket=(bucket.n_u, bucket.n_v),
                executor=self.executor.name,
                reason=("no big_graph_threshold set" if thr is None else
                        f"n_u={gc.n_u} < big_graph_threshold={thr}")
                + ": one vmap lane in the bucket pool"))
        return rid

    submit = admit

    def _tenant_stat(self, tenant: str, key: str, n: int = 1) -> None:
        t = self._per_tenant.setdefault(
            tenant, dict(admitted=0, rejected=0, completed=0,
                         cancelled=0, timed_out=0, failed=0,
                         step_capped=0))
        t[key] += n

    # -- admission (serving.slo) ----------------------------------------
    def _tenants_pending(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for q in [*self._queues.values(), self._big_queue]:
            for r in q:
                out[r.tenant] = out.get(r.tenant, 0) + 1
        return out

    def _bucket_backlog_steps(self, bucket: BucketSpec) -> int:
        """Estimated engine steps queued + in flight ahead of a new
        request in this bucket: the shape estimate of every pending
        request, half of it for each in-flight lane (its progress is
        unknown without a device read)."""
        cost = self.admission.policy.cost
        est = 0
        for r in self._queues.get(bucket, ()):
            est += cost.estimate_steps(r.graph.n_u, r.graph.n_v)
        pool = self._pools.get(bucket)
        if pool is not None:
            for r in pool.reqs:
                if r is not None:
                    est += cost.estimate_steps(r.graph.n_u,
                                               r.graph.n_v) // 2
        return est

    def _offer_admission(self, req: Request):
        bucket = req.bucket
        backlog = len(self._queues.get(bucket, ()))
        pool = self._pools.get(bucket)
        lanes = pool.B if pool is not None else \
            self.executor.plan_lanes(backlog + 1, self.policy)
        return self.admission.offer(
            n_u=req.graph.n_u, n_v=req.graph.n_v,
            bucket=(bucket.n_u, bucket.n_v),
            route="big" if req.big else "lane", tenant=req.tenant,
            deadline_s=req.deadline_s,
            pending=(sum(len(q) for q in self._queues.values())
                     + len(self._big_queue)),
            tenants_pending=self._tenants_pending(),
            backlog_steps=self._bucket_backlog_steps(bucket),
            lanes=lanes)

    # ------------------------------------------------------------------
    def _engine_config(self, bucket: BucketSpec):
        return self.engine.config(
            bucket.n_u, bucket.n_v, bucket.depth,
            collect_cap=self.collect_cap, order_mode=self.order_mode,
            impl=self.impl, kernel_impl=self.kernel_impl,
            resident_lanes=self.resident_lanes,
            resident_rebalance=self.resident_rebalance,
            **self.engine_params)

    def _round_budget(self) -> int | None:
        spr = self.policy.steps_per_round
        if spr > 0:
            return spr
        return self.max_graph_steps

    def _buckets_with_work(self) -> list[BucketSpec]:
        live = {b for b, q in self._queues.items() if q} \
            | {b for b, p in self._pools.items() if p.n_live()}
        return sorted(live, key=lambda b: (b.n_u, b.n_v))

    def _has_work(self) -> bool:
        return bool(self._buckets_with_work() or self._big_queue
                    or self._big is not None)

    def _ensure_pool(self, bucket: BucketSpec) -> _LanePool:
        pool = self._pools.get(bucket)
        backlog = len(self._queues.get(bucket, ()))
        if pool is None:
            n = self.executor.plan_lanes(backlog, self.policy)
            pool = _LanePool(self, bucket, n)
            self._pools[bucket] = pool
            self.routing_log.append(dict(
                event="pool", bucket=(bucket.n_u, bucket.n_v), lanes=n,
                executor=self.executor.name,
                placement=self.executor.placement(n)))
        else:
            desired = self.executor.plan_lanes(pool.n_live() + backlog,
                                               self.policy)
            if desired > pool.B:
                pool = self._grow_pool(bucket, pool, desired)
        return pool

    def _grow_pool(self, bucket: BucketSpec, old: _LanePool,
                   n_lanes: int) -> _LanePool:
        new = _LanePool(self, bucket, n_lanes)
        live = [i for i, r in enumerate(old.reqs) if r is not None]
        if live:
            self.executor.migrate(old.pool, new.pool, live)
            for j, i in enumerate(live):
                new.reqs[j] = old.reqs[i]
                new._queue_s[j] = old._queue_s[i]
                new._service_s[j] = old._service_s[i]
                new._compile_s[j] = old._compile_s[i]
        self._pools[bucket] = new
        self.routing_log.append(dict(
            event="pool-grow", bucket=(bucket.n_u, bucket.n_v),
            lanes=n_lanes, was=old.B, executor=self.executor.name,
            placement=self.executor.placement(n_lanes)))
        return new

    # -- big-graph lane -------------------------------------------------
    def _start_big(self) -> None:
        req = self._big_queue.popleft()
        cfg = self._engine_config(req.bucket)
        ctx = self.engine.make_context(req.graph, cfg, self.executor.device)
        lane = self.executor.big_lane(cfg, ctx, req.graph.n_u, self.cache,
                                      self.policy.steps_per_round or None,
                                      engine=self.engine,
                                      steps_per_call=
                                      self.policy.steps_per_call)
        self._big = _BigSlot(lane, req,
                             queue_s=time.perf_counter() - req.t_admit)
        self.routing_log.append(dict(
            event="big-lane", rid=req.rid, graph=req.graph.name,
            bucket=(req.bucket.n_u, req.bucket.n_v),
            executor=self.executor.name, placement=lane.placement()))

    def _poll_big(self) -> None:
        """Advance the big-graph lane one work-stealing round: place the
        next queued big request if the lane is free, run a round, demux on
        completion, enforce the step cap (typed ``step_capped`` result,
        or evict-then-raise under ``strict_step_cap``)."""
        if self._big is None:
            if not self._big_queue:
                return
            self._start_big()
        slot = self._big
        try:
            tel = self._with_retry("big", slot.lane.run_round,
                                   deadline=slot.req.deadline)
        except DeviceLostError:
            raise
        except (self.retry.retry_on if self.retry is not None
                else ()) as e:
            # retries exhausted and the lane is alone on its route: the
            # big graph IS the poison — fail it, keep serving the queue
            self._n_quarantined += 1
            counters = self.engine.stacked_counters(slot.lane.state)
            self._big = None
            self._completed[slot.req.rid] = self._flagged_result(
                slot.req, queue_s=slot.queue_s,
                service_s=slot.service_s, compile_s=slot.compile_s,
                counters=counters, failed=True,
                fail_reason=f"big-graph round failed "
                            f"{self.retry.max_attempts}x: {e}")
            if self.trace is not None:
                self.trace.recovery(action="quarantine",
                                    detail=f"big rid={slot.req.rid}")
            return
        exec_s = max(tel.wall_s - tel.compile_s, 0.0)
        slot.service_s += exec_s
        slot.compile_s += tel.compile_s
        # the big lane enters the same occupancy ledger as the pools:
        # busy = steps actually advanced, total = workers x critical path
        busy = int(tel.adv.sum())
        crit = int(tel.adv.max())
        self._n_rounds += 1
        self._busy_steps += busy
        self._total_lane_steps += slot.lane.n_workers * crit
        self._exec_wall_s += exec_s
        # launch accounting mirrors the pool rounds: each device advances
        # wpd workers, in ONE pool launch per segment when the multi-lane
        # kernel is active, else wpd
        spc = max(self.policy.steps_per_call, 1)
        segments = (crit + spc - 1) // spc
        n_dev = slot.lane.n_devices
        wpd = slot.lane.n_workers // n_dev
        pw = self.engine.pool_lanes(slot.lane.cfg, wpd,
                                    self.executor.device)
        self._n_launches += segments * n_dev * (1 if pw else wpd)
        if self._big_busy_per_worker is None:
            self._big_busy_per_worker = np.zeros(slot.lane.n_workers,
                                                 np.int64)
        if len(self._big_busy_per_worker) == slot.lane.n_workers:
            self._big_busy_per_worker += tel.adv
        if slot.lane.done:
            self._completed[slot.req.rid] = self._demux_big(slot)
            self._big = None
            return
        cap = self.max_graph_steps
        if cap is not None and slot.lane.max_worker_steps() >= cap:
            rid, name = slot.req.rid, slot.req.graph.name
            if self.strict_step_cap:
                self._big = None    # evict: the lane is dropped whole
                raise RuntimeError(
                    f"request {rid} ({name}) exceeded "
                    f"max_graph_steps={cap} without finishing; evicted "
                    f"(other requests remain servable)")
            counters = self.engine.stacked_counters(slot.lane.state)
            self._big = None        # evict: the lane is dropped whole
            self._completed[rid] = self._flagged_result(
                slot.req, queue_s=slot.queue_s,
                service_s=slot.service_s, compile_s=slot.compile_s,
                counters=counters, step_capped=True)

    def _demux_big(self, slot: _BigSlot) -> EngineResult:
        """Merge the work-stealing workers into one result via
        ``Engine.finish_workers`` (counters summed, collect buffers
        concatenated)."""
        lane, r = slot.lane, slot.req
        payload = self.engine.finish_workers(
            lane.cfg, lane.state, lane.n_workers,
            n_u=r.graph.n_u, n_v=r.graph.n_v, swapped=r.swapped,
            collect=self.collect)
        return self.engine.make_result(
            rid=r.rid, name=r.graph.name,
            latency_s=slot.queue_s + slot.service_s + slot.compile_s,
            queue_s=slot.queue_s, service_s=slot.service_s,
            compile_s=slot.compile_s, **payload)

    # -- request lifecycle ---------------------------------------------
    def _flagged_result(self, req: Request, *, queue_s: float,
                        service_s: float = 0.0, compile_s: float = 0.0,
                        counters: dict | None = None,
                        cancelled: bool = False,
                        timed_out: bool = False,
                        rejected: bool = False,
                        reject_reason: str = "",
                        failed: bool = False,
                        fail_reason: str = "",
                        step_capped: bool = False) -> EngineResult:
        """Terminal result of a request that did not run to completion
        (cancelled, deadline-expired, refused at admission, quarantined
        as poison, or step-capped)."""
        payload = self.engine.partial(
            counters, cfg=self._engine_config(req.bucket))
        res = self.engine.make_result(
            rid=req.rid, name=req.graph.name,
            latency_s=queue_s + service_s + compile_s, queue_s=queue_s,
            service_s=service_s, compile_s=compile_s,
            cancelled=cancelled, timed_out=timed_out,
            rejected=rejected, reject_reason=reject_reason,
            failed=failed, fail_reason=fail_reason,
            step_capped=step_capped, **payload)
        self._n_cancelled += int(cancelled)
        self._n_timed_out += int(timed_out)
        self._n_failed += int(failed)
        self._n_step_capped += int(step_capped)
        self.routing_log.append(dict(
            event=("rejected" if rejected else
                   "cancel" if cancelled else
                   "failed" if failed else
                   "step-cap" if step_capped else "deadline"),
            rid=req.rid,
            graph=req.graph.name, executor=self.executor.name,
            **(dict(reason=reject_reason) if rejected else
               dict(reason=fail_reason) if failed else {})))
        return res

    def _lane_counters(self, lane) -> dict:
        return self.engine.counters(lane)

    def _drop_pool_if_idle(self, bucket: BucketSpec) -> None:
        pool = self._pools.get(bucket)
        if pool is not None and pool.n_live() == 0 \
                and not self._queues.get(bucket):
            del self._pools[bucket]

    def cancel(self, rid: int) -> bool:
        """Cancel a pending request (dropped before placement) or an
        in-flight one (lane evicted); False when too late or unknown."""
        if rid in self._completed:
            return False
        now = time.perf_counter()
        for q in [*self._queues.values(), self._big_queue]:
            req = q.remove(rid)
            if req is not None:
                self._completed[rid] = self._flagged_result(
                    req, queue_s=now - req.t_admit, cancelled=True)
                return True
        for bucket, pool in list(self._pools.items()):
            for i, r in enumerate(pool.reqs):
                if r is None or r.rid != rid:
                    continue
                counters = self._lane_counters(
                    self.executor.lane(pool.pool, i))
                self.executor.evict(pool.pool, i)
                pool.reqs[i] = None
                self._completed[rid] = self._flagged_result(
                    r, queue_s=pool._queue_s[i],
                    service_s=pool._service_s[i],
                    compile_s=pool._compile_s[i],
                    counters=counters, cancelled=True)
                self._drop_pool_if_idle(bucket)
                return True
        if self._big is not None and self._big.req.rid == rid:
            slot, self._big = self._big, None
            counters = self.engine.stacked_counters(slot.lane.state)
            self._completed[rid] = self._flagged_result(
                slot.req, queue_s=slot.queue_s, service_s=slot.service_s,
                compile_s=slot.compile_s, counters=counters,
                cancelled=True)
            return True
        return False

    def _expire_deadlines(self) -> None:
        """Complete every deadline-expired request as ``timed_out``."""
        now = time.perf_counter()
        for q in [*self._queues.values(), self._big_queue]:
            for req in q.expired(now):
                self._completed[req.rid] = self._flagged_result(
                    req, queue_s=now - req.t_admit, timed_out=True)
        for bucket, pool in list(self._pools.items()):
            for i, r in enumerate(pool.reqs):
                if r is None or r.deadline is None or now < r.deadline:
                    continue
                counters = self._lane_counters(
                    self.executor.lane(pool.pool, i))
                self.executor.evict(pool.pool, i)
                pool.reqs[i] = None
                self._completed[r.rid] = self._flagged_result(
                    r, queue_s=pool._queue_s[i],
                    service_s=pool._service_s[i],
                    compile_s=pool._compile_s[i],
                    counters=counters, timed_out=True)
            self._drop_pool_if_idle(bucket)
        big = self._big
        if big is not None and big.req.deadline is not None \
                and now >= big.req.deadline:
            self._big = None
            counters = self.engine.stacked_counters(big.lane.state)
            self._completed[big.req.rid] = self._flagged_result(
                big.req, queue_s=big.queue_s, service_s=big.service_s,
                compile_s=big.compile_s, counters=counters,
                timed_out=True)

    # -- recovery (serving.faults / serving.recovery) -------------------
    def _pool_done_mask(self, lanepool: _LanePool) -> np.ndarray:
        """The one done-mask read point: with a retry policy attached the
        read is VERIFIED (voted re-reads, ``recovery.verified_read``),
        without one it is the plain single read."""
        if self.retry is None:
            return self.executor.done_mask(lanepool.pool)
        mask, mismatches = verified_read(
            lambda: self.executor.done_mask(lanepool.pool))
        if mismatches and self.trace is not None:
            self.trace.fault(site="done_mask", kind="corrupted-read")
        return mask

    def _with_retry(self, site: str, fn, deadline: float | None = None):
        """Run ``fn`` under the retry policy: on a retryable fault sleep
        the policy's deterministic backoff (clamped so it never sleeps
        past ``deadline``) and try again, up to ``max_attempts`` tries.
        ``DeviceLostError`` is never retried here (the poll-level
        failover handles it); anything outside ``retry_on`` — a real
        kernel error among them — propagates at once."""
        pol = self.retry
        if pol is None:
            return fn()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn()
            except DeviceLostError:
                raise
            except pol.retry_on as e:
                if self.trace is not None:
                    self.trace.fault(site=site, kind=type(e).__name__)
                if attempt >= pol.max_attempts:
                    raise
                delay = pol.delay_s(site, attempt)
                if deadline is not None:
                    delay = min(delay,
                                max(deadline - time.perf_counter(), 0.0))
                self._n_retries += 1
                if self.trace is not None:
                    self.trace.retry(site=site, attempt=attempt,
                                     delay_s=delay)
                if delay > 0:
                    time.sleep(delay)

    def _run_pool_round(self, lanepool: _LanePool, budget):
        """One executor round with the recovery ladder: transient faults
        retried in place (an injected fault raised before the launch, so
        the state is untouched), retries exhausted -> quarantine
        bisection, device-lost -> the poll-level failover.  Returns the
        round's telemetry, or None when quarantine consumed the round."""
        def run():
            return self.executor.run_round(
                lanepool.pool, self.cache, budget,
                unroll=self.policy.steps_per_call)

        if self.retry is None:
            return run()
        deadlines = [r.deadline for r in lanepool.reqs
                     if r is not None and r.deadline is not None]
        site = f"pool[{lanepool.bucket.n_u}x{lanepool.bucket.n_v}]"
        try:
            return self._with_retry(
                site, run, deadline=min(deadlines) if deadlines else None)
        except DeviceLostError:
            raise
        except self.retry.retry_on as e:
            self._quarantine(lanepool, e)
            return None

    def _probe_fails(self, lanepool: _LanePool, reqs: list[Request],
                     budget) -> bool:
        """Quarantine probe: install ``reqs`` fresh into the emptied
        pool, run one round under the retry policy, evict again.  True
        means the group still fails after retries.  Probe work is
        throwaway and enters no occupancy ledger."""
        dev = self.executor.device
        idx = list(range(len(reqs)))
        states = [self.engine.fresh_lane_state(lanepool.cfg, r.graph.n_u,
                                               dev) for r in reqs]
        ctxs = [self.engine.make_context(r.graph, lanepool.cfg, dev)
                for r in reqs]
        self.executor.install(lanepool.pool, idx, states, ctxs)
        try:
            self._with_retry(
                "quarantine-probe",
                lambda: self.executor.run_round(
                    lanepool.pool, self.cache, budget,
                    unroll=self.policy.steps_per_call))
            return False
        except DeviceLostError:
            raise
        except self.retry.retry_on:
            return True
        finally:
            for i in idx:
                self.executor.evict(lanepool.pool, i)

    def _quarantine(self, lanepool: _LanePool, err: Exception) -> None:
        """A pool failed ``max_attempts`` consecutive launches: evict
        every live lane, bisect the suspects with fresh-restart probes,
        requeue the exonerated (resuming from their checkpoints), and
        fail the isolated request — confirmed by a solo probe — as a
        typed ``status="failed"`` result.  A solo probe that passes means
        a transient streak: everyone is requeued, nobody failed."""
        bucket = lanepool.bucket
        queue = self._queues.setdefault(bucket, _PendingQueue())
        suspects: list[Request] = []
        for i, r in enumerate(lanepool.reqs):
            if r is None:
                continue
            suspects.append(r)
            self.executor.evict(lanepool.pool, i)
            lanepool.reqs[i] = None
        self.routing_log.append(dict(
            event="quarantine", bucket=(bucket.n_u, bucket.n_v),
            suspects=[r.rid for r in suspects],
            executor=self.executor.name, reason=str(err)))
        if self.trace is not None:
            self.trace.recovery(
                action="quarantine",
                detail=f"bucket={bucket.n_u}x{bucket.n_v} "
                       f"suspects={[r.rid for r in suspects]}")
        budget = self._round_budget()
        cand, cleared = suspects, []
        while len(cand) > 1:
            half, rest = cand[: len(cand) // 2], cand[len(cand) // 2:]
            if self._probe_fails(lanepool, half, budget):
                cleared.extend(rest)
                cand = half
            else:
                cleared.extend(half)
                cand = rest
        poison = cand[0] if cand else None
        if poison is not None and len(suspects) > 1 \
                and not self._probe_fails(lanepool, [poison], budget):
            cleared.append(poison)      # transient streak, not poison:
            poison = None               # nobody gets failed
        for r in cleared:
            snap = self._ckpt.get(r.rid) if self._ckpt is not None \
                else None
            if snap is not None:
                self._resume[r.rid] = snap
            queue.append(r)
        if poison is None:
            return
        self._n_quarantined += 1
        self._completed[poison.rid] = self._flagged_result(
            poison, queue_s=time.perf_counter() - poison.t_admit,
            failed=True,
            fail_reason=f"quarantined: pool round failed "
                        f"{self.retry.max_attempts}x and bisection "
                        f"isolated this request ({err})")

    def _maybe_checkpoint(self) -> None:
        """Every ``checkpoint_interval`` polls, snapshot every live
        lane's engine state host-side (keyed by rid).  The big-graph
        lane is not checkpointed: failover restarts it fresh."""
        pol = self.retry
        if pol is None or self._ckpt is None \
                or pol.checkpoint_interval <= 0:
            return
        self._poll_i += 1
        if self._poll_i % pol.checkpoint_interval:
            return
        for pool in self._pools.values():
            for i, r in enumerate(pool.reqs):
                if r is None:
                    continue
                self._ckpt.put(
                    r.rid, self.executor.lane(pool.pool, i),
                    queue_s=pool._queue_s[i],
                    service_s=pool._service_s[i],
                    compile_s=pool._compile_s[i])
                self._n_checkpoints += 1
        if self.trace is not None:
            self.trace.recovery(action="checkpoint",
                                detail=f"{len(self._ckpt)} lane(s)")

    def _failover(self, err: Exception) -> None:
        """Persistent executor failure: swap to ``failover_executor``,
        by default a fresh ``LocalExecutor`` on the failed executor's
        device (never the CPU in its place), requeue every in-flight
        request — lane requests resume from their host-side checkpoints,
        the big-graph request restarts fresh — and record the event.  An
        injector follows onto the new executor with its device-lost
        clock disarmed."""
        self._n_failovers += 1
        self._failed_over = True
        old_name = self.executor.name
        inner = self.failover_executor or LocalExecutor(
            device=str(self.executor.device))
        if isinstance(self.executor, FaultInjector):
            new_exec = self.executor.for_failover(inner)
            self._injectors.append(new_exec)
        else:
            new_exec = inner
        self.executor = new_exec
        for bucket, pool in list(self._pools.items()):
            q = self._queues.setdefault(bucket, _PendingQueue())
            for r in pool.reqs:
                if r is None:
                    continue
                snap = self._ckpt.get(r.rid) if self._ckpt is not None \
                    else None
                if snap is not None:
                    self._resume[r.rid] = snap
                q.append(r)
        self._pools.clear()             # the dead executor's buffers go
        #                                 with it
        if self._big is not None:
            self._big_queue.append(self._big.req)
            self._big = None
        self.routing_log.append(dict(
            event="failover", was=old_name, now=self.executor.name,
            reason=str(err)))
        if self.trace is not None:
            self.trace.recovery(
                action="failover",
                detail=f"{old_name} -> {self.executor.name}: {err}")

    # ------------------------------------------------------------------
    def _poll_once(self) -> None:
        """One scheduling round, wrapped in the device-lost failover: a
        ``DeviceLostError`` escaping the round triggers ONE failover and
        the poll re-runs on the new executor.  Without a retry policy (or
        with ``failover=False``, or after the one failover) it
        propagates."""
        try:
            self._poll_inner()
        except DeviceLostError as e:
            if self.retry is None or not self.retry.failover \
                    or self._failed_over:
                raise
            self._failover(e)
            self._poll_inner()

    def _poll_inner(self) -> None:
        """One scheduling round: expire deadlines, advance the big-graph
        lane, then for every bucket with work refill free lanes, run one
        bounded round, demux into the stash, enforce the step cap; then
        the checkpoint and the trace's poll event."""
        self._expire_deadlines()
        self._poll_big()
        for bucket in self._buckets_with_work():
            queue = self._queues.setdefault(bucket, _PendingQueue())
            pool = self._ensure_pool(bucket)
            placed = pool.refill(queue, self)
            self._n_lanes += placed
            if pool.n_live() == 0:
                del self._pools[bucket]
                continue
            self._n_pad_lanes += pool.B - pool.n_live()
            if pool.run_round(self):
                self._completed.update(pool.demux(self))
                pool.enforce_step_cap(self)
            if pool.n_live() == 0 and not queue:
                del self._pools[bucket]
        self._maybe_checkpoint()
        if self.trace is not None:
            self.trace.poll(
                busy_steps=self._busy_steps,
                total_lane_steps=self._total_lane_steps,
                exec_s=self._exec_wall_s,
                pending=(sum(len(q) for q in self._queues.values())
                         + len(self._big_queue)),
                in_flight=(sum(p.n_live() for p in self._pools.values())
                           + (1 if self._big is not None else 0)),
                compiles=self.cache.misses)

    def _take_completed(self) -> dict[int, EngineResult]:
        out, self._completed = self._completed, {}
        if out:
            for rid, res in out.items():
                if self._ckpt is not None:      # delivered: snapshot and
                    self._ckpt.pop(rid)         # any pending resume are
                    self._resume.pop(rid, None)  # dead weight
                tenant = self._rid_tenant.pop(rid, None)
                if tenant is not None and not res.rejected:
                    st = res.status
                    self._tenant_stat(
                        tenant, "completed" if st == "done" else st)
                if self.trace is not None:
                    self.trace.result(
                        rid=rid, status=res.status,
                        steps=int(res.steps), nodes=int(res.nodes),
                        metric=int(res.metric), queue_s=res.queue_s,
                        service_s=res.service_s,
                        compile_s=res.compile_s,
                        latency_s=res.latency_s)
            for sink in self._sinks:
                sink(out)
        return out

    def add_completion_sink(self, fn) -> None:
        """Register a callable invoked with every ``{rid: result}`` batch
        at delivery time."""
        self._sinks.append(fn)

    def reap(self) -> dict[int, EngineResult]:
        """Deliver stashed results without running a round."""
        return self._take_completed()

    def has_work(self) -> bool:
        return self._has_work()

    def poll(self) -> dict[int, EngineResult]:
        self._poll_once()
        return self._take_completed()

    def drain(self) -> dict[int, EngineResult]:
        while self._has_work():
            self._poll_once()
        return self._take_completed()

    def flush(self) -> dict[int, EngineResult]:
        return self.drain()

    def serve(self, graphs: list[BipartiteGraph]) -> list[EngineResult]:
        rids = [self.admit(g) for g in graphs]
        res = self.drain()
        return [res[rid] for rid in rids]

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        total = self._total_lane_steps
        busy_pw = self._big_busy_per_worker
        return dict(batches=self._n_rounds, lanes=self._n_lanes,
                    pad_lanes=self._n_pad_lanes,
                    pending=(sum(len(q) for q in self._queues.values())
                             + len(self._big_queue)),
                    in_flight=(sum(p.n_live()
                                   for p in self._pools.values())
                               + (1 if self._big is not None else 0)),
                    busy_steps=self._busy_steps,
                    total_lane_steps=total,
                    idle_lane_steps=total - self._busy_steps,
                    occupancy=(self._busy_steps / total) if total else 0.0,
                    kernel_impl=self.kernel_impl,
                    steps_per_call=self.policy.steps_per_call,
                    steps_per_poll=(self._busy_steps / self._n_rounds
                                    if self._n_rounds else 0.0),
                    resident_lanes=self.resident_lanes,
                    launches=self._n_launches,
                    launches_per_poll=(self._n_launches / self._n_rounds
                                       if self._n_rounds else 0.0),
                    rebalanced_steps=self._rebalanced_steps,
                    executor=self.executor.name,
                    engine=self.engine.name,
                    cancelled=self._n_cancelled,
                    timed_out=self._n_timed_out,
                    # fault / recovery ledger: faults_injected sums
                    # every injector this server has owned (the
                    # pre-failover one included), minus the reset base
                    failed=self._n_failed,
                    step_capped=self._n_step_capped,
                    retries=self._n_retries,
                    faults_injected=(sum(i.n_injected
                                         for i in self._injectors)
                                     - self._faults_base),
                    checkpoints=self._n_checkpoints,
                    quarantined=self._n_quarantined,
                    failovers=self._n_failovers,
                    # admission ledger (all zero with no controller)
                    admitted=self._n_admitted,
                    rejected=self._n_rejected,
                    shed=self._rejected_by("shed"),
                    rejected_backpressure=self._rejected_by("backpressure"),
                    rejected_fairness=self._rejected_by("fairness"),
                    per_tenant={t: dict(c)
                                for t, c in self._per_tenant.items()},
                    big_busy_per_worker=([] if busy_pw is None
                                         else busy_pw.tolist()),
                    # the big lane's live Fig.-5 balance number (1.0 when
                    # no big request ran)
                    big_imbalance=(1.0 if busy_pw is None
                                   else imbalance(busy_pw)),
                    **self.cache.stats())

    def reset_stats(self) -> None:
        """Zero the monotonic counters (``MONOTONIC_STATS``); gauges and
        configuration echoes are untouched."""
        self._n_rounds = 0
        self._n_lanes = 0
        self._n_pad_lanes = 0
        self._busy_steps = 0
        self._total_lane_steps = 0
        self._exec_wall_s = 0.0
        self._n_launches = 0
        self._rebalanced_steps = 0
        self._n_cancelled = 0
        self._n_timed_out = 0
        self._n_failed = 0
        self._n_step_capped = 0
        self._n_retries = 0
        self._n_checkpoints = 0
        self._n_quarantined = 0
        self._n_failovers = 0
        self._faults_base = sum(i.n_injected for i in self._injectors)
        self._n_admitted = 0
        self._n_rejected = 0
        self._per_tenant: dict[str, dict] = {}
        self._big_busy_per_worker: np.ndarray | None = None
        if self.admission is not None:
            self.admission.reset_stats()
        self.cache.reset_counters()

    def _rejected_by(self, reason: str) -> int:
        return (self.admission.rejected_by_reason[reason]
                if self.admission is not None else 0)

    def close_trace(self) -> None:
        """Flush and close the JSONL trace, if one is attached (a no-op
        otherwise; idempotent)."""
        if self.trace is not None:
            self.trace.close()
