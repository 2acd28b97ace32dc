"""Continuous-batching MBE scheduler: slot admission + mid-flight refill.

Twin of ``src/repro/serving/scheduler.py``, main path only: ``Request``,
``_PendingQueue``, ``_LanePool`` (refill / run_round / step cap / demux)
and ``MBEServer`` with admit / poll / drain / flush / serve / cancel /
deadlines / reap / stats / reset_stats, over the ``LocalExecutor``.  See
the reference module for the slot model, the routing and the accounting.

``stats()`` keeps the reference's full ``STATS_SCHEMA`` key set.  Keys of
features not ported yet report their neutral values (0, ``{}``, ``[]``,
1.0).  Those features raise ``NotImplementedError`` when asked for,
naming the ROADMAP Queue 1 item that ports them: admission control and
tracing (item 9), retry / fault injection / failover (item 10), the
big-graph lane (item 8).
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
from repro_torch.serving.executor import Executor, LocalExecutor


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
            ctxs.append(server.engine.make_context(
                r.graph, self.cfg, server.executor.device))
            states.append(server.engine.fresh_lane_state(
                self.cfg, r.graph.n_u, server.executor.device))
            self._queue_s[i] = time.perf_counter() - r.t_admit
            self._service_s[i] = 0.0
            self._compile_s[i] = 0.0
            self.reqs[i] = r
        if idx:
            server.executor.install(self.pool, idx, states, ctxs)
        return len(idx)

    def run_round(self, server: "MBEServer") -> bool:
        """One bounded executor round over all lanes; occupancy
        accounting.  Returns True (the reference returns False when its
        recovery layer consumed the round, which is not ported yet)."""
        budget = server._round_budget()
        tel = server.executor.run_round(
            self.pool, server.cache, budget,
            unroll=server.policy.steps_per_call)
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
        done = server.executor.done_mask(self.pool)
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
        done = server.executor.done_mask(self.pool)
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
                 admission=None, trace_path: str | None = None,
                 retry=None, fault_injector=None,
                 strict_step_cap: bool = False,
                 failover_executor: Executor | None = None,
                 device: str = "cuda"):
        not_yet = [("admission", admission, 9),
                   ("trace_path", trace_path, 9),
                   ("retry", retry, 10), ("fault_injector", fault_injector, 10),
                   ("failover_executor", failover_executor, 10)]
        for name, value, item in not_yet:
            if value is not None:
                raise NotImplementedError(
                    f"MBEServer({name}=...) is not ported yet "
                    f"(ROADMAP Queue 1 item {item})")
        self.policy = policy or BucketPolicy()
        if self.policy.big_graph_threshold is not None:
            raise NotImplementedError(
                "big_graph_threshold routes to the work-stealing big-graph "
                "lane, which is not ported yet (ROADMAP Queue 1 item 8)")
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
        self.engine = get_engine(engine)
        self.cache = ExecutableCache(capacity=cache_capacity)
        self.routing_log: list[dict] = []
        self._queues: dict[BucketSpec, _PendingQueue] = {}
        self._pools: dict[BucketSpec, _LanePool] = {}
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
        the reference for canonicalisation, priority and deadlines)."""
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
        self._n_admitted += 1
        self._tenant_stat(tenant, "admitted")
        self._rid_tenant[rid] = tenant
        self._queues.setdefault(bucket, _PendingQueue()).append(req)
        self.routing_log.append(dict(
            event="route", rid=rid, graph=gc.name, route="lane",
            bucket=(bucket.n_u, bucket.n_v), executor=self.executor.name,
            reason="no big_graph_threshold set"
                   + ": one vmap lane in the bucket pool"))
        return rid

    submit = admit

    def _tenant_stat(self, tenant: str, key: str, n: int = 1) -> None:
        t = self._per_tenant.setdefault(
            tenant, dict(admitted=0, rejected=0, completed=0,
                         cancelled=0, timed_out=0, failed=0,
                         step_capped=0))
        t[key] += n

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
        return bool(self._buckets_with_work())

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

    # -- request lifecycle ---------------------------------------------
    def _flagged_result(self, req: Request, *, queue_s: float,
                        service_s: float = 0.0, compile_s: float = 0.0,
                        counters: dict | None = None,
                        cancelled: bool = False,
                        timed_out: bool = False,
                        step_capped: bool = False) -> EngineResult:
        """Terminal result of a request that did not run to completion
        (cancelled, deadline-expired or step-capped)."""
        payload = self.engine.partial(
            counters, cfg=self._engine_config(req.bucket))
        res = self.engine.make_result(
            rid=req.rid, name=req.graph.name,
            latency_s=queue_s + service_s + compile_s, queue_s=queue_s,
            service_s=service_s, compile_s=compile_s,
            cancelled=cancelled, timed_out=timed_out,
            step_capped=step_capped, **payload)
        self._n_cancelled += int(cancelled)
        self._n_timed_out += int(timed_out)
        self._n_step_capped += int(step_capped)
        self.routing_log.append(dict(
            event=("cancel" if cancelled else
                   "step-cap" if step_capped else "deadline"),
            rid=req.rid, graph=req.graph.name,
            executor=self.executor.name))
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
        for q in self._queues.values():
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
        return False

    def _expire_deadlines(self) -> None:
        """Complete every deadline-expired request as ``timed_out``."""
        now = time.perf_counter()
        for q in self._queues.values():
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

    # ------------------------------------------------------------------
    def _poll_once(self) -> None:
        """One scheduling round: expire deadlines, then for every bucket
        with work refill free lanes, run one bounded round, demux into
        the stash, enforce the step cap."""
        self._expire_deadlines()
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

    def _take_completed(self) -> dict[int, EngineResult]:
        out, self._completed = self._completed, {}
        if out:
            for rid, res in out.items():
                tenant = self._rid_tenant.pop(rid, None)
                if tenant is not None:
                    st = res.status
                    self._tenant_stat(
                        tenant, "completed" if st == "done" else st)
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
        return dict(batches=self._n_rounds, lanes=self._n_lanes,
                    pad_lanes=self._n_pad_lanes,
                    pending=sum(len(q) for q in self._queues.values()),
                    in_flight=sum(p.n_live() for p in self._pools.values()),
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
                    failed=0, step_capped=self._n_step_capped,
                    retries=0, faults_injected=0, checkpoints=0,
                    quarantined=0, failovers=0,
                    admitted=self._n_admitted, rejected=0, shed=0,
                    rejected_backpressure=0, rejected_fairness=0,
                    per_tenant={t: dict(c)
                                for t, c in self._per_tenant.items()},
                    big_busy_per_worker=[], big_imbalance=1.0,
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
        self._n_step_capped = 0
        self._n_admitted = 0
        self._per_tenant: dict[str, dict] = {}
        self.cache.reset_counters()

    def close_trace(self) -> None:
        """No-op: tracing is not ported yet (ROADMAP Queue 1 item 9)."""
