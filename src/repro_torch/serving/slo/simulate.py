"""Host-side discrete-event simulator of the MBE serving pipeline.

Twin of ``src/repro/serving/slo/simulate.py`` (pure Python, copied
with the same fallback scalars, so both packages make the same
decisions).

The serving stack is buckets → executable cache → lane pools advancing
in bounded rounds; saturation questions ("will this stream meet its
deadlines?", "what does doubling ``max_batch`` buy?") can be answered
without a device because the pipeline's *structure* is host-side
bookkeeping and its *speed* reduces to three scalars:

* ``steps_per_s``      — LANE steps per wall second: a pool of ``B``
  lanes advancing ``crit`` steps in vmap lockstep costs
  ``B * crit / steps_per_s`` wall seconds (padded and finished lanes
  step too — that is the vmap barrier, and it is why this is calibrated
  against the ``total_lane_steps`` ledger, not ``busy_steps``),
* ``compile_s``        — cost of one new executable-cache entry (each
  new ``(bucket, batch, budget)`` key is one compile),
* ``round_overhead_s`` — host dispatch per scheduling round.

``CostModel`` holds them; ``CostModel.from_bench`` calibrates from a
benchmark artifact it is given (median over
``level == "engine"`` rows: measured steps/s, compile walls, and a
steps-per-cell density used to estimate a request's work from its shape
alone), and ``CostModel.from_trace`` calibrates from a measured request
trace (``repro_torch.serving.slo.trace``), which folds the *current* host +
backend speed in and is what the overload harness uses.

``simulate`` then replays a request list through a faithful host model
of the scheduler: requests arrive on the trace clock, are bucketed with
the real ``plan_bucket``/``plan_batch_size`` planner, queue
priority-FIFO per bucket, occupy lanes, advance in
``steps_per_round``-bounded rounds (critical-path timed, exactly the
vmap barrier), get demuxed and refilled mid-round — emitting the same
per-request queue/service/compile split and the same
busy/total-lane-steps occupancy ledger the real server reports.  The
simulator is deterministic and runs thousands of requests per second,
which is what makes the admission controller's at-admit completion
estimates and the planner's policy sweeps affordable.
"""
from __future__ import annotations

import dataclasses
import json
import math

from repro_torch.serving.buckets import (BucketPolicy, plan_batch_size,
                                         plan_bucket)
from repro_torch.serving.slo.trace import TraceRecord

# the JAX package's fallback scalars, copied as they are so that both
# packages make the same decisions on the same inputs; they are not a
# measurement of any card (calibrate with from_trace / from_bench)
DEFAULT_STEPS_PER_S = 4e4
DEFAULT_COMPILE_S = 0.4
DEFAULT_ROUND_OVERHEAD_S = 2e-3
DEFAULT_STEP_DENSITY = 0.6      # engine steps per (n_u * n_v) cell


@dataclasses.dataclass(frozen=True)
class CostModel:
    """The simulator's speed scalars + the shape→work estimator.

    ``steps_per_s`` is the WALL lane-step rate (advances the simulated
    clock — includes host dispatch between rounds, so queue/latency
    predictions line up with wall time); ``service_steps_per_s`` is the
    in-round EXEC rate (what the server's per-request ``service_s``
    accounting measures — device wall inside the round only).  They
    differ exactly by the host gap; when only one is known
    (``service_steps_per_s=None``) the wall rate is used for both."""

    steps_per_s: float = DEFAULT_STEPS_PER_S
    compile_s: float = DEFAULT_COMPILE_S
    round_overhead_s: float = DEFAULT_ROUND_OVERHEAD_S
    step_density: float = DEFAULT_STEP_DENSITY   # steps per n_u*n_v cell
    service_steps_per_s: float | None = None     # exec rate (see above)
    source: str = "default"

    @property
    def exec_rate(self) -> float:
        return self.service_steps_per_s or self.steps_per_s

    def estimate_steps(self, n_u: int, n_v: int) -> int:
        """Expected engine steps for a request known only by shape.
        MBE work is heavy-tailed (the paper's whole point), so this is
        an *expectation*, not a bound — admission layers slack on top."""
        return max(int(self.step_density * n_u * n_v), 1)

    # ------------------------------------------------------------------
    @classmethod
    def from_bench(cls, *paths: str) -> "CostModel":
        """Calibrate from the benchmark artifacts at ``paths``.

        Uses ``level == "engine"`` rows (benchmarks/kernels.py emits
        them with measured ``steps_per_s``, ``compile_s``, ``steps`` and
        the graph shape); medians across rows so one outlier shape
        cannot skew the model.  Rows from every given file pool
        together."""
        sps, comp, dens = [], [], []
        for path in paths:
            with open(path) as f:
                data = json.load(f)
            for row in data.get("rows", []):
                if row.get("level") != "engine":
                    continue
                if row.get("steps_per_s"):
                    sps.append(float(row["steps_per_s"]))
                if row.get("compile_s"):
                    comp.append(float(row["compile_s"]))
                if row.get("steps") and row.get("n_u") and row.get("n_v"):
                    dens.append(float(row["steps"])
                                / (row["n_u"] * row["n_v"]))
        if not sps:
            raise ValueError(f"no level=='engine' rows in {paths}")
        return cls(steps_per_s=_median(sps),
                   compile_s=_median(comp) if comp else DEFAULT_COMPILE_S,
                   step_density=(_median(dens) if dens
                                 else DEFAULT_STEP_DENSITY),
                   source=f"bench:{','.join(paths)}")

    @classmethod
    def from_trace(cls, records: list[TraceRecord],
                   polls: list[dict] | None = None) -> "CostModel":
        """Calibrate from a measured trace.

        With ``polls`` (the trace's per-round poll events,
        ``TraceReader.polls()``) the lane-step rate comes from the
        ledger deltas between consecutive polls whose compile count did
        not move — ``Δtotal_lane_steps / Δt`` is exactly the
        ``B * crit`` work unit the simulator charges, measured without
        compile walls polluting the denominator.  Without polls it falls
        back to the per-request sums (total measured steps over total
        measured service wall), which under-counts the padded-lane work
        a vmap round really does — prefer passing polls.

        Compile cost is the mean nonzero per-request compile charge;
        ``step_density`` the median measured steps per shape cell.
        Requests without a result event (or that never ran) are
        skipped."""
        steps = service = 0.0
        comp, dens = [], []
        for r in records:
            if r.steps is None or not r.steps:
                continue
            steps += r.steps
            service += r.service_s or 0.0
            if r.compile_s:
                comp.append(r.compile_s)
            dens.append(r.steps / (r.n_u * r.n_v))
        sps = exec_sps = None
        if polls:
            d_total = d_t = 0.0
            for a, b in zip(polls, polls[1:]):
                if b["compiles"] != a["compiles"]:
                    continue        # compile wall inside this delta
                d_total += b["total_lane_steps"] - a["total_lane_steps"]
                d_t += b["t"] - a["t"]
            if d_total > 0 and d_t > 0:
                sps = d_total / d_t
            # exec rate is exact: the last poll carries the cumulative
            # lane-step ledger AND the cumulative in-round exec wall
            last = polls[-1]
            if last.get("exec_s") and last["total_lane_steps"]:
                exec_sps = last["total_lane_steps"] / last["exec_s"]
        if sps is None:
            if steps <= 0 or service <= 0:
                raise ValueError("trace carries no measured service time")
            sps = steps / service
        return cls(steps_per_s=sps,
                   compile_s=(sum(comp) / len(comp)) if comp
                   else DEFAULT_COMPILE_S,
                   step_density=_median(dens) if dens
                   else DEFAULT_STEP_DENSITY,
                   service_steps_per_s=exec_sps,
                   source="trace" + (":polls" if polls else ""))


def _median(xs: list[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


# ---------------------------------------------------------------------------
# the simulated pipeline
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SimRequest:
    """One simulated request: arrival on the trace clock + the work.
    ``steps`` is the request's engine-step count — measured (replay) or
    estimated from shape (what-if streams)."""

    rid: int
    arrival_s: float
    n_u: int
    n_v: int
    steps: int
    priority: int = 0
    deadline_s: float | None = None
    tenant: str = "default"

    @classmethod
    def from_record(cls, r: TraceRecord,
                    cost: CostModel | None = None) -> "SimRequest":
        steps = r.steps
        if not steps:       # rejected / never-ran rows: estimate by shape
            steps = (cost or CostModel()).estimate_steps(r.n_u, r.n_v)
        return cls(rid=r.rid, arrival_s=r.t_arrival, n_u=r.n_u,
                   n_v=r.n_v, steps=int(steps), priority=r.priority,
                   deadline_s=r.deadline_s, tenant=r.tenant)


@dataclasses.dataclass
class SimResult:
    """Per-request prediction: same split the real server reports."""

    rid: int
    queue_s: float = 0.0
    service_s: float = 0.0
    compile_s: float = 0.0
    finish_s: float = 0.0
    timed_out: bool = False

    @property
    def latency_s(self) -> float:
        return self.queue_s + self.service_s + self.compile_s


@dataclasses.dataclass
class SimReport:
    """What one simulated serve predicts."""

    results: dict[int, SimResult]
    wall_s: float
    busy_steps: int
    total_lane_steps: int
    compiles: int
    rounds: int
    timed_out: int
    skipped_events: int = 0     # trace events the simulator does not
    #                             model (fault / retry / recovery, schema
    #                             v2): counted, never crashed on

    @property
    def occupancy(self) -> float:
        return (self.busy_steps / self.total_lane_steps
                if self.total_lane_steps else 0.0)

    @property
    def mean_latency_s(self) -> float:
        done = [r for r in self.results.values() if not r.timed_out]
        if not done:
            return 0.0
        return sum(r.latency_s for r in done) / len(done)

    @property
    def mean_service_s(self) -> float:
        done = [r for r in self.results.values() if not r.timed_out]
        if not done:
            return 0.0
        return sum(r.service_s for r in done) / len(done)


class _SimGraph:
    """Shape carrier for the real bucket planner (quacks like
    ``BipartiteGraph`` where ``plan_bucket`` is concerned)."""

    __slots__ = ("n_u", "n_v")

    def __init__(self, n_u: int, n_v: int):
        self.n_u = n_u
        self.n_v = n_v


class _SimLane:
    __slots__ = ("req", "remaining", "res")

    def __init__(self, req: SimRequest, res: SimResult):
        self.req = req
        self.remaining = req.steps
        self.res = res


class _SimPool:
    def __init__(self, B: int):
        self.B = B
        self.lanes: list[_SimLane | None] = [None] * B

    def n_live(self) -> int:
        return sum(x is not None for x in self.lanes)


def simulate(requests: list[SimRequest],
             policy: BucketPolicy | None = None,
             cost: CostModel | None = None,
             model_deadlines: bool = False) -> SimReport:
    """Discrete-event serve of ``requests`` under ``policy``.

    The event loop mirrors ``MBEServer`` poll-for-poll: admit arrivals
    whose time has come, then for every bucket with work ensure a pool
    (growing it when the backlog justifies more lanes, exactly
    ``_ensure_pool``), refill free lanes priority-first, charge one
    compile per new ``(bucket, B, budget)`` executable identity, run one
    bounded round at the pool's critical path, demux finished lanes.
    Rounds of different buckets serialize on the simulated host clock,
    as they do on the real one.

    ``model_deadlines=True`` also expires pending requests whose
    deadline passes before placement (the server's pending-expiry path);
    in-flight expiry is not modelled — the simulator's use cases
    (admission estimates, policy sweeps) only need the pending tail.
    """
    policy = policy or BucketPolicy()
    cost = cost or CostModel()
    budget = policy.steps_per_round if policy.steps_per_round > 0 else None

    arrivals = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
    queues: dict[tuple, list[SimRequest]] = {}
    pools: dict[tuple, _SimPool] = {}
    results: dict[int, SimResult] = {}
    compiled: set[tuple] = set()
    t = 0.0
    busy_steps = total_lane_steps = compiles = rounds = timed_out = 0

    def bucket_of(r: SimRequest) -> tuple:
        b = plan_bucket(_SimGraph(r.n_u, r.n_v), policy)
        return (b.n_u, b.n_v)

    while arrivals or any(queues.values()) \
            or any(p.n_live() for p in pools.values()):
        # ---- arrivals whose time has come -----------------------------
        if arrivals and not any(queues.values()) \
                and not any(p.n_live() for p in pools.values()):
            t = max(t, arrivals[0].arrival_s)    # idle server fast-forward
        while arrivals and arrivals[0].arrival_s <= t:
            r = arrivals.pop(0)
            queues.setdefault(bucket_of(r), []).append(r)
        # ---- pending deadline expiry ----------------------------------
        if model_deadlines:
            for b, q in queues.items():
                dead = [r for r in q if r.deadline_s is not None
                        and t >= r.arrival_s + r.deadline_s]
                for r in dead:
                    q.remove(r)
                    res = SimResult(rid=r.rid, queue_s=t - r.arrival_s,
                                    finish_s=t, timed_out=True)
                    results[r.rid] = res
                    timed_out += 1
        # ---- one round per bucket with work ---------------------------
        live = sorted(b for b in set(queues) | set(pools)
                      if queues.get(b) or
                      (b in pools and pools[b].n_live()))
        if not live:
            continue
        for b in live:
            q = queues.setdefault(b, [])
            pool = pools.get(b)
            backlog = len(q)
            if pool is None:
                pool = _SimPool(plan_batch_size(backlog, policy))
                pools[b] = pool
            else:
                desired = plan_batch_size(pool.n_live() + backlog, policy)
                if desired > pool.B:            # pool growth (migration)
                    grown = _SimPool(desired)
                    grown.lanes[:pool.B] = pool.lanes
                    pools[b] = pool = grown
            # refill: highest priority first, FIFO within a level
            q.sort(key=lambda r: (-r.priority, r.rid))
            for i in range(pool.B):
                if pool.lanes[i] is not None or not q:
                    continue
                r = q.pop(0)
                res = SimResult(rid=r.rid, queue_s=t - r.arrival_s)
                results[r.rid] = res
                pool.lanes[i] = _SimLane(r, res)
            if pool.n_live() == 0:
                del pools[b]
                continue
            # compile charge: one per new executable identity
            key = (b, pool.B, budget)
            dt_compile = 0.0
            if key not in compiled:
                compiled.add(key)
                compiles += 1
                dt_compile = cost.compile_s
            # one bounded round at the pool's critical path
            advs = []
            for lane in pool.lanes:
                if lane is None:
                    continue
                adv = lane.remaining if budget is None \
                    else min(lane.remaining, budget)
                advs.append((lane, adv))
            crit = max(a for _, a in advs)
            # vmap barrier: all B lanes (live, finished, padded) step
            # ``crit`` times — wall scales with B * crit lane steps; the
            # clock advances at the wall rate, resident lanes are charged
            # service at the in-round exec rate (the real server's
            # ``service_s`` excludes host gaps the same way)
            dt = (pool.B * crit) / cost.steps_per_s \
                + cost.round_overhead_s
            dt_exec = (pool.B * crit) / cost.exec_rate
            t += dt + dt_compile
            rounds += 1
            busy_steps += sum(a for _, a in advs)
            total_lane_steps += pool.B * crit
            for i, lane in enumerate(pool.lanes):
                if lane is None:
                    continue
                lane.res.service_s += dt_exec
                lane.res.compile_s += dt_compile
                lane.remaining -= (lane.remaining if budget is None
                                   else min(lane.remaining, budget))
                if lane.remaining <= 0:
                    lane.res.finish_s = t
                    if model_deadlines \
                            and lane.req.deadline_s is not None \
                            and t > lane.req.arrival_s \
                            + lane.req.deadline_s:
                        lane.res.timed_out = True
                        timed_out += 1
                    pool.lanes[i] = None
            if pool.n_live() == 0 and not q:
                del pools[b]

    return SimReport(results=results, wall_s=t, busy_steps=busy_steps,
                     total_lane_steps=total_lane_steps,
                     compiles=compiles, rounds=rounds,
                     timed_out=timed_out)


# ---------------------------------------------------------------------------
# trace replay
# ---------------------------------------------------------------------------

#: terminal statuses the replay simulator does not model: the request
#: never ran to completion, so its measured step count is partial (or
#: absent) and replaying it would distort the occupancy ledger.
#: ``failed`` / ``step_capped`` are schema-v2 statuses (fault-tolerance
#: subsystem, DESIGN.md §13); v1 traces simply never carry them.
UNREPLAYABLE_STATUSES = (None, "cancelled", "rejected", "failed",
                         "step_capped")

#: schema-v2 event kinds the simulator counts instead of modelling.
UNMODELLED_EVENTS = frozenset(("fault", "retry", "recovery"))


def replay(records: list[TraceRecord],
           policy: BucketPolicy | None = None,
           cost: CostModel | None = None,
           admitted_only: bool = True,
           model_deadlines: bool = False,
           polls: list[dict] | None = None,
           events: list[dict] | None = None) -> SimReport:
    """Replay a recorded trace through the simulator.

    Each request's work is its *measured* step count, so replay isolates
    the pipeline model from the work estimator: under the same policy
    the prediction should land near the measured latencies (the CI
    round-trip smoke asserts this), and under a *different* policy it
    answers the what-if question the planner sweeps.  Pass the trace's
    ``polls`` (``TraceReader.polls()``) to calibrate the default cost
    model from the per-round ledger instead of the per-request sums.

    Schema-v2 traces may carry fault / retry / recovery events and
    ``failed`` / ``step_capped`` terminal statuses.  The simulator does
    not model faults: those rows are skipped (their measured work is
    partial) and, when the raw ``events`` are passed, the unmodelled
    event kinds are tallied into ``SimReport.skipped_events`` — so old
    and new traces both replay, and a caller can see how much of the
    trace the prediction ignored."""
    cost = cost or CostModel.from_trace(records, polls=polls)
    reqs = [SimRequest.from_record(r, cost) for r in records
            if (r.admitted or not admitted_only) and r.route != "big"
            and r.status not in UNREPLAYABLE_STATUSES]
    report = simulate(reqs, policy=policy, cost=cost,
                      model_deadlines=model_deadlines)
    if events:
        report.skipped_events = sum(
            1 for e in events if e.get("event") in UNMODELLED_EVENTS)
    return report


def compare_trace(records: list[TraceRecord],
                  report: SimReport) -> dict:
    """Predicted-vs-measured summary for a same-policy replay: mean
    service latency and end-to-end latency ratios (prediction /
    measurement, 1.0 = perfect) over the requests present in both."""
    both = [(r, report.results[r.rid]) for r in records
            if r.rid in report.results and r.latency_s is not None
            and r.status == "done"]
    if not both:
        return dict(n=0, service_ratio=math.nan, latency_ratio=math.nan,
                    measured_mean_service_s=0.0,
                    predicted_mean_service_s=0.0,
                    measured_mean_latency_s=0.0,
                    predicted_mean_latency_s=0.0)
    m_serv = sum(r.service_s for r, _ in both) / len(both)
    p_serv = sum(s.service_s for _, s in both) / len(both)
    m_lat = sum(r.latency_s for r, _ in both) / len(both)
    p_lat = sum(s.latency_s for _, s in both) / len(both)
    return dict(n=len(both),
                measured_mean_service_s=m_serv,
                predicted_mean_service_s=p_serv,
                service_ratio=(p_serv / m_serv if m_serv else math.nan),
                measured_mean_latency_s=m_lat,
                predicted_mean_latency_s=p_lat,
                latency_ratio=(p_lat / m_lat if m_lat else math.nan))
