"""SLO-aware admission control for ``MBEServer`` (DESIGN.md §12).

Twin of ``src/repro/serving/slo/admission.py`` (pure Python, copied as
it is: the same verdicts, in the same order, with the same reasons).

The server's deadline plumbing is *reactive*: an expired request
is completed as ``timed_out`` — after its compile and step budget is
already spent.  The admission controller sits in front of the pending
queues and makes the call at admit time, before any context build or
executable compile, in three independent layers (each off unless its
policy field is set):

* **backpressure**  — bounded pending queue: more than ``max_pending``
  requests waiting across all buckets rejects the newcomer
  (``reason="backpressure"``).  Turns unbounded queue growth — the
  saturation failure mode — into immediate, typed feedback.
* **fairness**      — weighted per-tenant queue shares: tenant *i* may
  hold at most ``ceil(weight_i / Σweights * max_pending)`` pending
  requests; beyond that the newcomer rejects (``reason="fairness"``)
  even when the queue as a whole has room, so one chatty tenant cannot
  starve the rest.  Unknown tenants get ``default_weight``.
* **shed-on-deadline** — a request admitted with ``deadline_s`` is
  simulated forward: estimated completion = bucket backlog ahead of it
  + its own estimated work, at the cost model's measured steps/s, plus
  a compile charge when its bucket is cold.  If the estimate exceeds
  ``deadline_s * shed_slack`` the request is rejected
  (``reason="shed"``) instead of burning compile/step budget on a
  near-guaranteed ``timed_out``.

A rejected request still gets a request id and a typed terminal result
(``status == "rejected"``, zero counters) delivered through the normal
poll/reap/future machinery — rejection is a *result*, not an exception,
so clients retry/deflect with full information.

The controller is pure host-side bookkeeping over state the scheduler
already exposes (queue lengths, per-tenant pending, cost model
scalars); it never touches device arrays, and a server constructed
without one takes no admission branch at all (the byte-identity
guarantee when disabled).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.serving.slo.simulate import CostModel


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Admission knobs; every layer defaults to off."""

    max_pending: int | None = None      # bounded-queue backpressure
    tenant_weights: dict | None = None  # {tenant: weight} fairness shares
    default_weight: float = 1.0         # weight of tenants not listed
    shed_on_deadline: bool = False      # reject predicted deadline misses
    shed_slack: float = 1.0             # shed when est > slack * deadline
    #                                     (> 1 = lenient, < 1 = strict)
    cost: CostModel = dataclasses.field(default_factory=CostModel)

    # fairness needs a queue capacity to split into shares: max_pending
    # when set, else this standalone cap
    fairness_pending_cap: int = 64


@dataclasses.dataclass(frozen=True)
class Decision:
    """One admission verdict (also the trace/routing-log record)."""

    admitted: bool
    reason: str                 # 'ok' | 'backpressure' | 'fairness' | 'shed'
    est_completion_s: float | None = None   # shed layer's estimate, when
    #                                         it ran (admitted or not)


class AdmissionController:
    """Stateful admission front for one ``MBEServer``.

    The server calls ``offer`` once per ``admit`` with the routed
    request's facts; the controller answers with a ``Decision`` and
    keeps its own cumulative counters (``stats()``), which the server
    folds into its stats dict.  ``seen_buckets`` tracks which bucket
    shapes have been admitted before — the shed estimator's cold-compile
    charge."""

    def __init__(self, policy: AdmissionPolicy | None = None):
        self.policy = policy or AdmissionPolicy()
        self.n_admitted = 0
        self.n_rejected = 0
        self.rejected_by_reason = dict(backpressure=0, fairness=0, shed=0)
        self._seen_buckets: set[tuple[int, int]] = set()

    # ------------------------------------------------------------------
    def _total_weight(self, tenants) -> float:
        w = self.policy.tenant_weights or {}
        names = set(tenants) | set(w)
        return sum(w.get(t, self.policy.default_weight) for t in names) \
            or 1.0

    def _fair_share(self, tenant: str, tenants_pending: dict) -> int:
        w = self.policy.tenant_weights or {}
        weight = w.get(tenant, self.policy.default_weight)
        cap = (self.policy.max_pending
               if self.policy.max_pending is not None
               else self.policy.fairness_pending_cap)
        share = weight / self._total_weight(tenants_pending) * cap
        return max(int(math.ceil(share)), 1)

    def estimate_completion_s(self, *, n_u: int, n_v: int,
                              bucket: tuple[int, int],
                              backlog_steps: int,
                              lanes: int = 1) -> float:
        """Expected seconds until a request of this shape completes,
        were it admitted now: the bucket's backlog drains ahead of it
        (lane pools overlap the newcomer with up to ``lanes``-1 peers,
        so the backlog is discounted by the pool width), then its own
        estimated work runs, plus one compile when the bucket is cold."""
        cost = self.policy.cost
        own = cost.estimate_steps(n_u, n_v)
        ahead = backlog_steps / max(lanes, 1)
        est = (ahead + own) / cost.steps_per_s
        if bucket not in self._seen_buckets:
            est += cost.compile_s
        return est

    # ------------------------------------------------------------------
    def offer(self, *, n_u: int, n_v: int, bucket: tuple[int, int],
              route: str, tenant: str, deadline_s: float | None,
              pending: int, tenants_pending: dict,
              backlog_steps: int, lanes: int = 1) -> Decision:
        """One admission verdict.  ``pending`` is the server-wide queued
        count, ``tenants_pending`` the per-tenant split of it,
        ``backlog_steps`` the estimated engine steps queued + in flight
        ahead of this request in its bucket, ``lanes`` the bucket pool's
        (planned) width."""
        pol = self.policy
        # 1. backpressure: bounded total queue
        if pol.max_pending is not None and pending >= pol.max_pending:
            return self._reject("backpressure")
        # 2. weighted per-tenant fairness
        if pol.tenant_weights is not None:
            held = tenants_pending.get(tenant, 0)
            if held >= self._fair_share(tenant, tenants_pending):
                return self._reject("fairness")
        # 3. shed-on-deadline
        est = None
        if pol.shed_on_deadline and deadline_s is not None:
            est = self.estimate_completion_s(
                n_u=n_u, n_v=n_v, bucket=bucket,
                backlog_steps=backlog_steps, lanes=lanes)
            if est > deadline_s * pol.shed_slack:
                d = self._reject("shed")
                return dataclasses.replace(d, est_completion_s=est)
        self.n_admitted += 1
        self._seen_buckets.add(bucket)
        return Decision(admitted=True, reason="ok", est_completion_s=est)

    def _reject(self, reason: str) -> Decision:
        self.n_rejected += 1
        self.rejected_by_reason[reason] += 1
        return Decision(admitted=False, reason=reason)

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        return dict(admitted=self.n_admitted, rejected=self.n_rejected,
                    shed=self.rejected_by_reason["shed"],
                    rejected_backpressure=
                    self.rejected_by_reason["backpressure"],
                    rejected_fairness=self.rejected_by_reason["fairness"])

    def reset_stats(self) -> None:
        self.n_admitted = 0
        self.n_rejected = 0
        self.rejected_by_reason = dict(backpressure=0, fairness=0, shed=0)
