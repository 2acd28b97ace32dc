"""Trace-driven capacity planning: what-if ``BucketPolicy`` sweeps over
a recorded request trace (DESIGN.md §12).

Twin of ``src/repro/serving/slo/planner.py`` (pure Python, copied as it
is).

Sizing a serving deployment means answering "under policy X, what would
this traffic's latency and occupancy have been?" — for the policies you
did NOT run.  The replay simulator makes that a host-side loop: each
candidate policy replays the same recorded trace (measured per-request
work, measured cost model) and yields predicted mean latency, occupancy,
compile count and wall time; ``frontier`` then reduces the sweep to its
Pareto set (no other candidate is both faster and busier), which is the
shortlist an operator actually chooses from.

    records = load_requests("trace.jsonl")
    cost = CostModel.from_trace(records)
    rows = sweep(records, candidate_policies(), cost)
    best = frontier(rows)

``candidate_policies`` builds the default grid over the knobs that move
serving behaviour — ``steps_per_round`` (refill granularity),
``max_batch`` (lane count), ``bucket_mode`` (padding vs executable
reuse) — around an optional base policy; pass your own list to sweep
anything else (e.g. ``big_graph_threshold`` or ``steps_per_call``
variants).
"""
from __future__ import annotations

import dataclasses

from repro_torch.serving.buckets import BucketPolicy
from repro_torch.serving.slo.simulate import CostModel, replay
from repro_torch.serving.slo.trace import TraceRecord


def candidate_policies(base: BucketPolicy | None = None,
                       steps_per_round=(0, 16, 64, 256),
                       max_batch=(4, 8, 16),
                       bucket_modes=("pow2",)) -> list[BucketPolicy]:
    """The default what-if grid: every combination of the given knob
    values grafted onto ``base`` (other fields inherited)."""
    base = base or BucketPolicy()
    out = []
    for mode in bucket_modes:
        for spr in steps_per_round:
            for mb in max_batch:
                out.append(dataclasses.replace(
                    base, mode=mode, steps_per_round=spr, max_batch=mb))
    return out


def describe(policy: BucketPolicy) -> dict:
    """The swept knobs of one candidate, as a flat row prefix."""
    return dict(bucket_mode=policy.mode,
                steps_per_round=policy.steps_per_round,
                max_batch=policy.max_batch,
                steps_per_call=policy.steps_per_call,
                big_graph_threshold=policy.big_graph_threshold)


def sweep(records: list[TraceRecord],
          candidates: list[BucketPolicy] | None = None,
          cost: CostModel | None = None,
          model_deadlines: bool = True) -> list[dict]:
    """Replay ``records`` under every candidate policy; one flat row per
    candidate (knobs + predicted mean latency / occupancy / compiles /
    wall / deadline misses)."""
    candidates = candidates or candidate_policies()
    cost = cost or CostModel.from_trace(records)
    rows = []
    for pol in candidates:
        rep = replay(records, policy=pol, cost=cost,
                     model_deadlines=model_deadlines)
        rows.append(dict(
            **describe(pol),
            predicted_mean_latency_s=round(rep.mean_latency_s, 6),
            predicted_mean_service_s=round(rep.mean_service_s, 6),
            predicted_occupancy=round(rep.occupancy, 4),
            predicted_wall_s=round(rep.wall_s, 6),
            predicted_compiles=rep.compiles,
            predicted_rounds=rep.rounds,
            predicted_timed_out=rep.timed_out))
    return rows


def frontier(rows: list[dict],
             minimize: str = "predicted_mean_latency_s",
             maximize: str = "predicted_occupancy") -> list[dict]:
    """Pareto-efficient subset of a sweep: keep a row iff no other row
    is at least as good on both objectives and strictly better on one.
    Sorted by the minimized objective (the operator's shortlist)."""
    keep = []
    for r in rows:
        dominated = any(
            o[minimize] <= r[minimize] and o[maximize] >= r[maximize]
            and (o[minimize] < r[minimize] or o[maximize] > r[maximize])
            for o in rows)
        if not dominated:
            keep.append(r)
    return sorted(keep, key=lambda r: r[minimize])
