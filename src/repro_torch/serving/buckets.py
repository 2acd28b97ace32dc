"""Shape-bucketing planner for the batched multi-graph MBE serving layer.

Twin of ``src/repro/serving/buckets.py`` (pure Python, copied as it is).

The inverse batching problem to cuMBE's: instead of one graph fanned out
over many workers, many users each submit a *small* graph and the server
must keep one accelerator busy across all of them.  A jitted engine
executable is specialized on the static shapes ``(n_u, n_v, depth)`` (plus
``EngineConfig``), so serving each request at its exact shape would compile
once per distinct request shape — compilation dominating enumeration for
small graphs.

The planner therefore *pads* every incoming graph up to one of a small set
of canonical buckets.  Enumeration on a padded graph is bit-identical to
the exact-shape run: padding vertices have empty neighbourhoods and rank
``2*n_u``, so they never enter P or Q, and zero bitset words hash to zero
so even the enumeration fingerprint is unchanged (``test_padded_graph_
same_result``).  The price of padding is wasted lanes/words per step; the
bucket policies trade that against executable reuse:

* ``pow2``   — round each side up to the next power of two (few buckets,
  geometric worst-case 2x padding per side).
* ``linear`` — round up to multiples of ``step_u``/``step_v`` (more
  buckets, tighter padding).
* ``exact``  — no padding (the no-bucketing ablation: one executable per
  distinct request shape).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.engine_dense import EngineConfig
from repro_torch.core.graph import BipartiteGraph


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    mode: str = "pow2"        # 'pow2' | 'linear' | 'exact'
    step_u: int = 8           # linear-mode granularity, U side
    step_v: int = 32          # linear-mode granularity, V side
    min_u: int = 4            # floor (pow2/linear): tiny graphs share one
    min_v: int = 16           # bucket instead of one bucket per size
    max_batch: int = 8        # graphs per batched engine call
    pad_batch: bool = True    # round the batch dim up to a power of two so
    #                           partial flushes reuse full-batch executables
    steps_per_round: int = 0  # continuous-scheduler round budget: 0 runs
    #                           each lane pool to completion per round
    #                           (whole-batch flush semantics); > 0 bounds
    #                           every engine call so finished lanes can be
    #                           refilled mid-flight from the pending queue
    steps_per_call: int = 1   # engine-loop inner unroll: candidate steps
    #                           advanced per while-loop iteration inside
    #                           one compiled round segment.  Amortizes the
    #                           per-step loop carry/cond dispatch and lets
    #                           XLA fuse across consecutive steps; the
    #                           in-graph early exit (done lanes, round
    #                           budget) is preserved, so results and step
    #                           counts are byte-identical to 1.  Baked
    #                           into the round executable (cache key).
    big_graph_threshold: int | None = None
    #                           routing: a (canonical) graph with n_u >=
    #                           threshold root tasks is NOT placed in a
    #                           vmap lane — one lane would serialize the
    #                           whole subtree forest behind the bucket's
    #                           round barrier.  It routes to the dedicated
    #                           big-graph lane instead: cuMBE's shared-graph
    #                           decomposition (root tasks spread over every
    #                           mesh worker, work stealing at round
    #                           barriers).  None disables big-graph routing.

    @property
    def lane_cap(self) -> int:
        """Largest usable lane count.  With ``pad_batch`` every planned
        batch size must be a power of two (that is the executable-reuse
        promise), so a non-power-of-two ``max_batch`` is rounded DOWN to
        the previous power of two rather than minted as its own size."""
        return _prev_pow2(self.max_batch) if self.pad_batch \
            else self.max_batch


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """A canonical padded shape; the unit the executable cache keys on."""
    n_u: int
    n_v: int
    depth: int

    def engine_config(self, **kw) -> EngineConfig:
        return EngineConfig(n_u=self.n_u, n_v=self.n_v, m_real=self.n_u,
                            depth=self.depth, **kw)


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length() if n > 1 else 1


def _prev_pow2(n: int) -> int:
    return 1 << (n.bit_length() - 1) if n >= 1 else 1


def _round_up(n: int, step: int) -> int:
    return ((n + step - 1) // step) * step


def plan_bucket(g: BipartiteGraph, policy: BucketPolicy) -> BucketSpec:
    """Map a (canonical-orientation) graph onto its serving bucket."""
    if policy.mode == "exact":
        nu, nv = g.n_u, g.n_v
    elif policy.mode == "pow2":
        nu = _next_pow2(max(g.n_u, policy.min_u))
        nv = _next_pow2(max(g.n_v, policy.min_v))
    elif policy.mode == "linear":
        nu = _round_up(max(g.n_u, policy.min_u), policy.step_u)
        nv = _round_up(max(g.n_v, policy.min_v), policy.step_v)
    else:
        raise ValueError(f"unknown bucket mode {policy.mode!r}")
    # depth bounds the DFS stack: n_u levels + task init + slack.  It must
    # be a bucket constant (not the graph's), or it would leak the request
    # shape back into the executable key.
    return BucketSpec(n_u=nu, n_v=nv, depth=nu + 2)


def plan_route(g: BipartiteGraph, policy: BucketPolicy) -> str:
    """Route a (canonical-orientation) request: ``"lane"`` places it in a
    bucket lane pool (one graph per vmap lane), ``"big"`` sends it to the
    work-stealing big-graph lane (one graph decomposed into root tasks
    across every mesh worker).

    The routing key is the canonical ``n_u`` — the number of first-level
    subtrees, i.e. the graph's supply of stealable root tasks.  Below the
    threshold a graph cannot feed multiple workers anyway; at or above it,
    keeping the graph in one lane would make every other lane of its
    bucket wait on one worker's serial DFS (the exact imbalance cuMBE's
    work stealing removes).
    """
    big = (policy.big_graph_threshold is not None
           and g.n_u >= policy.big_graph_threshold)
    return "big" if big else "lane"


def plan_batch_size(n_pending: int, policy: BucketPolicy) -> int:
    """Lane count for a pool serving ``n_pending`` same-bucket graphs.

    With ``pad_batch`` the result is ALWAYS a power of two capped at
    ``policy.lane_cap`` — a non-power-of-two ``max_batch`` (e.g. 6) must
    not leak extra batch sizes like {1, 2, 4, 6} into the executable
    cache, which would defeat the reuse promise padding exists to keep.
    """
    b = min(n_pending, policy.lane_cap)
    return min(_next_pow2(b), policy.lane_cap) if policy.pad_batch else b
