"""Pluggable execution backends for the MBE serving layer.

Twin of ``src/repro/serving/executor.py``: ``LanePool``,
``RoundTelemetry``, the ``Executor`` interface, ``LocalExecutor``
(single-device lane pools, one lane per graph, one cached ``run_batch``
callable per ``(bucket, batch, budget)``) and ``BigGraphLane`` (one
heavy graph's root tasks strided over ``big_workers`` workers on the
executor's device, pending tasks stolen at round barriers: the paper's
work stealing between thread blocks).  The scheduler speaks only this
interface.

Not in this slice: ``ShardedExecutor`` (lane pools and the big lane over
several devices, the rest of ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import abc
import dataclasses

import numpy as np
import torch

from repro_torch.core import distributed as dd
from repro_torch.core import engine_dense as ed
from repro_torch.core.engine import DENSE, Engine
from repro_torch.kernels.dispatch import check_device
from repro_torch.serving.buckets import BucketPolicy, plan_batch_size
from repro_torch.serving.cache import ExecutableCache

# Round budget for the big-graph lane when the bucket policy runs
# unbounded rounds (steps_per_round == 0): work stealing only happens at
# round barriers, so the big lane must stay bounded even in flush mode.
DEFAULT_BIG_ROUND_STEPS = 2048
# the reference's serving mesh axis, named in the big lane's placement
MBE_LANE_AXIS = "mbe_lanes"


def _stack(items):
    return type(items[0])(*[torch.stack(xs) for xs in zip(*items)])


class LanePool:
    """Device-side half of a bucket's lane pool: the batched state and
    context plus their static shape, owned by an ``Executor``."""

    __slots__ = ("cfg", "B", "engine", "state", "ctx")

    def __init__(self, cfg: ed.EngineConfig, n_lanes: int,
                 engine: Engine | None = None):
        self.cfg = cfg
        self.B = n_lanes
        self.engine = engine or DENSE
        self.state = None
        self.ctx = None


@dataclasses.dataclass
class RoundTelemetry:
    """What one bounded round reports back to the scheduler."""
    wall_s: float                 # round wall time
    compile_s: float              # always 0.0 in the port (no compile)
    adv: np.ndarray               # per-lane engine steps advanced
    pending: np.ndarray | None = None


class Executor(abc.ABC):
    """Execution backend: owns where lane pools live and how rounds run."""

    name: str = "executor"
    device: torch.device        # set by each backend (no CPU default)

    @abc.abstractmethod
    def plan_lanes(self, n_pending: int, policy: BucketPolicy) -> int:
        """Lane count for a pool serving ``n_pending`` same-bucket
        graphs."""

    def new_pool(self, cfg: ed.EngineConfig, n_lanes: int,
                 engine: Engine | None = None) -> LanePool:
        """Fresh pool of ``n_lanes`` idle (born-done) lanes on this
        backend's device."""
        pool = LanePool(cfg, n_lanes, engine)
        eng = pool.engine
        ds = eng.fresh_lane_state(cfg, 0, self.device)
        dc = eng.dummy_context(cfg, self.device)
        pool.state = _stack([ds] * n_lanes)
        pool.ctx = _stack([dc] * n_lanes)
        return pool

    def install(self, pool: LanePool, idx: list[int], states, ctxs) -> None:
        """Place fresh single-lane (state, ctx) pairs into rows ``idx``."""
        pool.state, pool.ctx = ed.replace_lanes(
            pool.state, pool.ctx, idx, _stack(states), _stack(ctxs))

    def migrate(self, old: LanePool, new: LanePool,
                live_idx: list[int]) -> None:
        """Move live rows of ``old`` into rows [0, len(live_idx)) of
        ``new`` (in-flight DFS state resumes unchanged)."""
        ii = torch.as_tensor(np.asarray(live_idx, dtype=np.int64),
                             device=self.device)
        new.state, new.ctx = ed.replace_lanes(
            new.state, new.ctx, np.arange(len(live_idx)),
            type(old.state)(*[x[ii] for x in old.state]),
            type(old.ctx)(*[x[ii] for x in old.ctx]))

    def evict(self, pool: LanePool, i: int) -> None:
        """Dummy-out lane ``i`` (cancellation, deadline, step cap)."""
        pool.state, pool.ctx = ed.replace_lane(
            pool.state, pool.ctx, i,
            pool.engine.fresh_lane_state(pool.cfg, 0, self.device),
            pool.engine.dummy_context(pool.cfg, self.device))

    @abc.abstractmethod
    def run_round(self, pool: LanePool, cache: ExecutableCache,
                  budget: int | None, unroll: int = 1) -> RoundTelemetry:
        """Advance every lane by one bounded round."""

    def launches_per_segment(self, pool: LanePool) -> int:
        """Kernel launches one segment of this pool costs: 1 when the
        pool kernel serves it, else one per lane."""
        return 1 if pool.engine.pool_lanes(pool.cfg, pool.B,
                                           self.device) else pool.B

    def lane(self, pool: LanePool, i: int):
        """One lane's state (for demux)."""
        return type(pool.state)(*[x[i] for x in pool.state])

    def done_mask(self, pool: LanePool) -> np.ndarray:
        return pool.engine.done(pool.state).cpu().numpy()

    def steps(self, pool: LanePool) -> np.ndarray:
        return pool.state.steps.cpu().numpy()

    @abc.abstractmethod
    def placement(self, n_lanes: int) -> str:
        """Human-readable lane placement for the routing log."""

    @abc.abstractmethod
    def big_lane(self, cfg: ed.EngineConfig, ctx, n_roots: int,
                 cache: ExecutableCache, budget: int | None,
                 engine: Engine | None = None,
                 steps_per_call: int = 1) -> "BigGraphLane":
        """Work-stealing lane for one routed-big graph on this backend."""


class LocalExecutor(Executor):
    """Single-device lane pools on ``device`` (the card unless the caller
    asks for the CPU)."""

    name = "local"

    def __init__(self, big_workers: int = 4, work_stealing: bool = True,
                 device: str = "cuda"):
        self.big_workers = big_workers
        self.work_stealing = work_stealing
        self.device = check_device(device)

    def plan_lanes(self, n_pending: int, policy: BucketPolicy) -> int:
        return plan_batch_size(n_pending, policy)

    def run_round(self, pool: LanePool, cache: ExecutableCache,
                  budget: int | None, unroll: int = 1) -> RoundTelemetry:
        entry = cache.get_round(pool.cfg, pool.B, budget,
                                engine=pool.engine, unroll=unroll,
                                device=self.device)
        before = pool.state.steps.cpu().numpy()
        out, wall, compile_s = entry.timed_call(pool.ctx, pool.state)
        pool.state = out
        return RoundTelemetry(wall_s=wall, compile_s=compile_s,
                              adv=out.steps.cpu().numpy() - before)

    def placement(self, n_lanes: int) -> str:
        return f"1 device x {n_lanes} vmap lanes"

    def big_lane(self, cfg, ctx, n_roots, cache, budget, engine=None,
                 steps_per_call=1):
        return BigGraphLane(self.name, cfg, self.device, MBE_LANE_AXIS,
                            self.big_workers, ctx, n_roots, cache, budget,
                            engine=engine, work_stealing=self.work_stealing,
                            steps_per_call=steps_per_call)


class BigGraphLane:
    """One heavy graph served cuMBE-style: root tasks strided across the
    workers, pending tasks stolen at round barriers.

    The round function is ``distributed.make_round_fn(with_telemetry=
    True)`` (one shared graph, the stacked worker state on
    the executor's device), cached under the reference's key shape with
    the device in the mesh's place, so same-bucket big graphs reuse one
    entry.  Per-worker busy steps accumulate in ``busy_per_worker`` (the
    paper's Fig.-5 load-distribution view)."""

    n_devices = 1

    def __init__(self, backend: str, cfg: ed.EngineConfig, device,
                 axis: str, workers_per_device: int, ctx, n_roots: int,
                 cache: ExecutableCache, budget: int | None,
                 engine: Engine | None = None, work_stealing: bool = True,
                 steps_per_call: int = 1):
        self.cfg = cfg
        self.device = device
        self.axis = axis
        self.engine = engine or DENSE
        self.n_workers = self.n_devices * workers_per_device
        self.round_steps = (budget if budget and budget > 0
                            else DEFAULT_BIG_ROUND_STEPS)
        dist = dd.DistConfig(steps_per_round=self.round_steps,
                             workers_per_device=workers_per_device,
                             work_stealing=work_stealing,
                             steps_per_call=steps_per_call)
        key = (("ws", backend, self.engine.name, work_stealing, str(device),
                axis, workers_per_device, cfg),
               self.n_workers, self.round_steps)
        if steps_per_call != 1:
            key = key + (steps_per_call,)

        def build():
            fn, _, _ = dd.make_round_fn(cfg, self.n_devices, dist,
                                        with_telemetry=True,
                                        engine=self.engine)
            return fn

        self._entry = cache.get_entry(key, build)
        # strided initial deal of the REAL root tasks (padding vertices
        # own no subtree) into queues of capacity T = cfg.m_real
        self.state = dd.strided_states(self.engine, cfg, n_roots,
                                       self.n_workers, device)
        self.ctx = ctx
        self.busy_per_worker = np.zeros(self.n_workers, np.int64)

    def run_round(self) -> RoundTelemetry:
        (out, telem), wall, compile_s = self._entry.timed_call(self.ctx,
                                                               self.state)
        self.state = out
        adv = telem["busy_steps"].cpu().numpy().astype(np.int64)
        self.busy_per_worker += adv
        return RoundTelemetry(wall_s=wall, compile_s=compile_s, adv=adv,
                              pending=telem["pending"].cpu().numpy())

    @property
    def done(self) -> bool:
        return bool(self.engine.done(self.state).all())

    def max_worker_steps(self) -> int:
        return int(self.state.steps.max())

    def placement(self) -> str:
        return (f"{self.n_workers} stealing workers on {self.n_devices} "
                f"device(s) (axis {self.axis!r}, round={self.round_steps} "
                f"steps)")
