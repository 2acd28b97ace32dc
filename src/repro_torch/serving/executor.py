"""Pluggable execution backends for the MBE serving layer.

Twin of ``src/repro/serving/executor.py``: ``LanePool``,
``RoundTelemetry``, the ``Executor`` interface and its backends:

* ``LocalExecutor``   — single-device lane pools, one lane per graph, one
  cached ``run_batch`` callable per ``(bucket, batch, budget)``;
* ``ShardedExecutor`` — the same lane-pool contract over a 1-D serving
  mesh (``launch.mesh.Mesh``): the pool's lanes are split over the
  devices, ``wpd = B // n_devices`` a device, and each round is ONE
  ``distributed.make_round_fn(ctx_batched=True)`` call, which advances
  every device's lanes in the same segments;
* ``BigGraphLane``    — one heavy graph's root tasks strided over every
  worker of a mesh (``workers_per_device`` a device; the local
  executor's mesh is its one device), pending tasks stolen at round
  barriers: the paper's work stealing between thread blocks.

The scheduler speaks only this interface.  An executor's ``device`` is
where the scheduler builds contexts and restored states (the mesh's
first device); the sharded executor moves each lane to its own device.
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
from repro_torch.launch.mesh import Mesh
from repro_torch.serving.buckets import BucketPolicy, plan_batch_size
from repro_torch.serving.cache import ExecutableCache
from repro_torch.sharding.axes import MBE_LANE_AXIS

# Round budget for the big-graph lane when the bucket policy runs
# unbounded rounds (steps_per_round == 0): work stealing only happens at
# round barriers, so the big lane must stay bounded even in flush mode.
DEFAULT_BIG_ROUND_STEPS = 2048


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
        mesh = Mesh([self.device], (MBE_LANE_AXIS,))
        return BigGraphLane(self.name, cfg, mesh, MBE_LANE_AXIS,
                            self.big_workers, ctx, n_roots, cache, budget,
                            engine=engine, work_stealing=self.work_stealing,
                            steps_per_call=steps_per_call)


class ShardedExecutor(Executor):
    """Lane pools placed across a 1-D serving mesh.

    The pool's lanes are split over ``axis`` (``wpd = B // n_devices``
    lanes a device; lane ``i`` on shard ``i // wpd``) and one bounded
    round is ONE ``make_round_fn(ctx_batched=True, work_stealing=False)``
    call: the per-lane-graphs layout, where stealing is meaningless
    because root-task indices are graph-local; balancing across lanes is
    the scheduler's refill.  Lane counts are padded up to a multiple of
    the mesh size.  Lane surgery writes each row into its own shard, on
    its device.

    ``big_workers_per_device`` sizes the big-graph lane: total stealing
    workers = mesh size x that (over-decomposition knob)."""

    name = "sharded"

    def __init__(self, mesh: Mesh, axis: str = MBE_LANE_AXIS,
                 big_workers_per_device: int = 1,
                 work_stealing: bool = True):
        if axis not in mesh.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
        self.mesh = mesh
        self.axis = axis
        self.n_devices = int(mesh.shape[axis])
        dd._mesh_devices(mesh, (axis,))
        self.device = mesh.devices[0]
        self.big_workers_per_device = big_workers_per_device
        self.work_stealing = work_stealing

    def plan_lanes(self, n_pending: int, policy: BucketPolicy) -> int:
        base = plan_batch_size(n_pending, policy)
        n_dev = self.n_devices
        b = max(base, n_dev)
        return ((b + n_dev - 1) // n_dev) * n_dev   # divisible placement

    # -- pool lifecycle: every row on its shard's device ------------------
    def new_pool(self, cfg, n_lanes, engine=None) -> LanePool:
        pool = LanePool(cfg, n_lanes, engine)
        eng, wpd = pool.engine, n_lanes // self.n_devices
        states, ctxs = [], []
        for dev in self.mesh.devices:
            states.append(_stack([eng.fresh_lane_state(cfg, 0, dev)] * wpd))
            ctxs.append(_stack([eng.dummy_context(cfg, dev)] * wpd))
        pool.state = dd.Sharded(states, self.mesh)
        pool.ctx = dd.Sharded(ctxs, self.mesh)
        return pool

    def install(self, pool, idx, states, ctxs) -> None:
        wpd = pool.B // self.n_devices
        by_shard: dict[int, list] = {}
        for i, st, cx in zip(idx, states, ctxs):
            by_shard.setdefault(i // wpd, []).append((i % wpd, st, cx))
        st_shards, cx_shards = list(pool.state.shards), list(pool.ctx.shards)
        for d, rows in by_shard.items():
            dev = self.mesh.devices[d]
            st_shards[d], cx_shards[d] = ed.replace_lanes(
                st_shards[d], cx_shards[d], [j for j, _, _ in rows],
                _stack([_to(st, dev) for _, st, _ in rows]),
                _stack([_to(cx, dev) for _, _, cx in rows]))
        pool.state = dd.Sharded(st_shards, self.mesh)
        pool.ctx = dd.Sharded(cx_shards, self.mesh)

    def migrate(self, old, new, live_idx) -> None:
        self.install(new, list(range(len(live_idx))),
                     [self.lane(old, i) for i in live_idx],
                     [_row(old.ctx, old.B, i) for i in live_idx])

    def evict(self, pool, i) -> None:
        dev = self.mesh.devices[i // (pool.B // self.n_devices)]
        self.install(pool, [i],
                     [pool.engine.fresh_lane_state(pool.cfg, 0, dev)],
                     [pool.engine.dummy_context(pool.cfg, dev)])

    def lane(self, pool, i):
        return _row(pool.state, pool.B, i)

    def done_mask(self, pool) -> np.ndarray:
        return np.concatenate([pool.engine.done(s).cpu().numpy()
                               for s in pool.state.shards])

    def steps(self, pool) -> np.ndarray:
        return np.concatenate([s.steps.cpu().numpy()
                               for s in pool.state.shards])

    # -- execution --------------------------------------------------------
    def run_round(self, pool: LanePool, cache: ExecutableCache,
                  budget: int | None, unroll: int = 1) -> RoundTelemetry:
        cfg, B = pool.cfg, pool.B
        wpd = B // self.n_devices
        key = ((self.name, pool.engine.name, self.mesh, self.axis, wpd,
                cfg), B, budget)
        if unroll != 1:
            key = key + (unroll,)
        # the per-device shard is what run_batch sees, so the pool path
        # (and the key extension) is per-device-width
        pw = pool.engine.pool_lanes(cfg, wpd, self.device)
        if pw:
            key = key + (("pool", pw),)

        def build():
            dist = dd.DistConfig(
                steps_per_round=(budget if budget is not None
                                 else cfg.max_steps),
                workers_per_device=wpd, work_stealing=False,
                steps_per_call=unroll)
            fn, _, _ = dd.make_round_fn(cfg, self.mesh, (self.axis,), dist,
                                        ctx_batched=True,
                                        with_telemetry=True,
                                        engine=pool.engine)
            return fn

        entry = cache.get_entry(key, build)
        (out, telem), wall, compile_s = entry.timed_call(pool.ctx,
                                                         pool.state)
        pool.state = out
        return RoundTelemetry(
            wall_s=wall, compile_s=compile_s,
            adv=telem["busy_steps"].cpu().numpy(),
            pending=telem["pending"].cpu().numpy())

    def launches_per_segment(self, pool: LanePool) -> int:
        wpd = pool.B // self.n_devices
        per_dev = 1 if pool.engine.pool_lanes(pool.cfg, wpd,
                                              self.device) else wpd
        return self.n_devices * per_dev

    def placement(self, n_lanes: int) -> str:
        wpd = n_lanes // self.n_devices
        return (f"{self.n_devices} devices x {wpd} lanes "
                f"(axis {self.axis!r})")

    def big_lane(self, cfg, ctx, n_roots, cache, budget, engine=None,
                 steps_per_call=1):
        return BigGraphLane(self.name, cfg, self.mesh, self.axis,
                            self.big_workers_per_device, ctx, n_roots,
                            cache, budget, engine=engine,
                            work_stealing=self.work_stealing,
                            steps_per_call=steps_per_call)


def _to(tree, device):
    return type(tree)(*[x.to(device) for x in tree])


def _row(sharded, n_rows: int, i: int):
    """Row ``i`` of a ``Sharded`` pool of ``n_rows`` rows, on its
    shard's device."""
    k = n_rows // len(sharded.shards)
    shard = sharded.shards[i // k]
    return type(shard)(*[x[i % k] for x in shard])


class BigGraphLane:
    """One heavy graph served cuMBE-style: root tasks strided across every
    mesh worker, pending tasks stolen at round barriers.

    The round function is ``distributed.make_round_fn(ctx_batched=False,
    work_stealing=..., with_telemetry=True)``: one replicated graph, the
    worker state sharded over the mesh, cached under the reference's key
    shape so same-bucket big graphs reuse one entry.  ``state`` is the
    workers' global view (every worker in order, on the mesh's first
    device), as the scheduler's ``finish_workers`` / ``stacked_counters``
    read it.  Per-worker busy steps accumulate in ``busy_per_worker``
    (the paper's Fig.-5 load-distribution view)."""

    def __init__(self, backend: str, cfg: ed.EngineConfig, mesh: Mesh,
                 axis: str, workers_per_device: int, ctx, n_roots: int,
                 cache: ExecutableCache, budget: int | None,
                 engine: Engine | None = None, work_stealing: bool = True,
                 steps_per_call: int = 1):
        self.cfg = cfg
        self.mesh = mesh
        self.axis = axis
        self.engine = engine or DENSE
        self.n_devices = int(mesh.shape[axis])
        self.n_workers = self.n_devices * workers_per_device
        self.round_steps = (budget if budget and budget > 0
                            else DEFAULT_BIG_ROUND_STEPS)
        dist = dd.DistConfig(steps_per_round=self.round_steps,
                             workers_per_device=workers_per_device,
                             work_stealing=work_stealing,
                             steps_per_call=steps_per_call)
        key = (("ws", backend, self.engine.name, work_stealing, mesh, axis,
                workers_per_device, cfg),
               self.n_workers, self.round_steps)
        if steps_per_call != 1:
            key = key + (steps_per_call,)

        def build():
            fn, _, _ = dd.make_round_fn(cfg, mesh, (axis,), dist,
                                        ctx_batched=False,
                                        with_telemetry=True,
                                        engine=self.engine)
            return fn

        self._entry = cache.get_entry(key, build)
        # strided initial deal of the REAL root tasks (padding vertices
        # own no subtree) into queues of capacity T = cfg.m_real, each
        # device's workers placed on it
        self._state = dd.Sharded.split(
            dd.strided_states(self.engine, cfg, n_roots, self.n_workers,
                              mesh.devices[0]), mesh)
        self.ctx = dd.replicate(ctx, mesh)
        self.busy_per_worker = np.zeros(self.n_workers, np.int64)

    @property
    def state(self):
        return self._state.gather()

    def run_round(self) -> RoundTelemetry:
        (out, telem), wall, compile_s = self._entry.timed_call(self.ctx,
                                                               self._state)
        self._state = out
        adv = telem["busy_steps"].cpu().numpy().astype(np.int64)
        self.busy_per_worker += adv
        return RoundTelemetry(wall_s=wall, compile_s=compile_s, adv=adv,
                              pending=telem["pending"].cpu().numpy())

    @property
    def done(self) -> bool:
        return all(bool(self.engine.done(s).all())
                   for s in self._state.shards)

    def max_worker_steps(self) -> int:
        return max(int(s.steps.max()) for s in self._state.shards)

    def placement(self) -> str:
        return (f"{self.n_workers} stealing workers on {self.n_devices} "
                f"device(s) (axis {self.axis!r}, round={self.round_steps} "
                f"steps)")
