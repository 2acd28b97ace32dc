"""Deterministic fault injection for the serving stack (DESIGN.md §13).

Twin of ``src/repro/serving/faults.py``: the exception taxonomy,
``FaultPlan``, ``u01`` (sha256), ``fingerprint`` and ``FaultInjector``
with its big-lane proxy.  ``FaultInjector`` wraps any ``Executor`` behind
the same interface and injects, at the poll / launch boundaries:

* **transient launch faults** (``TransientLaunchError``) and **injected
  compile failures** (``InjectedCompileError``), raised by the launch
  gate BEFORE the wrapped round runs;
* **persistent device-lost** (``DeviceLostError``) after
  ``device_lost_after`` launches, forever: the scheduler fails over;
* **corrupted done-mask reads**: one lane flipped on one read;
* **poison** (``PoisonError``): the ``poison_nth_install``-th lane ever
  installed is fingerprinted by its context's data, and every round on a
  pool hosting that fingerprint raises, so only quarantine isolates it.

Every site draws from its own schedule ``u01(f"{seed}:{site}:{n}")``
with a per-site counter, and the scheduler makes the reference's calls
in the reference's order, so one plan gives the same injector log in
both packages.

What a retry may assume.  An injected launch fault raises before the
wrapped call, so the pool's state is untouched and a retry recomputes
nothing.  A real failure inside a launch is another matter: the port's
resident kernels (K2 / K3) advance the state buffers they are handed in
place, so a CUDA error in the middle of a launch may leave those buffers
half-advanced.  ``RetryPolicy.retry_on`` therefore stays ``(FaultError,)``:
a real kernel error, or a failed ``nvcc`` build, propagates to the caller
and is never retried, quarantined or failed over.

All of it is OFF by default: a server built without a ``FaultPlan``
never constructs an injector.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.serving.executor import Executor, LanePool


# -- exception taxonomy -------------------------------------------------
class FaultError(RuntimeError):
    """Base class for injected (and injectable) serving faults; the
    default ``RetryPolicy.retry_on``."""


class TransientLaunchError(FaultError):
    """A round launch failed before committing any state; retryable."""


class InjectedCompileError(FaultError):
    """An executable's first call failed; retryable (the cache never
    keeps an entry for a failed first call — see ``serving.cache``)."""


class DeviceLostError(FaultError):
    """The executor's device is gone, persistently.  NOT retryable on the
    same executor: the scheduler fails over to a fresh one."""


class PoisonError(FaultError):
    """A request resident in this pool deterministically kills every
    round.  Retry cannot help; quarantine bisection isolates it."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """What to inject, when.  All rates are per-call probabilities drawn
    from the per-site deterministic schedule; everything defaults OFF."""

    seed: int = 0
    launch_rate: float = 0.0        # P(TransientLaunchError) per round launch
    compile_rate: float = 0.0       # P(InjectedCompileError) per round launch
    corrupt_done_rate: float = 0.0  # P(one flipped lane) per done_mask read
    device_lost_after: int | None = None   # launches before permanent death
    poison_nth_install: int | None = None  # 1-based lane-install ordinal to
    #                                        mark as poison (None = no poison)


def u01(key: str) -> float:
    """Deterministic uniform draw in [0, 1) from a string key (sha256:
    no neighbourhood structure between the near-identical per-site keys,
    stable across platforms and processes)."""
    h = hashlib.sha256(key.encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0 ** 64


def fingerprint(tree) -> str:
    """Content hash of an engine NamedTuple (sha1 over the raw bytes of
    every leaf, fields in order).  Poison follows the request's data
    across installs, evictions and failover; the injector never sees
    rids."""
    h = hashlib.sha1()
    for leaf in tree:
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        h.update(np.asarray(leaf).tobytes())
    return h.hexdigest()


class FaultInjector(Executor):
    """Executor decorator injecting the ``FaultPlan``'s faults.

    Every interface method delegates, with injection layered on
    ``run_round`` (launch faults, device-lost, poison), ``done_mask``
    (read corruption), ``install`` (poison fingerprinting) and
    ``big_lane`` (the returned lane is proxied so the big route shares
    the launch-fault schedule).  ``device`` is the wrapped executor's:
    lanes, contexts and restored checkpoints land where the inner
    executor runs.  ``n_injected`` counts every injected fault and
    ``log`` records them as ``(site, n, kind)`` dicts."""

    def __init__(self, inner: Executor, plan: FaultPlan,
                 _poison_fps: set[str] | None = None):
        self.inner = inner
        self.plan = plan
        self.name = f"fault({inner.name})"
        self.device = inner.device
        self.n_injected = 0
        self.log: list[dict] = []
        self._site_counts: dict[str, int] = {}
        self._launches = 0              # global launch-attempt ordinal
        self._dead = False              # device-lost latched
        self._installs = 0              # global lane-install ordinal
        self._poison_fps: set[str] = (_poison_fps if _poison_fps is not None
                                      else set())
        # poisoned lane indices per live pool, keyed by id() (LanePool
        # has __slots__)
        self._marks: dict[int, set[int]] = {}

    # -- schedule -------------------------------------------------------
    def _fire(self, site: str, rate: float) -> bool:
        """One draw from ``site``'s deterministic schedule."""
        if rate <= 0.0:
            return False
        n = self._site_counts.get(site, 0)
        self._site_counts[site] = n + 1
        return u01(f"{self.plan.seed}:{site}:{n}") < rate

    def _record(self, site: str, kind: str) -> None:
        self.n_injected += 1
        self.log.append(dict(site=site, n=self._site_counts.get(site, 0),
                             kind=kind))

    def _launch_gate(self, site: str, poisoned: bool) -> None:
        """The per-launch injection point shared by pool rounds and the
        big-graph lane; raises in severity order."""
        if self._dead:
            raise DeviceLostError(
                "injected device-lost (persistent): executor "
                f"{self.inner.name!r} is gone")
        n = self._launches
        self._launches += 1
        dla = self.plan.device_lost_after
        if dla is not None and n >= dla:
            self._dead = True
            self._record(site, "DeviceLostError")
            raise DeviceLostError(
                f"injected device-lost at launch #{n} (persistent)")
        if poisoned:
            self._record(site, "PoisonError")
            raise PoisonError(
                f"injected poison: a poisoned request is resident ({site})")
        if self._fire(site, self.plan.launch_rate):
            self._record(site, "TransientLaunchError")
            raise TransientLaunchError(
                f"injected transient launch fault ({site}, launch #{n})")
        if self._fire(f"{site}:compile", self.plan.compile_rate):
            self._record(site, "InjectedCompileError")
            raise InjectedCompileError(
                f"injected compile failure ({site}, launch #{n})")

    def for_failover(self, inner: Executor) -> "FaultInjector":
        """The injector for the post-failover executor: same transient
        rates, the device-lost clock and the poison install trigger
        disarmed; recorded poison fingerprints are SHARED, so a poisoned
        request stays poisoned across failover."""
        plan = dataclasses.replace(self.plan, device_lost_after=None,
                                   poison_nth_install=None)
        return FaultInjector(inner, plan, _poison_fps=self._poison_fps)

    # -- lane planning / placement (pure delegation) --------------------
    def plan_lanes(self, n_pending, policy):
        return self.inner.plan_lanes(n_pending, policy)

    def placement(self, n_lanes):
        return self.inner.placement(n_lanes)

    def launches_per_segment(self, pool):
        return self.inner.launches_per_segment(pool)

    # -- pool lifecycle (delegation + poison bookkeeping) ----------------
    def new_pool(self, cfg, n_lanes, engine=None):
        pool = self.inner.new_pool(cfg, n_lanes, engine)
        self._marks[id(pool)] = set()
        return pool

    def install(self, pool, idx, states, ctxs):
        marks = self._marks.setdefault(id(pool), set())
        for i, ctx in zip(idx, ctxs):
            self._installs += 1
            fp = fingerprint(ctx)
            if self.plan.poison_nth_install == self._installs:
                self._poison_fps.add(fp)
                self._record("install", "poison-marked")
            if fp in self._poison_fps:
                marks.add(i)
            else:
                marks.discard(i)
        return self.inner.install(pool, idx, states, ctxs)

    def migrate(self, old, new, live_idx):
        old_marks = self._marks.get(id(old), set())
        self._marks[id(new)] = {j for j, i in enumerate(live_idx)
                                if i in old_marks}
        return self.inner.migrate(old, new, live_idx)

    def evict(self, pool, i):
        self._marks.setdefault(id(pool), set()).discard(i)
        return self.inner.evict(pool, i)

    # -- execution ------------------------------------------------------
    def run_round(self, pool, cache, budget, unroll=1):
        self._launch_gate(f"launch[{pool.cfg.n_u}x{pool.cfg.n_v}]",
                          poisoned=bool(self._marks.get(id(pool))))
        return self.inner.run_round(pool, cache, budget, unroll)

    # -- demux views ----------------------------------------------------
    def lane(self, pool, i):
        return self.inner.lane(pool, i)

    def done_mask(self, pool: LanePool) -> np.ndarray:
        mask = self.inner.done_mask(pool)
        if self._fire("done_mask", self.plan.corrupt_done_rate) \
                and mask.size:
            n = self._site_counts["done_mask"]
            j = int(u01(f"{self.plan.seed}:done_mask_idx:{n}")
                    * mask.size)
            self._record("done_mask", "corrupted-read")
            mask = mask.copy()
            mask[j] = ~mask[j]
        return mask

    def steps(self, pool):
        return self.inner.steps(pool)

    # -- big-graph lane -------------------------------------------------
    def big_lane(self, cfg, ctx, n_roots, cache, budget, engine=None,
                 steps_per_call=1):
        lane = self.inner.big_lane(cfg, ctx, n_roots, cache, budget,
                                   engine=engine,
                                   steps_per_call=steps_per_call)
        poisoned = fingerprint(ctx) in self._poison_fps
        return _InjectedBigLane(self, lane, poisoned)


class _InjectedBigLane:
    """Proxy over a ``BigGraphLane`` so the big route draws from the same
    launch-fault schedule (site ``"big"``); everything else (``state``,
    ``n_workers``, ``n_devices``, ``done``, ``cfg``, ...) delegates."""

    def __init__(self, injector: FaultInjector, lane, poisoned: bool):
        self._injector = injector
        self._lane = lane
        self._poisoned = poisoned

    def run_round(self):
        self._injector._launch_gate("big", poisoned=self._poisoned)
        return self._lane.run_round()

    def __getattr__(self, attr):
        return getattr(self._lane, attr)
