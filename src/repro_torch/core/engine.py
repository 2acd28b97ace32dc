"""Engine protocol + name registry.

Twin of ``src/repro/core/engine.py``.  The serving stack drives engines
only through the ``Engine`` ABC: constructors (``make_context``,
``init_state``, ``dummy_context``, ``config``), the resumable stepper
(``run``/``run_batch``) and the result schema (``finish``/``partial``/
``counters``/``stacked_counters``/``finish_workers``/``make_result``).
Registered: ``dense`` (bitmask stacks, with resident kernels),
``compact`` (the paper's compact array), and, lazily on the first lookup
that misses, ``count`` ((p,q)-biclique counting) and ``mce`` (maximal
cliques of unipartite embeds).

``Engine.run``/``run_batch`` are the twin of the reference's generic
``lax.while_loop`` driver: the shared lane-batched host loop
(``engine_dense._torch_loop``: one ``any(active)`` read per segment of
``unroll`` guarded steps) over the engine's ``step_lanes``.  Engines with
resident kernels (``dense``) override them.

Device: constructors take the ``device`` their tensors go to (the card
unless the caller asks for the CPU; ``"cuda"`` without a card raises);
``pool_lanes`` asks about a device because the kernel path is decided by
where the tensors live.
"""
from __future__ import annotations

import abc
import dataclasses
import importlib

import numpy as np
import torch

from repro_torch.core import engine_compact as ec
from repro_torch.core import engine_dense as ed
from repro_torch.core.engine_dense import EngineConfig
from repro_torch.core.graph import BipartiteGraph
from repro_torch.core.results import EngineResult, MBEResult
from repro_torch.kernels.dispatch import check_device

_U32_MOD = 1 << 32


class Engine(abc.ABC):
    """One workload engine: constructors + resumable stepper + result
    schema (see ``src/repro/core/engine.py`` for the full contract)."""

    name: str = "engine"
    result_type: type[EngineResult] = MBEResult
    collectable: bool = True
    canonicalize: bool = True
    unipartite: bool = False

    # -- constructors ---------------------------------------------------
    @abc.abstractmethod
    def make_context(self, g: BipartiteGraph, cfg: EngineConfig,
                     device="cuda"):
        """Device-resident graph data (adjacency + orderings)."""

    @abc.abstractmethod
    def init_state(self, cfg: EngineConfig, tasks: np.ndarray,
                   device="cuda"):
        """Fresh worker state owning the given root-task list."""

    @abc.abstractmethod
    def dummy_context(self, cfg: EngineConfig, device="cuda"):
        """All-zero context for idle lanes."""

    def config(self, n_u: int, n_v: int, depth: int, *,
               m_real: int | None = None, **kw) -> EngineConfig:
        """Bucket-shaped ``EngineConfig``; unknown keys are dropped."""
        known = {f.name for f in dataclasses.fields(EngineConfig)}
        kw = {k: v for k, v in kw.items() if k in known}
        return EngineConfig(n_u=n_u, n_v=n_v,
                            m_real=n_u if m_real is None else m_real,
                            depth=depth, **kw)

    def make_config(self, g: BipartiteGraph, **kw) -> EngineConfig:
        """Exact-shape config for one graph (no bucket padding)."""
        return self.config(g.n_u, g.n_v, g.n_u + 2, m_real=g.n_u, **kw)

    def fresh_lane_state(self, cfg: EngineConfig, n_tasks: int,
                         device="cuda"):
        """Worker state owning root tasks [0, n_tasks), task queue padded
        to ``cfg.n_u`` so every serving lane has identical shapes."""
        device = check_device(device)
        s = self.init_state(cfg, np.arange(n_tasks, dtype=np.int32), device)
        pad = np.full(cfg.n_u, -1, np.int32)
        pad[:n_tasks] = np.arange(n_tasks, dtype=np.int32)
        return s._replace(tasks=torch.from_numpy(pad).to(device))

    # -- execution ------------------------------------------------------
    def step_lanes(self, ctx, cfg: EngineConfig, s, act: torch.Tensor,
                   batched: bool) -> None:
        """In place: one guarded engine step on every lane of the batched
        state ``s`` whose ``act`` flag is set (``batched``: ``ctx``
        carries the lane dim too)."""
        raise NotImplementedError(f"engine {self.name!r} has no step_lanes")

    def run(self, ctx, cfg: EngineConfig, s, max_steps: int | None = None,
            unroll: int = 1):
        """Run one lane until done or the step budget expires (resumable):
        segments of ``unroll`` guarded steps, one host read each."""
        return ed._unlane(self.run_batch(ctx, cfg, ed._lanes(s),
                                         max_steps=max_steps, unroll=unroll))

    def run_batch(self, ctx, cfg: EngineConfig, s,
                  max_steps: int | None = None, ctx_batched: bool = False,
                  unroll: int = 1):
        """``run`` over a leading lane dim (``ctx_batched=True``: one graph
        per lane, the serving layout; False: one shared graph)."""
        budget = cfg.max_steps if max_steps is None else max_steps
        return ed._torch_loop(ctx, cfg, s, budget, unroll,
                              batched=ctx_batched,
                              step_lanes=self.step_lanes)

    def run_shards(self, ctxs, cfg: EngineConfig, states,
                   max_steps: int | None = None, ctx_batched: bool = False,
                   unroll: int = 1) -> list:
        """``run_batch`` on every shard of a mesh (``ctxs[d]`` and
        ``states[d]`` on shard d's device), one shard after another;
        engines with a pool kernel advance the shards together."""
        return [self.run_batch(c, cfg, s, max_steps=max_steps,
                               ctx_batched=ctx_batched, unroll=unroll)
                for c, s in zip(ctxs, states)]

    def pool_lanes(self, cfg: EngineConfig, batch: int, device) -> int:
        """Pool width of a multi-lane kernel for ``batch`` lanes on
        ``device``, or 0 (the cache extends its keys with
        ``("pool", width)`` only when nonzero)."""
        return 0

    # -- collect / decode hooks ----------------------------------------
    def done(self, s) -> torch.Tensor:
        return (s.lvl < 0) & (s.tpos >= s.n_tasks)

    def collected(self, cfg: EngineConfig, s, n_u: int,
                  n_v: int) -> list[tuple[tuple, tuple]]:
        return ed.collected_bicliques(cfg, s, n_u, n_v)

    # -- result schema --------------------------------------------------
    def counters(self, s) -> dict:
        """Host-side scalar progress counters of one worker state; ``cs``
        as the unsigned fingerprint."""
        return dict(n_max=int(s.n_max), cs=int(s.cs) % _U32_MOD,
                    nodes=int(s.nodes), steps=int(s.steps))

    def stacked_counters(self, stacked) -> dict:
        """``counters`` summed over a leading worker axis (the big-graph
        lane's stacked state); the fingerprint is an order-independent
        uint32 sum, so the worker-wise sum is the serial value."""
        def total(x):
            return int(x.to(torch.int64).sum())
        return dict(n_max=total(stacked.n_max),
                    cs=int((stacked.cs.to(torch.int64) & 0xFFFFFFFF).sum())
                    % _U32_MOD,
                    nodes=total(stacked.nodes), steps=total(stacked.steps))

    def finish(self, cfg: EngineConfig, s, *, n_u: int, n_v: int,
               swapped: bool = False, collect: bool = False) -> dict:
        """Result payload for ONE completed lane state."""
        out = self.counters(s)
        out.update(bicliques=None, truncated=False)
        if collect:
            bic = self.collected(cfg, s, n_u, n_v)
            if swapped:
                bic = [(R, L) for L, R in bic]
            out["bicliques"] = bic
            out["truncated"] = int(s.n_max) > int(s.out_n)
        return out

    def _collect_workers(self, cfg: EngineConfig, stacked, n_workers: int,
                         n_u: int, n_v: int) -> tuple[list, bool]:
        """Every worker's decoded collect buffer, concatenated, and
        whether any worker's buffer overflowed."""
        out, truncated = [], False
        n_max = stacked.n_max.tolist()
        out_n = stacked.out_n.tolist()
        for w in range(n_workers):
            ws = type(stacked)(*[x[w] for x in stacked])
            out.extend(self.collected(cfg, ws, n_u, n_v))
            truncated |= n_max[w] > out_n[w]
        return out, truncated

    def finish_workers(self, cfg: EngineConfig, stacked, n_workers: int,
                       *, n_u: int, n_v: int, swapped: bool = False,
                       collect: bool = False) -> dict:
        """Result payload for a completed big-graph lane: counters summed
        across the stacked worker states, collect buffers concatenated."""
        out = self.stacked_counters(stacked)
        out.update(bicliques=None, truncated=False)
        if collect:
            bic, truncated = self._collect_workers(cfg, stacked, n_workers,
                                                   n_u, n_v)
            if swapped:
                bic = [(R, L) for L, R in bic]
            out["bicliques"] = bic
            out["truncated"] = truncated
        return out

    def partial(self, counters: dict | None,
                cfg: EngineConfig | None = None) -> dict:
        """Payload of a request that did not run to completion."""
        c = counters or {}
        return dict(n_max=int(c.get("n_max", 0)), cs=int(c.get("cs", 0)),
                    nodes=int(c.get("nodes", 0)),
                    steps=int(c.get("steps", 0)),
                    bicliques=None, truncated=False)

    def make_result(self, **fields) -> EngineResult:
        return self.result_type(**fields)

    # -- convenience ----------------------------------------------------
    def enumerate(self, g: BipartiteGraph, order_mode: str = "deg",
                  collect_cap: int = 1, impl: str = "jnp",
                  kernel_impl: str = "auto", device: str = "cuda",
                  **params):
        """Full single-worker run at the exact graph shape on ``device``;
        returns the final engine state."""
        dev = check_device(device)
        cfg = self.make_config(g, order_mode=order_mode,
                               collect_cap=collect_cap, impl=impl,
                               kernel_impl=kernel_impl, **params)
        ctx = self.make_context(g, cfg, dev)
        s0 = self.init_state(cfg, np.arange(g.n_u, dtype=np.int32), dev)
        out = self.run(ctx, cfg, s0)
        assert bool(self.done(out)), "step budget exhausted"
        return out

    def __repr__(self) -> str:
        return f"<Engine {self.name!r}>"


class DenseEngine(Engine):
    """Bitmask-stack engine (``engine_dense``)."""

    name = "dense"

    def make_context(self, g, cfg, device="cuda"):
        return ed.make_context(g, cfg, device)

    def init_state(self, cfg, tasks, device="cuda"):
        return ed.init_state(cfg, tasks, device)

    def dummy_context(self, cfg, device="cuda"):
        device = check_device(device)

        def z(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=device)
        return ed.GraphContext(adj=z(cfg.n_u, cfg.wv), order=z(cfg.n_u),
                               rank=z(cfg.n_u), l_root=z(cfg.wv),
                               root_counts=z(cfg.n_u))

    def step(self, ctx, cfg, s):
        return ed.step(ctx, cfg, s)

    def run(self, ctx, cfg, s, max_steps=None, unroll=1):
        return ed.run(ctx, cfg, s, max_steps=max_steps, unroll=unroll)

    def run_batch(self, ctx, cfg, s, max_steps=None, ctx_batched=False,
                  unroll=1):
        return ed.run_batch(ctx, cfg, s, max_steps=max_steps,
                            ctx_batched=ctx_batched, unroll=unroll)

    def run_shards(self, ctxs, cfg, states, max_steps=None,
                   ctx_batched=False, unroll=1):
        return ed.run_batch_shards(ctxs, cfg, states, max_steps=max_steps,
                                   ctx_batched=ctx_batched, unroll=unroll)

    def pool_lanes(self, cfg, batch, device):
        return ed.pool_lanes(cfg, batch, device)


class CompactEngine(Engine):
    """Paper-faithful compact-array engine (``engine_compact``); no
    resident kernel, so it runs on the shared lane loop."""

    name = "compact"

    def make_context(self, g, cfg, device="cuda"):
        return ec.make_context(g, cfg, device)

    def init_state(self, cfg, tasks, device="cuda"):
        return ec.init_state(cfg, tasks, device)

    def dummy_context(self, cfg, device="cuda"):
        device = check_device(device)

        def z(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=device)
        return ec.CompactContext(adj=z(cfg.n_u, cfg.wv), order=z(cfg.n_u),
                                 p_static=z(cfg.n_u), lk_static=z(cfg.n_u),
                                 q_static=z(cfg.n_u), l_root=z(cfg.wv))

    def step(self, ctx, cfg, s):
        return ec.step(ctx, cfg, s)

    def step_lanes(self, ctx, cfg, s, act, batched):
        ec._step_lanes(ctx, cfg, s, act, batched)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Engine] = {}

# built-in engines that register themselves on import; loaded lazily so
# this module (which they import) stays cycle-free
_BUILTIN_MODULES = ("repro_torch.core.engine_count",
                    "repro_torch.core.engine_mce")


def _load_builtins() -> None:
    for mod in _BUILTIN_MODULES:
        importlib.import_module(mod)


def register_engine(engine: Engine, *, override: bool = False) -> Engine:
    """Register an engine under its ``name`` (duplicates raise unless
    ``override=True``; re-registering the same instance is a no-op)."""
    prev = _REGISTRY.get(engine.name)
    if prev is not None and prev is not engine and not override:
        raise ValueError(
            f"engine {engine.name!r} is already registered ({prev!r}); "
            f"pass override=True to replace it")
    _REGISTRY[engine.name] = engine
    return engine


def get_engine(engine: str | Engine) -> Engine:
    """Resolve a registry name (or pass an ``Engine`` through)."""
    if isinstance(engine, Engine):
        return engine
    if engine not in _REGISTRY:
        _load_builtins()
    try:
        return _REGISTRY[engine]
    except KeyError:
        raise ValueError(f"unknown engine {engine!r}; available engines: "
                         f"{list_engines()}") from None


def list_engines() -> list[str]:
    """Names of every registered engine (built-ins included)."""
    _load_builtins()
    return sorted(_REGISTRY)


DENSE = register_engine(DenseEngine())
COMPACT = register_engine(CompactEngine())
