"""Work-stealing rounds over the workers of a mesh of devices.

Twin of ``src/repro/core/distributed.py`` (DESIGN.md §2): cuMBE's
coarse-grained parallelism (first-level subtrees, the root tasks of the
global degree order, strided over workers) and its k-level work stealing
as bounded rounds.  Each round runs every worker for ``steps_per_round``
engine steps, then, at the barrier, the pending (unstarted) root tasks
of all workers are flattened and re-dealt round-robin; an in-flight
subtree stays on its worker.  ``work_stealing=False`` is the paper's
noWS ablation (static strided assignment only).

What changed in the translation:

* **One controller, explicit placement.**  The reference ``shard_map``s
  the round over a ``jax.sharding.Mesh``; here one process drives every
  device of a ``launch.mesh.Mesh``, and a state sharded over it is a
  ``Sharded``: one ``workers_per_device``-row shard per device, global
  worker ``w = d * wpd + i`` in the reference's ``P(axis)`` order.  A
  shared graph context is ``replicate``d, one copy per device; the
  per-lane form (``ctx_batched=True``, one graph per lane) is sharded
  like the state.
* **The barrier's ``all_gather``** is a copy of every shard's ``tasks``,
  ``tpos`` and ``n_tasks`` to the mesh's first device, in shard order;
  there they are flattened and re-dealt by global worker id, and each
  shard's rows are copied back to its device (a few KB of int32; no host
  sync when the mesh is one device).
* **Devices advance together.**  ``Engine.run_shards`` runs the round on
  every shard; on the dense engine's pool-kernel path (K3) that is one
  segment launched on every shard, then every shard's flag read, so no
  device waits while the host polls another.  The per-step engines run
  the shards one after another (ROADMAP Queue 1 item 13).
* **The drop-mode scatter** of ``_flatten_pending`` becomes a scatter
  into one spare slot that is then cut off.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import engine_dense as ed
from repro_torch.core.graph import BipartiteGraph
from repro_torch.launch.mesh import Mesh

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class DistConfig:
    steps_per_round: int = 4096     # work-stealing barrier period
    workers_per_device: int = 1     # workers a device (TBs per SM
    #                                 analog): the rows of a state shard
    work_stealing: bool = True      # False = noWS ablation
    max_rounds: int = 10_000
    steps_per_call: int = 1         # engine-loop unroll inside the round
    #                                 (results are byte-identical)


def _rows(tree, lo: int, hi: int, device):
    return type(tree)(*[x[lo:hi].to(device) for x in tree])


class Sharded:
    """A stacked state (dim 0 = rows) split over the devices of a mesh:
    shard ``d`` holds global rows ``[d * k, (d + 1) * k)`` on
    ``mesh.devices[d]`` (the reference's ``NamedSharding(mesh,
    P(axis))``).  ``gather()`` is the global view on the first device."""

    __slots__ = ("shards", "mesh")

    def __init__(self, shards, mesh: Mesh):
        self.shards = tuple(shards)
        self.mesh = mesh

    @classmethod
    def split(cls, tree, mesh: Mesh) -> "Sharded":
        """``tree``'s rows dealt in contiguous blocks over ``mesh``."""
        n = mesh.size
        rows = tree[0].shape[0]
        if rows % n:
            raise ValueError(f"{rows} rows do not split over {n} devices")
        k = rows // n
        return cls([_rows(tree, d * k, (d + 1) * k, dev)
                    for d, dev in enumerate(mesh.devices)], mesh)

    def gather(self):
        """Every row in global order, on the mesh's first device."""
        if len(self.shards) == 1:
            return self.shards[0]
        d0 = self.mesh.devices[0]
        return type(self.shards[0])(*[
            torch.cat([x.to(d0) for x in leaves])
            for leaves in zip(*self.shards)])


class Replicated:
    """One copy of a tree on each device of a mesh (the reference's
    ``P()``); shards on one device share one copy."""

    __slots__ = ("copies", "mesh")

    def __init__(self, tree, mesh: Mesh):
        by_dev = {}
        for dev in mesh.devices:
            if dev not in by_dev:
                by_dev[dev] = type(tree)(*[x.to(dev) for x in tree])
        self.copies = tuple(by_dev[dev] for dev in mesh.devices)
        self.mesh = mesh


def replicate(tree, mesh: Mesh) -> Replicated:
    return tree if isinstance(tree, Replicated) else Replicated(tree, mesh)


def shard(tree, mesh: Mesh) -> Sharded:
    return tree if isinstance(tree, Sharded) else Sharded.split(tree, mesh)


def _mesh_devices(mesh: Mesh, axis_names) -> int:
    n_dev = int(np.prod([mesh.shape[a] for a in axis_names]))
    if n_dev != mesh.size:
        raise ValueError(
            f"the worker dim is sharded over every device: axes "
            f"{tuple(axis_names)} of mesh {mesh} hold {n_dev} of "
            f"{mesh.size}")
    return n_dev


def _flatten_pending(all_tasks: torch.Tensor, all_tpos: torch.Tensor,
                     all_ntask: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(W, T) queues + cursors -> (W*T,) flat pending list (-1 padded) +
    the total pending count."""
    W, T = all_tasks.shape
    dev = all_tasks.device
    n_pend = all_ntask - all_tpos                            # (W,)
    offs = torch.cumsum(n_pend, 0) - n_pend                  # (W,)
    pos = torch.arange(T, device=dev)[None, :]               # (1, T)
    src_idx = (all_tpos[:, None] + pos).clamp(max=T - 1)
    valid = pos < n_pend[:, None]
    gathered = torch.gather(all_tasks, 1, src_idx.long())
    # the reference's mode="drop": invalid entries go to one spare slot
    dst = torch.where(valid, offs[:, None] + pos,
                      torch.full_like(offs[:, None] + pos, W * T))
    flat = torch.full((W * T + 1,), -1, dtype=_I32, device=dev)
    flat.scatter_(0, dst.reshape(-1).long(), gathered.reshape(-1))
    return flat[:W * T], n_pend.sum().to(_I32)


def _deal_strided(flat: torch.Tensor, total: torch.Tensor, n_workers: int,
                  T: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Worker w takes ``flat[w::n_workers]`` — the round-robin deal, for
    every worker at once: (W, T) queues and (W,) counts."""
    dev = flat.device
    j = torch.arange(T, device=dev)[None, :]
    w = torch.arange(n_workers, device=dev)[:, None]
    src = j * n_workers + w
    take = src < total
    tasks = torch.where(take, flat[src.clamp(max=flat.shape[0] - 1)],
                        torch.full_like(src, -1, dtype=_I32))
    return tasks.to(_I32), take.sum(dim=1, dtype=_I32)


def context_specs(cfg: ed.EngineConfig) -> ed.GraphContext:
    """``meta`` stand-ins of the device-resident graph, the reference's
    shapes and dtypes (packed words uint32): the dry run's arguments
    (``launch/dryrun.py``).  Dense engine only, as the reference's."""
    def m(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")
    return ed.GraphContext(
        adj=m((cfg.n_u, cfg.wv), torch.uint32),
        order=m((cfg.n_u,), _I32), rank=m((cfg.n_u,), _I32),
        l_root=m((cfg.wv,), torch.uint32),
        root_counts=m((cfg.n_u,), _I32))


def state_specs(cfg: ed.EngineConfig, n_workers: int) -> ed.DenseState:
    """``meta`` stand-ins of the stacked worker state (dim 0 the
    workers): ``init_state``'s leaves, the reference's dtypes (packed
    words uint32).  Dense engine only, like ``context_specs``."""
    s = ed.init_state(cfg, np.zeros(cfg.m_real, np.int32), device="meta")
    return ed.DenseState(*(
        torch.empty((n_workers,) + tuple(x.shape), device="meta",
                    dtype=torch.uint32 if name in ed.WORD_LEAVES
                    else x.dtype)
        for name, x in zip(ed.DenseState._fields, s)))


def make_round_fn(cfg: ed.EngineConfig, mesh: Mesh,
                  axis_names: tuple[str, ...],
                  dist: DistConfig = DistConfig(),
                  ctx_batched: bool = False,
                  with_telemetry: bool = False,
                  engine=None):
    """The work-stealing round: ``(ctx, state) -> state`` over the worker
    state sharded over ``mesh`` (``axis_names``: the axes the worker dim
    is split over, every device of the mesh), ``workers_per_device``
    rows a device.

    ``ctx_batched=False``: one graph, replicated (a context, or a
    ``Replicated`` one); every worker runs its task slice of it and
    pending tasks are stolen across workers at the barrier.
    ``ctx_batched=True``: the context carries the worker dim, sharded
    like the state (one graph per lane, the serving layout); work
    stealing must then be off, since root-task indices are graph-local.
    ``state`` is a ``Sharded`` state (a stacked one is split first); the
    round returns a ``Sharded`` one.

    ``with_telemetry=True``: ``(ctx, state) -> (state, telemetry)`` with
    per-worker ``(W,)`` tensors on the mesh's first device:
    ``busy_steps`` (engine steps each worker advanced this round, the
    Fig.-5 load data) and ``pending`` (unstarted root tasks in each queue
    after the re-deal).  ``engine``: any registered engine (default
    dense); the re-deal touches only the shared contract's task-queue
    fields.

    Returns ``(round_fn, n_workers, T)``, ``T = cfg.m_real`` the queue
    capacity (every worker could end up with all roots)."""
    if engine is None:
        from repro_torch.core.engine import DENSE as engine
    if ctx_batched and dist.work_stealing:
        raise ValueError("work stealing requires a shared graph context: "
                         "task indices are graph-local (set "
                         "work_stealing=False for per-lane graphs)")
    n_dev = _mesh_devices(mesh, axis_names)
    wpd = dist.workers_per_device
    n_workers = n_dev * wpd
    T = cfg.m_real
    d0 = mesh.devices[0]

    def round_fn(ctx, state):
        state = shard(state, mesh)
        ctxs = (shard(ctx, mesh).shards if ctx_batched
                else replicate(ctx, mesh).copies)
        before = [s.steps for s in state.shards]
        outs = engine.run_shards(ctxs, cfg, state.shards,
                                 max_steps=dist.steps_per_round,
                                 ctx_batched=ctx_batched,
                                 unroll=dist.steps_per_call)
        busy = [s.steps - b for s, b in zip(outs, before)]
        if dist.work_stealing:
            # ---- work-stealing barrier: the queues of every shard on
            # the first device (the all_gather), re-dealt by global
            # worker id, each shard's rows back on its device ----------
            flat, total = _flatten_pending(
                *[torch.cat([getattr(s, f).to(d0) for s in outs])
                  for f in ("tasks", "tpos", "n_tasks")])
            tasks, n = _deal_strided(flat, total, n_workers, T)
            outs = [s._replace(tasks=tasks[d * wpd:(d + 1) * wpd].to(dev),
                               n_tasks=n[d * wpd:(d + 1) * wpd].to(dev),
                               tpos=torch.zeros_like(s.tpos))
                    for d, (s, dev) in enumerate(zip(outs, mesh.devices))]
        out = Sharded(outs, mesh)
        if not with_telemetry:
            return out
        return out, dict(
            busy_steps=torch.cat([b.to(d0) for b in busy]),
            pending=torch.cat([(s.n_tasks - s.tpos).to(d0) for s in outs]))

    return round_fn, n_workers, T


def strided_states(engine, cfg: ed.EngineConfig, n_roots: int,
                   n_workers: int, device):
    """Stacked worker states: the strided initial deal of root tasks
    [0, n_roots) over ``n_workers`` queues of capacity ``cfg.m_real``."""
    T = cfg.m_real
    per = []
    for w in range(n_workers):
        tasks = np.arange(w, n_roots, n_workers, dtype=np.int32)
        s = engine.init_state(cfg, tasks, device)
        pad = np.full(T, -1, np.int32)
        pad[: tasks.shape[0]] = tasks
        per.append(s._replace(tasks=torch.from_numpy(pad).to(s.lvl.device)))
    return type(per[0])(*[torch.stack(xs) for xs in zip(*per)])


def make_distributed_runner(g: BipartiteGraph, cfg: ed.EngineConfig,
                            mesh: Mesh | None = None,
                            axis_names: tuple[str, ...] | None = None,
                            dist: DistConfig = DistConfig(),
                            device="cuda"):
    """``(init_states, round_fn, driver)`` for one graph over ``mesh``
    (default: ``sharding.axes.mbe_serve_mesh`` over every visible card,
    or one CPU shard with ``device="cpu"``), dense engine.
    ``axis_names``: the axes the worker dim is split over (default every
    axis of the mesh)."""
    if mesh is None:
        from repro_torch.sharding.axes import mbe_serve_mesh
        mesh = mbe_serve_mesh(device=device)
    axis_names = tuple(axis_names or mesh.axis_names)
    ctx = replicate(ed.make_context(g, cfg, mesh.devices[0]), mesh)
    round_fn_core, n_workers, _ = make_round_fn(cfg, mesh, axis_names, dist)

    def init_states() -> Sharded:
        """Strided initial assignment of the m_real root tasks."""
        from repro_torch.core.engine import DENSE
        return Sharded.split(strided_states(DENSE, cfg, cfg.m_real,
                                            n_workers, mesh.devices[0]),
                             mesh)

    def round_fn(state):
        return round_fn_core(ctx, state)

    def driver(state=None, verbose: bool = False):
        """Run rounds to completion. Returns (final_state, round_log)."""
        if state is None:
            state = init_states()
        log = []
        prev_steps = np.zeros(n_workers, np.int64)
        for r in range(dist.max_rounds):
            state = round_fn(state)
            view = state.gather()
            steps = view.steps.cpu().numpy().astype(np.int64)
            busy = steps - prev_steps
            prev_steps = steps
            done = ed._done(view).cpu().numpy()
            log.append(dict(round=r, busy=busy.copy(),
                            done=int(done.sum()),
                            n_max=int(view.n_max.to(torch.int64).sum())))
            if verbose:
                print(f"round {r}: done {int(done.sum())}/{n_workers} "
                      f"nMB={log[-1]['n_max']}")
            if bool(done.all()):
                break
        return state, log

    return init_states, round_fn, driver


def totals(state) -> dict:
    """Aggregate counters across the worker dimension (every shard of a
    ``Sharded`` state)."""
    if isinstance(state, Sharded):
        state = state.gather()
    return dict(
        n_max=int(state.n_max.to(torch.int64).sum()),
        cs=int((state.cs.to(torch.int64) & 0xFFFFFFFF).sum() % (1 << 32)),
        nodes=int(state.nodes.to(torch.int64).sum()),
        steps=state.steps.cpu().numpy().astype(np.int64),
    )
