"""Work-stealing rounds over the workers of one device.

Twin of ``src/repro/core/distributed.py`` (DESIGN.md §2), single-device
half: cuMBE's coarse-grained parallelism (first-level subtrees, the root
tasks of the global degree order, strided over workers) and its k-level
work stealing as bounded rounds.  Each round runs every worker for
``steps_per_round`` engine steps, then, at the barrier, the pending
(unstarted) root tasks of all workers are flattened and re-dealt
round-robin; an in-flight subtree stays on its worker.
``work_stealing=False`` is the paper's noWS ablation (static strided
assignment only).

What changed in the translation:

* **One device, ``workers_per_device`` workers.**  The reference
  ``shard_map``s the round over a mesh and ``all_gather``s the queues;
  here the workers are the leading dim of one stacked state on one
  device, so the gather is the identity and the re-deal is torch ops on
  that device, with no host sync.  More than one device raises: the
  multi-GPU half (placement, collectives) is ROADMAP Queue 1 item 8.
* **A round is ``engine.run_batch(ctx, cfg, s, max_steps=
  steps_per_round, ctx_batched=False, unroll=steps_per_call)``**: on the
  dense engine's kernel path that is K3 (``resident_pool``) over the
  workers, every worker reading the one shared adjacency.  The budget of
  ``run_batch`` counts from each worker's steps at entry, as the
  reference's resumable ``run`` does, so round r + 1 resumes where round
  r stopped.
* **The drop-mode scatter** of ``_flatten_pending`` becomes a scatter
  into one spare slot that is then cut off.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import engine_dense as ed
from repro_torch.core.graph import BipartiteGraph
from repro_torch.kernels.dispatch import check_device

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class DistConfig:
    steps_per_round: int = 4096     # work-stealing barrier period
    workers_per_device: int = 1     # workers on the device (TBs per SM
    #                                 analog): the leading dim of the state
    work_stealing: bool = True      # False = noWS ablation
    max_rounds: int = 10_000
    steps_per_call: int = 1         # engine-loop unroll inside the round
    #                                 (results are byte-identical)


def require_one_device(n_devices: int) -> None:
    if n_devices != 1:
        raise NotImplementedError(
            f"work stealing across {n_devices} devices (placement and "
            f"collectives over several GPUs) is not ported yet: the rest "
            f"of ROADMAP Queue 1 item 8; the port steals between the "
            f"workers of one device")


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


def make_round_fn(cfg: ed.EngineConfig, n_devices: int = 1,
                  dist: DistConfig = DistConfig(),
                  with_telemetry: bool = False,
                  engine=None):
    """The work-stealing round: ``(ctx, state) -> state`` over the
    stacked worker state (dim 0 = ``dist.workers_per_device`` workers),
    every worker reading the one shared graph context.

    ``with_telemetry=True``: ``(ctx, state) -> (state,
    telemetry)`` with per-worker ``(W,)`` tensors ``busy_steps`` (engine
    steps each worker advanced this round, the Fig.-5 load data) and
    ``pending`` (unstarted root tasks in each queue after the re-deal).
    ``engine``: any registered engine (default dense); the re-deal
    touches only the shared contract's task-queue fields.

    Returns ``(round_fn, n_workers, T)``, ``T = cfg.m_real`` the queue
    capacity (every worker could end up with all roots)."""
    require_one_device(n_devices)
    if engine is None:
        from repro_torch.core.engine import DENSE as engine
    n_workers = dist.workers_per_device
    T = cfg.m_real

    def round_fn(ctx, s):
        steps_before = s.steps
        s = engine.run_batch(ctx, cfg, s, max_steps=dist.steps_per_round,
                             ctx_batched=False,
                             unroll=dist.steps_per_call)
        busy = s.steps - steps_before                     # (W,)
        if dist.work_stealing:
            # ---- work-stealing barrier: into the state the next round
            # reads (run_batch returned a fresh one) ----------------------
            flat, total = _flatten_pending(s.tasks, s.tpos, s.n_tasks)
            tasks, n = _deal_strided(flat, total, n_workers, T)
            s = s._replace(tasks=tasks, n_tasks=n,
                           tpos=torch.zeros_like(s.tpos))
        if not with_telemetry:
            return s
        return s, dict(busy_steps=busy, pending=s.n_tasks - s.tpos)

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
                            n_devices: int = 1,
                            dist: DistConfig = DistConfig(),
                            device="cuda"):
    """``(init_states, round_fn, driver)`` for one graph on ``device``
    (the card unless the caller asks for the CPU), dense engine."""
    device = check_device(device)
    ctx = ed.make_context(g, cfg, device)
    round_fn_core, n_workers, _ = make_round_fn(cfg, n_devices, dist)

    def init_states() -> ed.DenseState:
        """Strided initial assignment of the m_real root tasks."""
        from repro_torch.core.engine import DENSE
        return strided_states(DENSE, cfg, cfg.m_real, n_workers, device)

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
            steps = state.steps.cpu().numpy().astype(np.int64)
            busy = steps - prev_steps
            prev_steps = steps
            done = ed._done(state).cpu().numpy()
            log.append(dict(round=r, busy=busy.copy(),
                            done=int(done.sum()),
                            n_max=int(state.n_max.to(torch.int64).sum())))
            if verbose:
                print(f"round {r}: done {int(done.sum())}/{n_workers} "
                      f"nMB={log[-1]['n_max']}")
            if bool(done.all()):
                break
        return state, log

    return init_states, round_fn, driver


def totals(state) -> dict:
    """Aggregate counters across the worker dimension."""
    return dict(
        n_max=int(state.n_max.to(torch.int64).sum()),
        cs=int((state.cs.to(torch.int64) & 0xFFFFFFFF).sum() % (1 << 32)),
        nodes=int(state.nodes.to(torch.int64).sum()),
        steps=state.steps.cpu().numpy().astype(np.int64),
    )
