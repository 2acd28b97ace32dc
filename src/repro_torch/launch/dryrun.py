"""Multi-pod dry run: every (arch x shape) cell traced on the production
meshes, with one device's FLOPs, HBM bytes, collective bytes and memory.

Twin of ``src/repro/launch/dryrun.py``.  The reference lowers and
compiles each cell with ``jax.jit`` on 512 placeholder CPU devices and
reads the compiled module (``memory_analysis``, its HLO text through
``hlo_stats``).  The port has no compiler to ask.  It runs the cell's
step on ``meta`` tensors (shapes and dtypes, no storage) over a
``make_production_mesh`` of ``meta`` entries, under the cell's
``make_rules`` table and ``sharding.axes.lead()``: the single controller
runs device 0's share of the step, and ``hlo_stats.OpCounter`` counts
the aten operators it dispatches (see there for the cost model).  The
step is the port's own: ``make_train_step`` with AdamW,
``make_prefill_step``, ``make_serve_step``.

Record per cell (the reference's keys): ``status``, ``memory``,
``hlo_flops``, ``hlo_conv_flops``, ``hlo_bytes``, ``collectives``,
``n_devices``, the cell's meta (arch, shape, mesh, params, ...), and
``trace_s`` and ``n_ops`` (the reference's ``lower_s`` / ``compile_s``
have no counterpart).  ``memory``, device 0's:

* ``argument_size_in_bytes``: its shards of the arguments, exactly: the
  fp32 params, AdamW's fp32 moments and int32 step (train), the batch
  rows it holds (``input_specs``' dtypes), or the decode cache's part
  (``models.model.mesh_cache_axes``), tokens and position;
* ``output_size_in_bytes``: its part of what the step returns (the
  updated params and moments and the metrics; the next tokens, gathered
  on device 0; the tokens and the cache);
* ``temp_size_in_bytes``: the peak of the bytes of the storages the
  trace made that were live at once (``OpCounter``'s ``peak_bytes``;
  arguments excluded, outputs counted while they live).

The ``cumbe`` cell is the paper's own workload: its argument bytes are
the graph context (``core.distributed.context_specs``, replicated) and
one worker's state (``state_specs``); for one engine step it records the
operations and bytes of the K1-K3 bound in ``PERF.md`` section 6 (an AND
and a popcount a word over the n_u x wv adjacency, the adjacency read
once), as ``hlo_flops`` / ``hlo_bytes``.  The round's data-dependent
loop is not counted.

  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k \\
      --mesh pod1
  python -m repro_torch.launch.dryrun --mesh both     # every cell

Records go to ``build/dryrun_torch/<arch>__<shape>__<pod1|pod2>.json``;
a cell that fails is recorded with ``status: "error"`` and the run goes
on.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs import (ARCH_IDS, SHAPES, cache_len, get_config,
                                 input_specs)
from repro_torch.launch import hlo_stats
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.layers import abstract_params
from repro_torch.sharding import axes as A
from repro_torch.sharding.auto import make_rules, rules_report
from repro_torch.training.optimizer import adamw
from repro_torch.training.step import (make_prefill_step, make_serve_step,
                                       make_train_step)

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "build", "dryrun_torch")


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _device0_bytes(tree) -> int:
    """Bytes device 0 holds of ``tree``: a sharded leaf's device-0 shard,
    a list laid out a part a device its first part, a plain tensor
    whole."""
    if isinstance(tree, A.Shards):
        return _nbytes(tree.parts[0])
    if isinstance(tree, torch.Tensor):
        return _nbytes(tree)
    if isinstance(tree, dict):
        return sum(_device0_bytes(v) for v in tree.values())
    if isinstance(tree, list):      # one part a device
        return _device0_bytes(tree[0]) if tree else 0
    if isinstance(tree, tuple):
        return sum(_device0_bytes(v) for v in tree)
    return 0


def _abstract_shards(specs: dict, rules) -> dict:
    """fp32 ``meta`` parameters laid out under ``rules``: one shard a
    distinct part (``Shards``), or whole on a one-device mesh."""
    if rules.mesh.size == 1:
        return abstract_params(specs)
    out = {}
    for k, s in specs.items():
        sh = A.named_sharding(s.logical, rules)
        shape = M._local_shape(sh, s.shape, 0)
        out[k] = A.Shards([torch.empty(shape, dtype=torch.float32,
                                       device="meta")
                           for _ in range(sh.n_shards())], sh, s.shape)
    return out


def _batch_part(x: torch.Tensor, rules, logical) -> torch.Tensor:
    """The rows of a batch input device 0 holds (``act_batch``)."""
    if rules.mesh.size == 1:
        return x
    sh = A.NamedSharding(rules.mesh, A.spec_for(logical, rules))
    return x[sh.slices(x.shape, rules.mesh.coords(0))]


def build_lm_cell(arch: str, shape_name: str, multi_pod: bool, *,
                  mesh=None, cfg=None, shape=None):
    """(fn, args, arg_bytes, rules, mesh, meta): the step, its ``meta``
    arguments, device 0's argument bytes.  ``mesh`` / ``cfg`` / ``shape``
    replace the production mesh, the arch's config and the named shape (a
    smaller cell for a check)."""
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    rules = make_rules(cfg, mesh, shape, multi_pod=multi_pod)
    specs = M.param_specs(cfg)
    params = _abstract_shards(specs, rules)
    batch = input_specs(cfg, shape)
    meta = dict(arch=arch, shape=shape_name,
                mesh="x".join(str(n) for n in mesh.shape.values()),
                params=cfg.n_params(), active_params=cfg.n_active_params(),
                seq=shape.seq_len, batch=shape.global_batch,
                kind=shape.kind, unsharded=rules_report(cfg, rules))
    tok_l = ("act_batch",) + (None,) * (batch["tokens"].dim() - 1)
    if shape.kind == "train":
        opt = adamw(total_steps=10_000)
        fn = make_train_step(cfg, opt)
        with A.use_rules(rules), A.lead():
            state = opt.init(params)
        args = (params, state, batch)
        arg_bytes = (3 * _device0_bytes(params)
                     + _nbytes(state.step)
                     + sum(_nbytes(_batch_part(v, rules, tok_l
                                               if k != "patch_emb" else
                                               ("act_batch", None, None)))
                           for k, v in batch.items()))
    elif shape.kind == "prefill":
        fn = make_prefill_step(cfg)
        args = (params, batch)
        arg_bytes = _device0_bytes(params) + sum(
            _nbytes(_batch_part(v, rules, tok_l if k != "patch_emb" else
                                ("act_batch", None, None)))
            for k, v in batch.items())
    else:
        fn = make_serve_step(cfg)
        with A.use_rules(rules), A.lead():
            cache = M.init_cache(cfg, shape.global_batch,
                                 cache_len(cfg, shape), device="meta")
        args = (params, cache, batch["tokens"], batch["pos"])
        arg_bytes = (_device0_bytes(params) + _device0_bytes(cache)
                     + _nbytes(_batch_part(batch["tokens"], rules, tok_l))
                     + _nbytes(batch["pos"]))
    return fn, args, arg_bytes, rules, mesh, meta


def build_mbe_cell(multi_pod: bool):
    """The paper's own workload: one distributed work-stealing round's
    arguments and one engine step's bound (see the module docstring)."""
    from repro_torch.configs.cumbe import CONFIG as W
    from repro_torch.core import distributed as dd
    mesh = make_production_mesh(multi_pod=multi_pod)
    ecfg = W.engine_config()
    n_workers = mesh.size * W.dist.workers_per_device
    ctx = dd.context_specs(ecfg)
    state = dd.state_specs(ecfg, n_workers)
    per_worker = sum(_nbytes(x) // n_workers for x in state)
    arg_bytes = sum(map(_nbytes, ctx)) + per_worker * \
        W.dist.workers_per_device
    words = ecfg.n_u * ecfg.wv
    step = dict(ops=2 * words,                 # AND + popcount a word
                bytes=4 * words + 4 * ecfg.wv + 4 * ecfg.n_u)
    meta = dict(arch="cumbe", shape=W.name,
                mesh="x".join(str(n) for n in mesh.shape.values()),
                n_u=W.n_u, n_v=W.n_v, workers=n_workers, kind="mbe")
    return step, arg_bytes, mesh, meta


def _leaves(tree) -> list[torch.Tensor]:
    """Every tensor of ``tree`` (dicts, lists, tuples, ``Shards``)."""
    if isinstance(tree, A.Shards):
        return list(tree.parts)
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _leaves(x)]
    return []


def trace_cell(fn, args, rules) -> tuple[dict, object, float]:
    """``fn(*args)`` under ``rules`` and ``lead()``, counted: (stats,
    result, seconds)."""
    t0 = time.time()
    with A.use_rules(rules), A.lead(), \
            hlo_stats.OpCounter(_leaves(args)) as c:
        res = fn(*args)
    return c.stats(), res, time.time() - t0


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    if arch == "cumbe":
        t0 = time.time()
        step, arg_bytes, mesh, meta = build_mbe_cell(multi_pod)
        return dict(meta, status="ok", trace_s=round(time.time() - t0, 3),
                    memory=dict(argument_size_in_bytes=int(arg_bytes)),
                    hlo_flops=float(step["ops"]), hlo_conv_flops=0.0,
                    hlo_bytes=float(step["bytes"]),
                    collectives=dict({k: 0 for k in hlo_stats.COLLECTIVES},
                                     total=0, counts={}),
                    n_devices=mesh.size, per="one engine step (K1-K3 bound)")
    fn, args, arg_bytes, rules, mesh, meta = build_lm_cell(
        arch, shape_name, multi_pod)
    stats, res, secs = trace_cell(fn, args, rules)
    with A.lead():
        out_bytes = _device0_bytes(res)
    return dict(meta, status="ok", trace_s=round(secs, 3),
                memory=dict(argument_size_in_bytes=int(arg_bytes),
                            output_size_in_bytes=int(out_bytes),
                            temp_size_in_bytes=int(stats["peak_bytes"])),
                hlo_flops=stats["flops"],
                hlo_conv_flops=stats["conv_flops"],
                hlo_bytes=stats["hbm_bytes"],
                collectives=stats["collectives"], n_ops=stats["n_ops"],
                n_devices=mesh.size, per="device 0")


def _cell_name(arch, shape, multi_pod):
    return f"{arch}__{shape}__{'pod2' if multi_pod else 'pod1'}"


def all_cells() -> list[tuple[str, str]]:
    cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    cells.append(("cumbe", "cumbe-16k"))
    return cells


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="multi-pod dry run: each cell traced on meta tensors "
                    "over the production mesh, device 0's program counted "
                    "(there is no saved HLO, so the reference's --restat "
                    "and --save-hlo have no counterpart)")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["pod1", "pod2", "both"],
                    default="both")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    cells = all_cells()
    if args.arch:
        cells = [c for c in cells if c[0] == args.arch]
    if args.shape:
        cells = [c for c in cells if c[1] == args.shape]
    if args.list:
        for c in cells:
            print(f"{c[0]} x {c[1]}")
        return 0
    meshes = {"pod1": [False], "pod2": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)

    failures = 0
    t_all = time.time()
    for arch, shape in cells:
        for mp in meshes:
            name = _cell_name(arch, shape, mp)
            try:
                rec = run_cell(arch, shape, mp)
                temp = rec["memory"].get("temp_size_in_bytes", -1)
                print(f"[ok] {name}: trace {rec['trace_s']}s "
                      f"flops={rec['hlo_flops']:.3e} "
                      f"bytes={rec['hlo_bytes']:.3e} "
                      f"coll={rec['collectives']['total']:.3e}B "
                      f"temp={temp:.3e}", flush=True)
            except Exception as e:  # noqa: BLE001 — record and continue
                failures += 1
                rec = dict(arch=arch, shape=shape,
                           mesh="2x16x16" if mp else "16x16",
                           status="error", error=repr(e),
                           trace=traceback.format_exc())
                print(f"[FAIL] {name}: {e!r}", flush=True)
            with open(os.path.join(args.out, name + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
    print(f"done: {len(cells) * len(meshes) - failures} ok, "
          f"{failures} failed, {time.time() - t_all:.1f} s")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
