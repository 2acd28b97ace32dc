"""Work-stealing MBE launcher — the paper's workload, end to end.

Twin of ``src/repro/launch/mbe_run.py``, with the same flags: enumerates
all maximal bicliques (or runs another registered engine) of one
generated or Konect-format graph through ``MBEClient`` as ONE request
routed to the work-stealing big-graph lane (``big_graph_threshold=1``):
the graph's root tasks are dealt over ``--workers`` workers of the card
and re-dealt at round barriers.  The run is on one device: with more
than one card visible it raises (several devices are the rest of ROADMAP
Queue 1 item 8).  ``--file`` reads a local edge list; nothing is
downloaded.

Usage (on the card):
  python -m repro_torch.launch.mbe_run --dataset marvel-like --workers 4
  python -m repro_torch.launch.mbe_run --suite test --engine compact
  python -m repro_torch.launch.mbe_run --file graph.tsv --no-work-stealing
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api import (MBEClient, MBEOptions, get_engine, imbalance,
                             unipartite_graph)
from repro_torch.configs.cumbe import SMOKE
from repro_torch.core.distributed import require_one_device
from repro_torch.data.generators import dataset_suite, load_konect
from repro_torch.kernels.dispatch import check_device

# per-suite default dataset: the bench suite keeps the historical
# marvel-like default; the test suite uses its tiny power-law graph
_DEFAULT_DATASET = {"bench": "marvel-like", "test": "powerlaw-tiny"}


def main(argv=None, *, device="cuda") -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default=None,
                    help="name from repro_torch.data.generators."
                         "dataset_suite (default: per-suite)")
    ap.add_argument("--suite", default="bench", choices=["test", "bench"])
    ap.add_argument("--file", default=None,
                    help="Konect-format edge list instead of --dataset")
    ap.add_argument("--engine", default="dense",
                    help="workload engine by registry name (dense, "
                         "compact, count, mce; unknown names raise "
                         "ValueError listing the available engines)")
    ap.add_argument("--count-p", type=int, default=2,
                    help="count engine: p of the (p,q)-biclique count")
    ap.add_argument("--count-q", type=int, default=2,
                    help="count engine: q of the (p,q)-biclique count")
    ap.add_argument("--workers", type=int, default=None,
                    help="stealing workers on the device (default: cumbe "
                         "SMOKE)")
    ap.add_argument("--steps-per-round", type=int, default=4096)
    ap.add_argument("--steps-per-call", type=int, default=1,
                    help="engine-loop unroll per round segment "
                         "(byte-identical results)")
    ap.add_argument("--kernel-impl", default="auto",
                    choices=["auto", "jnp", "pallas"],
                    help="step-kernel path: the CUDA kernels vs torch ops "
                         "('auto' = the kernels on the card)")
    ap.add_argument("--resident-lanes",
                    type=lambda v: v if v == "auto" else int(v),
                    default="auto",
                    help="kernel path: the multi-lane resident pool kernel "
                         "('auto' = one launch per worker pool whenever "
                         "the gate admits it, int k caps the pool width, "
                         "0/1 pins one launch per worker)")
    ap.add_argument("--resident-rebalance", action="store_true",
                    help="pool path: rebalance surplus step budget from "
                         "finished to busy workers at segment boundaries")
    ap.add_argument("--no-work-stealing", action="store_true")
    ap.add_argument("--order", default="deg", choices=["deg", "input"])
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    dev = check_device(device)
    if dev.type == "cuda":
        require_one_device(torch.cuda.device_count())
    if args.file:
        g = load_konect(args.file)
    else:
        name = args.dataset or _DEFAULT_DATASET[args.suite]
        g = dataset_suite(args.suite)[name]
    if get_engine(args.engine).unipartite:
        # unipartite engines (mce) take symmetric embeds: serve the
        # dataset's incidence graph (U ∪ V vertices, one undirected edge
        # per bipartite edge)
        g = unipartite_graph(g.n_u + g.n_v,
                             [(int(u), g.n_u + int(v)) for u, v in g.edges],
                             name=f"{g.name}-incidence")
    print(f"[mbe] graph {g.name}: |U|={g.n_u} |V|={g.n_v} "
          f"|E|={len(g.edges)}")

    workers = args.workers or SMOKE.dist.workers_per_device
    client = MBEClient(MBEOptions(
        engine=args.engine, order_mode=args.order,
        count_p=args.count_p, count_q=args.count_q,
        kernel_impl=args.kernel_impl,
        resident_lanes=args.resident_lanes,
        resident_rebalance=args.resident_rebalance,
        bucket_mode="exact",            # one graph: no padding wanted
        big_graph_threshold=1,          # the whole run IS the big route
        steps_per_round=args.steps_per_round,
        steps_per_call=args.steps_per_call,
        workers_per_device=workers, big_workers=workers,
        work_stealing=not args.no_work_stealing, device=str(dev)))
    t0 = time.time()
    fut = client.submit(g)
    while not fut.done():
        client.poll()
        if args.verbose:
            st = client.stats()
            print(f"round {st['batches']}: busy/worker = "
                  f"{st['big_busy_per_worker']}")
    res = fut.result()
    dt = time.time() - t0
    st = client.stats()
    per_worker = np.asarray(st["big_busy_per_worker"], dtype=np.int64)
    imb = imbalance(per_worker)
    assert abs(imb - st["big_imbalance"]) < 1e-12
    print(f"[mbe] metric={res.metric} nodes={res.nodes} "
          f"rounds={st['batches']} time={dt:.2f}s "
          f"engine={st['engine']} "
          f"imbalance(max/mean)={imb:.3f}")
    out = dict(metric=res.metric, nodes=res.nodes, rounds=st["batches"],
               seconds=dt, imbalance=imb, engine=st["engine"])
    if hasattr(res, "n_max"):       # the MBE / MCE callers' key
        out["n_max"] = res.n_max
    return out


if __name__ == "__main__":
    main()
