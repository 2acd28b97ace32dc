"""Distributed MBE with work stealing over a mesh of devices.

    PYTHONPATH=src python examples/torch/mbe_distributed.py [--device cpu]

Twin of ``examples/mbe_distributed.py``.  Enumerates a
workload-imbalanced power-law graph through ``MBEClient`` with
``big_graph_threshold=1``: the whole graph goes to the work-stealing
big-graph lane, 2 workers on every device of the serving mesh (every
visible card; with ``--device cpu``, a CPU mesh of 8 shards, the
counterpart of the reference's 8 simulated host devices).  Runs with and
without the round-based work-stealing rebalance (``work_stealing=False``
is the paper's noWS ablation) and prints the per-worker busy-step
distribution: the live version of the paper's Figure 5.
"""
import argparse

import numpy as np

from repro_torch import MBEClient, MBEOptions
from repro_torch.baselines.mbea import count_mbea
from repro_torch.data.generators import powerlaw_bipartite
from repro_torch.sharding.axes import mbe_serve_mesh


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device
    mesh = mbe_serve_mesh(8 if dev == "cpu" else None, device=dev)

    g = powerlaw_bipartite(256, 512, m_edges=7000, alpha=1.35, seed=12,
                           name="marvel-like")
    print(f"[mbe] {g.name}: |U|={g.n_u} |V|={g.n_v} |E|={len(g.edges)} "
          f"on {mesh.size} devices ({mesh.devices[0].type})")
    oracle = count_mbea(g)

    out = {}
    for ws in (False, True):
        client = MBEClient(MBEOptions(
            bucket_mode="exact", big_graph_threshold=1, steps_per_round=512,
            mesh=mesh, workers_per_device=2, work_stealing=ws, device=dev))
        res = client.enumerate(g)
        assert res.n_max == oracle, (res.n_max, oracle)
        st = client.stats()
        busy = np.asarray(st["big_busy_per_worker"], dtype=float)
        rel = busy / busy.mean()
        tag = "work-stealing" if ws else "static       "
        print(f"[{tag}] nMB={res.n_max} rounds={st['batches']} "
              f"busy min/med/max = {rel.min():.2f}/{np.median(rel):.2f}/"
              f"{rel.max():.2f} (x mean)   "
              f"imbalance={st['big_imbalance']:.3f}")
        per_dev = busy.reshape(mesh.size, -1).sum(axis=1).astype(int)
        print(f"[{tag}] busy steps per worker: "
              f"{[int(b) for b in st['big_busy_per_worker']]}")
        print(f"[{tag}] busy steps per device: {per_dev.tolist()}")
        out[ws] = dict(n_max=res.n_max, rounds=st["batches"],
                       busy=list(st["big_busy_per_worker"]),
                       busy_per_device=per_dev.tolist(),
                       imbalance=st["big_imbalance"])
    print("[mbe] both schedules agree with the serial oracle")
    return out


if __name__ == "__main__":
    main()
