"""Quickstart on the PyTorch / CUDA port: enumerate maximal bicliques
through the one front door.

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

Twin of ``examples/quickstart.py``.  Builds the paper's Figure-1 example
graph and enumerates it through ``MBEClient`` with every MBE-result
engine (the dense engine and the paper-faithful compact-array engine),
checking they agree with each other and with the serial Algorithm-1
oracle; runs the hand-written kernels' path (``kernel_impl="pallas"``,
the resident lane pool); then the other registered workloads
((p,q)-biclique counting and maximal clique enumeration) through the
same client, and finally a bigger power-law graph through the futures
API.  ``--device`` defaults to the CUDA card; on the CPU the kernels'
plain versions run.
"""
import argparse

from repro_torch import (MBEClient, MBEOptions, MBEResult, get_engine,
                         list_engines, unipartite_graph)
from repro_torch.baselines.mbea import bicliques_to_key_set, enumerate_mbea
from repro_torch.core.graph import BipartiteGraph
from repro_torch.data.generators import powerlaw_bipartite


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device

    # --- the paper's Fig. 1 example --------------------------------------
    # U = {A..E} -> 0..4, V = {F..K} -> 0..5
    U = dict(A=0, B=1, C=2, D=3, E=4)
    V = dict(F=0, G=1, H=2, I=3, J=4, K=5)
    edges = [
        (U["A"], V["F"]), (U["A"], V["G"]), (U["A"], V["H"]),
        (U["B"], V["F"]), (U["B"], V["G"]), (U["B"], V["H"]),
        (U["C"], V["F"]), (U["C"], V["G"]), (U["C"], V["H"]),
        (U["C"], V["I"]),
        (U["D"], V["I"]), (U["D"], V["J"]),
        (U["E"], V["J"]), (U["E"], V["K"]),
    ]
    g = BipartiteGraph.from_edges(5, 6, edges, name="fig1")

    client = MBEClient(MBEOptions(collect=True, collect_cap=32, device=dev))
    res = client.enumerate(g)
    print(f"[fig1] {res.status}: engine found {res.n_max} maximal "
          f"bicliques in {res.nodes} search nodes")
    uname = {v: k for k, v in U.items()}
    vname = {v: k for k, v in V.items()}
    for L, R in res.bicliques:
        print("   R={%s}  L={%s}" % (",".join(uname[r] for r in R),
                                     ",".join(vname[l] for l in L)))
    assert res.n_max == len(bicliques_to_key_set(enumerate_mbea(g)))
    print("[fig1] matches the Algorithm-1 oracle")

    # every MBE-result engine, same answer (count and mce answer other
    # questions: a CountResult, a CliqueResult)
    mbe_engines = [n for n in list_engines()
                   if issubclass(get_engine(n).result_type, MBEResult)]
    for name in mbe_engines:
        r2 = MBEClient(MBEOptions(engine=name, collect=True, collect_cap=32,
                                  device=dev)).enumerate(g)
        assert (r2.n_max, r2.cs) == (res.n_max, res.cs), name
        assert bicliques_to_key_set(r2.bicliques) == \
            bicliques_to_key_set(res.bicliques), name
    print(f"[fig1] engines {mbe_engines} agree byte-identically")

    # the hand-written kernels with the multi-lane resident pool: one
    # launch per pool per segment instead of one per lane, same bytes out
    rp = MBEClient(MBEOptions(kernel_impl="pallas", resident_lanes="auto",
                              collect=True, collect_cap=32,
                              device=dev)).enumerate(g)
    assert (rp.n_max, rp.cs) == (res.n_max, res.cs)
    print("[fig1] resident-pool kernel path agrees byte-identically\n")

    # --- the other workloads, same front door ----------------------------
    cres = MBEClient(MBEOptions(engine="count", count_p=2, count_q=2,
                                device=dev)).enumerate(g)
    print(f"[fig1] count engine: {cres.count} (2,2)-bicliques "
          f"(metric={cres.metric})")
    ug = unipartite_graph(4, [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2)],
                          name="house")
    mres = MBEClient(MBEOptions(engine="mce", collect=True, collect_cap=8,
                                device=dev)).enumerate(ug)
    print(f"[{ug.name}] mce engine: {mres.n_max} maximal cliques: "
          f"{sorted(mres.cliques)}\n")

    # --- something bigger, via the futures API ---------------------------
    big = powerlaw_bipartite(192, 384, m_edges=4000, alpha=1.4, seed=7,
                             name="demo-powerlaw")
    client = MBEClient(MBEOptions(bucket_mode="exact", device=dev))
    fut = client.submit(big)      # -> MBEFuture: done()/result()/cancel()
    state = fut.result()
    print(f"[{big.name}] |U|={big.n_u} |V|={big.n_v} |E|={len(big.edges)}: "
          f"{state.n_max} maximal bicliques, {state.nodes} nodes, "
          f"{state.steps} engine steps ({state.latency_s:.2f}s)")
    n_ref = enumerate_mbea(big, collect=False)
    assert state.n_max == n_ref, (state.n_max, n_ref)
    print("matches the oracle count — done.")
    return dict(n_max=res.n_max, engines=mbe_engines, big=state.n_max)


if __name__ == "__main__":
    main()
