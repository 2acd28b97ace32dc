#!/usr/bin/env python3
"""Profiler windows over the row kernels on one card: how many of a
window's five launches ``torch.profiler`` reports.

    python3 chip_profile_windows.py [--windows N] [--settle SECONDS]

Each window profiles five launches of one wrapper (K4
``fused_select_packed``, K1 ``fused_check_packed``, K5
``intersect_count``) with CUDA activity only, the launches ``--settle``
seconds after the window opens: by default 0.05, the
``PROFILE_SETTLE_S`` of ``tests/test_torch_cuda_kernels.py`` and
``chip_smoke.py``; ``--settle 0`` opens it as those tests did before.

For every window: the kernel events and ``skew_us``, how far before its
own launch call a kept kernel is stamped (each kernel paired with the
launch of the same rank counted from the last; the largest over the
window), a lower bound on how far the card's converted clock runs
behind the host's.  Per wrapper: windows, windows that saw all five,
windows that lost some, and the skew's median and maximum.  The last
line is one JSON object of those summaries.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
LAUNCHES = 5


def calls(dev):
    """{wrapper name: (kernel name part, fn() launching once)} on one
    lane of 512 rows x 64 words (the per-step pools' 512 x 2048 bucket)."""
    import torch
    from repro_torch.core import bitset
    from repro_torch.kernels import fused_check as fc
    from repro_torch.kernels import fused_select as fs
    from repro_torch.kernels.intersect_count import intersect_count
    g = torch.Generator(device=dev).manual_seed(0)

    def words(*shape):
        return (torch.randint(-(1 << 31), 1 << 31, shape, generator=g,
                              device=dev, dtype=torch.int32)
                & torch.randint(-(1 << 31), 1 << 31, shape, generator=g,
                                device=dev, dtype=torch.int32))
    n, w = 512, 64
    adj, mask = words(1, n, w), words(1, w)
    act = bitset.from_bool(torch.rand(1, n, generator=g, device=dev) < 0.5)
    q = bitset.from_bool(torch.rand(1, n, generator=g, device=dev) < 0.3)
    p, nlp = act & ~q, bitset.count(mask)
    return {
        "fused_select_packed": ("fused_select_kernel", lambda: (
            fs.fused_select_packed(adj, mask, act, impl="pallas"))),
        "fused_check_packed": ("fused_check_kernel", lambda: (
            fc.fused_check_packed(adj, mask, nlp, q, p, impl="pallas"))),
        "intersect_count": ("intersect_count_kernel", lambda: (
            intersect_count(adj, mask, impl="pallas"))),
    }


def window(fn, part, settle) -> dict:
    """One window of LAUNCHES calls of ``fn``: kernels seen, whether all
    are ``part``'s, and the skew."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(settle)
        for _ in range(LAUNCHES):
            fn()
        torch.cuda.synchronize()
    with tempfile.NamedTemporaryFile(suffix=".json", delete=False) as f:
        path = f.name
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f).get("traceEvents", [])
                      if e.get("ph") == "X"]
    finally:
        os.unlink(path)
    ks = sorted(e["ts"] for e in events if e.get("cat") == "kernel")
    launches = sorted(e["ts"] for e in events
                      if e.get("cat") == "cuda_runtime"
                      and "Launch" in e.get("name", ""))
    pairs = list(zip(launches[-len(ks):], ks)) if ks else []
    return dict(kernels=len(ks),
                names_ok=all(part in e.get("name", "") for e in events
                             if e.get("cat") == "kernel"),
                skew_us=max((a - b for a, b in pairs), default=None))


def summarize(rs) -> dict:
    skew = sorted(r["skew_us"] for r in rs if r["skew_us"] is not None)
    return dict(windows=len(rs),
                all_five=sum(r["kernels"] == LAUNCHES for r in rs),
                lost_some=sum(r["kernels"] < LAUNCHES for r in rs),
                names_ok=all(r["names_ok"] for r in rs),
                skew_us_median=skew[len(skew) // 2] if skew else None,
                skew_us_max=skew[-1] if skew else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=200)
    ap.add_argument("--settle", type=float, default=0.05)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_profile_windows.py: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(f"[device] {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, cuda {torch.version.cuda}", flush=True)
    cs = calls(dev)
    for _, fn in cs.values():           # build and warm every kernel
        fn()
    records: dict = {name: [] for name in cs}
    t0 = time.perf_counter()
    for _ in range(args.windows):       # interleaved: drift hits all alike
        for name, (part, fn) in cs.items():
            records[name].append(window(fn, part, args.settle))
    summary = {k: summarize(rs) for k, rs in records.items()}
    print(f"  settle {args.settle} s: {args.windows * len(cs)} windows in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(dict(settle_s=args.settle, by_wrapper=summary)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
