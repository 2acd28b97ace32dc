#!/usr/bin/env python3
"""Chip smoke run of the PyTorch / CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

It never imports JAX or the JAX package ``repro``; its ground truth is the
port's NumPy copy of the serial MBEA oracle.  Phases (each one that fails
makes the script exit non-zero):

1. device   — the card's name and power limit;
2. build    — nvcc builds every ``src/repro_torch/csrc/*.cu`` (timed);
3. kernels  — each CUDA kernel against its plain torch-op version on the
              card, bit for bit (tolerance: exact, integer outputs):
              fused_check at (512, 64) and (1024, 128) with and without
              counts; resident_pool and resident_step on real pools
              (bucket 512 x 2048 with two graphs, an 8-lane stream pool,
              and the 1024 x 4096 bucket whose adjacency does not fit in
              shared memory) in every order mode, steps_per_call 1 and 16,
              rebalance off and on, at every segment boundary;
4. main     — the port's main path through ``MBEClient`` at default
              options (a 32-graph stream and dblp-like), the bench suite
              plus dblp-large at steps_per_call=16, then resident_lanes=0
              (single-lane kernel) and resident=False (per-step
              fused_check: one bench graph through ``run``, and two real
              pools through ``run_batch`` at buckets 128 x 256
              (unicode-like + ucforum-like) and 512 x 2048 (dblp-like +
              corp-leadership)); every n_max and cs against the oracle, every
              kernel's launch count > 0 on its path, counted per path;
5. times    — per-kernel CUDA-event times at the main path's shapes
              beside the plain version and the bound.

Every phase runs on every call; the script takes no arguments.  The line
before the last is the ``{"kernels": [...]}`` record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

H100_BYTES_PER_S = 3.35e12      # HBM3, SXM data sheet
H100_INT_OPS_PER_S = 67e12      # CUDA-core 32-bit rate (NVIDIA's published
#                                 FP32 non-tensor peak), for AND/popcount
#                                 words


def log(*a):
    print(*a, flush=True)


class PhaseError(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise PhaseError(msg)


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def max_err(a, b) -> int:
    """max |a - b| over two int32 tensors/states (0 = bit-exact)."""
    import torch
    if isinstance(a, tuple):
        return max(max_err(x, y) for x, y in zip(a, b))
    if a is None:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) \
        if a.numel() else 0


def assert_states_equal(a, b, what):
    """Every leaf equal; on a difference, name the leaf, the first
    differing positions and both sides' cursor scalars."""
    import torch
    for name, x, y in zip(a._fields, a, b):
        if not torch.equal(x, y):
            diff = (x != y).nonzero()[:4].tolist()
            vals = [(x[tuple(i)].item(), y[tuple(i)].item()) for i in diff]
            cur = {f: (getattr(a, f).tolist(), getattr(b, f).tolist())
                   for f in ("lvl", "forced_x", "tpos", "steps", "nodes",
                             "n_max", "out_n")}
            raise PhaseError(f"{what}: leaf {name} differs (max |err| "
                             f"{max_err(x, y)}) at {diff} kernel/plain "
                             f"{vals}; cursors kernel/plain {cur}")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def k1_inputs(n, w, seed, dev):
    import numpy as np
    import torch
    from repro_torch.core import bitset
    rng = np.random.default_rng(seed)
    adj = rng.integers(0, 1 << 32, size=(n, w), dtype=np.uint64)
    adj &= rng.integers(0, 1 << 32, size=(n, w), dtype=np.uint64)
    mask = rng.integers(0, 1 << 32, size=(w,), dtype=np.uint64)
    mask &= rng.integers(0, 1 << 32, size=(w,), dtype=np.uint64)
    adj[::7] |= mask            # rows with c == |L'| (full / violation)
    adj[3::11] = 0              # rows with c == 0
    nw = (n + 31) // 32
    q = rng.integers(0, 1 << 32, size=(nw,), dtype=np.uint64)
    p = rng.integers(0, 1 << 32, size=(nw,), dtype=np.uint64) & ~q
    if n % 32:
        q[-1] &= (1 << (n % 32)) - 1
        p[-1] &= (1 << (n % 32)) - 1
    nlp = int(sum(bin(int(x)).count("1") for x in mask))
    t = [bitset.from_u32(x.astype(np.uint32), dev) for x in (adj, mask, q, p)]
    return t[0], t[1], torch.tensor(nlp, dtype=torch.int32, device=dev), \
        t[2], t[3]


def check_fused_check(dev, seed):
    from repro_torch.kernels.fused_check.ops import fused_check_packed
    from repro_torch.kernels.fused_check.ref import fused_check_packed_ref
    worst = 0
    for n, w in ((512, 64), (1024, 128), (100, 3)):
        for with_counts in (False, True):
            args = k1_inputs(n, w, seed + n, dev)
            got = fused_check_packed(*args, impl="pallas",
                                     with_counts=with_counts)
            want = fused_check_packed_ref(*args, with_counts=with_counts)
            err = max_err(tuple(got), tuple(want))
            require(err == 0, f"fused_check ({n},{w}) counts={with_counts}"
                              f" differs (max |err| {err})")
            worst = max(worst, err)
    # lane-batched form (the per-step engine path): shared adjacency
    import torch
    adj, mask, nlp, q, p = k1_inputs(512, 64, seed, dev)
    masks = torch.stack([mask, mask & ~adj[5], adj[9]])
    from repro_torch.core import bitset
    nlps = bitset.count(masks)
    qs = torch.stack([q, p, q & p])
    ps = torch.stack([p, q, p])
    got = fused_check_packed(adj, masks, nlps, qs, ps, impl="pallas",
                             with_counts=True)
    want = fused_check_packed_ref(adj, masks, nlps, qs, ps, with_counts=True)
    err = max_err(tuple(got), tuple(want))
    require(err == 0, f"fused_check lane-batched differs ({err})")
    worst = max(worst, err)
    # per-lane adjacency at the per-step pools' buckets (128 x 256 and
    # 512 x 2048, two lanes)
    for n, w in ((128, 8), (512, 64)):
        args = k1_lane_inputs(2, n, w, seed + 3 * n, dev)
        got = fused_check_packed(*args, impl="pallas", with_counts=True)
        want = fused_check_packed_ref(*args, with_counts=True)
        err = max_err(tuple(got), tuple(want))
        require(err == 0, f"fused_check per-lane adj ({n},{w}) differs "
                          f"({err})")
        worst = max(worst, err)
    log(f"  fused_check: bit-exact at (512,64), (1024,128), (100,3), "
        f"counts on/off, lane-batched shared and per-lane adjacency")
    return worst


def bucket_pool(graphs, dev, **cfg_kw):
    """(cfg, stacked ctx, stacked fresh state) of one bucket's pool."""
    from repro_torch.core.engine import DENSE
    from repro_torch.serving.buckets import BucketPolicy, plan_bucket
    from repro_torch.serving.executor import _stack
    specs = {plan_bucket(g.canonical(), BucketPolicy()) for g in graphs}
    spec = max(specs, key=lambda b: (b.n_u, b.n_v))
    cfg = spec.engine_config(**cfg_kw)
    ctxs = [DENSE.make_context(g.canonical(), cfg, dev) for g in graphs]
    sts = [DENSE.fresh_lane_state(cfg, g.canonical().n_u, dev)
           for g in graphs]
    return cfg, _stack(ctxs), _stack(sts)


def drive_pool(ctx, cfg, s, *, spc, budget, rebalance, segments, what):
    """Pool kernel and plain pool segment in lockstep from state ``s``;
    every leaf and the scoreboard equal at every boundary."""
    import torch
    from repro_torch.core import engine_dense as ed
    from repro_torch.kernels.resident_pool.ops import resident_pool_segment
    from repro_torch.kernels.resident_pool.ref import (
        resident_pool_segment_ref)
    start = s.steps.clone()
    bud = torch.full_like(start, budget)
    sk = sr = s
    worst = 0
    for seg in range(segments):
        if not bool(ed._active(sk, start, bud).any()):
            break
        sk, bk = resident_pool_segment(ctx, cfg, sk, start=start,
                                       budget=bud, steps_per_call=spc,
                                       ctx_batched=True)
        sr, br = resident_pool_segment_ref(ctx, cfg, sr, start=start,
                                           budget=bud, steps_per_call=spc,
                                           ctx_batched=True)
        torch.cuda.synchronize()
        worst = max(worst, max_err(tuple(sk), tuple(sr)), max_err(bk, br))
        assert_states_equal(sk, sr, f"{what} seg {seg}")
        require(torch.equal(bk, br), f"{what} seg {seg}: scoreboard differs")
        if rebalance:
            bud = ed._rebalance_budgets(start, bud, sk.steps, bk)
    return worst


def drive_lane(ctx, cfg, s, *, spc, segments, what):
    """Single-lane kernel and plain segment in lockstep."""
    import torch
    from repro_torch.core import engine_dense as ed
    from repro_torch.kernels.resident_step.ops import resident_segment
    from repro_torch.kernels.resident_step.ref import resident_segment_ref
    start = s.steps.clone()
    budget = 1 << 30
    sk = sr = s
    worst = 0
    for seg in range(segments):
        if not bool(ed._active(sk, start, budget)):
            break
        sk = resident_segment(ctx, cfg, sk, start=start, budget=budget,
                              steps_per_call=spc)
        sr = resident_segment_ref(ctx, cfg, sr, start=start, budget=budget,
                                  steps_per_call=spc)
        torch.cuda.synchronize()
        worst = max(worst, max_err(tuple(sk), tuple(sr)))
        assert_states_equal(sk, sr, f"{what} seg {seg}")
    return worst


def check_resident(dev):
    """K3 and K2 against their plain versions on real pools; returns
    (pool configurations checked, largest |err| of K3, of K2) over every
    leaf and scoreboard entry compared."""
    from repro_torch.core import engine_dense as ed
    from repro_torch.kernels.resident_step.ops import resident_stage_adj
    from repro_torch.data.generators import (dataset_suite,
                                             random_graph_stream)
    from repro_torch.serving.buckets import BucketPolicy, plan_bucket
    bench = dataset_suite("bench")
    stream = random_graph_stream(32, seed=0)
    by_bucket: dict = {}
    for g in stream:
        by_bucket.setdefault(plan_bucket(g.canonical(), BucketPolicy()),
                             []).append(g)
    stream_pool = max(by_bucket.values(), key=len)[:8]
    pools = [("512x2048 dblp+youtube", [bench["dblp-like"],
                                        bench["youtube-like"]]),
             (f"stream pool x{len(stream_pool)}", stream_pool),
             ("1024x4096 dblp-large", [dataset_suite("large")["dblp-large"]])]
    checked = err_pool = err_step = 0
    for name, graphs in pools:
        for mode in ("deg", "deg_nocache", "input"):
            cfg, ctx, s0 = bucket_pool(graphs, dev, order_mode=mode,
                                       collect_cap=4)
            # a mid-run start: 300 kernel steps in, so deep levels,
            # backtracks and collect writes are on the compared path
            warm = ed.run_batch(ctx, cfg, s0, max_steps=300,
                                ctx_batched=True, unroll=16)
            for spc in (1, 16):
                for rebalance in (False, True):
                    segs = 12 if spc == 16 else 24
                    budget = 8 * spc if rebalance else 1 << 30
                    err_pool = max(err_pool, drive_pool(
                        ctx, dataclasses.replace(
                            cfg, resident_rebalance=rebalance), warm,
                        spc=spc, budget=budget, rebalance=rebalance,
                        segments=segs,
                        what=f"resident_pool {name} {mode} spc={spc} "
                             f"rebalance={rebalance}"))
                    checked += 1
                for i in range(len(graphs)):
                    lane = ed._lane(warm, i)
                    err_step = max(err_step, drive_lane(
                        ed._lane(ctx, i), cfg, lane, spc=spc, segments=8,
                        what=f"resident_step {name} lane {i} {mode} "
                             f"spc={spc}"))
        log(f"  resident_pool / resident_step: {name} bit-exact, "
            f"adjacency in shared memory: {resident_stage_adj(cfg)}")
    return checked, err_pool, err_step


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def oracle(g):
    from repro_torch.baselines.mbea import enumerate_mbea, pair_checksum_sum
    gc = g.canonical()
    bic = enumerate_mbea(gc)
    return len(bic), pair_checksum_sum(bic, gc.n_u, gc.n_v)


def key(g):
    """Oracle table key: the bench and test suites reuse graph names."""
    return g.name, g.n_u, g.n_v


def check_results(results, graphs, truth, what):
    for g, r in zip(graphs, results):
        n_max, cs = truth[key(g)]
        require(r.status == "done", f"{what}: {g.name} status {r.status}")
        require((r.n_max, r.cs) == (n_max, cs),
                f"{what}: {g.name} n_max/cs {(r.n_max, r.cs)} != oracle "
                f"{(n_max, cs)}")


def reset_counters():
    from repro_torch.kernels.fused_check.ops import fused_check_packed
    from repro_torch.kernels.resident_pool.ops import resident_pool_segment
    from repro_torch.kernels.resident_step.ops import resident_segment
    for f in (fused_check_packed, resident_pool_segment, resident_segment):
        f.launches = 0


def counters():
    from repro_torch.kernels.fused_check.ops import fused_check_packed
    from repro_torch.kernels.resident_pool.ops import resident_pool_segment
    from repro_torch.kernels.resident_step.ops import resident_segment
    return dict(fused_check=fused_check_packed.launches,
                resident_pool=resident_pool_segment.launches,
                resident_step=resident_segment.launches)


def main_path(dev):
    """Drive every path of the slice; returns {path label: launch counts},
    each read right after its own drive with the counts set to 0 just
    before it."""
    import torch
    from repro_torch import MBEClient, MBEOptions
    from repro_torch.core import engine_dense as ed
    from repro_torch.data.generators import (dataset_suite,
                                             random_graph_stream)
    stream = random_graph_stream(32, seed=0)
    bench = dataset_suite("bench")
    suite = dict(bench)
    suite["dblp-large"] = dataset_suite("large")["dblp-large"]
    t0 = time.perf_counter()
    truth = {key(g): oracle(g) for g in [*stream, *suite.values()]}
    log(f"  oracle (NumPy serial MBEA, host CPU): "
        f"{time.perf_counter() - t0:.1f} s for {len(truth)} graphs")
    by_path = {}
    per_graph = []

    def drive(label, opts, graphs, one_by_one=False):
        reset_counters()
        client = MBEClient(opts)
        t = time.perf_counter()
        if one_by_one:
            res = []
            for g in graphs:
                t1 = time.perf_counter()
                r = client.enumerate(g)
                wall = time.perf_counter() - t1
                per_graph.append(dict(graph=g.name, path=label,
                                      steps=r.steps, wall_s=wall,
                                      steps_per_s=r.steps / wall))
                res.append(r)
        else:
            res = client.enumerate_many(graphs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        by_path[label] = c = counters()
        check_results(res, graphs, truth, label)
        st = client.stats()
        log(f"  {label}: {len(graphs)} graphs, all n_max/cs = oracle, "
            f"{wall:.2f} s, launches {c}, scheduler launches "
            f"{st['launches']}, misses {st['misses']}")
        return c

    def drive_per_step(label, graphs, unroll):
        """``resident=False``: the per-step torch-op engine with the
        ``fused_check`` kernel, one lane through ``run`` or a real pool
        (per-lane adjacency, ``ctx_batched``) through ``run_batch``."""
        reset_counters()
        t = time.perf_counter()
        if len(graphs) == 1:
            g = graphs[0]
            s = ed.enumerate_dense(g.canonical(), device=str(dev),
                                   resident=False)
            finals = [s]
        else:
            cfg, ctx, s0 = bucket_pool(graphs, dev, resident=False)
            s = ed.run_batch(ctx, cfg, s0, ctx_batched=True, unroll=unroll)
            finals = [ed._lane(s, i) for i in range(len(graphs))]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        by_path[label] = c = counters()
        for g, f in zip(graphs, finals):
            require(bool(ed._done(f)), f"{label}: {g.name} not done")
            got = (int(f.n_max), int(f.cs) % (1 << 32))
            require(got == truth[key(g)], f"{label}: {g.name} n_max/cs "
                                          f"{got} != oracle {truth[key(g)]}")
        steps = max(int(f.steps) for f in finals)
        per_graph.append(dict(graph="+".join(g.name for g in graphs),
                              path=label, steps=steps, wall_s=wall,
                              steps_per_s=steps / wall))
        log(f"  {label}: = oracle, {wall:.2f} s, launches {c}")
        require(c["fused_check"] > 0, f"fused_check not launched: {label}")

    c = drive("default stream", MBEOptions(), stream)
    require(c["resident_pool"] > 0, "resident_pool not launched on the "
                                    "default stream path")
    drive("default dblp-like", MBEOptions(), [bench["dblp-like"]],
          one_by_one=True)
    c = drive("bench+dblp-large spc=16", MBEOptions(steps_per_call=16),
              list(suite.values()), one_by_one=True)
    require(c["resident_pool"] > 0, "resident_pool not launched (spc=16)")
    c = drive("resident_lanes=0 stream", MBEOptions(resident_lanes=0),
              stream)
    require(c["resident_step"] > 0, "resident_step not launched with "
                                    "resident_lanes=0")
    drive_per_step("resident=False run unicode-like", [bench["unicode-like"]],
                   unroll=1)
    drive_per_step("resident=False run_batch 128x256 unicode+ucforum",
                   [bench["unicode-like"], bench["ucforum-like"]], unroll=16)
    drive_per_step("resident=False run_batch 512x2048 dblp+corp",
                   [bench["dblp-like"], bench["corp-leadership"]], unroll=16)
    for row in per_graph:
        log("  per-graph " + json.dumps(row))
    return by_path


# each kernel's own path: the drive whose count is the record's `launches`
KERNEL_PATH = {
    "fused_check": "resident=False run_batch 128x256 unicode+ucforum",
    "resident_pool": "default stream",
    "resident_step": "resident_lanes=0 stream",
}


# ---------------------------------------------------------------------------
# phase 5: times
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps=20):
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def profile_window(fn):
    """Run ``fn`` under ``torch.profiler``; returns (wall_s, device busy
    s, {kernel name: (device s, count)}) — device time summed over every
    kernel the window launched (None when the profiler saw no device
    time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = {}
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0)
        if dev and e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.key] = (dev / 1e6, e.count)
    busy = sum(v[0] for v in by_kernel.values())
    return wall, (busy if by_kernel else None), by_kernel


def device_ms(fn, name_part, reps=20):
    """Device time of one launch of the kernel whose name contains
    ``name_part`` (profiler), or None when the profiler saw none."""
    fn()
    _, _, by_kernel = profile_window(lambda: [fn() for _ in range(reps)])
    hits = [v for k, v in by_kernel.items() if name_part in k]
    if not hits:
        return None
    return sum(v[0] for v in hits) / sum(v[1] for v in hits) * 1e3


def bound(bytes_, ops):
    tb = bytes_ / H100_BYTES_PER_S * 1e3
    to = ops / H100_INT_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def k1_lane_inputs(lanes, n, w, seed, dev):
    """K1 operands of a ``lanes``-wide pool with per-lane adjacency (the
    per-step ``run_batch`` path's shape)."""
    import torch
    parts = [k1_inputs(n, w, seed + i, dev) for i in range(lanes)]
    return tuple(torch.stack(xs) for xs in zip(*parts))


def record(name, by_path, errs, **fields):
    """One entry of the ``kernels`` line: ``launches`` is the count of
    the kernel's own path (``KERNEL_PATH``), ``launches_by_path`` every
    drive that launched it."""
    rec = dict(name=name, route="cuda",
               launches=by_path[KERNEL_PATH[name]][name],
               max_abs_err=errs[name], **fields)
    rec["path"] = KERNEL_PATH[name]
    rec["launches_by_path"] = {k: c[name] for k, c in by_path.items()
                               if c[name]}
    return rec


def times(dev, by_path, errs):
    import torch
    from repro_torch.core import engine_dense as ed
    from repro_torch.data.generators import dataset_suite
    from repro_torch.kernels.fused_check.ops import fused_check_packed
    from repro_torch.kernels.fused_check.ref import fused_check_packed_ref
    from repro_torch.kernels.resident_pool.ops import packed_pool_segment
    from repro_torch.kernels.resident_pool.ref import (
        resident_pool_segment_ref)
    from repro_torch.kernels.resident_step.ops import (pack, packed_segment,
                                                       resident_state_bytes)
    from repro_torch.kernels.resident_step.ref import resident_segment_ref
    out = []
    # K1 at its path's shapes: 2-lane pools with per-lane adjacency and
    # counts on (order_mode 'deg'), buckets 128 x 256 (the record) and
    # 512 x 2048 (logged)
    for lanes, n, w in ((2, 128, 8), (2, 512, 64)):
        args = k1_lane_inputs(lanes, n, w, 7, dev)

        def k1():
            return fused_check_packed(*args, impl="pallas", with_counts=True)
        ms = cuda_ms(k1)
        plain = cuda_ms(lambda: fused_check_packed_ref(*args,
                                                       with_counts=True))
        dms = device_ms(k1, "fused_check_kernel")
        nw = n // 32
        # read adj, mask, n_mask, q, p; write viol, full/part/nz, counts
        b, kind = bound(4 * lanes * (n * w + w + 1 + 2 * nw
                                     + 1 + 3 * nw + n), 2 * lanes * n * w)
        shape = f"lanes={lanes} N={n} W={w} per-lane adj, with_counts"
        if n == 128:
            out.append(record(
                "fused_check", by_path, errs,
                source="src/repro_torch/csrc/fused_check.cu",
                replaces="src/repro/kernels/fused_check/kernel.py:81",
                ms=ms, plain_ms=plain, bound_ms=b, bound_by=kind,
                library_ms=None, device_ms=dms, shape=shape))
        else:
            log(f"  fused_check at {shape}: {ms:.4f} ms/call (device "
                f"{dms} ms), plain {plain:.4f} ms, bound {b:.6f} ms "
                f"({kind})")
    # K3 / K2 at the default path's dblp-like pool: bucket 512 x 2048,
    # one lane, steps_per_call = 1, from a mid-run state
    g = dataset_suite("bench")["dblp-like"]
    cfg, ctx, s0 = bucket_pool([g], dev)
    warm = ed.run_batch(ctx, cfg, s0, max_steps=2000, ctx_batched=True)
    for spc in (1, 16):
        p = pack(warm, warm.steps, 1 << 30)

        def k3():
            return packed_pool_segment(ctx, cfg, warm, p, spc,
                                       ctx_batched=True)
        ms = cuda_ms(k3)
        plain = cuda_ms(lambda: resident_pool_segment_ref(
            ctx, cfg, warm, start=warm.steps, budget=1 << 30,
            steps_per_call=spc, ctx_batched=True), reps=5)
        dms = device_ms(k3, "resident_pool_kernel")
        _, board = k3()
        adv = int((spc - board[:, 1]).sum())
        b, kind = bound(resident_state_bytes(cfg, cfg.n_u, lanes=1),
                        adv * 2 * cfg.n_u * cfg.wv)
        if spc == 1:
            out.append(record(
                "resident_pool", by_path, errs,
                source="src/repro_torch/csrc/resident_pool.cu",
                replaces="src/repro/kernels/resident_pool/kernel.py:50",
                ms=ms, plain_ms=plain, bound_ms=b, bound_by=kind,
                library_ms=None, device_ms=dms,
                shape="bucket 512x2048, 1 lane, steps_per_call=1"))
        else:
            log(f"  resident_pool at spc=16 (512x2048, 1 lane): {ms:.4f} "
                f"ms/launch (device {dms} ms), plain {plain:.3f} ms, "
                f"bound {b:.5f} ms ({kind})")
        lane = ed._lane(warm, 0)
        lctx = ed._lane(ctx, 0)
        pl = pack(lane, lane.steps, 1 << 30)

        def k2():
            return packed_segment(lctx, cfg, lane, pl, spc)
        ms2 = cuda_ms(k2)
        plain2 = cuda_ms(lambda: resident_segment_ref(
            lctx, cfg, lane, start=lane.steps, budget=1 << 30,
            steps_per_call=spc), reps=5)
        dms2 = device_ms(k2, "resident_step_kernel")
        if spc == 1:
            out.append(record(
                "resident_step", by_path, errs,
                source="src/repro_torch/csrc/resident_step.cu",
                replaces="src/repro/kernels/resident_step/kernel.py:115",
                ms=ms2, plain_ms=plain2, bound_ms=b, bound_by=kind,
                library_ms=None, device_ms=dms2,
                shape="bucket 512x2048, steps_per_call=1"))
        else:
            log(f"  resident_step at spc=16: {ms2:.4f} ms/launch (device "
                f"{dms2} ms), plain {plain2:.3f} ms")
    # the device's busy share over two main-path windows
    from repro_torch import MBEClient, MBEOptions
    bench = dataset_suite("bench")
    for label, opts, g in (
            ("default, unicode-like", MBEOptions(), bench["unicode-like"]),
            ("steps_per_call=16, ucforum-like",
             MBEOptions(steps_per_call=16), bench["ucforum-like"])):
        client = MBEClient(opts)
        client.enumerate(g)             # warm the cache entry
        wall, busy, by_kernel = profile_window(lambda: client.enumerate(g))
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:4]
        share = None if busy is None else busy / wall
        log(f"  profile {label}: wall {wall:.4f} s, device busy "
            f"{busy} s, busy share {share}; top kernels " + json.dumps(
                [(k[:60], round(v[0], 6), v[1]) for k, v in top]))
    return out


# ---------------------------------------------------------------------------

def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke.py: src/repro_torch not found next to the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    assert "jax" not in sys.modules
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind}, torch {torch.__version__}, cuda "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout else ""
    require(smi_line, f"nvidia-smi failed: {smi.stderr}")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.library()
    log(f"[build] {time.perf_counter() - t0:.1f} s (nvcc "
        f"{_build.build_seconds if _build.build_seconds else 0:.1f} s)")
    for line in _build.ptxas_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("  ptxas " + line.strip())
    t0 = time.perf_counter()
    errs = dict(fused_check=check_fused_check(dev, seed=0))
    n, errs["resident_pool"], errs["resident_step"] = check_resident(dev)
    log(f"[kernels] {n} pool configurations + lanes bit-exact, max |err| "
        f"{errs}, {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path = main_path(dev)
    log(f"[main] {time.perf_counter() - t0:.1f} s, launches by path "
        f"{json.dumps(by_path)}")
    rec = times(dev, by_path, errs)
    log(smi_line)
    log(json.dumps({"kernels": rec}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
