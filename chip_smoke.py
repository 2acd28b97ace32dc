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
              fused_check packed at (512, 64) and (1024, 128) with and
              without counts; resident_pool and resident_step on real
              pools (bucket 512 x 2048 with two graphs, an 8-lane stream
              pool, and the 1024 x 4096 bucket whose adjacency runs on a
              cluster of 4 CTAs) in every order mode, steps_per_call 1
              and 16, rebalance off and on, at every segment boundary,
              through the functional entries and the run loop's in-place
              entry; resident_pool with ONE adjacency shared by every
              lane (the big lane's workers: dblp-like's 512 x 2048 at 4
              and 32 workers, dblp-large's 1024 x 4096 cluster at 4),
              steps_per_call 1 and 16, from a state re-dealt by a steal
              barrier, with a planted task-cursor fault it must flag;
              intersect_count (plain and through idx), every fused_select
              kind and the dense/prefix2 fused_check kinds (plain and
              gathered, counts on/off) at (128, 8), (512, 64), (1024, 128)
              and (100, 5), shared and per-lane adjacency, 1 and 8 lanes,
              random rows, all rows tied, nothing active (p = 0) and
              |L'| = 0; every K1 and K4 kind at the row tiles' edges
              (ties at the minimum across tiles, p = 0 / 1 / n, one
              active bit in the last ragged word, one row in the last
              tile, negative and out-of-range idx, |L'| = 0, and 26,000
              x 813 words past the residency gate), back-to-back calls
              whose flags and argmins alternate (the scratch reset), two
              streams at once, one device kernel per wrapper call
              (profiler), and a scratch slot left set before a call (a
              planted fault the check must flag); intersect_count (K5)
              on the row tiles at n 1 .. 1024 across the tile edges, w
              1, 5 and 64, no lane dim and 1 to 3 lanes with shared and
              per-lane adjacency, through idx with negative and
              out-of-range entries, unaligned operands, 2 x 26,000 x
              813 words, one device kernel a call (profiler), and a
              flipped adjacency bit (one row's count off by one) the
              check must flag; flash_fwd (K7) against its plain version at the
              qwen3-1.7b prefill layer shapes (1, 4096), (4, 4096) and
              (1, 32768) (its first and last 512 query rows), bf16 and
              fp32, causal, ragged (S = 1000 and 4097) and non-causal,
              hd 64 with G = 3, element-wise and per query row
              (tolerances at K7_TOL, K7_ROW_RTOL), fp32 also at the grad
              path's (2, 4096), hd 32 and hd 16, zamba2-7b's hd 112
              ((1, 4096) bf16, (2, 1000) bf16 and fp32, 32 heads), every
              case run twice with bit-identical o and lse, and two
              planted faults in bf16 and two in fp32 (at hd 128 and again
              at hd 112) the check must flag; the K7 backward
              (bf16: the fused dq / dk / dv kernel; fp32: K7 dq and dkv)
              against ``flash_bwd_ref`` at the training layer shapes
              (1, 4096) and (2, 4096), bf16 and fp32, causal, ragged
              (S = 1000 and 4097), non-causal and hd 64 with G = 3, and
              zamba2-7b's hd 112 ((2, 4096) bf16 and (1, 4096) fp32, 32
              heads), per output row and scaled (K7B_ROW_RTOL,
              K7B_SCALED_TOL); at hd 112 also no write past the outputs
              (buffers with a sentinel tail); the fused kernel's dk / dv
              bit-identical across two runs and dq within
              K7B_DQ_RERUN_RTOL (its atomics), the fp32 kernels' dq, dk,
              dv bit-identical; three planted faults on the fused kernel
              (lse offset past row 512, dD zeroed, a non-zero dq
              accumulator) and the lse offset on the fp32 kernels, at hd
              128 and again at hd 112, which the check must flag; the
              fp32 plain version, kernels and 3xTF32 emulation against
              the plain version in float64 (logged);
4. main     — the port's main paths against the oracle, each drive with
              the launch counters set to 0 just before it and read just
              after: ``MBEClient`` at default options (a 32-graph stream
              and dblp-like), the bench suite plus dblp-large at
              steps_per_call=16, resident_lanes=0 (single-lane kernel),
              resident=False (per-step fused_check: unicode-like through
              ``run``, 2-lane pools through ``run_batch`` at 64 x 256 and
              512 x 2048); the compact engine (the stream; unicode-like
              and dblp-like at steps_per_call=16; the stream unfused with
              impl='pallas'); the dense deg_nocache path with residency
              off (fused_select packed; unicode-like, and the 2-lane
              64 x 256 pool) and the dense unfused path with
              impl='pallas' (intersect_count); every n_max and cs against
              the oracle, every kernel's launch count > 0 on its path;
              the work-stealing big lane (``big_graph_threshold=1``: K3
              on one shared adjacency) on dblp-like and dblp-large at 4
              workers and at the most the pool gate admits, each with
              and without stealing (same totals), busy steps per worker
              and imbalance logged; the compact engine through the big
              lane; the mce engine (``random_unipartite`` streams fused,
              K4 packed, and unfused with impl='pallas', K5; one graph
              through the big lane) against the Bron–Kerbosch oracle;
              the count engine at (2, 2) and (2, 3), served and through
              the big lane, against the brute-force count;
              ``launch/mbe_run.py`` at the bench default (marvel-like,
              4 workers); the mesh (``mesh_path``: every visible card,
              or on one card a rehearsal mesh naming it 4 times): the
              32-graph stream through ``ShardedExecutor`` (dense K3 a
              shard, ``resident_lanes=0`` K2, compact on its 13 graphs
              of buckets up to 16 x 32), the big lane on dblp-like and dblp-large at 1 and
              4 workers a device with and without stealing (totals and
              busy steps per worker equal to the local big lane's at
              the same count), ``mbe_run`` marvel-like on the mesh, busy
              steps per device (every device's workers advanced) and,
              on two or more cards, K3 on every card in one profiler
              window, two cards at once at steps_per_call=16; the
              serving layer under SLO and faults:
              ``serve --mbe`` (defaults with --continuous, K3; --engine
              mce, K4 packed) against the oracles, a chaos stream (24
              graphs in lane pools, dblp-like on the big lane) under
              retries, corrupted done-mask reads, a device loss with
              failover and checkpoint resume and a poisoned install,
              held against the fault-free run of the same stream (every
              payload but the poisoned one's, one failover, the new
              pools and K3 on the card, the same injector log twice),
              the retry-off and retry-on walls in turns, a traced stream
              under backpressure and shed-on-deadline with the cost
              model calibrated from its trace, and two planted faults
              (a flipped snapshot bit, a failover onto the CPU) that the
              checks must flag;
              then the LM paths of qwen3-1.7b at full width (random
              weights from seed 0): ``make_prefill_step`` with
              attn_impl='pallas' at (1, 32768) and (4, 4096), exactly one
              K7 launch per layer, logits against attn_impl='xla' at
              the last position and at every position, every K7 call of
              the checked forward against its plain version, and a
              planted K7 fault that both checks must flag;
              decode == prefill in fp32; the LM ``serve`` loop; then
              the other model families at full width, each model freed
              before the next (granite-moe-1b-a400m, internvl2-2b with
              its 256 patch rows, musicgen-medium, zamba2-7b, xlstm-1.3b):
              ``make_prefill_step`` at (1, 4096) with attn_impl='pallas'
              (exactly 24 / 24 / 48 / 13 / 0 K7 launches), logits against
              'xla' at every position with every K7 call held against its
              plain version and a planted K7 fault flagged, decode ==
              prefill in fp32 (but vlm), and ``serve`` (4 slots, 4
              requests); then the training paths of qwen3-1.7b at full
              width: the train step's fp32 grads (remat on, microbatch
              (2, 4096) from the port's SyntheticSource) with
              attn_impl='pallas' against 'xla' per parameter, in bf16 at 28
              layers (with a planted K7 bwd fault that must be flagged) and in
              fp32 at 2 layers (TRAIN_GRAD_RTOL); 3 AdamW steps with accum=2 on
              (4, 4096)
              (per step 112 K7 fwd, 56 fused bwd; finite loss and grad
              norm; params moved; peak memory) and a profiled step; the
              launcher ``repro_torch.launch.train`` at the smoke config
              with an injected failure, resumed at its checkpointed data
              step; then the other families' training at full width
              (``families_train_path``; granite-moe-1b-a400m,
              internvl2-2b, musicgen-medium, zamba2-7b at 24 of its 81
              layers, xlstm-1.3b at (2, 1024)), one model at a time: the
              train step's grads on a (2, 4096) microbatch from the
              SyntheticSource (codebooks, patch rows) with
              attn_impl='pallas' against 'xla' (24 / 24 / 48 / 4 / 0 K7
              calls a forward, each launched twice and one fused backward;
              the limit the larger of TRAIN_GRAD_RTOL and twice the
              torch-op path's floor at half its key tile; a planted K7 bwd
              fault flagged), zamba2-7b's fp32 grads at 6 layers through
              K7 dq / dkv at hd 112 (the same floor rule), 2 AdamW steps
              with accum=2 (finite, params moved, peak memory), and the
              launcher with a restart on zamba2-7b's smoke config;
5. times    — per-kernel CUDA-event, profiler and queued times at each
              kernel's own path's shapes beside the plain version and the
              bound (K1 / K4 also under a sweep of launch plans, and past
              the residency gate)
              (K2 / K3 in place, every rep on its own copy of the state,
              at steps_per_call 1 and 16, per step, at 128 / 256 / 512
              threads, and dblp-large's 1024 x 4096 cluster)
              (and for K7, at hd 128 and at hd 112, the time of
              ``F.scaled_dot_product_attention`` on the same operands,
              and for the K7 backward SDPA's backward; the fp32 K7
              forward, dq and dkv at (2, 4096) beside SDPA's fp32 forward and
              backward and the kernels SDPA ran for them, the forward's shares
              of its FP32 and 3xTF32 bounds; the K7 backward at hd 112, the
              fused kernel at (2, 4096, 32, 32) and fp32 dq / dkv at (1,
              4096, 32, 32), beside SDPA's backward; K5 with its queued
              device time),
              and the device's busy share over main-path windows.

Every phase runs on every call; the script takes no arguments.  The line
before the last is the ``{"kernels": [...]}`` record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
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
H100_BF16_FLOPS = 989e12        # dense bf16 tensor-core peak (data sheet)
H100_FP32_FLOPS = 67e12         # FP32 CUDA-core (non-tensor) peak, the
#                                 fp32 K7 fwd / dq / dkv's rate
H100_TF32_FLOPS = 494.7e12      # dense TF32 tensor-core peak (data sheet):
#                                 fp32 products as 3xTF32, beside it


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
    # per-lane adjacency, two lanes, at the per-step pools' buckets
    # (64 x 256, 128 x 256 and 512 x 2048)
    for n, w in ((64, 8), (128, 8), (512, 64)):
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


def bucket_pool(graphs, dev, engine="dense", **cfg_kw):
    """(cfg, stacked ctx, stacked fresh state) of one bucket's pool."""
    from repro_torch.core.engine import get_engine
    from repro_torch.serving.buckets import BucketPolicy, plan_bucket
    from repro_torch.serving.executor import _stack
    eng = get_engine(engine)
    specs = {plan_bucket(g.canonical(), BucketPolicy()) for g in graphs}
    spec = max(specs, key=lambda b: (b.n_u, b.n_v))
    cfg = spec.engine_config(**cfg_kw)
    ctxs = [eng.make_context(g.canonical(), cfg, dev) for g in graphs]
    sts = [eng.fresh_lane_state(cfg, g.canonical().n_u, dev)
           for g in graphs]
    return cfg, _stack(ctxs), _stack(sts)


def drive_pool(ctx, cfg, s, *, spc, budget, rebalance, segments, what,
               ctx_batched=True):
    """The pool kernel through its functional entry and through the run
    loop's in-place entry (``pool_run`` on a private copy, budgets
    rebalanced in place as ``_run_batch_pool`` does), and the plain pool
    segment, in lockstep from state ``s``; every leaf and the scoreboard
    equal at every boundary.  ``ctx_batched=False``: one adjacency shared
    by every lane (the big lane's workers).  Returns (largest |err|
    functional, in place)."""
    import torch
    from repro_torch.core import engine_dense as ed
    from repro_torch.kernels.resident_pool.ops import (pool_run,
                                                       resident_pool_segment)
    from repro_torch.kernels.resident_pool.ref import (
        resident_pool_segment_ref)
    from repro_torch.kernels.resident_step.ops import (S_BUDGET, S_STEPS,
                                                       pack, unpack)
    start = s.steps.clone()
    bud = torch.full_like(start, budget)
    own = ed._owned(s)
    p = pack(own, start, bud)
    loop = pool_run(ctx, cfg, own, p, spc, ctx_batched=ctx_batched)
    sk = sr = s
    worst = worst_ip = 0
    for seg in range(segments):
        if not bool(ed._active(sk, start, bud).any()):
            break
        sk, bk = resident_pool_segment(ctx, cfg, sk, start=start,
                                       budget=bud, steps_per_call=spc,
                                       ctx_batched=ctx_batched)
        bi = loop.launch()
        sr, br = resident_pool_segment_ref(ctx, cfg, sr, start=start,
                                           budget=bud, steps_per_call=spc,
                                           ctx_batched=ctx_batched)
        torch.cuda.synchronize()
        si = unpack(own, p)
        worst = max(worst, max_err(tuple(sk), tuple(sr)), max_err(bk, br))
        worst_ip = max(worst_ip, max_err(tuple(si), tuple(sr)),
                       max_err(bi, br))
        assert_states_equal(sk, sr, f"{what} seg {seg}")
        assert_states_equal(si, sr, f"{what} in place seg {seg}")
        require(torch.equal(bk, br), f"{what} seg {seg}: scoreboard differs")
        require(torch.equal(bi, br),
                f"{what} in place seg {seg}: scoreboard differs")
        if rebalance:
            bud = ed._rebalance_budgets(start, bud, sk.steps, bk)
            p.scal[:, S_BUDGET] = ed._rebalance_budgets(
                start, p.scal[:, S_BUDGET], p.scal[:, S_STEPS], bi)
    return worst, worst_ip


def drive_lane(ctx, cfg, s, *, spc, segments, what):
    """Single-lane kernel (functional and in place) and plain segment in
    lockstep; returns (largest |err| functional, in place)."""
    import torch
    from repro_torch.core import engine_dense as ed
    from repro_torch.kernels.resident_step.ops import (lane_run, pack,
                                                       resident_segment,
                                                       unpack)
    from repro_torch.kernels.resident_step.ref import resident_segment_ref
    start = s.steps.clone()
    budget = 1 << 30
    own = ed._owned(s)
    p = pack(own, start, budget)
    loop = lane_run(ctx, cfg, own, p, spc)
    sk = sr = s
    worst = worst_ip = 0
    for seg in range(segments):
        if not bool(ed._active(sk, start, budget)):
            break
        sk = resident_segment(ctx, cfg, sk, start=start, budget=budget,
                              steps_per_call=spc)
        loop.launch()
        sr = resident_segment_ref(ctx, cfg, sr, start=start, budget=budget,
                                  steps_per_call=spc)
        torch.cuda.synchronize()
        si = unpack(own, p)
        worst = max(worst, max_err(tuple(sk), tuple(sr)))
        worst_ip = max(worst_ip, max_err(tuple(si), tuple(sr)))
        assert_states_equal(sk, sr, f"{what} seg {seg}")
        assert_states_equal(si, sr, f"{what} in place seg {seg}")
    return worst, worst_ip


def check_resident(dev):
    """K3 and K2 against their plain versions on real pools, through the
    functional and the in-place entries; the 1024 x 4096 pool runs on a
    cluster of CTAs.  Returns (pool configurations checked, largest |err|
    of K3, of K2) over every leaf and scoreboard entry compared."""
    from repro_torch.core import engine_dense as ed
    from repro_torch.kernels.resident_step.ops import (lane_threads,
                                                       resident_cluster,
                                                       resident_stage_adj)
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
                    err_pool = max(err_pool, *drive_pool(
                        ctx, dataclasses.replace(
                            cfg, resident_rebalance=rebalance), warm,
                        spc=spc, budget=budget, rebalance=rebalance,
                        segments=segs,
                        what=f"resident_pool {name} {mode} spc={spc} "
                             f"rebalance={rebalance}"))
                    checked += 1
                for i in range(len(graphs)):
                    lane = ed._lane(warm, i)
                    err_step = max(err_step, *drive_lane(
                        ed._lane(ctx, i), cfg, lane, spc=spc, segments=8,
                        what=f"resident_step {name} lane {i} {mode} "
                             f"spc={spc}"))
        log(f"  resident_pool / resident_step: {name} bit-exact "
            f"(functional and in place), adjacency in one CTA's shared "
            f"memory: {resident_stage_adj(cfg)}, CTAs per lane "
            f"{resident_cluster(cfg)}, {lane_threads(cfg)} threads")
    return checked, err_pool, err_step


def stolen(s):
    """``s`` after one work-stealing barrier: the pending root tasks of
    every worker flattened and re-dealt round-robin
    (``core.distributed``), so the lanes that follow hold re-dealt
    queues."""
    from repro_torch.core import distributed as dd
    flat, total = dd._flatten_pending(s.tasks, s.tpos, s.n_tasks)
    tasks, n = dd._deal_strided(flat, total, s.tasks.shape[0],
                                s.tasks.shape[1])
    return s._replace(tasks=tasks, n_tasks=n, tpos=s.tpos * 0)


# the shared-adjacency K3 cases: (graph, suite, workers)
K3_SHARED = (("dblp-like", "bench", 4), ("dblp-like", "bench", 32),
             ("dblp-large", "large", 4))


def check_resident_shared(dev):
    """K3 with ONE adjacency shared by every lane (``ctx_batched=False``,
    the big lane's workers, strided root tasks in queues of capacity
    ``m_real``) against its plain version, through the functional and
    the in-place entries, at every segment boundary: 512 x 2048
    (dblp-like) at 4 and 32 workers and 1024 x 4096 (dblp-large, a
    cluster of 4 CTAs a lane) at 4, steps_per_call 1 and 16, from a
    mid-run state whose queues were re-dealt by a steal barrier.  Two
    planted faults must be flagged: one worker's task cursor bumped in
    the kernel's input only, and one bit of the shared adjacency flipped
    in the kernel's copy only (``plant_shared_adjacency_fault``).
    Returns (cases checked, largest |err|)."""
    import torch
    from repro_torch.core import distributed as dd
    from repro_torch.core import engine_dense as ed
    from repro_torch.core.engine import DENSE
    from repro_torch.data.generators import dataset_suite
    from repro_torch.kernels.resident_pool.ops import resident_pool_segment
    from repro_torch.kernels.resident_pool.ref import (
        resident_pool_segment_ref)
    from repro_torch.kernels.resident_step.ops import resident_cluster
    from repro_torch.serving.buckets import BucketPolicy, plan_bucket
    checked = worst = 0
    for name, suite, workers in K3_SHARED:
        g = dataset_suite(suite)[name]
        cfg = plan_bucket(g.canonical(), BucketPolicy()).engine_config(
            collect_cap=4, kernel_impl="pallas")
        ctx = ed.make_context(g.canonical(), cfg, dev)
        s0 = dd.strided_states(DENSE, cfg, g.n_u, workers, dev)
        require(ed.pool_lanes(cfg, workers, dev) == workers,
                f"K3 shared {name} x{workers}: the pool gate refused")
        # 150 steps a worker, then a steal barrier
        warm = stolen(ed.run_batch(ctx, cfg, s0, max_steps=150,
                                   ctx_batched=False, unroll=16))
        for spc in (1, 16):
            worst = max(worst, *drive_pool(
                ctx, cfg, warm, spc=spc, budget=1 << 30, rebalance=False,
                segments=12 if spc == 16 else 24, ctx_batched=False,
                what=f"resident_pool shared {name} x{workers} spc={spc}"))
            checked += 1
        # planted fault: a worker whose queue still holds a task skips it
        # in the kernel's input only
        w = int((warm.n_tasks - warm.tpos).argmax())
        require(int(warm.n_tasks[w] - warm.tpos[w]) > 0,
                f"K3 shared {name}: no pending task to plant a fault on")
        bad = warm._replace(tpos=warm.tpos.clone())
        bad.tpos[w] += 1
        start = warm.steps.clone()
        bud = torch.full_like(start, 1 << 30)
        flagged = False
        sk, sr = bad, warm
        for seg in range(64):
            sk, _ = resident_pool_segment(ctx, cfg, sk, start=start,
                                          budget=bud, steps_per_call=16,
                                          ctx_batched=False)
            sr, _ = resident_pool_segment_ref(ctx, cfg, sr, start=start,
                                              budget=bud,
                                              steps_per_call=16,
                                              ctx_batched=False)
            try:
                assert_states_equal(sk, sr, "planted")
            except PhaseError:
                flagged = True
                break
        require(flagged, f"K3 shared {name} x{workers}: the planted task "
                         f"cursor fault was not flagged")
        adj_seg, row, bit = plant_shared_adjacency_fault(ctx, cfg, warm, g)
        log(f"  resident_pool shared adjacency: {name} "
            f"{cfg.n_u}x{cfg.n_v} x{workers} workers bit-exact "
            f"(functional and in place, spc 1 and 16, after a steal "
            f"barrier), CTAs per lane {resident_cluster(cfg)}; planted "
            f"cursor fault on worker {w} flagged at segment {seg}; "
            f"planted adjacency fault (row {row} bit {bit}; equal after "
            f"segment 0) flagged at segment {adj_seg}")
    return checked, worst


def plant_shared_adjacency_fault(ctx, cfg, warm, g, cap=64):
    """A fault whose effect must pass through K3's launches on the shared
    adjacency: the kernel reads a copy of the adjacency with one bit
    flipped in the root row that the first worker to start a new root
    task after the first segment reads next, the plain version reads the
    true adjacency, and both start from the same state.  A plain run
    ahead finds that row.  The states must agree after the first
    segment and be flagged at a later boundary; returns (segment, row,
    bit)."""
    import torch
    from repro_torch.kernels.resident_pool.ops import resident_pool_segment
    from repro_torch.kernels.resident_pool.ref import (
        resident_pool_segment_ref)
    start = warm.steps.clone()
    bud = torch.full_like(start, 1 << 30)

    def plain(s):
        return resident_pool_segment_ref(ctx, cfg, s, start=start,
                                         budget=bud, steps_per_call=16,
                                         ctx_batched=False)[0]
    s, row = warm, None
    for pop in range(cap):
        before = s.tpos.clone()
        s = plain(s)
        started = (s.tpos > before).nonzero()
        if pop > 0 and started.numel():
            w = int(started[0, 0])
            row = int(ctx.order[int(warm.tasks[w, int(before[w])])])
            break
    require(row is not None, f"K3 shared {cfg.n_u}x{cfg.n_v}: no worker "
                             f"started a root task in {cap} segments")
    bit = g.n_v // 2                # a real V vertex: inside l_root
    bad = ctx._replace(adj=ctx.adj.clone())
    bad.adj[row, bit // 32] ^= 1 << (bit % 32)
    sk = sr = warm
    for seg in range(pop + 4):
        sk, _ = resident_pool_segment(bad, cfg, sk, start=start, budget=bud,
                                      steps_per_call=16, ctx_batched=False)
        sr = plain(sr)
        try:
            assert_states_equal(sk, sr, "planted adjacency")
        except PhaseError:
            require(seg > 0, f"K3 shared {cfg.n_u}x{cfg.n_v}: kernel and "
                             f"plain differ after the first segment, "
                             f"before the planted row {row} is read")
            return seg, row, bit
    raise PhaseError(f"K3 shared {cfg.n_u}x{cfg.n_v}: the planted adjacency "
                     f"fault (row {row} bit {bit}) was not flagged within "
                     f"{pop + 4} segments")


def slice2_inputs(lanes, n, w, seed, dev, per_lane_adj, case):
    """Operands of the K4/K5/K1-kind checks: ``lanes`` lanes (1 = no lane
    dim), rows (n, w) shared or per lane, a permutation ``idx`` and the
    [Q ++ P] index of length 2n; ``case`` 'random', 'tied' (every row
    equal), 'none' (nothing active, p = 0, q_hi = p_hi = 0) or 'empty'
    (|L'| = 0)."""
    import numpy as np
    import torch
    from repro_torch.core import bitset
    rng = np.random.default_rng(seed)

    def words(*shape):
        return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64) \
            & rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)

    def t32(a):
        return bitset.from_u32(np.asarray(a).astype(np.uint32), dev)

    L = max(lanes, 1)
    adj = words(L if per_lane_adj else 1, n, w)
    mask = words(L, w)
    adj[:, ::7] |= mask[:, None, :] if per_lane_adj else mask[:1, None, :]
    adj[:, 3::11] = 0
    if case == "tied":
        adj[:] = adj[:, :1]
    if case == "empty":
        mask[:] = 0
    idx = np.stack([rng.permutation(n) for _ in range(L)]).astype(np.int32)
    idx2 = np.concatenate([idx[:, ::-1], idx], axis=1)
    act = (rng.random((L, n)) < 0.4).astype(np.int32)
    p = rng.integers(1, n + 1, size=L).astype(np.int32)
    q_hi = rng.integers(0, n + 1, size=L).astype(np.int32)
    if case == "none":
        act[:] = 0
        p[:] = 0
        q_hi[:] = 0
    out = dict(adj=t32(adj if per_lane_adj else adj[0]), mask=t32(mask),
               idx=torch.from_numpy(idx).to(dev),
               idx2=torch.from_numpy(idx2.copy()).to(dev),
               act=torch.from_numpy(act).to(dev),
               p=torch.from_numpy(p).to(dev),
               q_hi=torch.from_numpy(q_hi).to(dev))
    out["words"] = bitset.from_bool(out["act"] > 0)
    out["nlp"] = bitset.count(out["mask"])
    if lanes == 0:          # unbatched (shared adjacency): no lane dim
        require(not per_lane_adj, "an unbatched call has one adjacency")
        out = {k: (v if k == "adj" else v[0]) for k, v in out.items()}
    return out


def check_slice2_kernels(dev):
    """K5, every K4 kind and the dense/prefix2 K1 kinds, plain and
    gathered, against their plain versions on the card at (128, 8),
    (512, 64), (1024, 128) and a ragged (100, 5); shared and per-lane
    adjacency; unbatched, 1 and 8 lanes; random rows, all rows tied,
    nothing active (p = 0) and |L'| = 0.  Returns {entry point: largest
    |err| measured}."""
    from repro_torch.kernels import fused_check as fc
    from repro_torch.kernels import fused_select as fs
    from repro_torch.kernels.intersect_count.ops import intersect_count

    def calls(x):
        n = x["idx"].shape[-1]
        return {
            "intersect_count": (intersect_count, (x["adj"], x["mask"]), {}),
            "intersect_count idx": (intersect_count, (x["adj"], x["mask"]),
                                    dict(idx=x["idx"])),
            "fused_select": (fs.fused_select,
                             (x["adj"], x["mask"], x["act"]), {}),
            "fused_select_packed": (fs.fused_select_packed,
                                    (x["adj"], x["mask"], x["words"]), {}),
            "fused_select_prefix": (fs.fused_select_prefix,
                                    (x["adj"], x["mask"], x["p"]), {}),
            "fused_select_gathered": (
                fs.fused_select_gathered,
                (x["adj"], x["idx"], x["mask"], x["act"]), {}),
            "fused_select_gathered_prefix": (
                fs.fused_select_gathered_prefix,
                (x["adj"], x["idx"], x["mask"], x["p"]), {}),
            "fused_check": (fc.fused_check,
                            (x["adj"], x["mask"], x["nlp"], x["act"],
                             1 - x["act"]), {}),
            "fused_check_prefix2": (
                fc.fused_check_prefix2,
                (x["adj"], x["mask"], x["nlp"], x["q_hi"] // 2, x["p"]),
                dict(split=n // 2)),
            "fused_check_gathered": (
                fc.fused_check_gathered,
                (x["adj"], x["idx"], x["mask"], x["nlp"], x["act"],
                 1 - x["act"]), {}),
            "fused_check_gathered_prefix2": (
                fc.fused_check_gathered_prefix2,
                (x["adj"], x["idx2"], x["mask"], x["nlp"], x["q_hi"],
                 x["p"]), {}),
        }

    errs: dict = {}
    n_checks = 0
    for n, w in ((128, 8), (512, 64), (1024, 128), (100, 5)):
        for lanes, per_lane in ((0, False), (1, True), (8, False),
                                (8, True)):
            for case in ("random", "tied", "none", "empty"):
                x = slice2_inputs(lanes, n, w, n + 7 * w + lanes, dev,
                                  per_lane, case)
                for name, (fn, args, kw) in calls(x).items():
                    counts = (False, True) if name.startswith(
                        "fused_check") else (None,)
                    for wc in counts:
                        ckw = dict(kw) if wc is None else dict(
                            kw, with_counts=wc)
                        got = fn(*args, impl="pallas", **ckw)
                        want = fn(*args, impl="jnp", **ckw)
                        got = got if isinstance(got, tuple) else (got,)
                        want = want if isinstance(want, tuple) else (want,)
                        err = max_err(got, want)
                        require(err == 0 and all(
                            (a is None) == (b is None) and (a is None or (
                                a.shape == b.shape and a.dtype == b.dtype))
                            for a, b in zip(got, want)),
                            f"{name} ({n},{w}) lanes={lanes} per-lane adj="
                            f"{per_lane} {case} counts={wc}: differs "
                            f"(max |err| {err})")
                        key_ = name.split(" ")[0]
                        errs[key_] = max(errs.get(key_, 0), err)
                        n_checks += 1
    log(f"  K4/K5/K1 kinds: {n_checks} checks bit-exact, max |err| {errs}")
    return errs


# The row-tile kernels K1 and K4 at their tile edges (32-row tiles,
# dispatch.plan_rows): (n, w) of each case; "large" is past the residency
# gate (n_u ~ 25,700), with a ragged width (scalar loads, 4 chunks a row)
ROW_CASES = {"ties": (100, 5), "p0": (100, 5), "p1": (100, 5),
             "pn": (100, 5), "lastbit": (100, 5), "ragged33": (33, 8),
             "idx_range": (100, 5), "empty": (100, 5), "wide": (512, 64),
             "large": (26_000, 813)}
ROW_LANES = 2


def row_case_inputs(case, per_lane, seed, dev):
    """K1 / K4 operands of ``ROW_LANES`` lanes at a tile edge, made on the
    card from a seeded generator: ``ties`` (every row meets the mask but
    rows 40, 70 and 99, the minimum 0 first in tile 1 and equal in tiles
    2 and 3), ``p0`` / ``p1`` / ``pn`` (prefix bounds and activity 0, 1,
    n), ``lastbit`` (every activity word 0 but one bit in the last, ragged
    word), ``ragged33`` (one row in the last tile), ``idx_range``
    (negative and out-of-range idx), ``empty`` (|L'| = 0), ``wide`` and
    ``large`` (random)."""
    import torch
    from repro_torch.core import bitset
    n, w = ROW_CASES[case]
    L = ROW_LANES
    g = torch.Generator(device=dev).manual_seed(seed)

    def words(*shape):
        def one():
            return torch.randint(-(1 << 31), 1 << 31, shape, generator=g,
                                 device=dev, dtype=torch.int32)
        return one() & one()

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    adj = words(L if per_lane else 1, n, w)
    mask = words(L, w)
    adj[:, ::7] |= mask[:, None, :] if per_lane else mask[:1, None, :]
    adj[:, 3::11] = 0
    idx = torch.argsort(rand(L, n), dim=-1).to(torch.int32)
    act = (rand(L, n) < 0.5).to(torch.int32)
    qa = (rand(L, n) < 0.4).to(torch.int32)
    pa = ((rand(L, n) < 0.6) & (qa == 0)).to(torch.int32)
    split = n // 2

    def bound(hi, lo=0):
        return torch.randint(lo, hi + 1, (L,), generator=g, device=dev,
                             dtype=torch.int32)
    pb, q_hi, p_hi = bound(n, 1), bound(split), bound(n - split)
    if case == "ties":
        mask[:, 0] |= 1
        adj[:, :, 0] |= 1
        adj[:, [40, 70, 99]] = 0
        idx = torch.arange(n, dtype=torch.int32, device=dev).expand(L, n)
        act[:] = 1
        pb[:] = n
    elif case == "p0":
        act[:] = qa[:] = pa[:] = 0
        pb[:] = q_hi[:] = p_hi[:] = 0
    elif case == "p1":
        act[:] = qa[:] = pa[:] = 0
        act[:, 0] = qa[:, 0] = 1
        pa[:, split] = 1
        pb[:] = q_hi[:] = p_hi[:] = 1
    elif case == "pn":
        act[:] = 1
        pb[:] = n
        q_hi[:] = split
        p_hi[:] = n - split
    elif case == "lastbit":
        act[:] = qa[:] = pa[:] = 0
        act[:, n - 2] = pa[:, n - 2] = 1
        qa[:, n - 3] = 1
        pb[:] = n - 1
        q_hi[:] = split
        p_hi[:] = n - split - 1
    elif case == "idx_range":
        idx[:, :6] = torch.tensor([-1, -n, -n - 3, n, n + 5, -(1 << 30)],
                                  dtype=torch.int32, device=dev)
        idx[:, -3:] = torch.tensor([1 << 30, -2, n - 1], dtype=torch.int32,
                                   device=dev)
    elif case == "empty":
        mask[:] = 0
    return dict(adj=adj if per_lane else adj[0], mask=mask,
                nlp=bitset.count(mask), idx=idx.contiguous(), act=act,
                words=bitset.from_bool(act > 0), qa=qa, pa=pa,
                qw=bitset.from_bool(qa > 0), pw=bitset.from_bool(pa > 0),
                pb=pb, q_hi=q_hi, p_hi=p_hi, split=split)


def row_calls(x):
    """{wrapper name: (wrapper, args, kwargs)} of every K1 and K4 kind on
    the operands ``x`` (``row_case_inputs``); K1 with counts."""
    from repro_torch.kernels import fused_check as fc
    from repro_torch.kernels import fused_select as fs
    a, m, nlp, idx = x["adj"], x["mask"], x["nlp"], x["idx"]
    wc = dict(with_counts=True)
    return {
        "fused_select": (fs.fused_select, (a, m, x["act"]), {}),
        "fused_select_packed": (fs.fused_select_packed,
                                (a, m, x["words"]), {}),
        "fused_select_prefix": (fs.fused_select_prefix, (a, m, x["pb"]), {}),
        "fused_select_gathered": (fs.fused_select_gathered,
                                  (a, idx, m, x["act"]), {}),
        "fused_select_gathered_prefix": (fs.fused_select_gathered_prefix,
                                         (a, idx, m, x["pb"]), {}),
        "fused_check_packed": (fc.fused_check_packed,
                               (a, m, nlp, x["qw"], x["pw"]), wc),
        "fused_check": (fc.fused_check, (a, m, nlp, x["qa"], x["pa"]), wc),
        "fused_check_prefix2": (fc.fused_check_prefix2,
                                (a, m, nlp, x["q_hi"], x["p_hi"]),
                                dict(wc, split=x["split"])),
        "fused_check_gathered": (fc.fused_check_gathered,
                                 (a, idx, m, nlp, x["qa"], x["pa"]), wc),
        "fused_check_gathered_prefix2": (
            fc.fused_check_gathered_prefix2,
            (a, halves_idx(idx), m, nlp, x["q_hi"], x["p_hi"]), wc),
    }


def halves_idx(idx):
    """The compact engine's [Q ++ P'] index of 2n positions from two
    orders of the n rows."""
    import torch
    return torch.cat([idx.flip(-1), idx], dim=-1).contiguous()


def row_err(got, want) -> int:
    """max |err| of a K1 / K4 result against its plain version; a shape,
    dtype or None mismatch counts as an error."""
    same = all((a is None) == (b is None) and (a is None or (
        a.shape == b.shape and a.dtype == b.dtype))
        for a, b in zip(got, want))
    return max_err(tuple(got), tuple(want)) if same else 1 << 31


def check_row_kernels(dev):
    """K1 and K4, every kind, kernel against plain version on the card, bit
    for bit: the tile-edge cases (``ROW_CASES``, shared and per-lane
    adjacency, two lanes), back-to-back calls whose violation flags and
    argmins alternate (the scratch reset), two streams launching at once,
    one kernel a wrapper call (profiler), and two planted faults (a
    scratch slot left set) the check must flag.  Returns {wrapper name:
    largest |err|}."""
    import torch
    from repro_torch.core import bitset
    from repro_torch.kernels import fused_check as fc
    from repro_torch.kernels import fused_select as fs
    from repro_torch.kernels.dispatch import current_stream_ptr, row_scratch
    errs: dict = {}
    n_checks = 0
    for ci, case in enumerate(ROW_CASES):
        for per_lane in (False, True):
            x = row_case_inputs(case, per_lane, 1000 + 2 * ci + per_lane, dev)
            for name, (fn, args, kw) in row_calls(x).items():
                err = row_err(fn(*args, impl="pallas", **kw),
                              fn(*args, impl="jnp", **kw))
                require(err == 0, f"{name} {case} per-lane adj={per_lane}: "
                                  f"differs (max |err| {err})")
                errs[name] = max(errs.get(name, 0), err)
                n_checks += 1
    log(f"  K1/K4 tile edges: {n_checks} checks bit-exact ({list(ROW_CASES)}"
        f", shared and per-lane adjacency, {ROW_LANES} lanes)")

    # one kernel a wrapper call, and no fill or compare kernel beside it
    x = row_case_inputs("wide", True, 7, dev)
    for name, (fn, args, kw) in row_calls(x).items():
        fn(*args, impl="pallas", **kw)
        _, _, by_kernel = profile_window(
            lambda: [fn(*args, impl="pallas", **kw) for _ in range(10)])
        kname = "fused_check_kernel" if "check" in name \
            else "fused_select_kernel"
        seen = {k[:60]: v[1] for k, v in by_kernel.items()}
        require(sum(seen.values()) == 10 and all(kname in k for k in seen),
                f"{name}: 10 calls ran {seen} on the device, not 10 "
                f"{kname} launches")
    log("  K1/K4: one device kernel per wrapper call (profiler, 10 calls "
        "of each of the 10 wrappers), no other kernel")

    # the scratch reset: back-to-back calls, no sync between, whose
    # violation flags alternate (true, false, true) and whose argmins
    # differ, each read after all three ran
    x = row_case_inputs("wide", True, 11, dev)
    a, m, nlp = x["adj"], x["mask"], x["nlp"]
    full_rows = fc.fused_check_packed(a, m, nlp, x["qw"], x["pw"],
                                      impl="jnp", with_counts=True)[4] == \
        nlp[:, None]
    q_on = bitset.from_bool(full_rows)
    q_off = torch.zeros_like(q_on)
    late = x["act"].clone()
    late[:, :256] = 0
    seq = [(q_on, x["act"]), (q_off, late), (q_on, x["act"])]
    got = [(fc.fused_check_packed(a, m, nlp, q, x["pw"], impl="pallas"),
            fs.fused_select(a, m, act, impl="pallas")) for q, act in seq]
    want = [(fc.fused_check_packed(a, m, nlp, q, x["pw"], impl="jnp"),
             fs.fused_select(a, m, act, impl="jnp")) for q, act in seq]
    flags = [g[0][0].tolist() for g in got]
    picks = [g[1][0].tolist() for g in got]
    for (gk1, gk4), (wk1, wk4) in zip(got, want):
        require(row_err(gk1, wk1) == 0 and row_err(gk4, wk4) == 0,
                f"scratch reset: back-to-back calls differ (flags {flags}, "
                f"argmins {picks})")
    require(flags[0] == flags[2] == [True] * ROW_LANES
            and flags[1] == [False] * ROW_LANES and picks[0] != picks[1],
            f"scratch reset: the sequence does not alternate: flags {flags}, "
            f"argmins {picks}")
    log(f"  K1/K4 scratch reset: back-to-back flags {flags}, argmins "
        f"{picks}, each = plain")

    # two streams launching at once, each with its own scratch
    s1, s2 = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    for s in (s1, s2):
        s.wait_stream(torch.cuda.current_stream(dev))
    outs = {0: [], 1: []}
    for _ in range(20):
        for k, (s, (q, act)) in enumerate(zip((s1, s2), seq[:2])):
            with torch.cuda.stream(s):
                outs[k].append((fc.fused_check_packed(a, m, nlp, q, x["pw"],
                                                      impl="pallas"),
                                fs.fused_select(a, m, act, impl="pallas")))
    torch.cuda.synchronize()
    for k in (0, 1):
        for gk1, gk4 in outs[k]:
            require(row_err(gk1, want[k][0]) == 0
                    and row_err(gk4, want[k][1]) == 0,
                    f"two streams: stream {k} read another call's result")
    log("  K1/K4 on two streams at once: 2 x 20 calls of each, each = plain")

    # planted faults: a scratch slot left set before a call; the check
    # must flag the wrong result, and the kernel clears the slot again
    stream = current_stream_ptr(dev.index)
    k1_slots = row_scratch("fused_check", dev, stream, ROW_LANES, 2)
    k1_slots[0] = 1                     # lane 0's flag word, truth False
    bad = fc.fused_check_packed(a, m, nlp, q_off, x["pw"], impl="pallas")
    flagged_k1 = row_err(bad, want[1][0]) != 0
    k4_slots = row_scratch("fused_select", dev, stream, ROW_LANES, 4)
    k4_slots.view(torch.int64)[0] = ~5  # lane 0's key: count 0, position 5
    bad4 = fs.fused_select(a, m, late, impl="pallas")
    flagged_k4 = row_err(bad4, want[1][1]) != 0
    again = (fc.fused_check_packed(a, m, nlp, q_off, x["pw"], impl="pallas"),
             fs.fused_select(a, m, late, impl="pallas"))
    log(f"  K1/K4 planted faults: a set flag word gives viol "
        f"{bad[0].tolist()} (truth {want[1][0][0].tolist()}), flagged "
        f"{flagged_k1}; a planted key gives {bad4[0].tolist()} / "
        f"{bad4[1].tolist()} (truth {want[1][1][0].tolist()} / "
        f"{want[1][1][1].tolist()}), flagged {flagged_k4}")
    require(flagged_k1 and flagged_k4,
            "a planted scratch fault was not flagged")
    require(row_err(again[0], want[1][0]) == 0
            and row_err(again[1], want[1][1]) == 0,
            "the kernels did not clear a planted scratch slot")
    return errs


# K5 on the row tiles (csrc/intersect_count.cu): row counts at the 32-row
# tiles' edges, widths with w % 4 != 0 (one-word loads) and 16-byte units
K5_NS = (1, 31, 32, 33, 63, 64, 65, 512, 1024)
K5_WS = (1, 5, 64)
# (lanes, per-lane adjacency): 0 = no lane dim
K5_LANES = ((0, False), (1, True), (2, False), (3, True))


def k5_operands(n, w, lanes, per_lane, seed, dev, unaligned=False):
    """K5 operands made on the card from a seeded generator: adjacency
    (lanes or none, n, w), masks (lanes, w) and an ``idx`` of positions
    with negative and out-of-range entries (JAX's gather rule);
    ``unaligned`` puts adj and mask 4 bytes past a 16-byte boundary (the
    one-word path)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    L = max(lanes, 1)

    def words(*shape):
        def one():
            return torch.randint(-(1 << 31), 1 << 31, shape, generator=g,
                                 device=dev, dtype=torch.int32)
        x = one() & one()
        if not unaligned:
            return x
        buf = torch.empty(x.numel() + 4, dtype=torch.int32, device=dev)
        y = buf[1:1 + x.numel()].view(shape)
        y.copy_(x)
        return y
    adj = words(L if per_lane else 1, n, w)
    mask = words(L, w)
    adj[:, ::7] |= mask[:, None, :] if per_lane else mask[:1, None, :]
    adj[:, 3::11] = 0
    idx = torch.argsort(torch.rand(L, n, generator=g, device=dev),
                        dim=-1).to(torch.int32)
    edge = torch.tensor([-1, -n, -n - 3, n, n + 5, -(1 << 30), 1 << 30],
                        dtype=torch.int32, device=dev)
    idx[:, :min(n, 7)] = edge[:min(n, 7)]
    idx = idx.contiguous()
    a = adj if per_lane else adj[0]
    if lanes == 0:
        return a, mask[0], idx[0]
    return a, mask, idx


def check_k5_tiles(dev):
    """K5 against its plain version on the card, bit for bit: n at the row
    tiles' edges (``K5_NS``), w 1, 5 and 64 (``K5_WS``), no lane dim, 1, 2
    and 3 lanes with shared and per-lane adjacency (``K5_LANES``), rows in
    order and through an ``idx`` with negative and out-of-range entries;
    operands off 16-byte boundaries (the one-word path); 2 lanes of 26,000
    x 813 words (one-word loads, a row walked in 4 chunks); one device
    kernel a wrapper call (profiler); and a planted fault (one adjacency
    bit under the mask flipped, one row's count off by one) that the check
    must flag.  Returns the largest |err|."""
    import torch
    from repro_torch.kernels.intersect_count.ops import intersect_count
    worst, n_checks = 0, 0

    def held(a, m, i, what):
        nonlocal worst, n_checks
        got = intersect_count(a, m, idx=i, impl="pallas")
        want = intersect_count(a, m, idx=i, impl="jnp")
        err = max_err(got, want)
        require(err == 0 and got.shape == want.shape
                and got.dtype == want.dtype,
                f"intersect_count {what}: differs (max |err| {err})")
        worst = max(worst, err)
        n_checks += 1
    for n in K5_NS:
        for w in K5_WS:
            for lanes, per_lane in K5_LANES:
                a, m, i = k5_operands(n, w, lanes, per_lane,
                                      n * 131 + w * 7 + lanes, dev)
                for ix in (None, i):
                    held(a, m, ix, f"n={n} w={w} lanes={lanes} per-lane "
                                   f"adj={per_lane} idx={ix is not None}")
        a, m, i = k5_operands(n, 64, 2, True, n, dev, unaligned=True)
        require(a.data_ptr() % 16 and m.data_ptr() % 16,
                "the unaligned K5 operands are aligned")
        held(a, m, i, f"n={n} w=64 unaligned")
    a, m, i = k5_operands(26_000, 813, 2, False, 5, dev)
    for ix in (None, i):
        held(a, m, ix, f"26,000 x 813 idx={ix is not None}")
    log(f"  intersect_count tiles: {n_checks} checks bit-exact (n {K5_NS}, "
        f"w {K5_WS}, lanes/per-lane {K5_LANES}, rows in order and through "
        f"idx with negative and out-of-range entries, unaligned operands, "
        f"2 x 26,000 x 813)")

    # one device kernel a wrapper call, and nothing else on the device
    a, m, i = k5_operands(512, 64, 2, True, 9, dev)
    intersect_count(a, m, idx=i, impl="pallas")
    _, _, by_kernel = profile_window(
        lambda: [intersect_count(a, m, idx=i, impl="pallas")
                 for _ in range(10)])
    seen = {k[:60]: v[1] for k, v in by_kernel.items()}
    require(sum(seen.values()) == 10
            and all("intersect_count_kernel" in k for k in seen),
            f"intersect_count: 10 calls ran {seen} on the device, not 10 "
            f"intersect_count_kernel launches")
    log("  intersect_count: one device kernel per wrapper call (profiler, "
        "10 calls)")

    # planted fault: one bit of lane 0's row 0 under its mask, flipped in
    # the kernel's copy of the adjacency; held against the plain version
    # on the right operands, the counts of row 0 (at every position idx
    # sends to it) are off by one
    want = intersect_count(a, m, idx=i, impl="jnp")
    bit = m[0, 0] & -m[0, 0]
    require(int(bit) != 0, "the K5 control's mask word is 0")
    bad = a.clone()
    bad[0, 0, 0] ^= bit
    got = intersect_count(bad, m, idx=i, impl="pallas")
    diff = (got - want).abs()
    flagged = max_err(got, want) != 0
    log(f"  control (lane 0's row 0, bit {int(bit)} flipped): "
        f"{int((diff > 0).sum())} counts off, by {int(diff.max())}: "
        f"flagged {flagged}")
    require(flagged and int(diff.max()) == 1,
            "the K5 check passes a planted fault")
    return worst


# K7 fwd at the prefill shapes of qwen3-1.7b (KV 8, G 2, hd 128) and
# ragged / non-causal ones: (B, S, H, KV, hd, dtype, causal, rows).  The
# (1, 32768) layer is held on its first and last K7_SPAN query rows
# against all keys (the plain version's S x S scores would take 69 GB);
# every other case on all rows.
K7_SPAN = 512
# the bf16 K7 forward kernel's name, as the profiler reports it
K7_FWD_KERNEL = "flash_fwd_wgmma_kernel"
K7_CASES = (
    (1, 4096, 16, 8, 128, "bfloat16", True, None),
    (4, 4096, 16, 8, 128, "bfloat16", True, None),
    (1, 32768, 16, 8, 128, "bfloat16", True, "ends"),
    (2, 1000, 16, 8, 128, "bfloat16", True, None),  # ragged: S % 64 != 0
    (1, 4097, 16, 8, 128, "bfloat16", True, None),  # S % 4 != 0 (TMA rows)
    (2, 1000, 12, 4, 64, "bfloat16", True, None),   # hd 64, G = 3
    (2, 256, 8, 2, 128, "bfloat16", False, None),
    (1, 512, 16, 8, 128, "float32", True, None),
    # fp32 (the micro-tile kernel): the fp32 grad path's layer (the planted
    # faults' case, K7_F32_CONTROL), ragged, S % 4 != 0, hd 64 with G = 3,
    # non-causal, hd 32 and hd 16
    (2, 4096, 16, 8, 128, "float32", True, None),
    (2, 1000, 16, 8, 128, "float32", True, None),
    (1, 4097, 16, 8, 128, "float32", True, None),
    (2, 1000, 12, 4, 64, "float32", True, None),
    (2, 256, 8, 2, 128, "float32", False, None),
    (2, 1000, 8, 4, 32, "float32", True, None),
    (2, 333, 8, 2, 16, "float32", False, None),
    # zamba2-7b's shared attention block (hd 112, 32 heads, G = 1): the
    # prefill layer, ragged, and fp32 (the decode == prefill path)
    (1, 4096, 32, 32, 112, "bfloat16", True, None),
    (2, 1000, 32, 32, 112, "bfloat16", True, None),
    (2, 1000, 32, 32, 112, "float32", True, None),
)
# the fp32 controls' case: the fp32 grad path's layer
K7_F32_CONTROL = K7_CASES.index((2, 4096, 16, 8, 128, "float32", True, None))
# the hd-112 controls' cases (bf16 and fp32)
K7_HD112_CONTROLS = (K7_CASES.index((1, 4096, 32, 32, 112, "bfloat16", True,
                                     None)),
                     K7_CASES.index((2, 1000, 32, 32, 112, "float32", True,
                                     None)))
# Tolerances.  Element-wise, bf16 o 3e-2 abs/rel (tests/test_flash_kernel.py:
# bf16 keeps ~3 decimal digits, and the kernel rounds p at its running
# maximum where the plain version rounds it at the final one); fp32 o 1e-4
# (the same fp32 arithmetic summed in another order, TF32 off); lse 1e-4
# relative.  With scores ~N(0, 1), row i of o is a mean over ~i keys, of
# rms ~sqrt(e / (i + 1)) (0.026 at row 4095), so past the first few
# hundred rows the element-wise bf16 limit is as large as the values and
# a fault on the P V side passes it.  Per query row, ||o - ref|| / ||ref||
# is scale-free: bf16 1e-2 against the sound kernel's 4.4e-3 at most
# over K7_CASES (bf16 rounding of o and p), fp32 1e-5 against its 6.6e-7
# (PERF.md, PR 13); a planted fault reads 1.2-1.5.
K7_TOL = {"bfloat16": 3e-2, "float32": 1e-4}
K7_ROW_RTOL = {"bfloat16": 1e-2, "float32": 1e-5}
K7_LSE_RTOL = 1e-4


def k7_operands(B, S, H, KV, hd, dtype, dev, seed):
    """Packed K7 operands as the model's prefill builds them (contiguous,
    unpadded)."""
    import torch
    from repro_torch.kernels.flash_attention.ops import _pack
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(B, S, n, hd, generator=g, device=dev)
               .to(getattr(torch, dtype)) for n in (H, KV, KV))
    return tuple(x.contiguous() for x in _pack(q, k, v))


def k7_spans(S, rows):
    return ([(0, S)] if rows is None else
            [(0, min(K7_SPAN, S)), (max(S - K7_SPAN, 0), S)])


def k7_errors(qp, kp, vp, o, lse, *, causal, scale, sq, sk, spans):
    """K7's (o, lse) against ``flash_fwd_ref`` on the query-row spans:
    {abs: max |o err|, bad: elements past K7_TOL, row: max per-row
    ||o err|| / ||ref||, lse: max relative lse err, finite}."""
    import torch
    from repro_torch.kernels.flash_attention import flash_fwd_ref
    tol = K7_TOL[str(qp.dtype).split(".")[1]]
    e = dict(abs=0.0, bad=0, row=0.0, lse=0.0, finite=True)
    for a, b in spans:
        b = min(b, sq)
        ro, rl = flash_fwd_ref(qp[..., a:b, :], kp, vp, causal=causal,
                               scale=scale, sq=sq, sk=sk, q0=a)
        x, ro = o[..., a:b, :].float(), ro.float()
        d = (x - ro).abs()
        e["abs"] = max(e["abs"], float(d.max()))
        e["bad"] += int((d > tol + tol * ro.abs()).sum())
        e["row"] = max(e["row"], float(((x - ro).norm(dim=-1) / ro.norm(
            dim=-1).clamp(min=1e-30)).max()))
        e["lse"] = max(e["lse"], float(((lse[..., a:b] - rl).abs()
                                        / rl.abs().clamp(min=1.0)).max()))
        e["finite"] &= bool(torch.isfinite(x).all()
                            and torch.isfinite(lse[..., a:b]).all())
        del ro, rl, x, d
    return e


def k7_ok(e, dtype) -> bool:
    return (e["finite"] and e["bad"] == 0 and e["row"] <= K7_ROW_RTOL[dtype]
            and e["lse"] <= K7_LSE_RTOL)


def late_v_tiles_misplaced(v, axis=-2, first=K7_SPAN, tile=64):
    """Planted fault (control): every key from ``first`` on (along
    ``axis``) reads the V row one 64-key tile earlier (wrapping inside
    [first, Sk)), as a P V loop that misplaces its later V tiles would."""
    bad = v.clone()
    n = v.shape[axis] - first
    bad.narrow(axis, first, n).copy_(v.narrow(axis, first, n).roll(
        tile, dims=axis))
    return bad


# K7 fwd's device time per launch at K7_TIME_SHAPES from profiler windows
# of phase 3 (``check_k7``): in phase 5 some windows have seen no kernel
# at all, while the same windows in phase 3 see them (PERF.md, section 6)
K7_EARLY = {}


def check_k7(dev):
    """K7 fwd against ``flash_fwd_ref`` on the card at K7_CASES, then two
    planted faults that the check must flag; returns the largest max
    |err| of o over the cases, {"flash_fwd": at hd 16-128,
    "flash_fwd_hd112": at hd 112}.  Also takes K7's stand-alone device
    time at K7_TIME_SHAPES into K7_EARLY."""
    import torch
    from repro_torch.kernels.flash_attention import flash_fwd
    worst = {"flash_fwd": 0.0, "flash_fwd_hd112": 0.0}
    for i, (B, S, H, KV, hd, dt, causal, rows) in enumerate(K7_CASES):
        qp, kp, vp = k7_operands(B, S, H, KV, hd, dt, dev, seed=100 + i)
        kw = dict(causal=causal, scale=hd ** -0.5, sq=S, sk=S)
        o, lse = flash_fwd(qp, kp, vp, **kw)
        torch.cuda.synchronize()
        if (B, S, H, KV, hd) in K7_TIME_SHAPES and dt == "bfloat16":
            K7_EARLY[S] = device_ms(lambda: flash_fwd(qp, kp, vp, **kw),
                                    K7_FWD_KERNEL, reps=20 if S < 32768 else 5)
        if (B, S, H, KV, hd) == K7_HD112_SHAPE and dt == "bfloat16":
            K7_EARLY["hd112"] = device_ms(lambda: flash_fwd(qp, kp, vp, **kw),
                                          K7_FWD_KERNEL)
        e = k7_errors(qp, kp, vp, o, lse, spans=k7_spans(S, rows), **kw)
        # the forward has no atomics: a second run is bit-identical
        o2, lse2 = flash_fwd(qp, kp, vp, **kw)
        same = bool(torch.equal(o, o2) and torch.equal(lse, lse2))
        del o2, lse2
        log(f"  flash_fwd (B,S,H,KV,hd)={(B, S, H, KV, hd)} {dt} causal="
            f"{causal} rows={rows or 'all'}: o max |err| {e['abs']:.3g} "
            f"({e['bad']} past {K7_TOL[dt]} abs/rel), row rel err "
            f"{e['row']:.3g} (tol {K7_ROW_RTOL[dt]}), lse rel err "
            f"{e['lse']:.3g} (tol {K7_LSE_RTOL}); rerun bit-identical "
            f"{same}")
        require(k7_ok(e, dt), f"K7 {K7_CASES[i]}: {e}")
        require(same, f"K7 {K7_CASES[i]}: o or lse differs between two "
                      f"runs on the same operands")
        name = "flash_fwd_hd112" if hd == 112 else "flash_fwd"
        worst[name] = max(worst[name], e["abs"])
        if i in (0, K7_F32_CONTROL, *K7_HD112_CONTROLS):
            # controls (bf16 and fp32): the kernel with a planted fault,
            # held against the plain version of the right function, must
            # come out wrong
            for what, args, ckw in (
                    ("late V tiles misplaced",
                     (qp, kp, late_v_tiles_misplaced(vp)), kw),
                    ("non-causal mask", (qp, kp, vp),
                     dict(kw, causal=False))):
                co, cl = flash_fwd(*args, **ckw)
                ce = k7_errors(qp, kp, vp, co, cl, spans=k7_spans(S, rows),
                               **kw)
                log(f"  control ({what}) at {K7_CASES[i][:6]}: o max |err| "
                    f"{ce['abs']:.3g} ({ce['bad']} past {K7_TOL[dt]}), row "
                    f"rel err {ce['row']:.3g}, lse rel err {ce['lse']:.3g}: "
                    f"flagged {not k7_ok(ce, dt)} (element-wise alone: "
                    f"{ce['bad'] > 0})")
                require(not k7_ok(ce, dt), f"K7 check passes a planted "
                                           f"fault ({what}): {ce}")
                del co, cl
        del o, lse, qp, kp, vp
    torch.cuda.empty_cache()
    return worst


# The K7 backward at the qwen3-1.7b training layer shapes (B, 4096) with H 16,
# KV 8, hd 128 (the main path's microbatch is B = 2), bf16 and fp32,
# causal, plus ragged, non-causal and hd-64 cases: (B, S, H, KV, hd,
# dtype, causal).  The operands are the forward kernel's o and lse, a
# random do and dD = rowsum(do * o), the path's own.
K7B_CASES = (
    (1, 4096, 16, 8, 128, "bfloat16", True),
    (2, 4096, 16, 8, 128, "bfloat16", True),
    (1, 4096, 16, 8, 128, "float32", True),
    (2, 4096, 16, 8, 128, "float32", True),
    (2, 1000, 16, 8, 128, "bfloat16", True),    # ragged: S % 64 != 0
    (2, 256, 8, 2, 128, "bfloat16", False),
    (2, 1000, 16, 8, 128, "float32", True),     # ragged
    (1, 4097, 16, 8, 128, "float32", True),     # one row past a tile
    (2, 256, 8, 2, 128, "float32", False),
    (2, 1000, 12, 4, 64, "float32", True),      # hd 64, G = 3
    # zamba2-7b's shared attention layer (hd 112, padded to 128 in shared
    # memory by the fused kernel) in the family train path's microbatch,
    # and in fp32 (seven columns a thread)
    (2, 4096, 32, 32, 112, "bfloat16", True),
    (1, 4096, 32, 32, 112, "float32", True),
)
# at the hd-112 cases the planted faults run too, the kernels also write
# into buffers K7B_TAIL elements longer than their outputs (a sentinel
# past the end, which no write may reach: ``k7b_tail``), and the fp32
# kernels' device times are taken for phase 5 (``k7_bwd_hd112_times``,
# at these shapes; the fused kernel's too, which phase 5's windows missed)
K7B_TAIL = 2 * 128
K7B_HD112_SHAPES = {c[5]: c[:5] for c in K7B_CASES if c[4] == 112}
# the fp32 K7 dq, dkv and forward kernels' names, as the profiler reports
# them: ``check_k7_bwd`` takes their device times in phase 3, since phase
# 5's windows have not seen these kernels (PERF.md, section 6)
K7B_F32_KERNELS = {"flash_bwd_dq": "flash_dq_f32",
                   "flash_bwd_dkv": "flash_dkv_f32",
                   "flash_fwd": "flash_fwd_f32"}
# Tolerances, per output row (query rows of dq, key rows of dk and dv),
# ||x - ref|| / ||ref||, and max |x - ref| / max |ref| over the output.
# Rows whose ref norm is under 1e-2 of the median row's are left to the
# second measure: their exact value is ~0 (dq's first causal row: its one
# key gives ds = p (do.v - do.o) = 0) and both sides hold rounding noise
# of the terms there.  bf16: the kernels and the plain version round p
# and ds to bf16 at the same points, from fp32 scores summed in another
# order, and round the outputs to bf16 (the fused kernel's dq partials
# meet in an fp32 accumulator through atomics, another order again);
# fp32: the same fmaf chains in the same order (csrc/flash_bwd.cu: S, dP
# over the head dim, dQ over the keys, dK, dV over the G heads then the q
# rows), so what is left is the plain version's own rounding of p and ds;
# the plain version itself is further than these limits from its float64
# evaluation (check_k7_bwd logs both), so any other summation order
# misses them.  Limits at ~2-3x the sound kernels' largest readings over
# K7B_CASES on the card (PERF.md section 6: bf16 row 5.7e-3, scaled
# 3.9e-3; fp32 row 6.2e-7, scaled 3.1e-7); the planted faults read row
# >= 0.5 and scaled >= 0.047.
K7B_ROW_RTOL = {"bfloat16": 1e-2, "float32": 2e-6}
K7B_SCALED_TOL = {"bfloat16": 1e-2, "float32": 1e-6}
K7B_FAULT_ROW = 512
# dq of the fused kernel, one run against another on the same operands,
# per row: its fp32 partials are added in whatever order the atomics land,
# so an element may round to the neighbouring bf16 value: one bf16 ulp,
# at most 2^-7 of the value; dk and dv must be bit-identical.
K7B_DQ_RERUN_RTOL = 2 ** -7


def k7b_operands(B, S, H, KV, hd, dtype, causal, dev, seed):
    """(qp, kp, vp, dop, lse, dD, kwargs) as the training path builds
    them: the forward kernel's o and lse, a random do."""
    import torch
    from repro_torch.kernels.flash_attention import flash_fwd
    qp, kp, vp = k7_operands(B, S, H, KV, hd, dtype, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    dop = torch.randn(qp.shape, generator=g, device=dev).to(qp.dtype)
    kw = dict(causal=causal, scale=hd ** -0.5, sq=S, sk=S)
    o, lse = flash_fwd(qp, kp, vp, **kw)
    dD = (dop.float() * o.float()).sum(-1)
    return qp, kp, vp, dop, lse, dD, kw


def k7b_errors(got, want) -> dict:
    """{dq|dk|dv: {row, scaled, abs, finite}} of the kernels' outputs
    against the plain version's (K7B_ROW_RTOL's two measures)."""
    import torch
    out = {}
    for name, x, ref in zip(("dq", "dk", "dv"), got, want):
        x, ref = x.float(), ref.float()
        rn = ref.norm(dim=-1)
        keep = rn >= 1e-2 * rn.median()
        d = x - ref
        out[name] = dict(row=float((d.norm(dim=-1)[keep] / rn[keep]).max()),
                         scaled=float(d.abs().max() / ref.abs().max()),
                         abs=float(d.abs().max()),
                         finite=bool(torch.isfinite(x).all()))
        del x, ref, d
    return out


def k7b_ok(e, dtype) -> bool:
    return all(v["finite"] and v["row"] <= K7B_ROW_RTOL[dtype]
               and v["scaled"] <= K7B_SCALED_TOL[dtype] for v in e.values())


def k7b_brief(e) -> str:
    return ", ".join(f"{k} row {v['row']:.3g} scaled {v['scaled']:.3g}"
                     for k, v in e.items())


def k7b_tail(qp, kp, vp, dop, lse, dD, kw, want) -> dict:
    """hd 112: the kernels write dq (the fused kernel: its fp32
    accumulator), dk and dv as the first elements of buffers K7B_TAIL
    elements longer, whose tail holds a sentinel (NaN past the stores,
    1.5 past the accumulator's atomic adds, where a non-zero add shows);
    the tail must come back untouched (the last row, written past column
    111, would reach it; an earlier row's overrun lands on the next row,
    which the comparison sees) and the outputs within K7B_ROW_RTOL of the
    plain version's."""
    import torch
    from repro_torch.kernels.flash_attention.ops import (launch_bwd,
                                                        launch_dkv, launch_dq)
    dev, dt = qp.device, qp.dtype

    def longer(like, fill, dtype=None):
        buf = torch.full((like.numel() + K7B_TAIL,), fill, device=dev,
                         dtype=dtype or like.dtype)
        return buf, buf[:like.numel()].view(like.shape)
    ops = (qp, kp, vp, dop, lse, dD)
    bk, dk = longer(kp, float("nan"))
    bv, dv = longer(vp, float("nan"))
    if dt == torch.bfloat16:
        bq, dq = longer(qp, 1.5, torch.float32)
        dq.zero_()
        launch_bwd(*ops, dq, dk, dv, **kw)
        torch.cuda.synchronize()
        q_kept = bool((bq[-K7B_TAIL:] == 1.5).all())
        dq = dq.to(dt)
    else:
        bq, dq = longer(qp, float("nan"))
        launch_dq(*ops, dq, **kw)
        launch_dkv(*ops, dk, dv, **kw)
        torch.cuda.synchronize()
        q_kept = bool(torch.isnan(bq[-K7B_TAIL:]).all())
    kept = dict(dq=q_kept, dk=bool(torch.isnan(bk[-K7B_TAIL:]).all()),
                dv=bool(torch.isnan(bv[-K7B_TAIL:]).all()))
    e = k7b_errors((dq, dk, dv), want)
    dname = "bfloat16" if dt == torch.bfloat16 else "float32"
    log(f"  hd 112 into longer buffers ({K7B_TAIL} sentinel elements past "
        f"each output): tails untouched {kept}; {k7b_brief(e)}")
    require(all(kept.values()) and k7b_ok(e, dname),
            f"K7 bwd at hd 112 wrote past its outputs ({kept}) or "
            f"disagrees with the plain version there: {e}")
    return dict(tails_untouched=kept, errors=e)


def check_k7_bwd(dev):
    """The K7 backward against ``flash_bwd_ref`` on the card at K7B_CASES
    (bf16: the fused kernel; fp32: K7 dq and dkv), their determinism
    (fused: dk, dv bit-identical across two runs, dq within
    K7B_DQ_RERUN_RTOL; fp32: dq, dk, dv bit-identical), then planted
    faults that the check must flag: for the fused kernel the lse of
    query rows from K7B_FAULT_ROW on offset by +0.7, dD zeroed, and the dq
    accumulator handed to the kernel filled with non-zero values (at the
    first case and at hd 112); for the fp32 kernels the same lse offset
    (at the first fp32 case and at hd 112).  At hd 112 also ``k7b_tail``:
    no write past the outputs.  Logs, at the first fp32 case, the fp32
    plain version, the kernels and the plain version's 3xTF32 emulation
    against the plain version in float64.  Returns the largest max |err|
    of each kernel over its cases (hd 112 apart: ``<name>_hd112``), the
    readings, and the fp32 kernels' device times per launch at
    K7B_TIME_SHAPES[1] (with the kernels SDPA runs for its fp32 forward
    and backward there) and at hd 112, with the fused kernel's at
    hd 112."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_bwd, flash_bwd_ref,
                                                     flash_fwd)
    from repro_torch.kernels.flash_attention.ops import (launch_bwd,
                                                        launch_dkv, launch_dq)
    from repro_torch.kernels.flash_attention.ref import flash_bwd_3xtf32_ref
    worst = {f"{k}{x}": 0.0 for k in ("flash_bwd_fused", "flash_bwd_dq",
                                      "flash_bwd_dkv")
             for x in ("", "_hd112")}
    readings, early = {}, {}
    first_f32 = True
    for i, (B, S, H, KV, hd, dt, causal) in enumerate(K7B_CASES):
        sfx = "_hd112" if hd == 112 else ""
        qp, kp, vp, dop, lse, dD, kw = k7b_operands(B, S, H, KV, hd, dt,
                                                    causal, dev, 200 + i)
        got = flash_bwd(qp, kp, vp, dop, lse, dD, **kw)
        torch.cuda.synchronize()
        want = flash_bwd_ref(qp, kp, vp, dop, lse, dD, **kw)
        e = k7b_errors(got, want)
        readings[str(K7B_CASES[i])] = e
        log(f"  flash_bwd (B,S,H,KV,hd)={(B, S, H, KV, hd)} {dt} causal="
            f"{causal}: {k7b_brief(e)} (tols {K7B_ROW_RTOL[dt]} / "
            f"{K7B_SCALED_TOL[dt]})")
        require(k7b_ok(e, dt), f"K7 bwd {K7B_CASES[i]}: {e}")
        if dt == "bfloat16":
            name = "flash_bwd_fused" + sfx
            worst[name] = max(worst[name], *(v["abs"] for v in e.values()))
            again = flash_bwd(qp, kp, vp, dop, lse, dD, **kw)
            same = (torch.equal(again[1], got[1])
                    and torch.equal(again[2], got[2]))
            rerun = k7b_errors(again, got)["dq"]["row"]
            readings[f"rerun {K7B_CASES[i]}"] = dict(dk_dv_identical=same,
                                                      dq_row=rerun)
            log(f"  rerun: dk, dv bit-identical {same}; dq per row {rerun:.3g}"
                f" (tol {K7B_DQ_RERUN_RTOL:.3g})")
            require(same and rerun <= K7B_DQ_RERUN_RTOL,
                    f"K7 bwd {K7B_CASES[i]} rerun: dk/dv identical {same}, "
                    f"dq per row {rerun}")
            del again
            if hd == 112:
                # the fused kernel's device time at hd 112, for phase 5
                early[name] = device_ms(
                    lambda: flash_bwd(qp, kp, vp, dop, lse, dD, **kw),
                    "flash_bwd_fused", reps=5)
                log(f"  bf16 hd 112 fused device ms per launch: "
                    f"{early[name]}")
        else:
            worst["flash_bwd_dq" + sfx] = max(worst["flash_bwd_dq" + sfx],
                                            e["dq"]["abs"])
            worst["flash_bwd_dkv" + sfx] = max(worst["flash_bwd_dkv" + sfx],
                                             e["dk"]["abs"], e["dv"]["abs"])
            # no atomics: a second run is bit-identical
            again = flash_bwd(qp, kp, vp, dop, lse, dD, **kw)
            same = all(torch.equal(a, b) for a, b in zip(again, got))
            readings[f"rerun {K7B_CASES[i]}"] = dict(identical=same)
            log(f"  rerun: dq, dk, dv bit-identical {same}")
            require(same, f"K7 bwd {K7B_CASES[i]} rerun: dq, dk or dv "
                          f"differs between two runs on the same operands")
            del again
            if (B, S, H, KV, hd) == K7B_TIME_SHAPES[1] and causal:
                # the fp32 kernels' device times (dq, dkv and the forward
                # on the same operands) and the kernels SDPA runs for its
                # fp32 forward and backward, from windows that see them
                dq, dk, dv = (torch.empty_like(x) for x in (qp, kp, vp))
                ops = (qp, kp, vp, dop, lse, dD)
                for name, fn in (
                        ("flash_bwd_dq", lambda: launch_dq(*ops, dq, **kw)),
                        ("flash_bwd_dkv",
                         lambda: launch_dkv(*ops, dk, dv, **kw)),
                        ("flash_fwd", lambda: flash_fwd(qp, kp, vp, **kw))):
                    early[name] = device_ms(fn, K7B_F32_KERNELS[name],
                                            reps=5)
                early["library_kernels"] = sdpa_kernels(qp, kp, vp, dop)
                log(f"  fp32 device ms per launch and SDPA's kernels: "
                    f"{json.dumps(early)}")
                del dq, dk, dv, ops
            if hd == 112:
                # the hd-112 fp32 kernels' device times, as above
                dq, dk, dv = (torch.empty_like(t) for t in (qp, kp, vp))
                ops = (qp, kp, vp, dop, lse, dD)
                for name, fn in (
                        ("flash_bwd_dq", lambda: launch_dq(*ops, dq, **kw)),
                        ("flash_bwd_dkv",
                         lambda: launch_dkv(*ops, dk, dv, **kw))):
                    early[name + sfx] = device_ms(fn, K7B_F32_KERNELS[name],
                                                reps=5)
                log(f"  hd 112 device ms per launch (bf16 fused, fp32 dq "
                    f"and dkv): " + json.dumps(
                    {k: v for k, v in early.items() if k.endswith(sfx)}))
                del dq, dk, dv, ops
            if first_f32 or hd == 112:
                # control: the fp32 kernels given a wrong lse, held
                # against the plain version on the right one
                bad_lse = lse.clone()
                bad_lse[..., K7B_FAULT_ROW:] += 0.7
                ce = k7b_errors(flash_bwd(qp, kp, vp, dop, bad_lse, dD, **kw),
                                want)
                flagged = not k7b_ok(ce, dt)
                what = f"fp32 lse + 0.7 from row {K7B_FAULT_ROW}"
                readings[f"control: {what} {K7B_CASES[i][:5]}"] = ce
                log(f"  control ({what}) at {K7B_CASES[i][:5]}: "
                    f"{k7b_brief(ce)}: flagged {flagged}")
                require(flagged, f"K7 bwd check passes a planted fault "
                                 f"({what}) at {K7B_CASES[i][:5]}: {ce}")
                del bad_lse
            if first_f32:
                # what the fp32 limits hold: the plain version, the kernels
                # and the plain version's 3xTF32 emulation (a tensor-core
                # kernel's products) against the plain version evaluated
                # in float64 (the exact result on these operands, to
                # ~1e-15); the emulation against the fp32 plain version
                w64 = flash_bwd_ref(*(x.double() for x in (qp, kp, vp, dop,
                                                           lse, dD)), **kw)
                tf3 = flash_bwd_3xtf32_ref(qp, kp, vp, dop, lse, dD, **kw)
                for who, x, ref in (
                        ("plain version vs float64", want, w64),
                        ("kernels vs float64", got, w64),
                        ("3xTF32 emulation vs float64", tf3, w64),
                        ("3xTF32 emulation vs the fp32 plain version", tf3,
                         want)):
                    e64 = k7b_errors(x, ref)
                    readings[f"fp32 {who}"] = e64
                    log(f"  fp32 {who}: {k7b_brief(e64)}")
                del w64, tf3
                first_f32 = False
        del got
        if hd == 112:
            readings[f"tail {K7B_CASES[i]}"] = k7b_tail(
                qp, kp, vp, dop, lse, dD, kw, want)
        if i == 0 or (hd == 112 and dt == "bfloat16"):
            # controls: the fused kernel given a wrong operand, held against
            # the plain version on the right ones, must come out wrong
            require(dt == "bfloat16", "the controls run the fused kernel")
            bad_lse = lse.clone()
            bad_lse[..., K7B_FAULT_ROW:] += 0.7
            g = torch.Generator(device=dev).manual_seed(7)
            bad_acc = (torch.randn(qp.shape, generator=g, device=dev)
                       * float(want[0].float().abs().mean()))

            def dirty_acc():
                dk, dv = torch.empty_like(kp), torch.empty_like(vp)
                launch_bwd(qp, kp, vp, dop, lse, dD, bad_acc, dk, dv, **kw)
                return bad_acc.to(qp.dtype), dk, dv
            for what, run in (
                    (f"lse + 0.7 from row {K7B_FAULT_ROW}",
                     lambda: flash_bwd(qp, kp, vp, dop, bad_lse, dD, **kw)),
                    ("dD zeroed",
                     lambda: flash_bwd(qp, kp, vp, dop, lse,
                                       torch.zeros_like(dD), **kw)),
                    ("dq accumulator not zeroed", dirty_acc)):
                ce = k7b_errors(run(), want)
                flagged = not k7b_ok(ce, dt)
                readings[f"control: {what} {K7B_CASES[i][:5]}"] = ce
                log(f"  control ({what}) at {K7B_CASES[i][:5]}: "
                    f"{k7b_brief(ce)}: flagged {flagged}")
                require(flagged, f"K7 bwd check passes a planted fault "
                                 f"({what}) at {K7B_CASES[i][:5]}: {ce}")
            del bad_lse, bad_acc
        del qp, kp, vp, dop, lse, dD, want
        torch.cuda.empty_cache()
    return worst, readings, early


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


def counted():
    """{record name: (wrapper, counter attribute)} of every kernel wrapper
    that counts its launches: the eleven entry points of the ``kernels``
    line first, then the kinds no main path launches (their counts must
    stay 0 there)."""
    from repro_torch.kernels import fused_check as fc
    from repro_torch.kernels import fused_select as fs
    from repro_torch.kernels.intersect_count.ops import intersect_count
    from repro_torch.kernels.resident_pool.ops import resident_pool_segment
    from repro_torch.kernels.flash_attention.ops import flash_bwd, flash_fwd
    from repro_torch.kernels.resident_step.ops import resident_segment
    one = {"fused_check_packed": fc.fused_check_packed,
           "resident_pool": resident_pool_segment,
           "resident_step": resident_segment,
           "fused_select_packed": fs.fused_select_packed,
           "fused_select_gathered_prefix": fs.fused_select_gathered_prefix,
           "fused_check_gathered_prefix2": fc.fused_check_gathered_prefix2,
           "intersect_count": intersect_count,
           "flash_fwd": flash_fwd,
           "flash_bwd_fused": (flash_bwd, "fused_launches"),
           "flash_bwd_dq": (flash_bwd, "dq_launches"),
           "flash_bwd_dkv": (flash_bwd, "dkv_launches"),
           "fused_select": fs.fused_select,
           "fused_select_prefix": fs.fused_select_prefix,
           "fused_select_gathered": fs.fused_select_gathered,
           "fused_check": fc.fused_check,
           "fused_check_prefix2": fc.fused_check_prefix2,
           "fused_check_gathered": fc.fused_check_gathered}
    return {k: (v if isinstance(v, tuple) else (v, "launches"))
            for k, v in one.items()}


def reset_counters():
    for f, attr in counted().values():
        setattr(f, attr, 0)


def counters():
    return {k: getattr(f, attr) for k, (f, attr) in counted().items()}


def nonzero(c) -> dict:
    return {k: v for k, v in c.items() if v}


def k4_k1_launches(c) -> int:
    """Launches of any fused_select / fused_check kind in counts ``c``."""
    return sum(v for k, v in c.items() if k.startswith("fused_"))


def main_path(dev, smi_line):
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
            f"{wall:.2f} s, launches {nonzero(c)}, scheduler launches "
            f"{st['launches']}, misses {st['misses']}")
        return c

    def drive_per_step(label, graphs, need, unroll=16, **kw):
        """``resident=False``: the per-step torch-op dense engine with the
        per-step kernels (``need``: the one this drive must launch), one
        lane through ``run`` or a real pool (per-lane adjacency,
        ``ctx_batched``) through ``run_batch``."""
        reset_counters()
        t = time.perf_counter()
        if len(graphs) == 1:
            g = graphs[0]
            s = ed.enumerate_dense(g.canonical(), device=str(dev),
                                   resident=False, **kw)
            finals = [s]
        else:
            cfg, ctx, s0 = bucket_pool(graphs, dev, resident=False, **kw)
            s = ed.run_batch(ctx, cfg, s0, ctx_batched=True, unroll=unroll)
            finals = [ed._lane(s, i) for i in range(len(graphs))]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        c = counters()
        by_path[label] = {k: by_path.get(label, {}).get(k, 0) + v
                          for k, v in c.items()}
        for g, f in zip(graphs, finals):
            require(bool(ed._done(f)), f"{label}: {g.name} not done")
            got = (int(f.n_max), int(f.cs) % (1 << 32))
            require(got == truth[key(g)], f"{label}: {g.name} n_max/cs "
                                          f"{got} != oracle {truth[key(g)]}")
        steps = max(int(f.steps) for f in finals)
        per_graph.append(dict(graph="+".join(g.name for g in graphs),
                              path=label, steps=steps, wall_s=wall,
                              steps_per_s=steps / wall))
        log(f"  {label} {'+'.join(g.name for g in graphs)}: = oracle, "
            f"{wall:.2f} s, launches {nonzero(c)}")
        require(c[need] > 0, f"{need} not launched: {label}")

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
    k1 = "fused_check_packed"
    drive_per_step("resident=False run unicode-like", [bench["unicode-like"]],
                   k1, unroll=1)
    # depth cut: corp-leadership takes ucforum-like's lane in this pool,
    # so the bucket is 64 x 256 (ucforum-like's 38,853 per-step engine
    # steps cost ~170 s on the card)
    drive_per_step("resident=False run_batch 64x256 unicode+corp",
                   [bench["unicode-like"], bench["corp-leadership"]], k1)
    drive_per_step("resident=False run_batch 512x2048 dblp+corp",
                   [bench["dblp-like"], bench["corp-leadership"]], k1)

    # slice 2: the compact engine (K4 prefix + K1 prefix2 through K6 on
    # the kernel path, K5 gathered on the unfused path)
    compact_kernels = ("fused_select_gathered_prefix",
                       "fused_check_gathered_prefix2")
    c = drive("compact stream", MBEOptions(engine="compact"), stream)
    for k in compact_kernels:
        require(c[k] > 0, f"{k} not launched on the compact stream")
    c = drive("compact bench spc=16",
              MBEOptions(engine="compact", steps_per_call=16),
              [bench["unicode-like"], bench["dblp-like"]], one_by_one=True)
    for k in compact_kernels:
        require(c[k] > 0, f"{k} not launched (compact spc=16)")
    c = drive("compact unfused impl=pallas",
              MBEOptions(engine="compact", kernel_impl="jnp", impl="pallas"),
              stream)
    require(c["intersect_count"] > 0 and k4_k1_launches(c) == 0,
            f"compact unfused impl=pallas: launches {nonzero(c)}")
    # the dense paths K4 packed and K5 unblock
    label = "dense deg_nocache resident=False"
    drive_per_step(label, [bench["unicode-like"]], "fused_select_packed",
                   order_mode="deg_nocache")
    drive_per_step(label, [bench["dblp-like"], bench["corp-leadership"]],
                   "fused_select_packed", order_mode="deg_nocache")
    drive_per_step("dense unfused impl=pallas", [bench["unicode-like"]],
                   "intersect_count", kernel_impl="jnp", impl="pallas")
    for row in per_graph:
        log("  per-graph " + json.dumps(row))
    big_lane_path(dev, by_path, truth)
    mesh_path(dev, by_path, truth)
    serving_path(dev, by_path, truth, smi_line)
    return by_path


# ---------------------------------------------------------------------------
# phase 4 (slice 11): the work-stealing big lane, the mce and count engines
# ---------------------------------------------------------------------------

# random_unipartite (n, p, seed) of the mce / count streams; the last one
# also goes through the big lane
UNI_STREAM = ((24, 0.3, 24), (32, 0.3, 32), (40, 0.3, 40), (48, 0.3, 48))
UNI_BIG = (64, 0.3, 64)
COUNT_PQ = ((2, 2), (2, 3))


def gate_workers(cfg, dev, cap: int) -> int:
    """The largest worker count (up to ``cap``) whose stacked state the
    K3 pool gate admits."""
    from repro_torch.core import engine_dense as ed
    lo, hi = 1, cap
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if ed.pool_lanes(cfg, mid, dev) == mid:
            lo = mid
        else:
            hi = mid - 1
    return lo


def busy_brief(busy) -> dict:
    """``big_busy_per_worker`` in full for up to 32 workers, else its
    spread."""
    if len(busy) <= 32:
        return dict(busy_per_worker=busy)
    return dict(busy_min=min(busy), busy_max=max(busy),
                busy_mean=sum(busy) / len(busy), workers=len(busy))


def big_lane_path(dev, by_path, truth):
    """The slice-11 drives, each with the launch counters set to 0 just
    before it and read just after, every result against the port's NumPy
    oracles: the dense big lane (K3 on one shared adjacency) on dblp-like
    and dblp-large at 4 workers and at the largest count the pool gate
    admits, each also without work stealing (the same totals); the
    compact engine through the big lane (K4 prefix + K1 prefix2); the
    mce engine served fused (K4 packed) and unfused with
    ``impl="pallas"`` (K5) and through the big lane; the count engine at
    (2, 2) and (2, 3) served and through the big lane; and
    ``launch/mbe_run.py`` at the bench default."""
    import torch
    from repro_torch import MBEClient, MBEOptions
    from repro_torch.baselines.oracles import (count_pq_bicliques,
                                               enumerate_maximal_cliques)
    from repro_torch.data.generators import dataset_suite, random_unipartite
    from repro_torch.launch import mbe_run
    from repro_torch.serving.buckets import BucketPolicy, plan_bucket
    bench = dataset_suite("bench")
    large = dataset_suite("large")

    def drive(label, opts, graphs, want, need):
        """``want(g, result)`` -> (got, expected); ``need``: the kernels
        this drive must launch."""
        reset_counters()
        client = MBEClient(opts)
        t = time.perf_counter()
        res = client.enumerate_many(graphs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        by_path[label] = c = counters()
        for g, r in zip(graphs, res):
            require(r.status == "done", f"{label}: {g.name} {r.status}")
            got, exp = want(g, r)
            require(got == exp, f"{label}: {g.name} {got} != oracle {exp}")
        for k in need:
            require(c[k] > 0, f"{k} not launched: {label}")
        st = client.stats()
        row = dict(path=label, graphs=[g.name for g in graphs],
                   steps=sum(r.steps for r in res), wall_s=wall,
                   rounds=st["batches"], launches=nonzero(c),
                   scheduler_launches=st["launches"])
        if opts.big_graph_threshold is not None:
            row.update(big_imbalance=st["big_imbalance"],
                       **busy_brief(st["big_busy_per_worker"]))
        log("  slice11 " + json.dumps(row))
        return res

    def mbe(g, r):
        return (r.n_max, r.cs), truth[key(g)]

    # the dense big lane: K3 over the workers on one shared adjacency
    for g in (bench["dblp-like"], large["dblp-large"]):
        cfg = plan_bucket(g.canonical(), BucketPolicy()).engine_config()
        w_max = gate_workers(cfg, dev, cap=g.canonical().n_u)
        log(f"  big lane {g.name}: the K3 pool gate admits {w_max} workers "
            f"at most up to its {g.canonical().n_u} root tasks (a worker "
            f"past the root count never holds a task)")
        for workers in (4, w_max):
            totals = []
            for ws in (True, False):
                r = drive(f"big lane {g.name} x{workers} ws={ws}",
                          MBEOptions(big_graph_threshold=1,
                                     big_workers=workers, work_stealing=ws),
                          [g], mbe, ["resident_pool"])[0]
                totals.append((r.n_max, r.cs, r.nodes))
            require(totals[0] == totals[1],
                    f"big lane {g.name} x{workers}: work_stealing=False "
                    f"totals {totals[1]} != {totals[0]}")
    # the compact engine through the big lane
    drive("big lane compact unicode-like",
          MBEOptions(engine="compact", big_graph_threshold=1),
          [bench["unicode-like"]], mbe,
          ["fused_select_gathered_prefix", "fused_check_gathered_prefix2"])

    # the mce engine: served (K4 packed; K5 unfused) and the big lane
    uni = [random_unipartite(n, p, seed=sd) for n, p, sd in UNI_STREAM]
    big = [random_unipartite(*UNI_BIG[:2], seed=UNI_BIG[2])]
    cliques = {g.name: enumerate_maximal_cliques(g) for g in uni + big}

    def mce(g, r):
        return ((r.n_max, sorted(r.cliques)),
                (len(cliques[g.name]), cliques[g.name]))

    kw = dict(engine="mce", collect=True, collect_cap=1024)
    drive("mce stream", MBEOptions(**kw), uni, mce, ["fused_select_packed"])
    drive("mce stream unfused impl=pallas",
              MBEOptions(kernel_impl="jnp", impl="pallas", **kw), uni, mce,
              ["intersect_count"])
    require(k4_k1_launches(by_path["mce stream unfused impl=pallas"]) == 0,
            "mce unfused launched a fused_select / fused_check kind")
    drive("mce big lane", MBEOptions(big_graph_threshold=1, **kw), big,
          mce, ["fused_select_packed"])

    # the count engine (no kernel on its path): served and the big lane
    for p, q in COUNT_PQ:
        def count(g, r, p=p, q=q):
            return r.count, count_pq_bicliques(g, p, q)
        kw = dict(engine="count", count_p=p, count_q=q)
        drive(f"count ({p}, {q}) stream", MBEOptions(**kw), uni, count, [])
        drive(f"count ({p}, {q}) big lane",
              MBEOptions(big_graph_threshold=1, **kw), big, count, [])

    # the paper's own entry point at the bench default
    reset_counters()
    t = time.perf_counter()
    out = mbe_run.main(["--dataset", "marvel-like", "--workers", "4"])
    torch.cuda.synchronize()
    by_path["mbe_run marvel-like"] = c = counters()
    exp = truth[key(bench["marvel-like"])][0]
    require(out["n_max"] == exp,
            f"mbe_run marvel-like: n_max {out['n_max']} != oracle {exp}")
    require(c["resident_pool"] > 0, "resident_pool not launched: mbe_run")
    log("  slice11 " + json.dumps(dict(
        path="mbe_run marvel-like", wall_s=time.perf_counter() - t,
        rounds=out["rounds"], imbalance=out["imbalance"],
        launches=nonzero(c))))


# ---------------------------------------------------------------------------
# phase 4 (slice 15): lane pools and the big lane over a mesh of devices
# ---------------------------------------------------------------------------

# shards of the rehearsal mesh on a one-card machine (cuda:0 named four
# times); a machine with several cards serves on every one of them
REHEARSAL_SHARDS = 4
# the compact engine on the mesh serves the 32-graph stream's graphs of
# the buckets up to 16 x 32 (13 graphs, each bucket with at least one
# lane a shard): depth cut, since the per-step compact engine runs the
# shards one after another (the whole stream alone takes 36-55 s on one
# card, PERF.md)
MESH_COMPACT_BUCKET = (16, 32)
MESH_BIG_WPD = (1, 4)


def serving_mesh(dev):
    """``mbe_serve_mesh()`` over every visible card; on one card the
    rehearsal mesh that names it REHEARSAL_SHARDS times."""
    import torch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding.axes import MBE_LANE_AXIS, mbe_serve_mesh
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        mesh = mbe_serve_mesh()
        log(f"  serving mesh: {n_cards} cards {[str(d) for d in mesh.devices]}")
        return mesh, n_cards
    log(f"  rehearsal mesh: {REHEARSAL_SHARDS} shards on 1 card ({dev})")
    return Mesh([dev] * REHEARSAL_SHARDS, (MBE_LANE_AXIS,)), 1


def track_device_busy(executor, n_shards):
    """Wrap ``executor.run_round`` to sum every round's per-lane steps by
    shard (lane ``i`` on shard ``i // wpd``); returns the running sums."""
    import numpy as np
    busy = np.zeros(n_shards, np.int64)
    inner = executor.run_round

    def run_round(pool, cache, budget, unroll=1):
        tel = inner(pool, cache, budget, unroll)
        busy[:] += tel.adv.reshape(n_shards, -1).sum(axis=1)
        return tel
    executor.run_round = run_round
    return busy


def kernel_overlap(prof, name_part):
    """Of the kernels whose name holds ``name_part`` in a profiler
    window: {device index: launches}, the time (us) a launch on one card
    ran while a launch on another card was still running (summed over
    launches), and their device time (us)."""
    import torch
    spans = sorted((e.time_range.start, e.time_range.end, e.device_index)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and name_part in e.name)
    per_dev, last_end, overlap = {}, {}, 0.0
    for t0, t1, d in spans:
        per_dev[d] = per_dev.get(d, 0) + 1
        others = [e for k, e in last_end.items() if k != d]
        if others:
            overlap += max(0.0, min(max(others), t1) - t0)
        last_end[d] = max(last_end.get(d, t0), t1)
    return per_dev, overlap, sum(t1 - t0 for t0, t1, _ in spans)


def mesh_path(dev, by_path, truth):
    """The slice-15 drives over a mesh (every visible card, or the
    rehearsal mesh on one card), each with the launch counters set to 0
    just before it and read just after, every result against the oracle:
    the 32-graph stream through ``ShardedExecutor`` (dense default, K3 a
    shard; dense ``resident_lanes=0``, K2; compact on its graphs of the
    buckets up to MESH_COMPACT_BUCKET, K4 prefix + K1 prefix2); the big
    lane on
    dblp-like and dblp-large at MESH_BIG_WPD workers a device, stealing
    on and off, totals and busy steps per worker equal to the local big
    lane's at the same worker count; ``mbe_run`` on marvel-like with 4
    workers a device.  Every drive logs its wall time, rounds, launches,
    imbalance and busy steps per device and needs every device's workers
    to have advanced; on two or more cards a profiler window over a big
    lane drive needs K3 launches on every card, and at steps_per_call=16
    two cards running K3 at once."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import MBEClient, MBEOptions
    from repro_torch.data.generators import (dataset_suite,
                                             random_graph_stream)
    from repro_torch.launch import mbe_run
    from repro_torch.serving.buckets import BucketPolicy, plan_bucket
    t_phase = time.perf_counter()
    mesh, n_cards = serving_mesh(dev)
    n = mesh.size
    bench = dataset_suite("bench")
    large = dataset_suite("large")
    stream = random_graph_stream(32, seed=0)
    walls = {}

    def sync():
        for d in dict.fromkeys(mesh.devices):
            torch.cuda.synchronize(d)

    def drive(label, opts, graphs, need, big=False, shards=n):
        reset_counters()
        client = MBEClient(opts)
        busy_dev = track_device_busy(client.server.executor, shards)
        t = time.perf_counter()
        res = client.enumerate_many(graphs)
        sync()
        wall = time.perf_counter() - t
        by_path[label] = c = counters()
        check_results(res, graphs, truth, label)
        for k in need:
            require(c[k] > 0, f"{k} not launched: {label}")
        st = client.stats()
        row = dict(path=label, graphs=len(graphs), wall_s=wall,
                   rounds=st["batches"], launches=nonzero(c),
                   scheduler_launches=st["launches"])
        if big:
            per_w = np.asarray(st["big_busy_per_worker"], np.int64)
            busy_dev = per_w.reshape(shards, -1).sum(axis=1)
            row.update(big_imbalance=st["big_imbalance"],
                       **busy_brief(st["big_busy_per_worker"]))
        row["busy_per_device"] = busy_dev.tolist()
        require((busy_dev > 0).all(),
                f"{label}: a device's workers never advanced: "
                f"{busy_dev.tolist()}")
        log("  slice15 " + json.dumps(row))
        walls[label] = wall
        return res, st

    mopts = dict(mesh=mesh)
    drive("mesh stream", MBEOptions(**mopts), stream, ["resident_pool"])
    drive("mesh resident_lanes=0 stream",
          MBEOptions(resident_lanes=0, **mopts), stream, ["resident_step"])
    small = [g for g in stream
             if plan_bucket(g.canonical(), BucketPolicy()).n_u
             <= MESH_COMPACT_BUCKET[0]
             and plan_bucket(g.canonical(), BucketPolicy()).n_v
             <= MESH_COMPACT_BUCKET[1]]
    drive("mesh compact stream", MBEOptions(engine="compact", **mopts),
          small,
          ["fused_select_gathered_prefix", "fused_check_gathered_prefix2"])

    # the big lane over the mesh against the local one at the same count
    for g in (bench["dblp-like"], large["dblp-large"]):
        for wpd in MESH_BIG_WPD:
            workers = n * wpd
            (lr,), lst = drive(f"local big lane {g.name} x{workers}",
                               MBEOptions(big_graph_threshold=1,
                                          big_workers=workers,
                                          device=str(dev)),
                               [g], ["resident_pool"], big=True, shards=1)
            for ws in (True, False):
                (r,), st = drive(
                    f"mesh big lane {g.name} {n}x{wpd} ws={ws}",
                    MBEOptions(big_graph_threshold=1, workers_per_device=wpd,
                               work_stealing=ws, **mopts),
                    [g], ["resident_pool"], big=True)
                require((r.n_max, r.cs, r.nodes) ==
                        (lr.n_max, lr.cs, lr.nodes),
                        f"mesh big lane {g.name} {n}x{wpd} ws={ws}: totals "
                        f"{(r.n_max, r.cs, r.nodes)} != local "
                        f"{(lr.n_max, lr.cs, lr.nodes)}")
                # the same deal and the same steals: the same workers' work
                require(not ws or st["big_busy_per_worker"] ==
                        lst["big_busy_per_worker"],
                        f"mesh big lane {g.name} {n}x{wpd}: busy steps per "
                        f"worker differ from the local lane's")

    # the paper's entry point on the mesh
    reset_counters()
    made = []

    class Recorded(MBEClient):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
    mbe_run.MBEClient = Recorded
    try:
        t = time.perf_counter()
        out = mbe_run.main(["--dataset", "marvel-like", "--workers", "4"],
                           mesh=mesh)
        sync()
        wall = time.perf_counter() - t
    finally:
        mbe_run.MBEClient = MBEClient
    by_path["mesh mbe_run marvel-like"] = c = counters()
    exp = truth[key(bench["marvel-like"])][0]
    require(out["n_max"] == exp,
            f"mesh mbe_run marvel-like: n_max {out['n_max']} != oracle {exp}")
    require(c["resident_pool"] > 0, "resident_pool not launched: mesh mbe_run")
    st = made[0].stats()
    busy_dev = np.asarray(st["big_busy_per_worker"]).reshape(n, -1).sum(1)
    require((busy_dev > 0).all(), f"mesh mbe_run: a device's workers never "
                                  f"advanced: {busy_dev.tolist()}")
    require(st["executor"] == "sharded", f"mesh mbe_run: {st['executor']}")
    walls["mesh mbe_run marvel-like"] = wall
    log("  slice15 " + json.dumps(dict(
        path="mesh mbe_run marvel-like", wall_s=wall, rounds=out["rounds"],
        imbalance=out["imbalance"], launches=nonzero(c),
        busy_per_device=busy_dev.tolist())))

    if n_cards > 1:
        # lockstep across cards, one profiler window a drive over the big
        # lane: K3 on every card; at spc=1 a K3 segment (~5 us) is shorter
        # than the host's gap between two launches, so the cards can only
        # run at once with longer segments (logged at 1, required at 16)
        g = large["dblp-large"]
        overlap = {}
        for spc in (1, 16):
            client = MBEClient(MBEOptions(big_graph_threshold=1,
                                          workers_per_device=4,
                                          steps_per_call=spc, **mopts))
            sync()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                time.sleep(PROFILE_SETTLE_S)
                t = time.perf_counter()
                r = client.enumerate(g)
                sync()
                wall = time.perf_counter() - t
            check_results([r], [g], truth, f"mesh profiled big lane spc={spc}")
            per_dev, overlap[spc], busy = kernel_overlap(prof, "resident_pool")
            log("  slice15 " + json.dumps(dict(
                path=f"mesh profiled big lane dblp-large spc={spc}",
                wall_s=wall, k3_by_device=per_dev, k3_busy_us=busy,
                overlap_us=overlap[spc])))
            require(sorted(per_dev) == list(range(n_cards)),
                    f"K3 launches by card {per_dev}: not on every card")
        require(overlap[16] > 0, "no two cards ran K3 at once (spc=16)")
    log(f"  slice15 mesh phase {time.perf_counter() - t_phase:.1f} s on "
        f"{n} shard(s) of {n_cards} card(s); walls "
        + json.dumps({k: round(v, 3) for k, v in walls.items()}))


# ---------------------------------------------------------------------------
# phase 4 (slice 12): the serving layer under SLO and faults
# ---------------------------------------------------------------------------

# the chaos stream: random_graph_stream(CHAOS_N, seed 0) in lane pools
# (canonical n_u 6-25) and dblp-like (n_u 512) alone on the big lane
CHAOS_N = 24
CHAOS_POLICY = dict(steps_per_round=64, big_graph_threshold=512)
# the chaos plan's rates (launch faults, corrupted done-mask reads); its
# device loss and poisoned install are placed from the fault-free run
CHAOS_SEED = 12
CHAOS_RATES = dict(launch_rate=0.15, corrupt_done_rate=0.1)


def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def chaos_drive(server, *, stop_after_failover=False):
    """Poll ``server`` until it drains (or, with ``stop_after_failover``,
    until the poll that failed over); returns its results and what the
    poll that failed over saw: the devices of the pools the new executor
    built and the launch counts at that moment."""
    got, seen = {}, None
    while server.has_work():
        got.update(server.poll())
        if seen is None and server.stats()["failovers"]:
            seen = dict(counts=counters(), pool_devices=sorted(
                {str(p.pool.state.lvl.device)
                 for p in server._pools.values()}),
                executor_device=str(server.executor.device))
            if stop_after_failover:
                break
    sync(server.executor.device)
    return got, seen


def on_device(seen, dev) -> bool:
    """Whether the poll that failed over left the new executor and every
    pool it built on ``dev``'s kind of device (and built one at all)."""
    return (seen is not None and bool(seen["pool_devices"])
            and seen["executor_device"].startswith(dev.type)
            and all(d.startswith(dev.type) for d in seen["pool_devices"]))


def fault_schedule(graphs, policy, dev):
    """Where the chaos plan's poisoned install and device loss go, from
    a fault-free run behind an injector with no faults: the lane install
    half the way through the installs (k), and the launch half the way
    from that install to the last pool round (N), while lane requests are
    still in flight."""
    from repro_torch.serving import (FaultInjector, FaultPlan,
                                     LocalExecutor, MBEServer)
    ex = FaultInjector(LocalExecutor(device=str(dev)), FaultPlan())
    installs, pool_rounds = [], []
    real_install, real_round = ex.install, ex.run_round

    def install(pool, idx, states, ctxs):
        installs.extend([ex._launches] * len(idx))
        return real_install(pool, idx, states, ctxs)

    def run_round(pool, cache, budget, unroll=1):
        pool_rounds.append(ex._launches)
        return real_round(pool, cache, budget, unroll)
    ex.install, ex.run_round = install, run_round
    srv = MBEServer(policy, executor=ex)
    for g in graphs:
        srv.admit(g)
    srv.drain()
    k = len(installs) // 2
    return k, installs[k - 1] + (pool_rounds[-1] - installs[k - 1]) // 2


def chaos_mismatches(base, chaos, poisoned) -> list:
    """The rids whose chaos payload differs from the fault-free run's
    (every field but the measured ``*_s``), the poisoned ones left out."""
    def payload(r):
        return {k: getattr(r, k) for k in r.__dataclass_fields__
                if not k.endswith("_s")}
    return [rid for rid in base if rid not in poisoned
            and payload(base[rid]) != payload(chaos[rid])]


def serving_path(dev, by_path, truth, smi_line):
    """The slice-12 drives, each with the launch counters set to 0 just
    before it and read just after: ``serve --mbe`` on the card (defaults
    with --continuous, and --engine mce) against the oracles; the chaos
    stream (retries, corrupted done-mask reads, a device loss with a
    failover and checkpoint resume, a poisoned install isolated by
    quarantine) against the fault-free run of the same stream, twice
    with the same plan (the same injector log), with the retry-off and
    retry-on walls in turns; a traced stream under backpressure and
    shed-on-deadline, with the cost model calibrated from its trace and
    its replay beside the measurement; and two planted faults the checks
    must flag (one bit flipped in a snapshot's word leaf, a failover
    onto the CPU)."""
    from repro_torch import MBEClient, MBEOptions
    from repro_torch.baselines.oracles import enumerate_maximal_cliques
    from repro_torch.data.generators import (dataset_suite,
                                             random_graph_stream)
    from repro_torch.launch import serve as t_serve
    from repro_torch.serving import (BucketPolicy, FaultPlan,
                                     LocalExecutor, MBEServer, RetryPolicy,
                                     plan_bucket, scheduler)
    from repro_torch.serving.faults import fingerprint
    from repro_torch.serving.slo import (AdmissionPolicy, TraceReader,
                                         compare_trace, replay)
    t_all = time.perf_counter()

    # 1. serve --mbe on the card
    for label, argv, need in (
            ("serve --mbe --continuous", ["--continuous"],
             "resident_pool"),
            ("serve --mbe --engine mce", ["--engine", "mce"],
             "fused_select_packed")):
        reset_counters()
        out = t_serve.serve(["--mbe", *argv], device=str(dev))
        sync(dev)
        by_path[label] = c = counters()
        engine = "mce" if "mce" in argv else "dense"
        graphs = t_serve._request_stream(engine, out["requests"], 0)
        for g, r in zip(graphs, out["results"]):
            require(r.status == "done", f"{label}: {g.name} {r.status}")
            if engine == "mce":
                exp = len(enumerate_maximal_cliques(g))
                require(r.n_max == exp, f"{label}: {g.name} n_max "
                                        f"{r.n_max} != oracle {exp}")
            else:
                require((r.n_max, r.cs) == truth[key(g)],
                        f"{label}: {g.name} {(r.n_max, r.cs)} != oracle "
                        f"{truth[key(g)]}")
        require(c[need] > 0, f"{need} not launched: {label}")
        log("  slice12 " + json.dumps(dict(
            path=label, wall_s=out["wall_s"], rounds=out["batches"],
            metric=out["metric"], launches=nonzero(c))))

    # 2. the chaos stream
    graphs = [*random_graph_stream(CHAOS_N, seed=0),
              dataset_suite("bench")["dblp-like"]]
    policy = BucketPolicy(**CHAOS_POLICY)

    def server(retry=None, plan=None, **kw):
        srv = MBEServer(policy, retry=retry, fault_injector=plan,
                        executor=LocalExecutor(device=str(dev)), **kw)
        for g in graphs:
            srv.admit(g)
        return srv

    retry = RetryPolicy(max_attempts=4, checkpoint_interval=2)
    walls, runs = {}, {}
    # no faults, the retry policy off and on, in turns: what the verified
    # reads and the checkpoints cost
    for label in ("retry off", "retry on", "retry on", "retry off"):
        reset_counters()
        srv = server(retry if label == "retry on" else None)
        t = time.perf_counter()
        got, _ = chaos_drive(srv)
        walls.setdefault(label, []).append(time.perf_counter() - t)
        by_path[f"chaos stream {label}"] = counters()
        runs[label] = (srv, got)
    base_srv, base = runs["retry off"]
    st = base_srv.stats()
    for rid, g in enumerate(graphs):
        require(base[rid].status == "done"
                and (base[rid].n_max, base[rid].cs) == truth[key(g)],
                f"chaos stream fault-free: {g.name} != oracle")
    require(by_path["chaos stream retry off"]["resident_pool"] > 0,
            "resident_pool not launched on the chaos stream")
    k, n = fault_schedule(graphs, policy, dev)
    plan = FaultPlan(seed=CHAOS_SEED, device_lost_after=n,
                     poison_nth_install=k, **CHAOS_RATES)
    restores = []
    real_restore = scheduler.restore_state

    def counted_restore(state, device):
        restores.append(str(device))
        return real_restore(state, device)
    scheduler.restore_state = counted_restore
    try:
        logs = []
        for rep in range(2):
            reset_counters()
            srv = server(retry, plan)
            t = time.perf_counter()
            chaos, seen = chaos_drive(srv)
            walls.setdefault("chaos", []).append(
                time.perf_counter() - t)
            by_path["chaos stream faults"] = c = counters()
            logs.append([i.log for i in srv._injectors])
            if rep == 0:
                first = (srv, chaos, seen, c, list(restores))
    finally:
        scheduler.restore_state = real_restore
    srv, chaos, seen, c, restored = first
    cs_ = srv.stats()
    poison_fps = srv._injectors[0]._poison_fps

    def poisoned_rids(server):
        out = []
        for rid, g in enumerate(graphs):
            gc = g.canonical()
            cfg = server._engine_config(plan_bucket(gc, server.policy))
            if fingerprint(server.engine.make_context(gc, cfg, dev)) \
                    in poison_fps:
                out.append(rid)
        return out
    poisoned = poisoned_rids(srv)
    failed = [rid for rid, r in chaos.items() if r.status == "failed"]
    require(len(poisoned) == 1 and failed == poisoned,
            f"chaos: failed {failed}, poisoned {poisoned}")
    bad = chaos_mismatches(base, chaos, poisoned)
    require(not bad, f"chaos: rids {bad} differ from the fault-free run")
    require(cs_["failovers"] == 1, f"chaos: failovers {cs_['failovers']}")
    require(on_device(seen, dev), f"chaos: after the failover {seen}")
    k3_after = c["resident_pool"] - seen["counts"]["resident_pool"]
    require(k3_after > 0, "chaos: no K3 launch after the failover")
    require(restored and all(d.startswith(dev.type) for d in restored),
            f"chaos: checkpoint restores {restored}")
    require(logs[0] == logs[1], "chaos: the same plan gave another "
                                "injector log")
    log("  slice12 " + json.dumps(dict(
        path="chaos stream faults", graphs=len(graphs),
        plan=dataclasses.asdict(plan), poisoned_rid=poisoned[0],
        retries=cs_["retries"], faults_injected=cs_["faults_injected"],
        checkpoints=cs_["checkpoints"], quarantined=cs_["quarantined"],
        failovers=cs_["failovers"], restores=len(restored),
        k3_after_failover=k3_after, pool_devices=seen["pool_devices"],
        launches=nonzero(c), log_entries=len(logs[0][0]))))
    log(f"  slice12 walls (s, same call, turns off/on/on/off): "
        f"{json.dumps(walls)} on {smi_line}")

    # 3. SLO on the card: a traced stream under backpressure and
    # shed-on-deadline (the kernels were built and warmed above)
    trace = os.path.join(HERE, "build", "slice12_trace.jsonl")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    stream = random_graph_stream(32, seed=0)
    reset_counters()
    client = MBEClient(MBEOptions(
        steps_per_round=64, trace_path=trace, device=str(dev),
        admission=AdmissionPolicy(max_pending=8, shed_on_deadline=True)))
    futs = []
    for i, g in enumerate(stream):
        # waves of 16 with a poll between (the queue outgrows 8 pending);
        # every fourth request asks for an impossible 100 us, the rest
        # for a minute or nothing
        futs.append(client.submit(g, deadline_s=(1e-4 if i % 4 == 1 else
                                                 60.0 if i % 4 == 2
                                                 else None)))
        if i % 16 == 15:
            client.poll()
    client.drain()
    sync(dev)
    client.server.close_trace()
    by_path["slo traced stream"] = c = counters()
    res = [f.result() for f in futs]
    reader = TraceReader(trace)
    st = client.stats()
    admitted = [r for r in reader.requests if r.admitted]
    require(st["rejected"] > 0 and st["shed"] > 0
            and st["rejected_backpressure"] > 0,
            f"slo: rejections {st['rejected']} (shed {st['shed']}, "
            f"backpressure {st['rejected_backpressure']})")
    for g, r in zip(stream, res):
        if r.rejected:
            require(r.status == "rejected" and r.steps == 0,
                    f"slo: {g.name} rejected as {r.status}")
        else:
            require(r.status == "done" and (r.n_max, r.cs) == truth[key(g)],
                    f"slo: {g.name} {r.status} {(r.n_max, r.cs)}")
    results = [e for e in reader.events if e["event"] == "result"]
    require(sorted(e["rid"] for e in results) == list(range(len(stream)))
            and all(a.status is not None for a in admitted),
            "slo: a request has no result event, or more than one")
    require(c["resident_pool"] > 0, "resident_pool not launched: slo")
    cost = reader.cost_model()
    rep = replay(reader.requests, BucketPolicy(steps_per_round=64), cost,
                 polls=reader.polls())
    cmp = compare_trace(reader.requests, rep)
    log("  slice12 " + json.dumps(dict(
        path="slo traced stream", admitted=st["admitted"],
        rejected=st["rejected"], shed=st["shed"],
        backpressure=st["rejected_backpressure"],
        cost_from_trace=dict(steps_per_s=cost.steps_per_s,
                             service_steps_per_s=cost.service_steps_per_s,
                             compile_s=cost.compile_s,
                             step_density=cost.step_density),
        measured_mean_latency_s=cmp["measured_mean_latency_s"],
        predicted_mean_latency_s=cmp["predicted_mean_latency_s"],
        latency_ratio=cmp["latency_ratio"], launches=nonzero(c))))

    # 4. planted faults the checks must flag
    # (a) one bit of the cs word of one snapshot, flipped just before the
    # failover: that request's payload must differ from the fault-free one
    flipped = []
    srv = server(retry, plan)
    real_failover = srv._failover

    def failover_with_flip(err):
        for rid in srv._ckpt.rids():
            snap = srv._ckpt.get(rid).state
            snap.cs[...] ^= 1 << 7
            flipped.append(rid)
            break
        real_failover(err)
    srv._failover = failover_with_flip
    planted, _ = chaos_drive(srv)
    require(flipped, "planted snapshot flip: no snapshot before failover")
    bad = chaos_mismatches(base, planted, poisoned)
    require(flipped[0] in bad, f"planted snapshot flip on rid "
                               f"{flipped[0]} not flagged (mismatches {bad})")
    # (b) the failover pointed at a CPU executor: the device check must
    # flag it (stopped at the poll that failed over)
    srv = server(retry, plan, failover_executor=LocalExecutor(device="cpu"))
    _, seen = chaos_drive(srv, stop_after_failover=True)
    require(not on_device(seen, dev),
            f"planted CPU failover not flagged: {seen}")
    log(f"  slice12 planted faults flagged: snapshot bit flip on rid "
        f"{flipped[0]} (mismatches {bad}), CPU failover ({seen}); "
        f"[slice12] {time.perf_counter() - t_all:.1f} s")


# ---------------------------------------------------------------------------
# phase 4 (LM): qwen3-1.7b prefill and decode at full width
# ---------------------------------------------------------------------------

LM_ARCH = "qwen3-1.7b"
# prefill_32k (models/config.py SHAPES) with its batch cut from 32 to 1 for
# time, and a 4 x 4096 batch
LM_PREFILL = ((1, 32_768), (4, 4_096))
# the served loop at the reference serve()'s defaults
LM_SERVE = ["--arch", LM_ARCH, "--slots", "4", "--requests", "8",
            "--prompt-len", "16", "--max-new", "24", "--max-seq", "128"]
# bf16 logits of the K7 path against the blockwise torch-op path
# (attn_impl='xla'), both from ``M.forward`` at every position.  The two
# paths round p and o differently in every layer's attention (~2^-8
# relative) and 28 layers carry that into the logits (~N(0, 1) at random
# init: RMS-normed hidden state times a 1/sqrt(d) lm head).  Two limits:
# the last position's max |dlogit| (what prefill returns) and, at every
# position, ||dlogit|| / ||logit||.  At the last position of a long
# prompt the attention output is a mean over thousands of keys and
# barely moves the residual stream, so the per-position limit, which
# sees the early positions too, is the one a K7 fault has to pass; a
# planted fault (K7 reading misplaced late V tiles in every layer) must
# fail it.  Readings on the card (PERF.md, PR 13), sound against
# planted fault: last position 0.09-0.11 against 3.8-4.0, every position
# 0.025-0.026 against 0.86-0.92.
LM_LOGIT_TOL = 0.25
LM_LOGIT_RTOL = 0.1
# decode == prefill in fp32: tests/test_archs.py:67
LM_DECODE_TOL = 2e-3


@contextlib.contextmanager
def k7_held(fault=None):
    """Hold every K7 call that the model makes inside the block against
    ``flash_fwd_ref`` on its first and last K7_SPAN query rows; yields
    the list of ``k7_errors``, one per call.  ``fault`` (a control)
    rewrites the V operand the kernel gets, not the one it is held to."""
    from repro_torch.kernels.flash_attention import ops
    real, seen = ops._fwd, []

    def held(q, k, v, causal, scale):
        o, saved = real(q, k, v if fault is None else fault(v, axis=1),
                        causal, scale)
        qp, kp, vp = (x.contiguous() for x in ops._pack(q, k, v))
        S = q.shape[1]
        seen.append(k7_errors(
            qp, kp, vp, saved[3], saved[4], causal=causal,
            scale=q.shape[-1] ** -0.5 if scale is None else scale, sq=S,
            sk=k.shape[1], spans=k7_spans(S, "ends")))
        return o, saved
    ops._fwd = held
    try:
        yield seen
    finally:
        ops._fwd = real


def worst_k7(seen) -> dict:
    return dict(calls=len(seen), abs=max(e["abs"] for e in seen),
                bad=sum(e["bad"] for e in seen),
                row=max(e["row"] for e in seen),
                lse=max(e["lse"] for e in seen),
                finite=all(e["finite"] for e in seen))


def logit_errors(lp, lx, chunk=1024) -> dict:
    """Logits (B, S, V) of the K7 path against the torch-op path: the max
    over positions of ||lp - lx|| / ||lx|| (and where), its median, and
    the last position's max |dlogit|."""
    import torch
    B, S, _ = lx.shape
    rel = torch.empty(B, S, device=lx.device)
    for a in range(0, S, chunk):
        x, y = lp[:, a:a + chunk].float(), lx[:, a:a + chunk].float()
        rel[:, a:a + chunk] = (x - y).norm(dim=-1) / y.norm(dim=-1)
        del x, y
    return dict(rel=float(rel.max()), rel_at=divmod(int(rel.argmax()), S),
                rel_median=float(rel.median()),
                last_abs=float((lp[:, -1].float() - lx[:, -1].float())
                               .abs().max()))


def lm_held(pal, xla, params, toks, nxt, label) -> dict:
    """The prefill's checks: the K7 path's last-position logits against
    the torch-op path's (max |dlogit|, argmax) and its token; both paths'
    logits at every position; every K7 call held against its plain
    version; then the control, K7 with misplaced late V tiles in every
    layer, which both the kernel check and the logits check must flag."""
    import torch
    from repro_torch.models import model as M
    L = pal.n_layers
    with torch.no_grad():
        lp = M.forward(pal, params, toks, last_only=True)[0][:, -1].float()
        torch.cuda.synchronize()
        t = time.perf_counter()
        lx_all = M.forward(xla, params, toks)[0]
        torch.cuda.synchronize()
        wall_x = time.perf_counter() - t
        with k7_held() as seen:
            lp_all = M.forward(pal, params, toks)[0]
        sound = logit_errors(lp_all, lx_all)
        del lp_all
        with k7_held(late_v_tiles_misplaced) as seen_c:
            lc_all = M.forward(pal, params, toks)[0]
        control = logit_errors(lc_all, lx_all)
        lx = lx_all[:, -1].float()
        del lc_all, lx_all
    k7, k7c = worst_k7(seen), worst_k7(seen_c)
    top2 = lx.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    same = (lp.argmax(-1) == lx.argmax(-1)) | (gap < LM_LOGIT_TOL)
    d = float((lp - lx).abs().max())
    out = dict(xla_wall_s=wall_x, max_dlogit=d, logit_std=float(lx.std()),
               argmax_equal=int((lp.argmax(-1) == lx.argmax(-1)).sum()),
               logits_all=sound, k7_held=k7, control_logits=control,
               control_k7=k7c)
    log(f"  {label}: K7 logits vs torch-op path ({wall_x:.3f} s): last "
        f"position max |dlogit| {d:.4g} (tol {LM_LOGIT_TOL}, logit std "
        f"{out['logit_std']:.3f}), argmax equal {out['argmax_equal']}/"
        f"{len(lx)}; every position: " + json.dumps(sound)
        + f" (tol {LM_LOGIT_RTOL}); K7 calls held: " + json.dumps(k7))
    k7_flagged = not all(k7_ok(e, "bfloat16") for e in seen_c)
    lm_flagged = (control["rel"] > LM_LOGIT_RTOL
                  or control["last_abs"] > LM_LOGIT_TOL)
    log(f"  {label} control (K7 reads misplaced late V tiles): logits "
        + json.dumps(control) + ", K7 calls " + json.dumps(k7c)
        + f"; flagged by the kernel check {k7_flagged}, by the logits "
        f"check {lm_flagged} (last position alone "
        f"{control['last_abs'] > LM_LOGIT_TOL})")
    require(bool(torch.isfinite(lp).all() and torch.isfinite(lx).all()),
            f"{label}: non-finite logits")
    require(torch.equal(nxt.long(), lp.argmax(-1)),
            f"{label}: prefill_step tokens != argmax of its logits")
    require(d <= LM_LOGIT_TOL and bool(same.all()),
            f"{label}: max |dlogit| {d} (tol {LM_LOGIT_TOL}), argmax "
            f"pallas {lp.argmax(-1).tolist()} xla {lx.argmax(-1).tolist()}"
            f" top-2 gaps {gap.tolist()}")
    require(sound["rel"] <= LM_LOGIT_RTOL, f"{label}: logits differ at "
                                           f"some position: {sound}")
    require(k7["calls"] == L and all(k7_ok(e, "bfloat16") for e in seen),
            f"{label}: K7 calls against the plain version: {k7}")
    require(k7_flagged and lm_flagged,
            f"{label}: the planted K7 fault passed (kernel check flagged "
            f"{k7_flagged}, logits check {lm_flagged})")
    return out


def lm_path(dev, by_path):
    """Drive the LM paths; adds each one's launch counts to ``by_path`` and
    returns the measurements phase 5 reports."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M
    from repro_torch.models.layers import init_params
    from repro_torch.training.step import make_prefill_step
    cfg = configs.get_config(LM_ARCH)
    L = cfg.n_layers
    pal = dataclasses.replace(cfg, attn_impl="pallas")
    xla = dataclasses.replace(cfg, attn_impl="xla")
    t0 = time.perf_counter()
    master = init_params(M.param_specs(cfg), 0, device=dev)
    params = M.cast_params(cfg, master)
    torch.cuda.synchronize()
    log(f"  {LM_ARCH}: {cfg.n_params():,} params (fp32 masters + a {cfg.dtype}"
        f" copy), init {time.perf_counter() - t0:.1f} s")
    info = {"prefill": {}}
    prefill = make_prefill_step(pal)
    for B, S in LM_PREFILL:
        toks = torch.randint(0, cfg.vocab, (B, S), device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(S + B))
        batch = dict(tokens=toks)
        label = f"prefill ({B}, {S}) pallas"
        prefill(params, batch)                  # warm-up (cuBLAS plans)
        torch.cuda.synchronize()
        reset_counters()
        t = time.perf_counter()
        nxt = prefill(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        by_path[label] = c = counters()
        require(c["flash_fwd"] == L and sum(c.values()) == L,
                f"{label}: launches {nonzero(c)}, expected {L} flash_fwd")
        log(f"  {label}: {wall:.3f} s ({B * S / wall:,.0f} tok/s), launches "
            f"{nonzero(c)}")
        info["prefill"][f"{B}x{S}"] = dict(
            wall_s=wall, tok_per_s=B * S / wall,
            **lm_held(pal, xla, params, toks, nxt, label))
        if (B, S) == LM_PREFILL[0]:
            # the device's busy share over one prefill call
            pw, busy, by_kernel = profile_window(lambda: prefill(params,
                                                                 batch))
            top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:5]
            k7 = [v for k, v in by_kernel.items() if K7_FWD_KERNEL in k]
            info["profile"] = dict(
                wall_s=pw, busy_s=busy,
                busy_share=None if busy is None else busy / pw,
                # K7's device time per launch at this call's layer shape
                k7_device_ms=sum(v[0] for v in k7) / sum(v[1] for v in k7)
                * 1e3 if k7 else None,
                top=[(k[:60], v[0], v[1]) for k, v in top])
            log(f"  profile {label}: " + json.dumps(info["profile"]))
        del toks, batch, nxt
    del params
    # decode == prefill in fp32 at full width (the forward through K7)
    f32 = dataclasses.replace(pal, dtype="float32")
    B, S = 2, 32
    toks = torch.randint(0, cfg.vocab, (B, S), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(7))
    reset_counters()
    with torch.no_grad():
        full = M.forward(f32, master, toks)[0]
        n_k7 = counters()["flash_fwd"]
        cache = M.init_cache(f32, B, S, device=dev)
        dec = []
        for i in range(S):
            lg, cache = M.decode_step(f32, master, cache, toks[:, i], i)
            dec.append(lg)
    dec = torch.stack(dec, 1)
    by_path["decode == prefill fp32"] = counters()
    err = float((dec - full).abs().max())
    require(n_k7 == L and bool(torch.isfinite(full).all())
            and torch.allclose(dec, full, rtol=LM_DECODE_TOL,
                               atol=LM_DECODE_TOL),
            f"decode != prefill in fp32: max |err| {err}, K7 launches {n_k7}")
    info["decode_err"] = err
    log(f"  decode == prefill fp32 (B={B}, {S} positions): max |err| "
        f"{err:.3g} (tol {LM_DECODE_TOL}), K7 launches {n_k7} (forward)")
    del master, cache, full, dec
    torch.cuda.empty_cache()
    # the served loop, through the user's entry point
    reset_counters()
    out = serve(LM_SERVE, device=str(dev))
    by_path["serve"] = c = counters()
    outs = out["outputs"]
    require(out["tokens"] == 8 * 24 and all(len(v) == 24 for v in
                                            outs.values())
            and all(0 <= t < cfg.padded_vocab for v in outs.values()
                    for t in v),
            f"serve: {out['tokens']} tokens, lengths "
            f"{[len(v) for v in outs.values()]}")
    info["serve"] = {k: out[k] for k in ("tokens", "steps", "decode_calls",
                                         "wall_s", "tok_per_s")}
    log(f"  serve {' '.join(LM_SERVE)}: " + json.dumps(info["serve"])
        + f", launches {nonzero(c)} (K7 {c['flash_fwd']}: decode runs no "
        f"kernel, as in the reference)")
    return info


# ---------------------------------------------------------------------------
# phase 4 (families): the moe, vlm, audio, hybrid and ssm models at full
# width
# ---------------------------------------------------------------------------

# the families' archs; their K7 launches a forward are ``k7_calls``
# (24 / 24 / 48 / 81 // 6 = 13 / 0 at full depth)
FAMILIES = ("granite-moe-1b-a400m", "internvl2-2b", "musicgen-medium",
            "zamba2-7b", "xlstm-1.3b")


def k7_calls(cfg) -> int:
    """K7 calls of one forward: one an attention layer, the hybrid's one
    an application of its shared block, none for ssm."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return 0 if cfg.family == "ssm" else cfg.n_layers


# the prefill: 4096 tokens (internvl2: after its 256 patch rows)
FAMILY_PREFILL = (1, 4_096)
# decode == prefill in fp32: (B, positions)
FAMILY_DECODE = (2, 32)
FAMILY_SERVE = ["--slots", "4", "--requests", "4", "--prompt-len", "16",
                "--max-new", "8", "--max-seq", "64"]


def family_batch(cfg, B, S, dev, seed):
    """tokens (B, S[, n_cb]) and, for vlm, patch_emb (B, n_patch, d) in
    ``cfg.dtype`` (the reference's stub frontend: random rows of 0.02)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    out = dict(tokens=torch.randint(0, cfg.vocab, (B, S) + cb, device=dev,
                                    generator=g))
    if cfg.family == "vlm":
        out["patch_emb"] = (torch.randn(B, cfg.patch_tokens, cfg.d_model,
                                        device=dev, generator=g) * 0.02
                            ).to(getattr(torch, cfg.dtype))
    return out


def family_logits(pal, xla, params, batch, nxt, n_k7, label) -> dict:
    """A family's prefill logits, every position (audio: every codebook's
    too), of the K7 path against the torch-op path, with every K7 call
    held against its plain version; the floor: the torch-op path against
    itself with half its key tile (the same attention summed in another
    order, which is what K7 against the torch-op path is); the limits:
    the qwen3 phase's, or twice the floor where a deep stack carries that
    rounding further (logged); then the control, K7 reading misplaced
    late V tiles in every call, which both checks must flag."""
    import dataclasses
    import torch
    from repro_torch.models import model as M
    pe = batch.get("patch_emb")

    def logits(cfg):
        return M.forward(cfg, params, batch["tokens"], patch_emb=pe)[0]

    with torch.no_grad():
        lx = logits(xla)
        with k7_held() as seen:
            lp = logits(pal)
        require(torch.equal(nxt.long(), lp[:, -1].argmax(-1)),
                f"{label}: prefill_step tokens != argmax of its logits")
        finite = bool(torch.isfinite(lp).all() and torch.isfinite(lx).all())
        # audio: each codebook's logits a position of its own
        lp, lx = lp.flatten(1, -2), lx.flatten(1, -2)
        sound = logit_errors(lp, lx)
        del lp
        half = dataclasses.replace(xla, attn_chunk_k=xla.attn_chunk_k // 2)
        floor = logit_errors(logits(half).flatten(1, -2), lx)
        with k7_held(late_v_tiles_misplaced) as seen_c:
            control = logit_errors(logits(pal).flatten(1, -2), lx)
        del lx
    rtol = max(LM_LOGIT_RTOL, 2 * floor["rel"])
    atol = max(LM_LOGIT_TOL, 2 * floor["last_abs"])
    k7, k7c = worst_k7(seen), worst_k7(seen_c)
    k7_flagged = not all(k7_ok(e, "bfloat16") for e in seen_c)
    lm_flagged = control["rel"] > rtol or control["last_abs"] > atol
    out = dict(sound=sound, floor=floor, rtol=rtol, atol=atol, k7_held=k7,
               control=control, control_k7=k7c)
    log(f"  {label}: logits vs attn_impl='xla': " + json.dumps(sound)
        + f"; floor (xla, key tile {half.attn_chunk_k} vs "
        f"{xla.attn_chunk_k}): " + json.dumps(floor) + f"; limits "
        f"{rtol:.3g} every position, {atol:.3g} last (qwen3's "
        f"{LM_LOGIT_RTOL}, {LM_LOGIT_TOL}, or twice the floor); K7 calls "
        f"held: " + json.dumps(k7))
    log(f"  {label} control (K7 reads misplaced late V tiles): logits "
        + json.dumps(control) + f"; flagged by the kernel check "
        f"{k7_flagged}, by the logits check {lm_flagged}")
    require(finite and sound["rel"] <= rtol and sound["last_abs"] <= atol,
            f"{label}: logits against the torch-op path: {sound} (limits "
            f"{rtol}, {atol}; floor {floor})")
    require(k7["calls"] == n_k7 and all(k7_ok(e, "bfloat16") for e in seen),
            f"{label}: K7 calls against the plain version: {k7}")
    require(k7_flagged and lm_flagged,
            f"{label}: the planted K7 fault passed (kernel check "
            f"{k7_flagged}, logits check {lm_flagged})")
    return out


def families_path(dev, by_path):
    """Each family's full config in turn, its model freed before the
    next: the bf16 prefill through ``make_prefill_step`` with
    attn_impl='pallas' (exactly the table's K7 launches and no other
    kernel; ``family_logits``: logits against attn_impl='xla', every K7
    call against its plain version, a planted K7 fault flagged), decode
    == prefill in fp32 (moe with the capacity raised so that no token
    drops; vlm skipped, as in tests/test_archs.py), and the served loop
    through ``serve``.  Returns the measurements."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M
    from repro_torch.models.layers import init_params
    from repro_torch.training.step import make_prefill_step
    info = {}
    t_phase = time.perf_counter()
    for arch in FAMILIES:
        cfg = configs.get_config(arch)
        n_k7 = k7_calls(cfg)
        t0 = time.perf_counter()
        master = init_params(M.param_specs(cfg), 0, device=dev)
        params = M.cast_params(cfg, master)
        torch.cuda.synchronize()
        r = info[arch] = dict(params=cfg.n_params(),
                              init_s=time.perf_counter() - t0)
        log(f"  {arch} ({cfg.family}): {cfg.n_params():,} params, init "
            f"{r['init_s']:.1f} s")
        pal = dataclasses.replace(cfg, attn_impl="pallas")
        xla = dataclasses.replace(cfg, attn_impl="xla")
        B, S = FAMILY_PREFILL
        batch = family_batch(cfg, B, S, dev, seed=S + B)
        prefill = make_prefill_step(pal)
        prefill(params, batch)                  # warm-up (cuBLAS plans)
        torch.cuda.synchronize()
        label = f"{arch} prefill ({B}, {S}) pallas"
        reset_counters()
        t = time.perf_counter()
        nxt = prefill(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        by_path[label] = c = counters()
        require(c["flash_fwd"] == n_k7 and sum(c.values()) == n_k7,
                f"{label}: launches {nonzero(c)}, expected {n_k7} flash_fwd")
        r.update(prefill_wall_s=wall, prefill_tok_per_s=B * S / wall,
                 k7_launches=c["flash_fwd"])
        log(f"  {label}: {wall:.3f} s ({B * S / wall:,.0f} tok/s), launches "
            f"{nonzero(c)}")
        if n_k7:
            r["logits"] = family_logits(pal, xla, params, batch, nxt, n_k7,
                                        label)
        else:
            with torch.no_grad():
                lp = M.forward(pal, params, batch["tokens"])[0]
            require(bool(torch.isfinite(lp).all())
                    and torch.equal(nxt.long(), lp[:, -1].argmax(-1)),
                    f"{label}: non-finite logits, or prefill_step tokens != "
                    f"argmax of its logits")
            log(f"  {label}: no attention, so attn_impl='xla' runs the same "
                f"code; logits finite")
            del lp
        del params, batch, nxt
        torch.cuda.empty_cache()
        if cfg.family != "vlm":
            f32 = dataclasses.replace(pal, dtype="float32")
            if cfg.is_moe:
                f32 = dataclasses.replace(f32, capacity_factor=float(
                    cfg.n_experts) / cfg.top_k + 1.0)
            B, S = FAMILY_DECODE
            toks = family_batch(f32, B, S, dev, seed=7)["tokens"]
            reset_counters()
            t = time.perf_counter()
            with torch.no_grad():
                full = M.forward(f32, master, toks)[0]
                n_f = counters()["flash_fwd"]
                cache = M.init_cache(f32, B, S, device=dev)
                dec = torch.stack([M.decode_step(f32, master, cache,
                                                 toks[:, i], i)[0]
                                   for i in range(S)], 1)
            torch.cuda.synchronize()
            by_path[f"{arch} decode == prefill fp32"] = counters()
            err = float((dec - full).abs().max())
            r.update(decode_err=err, decode_wall_s=time.perf_counter() - t)
            log(f"  {arch} decode == prefill fp32 (B={B}, {S} positions): "
                f"max |err| {err:.3g} (tol {LM_DECODE_TOL}), K7 launches "
                f"{n_f} (forward), {r['decode_wall_s']:.2f} s")
            require(n_f == n_k7 and bool(torch.isfinite(full).all())
                    and torch.allclose(dec, full, rtol=LM_DECODE_TOL,
                                       atol=LM_DECODE_TOL),
                    f"{arch}: decode != prefill in fp32: max |err| {err}, "
                    f"K7 launches {n_f}")
            del cache, full, dec, toks
        del master
        torch.cuda.empty_cache()
        # the served loop, through the user's entry point
        argv = ["--arch", arch] + FAMILY_SERVE
        reset_counters()
        out = serve(argv, device=str(dev))
        by_path[f"{arch} serve"] = c = counters()
        outs = out["outputs"]
        toks = [t for v in outs.values() for x in v
                for t in (x if isinstance(x, list) else [x])]
        cb = cfg.n_codebooks or 1
        require(out["tokens"] == 4 * 8
                and all(len(v) == 8 for v in outs.values())
                and len(toks) == 4 * 8 * cb
                and all(0 <= t < cfg.padded_vocab for t in toks),
                f"{arch} serve: {out['tokens']} tokens, lengths "
                f"{[len(v) for v in outs.values()]}")
        r["serve"] = {k: out[k] for k in ("tokens", "steps", "decode_calls",
                                          "wall_s", "tok_per_s")}
        log(f"  {arch} serve {' '.join(argv)}: " + json.dumps(r["serve"])
            + f", launches {nonzero(c)}")
        del out
        torch.cuda.empty_cache()
    info["wall_s"] = time.perf_counter() - t_phase
    log(f"  [families] {info['wall_s']:.1f} s")
    return info


# ---------------------------------------------------------------------------
# phase 4 (training): qwen3-1.7b train step at full width
# ---------------------------------------------------------------------------

# the train_4k shape (models/config.py SHAPES): seq 4096, its global batch
# of 256 cut to microbatches of 2 rows to fit one card
TRAIN_SEQ = 4_096
TRAIN_MICRO = 2
TRAIN_ACCUM = 2
TRAIN_STEPS = 3
# per-parameter ||g_kernel - g_torch_op|| / ||g_torch_op|| of the train
# step's fp32 grads, K7 path against the blockwise torch-op attention
# path.  bf16 (full width, 28 layers): the two attention paths round p, o
# and the grads differently in every layer and the backward carries that
# through 28 layers; fp32 (full width, 2 layers): the same arithmetic
# summed in another order.  Limits at ~2.2-2.6x the sound readings on
# the card (PERF.md section 6: bf16 0.039 at most, median 0.033; fp32
# 4.5e-6); a planted K7 bwd fault (dD zeroed in every layer) reads 2.05
# (median 1.18) and must fail the bf16 one.
TRAIN_GRAD_RTOL = {"bfloat16": 0.1, "float32": 1e-5}
# the launcher on the card at the smoke config: 20 steps, a failure after
# step 7, a checkpoint every 5 steps, so the restart resumes at data step 5
TRAIN_LAUNCH = ["--arch", LM_ARCH, "--smoke", "--steps", "20", "--fail-at",
                "7", "--ckpt-every", "5", "--batch", "8", "--seq", "128"]


def grad_probe():
    """Optimizer whose state becomes the step's averaged fp32 grads (the
    reference test's grad probe, ``tests/test_training.py:72-86``, with
    the grads kept exactly instead of added to the params)."""
    import torch
    from repro_torch.training.optimizer import Optimizer, global_norm

    def update(g, st, params):
        zero = torch.zeros((), device=next(iter(g.values())).device)
        return ({k: zero for k in g}, g,
                dict(lr=zero, grad_norm=global_norm(g)))
    return Optimizer(init=lambda p: None, update=update)


@contextlib.contextmanager
def k7_bwd_fault():
    """Control: every K7 backward call of the block gets dD zeroed (the
    kernels still launch and count)."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    real = ops.flash_bwd

    def faulty(qp, kp, vp, dop, lse, dD, **kw):
        return real(qp, kp, vp, dop, lse, torch.zeros_like(dD), **kw)
    counts = ("fused_launches", "dq_launches", "dkv_launches")
    for c in counts:
        setattr(faulty, c, getattr(real, c))
    ops.flash_bwd = faulty
    try:
        yield
    finally:
        ops.flash_bwd = real
        for c in counts:
            setattr(real, c, getattr(faulty, c))


def grad_errors(g, ref) -> dict:
    """Per parameter ||g - ref|| / ||ref||: the largest (and where) and
    the median."""
    rel = {k: float((g[k] - r).norm() / r.norm().clamp(min=1e-30))
           for k, r in ref.items()}
    worst = max(rel, key=rel.get)
    vals = sorted(rel.values())
    return dict(max=rel[worst], at=worst, median=vals[len(vals) // 2])


def train_batch(cfg, rows, step, dev, seq=TRAIN_SEQ):
    """Rows ``rows`` of the port's SyntheticSource batch ``step`` at
    ``seq`` tokens, on the card: the audio family's codebooks and the vlm
    family's patch rows too, as the launcher's data source makes them."""
    import torch
    from repro_torch.datapipe import DataConfig, SyntheticSource
    src = SyntheticSource(DataConfig(
        batch=rows, seq_len=seq, vocab=cfg.vocab, seed=0,
        n_codebooks=cfg.n_codebooks, patch_tokens=cfg.patch_tokens,
        d_model=cfg.d_model))
    return {k: torch.from_numpy(v).to(dev)
            for k, v in src.batch(step).items()}


def probe_grads(cfg, master, batch, fault=False):
    """(fp32 grads of one train step, launch counts of the step)."""
    import torch
    from repro_torch.training.step import make_train_step
    opt = grad_probe()
    reset_counters()
    with k7_bwd_fault() if fault else contextlib.nullcontext():
        _, g, m = make_train_step(cfg, opt)(master, None, batch)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(m["loss"]) and torch.isfinite(
        m["grad_norm"])), f"{cfg.name}: loss {m['loss']} grad norm "
                          f"{m['grad_norm']}")
    return g, counters()


def check_train_grads(cfg, master, batch, dtype, label, by_path,
                      control=False, floor=False):
    """The train step's grads, K7 path against the torch-op path, at
    TRAIN_GRAD_RTOL; with ``floor`` the limit is the larger of that and
    twice a floor measured here, the torch-op path against itself at half
    its key tile (the same attention summed in another order, which is
    what K7 against the torch-op path is; the families' deep bf16 stacks,
    as their logits in ``family_logits``); with ``control`` also the
    planted K7 bwd fault, which must be flagged."""
    import torch
    L = k7_calls(cfg)
    pal = dataclasses.replace(cfg, attn_impl="pallas", dtype=dtype)
    xla = dataclasses.replace(cfg, attn_impl="xla", dtype=dtype)
    t = time.perf_counter()
    gx, cx = probe_grads(xla, master, batch)
    wall_x = time.perf_counter() - t
    t = time.perf_counter()
    gp, cp = probe_grads(pal, master, batch)
    wall_p = time.perf_counter() - t
    by_path[label] = cp
    # remat: two K7 fwd a K7 call; the backward is the fused kernel in
    # bf16, K7 dq + dkv in fp32
    bwd = ((L, 0, 0) if dtype == "bfloat16" else (0, L, L))
    want = (2 * L,) + bwd
    require((cp["flash_fwd"], cp["flash_bwd_fused"], cp["flash_bwd_dq"],
             cp["flash_bwd_dkv"]) == want and sum(cp.values()) == sum(want)
            and not any(cx.values()),
            f"{label}: launches {nonzero(cp)}, torch-op path {nonzero(cx)};"
            f" expected (fwd, fused, dq, dkv) = {want}")
    sound = grad_errors(gp, gx)
    del gp
    limit = TRAIN_GRAD_RTOL[dtype]
    out = dict(wall_s=wall_p, xla_wall_s=wall_x, grads=sound,
               launches=nonzero(cp))
    if floor:
        half = dataclasses.replace(xla, attn_chunk_k=xla.attn_chunk_k // 2)
        gf, _ = probe_grads(half, master, batch)
        out["floor"] = grad_errors(gf, gx)
        del gf
        limit = max(limit, 2 * out["floor"]["max"])
    out["limit"] = limit
    log(f"  {label}: {wall_p:.3f} s (torch-op path {wall_x:.3f} s), "
        f"launches {nonzero(cp)}; grads vs torch-op path: "
        + json.dumps(sound) + f" (limit {limit:.3g}"
        + (f": TRAIN_GRAD_RTOL {TRAIN_GRAD_RTOL[dtype]} or twice the floor "
           f"(torch-op path, key tile {xla.attn_chunk_k // 2} vs "
           f"{xla.attn_chunk_k}) " + json.dumps(out["floor"]) if floor
           else "") + ")")
    if control:
        gc, _ = probe_grads(pal, master, batch, fault=True)
        out["control"] = grad_errors(gc, gx)
        del gc
        flagged = out["control"]["max"] > limit
        log(f"  {label} control (K7 bwd with dD zeroed in every call): "
            + json.dumps(out["control"]) + f"; flagged {flagged}")
        require(flagged, f"{label}: the planted K7 bwd fault passed: "
                         f"{out['control']}")
    del gx
    torch.cuda.empty_cache()
    require(sound["max"] <= limit,
            f"{label}: grads differ from the torch-op path: {sound} (limit "
            f"{limit})")
    return out


def adamw_steps(cfg, params, batches, label, by_path, watch):
    """AdamW steps through ``make_train_step(accum=TRAIN_ACCUM)``, one a
    batch: each step's launches (2 K7 fwd and one fused bwd a K7 call and
    microbatch), finite loss and grad norm, the ``watch`` params moved,
    peak device memory, walls (the mean of all but the first).  Returns
    (info, params, optimizer state, the step)."""
    import torch
    from repro_torch.training.optimizer import adamw
    from repro_torch.training.step import make_train_step
    L = k7_calls(cfg)
    n_steps = len(batches)
    opt = adamw(peak_lr=3e-4, warmup=1, total_steps=n_steps + 1)
    step = make_train_step(cfg, opt, accum=TRAIN_ACCUM)
    state = opt.init(params)
    before = {k: params[k][..., :64].clone() for k in watch}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    walls, hist = [], []
    for i, batch in enumerate(batches):
        n = counters()
        t = time.perf_counter()
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        c = counters()
        per = {k: c[k] - n[k] for k in c}
        want = (2 * L * TRAIN_ACCUM, L * TRAIN_ACCUM)
        require((per["flash_fwd"], per["flash_bwd_fused"]) == want
                and sum(per.values()) == sum(want),
                f"{label} step {i}: launches {nonzero(per)}, expected "
                f"(fwd, fused) = {want}")
        hist.append(dict(loss=float(m["loss"]), grad_norm=float(
            m["grad_norm"]), lr=float(m["lr"]), tokens=float(m["tokens"])))
        require(all(map(lambda x: x == x and abs(x) != float("inf"),
                        hist[-1].values())), f"{label}: {hist[-1]}")
    by_path[label] = c = counters()
    peak = torch.cuda.max_memory_allocated()
    moved = {k: float((params[k][..., :64] - v).abs().max())
             for k, v in before.items()}
    require(all(x > 0 for x in moved.values()) and int(state.step) ==
            n_steps, f"{label}: params moved {moved}, step "
                     f"{int(state.step)}")
    wall = sum(walls[1:]) / len(walls[1:])
    tokens = batches[0]["tokens"].shape[0] * batches[0]["tokens"].shape[1]
    info = dict(history=hist, walls_s=walls, wall_s=wall,
                tok_per_s=tokens / wall, peak_gb=peak / 1e9, moved=moved,
                launches=nonzero(c))
    log(f"  {label}: {n_steps} AdamW steps, " + json.dumps(info))
    return info, params, state, step


def train_path(dev, by_path):
    """Drive the training paths of qwen3-1.7b at full width; adds each
    one's launch counts to ``by_path`` and returns what phase 5 reports."""
    import torch
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.models.layers import init_params
    cfg = dataclasses.replace(configs.get_config(LM_ARCH), remat=True,
                              attn_impl="pallas")
    info = {}
    torch.cuda.reset_peak_memory_stats()
    master = init_params(M.param_specs(cfg), 0, device=dev)
    micro = train_batch(cfg, TRAIN_MICRO, 0, dev)
    # (a) bf16, 28 layers: grads against the torch-op path, and a control
    info["grads_bf16"] = check_train_grads(
        cfg, master, micro, "bfloat16",
        f"train grads ({TRAIN_MICRO}, {TRAIN_SEQ}) bf16", by_path,
        control=True)
    del master
    torch.cuda.empty_cache()
    # (b) fp32, 2 layers at full width
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    master2 = init_params(M.param_specs(cfg2), 0, device=dev)
    info["grads_fp32"] = check_train_grads(
        cfg2, master2, micro, "float32",
        f"train grads ({TRAIN_MICRO}, {TRAIN_SEQ}) fp32 2 layers", by_path)
    del master2, micro
    torch.cuda.empty_cache()
    # (c) AdamW steps, accum 2, through make_train_step
    B = TRAIN_MICRO * TRAIN_ACCUM
    label = f"train ({B}, {TRAIN_SEQ}) accum={TRAIN_ACCUM}"
    params = init_params(M.param_specs(cfg), 0, device=dev)
    batches = [train_batch(cfg, B, i, dev) for i in range(TRAIN_STEPS + 1)]
    info["steps"], params, state, step = adamw_steps(
        cfg, params, batches[:TRAIN_STEPS], label, by_path,
        ("layers/attn/wq", "lm_head/w"))
    # the device's busy share over one more step (not counted)
    pw, busy, by_kernel = profile_window(
        lambda: step(params, state, batches[TRAIN_STEPS]))
    k7 = {k: v for k, v in by_kernel.items() if "flash_" in k}
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:6]
    info["profile"] = dict(
        wall_s=pw, busy_s=busy,
        busy_share=None if busy is None else busy / pw,
        k7_s=sum(v[0] for v in k7.values()),
        k7_share=None if not busy else sum(v[0] for v in k7.values()) / busy,
        k7_by_kernel={k[:48]: v for k, v in k7.items()},
        top=[(k[:60], v[0], v[1]) for k, v in top])
    log(f"  profile {label}: " + json.dumps(info["profile"]))
    del params, state, batches, step
    torch.cuda.empty_cache()
    # (d) the launcher at the smoke config, with a failure and a restart
    info["launcher"] = launcher_restart(dev, TRAIN_LAUNCH, "launcher --smoke",
                                        by_path)
    return info


def launcher_restart(dev, argv, label, by_path) -> dict:
    """``repro_torch.launch.train`` with ``argv`` (20 steps, a failure
    after step 7, a checkpoint every 5): one restart, resumed at data
    step 5, finite losses."""
    import shutil
    from repro_torch.launch.train import train
    ckpt = os.path.join(HERE, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    reset_counters()
    t = time.perf_counter()
    out = train(argv + ["--ckpt-dir", ckpt], device=str(dev))
    wall = time.perf_counter() - t
    by_path[label] = counters()
    losses = [x for _, x in out["history"]]
    require(out["restarts"] == 1 and out["starts"] == [0, 5] and losses
            and all(x == x and abs(x) != float("inf") for x in losses),
            f"{label}: {out}")
    info = dict(wall_s=wall, restarts=out["restarts"], starts=out["starts"],
                history=out["history"])
    log(f"  {label} {' '.join(argv)}: " + json.dumps(info))
    shutil.rmtree(ckpt, ignore_errors=True)
    return info


# ---------------------------------------------------------------------------
# phase 4 (family training): the moe, vlm, audio, hybrid and ssm families'
# train steps at full width
# ---------------------------------------------------------------------------

# (arch, layers, sequence length) of the family train path, remat on, bf16
# on fp32 masters, microbatch TRAIN_MICRO rows: zamba2-7b cut to 24 of its
# 81 layers (4 applications of the shared block; 2.31 B params, whose
# fp32 masters, grads, AdamW moments and bf16 cast take ~42 GB: all 81
# would take ~120 GB), xlstm-1.3b at 1,024 tokens (its sLSTM loops run a
# step a token, under autograd too); None: the published depth
FAMILY_TRAIN = (("granite-moe-1b-a400m", None, TRAIN_SEQ),
                ("internvl2-2b", None, TRAIN_SEQ),
                ("musicgen-medium", None, TRAIN_SEQ),
                ("zamba2-7b", 24, TRAIN_SEQ),
                ("xlstm-1.3b", None, 1_024))
# zamba2-7b in fp32 at full width: its grads through K7 dq / dkv at hd 112
# (one application of the shared block, after layer 6)
ZAMBA_FP32_LAYERS = 6
FAMILY_STEPS = 2
FAMILY_LAUNCH = ["--arch", "zamba2-7b", "--smoke", "--steps", "20",
                 "--fail-at", "7", "--ckpt-every", "5", "--batch", "8",
                 "--seq", "128"]


def families_train_path(dev, by_path):
    """Each family's train step at full width in turn, its model freed
    before the next (``FAMILY_TRAIN``): the grads of one microbatch, K7
    path against the torch-op path (``check_train_grads``: 2 K7 fwd and
    one fused bwd a K7 call, the limit the larger of TRAIN_GRAD_RTOL and
    twice the floor, the planted K7 bwd fault flagged; xlstm-1.3b has no
    attention, so its two paths are the same code: its grads once, finite,
    no launch); zamba2-7b also in fp32 at ZAMBA_FP32_LAYERS layers
    through K7 dq / dkv at hd 112 (the limit the larger of
    TRAIN_GRAD_RTOL and twice the floor: the Mamba2 layers' small
    ``a_log`` / ``d_skip`` leaves sum many terms that cancel, and read
    2.1e-5 against TRAIN_GRAD_RTOL's 1e-5 on the card); FAMILY_STEPS AdamW
    steps with accum=TRAIN_ACCUM (``adamw_steps``); then the launcher
    with a restart on zamba2-7b's smoke config.  Returns the
    measurements."""
    import torch
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.models.layers import init_params
    info = {}
    t_phase = time.perf_counter()
    for arch, layers, seq in FAMILY_TRAIN:
        cfg = configs.get_config(arch)
        cfg = dataclasses.replace(cfg, remat=True, attn_impl="pallas",
                                  n_layers=layers or cfg.n_layers)
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        master = init_params(M.param_specs(cfg), 0, device=dev)
        micro = train_batch(cfg, TRAIN_MICRO, 0, dev, seq)
        n_k7 = k7_calls(cfg)
        r = info[arch] = dict(params=cfg.n_params(), layers=cfg.n_layers,
                              seq=seq, k7_calls=n_k7)
        log(f"  {arch} ({cfg.family}, {cfg.n_layers} layers, "
            f"{cfg.n_params():,} params): train microbatch "
            f"({TRAIN_MICRO}, {seq}), {n_k7} K7 calls a forward")
        label = f"{arch} train grads ({TRAIN_MICRO}, {seq}) bf16"
        if n_k7:
            r["grads_bf16"] = check_train_grads(
                cfg, master, micro, "bfloat16", label, by_path,
                control=True, floor=True)
        else:
            t = time.perf_counter()
            g, c = probe_grads(dataclasses.replace(cfg, dtype="bfloat16"),
                               master, micro)
            wall = time.perf_counter() - t
            by_path[label] = c
            finite = all(bool(torch.isfinite(v).all()) for v in g.values())
            r["grads_bf16"] = dict(wall_s=wall, finite=finite,
                                   launches=nonzero(c))
            log(f"  {label}: {wall:.3f} s, no attention (attn_impl='xla' "
                f"runs the same code); grads finite {finite}, launches "
                f"{nonzero(c)}")
            require(finite and not any(c.values()),
                    f"{label}: grads finite {finite}, launches {nonzero(c)}")
            del g
        del micro
        torch.cuda.empty_cache()
        B = TRAIN_MICRO * TRAIN_ACCUM
        batches = [train_batch(cfg, B, i, dev, seq)
                   for i in range(FAMILY_STEPS)]
        watch = ("lm_head/w", next(k for k in sorted(master)
                                   if master[k].dim() >= 3))
        r["steps"], params, state, _ = adamw_steps(
            cfg, master, batches,
            f"{arch} train ({B}, {seq}) accum={TRAIN_ACCUM}", by_path,
            watch)
        del master, params, state, batches
        torch.cuda.empty_cache()
        if arch == "zamba2-7b":
            cfg6 = dataclasses.replace(cfg, n_layers=ZAMBA_FP32_LAYERS)
            master6 = init_params(M.param_specs(cfg6), 0, device=dev)
            micro = train_batch(cfg6, TRAIN_MICRO, 0, dev, seq)
            r["grads_fp32"] = check_train_grads(
                cfg6, master6, micro, "float32",
                f"{arch} train grads ({TRAIN_MICRO}, {seq}) fp32 "
                f"{ZAMBA_FP32_LAYERS} layers", by_path, floor=True)
            del master6, micro
            torch.cuda.empty_cache()
        r["wall_s"] = time.perf_counter() - t0
        log(f"  {arch} training: {r['wall_s']:.1f} s")
    info["launcher"] = launcher_restart(
        dev, FAMILY_LAUNCH, "zamba2-7b launcher --smoke", by_path)
    info["wall_s"] = time.perf_counter() - t_phase
    log(f"  [families train] {info['wall_s']:.1f} s")
    return info


# each kernel's own path: the drive whose count is the record's `launches`
KERNEL_PATH = {
    "fused_check_packed": "resident=False run_batch 512x2048 dblp+corp",
    "resident_pool": "default stream",
    "resident_step": "resident_lanes=0 stream",
    "fused_select_packed": "dense deg_nocache resident=False",
    "fused_select_gathered_prefix": "compact stream",
    "fused_check_gathered_prefix2": "compact stream",
    "intersect_count": "compact unfused impl=pallas",
    "flash_fwd": f"prefill {LM_PREFILL[0]} pallas",
    "flash_fwd_hd112": "zamba2-7b prefill (1, 4096) pallas",
    "flash_bwd_fused": f"train ({TRAIN_MICRO * TRAIN_ACCUM}, {TRAIN_SEQ}) "
                       f"accum={TRAIN_ACCUM}",
    "flash_bwd_dq": f"train grads ({TRAIN_MICRO}, {TRAIN_SEQ}) fp32 2 layers",
    "flash_bwd_dkv": f"train grads ({TRAIN_MICRO}, {TRAIN_SEQ}) fp32 2 "
                     f"layers",
    "flash_bwd_fused_hd112": f"zamba2-7b train grads ({TRAIN_MICRO}, "
                             f"{TRAIN_SEQ}) bf16",
    "flash_bwd_dq_hd112": f"zamba2-7b train grads ({TRAIN_MICRO}, "
                          f"{TRAIN_SEQ}) fp32 {ZAMBA_FP32_LAYERS} layers",
    "flash_bwd_dkv_hd112": f"zamba2-7b train grads ({TRAIN_MICRO}, "
                           f"{TRAIN_SEQ}) fp32 {ZAMBA_FP32_LAYERS} layers",
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


# the profiler drops a device event stamped before its window opened, and
# the card's converted kernel timestamps can run milliseconds behind the
# host clock (chip_profile_windows.py): the work starts this long after
# the window opens
PROFILE_SETTLE_S = 0.05


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
        time.sleep(PROFILE_SETTLE_S)
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
    ``name_part`` (profiler), or None when the profiler saw none (logged
    with what the window did see: late in the script some windows come
    back with no kernel at all, PERF.md section 6)."""
    fn()
    _, _, by_kernel = profile_window(lambda: [fn() for _ in range(reps)])
    hits = [v for k, v in by_kernel.items() if name_part in k]
    if not hits:
        log(f"  device_ms: no {name_part} in a profiler window of {reps} "
            f"calls; it saw {len(by_kernel)} kernels: " + json.dumps(
                [(k[:50], v) for k, v in list(by_kernel.items())[:4]]))
        return None
    return sum(v[0] for v in hits) / sum(v[1] for v in hits) * 1e3


def bound(bytes_, ops, ops_per_s=H100_INT_OPS_PER_S):
    tb = bytes_ / H100_BYTES_PER_S * 1e3
    to = ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def k1_lane_inputs(lanes, n, w, seed, dev):
    """K1 operands of a ``lanes``-wide pool with per-lane adjacency (the
    per-step ``run_batch`` path's shape)."""
    import torch
    parts = [k1_inputs(n, w, seed + i, dev) for i in range(lanes)]
    return tuple(torch.stack(xs) for xs in zip(*parts))


def record(name, by_path, errs, counter=None, **fields):
    """One entry of the ``kernels`` line: ``launches`` is the count of
    the kernel's own path (``KERNEL_PATH``), ``launches_by_path`` every
    drive that launched it; ``counter`` names the wrapper's count when it
    is not ``name`` (a second row of one wrapper)."""
    key_ = counter or name
    rec = dict(name=name, route="cuda",
               launches=by_path[KERNEL_PATH[name]][key_],
               max_abs_err=errs[name], **fields)
    rec["path"] = KERNEL_PATH[name]
    rec["launches_by_path"] = {k: c[key_] for k, c in by_path.items()
                               if c[key_]}
    return rec


def lane_work_bytes(cfg, adv: int) -> int:
    """Bytes the lane kernel must move for ``adv`` advanced steps: the
    adjacency read once, the cursor block read and written, and per step
    one level's rows read (L, P, Q, R, the cstack row) and one level's
    rows written (L', the counts row, P at two levels, Q, R, x)."""
    read = cfg.wv + cfg.n_u + 3 * cfg.wu
    write = cfg.wv + cfg.n_u + 4 * cfg.wu + 1
    return 4 * (cfg.n_u * cfg.wv + 2 * 16 + adv * (read + write))


def per_step(ms, adv):
    return None if ms is None or not adv else ms / adv


def queued_ms(fn, reps=20):
    """Device ms per call: the calls are queued behind a spin kernel of
    about a millisecond, so they run back to back on the device whatever
    the host's pace (CUDA events around them; the device's own gap
    between launches included)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def lane_times(ctx, cfg, warm, spc, *, pool, threads=None, host=True,
               reps=20):
    """K3 (``pool``: every lane of ``warm``) or K2 (one lane) at ``spc``,
    in place: every timed launch runs on its own copy of ``warm``, made
    before the timed window, so no rep starts from a state an earlier rep
    advanced.  Returns (ms per launch, back to back, CUDA events; device
    ms per launch, profiler (None when its window saw no kernel); device
    ms per launch, queued (``queued_ms``); ms per run-loop segment, i.e. a
    launch and the flag read, host clock; steps advanced per launch)."""
    import torch
    from repro_torch.core import engine_dense as ed
    from repro_torch.kernels.resident_pool.ops import pool_run
    from repro_torch.kernels.resident_step.ops import (S_STEPS, lane_run,
                                                       pack)

    def runs(n):
        out = []
        for _ in range(n):
            own = ed._owned(warm)
            p = pack(own, own.steps.clone(), 1 << 30)
            out.append(pool_run(ctx, cfg, own, p, spc, ctx_batched=True,
                                threads=threads) if pool
                       else lane_run(ctx, cfg, own, p, spc,
                                     threads=threads))
        torch.cuda.synchronize()
        return out

    name = "resident_pool_kernel" if pool else "resident_step_kernel"
    ms = dms = seg = None
    if host:
        it = iter(runs(reps + 1))
        ms = cuda_ms(lambda: next(it).launch(), reps)
        it = iter(runs(reps + 1))
        dms = device_ms(lambda: next(it).launch(), name, reps)
    it = iter(runs(reps + 1))
    qms = queued_ms(lambda: next(it).launch(), reps)
    rs = runs(reps)
    if host:
        t = time.perf_counter()
        for r in rs:
            r.launch()
            r.active()
        seg = (time.perf_counter() - t) / reps * 1e3
    else:
        rs[0].launch()
        torch.cuda.synchronize()
    adv = int((rs[0].p.scal[..., S_STEPS] - warm.steps).sum())
    return ms, dms, qms, seg, adv


def times(dev, by_path, errs):
    import torch
    from repro_torch.core import engine_dense as ed
    from repro_torch.data.generators import dataset_suite
    from repro_torch.kernels.fused_check.ops import fused_check_packed
    from repro_torch.kernels.fused_check.ref import fused_check_packed_ref
    from repro_torch.kernels.resident_pool.ref import (
        resident_pool_segment_ref)
    from repro_torch.kernels.resident_step.ops import (resident_cluster,
                                                       resident_state_bytes)
    from repro_torch.kernels.resident_step.ref import resident_segment_ref
    out = []
    # K1 (packed) at its path's shapes: 2-lane pools with per-lane
    # adjacency and counts on (order_mode 'deg'), buckets 512 x 2048 (the
    # record) and 128 x 256 (logged, PR 11's record shape)
    for lanes, n, w in ((2, 512, 64), (2, 128, 8)):
        args = k1_lane_inputs(lanes, n, w, 7, dev)

        def k1():
            return fused_check_packed(*args, impl="pallas", with_counts=True)
        ms = cuda_ms(k1)
        plain = cuda_ms(lambda: fused_check_packed_ref(*args,
                                                       with_counts=True))
        dms = device_ms(k1, "fused_check_kernel")
        qms = queued_ms(k1)
        nw = n // 32
        # read adj, mask, n_mask, q, p; write viol, full/part/nz, counts
        b, kind = bound(4 * lanes * (n * w + w + 1 + 2 * nw
                                     + 1 + 3 * nw + n), 2 * lanes * n * w)
        shape = f"lanes={lanes} N={n} W={w} per-lane adj, with_counts"
        if n == 512:
            out.append(record(
                "fused_check_packed", by_path, errs,
                source="src/repro_torch/csrc/fused_check.cu",
                replaces="src/repro/kernels/fused_check/kernel.py:81",
                ms=ms, plain_ms=plain, bound_ms=b, bound_by=kind,
                library_ms=None, device_ms=dms, queued_ms=qms, shape=shape))
        else:
            log(f"  fused_check_packed at {shape}: {ms:.4f} ms/call (device "
                f"{dms} ms, queued {qms:.4f} ms), plain {plain:.4f} ms, "
                f"bound {b:.6f} ms ({kind})")
    # K3 / K2 at the default path's dblp-like pool: bucket 512 x 2048,
    # one lane, from a mid-run state; then dblp-large's 1024 x 4096 lane
    # (a cluster of CTAs)
    bench = dataset_suite("bench")
    cfg, ctx, s0 = bucket_pool([bench["dblp-like"]], dev)
    warm = ed.run_batch(ctx, cfg, s0, max_steps=2000, ctx_batched=True)
    lane, lctx = ed._lane(warm, 0), ed._lane(ctx, 0)
    for spc in (1, 16):
        ms, dms, qms, seg, adv = lane_times(ctx, cfg, warm, spc, pool=True)
        plain = cuda_ms(lambda: resident_pool_segment_ref(
            ctx, cfg, warm, start=warm.steps, budget=1 << 30,
            steps_per_call=spc, ctx_batched=True), reps=5)
        b, kind = bound(lane_work_bytes(cfg, adv), adv * 2 * cfg.n_u * cfg.wv)
        old_b, _ = bound(resident_state_bytes(cfg, cfg.n_u, lanes=1), 0)
        ms2, dms2, qms2, seg2, adv2 = lane_times(lctx, cfg, lane, spc,
                                                 pool=False)
        plain2 = cuda_ms(lambda: resident_segment_ref(
            lctx, cfg, lane, start=lane.steps, budget=1 << 30,
            steps_per_call=spc), reps=5)
        log(f"  resident_pool 512x2048 1 lane spc={spc}: {ms:.4f} ms/launch "
            f"(device: profiler {dms} ms, queued {qms:.4f} ms; {adv} "
            f"steps: {per_step(qms, adv):.5f} ms a step), run-loop segment "
            f"(launch + flag read) {seg:.4f} ms, plain {plain:.3f} ms, "
            f"bound {b:.6f} ms ({kind}; the old whole-state bound "
            f"{old_b:.5f} ms); resident_step: {ms2:.4f} ms/launch (device: "
            f"profiler {dms2} ms, queued {qms2:.4f} ms; "
            f"{per_step(qms2, adv2):.5f} ms a step), segment {seg2:.4f} ms, "
            f"plain {plain2:.3f} ms")
        if spc == 1:
            out.append(record(
                "resident_pool", by_path, errs,
                source="src/repro_torch/csrc/resident_pool.cu",
                replaces="src/repro/kernels/resident_pool/kernel.py:50",
                ms=ms, plain_ms=plain, bound_ms=b, bound_by=kind,
                library_ms=None, device_ms=dms, queued_ms=qms,
                segment_ms=seg, old_bound_ms=old_b,
                shape="bucket 512x2048, 1 lane, steps_per_call=1"))
            out.append(record(
                "resident_step", by_path, errs,
                source="src/repro_torch/csrc/resident_step.cu",
                replaces="src/repro/kernels/resident_step/kernel.py:115",
                ms=ms2, plain_ms=plain2, bound_ms=b, bound_by=kind,
                library_ms=None, device_ms=dms2, queued_ms=qms2,
                segment_ms=seg2, old_bound_ms=old_b,
                shape="bucket 512x2048, steps_per_call=1"))
        else:
            for th in (128, 256, 512):
                _, _, q, _, a = lane_times(ctx, cfg, warm, spc, pool=True,
                                           threads=th, host=False)
                log(f"  resident_pool 512x2048 spc=16 at {th} threads: "
                    f"device (queued) {q:.4f} ms, {per_step(q, a):.5f} ms "
                    f"a step")
    big = dataset_suite("large")["dblp-large"]
    cfg, ctx, s0 = bucket_pool([big], dev)
    warm = ed.run_batch(ctx, cfg, s0, max_steps=2000, ctx_batched=True)
    for spc in (1, 16):
        ms, dms, qms, seg, adv = lane_times(ctx, cfg, warm, spc, pool=True)
        b, kind = bound(lane_work_bytes(cfg, adv), adv * 2 * cfg.n_u * cfg.wv)
        log(f"  resident_pool dblp-large 1024x4096 (cluster of "
            f"{resident_cluster(cfg)}) spc={spc}: {ms:.4f} ms/launch "
            f"(device: profiler {dms} ms, queued {qms:.4f} ms; {adv} steps: "
            f"{per_step(qms, adv):.5f} ms a step), segment {seg:.4f} ms, "
            f"bound {b:.6f} ms ({kind})")
        if spc == 16:
            for th in (128, 256, 512):
                _, _, q, _, a = lane_times(ctx, cfg, warm, spc, pool=True,
                                           threads=th, host=False)
                log(f"  resident_pool dblp-large spc=16 at {th} threads: "
                    f"device (queued) {q:.4f} ms, {per_step(q, a):.5f} ms "
                    f"a step")
    out += slice2_times(dev, by_path, errs)
    row_plan_sweep(dev)
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


# one qwen3-1.7b layer's K7 call at the two prefill lengths: (B, S, H, KV, hd)
K7_TIME_SHAPES = ((1, 4_096, 16, 8, 128), (1, 32_768, 16, 8, 128))


def k7_times(dev, by_path, errs, lm):
    """K7 fwd at the qwen3-1.7b layer shapes (1, 4096) and (1, 32768):
    wrapper call (CUDA events), device time (profiler), the bound (causal
    FLOPs over the bf16 peak against bytes over the memory rate), the
    plain version (4096 only: its S x S scores take 1 GB there and 69 GB
    at 32k) and ``F.scaled_dot_product_attention`` on the same operands."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_fwd, flash_fwd_ref
    calls = {}
    for B, S, H, KV, hd in K7_TIME_SHAPES:
        qp, kp, vp = k7_operands(B, S, H, KV, hd, "bfloat16", dev, seed=S)
        calls[S] = (
            lambda qp=qp, kp=kp, vp=vp, S=S, hd=hd: flash_fwd(
                qp, kp, vp, causal=True, scale=hd ** -0.5, sq=S, sk=S),
            lambda qp=qp, kp=kp, vp=vp: F.scaled_dot_product_attention(
                qp.flatten(1, 2), kp, vp, is_causal=True, enable_gqa=True),
            lambda qp=qp, kp=kp, vp=vp, S=S, hd=hd: flash_fwd_ref(
                qp, kp, vp, causal=True, scale=hd ** -0.5, sq=S, sk=S))
    rows = {}
    for B, S, H, KV, hd in K7_TIME_SHAPES:
        k7 = calls[S][0]
        reps = 20 if S == K7_TIME_SHAPES[0][1] else 5
        flops = 4 * hd * H * B * S * (S + 1) // 2       # causal work only
        nbytes = 2 * B * S * hd * (2 * H + 2 * KV) + 4 * B * H * S
        b, kind = bound(nbytes, flops, H100_BF16_FLOPS)
        ms = cuda_ms(k7, reps)
        rows[S] = dict(ms=ms, device_ms=device_ms(k7, K7_FWD_KERNEL, reps),
                       bound_ms=b, bound_by=kind,
                       tflops=flops / (ms * 1e9))
    # beside phase 5's stand-alone windows stand phase 3's (K7_EARLY) and
    # the profiled prefill call at (1, 32768), K7's device time per launch
    require(K7_TIME_SHAPES[1][:2] == LM_PREFILL[0],
            "the profiled prefill call is not at K7's (1, 32768) shape")
    rows[K7_TIME_SHAPES[1][1]]["device_ms_in_prefill"] = lm["profile"][
        "k7_device_ms"]
    for _, S, _, _, _ in K7_TIME_SHAPES:
        rows[S]["device_ms_phase3"] = K7_EARLY.get(S)
    for B, S, H, KV, hd in K7_TIME_SHAPES:
        k7, lib, plain = calls[S]
        small = S == K7_TIME_SHAPES[0][1]
        r = rows[S]
        r["library_ms"] = cuda_ms(lib, 20 if small else 5)
        x, y = lib().float(), k7()[0].flatten(1, 2).float()
        r["sdpa_max_abs_diff"] = float((x - y).abs().max())
        r["sdpa_row_rel_diff"] = float(((x - y).norm(dim=-1)
                                        / x.norm(dim=-1)).max())
        del x, y
        # the same function: each is within K7_ROW_RTOL of the exact result
        require(r["sdpa_row_rel_diff"] <= K7_ROW_RTOL["bfloat16"] * 2,
                f"SDPA and K7 disagree at S={S}: {r['sdpa_row_rel_diff']}")
        r["plain_ms"] = cuda_ms(plain, reps=3) if small else None
        log(f"  flash_fwd at {(B, S, H, KV, hd)} bf16 causal: " + json.dumps(r))
    del calls
    r = rows[K7_TIME_SHAPES[0][1]]
    rec = record("flash_fwd", by_path, errs,
                 source="src/repro_torch/csrc/flash_fwd.cu",
                 replaces="src/repro/kernels/flash_attention/kernel.py:47",
                 ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                 bound_by=r["bound_by"], library_ms=r["library_ms"],
                 library_call="F.scaled_dot_product_attention(is_causal=True, "
                              "enable_gqa=True)",
                 device_ms=r["device_ms"] if r["device_ms"] is not None
                 else r["device_ms_phase3"],
                 device_ms_from="phase 5" if r["device_ms"] is not None
                 else "phase 3",
                 shape=f"(B, S, H, KV, hd) = {K7_TIME_SHAPES[0]} bf16 "
                       f"causal, one qwen3-1.7b layer",
                 at_32k=rows[K7_TIME_SHAPES[1][1]],
                 prefill=lm["prefill"], serve=lm["serve"],
                 prefill_profile=lm["profile"])
    return [rec]


# zamba2-7b's shared attention layer: (B, S, H, KV, hd)
K7_HD112_SHAPE = (1, 4_096, 32, 32, 112)


def k7_hd112_times(dev, by_path, errs, fam):
    """K7 fwd at hd 112 (zamba2-7b's shared block at its prefill): call
    (CUDA events), device time (profiler), the bound, the plain version
    and ``F.scaled_dot_product_attention`` on the same operands; the
    record's launches are the zamba2-7b prefill's."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_fwd, flash_fwd_ref
    B, S, H, KV, hd = K7_HD112_SHAPE
    qp, kp, vp = k7_operands(B, S, H, KV, hd, "bfloat16", dev, seed=112)
    kw = dict(causal=True, scale=hd ** -0.5, sq=S, sk=S)
    k7 = lambda: flash_fwd(qp, kp, vp, **kw)
    lib = lambda: F.scaled_dot_product_attention(
        qp.flatten(1, 2), kp, vp, is_causal=True, enable_gqa=True)
    flops = 4 * hd * H * B * S * (S + 1) // 2
    nbytes = 2 * B * S * hd * (2 * H + 2 * KV) + 4 * B * H * S
    b, kind = bound(nbytes, flops, H100_BF16_FLOPS)
    r = dict(ms=cuda_ms(k7), device_ms=device_ms(k7, K7_FWD_KERNEL),
             bound_ms=b, bound_by=kind, library_ms=cuda_ms(lib),
             plain_ms=cuda_ms(lambda: flash_fwd_ref(qp, kp, vp, **kw),
                              reps=3))
    r["tflops"] = flops / (r["ms"] * 1e9)
    x, y = lib().float(), k7()[0].flatten(1, 2).float()
    r["sdpa_row_rel_diff"] = float(((x - y).norm(dim=-1)
                                    / x.norm(dim=-1)).max())
    del x, y
    require(r["sdpa_row_rel_diff"] <= K7_ROW_RTOL["bfloat16"] * 2,
            f"SDPA and K7 disagree at hd 112: {r['sdpa_row_rel_diff']}")
    log(f"  flash_fwd at {K7_HD112_SHAPE} bf16 causal: " + json.dumps(r))
    return record("flash_fwd_hd112", by_path, errs, counter="flash_fwd",
                  source="src/repro_torch/csrc/flash_fwd.cu",
                  replaces="src/repro/kernels/flash_attention/kernel.py:47",
                  ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=b,
                  bound_by=kind, library_ms=r["library_ms"],
                  library_call="F.scaled_dot_product_attention("
                               "is_causal=True, enable_gqa=True)",
                  device_ms=r["device_ms"] if r["device_ms"] is not None
                  else K7_EARLY.get("hd112"),
                  device_ms_from="phase 5" if r["device_ms"] is not None
                  else "phase 3", tflops=r["tflops"],
                  shape=f"(B, S, H, KV, hd) = {K7_HD112_SHAPE} bf16 causal, "
                        f"zamba2-7b's shared attention layer",
                  families={a: {k: v for k, v in f.items() if k != "logits"}
                            for a, f in fam.items() if a != "wall_s"},
                  families_wall_s=fam["wall_s"])


# one qwen3-1.7b layer's K7 backward at the training shapes: (B, S, H, KV,
# hd); the main path's microbatch is the second
K7B_TIME_SHAPES = ((1, 4_096, 16, 8, 128), (2, 4_096, 16, 8, 128))


def sdpa_backward(qp, kp, vp, dop, reps=20):
    """The library call for the K7 backward: ``torch.autograd.grad``
    through ``F.scaled_dot_product_attention(is_causal=True,
    enable_gqa=True)`` minus its forward, which computes dq, dk and dv
    together.  Returns ({library_fwd_bwd_ms, library_fwd_ms, library_ms},
    SDPA's dq in fp32, (B, H, S, hd))."""
    import torch
    import torch.nn.functional as F
    qs, ks, vs = (x.detach().requires_grad_() for x in
                  (qp.flatten(1, 2), kp, vp))
    dos = dop.flatten(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                              enable_gqa=True)

    def fwd_bwd():
        return torch.autograd.grad(fwd(), (qs, ks, vs), dos)
    r = dict(library_fwd_bwd_ms=cuda_ms(fwd_bwd, reps),
             library_fwd_ms=cuda_ms(fwd, reps))
    r["library_ms"] = r["library_fwd_bwd_ms"] - r["library_fwd_ms"]
    return r, fwd_bwd()[0].float()


def sdpa_kernels(qp, kp, vp, dop):
    """The kernels one ``sdpa_backward`` library call runs (which SDPA
    backend): [(name, device ms, launches)], the six longest."""
    import torch
    import torch.nn.functional as F
    qs, ks, vs = (x.detach().requires_grad_() for x in
                  (qp.flatten(1, 2), kp, vp))
    _, _, by_kernel = profile_window(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                       enable_gqa=True),
        (qs, ks, vs), dop.flatten(1, 2)))
    return sorted(((k[:80], v[0] * 1e3, v[1]) for k, v in by_kernel.items()),
                  key=lambda x: -x[1])[:6]


def row_rel(x, ref) -> float:
    """max over rows of ||x - ref|| / ||ref||, rows under 1e-2 of the
    median row norm left out (K7B_ROW_RTOL's first measure)."""
    rn = ref.norm(dim=-1)
    keep = rn >= 1e-2 * rn.median()
    return float(((x - ref).norm(dim=-1)[keep] / rn[keep]).max())


def k7_bwd_times(dev, by_path, errs, train, early):
    """The fused K7 backward at K7B_TIME_SHAPES, bf16 causal: the wrapper
    call (CUDA events; it includes zeroing the fp32 dq accumulator and
    casting it to bf16) and the kernel's device time (profiler), its
    bound (10 hd FLOPs a causal (q, k) pair over the bf16 peak, against
    the bytes it must move), TFLOP/s at 10 hd, the plain version and the
    library call (``sdpa_backward``).  Then the fp32 K7 dq and dkv at the
    fp32 grad path's shape (2, 4096): each kernel's launch time, its
    device time (phase 3's: ``early`` from ``check_k7_bwd``), its bound
    (6 hd and 8 hd FLOPs a pair with the recomputed scores over the FP32
    CUDA-core peak; beside it the same products as 3xTF32 at the TF32
    tensor-core peak), the plain version, SDPA's fp32 backward and the
    kernels that SDPA ran for it.  Also the fp32 K7 forward on the same
    operands (call, device time, bound at 4 hd FLOPs a pair, the plain
    version and SDPA's fp32 forward), returned apart for the flash_fwd
    record."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_bwd, flash_bwd_ref,
                                                     flash_fwd, flash_fwd_ref)
    from repro_torch.kernels.flash_attention.ops import launch_dkv, launch_dq
    rows = {}
    for B, S, H, KV, hd in K7B_TIME_SHAPES:
        qp, kp, vp, dop, lse, dD, kw = k7b_operands(
            B, S, H, KV, hd, "bfloat16", True, dev, seed=S + B)
        ops = (qp, kp, vp, dop, lse, dD)

        def call():
            return flash_bwd(*ops, **kw)
        pairs = B * H * S * (S + 1) // 2              # causal (q, k) pairs
        rq = 2 * B * S * hd * H                      # one q-shaped bf16 tensor
        rk = 2 * B * S * hd * KV
        flops = 10 * hd * pairs
        b, kind = bound(3 * rq + 4 * rk + 8 * B * H * S, flops,
                        H100_BF16_FLOPS)
        ms = cuda_ms(call)
        r = dict(ms=ms, device_ms=device_ms(call, "flash_bwd_fused"),
                 bound_ms=b, bound_by=kind, tflops=flops / (ms * 1e9))
        r["plain_ms"] = cuda_ms(lambda: flash_bwd_ref(*ops, **kw), reps=3)
        lib, sdpa_dq = sdpa_backward(qp, kp, vp, dop)
        r.update(lib)
        # the same function: SDPA's dq per query row against the kernel's
        r["sdpa_dq_row_rel_diff"] = row_rel(call()[0].flatten(1, 2).float(),
                                            sdpa_dq)
        require(r["sdpa_dq_row_rel_diff"] <= 2 * K7B_ROW_RTOL["bfloat16"],
                f"SDPA and the fused K7 backward disagree on dq at {(B, S)}:"
                f" {r['sdpa_dq_row_rel_diff']}")
        del sdpa_dq, ops, qp, kp, vp, dop, lse, dD
        torch.cuda.empty_cache()
        rows[(B, S)] = r
        log(f"  flash_bwd fused at {(B, S, H, KV, hd)} bf16 causal: "
            + json.dumps(r))
    # fp32: K7 dq and dkv, one layer of the fp32 grad path
    B, S, H, KV, hd = K7B_TIME_SHAPES[1]
    qp, kp, vp, dop, lse, dD, kw = k7b_operands(
        B, S, H, KV, hd, "float32", True, dev, seed=S + B)
    ops = (qp, kp, vp, dop, lse, dD)
    dq, dk, dv = (torch.empty_like(x) for x in (qp, kp, vp))
    pairs = B * H * S * (S + 1) // 2
    rq, rk = 4 * B * S * hd * H, 4 * B * S * hd * KV
    f32 = {}
    for name, fn, flops, nbytes in (
            ("flash_bwd_dq", lambda: launch_dq(*ops, dq, **kw),
             6 * hd * pairs, 3 * rq + 2 * rk + 8 * B * H * S),
            ("flash_bwd_dkv", lambda: launch_dkv(*ops, dk, dv, **kw),
             8 * hd * pairs, 2 * rq + 4 * rk + 8 * B * H * S)):
        # the kernels' arithmetic: one FP32 FMA a product on the CUDA
        # cores; beside it the 3xTF32 bound (three TF32 products a fp32
        # product on the tensor cores, fp32-accurate but rounded otherwise
        # than the plain version)
        b, kind = bound(nbytes, flops, H100_FP32_FLOPS)
        ms = cuda_ms(fn, reps=5)
        f32[name] = dict(ms=ms, device_ms=early[name], bound_ms=b,
                         bound_by=kind,
                         bound_ms_3xtf32=bound(nbytes, 3 * flops,
                                               H100_TF32_FLOPS)[0],
                         tflops=flops / (ms * 1e9))
    f32["plain_ms"] = cuda_ms(lambda: flash_bwd_ref(*ops, **kw), reps=2)
    lib, _ = sdpa_backward(qp, kp, vp, dop, reps=3)
    f32.update(lib)
    f32["library_kernels"] = early["library_kernels"]
    # the fp32 K7 forward on the same operands
    fwd = lambda: flash_fwd(qp, kp, vp, **kw)
    fms = cuda_ms(fwd, reps=5)
    fb, fkind = bound(8 * B * S * hd * (H + KV) + 4 * B * H * S,
                      4 * hd * pairs, H100_FP32_FLOPS)
    fwd32 = dict(ms=fms, device_ms=early["flash_fwd"], bound_ms=fb,
                 bound_by=fkind,
                 bound_ms_3xtf32=bound(0, 3 * 4 * hd * pairs,
                                       H100_TF32_FLOPS)[0],
                 tflops=4 * hd * pairs / (fms * 1e9),
                 plain_ms=cuda_ms(lambda: flash_fwd_ref(qp, kp, vp, **kw),
                                  reps=2),
                 library_ms=f32["library_fwd_ms"],
                 library_call="F.scaled_dot_product_attention(is_causal="
                              "True, enable_gqa=True), fp32",
                 shape=f"(B, S, H, KV, hd) = {(B, S, H, KV, hd)} fp32 causal")
    # roofline shares: the bound over the call's time and over the device
    # time, against the FP32 CUDA-core peak and against 3xTF32's
    dev_ms = fwd32["device_ms"]
    for tag, bms in (("fp32", fwd32["bound_ms"]),
                     ("3xtf32", fwd32["bound_ms_3xtf32"])):
        fwd32[f"bound_share_{tag}"] = bms / fms
        fwd32[f"bound_share_{tag}_device"] = (None if not dev_ms
                                              else bms / dev_ms)
    del ops, qp, kp, vp, dop, lse, dD, dq, dk, dv
    torch.cuda.empty_cache()
    log(f"  flash_bwd dq / dkv at {(B, S, H, KV, hd)} fp32 causal: "
        + json.dumps(f32))
    log(f"  flash_fwd at {(B, S, H, KV, hd)} fp32 causal: "
        + json.dumps(fwd32))
    main = rows[K7B_TIME_SHAPES[1][:2]]
    library = dict(
        library_call="torch.autograd.grad through F.scaled_dot_product_"
                     "attention(is_causal=True, enable_gqa=True), minus its "
                     "forward",
        library_note="SDPA's backward computes dq, dk and dv in one call")
    kernel_py = "src/repro/kernels/flash_attention/kernel.py"
    out = [record(
        "flash_bwd_fused", by_path, errs,
        source="src/repro_torch/csrc/flash_bwd.cu",
        replaces=f"{kernel_py}:91",
        replaces_all=[f"{kernel_py}:91", f"{kernel_py}:131"],
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=main["library_ms"], **library,
        plain_note="flash_bwd_ref computes dq, dk and dv in one call",
        device_ms=main["device_ms"], tflops_10hd=main["tflops"],
        shape=f"(B, S, H, KV, hd) = {K7B_TIME_SHAPES[1]} bf16 causal, one "
              f"qwen3-1.7b layer of the train step's microbatch",
        at_1x4096=rows[K7B_TIME_SHAPES[0][:2]], train=train)]
    for name, line in (("flash_bwd_dq", 91), ("flash_bwd_dkv", 131)):
        k = f32[name]
        out.append(record(
            name, by_path, errs, source="src/repro_torch/csrc/flash_bwd.cu",
            replaces=f"{kernel_py}:{line}", ms=k["ms"],
            plain_ms=f32["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=f32["library_ms"], **library,
            bound_note="FP32 FMAs at the CUDA-core peak; bound_ms_3xtf32: "
                       "three TF32 products a fp32 product at the dense "
                       "TF32 tensor-core peak",
            bound_ms_3xtf32=k["bound_ms_3xtf32"],
            library_kernels=f32["library_kernels"],
            plain_note="flash_bwd_ref computes dq, dk and dv in one call",
            device_ms=k["device_ms"], tflops=k["tflops"],
            shape=f"(B, S, H, KV, hd) = {K7B_TIME_SHAPES[1]} fp32 causal, "
                  f"one layer of the fp32 grad path"))
    return out, fwd32


def k7_bwd_hd112_times(dev, by_path, errs, ftrain, early):
    """The K7 backward at hd 112, zamba2-7b's shared attention layer
    (K7B_HD112_SHAPES): the fused bf16 kernel at the family train
    microbatch and the fp32 dq and dkv, each with its call time (CUDA
    events), device time (profiler, from phase 3: ``early``), bound (10 hd, 6 hd and 8 hd FLOPs a causal pair over the
    bf16 and FP32 peaks, against the bytes), the plain version and SDPA's
    backward on the same operands (``sdpa_backward``).  Returns the three
    records; their launches are zamba2-7b's train grads'."""
    import torch
    from repro_torch.kernels.flash_attention import flash_bwd, flash_bwd_ref
    from repro_torch.kernels.flash_attention.ops import launch_dkv, launch_dq
    kernel_py = "src/repro/kernels/flash_attention/kernel.py"
    common = dict(source="src/repro_torch/csrc/flash_bwd.cu",
                  library_call="torch.autograd.grad through F.scaled_dot_"
                               "product_attention(is_causal=True, "
                               "enable_gqa=True), minus its forward",
                  library_note="SDPA's backward computes dq, dk and dv in "
                               "one call",
                  plain_note="flash_bwd_ref computes dq, dk and dv in one "
                             "call",
                  families_train={a: {k: v for k, v in f.items()
                                      if k in ("steps", "wall_s", "layers",
                                               "seq", "k7_calls")}
                                  for a, f in ftrain.items()
                                  if isinstance(f, dict) and "steps" in f},
                  families_train_wall_s=ftrain["wall_s"])
    out = []
    # bf16: the fused kernel
    B, S, H, KV, hd = K7B_HD112_SHAPES["bfloat16"]
    qp, kp, vp, dop, lse, dD, kw = k7b_operands(
        B, S, H, KV, hd, "bfloat16", True, dev, seed=S + hd)
    ops = (qp, kp, vp, dop, lse, dD)
    call = lambda: flash_bwd(*ops, **kw)
    pairs = B * H * S * (S + 1) // 2
    rq, rk = 2 * B * S * hd * H, 2 * B * S * hd * KV
    flops = 10 * hd * pairs
    b, kind = bound(3 * rq + 4 * rk + 8 * B * H * S, flops, H100_BF16_FLOPS)
    ms = cuda_ms(call)
    r = dict(ms=ms, device_ms=early["flash_bwd_fused_hd112"], bound_ms=b,
             bound_by=kind, tflops=flops / (ms * 1e9),
             plain_ms=cuda_ms(lambda: flash_bwd_ref(*ops, **kw), reps=3))
    lib, sdpa_dq = sdpa_backward(qp, kp, vp, dop)
    r.update(lib)
    r["sdpa_dq_row_rel_diff"] = row_rel(call()[0].flatten(1, 2).float(),
                                        sdpa_dq)
    require(r["sdpa_dq_row_rel_diff"] <= 2 * K7B_ROW_RTOL["bfloat16"],
            f"SDPA and the fused K7 backward disagree on dq at hd 112: "
            f"{r['sdpa_dq_row_rel_diff']}")
    del sdpa_dq, ops, qp, kp, vp, dop, lse, dD
    torch.cuda.empty_cache()
    log(f"  flash_bwd fused at {(B, S, H, KV, hd)} bf16 causal: "
        + json.dumps(r))
    out.append(record(
        "flash_bwd_fused_hd112", by_path, errs, counter="flash_bwd_fused",
        replaces=f"{kernel_py}:91",
        replaces_all=[f"{kernel_py}:91", f"{kernel_py}:131"],
        ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=b, bound_by=kind,
        library_ms=r["library_ms"], device_ms=r["device_ms"],
        device_ms_from="phase 3", tflops_10hd=r["tflops"], timing=r,
        shape=f"(B, S, H, KV, hd) = {(B, S, H, KV, hd)} bf16 causal, "
              f"zamba2-7b's shared attention layer in the train microbatch",
        **common))
    # fp32: K7 dq and dkv
    B, S, H, KV, hd = K7B_HD112_SHAPES["float32"]
    qp, kp, vp, dop, lse, dD, kw = k7b_operands(
        B, S, H, KV, hd, "float32", True, dev, seed=S + hd)
    ops = (qp, kp, vp, dop, lse, dD)
    dq, dk, dv = (torch.empty_like(t) for t in (qp, kp, vp))
    pairs = B * H * S * (S + 1) // 2
    rq, rk = 4 * B * S * hd * H, 4 * B * S * hd * KV
    f32 = {}
    for name, fn, flops, nbytes in (
            ("flash_bwd_dq", lambda: launch_dq(*ops, dq, **kw),
             6 * hd * pairs, 3 * rq + 2 * rk + 8 * B * H * S),
            ("flash_bwd_dkv", lambda: launch_dkv(*ops, dk, dv, **kw),
             8 * hd * pairs, 2 * rq + 4 * rk + 8 * B * H * S)):
        b, kind = bound(nbytes, flops, H100_FP32_FLOPS)
        ms = cuda_ms(fn, reps=5)
        f32[name] = dict(ms=ms, device_ms=early[name + "_hd112"], bound_ms=b,
                         bound_by=kind, tflops=flops / (ms * 1e9))
    f32["plain_ms"] = cuda_ms(lambda: flash_bwd_ref(*ops, **kw), reps=2)
    lib, _ = sdpa_backward(qp, kp, vp, dop, reps=3)
    f32.update(lib)
    del ops, qp, kp, vp, dop, lse, dD, dq, dk, dv
    torch.cuda.empty_cache()
    log(f"  flash_bwd dq / dkv at {(B, S, H, KV, hd)} fp32 causal: "
        + json.dumps(f32))
    for name, line in (("flash_bwd_dq", 91), ("flash_bwd_dkv", 131)):
        k = f32[name]
        out.append(record(
            name + "_hd112", by_path, errs, counter=name,
            replaces=f"{kernel_py}:{line}", ms=k["ms"],
            plain_ms=f32["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=f32["library_ms"],
            library_fwd_bwd_ms=f32["library_fwd_bwd_ms"],
            device_ms=k["device_ms"], device_ms_from="phase 3",
            tflops=k["tflops"],
            shape=f"(B, S, H, KV, hd) = {(B, S, H, KV, hd)} fp32 causal, "
                  f"zamba2-7b's shared attention layer",
            **common))
    return out


# the sweep of K1 / K4 launch plans: (rows a CTA, threads at most)
ROW_SWEEP = [(r, t) for r in (32, 64, 128, 256) for t in (128, 256, 512)]


def row_plan_sweep(dev):
    """K1 and K4's device time (queued) under each launch plan of
    ``ROW_SWEEP`` at the timed shapes (K1 packed and K4 packed: 2 lanes x
    512 x 64 words per-lane; K1 prefix2: 1,024 positions [Q ++ P] through
    idx over 512 rows; K4 prefix: 512 positions through idx, p = 255) and
    past the residency gate (one lane of 26,000 x 813 words, scalar
    loads); then that large shape's call, plain and bound.  Logged."""
    import torch
    from repro_torch.kernels.dispatch import aligned16, plan_rows
    from repro_torch.kernels.fused_check import ops as fco
    from repro_torch.kernels.fused_select import ops as fso
    wide = row_case_inputs("wide", True, 21, dev)
    big = row_case_inputs("large", False, 22, dev)
    one = {k: (v[:1] if k not in ("adj", "split") else v)
           for k, v in wide.items()}
    one["adj"] = wide["adj"][:1]
    p255 = torch.full((1,), 255, dtype=torch.int32, device=dev)
    q_hi = torch.full((1,), 200, dtype=torch.int32, device=dev)

    def shapes(x, tag):
        a, m, nlp = x["adj"], x["mask"], x["nlp"]
        n, w = a.shape[-2:]
        lanes = m.shape[0]
        vec = aligned16(a, m, w)
        yield (f"K1 packed {tag}", n, w, lanes, vec,
               lambda pl: fco._launch("sweep", "packed", a, m, nlp, x["qw"],
                                      x["pw"], with_counts=True, plan=pl))
        yield (f"K4 packed {tag}", n, w, lanes, vec,
               lambda pl: fso._launch("sweep", "packed", a, m, x["words"],
                                      plan=pl))
    for label, n, w, lanes, vec, fn in [
            *shapes(wide, "2 x 512 x 64"), *shapes(big, "1 x 26000 x 813")]:
        row = {}
        for r, t in ROW_SWEEP:
            row[f"{r}/{t}"] = round(queued_ms(
                lambda: fn(plan_rows(n, w, lanes, vec, r, t))), 5)
        log(f"  plan sweep {label} (rows a CTA / threads at most -> queued "
            f"device ms): " + json.dumps(row))
    idx2 = halves_idx(one["idx"])
    a1, m1 = one["adj"], one["mask"]
    for label, n, fn in (
            ("K1 prefix2 1 x 1024 positions through idx", 1024,
             lambda pl: fco._launch("sweep", "prefix2", a1, m1, one["nlp"],
                                    q_hi, p255, with_counts=False, idx=idx2,
                                    split=512, plan=pl)),
            ("K4 prefix 1 x 512 positions through idx, p = 255", 512,
             lambda pl: fso._launch("sweep", "prefix", a1, m1, p255,
                                    idx=one["idx"], plan=pl))):
        row = {}
        for r, t in ROW_SWEEP:
            row[f"{r}/{t}"] = round(queued_ms(
                lambda: fn(plan_rows(n, 64, 1, True, r, t))), 5)
        log(f"  plan sweep {label}: " + json.dumps(row))
    # past the residency gate: the default plan's call, device and plain
    x = big
    n, w = x["adj"].shape
    calls = row_calls(x)
    for name in ("fused_select", "fused_check_packed"):
        f, args, kw = calls[name]
        ms = cuda_ms(lambda: f(*args, impl="pallas", **kw), reps=10)
        qms = queued_ms(lambda: f(*args, impl="pallas", **kw), reps=10)
        plain = cuda_ms(lambda: f(*args, impl="jnp", **kw), reps=3)
        # K4 dense reads its active rows, K1 every row; bytes bound
        rows_read = int((x["act"] > 0).sum()) if "select" in name \
            else ROW_LANES * n
        b, kind = bound(4 * rows_read * w, 2 * rows_read * w)
        log(f"  {name} at {ROW_LANES} lanes x {n} x {w} (shared adj, past "
            f"the residency gate): {ms:.4f} ms/call, queued {qms:.4f} ms, "
            f"plain {plain:.3f} ms, bound {b:.5f} ms ({kind}), plan "
            f"{plan_rows(n, w, ROW_LANES, False)}")


NO_LIBRARY = ("no single PyTorch call computes it: torch has no popcount "
              "op, so an AND + popcount row reduction is several calls")


def slice2_times(dev, by_path, errs):
    """K4 (packed), K6 (the gathered K4 prefix and K1 prefix2 kinds) and
    K5 at their own paths' shapes, bucket 512 x 2048 (N = 512, W = 64)
    with per-lane adjacency: the compact kernels on one dblp-like lane,
    their operands (P, Q, L, the level pointers) taken from a mid-run
    compact state, and the packed select on the 2-lane deg_nocache pool
    (dblp-like + corp-leadership) mid-run.  ``bound_ms`` counts the rows
    each call's function needs from this run's operands (read through
    ``idx`` once each), the index and activity operands and the outputs;
    its operations are one AND + one popcount per word read."""
    import torch
    from repro_torch.core import bitset
    from repro_torch.core import engine_dense as ed
    from repro_torch.core.engine import COMPACT
    from repro_torch.data.generators import dataset_suite
    from repro_torch.kernels import fused_check as fc
    from repro_torch.kernels import fused_select as fs
    from repro_torch.kernels.intersect_count.ops import intersect_count
    bench = dataset_suite("bench")
    out = []
    # the lane right after the init task of the middle root: level 0 with
    # half of U in Q and half in P, the forced root's step next
    g = bench["dblp-like"].canonical()
    cfg, ctx, s0 = bucket_pool([g], dev, engine="compact")
    s = COMPACT.run_batch(ctx, cfg, s0._replace(
        tpos=torch.full_like(s0.tpos, g.n_u // 2)), max_steps=1,
        ctx_batched=True)
    ar = torch.arange(1, device=dev)
    lvl = s.lvl.clamp(min=0)
    L = s.lmask[ar, lvl]
    p = s.p_ptr[ar, lvl]
    q_hi = s.q_ptr[ar, lvl]
    Lp = L & ctx.adj[ar, s.forced_x.clamp(min=0)]
    nLp = bitset.count(Lp)
    idx2 = torch.cat([s.Q, s.P], dim=-1)
    p_work = p                              # the root is forced: no pop
    n, w = cfg.n_u, cfg.wv
    pv, qv, pw = int(p[0]), int(q_hi[0]), int(p_work[0])
    shape = (f"bucket 512x2048, 1 lane, per-lane adj, dblp-like's state "
             f"after the init task of root {g.n_u // 2}")
    row_b = 4 * w
    specs = [
        ("fused_select_gathered_prefix", "fused_select_kernel",
         lambda impl: fs.fused_select_gathered_prefix(ctx.adj, s.P, L, p,
                                                      impl=impl),
         # rows [0, p) through idx, idx[0:p], mask, p; (idx, val) out
         (pv * (row_b + 4) + row_b + 4 + 8, pv * w),
         "src/repro_torch/csrc/fused_select.cu",
         "src/repro/kernels/fused_select/kernel.py:67",
         f"{shape}, prefix p = {pv} of N = {n}"),
        ("fused_check_gathered_prefix2", "fused_check_kernel",
         lambda impl: fc.fused_check_gathered_prefix2(
             ctx.adj, idx2, Lp, nLp, q_hi, p_work, impl=impl),
         # nz needs every one of the 2N rows: rows + idx, mask, |L'|,
         # bounds; viol + 3 bool flags per row out
         (2 * n * (row_b + 4) + row_b + 12 + 4 + 3 * 2 * n, 2 * n * w),
         "src/repro_torch/csrc/fused_check.cu",
         "src/repro/kernels/fused_check/kernel.py:81",
         f"{shape}, prefix2 over 2N = {2 * n} rows [Q ++ P], q_hi = {qv}, "
         f"p_hi = {pw}"),
        ("intersect_count", "intersect_count_kernel",
         lambda impl: intersect_count(ctx.adj, L, idx=s.P, impl=impl),
         # every row through idx, idx, mask; counts out
         (n * (row_b + 4) + row_b + 4 * n, n * w),
         "src/repro_torch/csrc/intersect_count.cu",
         "src/repro/kernels/intersect_count/kernel.py:32",
         f"{shape}, gathered through P (N = {n})"),
    ]
    # the packed select on its own path's pool, each lane right after the
    # init task of its middle root
    pair = [bench["dblp-like"], bench["corp-leadership"]]
    dcfg, dctx, d0 = bucket_pool(pair, dev, order_mode="deg_nocache",
                                 resident=False)
    mid = torch.tensor([x.canonical().n_u // 2 for x in pair],
                       dtype=torch.int32, device=dev)
    d = ed.run_batch(dctx, dcfg, d0._replace(tpos=mid), max_steps=1,
                     ctx_batched=True)
    ar2 = torch.arange(2, device=dev)
    dl = d.lvl.clamp(min=0)
    dL, pm = d.lmask[ar2, dl], d.pmask[ar2, dl]
    act_rows = int(bitset.count(pm).sum())
    specs.append((
        "fused_select_packed", "fused_select_kernel",
        lambda impl: fs.fused_select_packed(dctx.adj, dL, pm, impl=impl),
        # active rows of both lanes, masks, activity words; 2 x 8 B out
        (act_rows * row_b + 2 * (row_b + 4 * dcfg.wu + 8), act_rows * w),
        "src/repro_torch/csrc/fused_select.cu",
        "src/repro/kernels/fused_select/kernel.py:67",
        f"bucket 512x2048, 2 lanes (dblp-like + corp-leadership) per-lane "
        f"adj, deg_nocache resident=False, after the init task of each "
        f"lane's middle root, {act_rows} active rows"))
    for name, kname, fn, (nbytes, nwords), src, rep, shp in specs:
        got, want = fn("pallas"), fn("jnp")
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max_err(got, want)
        require(err == 0, f"{name} differs at its path's shape ({err})")
        errs[name] = max(errs[name], err)
        ms = cuda_ms(lambda: fn("pallas"))
        plain = cuda_ms(lambda: fn("jnp"))
        dms = device_ms(lambda: fn("pallas"), kname)
        qms = queued_ms(lambda: fn("pallas"))
        b, kind = bound(nbytes, 2 * nwords)
        out.append(record(name, by_path, errs, source=src, replaces=rep,
                          ms=ms, plain_ms=plain, bound_ms=b, bound_by=kind,
                          library_ms=None, library_note=NO_LIBRARY,
                          device_ms=dms, queued_ms=qms, shape=shp))
    # K1's dense kind through idx (fused_check_gathered): no main path
    # launches it (its count stays 0 there); timed at the compact lane's
    # shape over the same 2N rows [Q ++ P] with activity as prefix2 reads
    # it, for its PERF.md row; logged, not in the kernels line
    pos = torch.arange(2 * n, device=dev)[None]
    q_act = (pos < qv).to(torch.int32)
    p_act = ((pos >= n) & (pos < n + pw)).to(torch.int32)

    def k1_dense(impl):
        return fc.fused_check_gathered(ctx.adj, idx2, Lp, nLp, q_act, p_act,
                                       impl=impl)
    err = max_err(k1_dense("pallas"), k1_dense("jnp"))
    require(err == 0, f"fused_check_gathered differs ({err})")
    b, kind = bound(2 * n * (row_b + 4) + row_b + 4 + 2 * 2 * n + 3 * 2 * n,
                    2 * 2 * n * w)
    k1d = dict(ms=cuda_ms(lambda: k1_dense("pallas")),
               device_ms=device_ms(lambda: k1_dense("pallas"),
                                   "fused_check_kernel"),
               queued_ms=queued_ms(lambda: k1_dense("pallas")),
               plain_ms=cuda_ms(lambda: k1_dense("jnp")), bound_ms=b,
               bound_by=kind, max_abs_err=err, library_ms=None)
    log(f"  fused_check_gathered (K1 dense through idx) at {shape}, 2N = "
        f"{2 * n} rows: " + json.dumps(k1d))
    # the device's busy share over a compact request's window: the
    # dblp-like lane's engine loop, steps_per_call = 16, 256 steps from the
    # state above
    wall, busy, by_kernel = profile_window(lambda: COMPACT.run_batch(
        ctx, cfg, s, max_steps=256, ctx_batched=True, unroll=16))
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:4]
    share = None if busy is None else busy / wall
    log(f"  profile compact dblp-like spc=16 (256 steps from root "
        f"{g.n_u // 2}): wall {wall:.4f} s, device busy {busy} s, "
        f"busy share {share}, {sum(v[1] for v in by_kernel.values())} "
        f"kernels; top kernels " + json.dumps(
            [(k[:60], round(v[0], 6), v[1]) for k, v in top]))
    return out


# ---------------------------------------------------------------------------

def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke.py: src/repro_torch not found next to the script",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, SRC)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    assert "jax" not in sys.modules
    # fp32 products in full fp32: the plain versions are the yardstick
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
        if ("registers" in line or "Compiling entry" in line
                or "spill" in line or "C75" in line):
            log("  ptxas " + line.strip())
    log("  flash_bwd_fused dynamic shared memory (bytes) by head dim: "
        + json.dumps({hd: _build.library().rt_flash_bwd_fused_smem(hd)
                      for hd in (16, 32, 64, 112, 128)}))
    t0 = time.perf_counter()
    errs = dict(fused_check_packed=check_fused_check(dev, seed=0))
    n, errs["resident_pool"], errs["resident_step"] = check_resident(dev)
    n_shared, err_shared = check_resident_shared(dev)
    n += n_shared
    errs["resident_pool"] = max(errs["resident_pool"], err_shared)
    errs.update(check_slice2_kernels(dev))
    for k, v in check_row_kernels(dev).items():
        errs[k] = max(errs.get(k, 0), v)
    errs["intersect_count"] = max(errs["intersect_count"],
                                  check_k5_tiles(dev))
    errs.update(check_k7(dev))
    bwd_errs, _, bwd_early = check_k7_bwd(dev)
    errs.update(bwd_errs)
    log(f"[kernels] {n} pool configurations + lanes bit-exact, max |err| "
        f"{errs}, {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path = main_path(dev, smi_line)
    lm = lm_path(dev, by_path)
    fam = families_path(dev, by_path)
    train = train_path(dev, by_path)
    ftrain = families_train_path(dev, by_path)
    log(f"[main] {time.perf_counter() - t0:.1f} s, launches by path "
        f"{json.dumps({k: nonzero(c) for k, c in by_path.items()})}")
    t0 = time.perf_counter()
    fwd = k7_times(dev, by_path, errs, lm)
    bwd, fwd[0]["fp32_at_2x4096"] = k7_bwd_times(dev, by_path, errs, train,
                                                 bwd_early)
    fwd.append(k7_hd112_times(dev, by_path, errs, fam))
    bwd += k7_bwd_hd112_times(dev, by_path, errs, ftrain, bwd_early)
    rec = times(dev, by_path, errs) + fwd + bwd
    log(f"[times] {time.perf_counter() - t0:.1f} s; [total] "
        f"{time.perf_counter() - t_start:.1f} s")
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
