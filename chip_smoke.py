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
              pool, and the 1024 x 4096 bucket whose adjacency does not
              fit in shared memory) in every order mode, steps_per_call 1
              and 16, rebalance off and on, at every segment boundary;
              intersect_count (plain and through idx), every fused_select
              kind and the dense/prefix2 fused_check kinds (plain and
              gathered, counts on/off) at (128, 8), (512, 64), (1024, 128)
              and (100, 5), shared and per-lane adjacency, 1 and 8 lanes,
              random rows, all rows tied, nothing active (p = 0) and
              |L'| = 0; flash_fwd (K7) against its plain version at the
              qwen3-1.7b prefill layer shapes (1, 4096), (4, 4096) and
              (1, 32768) (its first and last 512 query rows), bf16 and
              fp32, causal, ragged (S = 1000 and 4097) and non-causal,
              hd 64 with G = 3, element-wise and per query row
              (tolerances at K7_TOL, K7_ROW_RTOL), every case run twice
              with bit-identical o and lse, and two planted faults the
              check must flag; the K7 backward
              (bf16: the fused dq / dk / dv kernel; fp32: K7 dq and dkv)
              against ``flash_bwd_ref`` at the training layer shapes
              (1, 4096) and (2, 4096), bf16 and fp32, causal, ragged
              (S = 1000 and 4097), non-causal and hd 64 with G = 3, per
              output row and scaled (K7B_ROW_RTOL, K7B_SCALED_TOL); the
              fused kernel's dk / dv bit-identical across two runs and dq
              within K7B_DQ_RERUN_RTOL (its atomics), the fp32 kernels'
              dq, dk, dv bit-identical; three planted faults on the fused
              kernel (lse offset past row 512, dD zeroed, a non-zero dq
              accumulator) and the lse offset on the fp32 kernels, which
              the check must flag; the fp32 plain version, kernels and
              3xTF32 emulation against the plain version in float64
              (logged);
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
              512 x 2048 pool) and the dense unfused path with
              impl='pallas' (intersect_count); every n_max and cs against
              the oracle, every kernel's launch count > 0 on its path;
              then the LM paths of qwen3-1.7b at full width (random
              weights from seed 0): ``make_prefill_step`` with
              attn_impl='pallas' at (1, 32768) and (4, 4096), exactly one
              K7 launch per layer, logits against attn_impl='xla' at
              the last position and at every position, every K7 call of
              the checked forward against its plain version, and a
              planted K7 fault that both checks must flag;
              decode == prefill in fp32; the LM ``serve`` loop; then
              the training paths of qwen3-1.7b at full width: the train
              step's fp32 grads (remat on, microbatch (2, 4096) from the
              port's SyntheticSource) with attn_impl='pallas' against
              'xla' per parameter, in bf16 at 28 layers (with a planted
              K7 bwd fault that must be flagged) and in fp32 at 2 layers
              (TRAIN_GRAD_RTOL); 3 AdamW steps with accum=2 on (4, 4096)
              (per step 112 K7 fwd, 56 fused bwd; finite loss and grad
              norm; params moved; peak memory) and a profiled step; the
              launcher ``repro_torch.launch.train`` at the smoke config
              with an injected failure, resumed at its checkpointed data
              step;
5. times    — per-kernel CUDA-event and profiler times at each kernel's
              own path's shapes beside the plain version and the bound
              (and for K7 the time of ``F.scaled_dot_product_attention``
              on the same operands, and for the K7 backward SDPA's
              backward; the fp32 K7 forward, dq and dkv at (2, 4096)
              beside SDPA's fp32 forward and backward and the kernels
              SDPA ran for them),
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
)
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
    |err| of o over the cases.  Also takes K7's stand-alone device time
    at K7_TIME_SHAPES into K7_EARLY."""
    import torch
    from repro_torch.kernels.flash_attention import flash_fwd
    worst = 0.0
    for i, (B, S, H, KV, hd, dt, causal, rows) in enumerate(K7_CASES):
        qp, kp, vp = k7_operands(B, S, H, KV, hd, dt, dev, seed=100 + i)
        kw = dict(causal=causal, scale=hd ** -0.5, sq=S, sk=S)
        o, lse = flash_fwd(qp, kp, vp, **kw)
        torch.cuda.synchronize()
        if (B, S, H, KV, hd) in K7_TIME_SHAPES and dt == "bfloat16":
            K7_EARLY[S] = device_ms(lambda: flash_fwd(qp, kp, vp, **kw),
                                    K7_FWD_KERNEL, reps=20 if S < 32768 else 5)
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
        worst = max(worst, e["abs"])
        if i == 0:
            # controls: the kernel with a planted fault, held against the
            # plain version of the right function, must come out wrong
            for what, args, ckw in (
                    ("late V tiles misplaced",
                     (qp, kp, late_v_tiles_misplaced(vp)), kw),
                    ("non-causal mask", (qp, kp, vp),
                     dict(kw, causal=False))):
                co, cl = flash_fwd(*args, **ckw)
                ce = k7_errors(qp, kp, vp, co, cl, spans=k7_spans(S, rows),
                               **kw)
                log(f"  control ({what}) at {K7_CASES[i][:5]}: o max |err| "
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
)
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


def check_k7_bwd(dev):
    """The K7 backward against ``flash_bwd_ref`` on the card at K7B_CASES
    (bf16: the fused kernel; fp32: K7 dq and dkv), their determinism
    (fused: dk, dv bit-identical across two runs, dq within
    K7B_DQ_RERUN_RTOL; fp32: dq, dk, dv bit-identical), then planted
    faults that the check must flag: for the fused kernel the lse of
    query rows from K7B_FAULT_ROW on offset by +0.7, dD zeroed, and the dq
    accumulator handed to the kernel filled with non-zero values; for the
    fp32 kernels the same lse offset.  Logs, at the first fp32 case, the
    fp32 plain version, the kernels and the plain version's 3xTF32
    emulation against the plain version in float64.  Returns the largest
    max |err| of each kernel over its cases, the readings, and the fp32
    kernels' device times per launch at K7B_TIME_SHAPES[1] with the
    kernels SDPA runs for its fp32 forward and backward there."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_bwd, flash_bwd_ref,
                                                     flash_fwd)
    from repro_torch.kernels.flash_attention.ops import (launch_bwd,
                                                        launch_dkv, launch_dq)
    from repro_torch.kernels.flash_attention.ref import flash_bwd_3xtf32_ref
    worst = {"flash_bwd_fused": 0.0, "flash_bwd_dq": 0.0,
             "flash_bwd_dkv": 0.0}
    readings, early = {}, {}
    first_f32 = True
    for i, (B, S, H, KV, hd, dt, causal) in enumerate(K7B_CASES):
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
            worst["flash_bwd_fused"] = max(worst["flash_bwd_fused"],
                                           *(v["abs"] for v in e.values()))
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
        else:
            worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], e["dq"]["abs"])
            worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"],
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
                # control: the fp32 kernels given a wrong lse, held
                # against the plain version on the right one
                first_f32 = False
                bad_lse = lse.clone()
                bad_lse[..., K7B_FAULT_ROW:] += 0.7
                ce = k7b_errors(flash_bwd(qp, kp, vp, dop, bad_lse, dD, **kw),
                                want)
                flagged = not k7b_ok(ce, dt)
                what = f"fp32 lse + 0.7 from row {K7B_FAULT_ROW}"
                readings[f"control: {what}"] = ce
                log(f"  control ({what}) at {K7B_CASES[i][:5]}: "
                    f"{k7b_brief(ce)}: flagged {flagged}")
                require(flagged, f"K7 bwd check passes a planted fault "
                                 f"({what}): {ce}")
                del bad_lse
        del got
        if i == 0:
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
                readings[f"control: {what}"] = ce
                log(f"  control ({what}) at {K7B_CASES[i][:5]}: "
                    f"{k7b_brief(ce)}: flagged {flagged}")
                require(flagged, f"K7 bwd check passes a planted fault "
                                 f"({what}): {ce}")
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
    return by_path


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


def train_batch(cfg, rows, step, dev):
    """Rows ``rows`` of the port's SyntheticSource batch ``step`` at
    TRAIN_SEQ, on the card."""
    import torch
    from repro_torch.datapipe import DataConfig, SyntheticSource
    src = SyntheticSource(DataConfig(batch=rows, seq_len=TRAIN_SEQ,
                                     vocab=cfg.vocab, seed=0))
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
                      control=False):
    """The train step's grads, K7 path against the torch-op path; with
    ``control`` also the planted K7 bwd fault, which must be flagged."""
    import torch
    L = cfg.n_layers
    pal = dataclasses.replace(cfg, attn_impl="pallas", dtype=dtype)
    xla = dataclasses.replace(cfg, attn_impl="xla", dtype=dtype)
    t = time.perf_counter()
    gx, cx = probe_grads(xla, master, batch)
    wall_x = time.perf_counter() - t
    t = time.perf_counter()
    gp, cp = probe_grads(pal, master, batch)
    wall_p = time.perf_counter() - t
    by_path[label] = cp
    # remat: two K7 fwd a layer; the backward is the fused kernel in bf16,
    # K7 dq + dkv in fp32
    bwd = ((L, 0, 0) if dtype == "bfloat16" else (0, L, L))
    want = (2 * L,) + bwd
    require((cp["flash_fwd"], cp["flash_bwd_fused"], cp["flash_bwd_dq"],
             cp["flash_bwd_dkv"]) == want and sum(cp.values()) == sum(want)
            and not any(cx.values()),
            f"{label}: launches {nonzero(cp)}, torch-op path {nonzero(cx)};"
            f" expected (fwd, fused, dq, dkv) = {want}")
    sound = grad_errors(gp, gx)
    del gp
    out = dict(wall_s=wall_p, xla_wall_s=wall_x, grads=sound,
               launches=nonzero(cp))
    log(f"  {label}: {wall_p:.3f} s (torch-op path {wall_x:.3f} s), "
        f"launches {nonzero(cp)}; grads vs torch-op path: "
        + json.dumps(sound) + f" (tol {TRAIN_GRAD_RTOL[dtype]})")
    if control:
        gc, _ = probe_grads(pal, master, batch, fault=True)
        out["control"] = grad_errors(gc, gx)
        del gc
        flagged = out["control"]["max"] > TRAIN_GRAD_RTOL[dtype]
        log(f"  {label} control (K7 bwd with dD zeroed in every layer): "
            + json.dumps(out["control"]) + f"; flagged {flagged}")
        require(flagged, f"{label}: the planted K7 bwd fault passed: "
                         f"{out['control']}")
    del gx
    torch.cuda.empty_cache()
    require(sound["max"] <= TRAIN_GRAD_RTOL[dtype],
            f"{label}: grads differ from the torch-op path: {sound}")
    return out


def train_path(dev, by_path):
    """Drive the training paths of qwen3-1.7b at full width; adds each
    one's launch counts to ``by_path`` and returns what phase 5 reports."""
    import shutil
    import torch
    from repro_torch import configs
    from repro_torch.launch.train import train
    from repro_torch.models import model as M
    from repro_torch.models.layers import init_params
    from repro_torch.training.optimizer import adamw
    from repro_torch.training.step import make_train_step
    cfg = dataclasses.replace(configs.get_config(LM_ARCH), remat=True,
                              attn_impl="pallas")
    L = cfg.n_layers
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
    opt = adamw(peak_lr=3e-4, warmup=1, total_steps=TRAIN_STEPS + 1)
    step = make_train_step(cfg, opt, accum=TRAIN_ACCUM)
    params = init_params(M.param_specs(cfg), 0, device=dev)
    state = opt.init(params)
    before = {k: params[k][..., :64].clone() for k in ("layers/attn/wq",
                                                       "lm_head/w")}
    batches = [train_batch(cfg, B, i, dev) for i in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    walls, hist = [], []
    for i in range(TRAIN_STEPS):
        n = counters()
        t = time.perf_counter()
        params, state, m = step(params, state, batches[i])
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
            TRAIN_STEPS, f"{label}: params moved {moved}, step "
                         f"{int(state.step)}")
    wall = sum(walls[1:]) / len(walls[1:])
    info["steps"] = dict(history=hist, walls_s=walls, wall_s=wall,
                         tok_per_s=B * TRAIN_SEQ / wall, peak_gb=peak / 1e9,
                         moved=moved, launches=nonzero(c))
    log(f"  {label}: {TRAIN_STEPS} AdamW steps, " + json.dumps(
        info["steps"]))
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
    ckpt = os.path.join(HERE, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    reset_counters()
    t = time.perf_counter()
    out = train(TRAIN_LAUNCH + ["--ckpt-dir", ckpt], device=str(dev))
    wall = time.perf_counter() - t
    by_path["launcher --smoke"] = counters()
    losses = [x for _, x in out["history"]]
    require(out["restarts"] == 1 and out["starts"] == [0, 5] and losses
            and all(x == x and abs(x) != float("inf") for x in losses),
            f"launcher: {out}")
    info["launcher"] = dict(wall_s=wall, restarts=out["restarts"],
                            starts=out["starts"], history=out["history"])
    log(f"  launcher {' '.join(TRAIN_LAUNCH)}: " + json.dumps(
        info["launcher"]))
    shutil.rmtree(ckpt, ignore_errors=True)
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
    "flash_bwd_fused": f"train ({TRAIN_MICRO * TRAIN_ACCUM}, {TRAIN_SEQ}) "
                       f"accum={TRAIN_ACCUM}",
    "flash_bwd_dq": f"train grads ({TRAIN_MICRO}, {TRAIN_SEQ}) fp32 2 layers",
    "flash_bwd_dkv": f"train grads ({TRAIN_MICRO}, {TRAIN_SEQ}) fp32 2 "
                     f"layers",
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
                library_ms=None, device_ms=dms, shape=shape))
        else:
            log(f"  fused_check_packed at {shape}: {ms:.4f} ms/call (device "
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
    out += slice2_times(dev, by_path, errs)
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
        b, kind = bound(nbytes, 2 * nwords)
        out.append(record(name, by_path, errs, source=src, replaces=rep,
                          ms=ms, plain_ms=plain, bound_ms=b, bound_by=kind,
                          library_ms=None, library_note=NO_LIBRARY,
                          device_ms=dms, shape=shp))
    # K1's dense kind through idx (fused_check_gathered): no main path
    # launches it (its count stays 0 there); timed at the compact lane's
    # shape over the same 2N rows [Q ++ P] with activity as prefix2 reads
    # it, for its PERF.md row; logged, not in the kernels line
    pos = torch.arange(2 * n, device=dev)[None]
    q_act, p_act = pos < qv, (pos >= n) & (pos < n + pw)

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
                      for hd in (16, 32, 64, 128)}))
    t0 = time.perf_counter()
    errs = dict(fused_check_packed=check_fused_check(dev, seed=0))
    n, errs["resident_pool"], errs["resident_step"] = check_resident(dev)
    errs.update(check_slice2_kernels(dev))
    errs["flash_fwd"] = check_k7(dev)
    bwd_errs, _, bwd_early = check_k7_bwd(dev)
    errs.update(bwd_errs)
    log(f"[kernels] {n} pool configurations + lanes bit-exact, max |err| "
        f"{errs}, {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path = main_path(dev)
    lm = lm_path(dev, by_path)
    train = train_path(dev, by_path)
    log(f"[main] {time.perf_counter() - t0:.1f} s, launches by path "
        f"{json.dumps({k: nonzero(c) for k, c in by_path.items()})}")
    t0 = time.perf_counter()
    fwd = k7_times(dev, by_path, errs, lm)
    bwd, fwd[0]["fp32_at_2x4096"] = k7_bwd_times(dev, by_path, errs, train,
                                                 bwd_early)
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
