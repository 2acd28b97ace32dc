"""Deterministic, restartable data pipeline.

A copy of ``src/repro/datapipe/pipeline.py`` (numpy only; the port
imports nothing of the JAX package), batch for batch identical to it.

Fault-tolerance contract: a batch is a pure function of (source, step,
host), never of wall-clock or iterator state. After a crash+restore to
step N the pipeline resumes at batch N bit-identically — no data loss, no
replay skew. That single property is what makes checkpoint/restart exact.

* ``SyntheticSource`` — counter-based hash stream (stateless, infinite).
* ``MemmapSource`` — flat token file (np.memmap) cut into fixed windows;
  step-indexed shuffled addressing via a Feistel permutation (stateless
  shuffle, no epoch buffer to checkpoint).
* per-host sharding: host h of H takes batch rows [h*B/H, (h+1)*B/H) — on
  a multi-host pod each host materializes only its slice (the
  ``host_slice`` arg; this box always has slice (0,1)).
* ``make_pipeline`` adds a background prefetch thread with a bounded queue
  (depth 2): host batch assembly overlaps device compute.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int                 # global batch (sequences)
    seq_len: int
    vocab: int
    n_codebooks: int = 0       # audio: tokens (B, S, CB)
    patch_tokens: int = 0      # vlm: extra patch embedding prefix
    d_model: int = 0           # vlm: patch embedding width
    seed: int = 0


def _hash_u32(x: np.ndarray) -> np.ndarray:
    """splitmix32-style avalanche on uint32 (vectorized, deterministic)."""
    x = x.astype(np.uint32)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


class SyntheticSource:
    """Infinite hash-stream tokens; batch(step) is pure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int, host_slice: tuple[int, int] = (0, 1)) -> dict:
        cfg = self.cfg
        h, H = host_slice
        rows = cfg.batch // H
        shape = (rows, cfg.seq_len + 1)
        if cfg.n_codebooks:
            shape = shape + (cfg.n_codebooks,)
        # element ids are positions in the GLOBAL batch: host h's rows are
        # exactly rows [h*rows, (h+1)*rows) of the full batch (sharding a
        # batch across hosts never changes its contents)
        per_row = int(np.prod(shape[1:]))
        base = np.uint32((step * 2654435761 + cfg.seed * 97) % (1 << 32))
        idx = (np.arange(rows * per_row, dtype=np.uint32)
               + np.uint32(h * rows * per_row))
        toks = (_hash_u32(idx + base) % np.uint32(cfg.vocab)).astype(
            np.int32).reshape(shape)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.patch_tokens:
            per_row_p = cfg.patch_tokens * cfg.d_model
            pidx = (np.arange(rows * per_row_p, dtype=np.uint32)
                    + np.uint32(h * rows * per_row_p))
            pe = _hash_u32(pidx + base + np.uint32(7))
            pe = (pe.astype(np.float32) / 2**31 - 1.0) * 0.02
            out["patch_emb"] = pe.reshape(
                rows, cfg.patch_tokens, cfg.d_model)
        return out


def _feistel_perm(i: np.ndarray, n: int, key: int, rounds: int = 4
                  ) -> np.ndarray:
    """Pseudorandom permutation of [0, n) via cycle-walking Feistel."""
    bits = max(int(n - 1).bit_length(), 2)
    half = (bits + 1) // 2
    mask = (1 << half) - 1
    out = i.astype(np.uint64)

    def one_pass(x):
        l = (x >> np.uint64(half)) & np.uint64(mask)
        r = x & np.uint64(mask)
        for rnd in range(rounds):
            f = _hash_u32((r + np.uint64(key * 0x9E3779B9 + rnd)).astype(
                np.uint32)).astype(np.uint64) & np.uint64(mask)
            l, r = r, l ^ f
        return (l << np.uint64(half)) | r

    out = one_pass(out)
    # cycle-walk until inside range (expected <2 iterations)
    for _ in range(64):
        over = out >= n
        if not over.any():
            break
        out = np.where(over, one_pass(out), out)
    return out.astype(np.int64)


class MemmapSource:
    """Flat token file -> fixed windows, Feistel-shuffled, step-indexed."""

    def __init__(self, cfg: DataConfig, path: str):
        self.cfg = cfg
        self.data = np.memmap(path, dtype=np.int32, mode="r")
        self.n_windows = (len(self.data) - 1) // cfg.seq_len
        if self.n_windows < 1:
            raise ValueError(f"{path}: file shorter than one window")

    def batch(self, step: int, host_slice: tuple[int, int] = (0, 1)) -> dict:
        cfg = self.cfg
        h, H = host_slice
        rows = cfg.batch // H
        flat = (np.int64(step) * cfg.batch + h * rows
                + np.arange(rows, dtype=np.int64))
        epoch = flat // self.n_windows
        within = flat % self.n_windows
        win = _feistel_perm(within, self.n_windows,
                            key=cfg.seed + 1) if self.n_windows > 1 \
            else within
        win = (win + epoch * 7919) % self.n_windows  # epoch-rotated
        starts = win * cfg.seq_len
        tok = np.stack([np.asarray(self.data[s: s + cfg.seq_len + 1])
                        for s in starts])
        return {"tokens": tok[:, :-1].astype(np.int32),
                "labels": tok[:, 1:].astype(np.int32)}


def make_pipeline(source, start_step: int = 0, *, prefetch: int = 2,
                  host_slice: tuple[int, int] = (0, 1)
                  ) -> Iterator[tuple[int, dict]]:
    """Background-prefetched (step, batch) iterator starting at start_step."""
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            try:
                q.put((step, source.batch(step, host_slice)), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    class _Iter:
        def __iter__(self):
            return self

        def __next__(self):
            return q.get()

        def close(self):
            stop.set()

    return _Iter()
