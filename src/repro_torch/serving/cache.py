"""Executable cache for the serving layer.

Twin of ``src/repro/serving/cache.py``.  A reference entry is a JAX AOT
executable; a port entry is the callable for one
``(cfg, batch, budget, unroll, pool)`` identity — PyTorch runs eagerly
and the CUDA kernels are built once per process, so there is nothing to
compile per identity and ``compile_s`` stays 0.0.  The keys, the LRU
bound and the counters are the reference's: ``misses`` counts the
distinct identities that ran (a failed first call rolls its miss back),
so it equals the reference's ``misses`` on the same stream.
"""
from __future__ import annotations

import collections
import time
from typing import Callable

import torch

from repro_torch.core.distributed import Sharded
from repro_torch.core.engine import DENSE, Engine
from repro_torch.kernels.dispatch import check_device


class CacheEntry:
    """One batched enumeration callable.  The first successful call
    commits the entry (``on_compiled``); a failing first call drops it
    and rolls back its miss (``on_failed``), as in the reference."""

    __slots__ = ("_fn", "_ran", "compile_s", "_on_compiled", "_on_failed")

    def __init__(self, fn, on_compiled=None, on_failed=None):
        self._fn = fn
        self._ran = False
        self.compile_s = 0.0
        self._on_compiled = on_compiled
        self._on_failed = on_failed

    @property
    def compiled(self) -> bool:
        return self._ran

    def __call__(self, ctx, s):
        if self._ran:
            return self._fn(ctx, s)
        try:
            out = self._fn(ctx, s)
        except Exception:
            if self._on_failed is not None:
                self._on_failed(self)
            raise
        self._ran = True
        if self._on_compiled is not None:
            self._on_compiled(self)
        return out

    def timed_call(self, ctx, s):
        """Blocking call: ``(out, wall_s, compile_s)``; on the card the
        wall time ends in ``torch.cuda.synchronize()`` of every device
        the state lies on (each shard's of a ``Sharded`` one)."""
        devs = s.mesh.devices if isinstance(s, Sharded) else (s.lvl.device,)
        t0 = time.perf_counter()
        out = self(ctx, s)
        for dev in dict.fromkeys(devs):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0, 0.0


class ExecutableCache:
    """LRU cache of ``CacheEntry`` objects, bounded at ``capacity``."""

    DEFAULT_CAPACITY = 256

    def __init__(self, capacity: int | None = DEFAULT_CAPACITY):
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity must be >= 1 or None, got {capacity}")
        self.capacity = capacity
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get_entry(self, key, build: Callable[[], object]) -> CacheEntry:
        """Keyed lookup; on a miss ``build()`` returns the
        ``(ctx, state) -> state`` callable of the new entry."""
        entry = self._entries.get(key)
        if entry is not None:
            self.hits += 1
            self._entries.move_to_end(key)
            return entry
        self.misses += 1
        entry = CacheEntry(build(),
                           on_compiled=lambda e: self._commit(key, e),
                           on_failed=lambda e: self._discard(key, e))
        self._entries[key] = entry
        if self.capacity is not None and len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1
        return entry

    def _discard(self, key, entry: CacheEntry) -> None:
        if self._entries.get(key) is entry:
            del self._entries[key]
            self.misses = max(self.misses - 1, 0)

    def _commit(self, key, entry: CacheEntry) -> None:
        if key in self._entries:
            return
        self.misses += 1
        self._entries[key] = entry
        if self.capacity is not None and len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1

    def get_round(self, cfg, batch: int, max_steps: int | None = None,
                  engine: Engine | None = None, unroll: int = 1,
                  device="cuda") -> CacheEntry:
        """Local-backend batched enumeration callable
        ``(ctx, state) -> state`` over ``batch`` lanes on ``device``, with
        the reference's key (``("pool", width)`` appended only when the
        pool kernel serves this (cfg, batch))."""
        eng = engine or DENSE
        device = check_device(device)

        def build():
            def fn(ctx, s):
                return eng.run_batch(ctx, cfg, s, max_steps=max_steps,
                                     ctx_batched=True, unroll=unroll)
            return fn

        head = cfg if eng.name == DENSE.name else (eng.name, cfg)
        key = (head, batch, max_steps) if unroll == 1 \
            else (head, batch, max_steps, unroll)
        pw = eng.pool_lanes(cfg, batch, device)
        if pw:
            key = key + (("pool", pw),)
        return self.get_entry(key, build)

    def get(self, cfg, batch: int, device="cuda") -> CacheEntry:
        """Run-to-completion callable (drain entry)."""
        return self.get_round(cfg, batch, None, device=device)

    def stats(self) -> dict:
        return dict(hits=self.hits, misses=self.misses,
                    entries=len(self._entries), evictions=self.evictions)

    def reset_counters(self) -> None:
        self.hits = 0
        self.misses = 0
        self.evictions = 0
