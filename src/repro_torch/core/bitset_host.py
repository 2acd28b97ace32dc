"""Host-side (numpy-only) bitset helpers.

Twin of ``src/repro/core/bitset_host.py``: a NumPy-only copy, so the
port never imports the JAX package.

Kept free of any JAX import so that process-pool oracle workers (ParMBE
stand-in) and data tooling can use them without dragging a JAX runtime into
forked/spawned subprocesses.
"""
from __future__ import annotations

import numpy as np

WORD = 32


def n_words(n: int) -> int:
    return (int(n) + WORD - 1) // WORD


def pack_indices(idx, n: int) -> np.ndarray:
    w = np.zeros(n_words(n), dtype=np.uint32)
    for i in idx:
        i = int(i)
        if not 0 <= i < n:
            raise ValueError(f"index {i} outside universe [0,{n})")
        w[i // WORD] |= np.uint32(1) << np.uint32(i % WORD)
    return w


def unpack(words: np.ndarray, n: int) -> list[int]:
    words = np.asarray(words, dtype=np.uint32)
    out = []
    for i in range(n):
        if (words[i // WORD] >> np.uint32(i % WORD)) & np.uint32(1):
            out.append(i)
    return out


def full_mask(n: int) -> np.ndarray:
    w = np.full(n_words(n), 0xFFFFFFFF, dtype=np.uint32)
    rem = n % WORD
    if rem:
        w[-1] = np.uint32((1 << rem) - 1)
    return w
