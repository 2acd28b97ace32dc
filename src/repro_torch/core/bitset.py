"""Packed bitset utilities on torch tensors.

Twin of ``src/repro/core/bitset.py``.  A set over a universe of size n is
a vector of ``ceil(n/32)`` words; bit v sits at bit v%32 of word v//32.

Words are **int32 bit patterns**: torch's ``uint32`` lacks ``>>``, ``<<``,
``+``, ``~``, ``index_put_`` and ``min``, so the port stores every word
as int32 and shows it as uint32 only at the NumPy boundary
(``.numpy().view(np.uint32)``).  Bitwise AND/OR/XOR/NOT are exact on the
bit patterns.  Everything that would shift, add or multiply a word (the
SWAR popcount, the logical shift, the checksums) widens to int64, works
on the unsigned value and wraps back mod 2**32 explicitly, so no result
depends on signed-overflow behaviour.

Index arithmetic keeps the reference's floor ``//`` and ``%`` semantics
for negative indices (torch's tensor ``//``/``%`` are floor/Python-sign
too): ``singleton(-1, nw)`` is the empty set, as in JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bitset_host import (  # noqa: F401
    WORD, full_mask, n_words, pack_indices, unpack)

_MASK32 = 0xFFFFFFFF
_INF = 0x7FFFFFFF


def _u64(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their unsigned values as int64."""
    return words.to(torch.int64) & _MASK32


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 bit patterns of ``x mod 2**32``."""
    x = x & _MASK32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def to_u32(x) -> np.ndarray:
    """Tensor of int32 bit patterns -> NumPy uint32 view (host copy)."""
    return np.array(x.detach().cpu().numpy(), dtype=np.int32).view(np.uint32)


def from_u32(a, device=None) -> torch.Tensor:
    """NumPy uint32 (or any int array holding 32-bit words) -> int32 bit
    pattern tensor on ``device``."""
    # np.array, not np.ascontiguousarray: the latter turns a 0-d leaf
    # (``cs``) into shape (1,)
    a = np.array(np.asarray(a).astype(np.uint32, copy=False), order="C")
    return torch.from_numpy(a.view(np.int32)).to(device)


def shr(words: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32 bit patterns (int32 ``>>`` is
    arithmetic: ``-1 >> 28 == -1``)."""
    return wrap32(_u64(words) >> k)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Per-word population count (SWAR on the unsigned value) -> int32."""
    x = _u64(words)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = (x * 0x01010101) & _MASK32
    return (x >> 24).to(torch.int32)


def count(words: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Cardinality of a packed bitset (int32)."""
    return popcount(words).sum(dim=axis, dtype=torch.int32)


# bit k as an int32 pattern (1 << 31 is INT32_MIN): a table, so no shift
# into the sign bit is ever evaluated
_BITS = [wrap32(torch.tensor(1 << k, dtype=torch.int64)).item()
         for k in range(WORD)]


_TABLES: dict = {}


def _table(name: str, device) -> torch.Tensor:
    """Per-device constant rows: ``bits`` (the 32 single-bit int32
    patterns) and ``weights`` (their unsigned values as int64)."""
    key = (name, str(device))
    t = _TABLES.get(key)
    if t is None:
        t = (torch.tensor(_BITS, dtype=torch.int32, device=device)
             if name == "bits" else
             torch.tensor([1 << k for k in range(WORD)], dtype=torch.int64,
                          device=device))
        _TABLES[key] = t
    return t


def _bit(i, device) -> torch.Tensor:
    return _table("bits", device)[torch.as_tensor(i, device=device) % WORD]


def member(words: torch.Tensor, i) -> torch.Tensor:
    """O(1) membership test of index ``i`` (scalar) in ``words``."""
    i = torch.as_tensor(i, device=words.device)
    w = words[..., i // WORD]
    return (w & _bit(i, words.device)) != 0


def singleton(i, nw: int) -> torch.Tensor:
    """Packed bitset {i} with ``nw`` words; ``i`` may carry leading lane
    dims (-> (..., nw)).  Negative ``i`` gives the empty set."""
    i = torch.as_tensor(i)
    dev = i.device
    word = (i // WORD).to(torch.int32)
    bit = _bit(i, dev)
    lanes = torch.arange(nw, dtype=torch.int32, device=dev)
    return torch.where(lanes == word[..., None], bit[..., None],
                       torch.zeros((), dtype=torch.int32, device=dev))


def add(words: torch.Tensor, i) -> torch.Tensor:
    """``words`` with bit ``i`` set (``i >= 0``)."""
    return words | singleton(torch.as_tensor(i, device=words.device),
                             words.shape[-1])


def remove(words: torch.Tensor, i) -> torch.Tensor:
    """``words`` with bit ``i`` cleared (``i >= 0``)."""
    return words & ~singleton(torch.as_tensor(i, device=words.device),
                              words.shape[-1])


def to_bool(words: torch.Tensor, n: int) -> torch.Tensor:
    """Expand packed words -> (..., n) bool."""
    bits = words[..., :, None] & _table("bits", words.device)
    flat = bits.reshape(words.shape[:-1] + (words.shape[-1] * WORD,))
    return flat[..., :n] != 0


def from_bool(mask: torch.Tensor) -> torch.Tensor:
    """Pack a (..., n) bool vector into (..., ceil(n/32)) int32 words."""
    n = mask.shape[-1]
    nw = n_words(n)
    pad = nw * WORD - n
    m = mask.to(torch.int64)
    if pad:
        m = torch.nn.functional.pad(m, (0, pad))
    m = m.reshape(mask.shape[:-1] + (nw, WORD))
    return wrap32((m * _table("weights", mask.device)).sum(dim=-1))


def first_member(words: torch.Tensor) -> torch.Tensor:
    """Index of the lowest set bit, or -1 if empty (int32)."""
    bits = to_bool(words, words.shape[-1] * WORD)
    idx = torch.argmax(bits.to(torch.int32), dim=-1).to(torch.int32)
    return torch.where(bits.any(dim=-1), idx, torch.full_like(idx, -1))


def iota_mask(n_bits_total: int, upto) -> torch.Tensor:
    """Packed bitset of [0, upto) over a universe padded to n_bits_total."""
    upto = torch.as_tensor(upto, dtype=torch.int64)
    pos = torch.arange(n_words(n_bits_total) * WORD, dtype=torch.int64,
                       device=upto.device)
    return from_bool(pos < upto)


def masked_argmin(values: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """First index minimising ``values`` among members of ``words`` (0 when
    the set is empty, like ``argmin`` over an all-INF vector)."""
    act = to_bool(words, values.shape[-1])
    masked = torch.where(act, values,
                         torch.full_like(values, _INF))
    return torch.argmin(masked, dim=-1).to(torch.int32)


def intersect_count(rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """|row_i AND mask| for every row. rows (..., m, nw), mask (..., nw)."""
    return count(rows & mask[..., None, :], axis=-1)


def equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.all(a == b, dim=-1)


def is_subset(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a ⊆ b for packed sets."""
    return torch.all((a & ~b) == 0, dim=-1)


def _checksum_u(words: torch.Tensor) -> torch.Tensor:
    """``checksum`` as an unsigned int64 value in [0, 2**32)."""
    nw = words.shape[-1]
    mult = (torch.arange(nw, dtype=torch.int64, device=words.device)
            * 0x9E3779B9 + 0x85EBCA6B) & _MASK32
    h = (_u64(words) * mult) & _MASK32
    h = h ^ (h >> 15)
    h = (h * 0x2545F491) & _MASK32
    h = h ^ (h >> 13)
    return h.sum(dim=-1) & _MASK32


def checksum(words: torch.Tensor) -> torch.Tensor:
    """Order-independent uint32 hash of a packed set (int32 pattern)."""
    return wrap32(_checksum_u(words))


def pair_checksum(l_words: torch.Tensor, r_words: torch.Tensor
                  ) -> torch.Tensor:
    """uint32 hash of a biclique (L, R) (int32 pattern); summed with
    wraparound over all bicliques it is the enumeration fingerprint."""
    hl = _checksum_u(l_words)
    hr = _checksum_u(r_words)
    x = ((hl * 0x85EBCA6B) & _MASK32) ^ ((hr * 0xC2B2AE35) & _MASK32)
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK32
    return wrap32(x ^ (x >> 15))
