"""GQA attention: blockwise (flash) prefill path + cached decode.

Twin of ``src/repro/models/attention.py``; both functions are torch ops,
neither is a kernel (the hand-written kernel is ``kernels.flash_attention``,
the ``attn_impl="pallas"`` path).

* ``flash_attention`` — blockwise attention over KV tiles with a running
  max/sum (the ``attn_impl="xla"`` path), so a 32k-token prefill never
  holds an S x S score matrix: Q stays whole, the loop runs over KV tiles
  of ``chunk_k``.
* ``decode_attention`` — one new token per slot against a KV cache, each
  slot attending over positions [0, cache_len[slot]].
* ``decode_partial`` — the same over one device's chunk of a cache split
  along its sequence (``cache_seq`` on a mesh): the chunk's running
  (max, sum, acc), which ``combine_partials`` merges by logsumexp.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding.axes import constrain

_NEG = -1e30


def _tile_update(qc, kc, vc, m, l, acc, qpos, kpos, scale, causal):
    """One (Q x KV-tile) flash step.

    qc: (B, cq, KV, G, hd); kc/vc: (B, ck, KV, hd);
    m, l: (B, KV, G, cq); acc: (B, KV, G, cq, hd).
    """
    s = torch.einsum("bqvgd,bcvd->bvgqc", qc, kc) * scale
    s = s.float()
    if causal:
        mask = kpos[None, :] <= qpos[:, None]            # (cq, ck)
        s = torch.where(mask[None, None, None], s, _NEG)
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + torch.sum(p, dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bvgqc,bcvd->bvgqd", p.to(vc.dtype), vc).float()
    return m_new, l_new, acc_new


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    chunk_k: int = 1024, causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) -> (B, Sq, H, hd).

    Q stays whole and the loop runs over KV tiles only, as in the
    reference (whose reason is its sequence-parallel layout; its
    ``chunk_q`` is ignored there, and its ``q_offset`` has no caller, so
    neither is taken here)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    ck = min(chunk_k, Sk)
    pk = (-Sk) % ck
    if pk:
        # padded K positions sit at pos >= Sk; as in the reference only the
        # causal mask excludes them (a non-causal call scores them 0)
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
    nk = (Sk + pk) // ck
    scale = 1.0 / (hd ** 0.5)
    dev = q.device

    q5 = q.reshape(B, Sq, KV, G, hd)
    qpos = torch.arange(Sq, device=dev)
    m = torch.full((B, KV, G, Sq), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32, device=dev)
    for i in range(nk):
        kpos = i * ck + torch.arange(ck, device=dev)
        m, l, acc = _tile_update(q5, k[:, i * ck:(i + 1) * ck],
                                 v[:, i * ck:(i + 1) * ck], m, l, acc, qpos,
                                 kpos, scale, causal)
    out = acc / torch.clamp(l[..., None], min=1e-20)   # (B,KV,G,Sq,hd)
    out = out.permute(0, 3, 1, 2, 4)                   # (B,Sq,KV,G,hd)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor
                     ) -> torch.Tensor:
    """q: (B, H, hd) one new token per slot; caches (B, S, KV, hd);
    ``cache_len`` a scalar or (B,) per slot: slot b attends over positions
    [0, cache_len[b]] (the new token's k/v already written)."""
    B, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = 1.0 / (hd ** 0.5)
    q5 = q.reshape(B, KV, G, hd)
    k_cache = constrain(k_cache, "cache_batch", "cache_seq", "act_kv", None)
    v_cache = constrain(v_cache, "cache_batch", "cache_seq", "act_kv", None)
    s = torch.einsum("bvgd,bsvd->bvgs", q5, k_cache).float()
    s = s * scale
    lens = torch.as_tensor(cache_len, device=q.device).reshape(-1)
    valid = (torch.arange(S, device=q.device)[None, :]
             <= lens[:, None])[:, None, None, :]        # (B|1, 1, 1, S)
    s = torch.where(valid, s, _NEG)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bvgs,bsvd->bvgd",
                       (p / torch.clamp(l, min=1e-20)).to(v_cache.dtype),
                       v_cache)
    return out.reshape(B, H, hd).to(q.dtype)


def decode_partial(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, cache_len: torch.Tensor,
                   offset: int):
    """``decode_attention`` over a cache chunk that holds positions
    ``offset ..`` of the sequence: returns (m, l, acc), the chunk's row
    max, sum of exp and unnormalised output, (B, KV, G[, hd]) fp32."""
    B, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    q5 = q.reshape(B, KV, G, hd)
    s = torch.einsum("bvgd,bsvd->bvgs", q5, k_cache).float()
    s = s * (1.0 / (hd ** 0.5))
    lens = torch.as_tensor(cache_len, device=q.device).reshape(-1)
    kpos = offset + torch.arange(S, device=q.device)
    s = torch.where((kpos[None, :] <= lens[:, None])[:, None, None, :],
                    s, _NEG)
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("bvgs,bsvd->bvgd", p.to(v_cache.dtype),
                       v_cache).float()
    return m, p.sum(-1), acc


def combine_partials(parts, dtype) -> torch.Tensor:
    """The (m, l, acc) of every chunk of the sequence merged by
    logsumexp: (B, H, hd) in ``dtype``."""
    m = torch.stack([p[0] for p in parts]).amax(0)
    l = acc = 0
    for mj, lj, aj in parts:
        c = torch.exp(mj - m)
        l = l + lj * c
        acc = acc + aj * c[..., None]
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    B, KV, G, hd = out.shape
    return out.reshape(B, KV * G, hd).to(dtype)
