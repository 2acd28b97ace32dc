"""Plain torch-op versions of flash attention.

Twin of ``src/repro/kernels/flash_attention/ref.py`` (``attention_ref``)
plus ``flash_fwd_ref`` and ``flash_bwd_ref``, the plain versions of the
K7 forward kernel and of the K7 dq / dkv backward kernels in the kernels'
own packed, padded layout.  The CPU tests run them, and ``chip_smoke.py``
holds the CUDA kernels against them on the card.  They compute in fp32
(float64 for float64 operands, which ``torch.autograd.gradcheck`` needs).
"""
from __future__ import annotations

import torch

_NEG = -1e30


def _acc(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the accumulation dtype: fp32, or float64 for float64."""
    return x if x.dtype == torch.float64 else x.float()


def _mask(Sqp, Skp, *, causal, sq, sk, q0, device):
    qpos = q0 + torch.arange(Sqp, device=device)[:, None]
    kpos = torch.arange(Skp, device=device)[None, :]
    mask = (kpos < sk) & (qpos < sq)
    if causal:
        mask = mask & (kpos <= qpos)
    return mask


def attention_ref(q, k, v, *, causal: bool = True,
                  scale: float | None = None):
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd). Naive O(S^2) softmax."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / (hd ** 0.5)
    q5 = q.reshape(B, Sq, KV, G, hd).float()
    s = torch.einsum("bqvgd,bkvd->bvgqk", q5, k.float()) * scale
    if causal:
        mask = (torch.arange(Sk, device=q.device)[None, :]
                <= torch.arange(Sq, device=q.device)[:, None])
        s = torch.where(mask[None, None, None], s, _NEG)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bvgqk,bkvd->bvgqd", p, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def flash_fwd_ref(qp, kp, vp, *, causal: bool, scale: float, sq: int,
                  sk: int, q0: int = 0):
    """The K7 forward in the kernel's layout: qp (B, KV, G, Sqp, hd),
    kp/vp (B, KV, Skp, hd), padded past the real lengths ``sq``/``sk``.
    Returns ``(o, lse)``: o like qp, lse (B, KV, G, Sqp) fp32.  ``qp``
    may be a slice of the query rows that starts at position ``q0``
    (its rows are positions ``q0 ..``; ``sq`` stays the whole length),
    which checks a long sequence without its S x S scores.

    The arithmetic of ``_fwd_kernel`` (``kernel.py:47``) without the
    tiling: fp32 scores, the mask ``(kpos < sk) & (qpos < sq) & (kpos <=
    qpos if causal)`` with -1e30, ``p`` rounded to the input dtype before
    the ``p @ v`` product, ``o = acc / max(l, 1e-30)`` and ``lse = m +
    log(max(l, 1e-30))``.  Padded query rows (``qpos >= sq``) hold values
    that depend on the tiling in the kernels: never read them."""
    s = torch.einsum("bvgqd,bvkd->bvgqk", _acc(qp), _acc(kp)) * scale
    mask = _mask(qp.shape[3], kp.shape[2], causal=causal, sq=sq, sk=sk,
                 q0=q0, device=qp.device)
    s = torch.where(mask, s, _NEG)
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.clamp(torch.sum(p, dim=-1), min=1e-30)
    acc = torch.einsum("bvgqk,bvkd->bvgqd", _acc(p.to(vp.dtype)), _acc(vp))
    o = (acc / l[..., None]).to(qp.dtype)
    return o, m + torch.log(l)


def flash_bwd_ref(qp, kp, vp, dop, lse, dD, *, causal: bool, scale: float,
                  sq: int, sk: int, q0: int = 0):
    """K7 dq and dkv in the kernels' layout: qp / dop (B, KV, G, Sqp, hd),
    kp / vp (B, KV, Skp, hd), lse / dD (B, KV, G, Sqp) fp32 (dD =
    rowsum(do * o)).  Returns ``(dq, dk, dv)`` like qp, kp, vp; padded
    query rows of dq and keys past ``sk`` get 0.  With ``q0`` the query
    operands are a slice of the rows starting at position ``q0`` (``sq``
    stays the whole length): dq is those rows' and dk / dv sum over those
    rows only.

    The arithmetic of ``_dq_kernel`` / ``_dkv_kernel`` (``kernel.py:91,
    131``) without the tiling: fp32 scores, ``p = exp(s - lse)`` on the
    mask and 0 off it (the mask is applied before ``exp``, so a padded
    row's lse never yields inf or NaN), ``dp = do v^T`` on fp32 casts,
    ``ds = p (dp - dD) scale``; ds rounded to k's dtype before ``ds k``,
    p to do's dtype before ``p^T do``, ds to q's dtype before ``ds^T q``;
    dk and dv summed over the G query heads of each KV group."""
    mask = _mask(qp.shape[3], kp.shape[2], causal=causal, sq=sq, sk=sk,
                 q0=q0, device=qp.device)
    s = torch.einsum("bvgqd,bvkd->bvgqk", _acc(qp), _acc(kp)) * scale
    p = torch.exp(torch.where(mask, s - _acc(lse)[..., None], _NEG))
    dp = torch.einsum("bvgqd,bvkd->bvgqk", _acc(dop), _acc(vp))
    ds = p * (dp - _acc(dD)[..., None]) * scale
    dq = torch.einsum("bvgqk,bvkd->bvgqd", _acc(ds.to(kp.dtype)), _acc(kp))
    dk = torch.einsum("bvgqk,bvgqd->bvkd", _acc(ds.to(qp.dtype)), _acc(qp))
    dv = torch.einsum("bvgqk,bvgqd->bvkd", _acc(p.to(dop.dtype)), _acc(dop))
    return dq.to(qp.dtype), dk.to(kp.dtype), dv.to(vp.dtype)
