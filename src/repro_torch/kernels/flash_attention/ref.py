"""Plain torch-op versions of the flash-attention forward.

Twin of ``src/repro/kernels/flash_attention/ref.py`` (``attention_ref``)
plus ``flash_fwd_ref``, the plain version of the K7 forward kernel in the
kernel's own packed, padded layout.  The CPU tests run them, and
``chip_smoke.py`` holds the CUDA kernel against ``flash_fwd_ref`` on the
card.
"""
from __future__ import annotations

import torch

_NEG = -1e30


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
    Sqp, Skp = qp.shape[3], kp.shape[2]
    dev = qp.device
    s = torch.einsum("bvgqd,bvkd->bvgqk", qp.float(), kp.float()) * scale
    qpos = q0 + torch.arange(Sqp, device=dev)[:, None]
    kpos = torch.arange(Skp, device=dev)[None, :]
    mask = (kpos < sk) & (qpos < sq)
    if causal:
        mask = mask & (kpos <= qpos)
    s = torch.where(mask, s, _NEG)
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.clamp(torch.sum(p, dim=-1), min=1e-30)
    acc = torch.einsum("bvgqk,bvkd->bvgqd", p.to(vp.dtype).float(),
                       vp.float())
    o = (acc / l[..., None]).to(qp.dtype)
    return o, m + torch.log(l)
