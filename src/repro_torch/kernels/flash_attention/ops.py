"""Dispatch wrapper for the flash-attention forward (K7 fwd).

Twin of ``src/repro/kernels/flash_attention/ops.py``.  It replaces the
Pallas kernel ``src/repro/kernels/flash_attention/kernel.py:_fwd_kernel``
(``flash_fwd_pallas``) with ``csrc/flash_fwd.cu``.

``flash_attention(q, k, v)`` takes the public (B, S, H, hd) /
(B, S, KV, hd) layout, packs the GQA heads to (B, KV, G, S, hd) (query
head ``h = kv * G + g``) and calls ``flash_fwd``.  The reference pads
both sequence dims to multiples of its VMEM block sizes; the CUDA kernel
picks its own tiles and masks the ragged tails itself, so nothing is
padded here and ``block_q`` / ``block_k`` are taken only for the
reference's signature.  ``flash_fwd`` still takes padded operands
(``sq <= Sqp``, ``sk <= Skp``), as ``flash_fwd_pallas`` does.

``flash_fwd`` launches the kernel on a CUDA tensor (or raises) and runs
``flash_fwd_ref`` on a CPU one; every launch adds one to
``flash_fwd.launches``.  There is no backward yet: on a CUDA tensor that
requires grad the wrapper raises instead of differentiating through the
plain version (the dq/dkv kernels come with the training path, ROADMAP
Queue 2).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import expect
from repro_torch.kernels.flash_attention.ref import flash_fwd_ref

# the head dims the kernel is instantiated for (csrc/flash_fwd.cu)
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _pack(q, k, v):
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qp = q.reshape(B, Sq, KV, G, hd).permute(0, 2, 3, 1, 4)
    kp = k.permute(0, 2, 1, 3)
    vp = v.permute(0, 2, 1, 3)
    return qp, kp, vp


def flash_fwd(qp, kp, vp, *, causal: bool, scale: float, sq: int, sk: int):
    """qp (B, KV, G, Sqp, hd); kp/vp (B, KV, Skp, hd), padded past the
    real lengths ``sq <= Sqp``, ``sk <= Skp``.  Returns ``(o, lse)``: o
    like qp, lse (B, KV, G, Sqp) fp32; padded query rows hold junk."""
    if qp.device.type != "cuda":
        return flash_fwd_ref(qp, kp, vp, causal=causal, scale=scale, sq=sq,
                             sk=sk)
    what = "flash_fwd"
    if qp.requires_grad or kp.requires_grad or vp.requires_grad:
        raise NotImplementedError(
            f"{what}: no backward kernel yet (K7 dq/dkv come with the "
            f"training slice, ROADMAP Queue 2); call it under "
            f"torch.no_grad() or on detached tensors")
    if qp.dim() != 5:
        raise ValueError(f"{what}: q must be (B, KV, G, Sq, hd), got "
                         f"{tuple(qp.shape)}")
    B, KV, G, Sqp, hd = qp.shape
    Skp = kp.shape[2] if kp.dim() == 4 else -1
    if qp.dtype not in DTYPES:
        raise ValueError(f"{what}: dtype {qp.dtype} not taken; expected one "
                         f"of {sorted(map(str, DTYPES))}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {hd} not taken; expected one of "
                         f"{HEAD_DIMS}")
    dev = qp.device
    expect(qp, what, "q", qp.dtype, qp.shape, dev)
    expect(kp, what, "k", qp.dtype, (B, KV, Skp, hd), dev)
    expect(vp, what, "v", qp.dtype, (B, KV, Skp, hd), dev)
    if any(t.data_ptr() % 16 for t in (qp, kp, vp)):
        raise ValueError(f"{what}: q, k and v must start on 16-byte "
                         f"boundaries (the kernel reads 16-byte chunks)")
    if not (0 < sq <= Sqp and 0 < sk <= Skp):
        raise ValueError(f"{what}: real lengths sq={sq}, sk={sk} outside "
                         f"the padded ({Sqp}, {Skp})")
    o = torch.empty_like(qp)
    lse = torch.empty((B, KV, G, Sqp), dtype=torch.float32, device=dev)
    rc = _build.library().rt_flash_fwd(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), o.data_ptr(),
        lse.data_ptr(), DTYPES[qp.dtype], B * KV * G, G, Sqp, Skp, sq, sk,
        hd, float(scale), int(bool(causal)), _build.stream_ptr(dev))
    _build.check(rc, "flash_fwd launch")
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


def _fwd(q, k, v, causal, scale):
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    sc = scale if scale is not None else 1.0 / (hd ** 0.5)
    qp, kp, vp = (x.contiguous() for x in _pack(q, k, v))
    o, lse = flash_fwd(qp, kp, vp, causal=causal, scale=sc, sq=Sq, sk=Sk)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd), lse


def flash_attention(q, k, v, causal=True, block_q=512, block_k=512,
                    scale=None):
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd) -> (B, Sq, H, hd)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         f"(B, Sq, H, hd) and (B, Sk, KV, hd) with KV | H")
    o, _ = _fwd(q, k, v, causal, scale)
    return o
