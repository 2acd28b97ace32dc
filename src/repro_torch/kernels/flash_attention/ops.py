"""Dispatch and autodiff wrapper for flash attention (K7 fwd, dq, dkv).

Twin of ``src/repro/kernels/flash_attention/ops.py``.  It replaces the
Pallas kernels of ``src/repro/kernels/flash_attention/kernel.py``:
``_fwd_kernel`` (``flash_fwd_pallas``) with ``csrc/flash_fwd.cu``, and
``_dq_kernel`` / ``_dkv_kernel`` (``flash_bwd_pallas``) with
``csrc/flash_bwd.cu`` (one fused kernel for both in bf16).

``flash_attention(q, k, v)`` takes the public (B, S, H, hd) /
(B, S, KV, hd) layout, packs the GQA heads to (B, KV, G, S, hd) (query
head ``h = kv * G + g``) and runs ``_FlashAttention``, the twin of the
reference's ``jax.custom_vjp``: its forward is ``flash_fwd`` and its
backward ``flash_bwd``.  The reference pads both sequence dims to
multiples of its VMEM block sizes; the CUDA kernels pick their own tiles
and mask the ragged tails themselves, so nothing is padded here and
``block_q`` / ``block_k`` are taken only for the reference's signature.
``flash_fwd`` and ``flash_bwd`` still take padded operands (``sq <=
Sqp``, ``sk <= Skp``), as the Pallas calls do.

``flash_fwd`` and ``flash_bwd`` launch their kernels on CUDA tensors (or
raise) and run ``flash_fwd_ref`` / ``flash_bwd_ref`` on CPU ones.  In
bf16 the backward is one fused kernel (dq, dk and dv in one pass); in
fp32 it is two CUDA-core kernels, dq then dkv, each output summed in the
plain version's order (bit-identical run to run).  Every launch adds one
to ``flash_fwd.launches``, ``flash_bwd.fused_launches`` (bf16),
``flash_bwd.dq_launches`` or ``flash_bwd.dkv_launches`` (fp32).  There
is no fallback: a CUDA tensor that requires grad goes through the
kernels both ways.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import expect, on_device
from repro_torch.kernels.flash_attention.ref import (_acc, flash_bwd_ref,
                                                     flash_fwd_ref)

# the head dims the kernels of both directions are instantiated for
# (csrc/flash_fwd.cu, csrc/flash_bwd.cu; 112 is zamba2-7b's, padded to 128
# in shared memory by the bf16 kernels)
HEAD_DIMS = (16, 32, 64, 112, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _pack(q, k, v):
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qp = q.reshape(B, Sq, KV, G, hd).permute(0, 2, 3, 1, 4)
    kp = k.permute(0, 2, 1, 3)
    vp = v.permute(0, 2, 1, 3)
    return qp, kp, vp


def _check(what, qp, kp, vp, sq, sk, dop=None, lse=None, dD=None):
    """Raise unless the packed operands are what the kernels take; returns
    (B, KV, G, Sqp, hd)."""
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
    rows = []
    if dop is not None:
        expect(dop, what, "do", qp.dtype, qp.shape, dev)
        expect(lse, what, "lse", torch.float32, qp.shape[:4], dev)
        expect(dD, what, "dD", torch.float32, qp.shape[:4], dev)
        rows = [dop]
    if any(t.data_ptr() % 16 for t in (qp, kp, vp, *rows)):
        raise ValueError(f"{what}: q, k, v and do must start on 16-byte "
                         f"boundaries (the kernels read 16-byte chunks)")
    if dop is not None and (lse.data_ptr() % 16 or dD.data_ptr() % 16):
        raise ValueError(f"{what}: lse and dD must start on 16-byte "
                         f"boundaries (the backward copies them with TMA)")
    if not (0 < sq <= Sqp and 0 < sk <= Skp):
        raise ValueError(f"{what}: real lengths sq={sq}, sk={sk} outside "
                         f"the padded ({Sqp}, {Skp})")
    return B, KV, G, Sqp, hd


def flash_fwd(qp, kp, vp, *, causal: bool, scale: float, sq: int, sk: int):
    """qp (B, KV, G, Sqp, hd); kp/vp (B, KV, Skp, hd), padded past the
    real lengths ``sq <= Sqp``, ``sk <= Skp``.  Returns ``(o, lse)``: o
    like qp, lse (B, KV, G, Sqp) fp32; padded query rows hold junk."""
    if qp.device.type != "cuda":
        return flash_fwd_ref(qp, kp, vp, causal=causal, scale=scale, sq=sq,
                             sk=sk)
    B, KV, G, Sqp, hd = _check("flash_fwd", qp, kp, vp, sq, sk)
    dev = qp.device
    o = torch.empty_like(qp)
    lse = torch.empty((B, KV, G, Sqp), dtype=torch.float32, device=dev)
    with on_device(dev):
        rc = _build.library().rt_flash_fwd(
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), o.data_ptr(),
            lse.data_ptr(), DTYPES[qp.dtype], B * KV * G, G, Sqp,
            kp.shape[2], sq, sk, hd, float(scale), int(bool(causal)),
            _build.stream_ptr(dev))
    _build.check(rc, "flash_fwd launch")
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


def flash_bwd(qp, kp, vp, dop, lse, dD, *, causal: bool, scale: float,
              sq: int, sk: int):
    """The K7 backward.  qp / dop (B, KV, G, Sqp, hd); kp / vp (B, KV,
    Skp, hd); lse (the forward's) and dD = rowsum(do * o), (B, KV, G,
    Sqp) fp32.  Returns ``(dq, dk, dv)`` like qp, kp, vp.  bf16: the fused
    kernel adds dq into an fp32 accumulator with atomics (its summation
    order varies from run to run; dk and dv do not), cast here to bf16;
    fp32: K7 dq then K7 dkv, deterministic."""
    if qp.device.type != "cuda":
        return flash_bwd_ref(qp, kp, vp, dop, lse, dD, causal=causal,
                             scale=scale, sq=sq, sk=sk)
    _check("flash_bwd", qp, kp, vp, sq, sk, dop, lse, dD)
    ops = (qp, kp, vp, dop, lse, dD)
    kw = dict(causal=causal, scale=scale, sq=sq, sk=sk)
    dk, dv = torch.empty_like(kp), torch.empty_like(vp)
    if qp.dtype == torch.bfloat16:
        dq_acc = torch.zeros(qp.shape, dtype=torch.float32, device=qp.device)
        launch_bwd(*ops, dq_acc, dk, dv, **kw)
        return dq_acc.to(qp.dtype), dk, dv
    dq = torch.empty_like(qp)
    launch_dq(*ops, dq, **kw)
    launch_dkv(*ops, dk, dv, **kw)
    return dq, dk, dv


def _bwd_args(qp, kp, sq, sk, causal, scale):
    B, KV, G, Sqp, hd = qp.shape
    return (B * KV * G, G, Sqp, kp.shape[2], sq, sk, hd, float(scale),
            int(bool(causal)), _build.stream_ptr(qp.device))


def pad_rows4(*xs):
    """``xs`` (.., Sqp) with their last dim zero-padded to a multiple of 4:
    the fused kernel reads lse and dD by TMA in boxes that must start on
    16-byte boundaries.  Returned as they are when Sqp already is one."""
    pad = -xs[0].shape[-1] % 4
    if not pad:
        return xs
    return tuple(torch.nn.functional.pad(x, (0, pad)) for x in xs)


def launch_bwd(qp, kp, vp, dop, lse, dD, dq_acc, dk, dv, *, causal, scale,
               sq, sk):
    """Launch the fused bf16 kernel on operands ``flash_bwd`` has checked:
    adds dq into ``dq_acc`` (fp32, zeroed by the caller), writes ``dk``,
    ``dv``."""
    lse, dD = pad_rows4(lse, dD)
    with on_device(qp.device):
        rc = _build.library().rt_flash_bwd_fused(
            *(t.data_ptr()
              for t in (qp, kp, vp, dop, lse, dD, dq_acc, dk, dv)),
            lse.shape[-1], *_bwd_args(qp, kp, sq, sk, causal, scale))
    _build.check(rc, "flash_bwd fused launch")
    flash_bwd.fused_launches += 1


def launch_dq(qp, kp, vp, dop, lse, dD, dq, *, causal, scale, sq, sk):
    """Launch the fp32 K7 dq into ``dq`` on checked operands."""
    with on_device(qp.device):
        rc = _build.library().rt_flash_bwd_dq(
            *(t.data_ptr() for t in (qp, kp, vp, dop, lse, dD, dq)),
            DTYPES[qp.dtype], *_bwd_args(qp, kp, sq, sk, causal, scale))
    _build.check(rc, "flash_bwd dq launch")
    flash_bwd.dq_launches += 1


def launch_dkv(qp, kp, vp, dop, lse, dD, dk, dv, *, causal, scale, sq, sk):
    """Launch the fp32 K7 dkv into ``dk``, ``dv`` on checked operands."""
    with on_device(qp.device):
        rc = _build.library().rt_flash_bwd_dkv(
            *(t.data_ptr() for t in (qp, kp, vp, dop, lse, dD, dk, dv)),
            DTYPES[qp.dtype], *_bwd_args(qp, kp, sq, sk, causal, scale))
    _build.check(rc, "flash_bwd dkv launch")
    flash_bwd.dkv_launches += 1


flash_bwd.fused_launches = 0
flash_bwd.dq_launches = 0
flash_bwd.dkv_launches = 0


def _fwd(q, k, v, causal, scale):
    """The packed forward: (o (B, Sq, H, hd), (qp, kp, vp, op, lse))."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    sc = scale if scale is not None else 1.0 / (hd ** 0.5)
    qp, kp, vp = (x.contiguous() for x in _pack(q, k, v))
    o, lse = flash_fwd(qp, kp, vp, causal=causal, scale=sc, sq=Sq, sk=Sk)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd), (qp, kp, vp, o,
                                                            lse)


class _FlashAttention(torch.autograd.Function):
    """Twin of the reference's ``jax.custom_vjp`` (``ops.py:39-98``):
    forward ``flash_fwd``, backward ``flash_bwd`` with dD = rowsum(do * o)
    in fp32 outside the kernels, as the reference computes it; the grads
    come back in the inputs' dtype (the kernels take one dtype for q, k
    and v and write their grads in it)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, saved = _fwd(q, k, v, causal, scale)
        ctx.save_for_backward(*saved)
        ctx.causal = causal
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        qp, kp, vp, op, lse = ctx.saved_tensors
        B, KV, G, Sq, hd = qp.shape
        Sk = kp.shape[2]
        sc = ctx.scale if ctx.scale is not None else 1.0 / (hd ** 0.5)
        dop = do.reshape(B, Sq, KV, G, hd).permute(0, 2, 3, 1, 4).contiguous()
        dD = (_acc(dop) * _acc(op)).sum(-1)
        dq, dk, dv = flash_bwd(qp, kp, vp, dop, lse, dD, causal=ctx.causal,
                               scale=sc, sq=Sq, sk=Sk)
        dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, KV * G, hd)
        return dq, dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3), None, None


def flash_attention(q, k, v, causal=True, block_q=512, block_k=512,
                    scale=None):
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd) -> (B, Sq, H, hd);
    differentiable through ``_FlashAttention``."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         f"(B, Sq, H, hd) and (B, Sk, KV, hd) with KV | H")
    return _FlashAttention.apply(q, k, v, causal, scale)
