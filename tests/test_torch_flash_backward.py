"""The port's flash-attention backward (``flash_bwd_ref``, the plain
version of K7 dq / dkv, and ``_FlashAttention``, the autograd twin of the
reference's ``custom_vjp``) against the JAX package's: the same
numpy-seeded operands through ``flash_bwd_pallas`` in interpret mode and
``jax.grad`` of ``flash_attention_pallas(interpret=True)``, and through
the port on CPU tensors, where the wrappers run the plain versions.

Tolerances: fp32 1e-5 for the kernel-layout plain version and its 3xTF32
emulation against the Pallas kernel (the same arithmetic, summed in
another order; 3xTF32 drops ~2^-22 of each product), 1e-4 for
the grads through the whole autodiff path (``tests/test_flash_kernel.py:
63``); bf16 3e-2 (bf16 keeps ~3 decimal digits, and the two forwards
round p at different running maxima); ``gradcheck`` in float64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.flash_attention.kernel import (flash_bwd_pallas,
                                                  flash_fwd_pallas)
from repro.kernels.flash_attention.ops import flash_attention_pallas
from repro_torch.kernels.flash_attention import (flash_attention, flash_bwd,
                                                 flash_bwd_ref)
from repro_torch.kernels.flash_attention.ops import (_FlashAttention, _pack,
                                                    pad_rows4)
from repro_torch.kernels.flash_attention.ref import (flash_bwd_3xtf32_ref,
                                                     tf32_split)
from repro_torch.models.weights import _tensor

# the case grid of tests/test_flash_kernel.py:27-34
CASES = [
    (1, 16, 16, 2, 1, 8, True),
    (2, 32, 32, 4, 2, 16, True),
    (1, 24, 24, 4, 4, 8, True),       # MHA, seq not a block multiple
    (2, 64, 64, 8, 2, 32, False),     # non-causal GQA-4
    (1, 40, 40, 6, 2, 16, True),      # odd sizes
]


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _qkv_do(B, S, H, KV, hd, seed):
    return (_rand((B, S, H, hd), seed), _rand((B, S, KV, hd), seed + 1),
            _rand((B, S, KV, hd), seed + 2), _rand((B, S, H, hd), seed + 3))


def _pad_seq(x, axis, mult):
    pad = (-x.shape[axis]) % mult
    return F.pad(x, [0, 0] * (x.ndim - axis - 1) + [0, pad]).contiguous()


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))


def _pallas_bwd(B, S, H, KV, hd, causal):
    """The packed operands (padded to 8-row blocks) with the Pallas
    forward's lse and dD, their kwargs, and ``flash_bwd_pallas``'s dq, dk,
    dv on them."""
    q, k, v, do = (torch.from_numpy(x) for x in _qkv_do(B, S, H, KV, hd, 3))
    qp, kp, vp = (_pad_seq(x, ax, 8) for x, ax in zip(_pack(q, k, v),
                                                      (3, 2, 2)))
    dop = _pad_seq(_pack(do, k, v)[0], 3, 8)
    sc = hd ** -0.5
    kw = dict(causal=causal, scale=sc, sq=S, sk=S, block_q=8, block_k=8)
    jq, jk, jv, jdo = (jnp.asarray(x.numpy()) for x in (qp, kp, vp, dop))
    jo, jl = flash_fwd_pallas(jq, jk, jv, interpret=True, **kw)
    jD = jnp.sum(jdo * jo, axis=-1)
    want = flash_bwd_pallas(jq, jk, jv, jdo, jl, jD, interpret=True, **kw)
    lse, dD = torch.from_numpy(_np(jl)), torch.from_numpy(_np(jD))
    return ((qp, kp, vp, dop, lse, dD),
            dict(causal=causal, scale=sc, sq=S, sk=S), want)


@pytest.mark.parametrize("B,S,H,KV,hd,causal", [c[:2] + c[3:] for c in CASES])
def test_flash_bwd_ref_matches_jax_kernels(B, S, H, KV, hd, causal):
    """dq, dk, dv of the plain version against ``flash_bwd_pallas`` on the
    same packed operands, padded to 8-row blocks, with the Pallas
    forward's o and lse."""
    ops, kw, want = _pallas_bwd(B, S, H, KV, hd, causal)
    for fn in (flash_bwd_ref, flash_bwd):        # the wrapper on a CPU tensor
        got = fn(*ops, **kw)
        for g, w, x in zip(got, want, ops):
            assert g.shape == x.shape and g.dtype == x.dtype
            np.testing.assert_allclose(g.numpy(), _np(w), rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("B,S,H,KV,hd,causal", [c[:2] + c[3:] for c in CASES])
def test_flash_bwd_3xtf32_emulation_matches_jax_kernels(B, S, H, KV, hd,
                                                        causal):
    """The 3xTF32 split's error budget: dq, dk, dv of
    ``flash_bwd_3xtf32_ref`` against ``flash_bwd_pallas`` within the fp32
    limit."""
    ops, kw, want = _pallas_bwd(B, S, H, KV, hd, causal)
    for g, w, x in zip(flash_bwd_3xtf32_ref(*ops, **kw), want, ops):
        assert g.shape == x.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=1e-5, atol=1e-5)


def test_tf32_split_rounds_as_cvt_rna():
    """``hi`` and ``lo`` have their low 13 mantissa bits zero, ``hi`` is x
    to nearest with ties away from zero, and ``hi + lo`` is x to 2^-22
    relative, over fp32's exponent range."""
    rng = np.random.default_rng(17)
    x = rng.normal(size=4096) * 10.0 ** rng.uniform(-30, 30, 4096)
    ties = [1 + 2 ** -11, -(1 + 2 ** -11), 3 * 2 ** -12 + 1, 0.0]
    x = torch.from_numpy(np.concatenate([x, ties]).astype(np.float32))
    hi, lo = tf32_split(x)
    for h in (hi, lo):
        assert not (h.view(torch.int32) & 0x1FFF).any()
    assert hi[-4:].tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 ** -10,
                                0.0]
    xd = x.double()
    assert ((xd - hi.double()).abs() <= 2 ** -11 * xd.abs()).all()
    assert ((hi.double() + lo.double() - xd).abs()
            <= 2 ** -22 * xd.abs()).all()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rows", [(0, 16), (16, 40)])
def test_flash_bwd_ref_on_a_slice_of_query_rows(causal, rows):
    """``q0``: dq of rows [a, b) equals those rows of the whole, and the
    slices' dk / dv add up to the whole's."""
    q, k, v, do = (torch.from_numpy(x).double()
                   for x in _qkv_do(2, 40, 4, 2, 16, 5))
    qp, kp, vp = (x.contiguous() for x in _pack(q, k, v))
    dop = _pack(do, k, v)[0].contiguous()
    g = torch.Generator().manual_seed(0)
    lse = torch.randn(qp.shape[:4], generator=g, dtype=torch.float64) + 3
    dD = torch.randn(qp.shape[:4], generator=g, dtype=torch.float64)
    kw = dict(causal=causal, scale=0.25, sq=40, sk=40)
    dq, dk, dv = flash_bwd_ref(qp, kp, vp, dop, lse, dD, **kw)
    parts = [flash_bwd_ref(qp[..., a:b, :], kp, vp, dop[..., a:b, :],
                           lse[..., a:b], dD[..., a:b], q0=a, **kw)
             for a, b in ((0, rows[0]), rows, (rows[1], 40)) if b > a]
    torch.testing.assert_close(torch.cat([p[0] for p in parts], 3), dq)
    torch.testing.assert_close(sum(p[1] for p in parts), dk)
    torch.testing.assert_close(sum(p[2] for p in parts), dv)


@pytest.mark.parametrize("B,S,H,KV,hd,causal", [c[:2] + c[3:] for c in CASES])
def test_autograd_matches_jax_grad_fp32(B, S, H, KV, hd, causal):
    q, k, v, do = _qkv_do(B, S, H, KV, hd, 11)

    def f(a, b, c):
        return jnp.sum(flash_attention_pallas(a, b, c, causal, 8, 8, None,
                                              True) * do)
    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = flash_attention(*t, causal, 8, 8)
    got = torch.autograd.grad(o, t, torch.from_numpy(do))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_matches_jax_grad_bf16(causal):
    q, k, v, do = _qkv_do(1, 32, 4, 2, 16, 13)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do)]

    def f(a, b, c):
        o = flash_attention_pallas(a, b, c, causal, 16, 16, None, True)
        return jnp.sum(o.astype(jnp.float32) * jb[3].astype(jnp.float32))
    want = jax.grad(f, argnums=(0, 1, 2))(*jb[:3])
    t = [_tensor(np.asarray(x)) for x in jb]     # the same bf16 bits
    qkv = [x.requires_grad_() for x in t[:3]]
    got = torch.autograd.grad(flash_attention(*qkv, causal, 16, 16), qkv,
                              t[3])
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), _np(w), rtol=3e-2,
                                   atol=3e-2)


@pytest.mark.parametrize("causal,scale", [(True, None), (False, 0.3)])
def test_gradcheck_float64(causal, scale):
    g = torch.Generator().manual_seed(2)
    q = torch.randn(1, 6, 2, 4, generator=g, dtype=torch.float64)
    k = torch.randn(1, 6, 1, 4, generator=g, dtype=torch.float64)
    v = torch.randn(1, 6, 1, 4, generator=g, dtype=torch.float64)
    args = [x.requires_grad_() for x in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda a, b, c: _FlashAttention.apply(a, b, c, causal, scale), args)


def test_bwd_runs_the_plain_version_on_cpu_tensors():
    q, k, v, do = (torch.from_numpy(x) for x in _qkv_do(1, 16, 4, 2, 8, 1))
    counts = ("fused_launches", "dq_launches", "dkv_launches")
    before = [getattr(flash_bwd, c) for c in counts]
    qkv = [x.requires_grad_() for x in (q, k, v)]
    torch.autograd.grad(flash_attention(*qkv), qkv, do)
    assert [getattr(flash_bwd, c) for c in counts] == before


@pytest.mark.parametrize("Sqp", [4096, 4097, 33, 40])
def test_lse_rows_padded_to_16_bytes(Sqp):
    """The fused kernel's lse / dD rows: a multiple of 4 fp32 values, the
    values kept and the pad zero."""
    g = torch.Generator().manual_seed(Sqp)
    lse, dD = (torch.randn(2, 3, 2, Sqp, generator=g) for _ in range(2))
    plse, pdD = pad_rows4(lse, dD)
    for x, p in ((lse, plse), (dD, pdD)):
        assert p.shape[-1] % 4 == 0 and p.shape[-1] - Sqp < 4
        assert torch.equal(p[..., :Sqp], x) and not p[..., Sqp:].any()
        assert p.is_contiguous()
