"""The port's flash attention (``repro_torch.kernels.flash_attention``, K7
fwd, and the blockwise ``repro_torch.models.attention``) against the JAX
package's: the same numpy-seeded inputs through JAX's Pallas kernel in
interpret mode (and its jnp oracle) and through the port on CPU tensors,
where the K7 wrapper runs its plain version.

Tolerances: fp32 1e-5 abs/rel (the same arithmetic, summed in another
order); bf16 3e-2 (``tests/test_flash_kernel.py``: bf16 keeps ~3 decimal
digits, and the two sides round p at different running maxima).  Padded
query rows are never compared: their values depend on the tiling."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.flash_attention.kernel import flash_fwd_pallas
from repro.kernels.flash_attention.ops import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.models import attention as j_attn
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention, flash_fwd,
                                                 flash_fwd_ref)
from repro_torch.kernels.flash_attention.ops import _pack
from repro_torch.models import attention as t_attn
from repro_torch.models.weights import _tensor

# the case grid of tests/test_flash_kernel.py:27-34
CASES = [
    (1, 16, 16, 2, 1, 8, True),
    (2, 32, 32, 4, 2, 16, True),
    (1, 24, 24, 4, 4, 8, True),       # MHA, seq not a block multiple
    (2, 64, 64, 8, 2, 32, False),     # non-causal GQA-4
    (1, 40, 40, 6, 2, 16, True),      # odd sizes
]
BLOCKS = [(8, 8), (16, 32)]


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _qkv(B, Sq, Sk, H, KV, hd, seed=0):
    return (_rand((B, Sq, H, hd), seed), _rand((B, Sk, KV, hd), seed + 1),
            _rand((B, Sk, KV, hd), seed + 2))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype)


def _pad_seq(x, axis, mult):
    """Zero-pad dim ``axis`` up to a multiple of ``mult``, as the
    reference's ``_fwd`` does for its VMEM blocks (contiguous)."""
    pad = (-x.shape[axis]) % mult
    return F.pad(x, [0, 0] * (x.ndim - axis - 1) + [0, pad]).contiguous()


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal", CASES)
@pytest.mark.parametrize("blocks", BLOCKS)
def test_wrapper_matches_jax_pallas_and_ref(B, Sq, Sk, H, KV, hd, causal,
                                            blocks):
    q, k, v = _qkv(B, Sq, Sk, H, KV, hd)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal, blocks[0],
                                  blocks[1], None, True)
    got = flash_attention(_t(q), _t(k), _t(v), causal, blocks[0], blocks[1])
    assert got.shape == (B, Sq, H, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)
    ref = attention_ref(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(
        ref.numpy(), _np(j_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=causal)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal", CASES)
@pytest.mark.parametrize("blocks", BLOCKS)
def test_flash_fwd_ref_matches_jax_kernel_o_and_lse(B, Sq, Sk, H, KV, hd,
                                                    causal, blocks):
    """The kernel-layout plain version against ``flash_fwd_pallas`` on the
    same packed, padded operands: o and lse on the real rows."""
    q, k, v = _qkv(B, Sq, Sk, H, KV, hd, seed=7)
    bq, bk = min(blocks[0], max(Sq, 8)), min(blocks[1], max(Sk, 8))
    qp, kp, vp = _pack(_t(q), _t(k), _t(v))
    qp, kp, vp = _pad_seq(qp, 3, bq), _pad_seq(kp, 2, bk), _pad_seq(vp, 2, bk)
    sc = hd ** -0.5
    jo, jl = flash_fwd_pallas(jnp.asarray(qp.numpy()), jnp.asarray(kp.numpy()),
                              jnp.asarray(vp.numpy()), causal=causal,
                              scale=sc, sq=Sq, sk=Sk, block_q=bq, block_k=bk,
                              interpret=True)
    for fn in (flash_fwd_ref, flash_fwd):    # the wrapper on a CPU tensor
        o, lse = fn(qp, kp, vp, causal=causal, scale=sc, sq=Sq, sk=Sk)
        assert o.shape == qp.shape and lse.shape == qp.shape[:4]
        assert lse.dtype == torch.float32
        np.testing.assert_allclose(o[..., :Sq, :].numpy(),
                                   _np(jo)[..., :Sq, :], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(lse[..., :Sq].numpy(),
                                   _np(jl)[..., :Sq], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rows", [(0, 8), (13, 29), (24, 40)])
def test_flash_fwd_ref_on_a_slice_of_query_rows(causal, rows):
    """``q0``: the plain version on query rows [a, b) of a padded layout
    equals those rows of the whole (how a 32k sequence is checked on the
    card without its S x S scores)."""
    q, k, v = _qkv(2, 37, 37, 4, 2, 16, seed=9)
    qp, kp, vp = (_pad_seq(x, ax, 8) for x, ax in
                  zip(_pack(_t(q), _t(k), _t(v)), (3, 2, 2)))
    a, b = rows
    kw = dict(causal=causal, scale=0.25, sq=37, sk=37)
    o, lse = flash_fwd_ref(qp, kp, vp, **kw)
    so, slse = flash_fwd_ref(qp[..., a:b, :], kp, vp, q0=a, **kw)
    real = min(b, 37) - a
    torch.testing.assert_close(so[..., :real, :], o[..., a:a + real, :],
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(slse[..., :real], lse[..., a:a + real],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_inputs(causal):
    q, k, v = _qkv(1, 32, 32, 4, 2, 16, seed=6)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    tb = [_tensor(np.asarray(x)) for x in jb]           # the same bf16 bits
    want = flash_attention_pallas(*jb, causal, 16, 16, None, True)
    got = flash_attention(*tb, causal, 16, 16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=3e-2,
                               atol=3e-2)
    ref = _np(j_attention_ref(*jb, causal=causal))
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=3e-2,
                               atol=3e-2)


def test_wrapper_counts_no_cpu_launch_and_rejects_bad_operands():
    q, k, v = (_t(x) for x in _qkv(1, 16, 16, 4, 2, 8))
    before = flash_fwd.launches
    flash_attention(q, k, v)
    assert flash_fwd.launches == before      # the plain version ran
    with pytest.raises(ValueError, match="KV \\| H"):
        flash_attention(q, k[:, :, :1].expand(1, 16, 3, 8), v)
    with pytest.raises(ValueError):
        flash_attention(q[0], k, v)


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal", CASES[:2] + CASES[3:])
@pytest.mark.parametrize("chunk_k", [8, 16, 1024])
def test_blockwise_xla_path_matches_jax(B, Sq, Sk, H, KV, hd, causal,
                                        chunk_k):
    q, k, v = _qkv(B, Sq, Sk, H, KV, hd, seed=3)
    want = j_attn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), chunk_k=chunk_k,
                                  causal=causal)
    got = t_attn.flash_attention(_t(q), _t(k), _t(v), chunk_k=chunk_k,
                                 causal=causal)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lens", [(5,), (0, 7, 15, 3)])
def test_decode_attention_matches_jax_per_slot(lens):
    """The port takes one cache length per slot; the reference one per
    call (vmapped per slot by its serve loop): compare slot by slot."""
    B, S, H, KV, hd = len(lens), 16, 4, 2, 8
    rng = np.random.default_rng(11)
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    kc = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    vc = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    got = t_attn.decode_attention(_t(q), _t(kc), _t(vc),
                                  torch.tensor(lens)).numpy()
    for b, n in enumerate(lens):
        want = j_attn.decode_attention(jnp.asarray(q[b:b + 1]),
                                       jnp.asarray(kc[b:b + 1]),
                                       jnp.asarray(vc[b:b + 1]),
                                       jnp.int32(n))
        np.testing.assert_allclose(got[b:b + 1], _np(want), rtol=1e-5,
                                   atol=1e-5)
