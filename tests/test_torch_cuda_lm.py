"""The K7 forward kernel (``csrc/flash_fwd.cu``) and the LM prefill path
on the card.  Without a CUDA device every test skips, decided inside the
``card`` fixture so that all test workers collect the same tests.  Run on
the card with:

    python -m pytest -q -m gpu tests/test_torch_cuda_lm.py

Tolerances: fp32 ``o`` 1e-4 (the plain version runs the same fp32
arithmetic, summed in another order; TF32 is switched off), bf16 ``o``
3e-2 (``tests/test_flash_kernel.py``: the kernel rounds p at its running
maximum, the plain version at the final one), ``lse`` 1e-4 relative;
and per query row ||o - ref|| / ||ref|| at 1e-2 (bf16) and 1e-5 (fp32),
which sees a fault in the late rows, whose values are small.
This file imports no JAX: the machine with the card has none."""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from repro_torch import configs
from repro_torch.kernels.flash_attention import (flash_attention, flash_bwd,
                                                 flash_bwd_ref, flash_fwd,
                                                 flash_fwd_ref)
from repro_torch.kernels.flash_attention.ops import _pack
from repro_torch.models import model as M
from repro_torch.models.layers import init_params
from repro_torch.training.step import make_prefill_step

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _pad_seq(x, axis, mult):
    pad = (-x.shape[axis]) % mult
    return F.pad(x, [0, 0] * (x.ndim - axis - 1) + [0, pad]).contiguous()


def _row_rel(o, ro):
    """max over query rows of ||o - ro|| / ||ro|| (fp32)."""
    o, ro = o.float(), ro.float()
    return float(((o - ro).norm(dim=-1)
                  / ro.norm(dim=-1).clamp(min=1e-30)).max())


def _packed(card, B, S, H, KV, hd, dtype, pad, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    q, k, v = (torch.randn(B, S, n, hd, generator=g, device=card).to(dtype)
               for n in (H, KV, KV))
    qp, kp, vp = _pack(q, k, v)
    return _pad_seq(qp, 3, pad), _pad_seq(kp, 2, pad), _pad_seq(vp, 2, pad)


@pytest.mark.parametrize("B,S,H,KV,hd,pad", [
    (1, 256, 16, 8, 128, 256), (2, 1000, 16, 8, 128, 1024),
    (2, 100, 4, 2, 64, 128), (1, 40, 6, 2, 32, 40), (2, 33, 4, 4, 16, 64),
    # S % 4 != 0 (TMA rows), and 16 key tiles through the 3-stage K / V
    # ring with a ragged tail
    (1, 4097, 16, 8, 128, 4100), (1, 2000, 16, 8, 128, 2048)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_matches_plain(card, B, S, H, KV, hd, pad, dtype, causal):
    qp, kp, vp = _packed(card, B, S, H, KV, hd, dtype, pad, S + hd)
    sc = hd ** -0.5
    n = flash_fwd.launches
    o, lse = flash_fwd(qp, kp, vp, causal=causal, scale=sc, sq=S, sk=S)
    torch.cuda.synchronize()
    assert flash_fwd.launches == n + 1
    ro, rl = flash_fwd_ref(qp, kp, vp, causal=causal, scale=sc, sq=S, sk=S)
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-4
    assert o.dtype == dtype and torch.isfinite(o).all()
    torch.testing.assert_close(o[..., :S, :].float(), ro[..., :S, :].float(),
                               rtol=tol, atol=tol)
    torch.testing.assert_close(lse[..., :S], rl[..., :S], rtol=1e-4,
                               atol=1e-4)
    row_tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    assert _row_rel(o[..., :S, :], ro[..., :S, :]) <= row_tol


@pytest.mark.parametrize("B,S,H,KV,hd,causal", [
    (1, 4096, 16, 8, 128, True), (2, 1000, 12, 4, 64, True),
    (2, 256, 8, 2, 128, False)])
def test_flash_fwd_bf16_is_bit_identical_run_to_run(card, B, S, H, KV, hd,
                                                     causal):
    # the forward has no atomics: the same operands give the same bits
    qp, kp, vp = _packed(card, B, S, H, KV, hd, torch.bfloat16, S, S)
    kw = dict(causal=causal, scale=hd ** -0.5, sq=S, sk=S)
    o, lse = flash_fwd(qp, kp, vp, **kw)
    o2, lse2 = flash_fwd(qp, kp, vp, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    q = torch.randn(1, 64, 4, 128, device=card, dtype=torch.bfloat16)
    k = torch.randn(1, 64, 2, 128, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :96], k[..., :96], k[..., :96])
    with pytest.raises(ValueError, match="head dim"):
        flash_bwd(*(x[..., :96].contiguous() for x in _pack(q, k, k)),
                  _pack(q, k, k)[0][..., :96].contiguous(),
                  torch.zeros(1, 2, 2, 64, device=card),
                  torch.zeros(1, 2, 2, 64, device=card), causal=True,
                  scale=0.1, sq=64, sk=64)
    # a tensor that requires grad goes through the kernels both ways: K7
    # fwd, then in bf16 the fused backward (no fp32 dq / dkv launch)
    def counts():
        return (flash_fwd.launches, flash_bwd.fused_launches,
                flash_bwd.dq_launches, flash_bwd.dkv_launches)
    n = counts()
    qg = q.clone().requires_grad_()
    flash_attention(qg, k, k).sum().backward()
    torch.cuda.synchronize()
    assert counts() == (n[0] + 1, n[1] + 1, n[2], n[3])
    assert qg.grad.dtype == torch.bfloat16 and torch.isfinite(qg.grad).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_kernel_path_matches_torch_op_path(card, dtype):
    """The qwen3 smoke model's prefill on the card: attn_impl='pallas'
    (K7, one launch per layer) against 'xla' (blockwise torch ops)."""
    base = dataclasses.replace(configs.get_smoke("qwen3-1.7b"), dtype=dtype,
                               head_dim=32, attn_chunk_q=16, attn_chunk_k=16)
    params = init_params(M.param_specs(base), 0, device=card)
    toks = torch.randint(0, base.vocab, (2, 45), device=card,
                         generator=torch.Generator(device=card).manual_seed(1))
    out = {}
    for impl in ("xla", "pallas"):
        cfg = dataclasses.replace(base, attn_impl=impl)
        n = flash_fwd.launches
        with torch.no_grad():
            out[impl] = M.forward(cfg, params, toks, last_only=True)[0]
        assert flash_fwd.launches - n == (cfg.n_layers if impl == "pallas"
                                          else 0)
    # bf16: the two attention paths round p and o differently, and two
    # layers carry that into logits of unit scale (random init)
    tol = 1e-4 if dtype == "float32" else 5e-2
    torch.testing.assert_close(out["pallas"].float(), out["xla"].float(),
                               rtol=tol, atol=tol)
    if dtype == "float32":
        nxt = make_prefill_step(dataclasses.replace(base, attn_impl="pallas"))(
            params, dict(tokens=toks))
        assert nxt.tolist() == out["xla"][:, -1].argmax(-1).tolist()


@pytest.mark.parametrize("B,S,H,KV,hd,causal", [
    (2, 1000, 16, 8, 128, True), (1, 4097, 16, 8, 128, True),
    (2, 1000, 12, 4, 64, True), (2, 300, 6, 2, 32, True),
    (2, 333, 6, 2, 16, True), (2, 256, 8, 2, 128, False),
    (1, 97, 6, 2, 64, False), (2, 130, 4, 4, 16, False)])
def test_flash_fwd_fp32_micro_tiles_match_plain(card, B, S, H, KV, hd,
                                                causal):
    """The fp32 forward (register micro-tiles, two 32-key softmax steps a
    64-key tile) at every head dim, ragged S (a tile's second step past
    the keys), G = 3 and non-causal; bit-identical run to run."""
    qp, kp, vp = _packed(card, B, S, H, KV, hd, torch.float32, 4, S + 7)
    kw = dict(causal=causal, scale=hd ** -0.5, sq=S, sk=S)
    o, lse = flash_fwd(qp, kp, vp, **kw)
    o2, lse2 = flash_fwd(qp, kp, vp, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    ro, rl = flash_fwd_ref(qp, kp, vp, **kw)
    torch.testing.assert_close(o[..., :S, :], ro[..., :S, :], rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(lse[..., :S], rl[..., :S], rtol=1e-4,
                               atol=1e-4)
    assert _row_rel(o[..., :S, :], ro[..., :S, :]) <= 1e-5


@pytest.mark.parametrize("B,S,H,KV,pad", [
    (1, 4096, 32, 32, 4096), (2, 1000, 32, 32, 1024), (1, 97, 4, 2, 100),
    (2, 333, 6, 2, 336)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_head_dim_112(card, B, S, H, KV, pad, dtype, causal):
    """zamba2-7b's head dim: seven 16-column blocks under the 32-byte
    swizzle (bf16), seven columns a thread (fp32); against the plain
    version, one launch a call, bit-identical run to run."""
    qp, kp, vp = _packed(card, B, S, H, KV, 112, dtype, pad, S + 112)
    kw = dict(causal=causal, scale=112 ** -0.5, sq=S, sk=S)
    n = flash_fwd.launches
    o, lse = flash_fwd(qp, kp, vp, **kw)
    o2, lse2 = flash_fwd(qp, kp, vp, **kw)
    torch.cuda.synchronize()
    assert flash_fwd.launches == n + 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    ro, rl = flash_fwd_ref(qp, kp, vp, **kw)
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(o[..., :S, :].float(), ro[..., :S, :].float(),
                               rtol=tol, atol=tol)
    torch.testing.assert_close(lse[..., :S], rl[..., :S], rtol=1e-4,
                               atol=1e-4)
    row_tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    assert _row_rel(o[..., :S, :], ro[..., :S, :]) <= row_tol


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_head_dim_112_matches_plain(card, dtype):
    """zamba2-7b's head dim through the K7 backward (bf16: the fused
    kernel, padded to 128 in shared memory; fp32: K7 dq and dkv, seven
    columns a thread) against ``flash_bwd_ref``, per output row at 1e-2
    (bf16) and 1e-5 (fp32), rows whose reference is ~0 left out as in
    ``tests/test_torch_cuda_train.py``."""
    S = 300
    qp, kp, vp = _packed(card, 2, S, 8, 4, 112, dtype, 4, 3)
    g = torch.Generator(device=card).manual_seed(4)
    dop = torch.randn(qp.shape, generator=g, device=card).to(dtype)
    kw = dict(causal=True, scale=112 ** -0.5, sq=S, sk=S)
    o, lse = flash_fwd_ref(qp, kp, vp, **kw)
    dD = (dop.float() * o.float()).sum(-1)
    got = flash_bwd(qp, kp, vp, dop, lse, dD, **kw)
    torch.cuda.synchronize()
    want = flash_bwd_ref(qp, kp, vp, dop, lse, dD, **kw)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    for name, x, ref in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == dtype and torch.isfinite(x).all(), name
        x, ref = x.float(), ref.float()
        rn = ref.norm(dim=-1)
        keep = rn >= 1e-2 * rn.median()
        row = float(((x - ref).norm(dim=-1)[keep] / rn[keep]).max())
        assert row <= tol, (name, row)


FAMILY_K7 = {"granite-moe-1b-a400m": lambda c: c.n_layers,
             "internvl2-2b": lambda c: c.n_layers,
             "musicgen-medium": lambda c: c.n_layers,
             "zamba2-7b": lambda c: c.n_layers // c.attn_every,
             "xlstm-1.3b": lambda c: 0}


@pytest.mark.parametrize("arch", sorted(FAMILY_K7))
def test_family_prefill_kernel_path(card, arch):
    """Each family's smoke model, fp32, prefill on the card: K7 launched
    once a prefill for every attention layer (the hybrid's shared block
    once an application; none for ssm), its tokens equal to the torch-op
    path's (attn_impl='xla')."""
    base = dataclasses.replace(configs.get_smoke(arch), dtype="float32")
    params = init_params(M.param_specs(base), 0, device=card)
    g = torch.Generator(device=card).manual_seed(2)
    cb = (base.n_codebooks,) if base.n_codebooks else ()
    batch = dict(tokens=torch.randint(0, base.vocab, (2, 64) + cb,
                                      device=card, generator=g))
    if base.family == "vlm":
        batch["patch_emb"] = torch.randn(2, base.patch_tokens, base.d_model,
                                         device=card, generator=g) * 0.02
    nxt = {}
    for impl in ("xla", "pallas"):
        n = flash_fwd.launches
        nxt[impl] = make_prefill_step(dataclasses.replace(
            base, attn_impl=impl))(params, batch)
        torch.cuda.synchronize()
        assert flash_fwd.launches - n == (FAMILY_K7[arch](base)
                                          if impl == "pallas" else 0)
    assert nxt["pallas"].shape == (2,) + cb
    assert torch.equal(nxt["pallas"], nxt["xla"])
