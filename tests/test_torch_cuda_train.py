"""The K7 backward kernels (``csrc/flash_bwd.cu``) and the training path
on the card.  Without a CUDA device every test skips, decided inside the
``card`` fixture so that all test workers collect the same tests.  Run on
the card with:

    python -m pytest -q -m gpu tests/test_torch_cuda_train.py

Tolerances, against ``flash_bwd_ref`` on the same operands: per row
(query rows for dq, key rows for dk and dv) ||x - ref|| / ||ref||, and
max |x - ref| / max |ref| over the whole output, each at
1e-2 (bf16: the kernels and the plain version round p and ds to bf16 at
the same points, from fp32 scores summed in another order, and round the
outputs to bf16) and 1e-5 (fp32, the same arithmetic in another order;
TF32 is switched off).  The smoke model's grads, kernel path against the
torch-op path: per parameter ||dg|| / ||g|| 1e-4 in fp32 (both paths
fp32, summed in another order), 5e-2 in bf16 (the two attention paths
round p, o and the grads differently in both layers).
This file imports no JAX: the machine with the card has none."""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from repro_torch import configs
from repro_torch.kernels.flash_attention import (flash_bwd, flash_bwd_ref,
                                                 flash_fwd, flash_fwd_ref)
from repro_torch.kernels.flash_attention.ops import _pack
from repro_torch.models import model as M
from repro_torch.models.layers import init_params
from repro_torch.training.optimizer import Optimizer, global_norm
from repro_torch.training.step import make_train_step

pytestmark = pytest.mark.gpu

ROW_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _pad_seq(x, axis, mult):
    pad = (-x.shape[axis]) % mult
    return F.pad(x, [0, 0] * (x.ndim - axis - 1) + [0, pad]).contiguous()


def _errors(x, ref):
    """(max over rows of ||x - ref|| / ||ref||, max |x - ref| / max |ref|).
    Rows whose ref norm is below 1e-2 of the median row's are left to the
    second measure: their exact value is ~0 (dq's first causal row: its
    only key gives ds = p (do.v - do.o) = 0), and what both sides hold
    there is rounding noise of the terms, not of the result."""
    x, ref = x.float(), ref.float()
    rn = ref.norm(dim=-1)
    keep = rn >= 1e-2 * rn.median()
    row = float(((x - ref).norm(dim=-1)[keep] / rn[keep]).max())
    return row, float((x - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("B,S,H,KV,hd,pad", [
    (1, 256, 16, 8, 128, 256), (2, 1000, 16, 8, 128, 1024),
    (2, 100, 4, 2, 64, 128), (1, 40, 6, 2, 32, 40), (2, 33, 4, 4, 16, 64)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_matches_plain(card, B, S, H, KV, hd, pad, dtype, causal):
    g = torch.Generator(device=card).manual_seed(S + hd)
    q, k, v, do = (torch.randn(B, S, n, hd, generator=g, device=card)
                   .to(dtype) for n in (H, KV, KV, H))
    qp, kp, vp = (_pad_seq(x, ax, pad) for x, ax in
                  zip(_pack(q, k, v), (3, 2, 2)))
    dop = _pad_seq(_pack(do, k, v)[0], 3, pad)
    kw = dict(causal=causal, scale=hd ** -0.5, sq=S, sk=S)
    o, lse = flash_fwd_ref(qp, kp, vp, **kw)
    dD = (dop.float() * o.float()).sum(-1)
    n = (flash_bwd.dq_launches, flash_bwd.dkv_launches)
    got = flash_bwd(qp, kp, vp, dop, lse, dD, **kw)
    torch.cuda.synchronize()
    assert (flash_bwd.dq_launches, flash_bwd.dkv_launches) == (n[0] + 1,
                                                               n[1] + 1)
    want = flash_bwd_ref(qp, kp, vp, dop, lse, dD, **kw)
    for name, x, ref, real in zip(("dq", "dk", "dv"), got, want,
                                  (slice(0, S),) * 3):
        assert x.dtype == dtype and x.shape == ref.shape
        assert torch.isfinite(x).all(), name
        row, scaled = _errors(x[..., real, :], ref[..., real, :])
        assert row <= ROW_TOL[dtype] and scaled <= ROW_TOL[dtype], \
            (name, row, scaled)
    # padded query rows of dq and keys past sk are 0
    assert not got[0][..., S:, :].any()
    assert not got[1][..., S:, :].any() and not got[2][..., S:, :].any()


def test_flash_bwd_refuses_what_the_kernels_do_not_take(card):
    q = torch.randn(1, 2, 2, 64, 128, device=card, dtype=torch.bfloat16)
    k = torch.randn(1, 2, 64, 128, device=card, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 2, 64, device=card)
    kw = dict(causal=True, scale=0.1, sq=64, sk=64)
    with pytest.raises(ValueError, match="lse"):
        flash_bwd(q, k, k, q, lse.double(), lse, **kw)
    with pytest.raises(ValueError, match="do"):
        flash_bwd(q, k, k, q.float(), lse, lse, **kw)
    with pytest.raises(ValueError, match="real lengths"):
        flash_bwd(q, k, k, q, lse, lse, causal=True, scale=0.1, sq=65,
                  sk=64)


def _grad_probe():
    """Optimizer whose state becomes the step's averaged grads."""
    return Optimizer(
        init=lambda p: None,
        update=lambda g, st, p: ({k: torch.zeros_like(v) for k, v in
                                  p.items()}, g,
                                 dict(lr=torch.zeros(()),
                                      grad_norm=global_norm(g))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_smoke_train_step_kernel_path_matches_torch_op_path(card, dtype):
    """The qwen3 smoke model's grads on the card, remat on: attn_impl=
    'pallas' (K7 fwd twice and dq, dkv once per layer) against 'xla'."""
    base = dataclasses.replace(configs.get_smoke("qwen3-1.7b"), dtype=dtype,
                               remat=True)
    params = init_params(M.param_specs(base), 0, device=card)
    g = torch.Generator(device=card).manual_seed(1)
    toks = torch.randint(0, base.vocab, (2, 45), device=card, generator=g)
    batch = dict(tokens=toks, labels=toks.roll(-1, 1))
    grads = {}
    for impl in ("xla", "pallas"):
        cfg = dataclasses.replace(base, attn_impl=impl)
        opt = _grad_probe()
        n = (flash_fwd.launches, flash_bwd.dq_launches,
             flash_bwd.dkv_launches)
        _, grads[impl], m = make_train_step(cfg, opt)(dict(params),
                                                      opt.init(params), batch)
        torch.cuda.synchronize()
        L = cfg.n_layers if impl == "pallas" else 0
        assert (flash_fwd.launches - n[0], flash_bwd.dq_launches - n[1],
                flash_bwd.dkv_launches - n[2]) == (2 * L, L, L)
        assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    tol = 1e-4 if dtype == "float32" else 5e-2
    for k, gx in grads["xla"].items():
        gp = grads["pallas"][k]
        assert gp.dtype == torch.float32
        rel = float((gp - gx).norm() / gx.norm().clamp(min=1e-30))
        assert rel <= tol, (k, rel)
