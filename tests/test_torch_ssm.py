"""The port's Mamba2 / SSD block (``repro_torch.models.ssm``) against the
JAX package's ``repro.models.ssm``: the same numpy-seeded inputs and
weights through both, in fp32.

Tolerance: fp32 1e-5 abs/rel on every output and state (the same
arithmetic; the chunk einsums and the scan summed in another order)."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import configs as j_configs
from repro.models import ssm as J
from repro_torch.models import ssm as T

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j, np.float32), **TOL)


def _ssd_inputs(B, S, H, P, N, seed):
    return (_rand((B, S, H, P), seed), _rand((B, S, H), seed + 1),
            _rand((B, S, N), seed + 2, 0.5), _rand((B, S, N), seed + 3, 0.5),
            _rand((H,), seed + 4, 0.5), _rand((H,), seed + 5))


@pytest.mark.parametrize("K,cached", [(4, False), (4, True), (1, False)])
def test_causal_conv(K, cached):
    x, w = _rand((2, 7, 6), 0), _rand((K, 6), 1)
    cache = _rand((2, K - 1, 6), 2) if cached else None
    jy, jc = J._causal_conv(jnp.asarray(x), jnp.asarray(w),
                            None if cache is None else jnp.asarray(cache))
    ty, tc = T._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                            None if cache is None else torch.from_numpy(cache))
    _close(ty, jy)
    _close(tc, jc)


@pytest.mark.parametrize("S,chunk", [(32, 8), (24, 24), (16, 32)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked(S, chunk, with_h0):
    B, H, P, N = 2, 3, 4, 5
    ins = _ssd_inputs(B, S, H, P, N, seed=S)
    h0 = _rand((B, H, N, P), 9) if with_h0 else None
    jy, jh = J.ssd_chunked(*map(jnp.asarray, ins), chunk,
                           None if h0 is None else jnp.asarray(h0))
    ty, th = T.ssd_chunked(*map(torch.from_numpy, ins), chunk,
                           None if h0 is None else torch.from_numpy(h0))
    assert ty.shape == (B, S, H, P) and th.dtype == torch.float32
    _close(ty, jy)
    _close(th, jh)


@pytest.mark.parametrize("dt_shift", [0.0, 6.0])
def test_ssd_chunked_grads(dt_shift):
    """Grads of the chunked scan against ``jax.grad`` of the reference's
    (rtol 1e-4: the backward sums in another order), and where a chunk's
    decays sum past exp's range (``dt_shift`` 6: softplus ~6 a step, 64
    steps a chunk) the same outputs, with finite grads in the port; the
    reference's grads are NaN there (its mask comes after the exp: 0 *
    inf, ``ROADMAP.md`` Queue 3)."""
    import jax
    B, S, H, P, N = 1, 64, 2, 4, 3
    x, dt, Bm, Cm, A, D = _ssd_inputs(B, S, H, P, N, seed=5)
    dt = dt + np.float32(dt_shift)
    w = _rand((B, S, H, P), 6)
    ins = (x, dt, Bm, Cm, A, D)

    def jloss(*a):
        return jnp.sum(J.ssd_chunked(*a, S)[0] * w)
    jy = J.ssd_chunked(*map(jnp.asarray, ins), S)[0]
    jg = jax.grad(jloss, argnums=tuple(range(6)))(*map(jnp.asarray, ins))
    t = [torch.from_numpy(a).requires_grad_() for a in ins]
    ty = T.ssd_chunked(*t, S)[0]
    tg = torch.autograd.grad((ty * torch.from_numpy(w)).sum(), t)
    _close(ty.detach(), jy)
    assert all(bool(torch.isfinite(g).all()) for g in tg)
    if dt_shift:
        assert not all(bool(np.isfinite(np.asarray(g)).all()) for g in jg)
    else:
        for g, r in zip(tg, jg):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                       atol=1e-5)


def test_ssd_decode_step_and_the_chunked_scan_agree():
    """One decode step against the reference's, and a run of decode steps
    against the chunked scan's output and final state (the port alone)."""
    B, S, H, P, N = 2, 8, 3, 4, 5
    x, dt, Bm, Cm, A, D = _ssd_inputs(B, S, H, P, N, seed=3)
    h = _rand((B, H, N, P), 4)
    jy, jh = J.ssd_decode_step(*(jnp.asarray(a) for a in
                                 (x[:, 0], dt[:, 0], Bm[:, 0], Cm[:, 0], A, D,
                                  h)))
    ty, th = T.ssd_decode_step(*(torch.from_numpy(a) for a in
                                 (x[:, 0], dt[:, 0], Bm[:, 0], Cm[:, 0], A, D,
                                  h)))
    _close(ty, jy)
    _close(th, jh)
    t = [torch.from_numpy(a) for a in (x, dt, Bm, Cm, A, D)]
    y_all, h_all = T.ssd_chunked(*t, 4)
    hs = torch.zeros(B, H, N, P)
    for i in range(S):
        yi, hs = T.ssd_decode_step(t[0][:, i], t[1][:, i], t[2][:, i],
                                   t[3][:, i], t[4], t[5], hs)
        torch.testing.assert_close(yi, y_all[:, i], **TOL)
    torch.testing.assert_close(hs, h_all, **TOL)


def _block_params(cfg, seed):
    di, N, H, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    d = cfg.d_model
    return {"in_proj": _rand((d, 2 * di + 2 * N + H), seed, d ** -0.5),
            "conv_w": _rand((K, di + 2 * N), seed + 1, 0.5),
            "a_log": _rand((H,), seed + 2, 0.3),
            "dt_bias": _rand((H,), seed + 3, 0.3),
            "d_skip": _rand((H,), seed + 4),
            "norm_inner": 1 + _rand((di,), seed + 5, 0.1),
            "out_proj": _rand((di, d), seed + 6, di ** -0.5)}


@pytest.mark.parametrize("decode,with_state", [(False, False),
                                               (False, True), (True, True)])
def test_mamba2_block(decode, with_state):
    cfg = dataclasses.replace(j_configs.get_smoke("zamba2-7b"),
                              dtype="float32")
    B, S = 2, 64
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    p = _block_params(cfg, seed=11)
    x = _rand((B, cfg.d_model) if decode else (B, S, cfg.d_model), 12)
    state = ((_rand((B, H, N, P), 13), _rand((B, cfg.ssm_conv - 1,
                                              di + 2 * N), 14))
             if with_state else None)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jy, (jh, jc) = J.mamba2_block(
        jnp.asarray(x), jp, cfg, decode=decode,
        state=None if state is None else tuple(map(jnp.asarray, state)))
    ty, (th, tc) = T.mamba2_block(
        torch.from_numpy(x), tp, cfg, decode=decode,
        state=None if state is None else tuple(map(torch.from_numpy, state)))
    _close(ty, jy)
    _close(th, jh)
    _close(tc, jc)
