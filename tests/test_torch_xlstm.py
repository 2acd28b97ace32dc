"""The port's xLSTM blocks (``repro_torch.models.xlstm``) against the JAX
package's ``repro.models.xlstm``: the same numpy-seeded inputs and
weights through both, in fp32, with their states.

Tolerance: fp32 1e-5 abs/rel on every output and state (the same
arithmetic, summed in another order; the sLSTM's input projection is
taken for all steps in one product)."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import configs as j_configs
from repro.models import xlstm as J
from repro_torch.models import xlstm as T

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j, np.float32), **TOL)


def _gates(B, S, H, P, seed):
    return (_rand((B, S, H, P), seed), _rand((B, S, H, P), seed + 1),
            _rand((B, S, H, P), seed + 2), _rand((B, S, H), seed + 3),
            _rand((B, S, H), seed + 4, 2.0))


def _state(B, H, P, seed):
    return (_rand((B, H, P, P), seed, 0.3), _rand((B, H, P), seed + 1, 0.3),
            _rand((B, H), seed + 2))


@pytest.mark.parametrize("S,chunk", [(32, 8), (16, 16), (12, 32)])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_chunked(S, chunk, with_state):
    B, H, P = 2, 2, 4
    ins = _gates(B, S, H, P, seed=S)
    st = _state(B, H, P, 7) if with_state else None
    jh, jst = J.mlstm_chunked(*map(jnp.asarray, ins), chunk,
                              None if st is None else
                              tuple(map(jnp.asarray, st)))
    th, tst = T.mlstm_chunked(*map(torch.from_numpy, ins), chunk,
                              None if st is None else
                              tuple(map(torch.from_numpy, st)))
    _close(th, jh)
    for t, j in zip(tst, jst):
        _close(t, j)


def test_mlstm_decode_step_and_the_chunked_form_agree():
    B, S, H, P = 2, 8, 2, 4
    q, k, v, i, f = _gates(B, S, H, P, seed=3)
    st = _state(B, H, P, 4)
    jh, jst = J.mlstm_decode_step(*(jnp.asarray(a[:, 0]) for a in
                                    (q, k, v, i, f)),
                                  tuple(map(jnp.asarray, st)))
    th, tst = T.mlstm_decode_step(*(torch.from_numpy(a[:, 0]) for a in
                                    (q, k, v, i, f)),
                                  tuple(map(torch.from_numpy, st)))
    _close(th, jh)
    for t, j in zip(tst, jst):
        _close(t, j)
    t = [torch.from_numpy(a) for a in (q, k, v, i, f)]
    h_all, (C, n, m) = T.mlstm_chunked(*t, 4)
    s = (torch.zeros(B, H, P, P), torch.zeros(B, H, P),
         torch.full((B, H), -1e30))
    for j in range(S):
        hj, s = T.mlstm_decode_step(*(a[:, j] for a in t), s)
        torch.testing.assert_close(hj, h_all[:, j], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(s[0] * torch.exp(s[2])[..., None, None],
                               C * torch.exp(m)[..., None, None], **TOL)


def _cfg():
    return dataclasses.replace(j_configs.get_smoke("xlstm-1.3b"),
                               dtype="float32")


def _mlstm_params(cfg, seed):
    d = cfg.d_model
    di = cfg.mlstm_proj * d
    H = cfg.n_heads
    P = di // H
    return {"up_proj": _rand((d, 2 * di), seed, d ** -0.5),
            "conv_w": _rand((cfg.ssm_conv, di), seed + 1, 0.5),
            "wq": _rand((H, P, P), seed + 2, P ** -0.5),
            "wk": _rand((H, P, P), seed + 3, P ** -0.5),
            "wv": _rand((H, P, P), seed + 4, P ** -0.5),
            "wi": _rand((di, H), seed + 5, di ** -0.5),
            "wf": _rand((di, H), seed + 6, di ** -0.5),
            "norm_inner": 1 + _rand((di,), seed + 7, 0.1),
            "down_proj": _rand((di, d), seed + 8, di ** -0.5)}


def _slstm_params(cfg, seed):
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    ff = ((4 * d // 3) + 127) // 128 * 128
    return {"w_gates": _rand((d, 4 * d), seed, d ** -0.5),
            "r_gates": _rand((H, dh, 4 * dh), seed + 1, 0.5 * dh ** -0.5),
            "ln": 1 + _rand((d,), seed + 2, 0.1),
            "up": _rand((d, ff), seed + 3, d ** -0.5),
            "down": _rand((ff, d), seed + 4, ff ** -0.5)}


def _run_block(jfn, tfn, p, cfg, x, state, decode):
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    conv = lambda s, f: tuple(conv(a, f) for a in s) \
        if isinstance(s, tuple) else f(s)
    jy, jst = jfn(jnp.asarray(x), jp, cfg, decode=decode,
                  state=None if state is None else conv(state, jnp.asarray))
    ty, tst = tfn(torch.from_numpy(x), tp, cfg, decode=decode,
                  state=None if state is None else conv(state,
                                                        torch.from_numpy))
    _close(ty, jy)
    flat = lambda s: sum((flat(a) for a in s), []) \
        if isinstance(s, tuple) else [s]
    for t, j in zip(flat(tst), flat(jst), strict=True):
        _close(t, j)


@pytest.mark.parametrize("decode,with_state", [(False, False),
                                               (False, True), (True, True)])
def test_mlstm_block(decode, with_state):
    cfg = _cfg()
    B, S = 2, 64
    di = cfg.mlstm_proj * cfg.d_model
    H, P = cfg.n_heads, di // cfg.n_heads
    x = _rand((B, cfg.d_model) if decode else (B, S, cfg.d_model), 21)
    state = ((_state(B, H, P, 22), _rand((B, cfg.ssm_conv - 1, di), 23))
             if with_state else None)
    _run_block(J.mlstm_block, T.mlstm_block, _mlstm_params(cfg, 20), cfg, x,
               state, decode)


@pytest.mark.parametrize("decode,with_state", [(False, False),
                                               (False, True), (True, True)])
def test_slstm_block(decode, with_state):
    cfg = _cfg()
    B, S = 2, 40
    H, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    x = _rand((B, cfg.d_model) if decode else (B, S, cfg.d_model), 31)
    state = None
    if with_state:
        c, n, m, h = (_rand((B, H, dh), 32 + i) for i in range(4))
        state = (c, np.abs(n) + 0.5, m, h)
    _run_block(J.slstm_block, T.slstm_block, _slstm_params(cfg, 30), cfg, x,
               state, decode)
