"""The port's moe, vlm, audio, hybrid and ssm families (``repro_torch.models
.model``, ``training.step``, ``launch.serve``) against the JAX package's,
on each family's smoke config in fp32: the same weights (the JAX
package's ``init_params``, carried across with ``params_from_jax``) and
the same numpy-seeded tokens through both.

Tolerances: fp32 1e-5 abs/rel on logits, aux and every cache leaf (the
same arithmetic, summed in another order); tokens and the served streams
exactly; decode == prefill at 2e-3 (``tests/test_archs.py``).  The JAX
side runs its Pallas flash kernel in interpret mode (``model.py`` does so
off the TPU)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AxisType

from repro import configs as j_configs
from repro.kernels.flash_attention.kernel import flash_fwd_pallas
from repro.launch import serve as j_serve
from repro.models import layers as j_layers
from repro.models import model as JM
from repro.training.step import make_prefill_step as j_prefill_step
from repro_torch import configs as t_configs
from repro_torch.kernels.flash_attention import flash_attention, flash_fwd
from repro_torch.kernels.flash_attention import ops as k7_ops
from repro_torch.launch.serve import serve_lm
from repro_torch.models import model as TM
from repro_torch.models.weights import params_from_jax
from repro_torch.training.step import make_prefill_step, make_serve_step

ARCHS = ["granite-moe-1b-a400m", "internvl2-2b", "musicgen-medium",
         "zamba2-7b", "xlstm-1.3b"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg(arch, **kw):
    return dataclasses.replace(j_configs.get_smoke(arch), dtype="float32",
                               **kw)


def _tcfg(arch, **kw):
    return dataclasses.replace(t_configs.get_smoke(arch), dtype="float32",
                               **kw)


_WEIGHTS = {}


def _weights(arch, seed=0):
    """JAX params of the smoke config (``jax.random.key(seed)``, as the
    JAX serve() draws them) and the same weights in the port."""
    if (arch, seed) not in _WEIGHTS:
        jp = j_layers.init_params(JM.param_specs(_cfg(arch)),
                                  jax.random.key(seed))
        _WEIGHTS[arch, seed] = jp, params_from_jax(
            {k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    return _WEIGHTS[arch, seed]


def _batch(cfg, B, S, seed):
    """tokens (B, S[, n_cb]) and, for vlm, patch_emb (B, n_patch, d)."""
    rng = np.random.default_rng(seed)
    cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    out = dict(tokens=rng.integers(0, cfg.vocab, (B, S) + cb,
                                   dtype=np.int32))
    if cfg.family == "vlm":
        out["patch_emb"] = (rng.normal(size=(B, cfg.patch_tokens,
                                             cfg.d_model)) * 0.02
                            ).astype(np.float32)
    return out


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_the_reference(arch):
    js, ts = JM.param_specs(_cfg(arch)), TM.param_specs(_tcfg(arch))
    assert sorted(js) == sorted(ts)
    for k in js:
        assert (js[k].shape, js[k].logical, js[k].init, js[k].scale) == \
            (ts[k].shape, ts[k].logical, ts[k].init, ts[k].scale), k
    full = t_configs.get_config(arch)
    assert full.n_params() == j_configs.get_config(arch).n_params()
    assert full.n_active_params() == \
        j_configs.get_config(arch).n_active_params()


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_the_reference(arch, impl):
    jp, tp = _weights(arch)
    b = _batch(_cfg(arch), 2, 32, seed=1)
    jl, ja = JM.forward(_cfg(arch, attn_impl=impl), jp, jnp.asarray(
        b["tokens"]), patch_emb=_j(b).get("patch_emb"))
    tl, ta = TM.forward(_tcfg(arch, attn_impl=impl), tp, torch.from_numpy(
        b["tokens"]), patch_emb=_t(b).get("patch_emb"))
    assert tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), **TOL)
    if arch == "granite-moe-1b-a400m":
        assert float(ta) > 0                  # summed over the layers
    last, _ = TM.forward(_tcfg(arch, attn_impl=impl), tp, torch.from_numpy(
        b["tokens"]), patch_emb=_t(b).get("patch_emb"), last_only=True)
    torch.testing.assert_close(last[:, 0], tl[:, -1], **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_the_reference(arch):
    """Eight decode steps of a batch of 2 from a zero cache: logits and
    every cache leaf after every step."""
    jp, tp = _weights(arch)
    cfg, tcfg = _cfg(arch), _tcfg(arch)
    toks = _batch(cfg, 2, 8, seed=2)["tokens"]
    jc = JM.init_cache(cfg, 2, 16)
    tc = TM.init_cache(tcfg, 2, 16, device="cpu")
    assert sorted(jc) == sorted(tc)
    for name in jc:
        assert tuple(tc[name].shape) == jc[name].shape
        assert str(tc[name].dtype).split(".")[1] == str(jc[name].dtype)
    dec = jax.jit(lambda p, c, t, i: JM.decode_step(cfg, p, c, t, i))
    for i in range(8):
        jl, jc = dec(jp, jc, jnp.asarray(toks[:, i]), jnp.int32(i))
        tl, tc = TM.decode_step(tcfg, tp, tc, torch.from_numpy(toks[:, i]), i)
        np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
        for name in jc:
            np.testing.assert_allclose(tc[name].numpy(), _np(jc[name]),
                                       err_msg=f"{name} at step {i}", **TOL)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "internvl2-2b"])
def test_decode_matches_prefill(arch):
    """tests/test_archs.py's check on the port alone: step-by-step decode
    logits equal the teacher-forced forward's at every position (moe with
    the capacity raised so that no token drops; vlm is skipped there)."""
    tcfg = _tcfg(arch)
    if tcfg.is_moe:
        tcfg = dataclasses.replace(
            tcfg, capacity_factor=float(tcfg.n_experts) / tcfg.top_k + 1.0)
    _, tp = _weights(arch)
    B, S = 2, 24
    toks = torch.from_numpy(_batch(tcfg, B, S, seed=3)["tokens"])
    full, _ = TM.forward(tcfg, tp, toks)
    cache = TM.init_cache(tcfg, B, 32, device="cpu")
    outs = []
    for i in range(S):
        lg, cache = TM.decode_step(tcfg, tp, cache, toks[:, i], i)
        outs.append(lg)
    torch.testing.assert_close(torch.stack(outs, 1), full, rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_tokens_match(arch):
    jp, tp = _weights(arch)
    b = _batch(_cfg(arch), 3, 16, seed=4)
    want = np.asarray(j_prefill_step(_cfg(arch))(jp, _j(b)))
    got = make_prefill_step(_tcfg(arch))(tp, _t(b))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_serve(monkeypatch, argv, zero_router=False):
    """The JAX package's serve() on fp32 smoke weights, on Auto mesh axes
    (jax 0.9 makes Explicit ones by default, which its sharding
    constraints reject); ``zero_router`` zeroes the moe router so that
    every token ties on experts 0 .. k-1."""
    smoke = j_configs.get_smoke
    monkeypatch.setattr(j_configs, "get_smoke",
                        lambda a: dataclasses.replace(smoke(a),
                                                      dtype="float32"))
    monkeypatch.setattr(j_serve, "make_local_mesh", lambda model=1:
                        jax.make_mesh((1, model), ("data", "model"),
                                      axis_types=(AxisType.Auto,) * 2))
    if zero_router:
        init = j_serve.init_params

        def zeroed(specs, key):
            p = init(specs, key)
            return dict(p, **{"layers/moe/wg":
                              jnp.zeros_like(p["layers/moe/wg"])})
        monkeypatch.setattr(j_serve, "init_params", zeroed)
    return j_serve.serve(argv)


def _prompts(cfg, n, plen, seed=0):
    """The prompts the JAX serve() draws for ``--seed seed``."""
    rng = np.random.default_rng(seed)
    cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    return [rng.integers(0, cfg.vocab, (plen,) + cb).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("arch", ARCHS)
def test_served_streams_equal_jax_serve(arch, monkeypatch):
    """The port's serve loop on the JAX serve's own weights and prompts:
    every request's token stream equal, token for token (audio: a list of
    codebook tokens a step).  moe at 2 slots: the batched decode's one
    capacity group would drop a slot's token whenever both slots pick an
    expert; the served loop routes each slot alone, as the reference."""
    argv = ["--arch", arch, "--smoke", "--requests", "5", "--slots", "2",
            "--prompt-len", "4", "--max-new", "5", "--max-seq", "12"]
    want = _jax_serve(monkeypatch, argv)
    _, tp = _weights(arch)
    cfg = _tcfg(arch)
    got = serve_lm(cfg, tp, _prompts(cfg, 5, 4), slots=2, max_new=5,
                   max_seq=12)
    assert got["outputs"] == want["outputs"]
    assert (got["tokens"], got["steps"]) == (want["tokens"], want["steps"])
    if cfg.n_codebooks:
        assert all(len(t) == cfg.n_codebooks for v in got["outputs"].values()
                   for t in v)


def test_moe_served_streams_with_a_forced_cross_slot_drop(monkeypatch):
    """The router zeroed: every token ties on experts 0 and 1, so at 4
    slots a decode grouping the batch (capacity int(4 * 2 * 1.25 / 8 + 1)
    = 2) drops slots 2 and 3 from both experts in every layer, where the
    reference's vmapped one-slot decode (capacity 1, one token) drops
    none.  The served streams still equal the JAX serve's; the batched
    decode, on the same cache, gives other logits."""
    arch = "granite-moe-1b-a400m"
    argv = ["--arch", arch, "--smoke", "--requests", "4", "--slots", "4",
            "--prompt-len", "4", "--max-new", "5", "--max-seq", "12"]
    want = _jax_serve(monkeypatch, argv, zero_router=True)
    _, tp = _weights(arch)
    tp = dict(tp, **{"layers/moe/wg": torch.zeros_like(tp["layers/moe/wg"])})
    cfg = _tcfg(arch)
    got = serve_lm(cfg, tp, _prompts(cfg, 4, 4), slots=4, max_new=5,
                   max_seq=12)
    assert got["outputs"] == want["outputs"]
    toks = torch.arange(4, dtype=torch.int32) * 7
    per_slot = TM.decode_step(dataclasses.replace(cfg, moe_group=1), tp,
                              TM.init_cache(cfg, 4, 8, device="cpu"), toks,
                              0)[0]
    batched = TM.decode_step(cfg, tp, TM.init_cache(cfg, 4, 8, device="cpu"),
                             toks, 0)[0]
    torch.testing.assert_close(per_slot[:2], batched[:2], **TOL)
    assert not torch.allclose(per_slot[2:], batched[2:], atol=1e-3)


def test_serve_step_returns_codebook_tokens():
    arch = "musicgen-medium"
    _, tp = _weights(arch)
    cfg = _tcfg(arch)
    cache = TM.init_cache(cfg, 3, 8, device="cpu")
    toks = torch.from_numpy(_batch(cfg, 3, 1, seed=5)["tokens"][:, 0])
    nxt, _ = make_serve_step(cfg)(tp, cache, toks, torch.zeros(3, dtype=int))
    assert tuple(nxt.shape) == (3, cfg.n_codebooks) and nxt.dtype == \
        torch.int32


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,block", [(48, 16), (37, 32)])
def test_k7_plain_at_head_dim_112_matches_jax_kernel(S, block, causal):
    """zamba2-7b's head dim: K7's plain version (the wrapper on a CPU
    tensor) against ``flash_fwd_pallas(interpret=True)`` on the same
    packed, padded operands, o and lse on the real rows; and the public
    wrapper against the reference's at (B, S, 4, 4, 112)."""
    rng = np.random.default_rng(S)
    B, H, KV, hd = 1, 4, 2, 112
    q, k, v = (rng.normal(size=(B, S, n, hd)).astype(np.float32)
               for n in (H, KV, KV))
    qp, kp, vp = k7_ops._pack(*map(torch.from_numpy, (q, k, v)))
    pad = -S % block
    qp = torch.nn.functional.pad(qp, (0, 0, 0, pad)).contiguous()
    kp = torch.nn.functional.pad(kp, (0, 0, 0, pad)).contiguous()
    vp = torch.nn.functional.pad(vp, (0, 0, 0, pad)).contiguous()
    sc = hd ** -0.5
    jo, jl = flash_fwd_pallas(jnp.asarray(qp.numpy()), jnp.asarray(kp.numpy()),
                              jnp.asarray(vp.numpy()), causal=causal,
                              scale=sc, sq=S, sk=S, block_q=block,
                              block_k=block, interpret=True)
    o, lse = flash_fwd(qp, kp, vp, causal=causal, scale=sc, sq=S, sk=S)
    np.testing.assert_allclose(o[..., :S, :].numpy(), _np(jo)[..., :S, :],
                               **TOL)
    np.testing.assert_allclose(lse[..., :S].numpy(), _np(jl)[..., :S], **TOL)
    from repro.kernels.flash_attention.ops import flash_attention_pallas
    want = flash_attention_pallas(*map(jnp.asarray, (q, k, v)), causal,
                                  block, block, None, True)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal, block,
                          block)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_k7_head_dims_forward_and_backward():
    """Both directions take hd 112 (zamba2-7b's) and refuse hd 96 (the
    check the CUDA entries make first)."""
    assert 112 in k7_ops.HEAD_DIMS
    qp = torch.zeros(1, 1, 1, 16, 112)
    kp = torch.zeros(1, 1, 16, 112)
    rows = torch.zeros(1, 1, 1, 16)
    assert k7_ops._check("flash_fwd", qp, kp, kp, 16, 16)[-1] == 112
    assert k7_ops._check("flash_bwd", qp, kp, kp, 16, 16, qp, rows,
                         rows)[-1] == 112
    q96, k96 = torch.zeros(1, 1, 1, 16, 96), torch.zeros(1, 1, 16, 96)
    with pytest.raises(ValueError, match="head dim 96"):
        k7_ops._check("flash_fwd", q96, k96, k96, 16, 16)
    with pytest.raises(ValueError, match="head dim 96"):
        k7_ops._check("flash_bwd", q96, k96, k96, 16, 16, q96, rows, rows)
