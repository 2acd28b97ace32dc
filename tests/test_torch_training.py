"""The port's training substrate (``repro_torch.training``,
``models.layers.softmax_cross_entropy``, remat in ``models.model``)
against the JAX package's, on the qwen3 smoke config in fp32 with the
same weights (the JAX package's ``init_params``, carried across with
``params_from_jax``) and the same numpy-seeded tokens.

Tolerances: the optimizer's arithmetic 1e-5 relative (the same fp32 ops
in the same order, but the global norm sums in another order and ``pow``
may differ in its last bit, a few ulp through the update); ``loss_fn`` and
its grads rtol 1e-3 / atol 1e-5 (``tests/test_flash_kernel.py:121``: the
forward and backward summed in another order); the int8 codes exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import layers as j_layers
from repro.models import model as JM
from repro.training import compress as j_compress
from repro.training import optimizer as j_opt
from repro.training.step import loss_fn as j_loss_fn
from repro_torch import configs as t_configs
from repro_torch.models import layers as t_layers
from repro_torch.models import model as TM
from repro_torch.models.weights import params_from_jax
from repro_torch.training import compress as t_compress
from repro_torch.training import optimizer as t_opt
from repro_torch.training.step import loss_fn, make_eval_step, make_train_step

ARCH = "qwen3-1.7b"


def _cfg(**kw):
    return dataclasses.replace(j_configs.get_smoke(ARCH), dtype="float32",
                               attn_chunk_q=16, attn_chunk_k=16, **kw)


def _tcfg(**kw):
    return dataclasses.replace(t_configs.get_smoke(ARCH), dtype="float32",
                               attn_chunk_q=16, attn_chunk_k=16, **kw)


@pytest.fixture(scope="module")
def weights():
    jp = j_layers.init_params(JM.param_specs(_cfg()), jax.random.key(0))
    return jp, params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                               device="cpu")


def _batch(B=4, S=32, seed=0):
    toks = np.random.default_rng(seed).integers(0, 256, (B, S),
                                                dtype=np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1                       # one masked label per row
    return toks, labels


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))


def _grad_probe():
    """The reference test's stub optimizer (``tests/test_training.py:
    72-86``): its update IS the averaged gradient."""
    def update(g, st, params):
        return g, st, dict(lr=torch.zeros(()),
                           grad_norm=t_opt.global_norm(g))
    return t_opt.Optimizer(init=lambda p: torch.zeros((), dtype=torch.int32),
                           update=update)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_schedule_and_norms_match():
    for warmup, total in ((10, 100), (0, 7)):
        j = j_opt.cosine_schedule(1e-3, warmup, total, floor=0.1)
        t = t_opt.cosine_schedule(1e-3, warmup, total, floor=0.1)
        for s in (0, 1, warmup, warmup + 3, total // 2, total, total + 5):
            np.testing.assert_allclose(float(t(torch.tensor(s))),
                                       float(j(jnp.int32(s))), rtol=1e-6)
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(4, 3)).astype(np.float32) * 3,
            "b": rng.normal(size=(5,)).astype(np.float32)}
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    tt = {k: torch.from_numpy(v) for k, v in tree.items()}
    np.testing.assert_allclose(float(t_opt.global_norm(tt)),
                               float(j_opt.global_norm(jt)), rtol=1e-6)
    for max_norm in (1.0, 100.0):
        jc, jn = j_opt.clip_by_global_norm(jt, max_norm)
        tc, tn = t_opt.clip_by_global_norm(tt, max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for k in tree:
            np.testing.assert_allclose(tc[k].numpy(), _np(jc[k]), rtol=1e-6)
    assert t_opt._leaf_names(tt) == j_opt._leaf_names(jt)


@pytest.mark.parametrize("max_grad_norm", [0.5, 1e9])
def test_adamw_updates_match(max_grad_norm):
    """Three ``adamw`` updates on the same params and grads: updates,
    moments, step, lr and grad norm; weight decay on the matrix only."""
    rng = np.random.default_rng(1)
    params = {"w": rng.normal(size=(6, 4)).astype(np.float32),
              "s": rng.normal(size=(4,)).astype(np.float32)}
    kw = dict(peak_lr=1e-2, warmup=2, total_steps=10, weight_decay=0.1,
              max_grad_norm=max_grad_norm)
    jo, to = j_opt.adamw(**kw), t_opt.adamw(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    for i in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in params.items()}
        ju, js, jm = jo.update({k: jnp.asarray(v) for k, v in g.items()},
                               js, jp)
        tu, ts, tm = to.update({k: torch.from_numpy(v) for k, v in g.items()},
                               ts, tp)
        assert int(ts.step) == int(js.step) == i + 1
        for k in params:
            np.testing.assert_allclose(tu[k].numpy(), _np(ju[k]), rtol=1e-5,
                                       atol=1e-9)
            np.testing.assert_allclose(ts.mu[k].numpy(), _np(js.mu[k]),
                                       rtol=1e-5, atol=1e-9)
            np.testing.assert_allclose(ts.nu[k].numpy(), _np(js.nu[k]),
                                       rtol=1e-5, atol=1e-12)
        for m in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[m]), float(jm[m]), rtol=1e-5)
        jp = j_opt.apply_updates(jp, ju)
        tp = t_opt.apply_updates(tp, tu)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), _np(jp[k]), rtol=1e-5,
                                       atol=1e-8)


def test_quantize_matches_and_psum_waits_for_multi_gpu():
    rng = np.random.default_rng(2)
    for x in (rng.normal(size=(256,)) * 3.0, np.zeros((4, 3)),
              np.array([0.5, -1.5, 2.5, 127.0])):
        x = x.astype(np.float32)
        jc, js = j_compress._quantize(jnp.asarray(x))
        tc, ts = t_compress._quantize(torch.from_numpy(x))
        assert tc.dtype == torch.int8
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        assert float(ts) == float(js)
        np.testing.assert_array_equal(
            t_compress._dequantize(tc, ts).numpy(),
            np.asarray(j_compress._dequantize(jc, js)))
    err = t_compress.init_error_state({"a": torch.ones(2, 3)})
    assert err["a"].dtype == torch.float32 and not err["a"].any()
    # quantized_psum over one participant, and the step that takes it
    # (the multi-participant checks: tests/test_torch_compress.py)
    g = {"a": torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float32))}
    red, new = t_compress.quantized_psum([g], "pod", [err])
    codes, scale = t_compress._quantize(g["a"])
    assert torch.equal(red[0]["a"], t_compress._dequantize(codes, scale))
    assert torch.equal(new[0]["a"], g["a"] - red[0]["a"])
    step = make_train_step(_tcfg(), _grad_probe(), compress_axis="pod")
    cfg = _tcfg()
    params = t_layers.init_params(TM.param_specs(cfg), 0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 8),
                         generator=torch.Generator().manual_seed(0))
    out = step(params, torch.zeros((), dtype=torch.int32),
               dict(tokens=toks, labels=toks),
               t_compress.init_error_state(params))
    assert len(out) == 4 and set(out[3]) == set(params)


# ---------------------------------------------------------------------------
# loss and grads
# ---------------------------------------------------------------------------

def test_softmax_cross_entropy_matches():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32) * 4
    labels = rng.integers(-1, 11, size=(2, 5)).astype(np.int32)
    jl, jn = j_layers.softmax_cross_entropy(jnp.asarray(logits),
                                            jnp.asarray(labels))
    tl, tn = t_layers.softmax_cross_entropy(torch.from_numpy(logits),
                                            torch.from_numpy(labels))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert float(tn) == float(jn) == float((labels >= 0).sum())
    tb, _ = t_layers.softmax_cross_entropy(
        torch.from_numpy(logits).bfloat16(), torch.from_numpy(labels))
    assert tb.dtype == torch.float32


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_loss_and_grads_match(weights, impl):
    jp, tp = weights
    toks, labels = _batch(2, 24, seed=4)
    jb = dict(tokens=jnp.asarray(toks), labels=jnp.asarray(labels))
    (jtot, jm), jg = jax.value_and_grad(
        lambda p: j_loss_fn(_cfg(attn_impl=impl), p, jb), has_aux=True)(jp)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tot, tm = loss_fn(_tcfg(attn_impl=impl), leaves,
                      dict(tokens=torch.from_numpy(toks),
                           labels=torch.from_numpy(labels)))
    tot.backward()
    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=1e-5)
    for m in ("loss", "aux_loss", "tokens"):
        np.testing.assert_allclose(float(tm[m].detach()), float(jm[m]),
                                   rtol=1e-5)
    assert float(tm["tokens"]) == 2 * 23
    for k in jp:
        np.testing.assert_allclose(leaves[k].grad.numpy(), _np(jg[k]),
                                   rtol=1e-3, atol=1e-5, err_msg=k)
    ev = make_eval_step(_tcfg(attn_impl=impl))(tp, dict(
        tokens=torch.from_numpy(toks), labels=torch.from_numpy(labels)))
    np.testing.assert_allclose(float(ev["loss"]), float(jm["loss"]),
                               rtol=1e-5)


def _probe_grads(cfg, params, toks, labels, accum=1):
    opt = _grad_probe()
    step = make_train_step(cfg, opt, accum=accum)
    out, _, m = step(dict(params), opt.init(params),
                     dict(tokens=torch.from_numpy(toks),
                          labels=torch.from_numpy(labels)))
    return {k: out[k] - params[k] for k in params}, m


def test_grad_accum_invariance(weights):
    """accum=4 on a batch == accum=1 on the same batch (same grads), as
    the reference's ``test_grad_accum_invariance``."""
    _, tp = weights
    toks, labels = _batch(4, 32, seed=5)
    g1, m1 = _probe_grads(_tcfg(), tp, toks, labels)
    g4, m4 = _probe_grads(_tcfg(), tp, toks, labels, accum=4)
    np.testing.assert_allclose(float(m4["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    assert float(m4["tokens"]) == float(m1["tokens"]) == 4 * 31
    for k in tp:
        np.testing.assert_allclose(g4[k].numpy(), g1[k].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=k)
    with pytest.raises(ValueError, match="accum=3"):
        _probe_grads(_tcfg(), tp, toks, labels, accum=3)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_remat_on_equals_remat_off(weights, impl):
    """Recomputing each layer in the backward pass changes no grad."""
    _, tp = weights
    toks, labels = _batch(2, 24, seed=6)
    off, _ = _probe_grads(_tcfg(attn_impl=impl, remat=False), tp, toks,
                          labels)
    on, _ = _probe_grads(_tcfg(attn_impl=impl, remat=True), tp, toks, labels)
    for k in tp:
        torch.testing.assert_close(on[k], off[k], rtol=0, atol=0)


def test_loss_decreases(weights):
    """The reference's ``test_loss_decreases``: 30 AdamW steps on one
    batch take the loss below 0.7 of its first value."""
    _, tp = weights
    toks = np.random.default_rng(0).integers(0, 256, (4, 32), dtype=np.int32)
    batch = dict(tokens=torch.from_numpy(toks), labels=torch.from_numpy(toks))
    opt = t_opt.adamw(peak_lr=3e-3, warmup=2, total_steps=60)
    step = make_train_step(_tcfg(), opt)
    params, st = dict(tp), opt.init(tp)
    first = None
    for _ in range(30):
        params, st, m = step(params, st, batch)
        first = float(m["loss"]) if first is None else first
    assert int(st.step) == 30
    assert float(m["loss"]) < first * 0.7, (first, float(m["loss"]))
