"""Shared set-up of the family training tests (``test_torch_train_*.py``):
each family's smoke config in fp32 in both packages, the JAX package's
weights carried into the port with ``params_from_jax``, numpy-seeded
batches, grads against ``jax.value_and_grad`` of the reference's
``loss_fn``, and the two packages' grad-probe optimizers (a stub whose
update IS the averaged gradient, ``tests/test_training.py``).

Tolerances as ``tests/test_torch_training.py``'s: the loss totals and
metrics rtol 1e-5; every grad leaf rtol 1e-3 / atol 1e-5 (the forward
and backward summed in another order).  The JAX side runs its Pallas
flash kernel in interpret mode (``model.py`` does so off the TPU); the
port's K7 wrappers run their plain versions on CPU tensors, the backward
at hd 112 included."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as j_configs
from repro.models import layers as j_layers
from repro.models import model as JM
from repro.training import optimizer as j_opt
from repro.training import step as j_step
from repro_torch import configs as t_configs
from repro_torch.models.weights import params_from_jax
from repro_torch.training import optimizer as t_opt
from repro_torch.training import step as t_step

ARCHS = ["granite-moe-1b-a400m", "internvl2-2b", "musicgen-medium",
         "zamba2-7b", "xlstm-1.3b"]
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
# zamba2's smoke config at zamba2-7b's head dim (3584 / 32 = 112): two
# heads of 112 in a 224-wide model, so that the shared block's attention
# runs the K7 backward at hd 112
HD112 = dict(d_model=224, n_heads=2, n_kv=2)


def cfg(arch, **kw):
    return dataclasses.replace(j_configs.get_smoke(arch), dtype="float32",
                               **kw)


def tcfg(arch, **kw):
    return dataclasses.replace(t_configs.get_smoke(arch), dtype="float32",
                               **kw)


_WEIGHTS = {}


def weights(arch, **kw):
    """The JAX params of the (replaced) smoke config from
    ``jax.random.key(0)`` and the same weights in the port."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _WEIGHTS:
        jp = j_layers.init_params(JM.param_specs(cfg(arch, **kw)),
                                  jax.random.key(0))
        _WEIGHTS[key] = jp, params_from_jax(
            {k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    return _WEIGHTS[key]


def batch(c, B, S, seed):
    """tokens (B, S[, n_cb]), labels like them (the next token, the last
    position masked), and for vlm patch_emb (B, n_patch, d), for config
    ``c``."""
    rng = np.random.default_rng(seed)
    cb = (c.n_codebooks,) if c.n_codebooks else ()
    toks = rng.integers(0, c.vocab, (B, S) + cb, dtype=np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    out = dict(tokens=toks, labels=labels)
    if c.family == "vlm":
        out["patch_emb"] = (rng.normal(size=(B, c.patch_tokens,
                                             c.d_model)) * 0.02
                            ).astype(np.float32)
    return out


def to_j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def as_np(x):
    return np.array(jnp.asarray(x, jnp.float32))


def grads_match(arch, impl, B=2, S=32, seed=4, **kw):
    """loss_fn's total, metrics and every grad leaf, port against
    ``jax.value_and_grad`` of the reference's; returns the port's
    metrics."""
    jp, tp = weights(arch, **kw)
    b = batch(cfg(arch, **kw), B, S, seed)
    (jtot, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: j_step.loss_fn(cfg(arch, attn_impl=impl, **kw), p,
                                 to_j(b)), has_aux=True))(jp)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tot, tm = t_step.loss_fn(tcfg(arch, attn_impl=impl, **kw), leaves,
                             to_t(b))
    tot.backward()
    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=1e-5)
    for m in ("loss", "aux_loss", "tokens"):
        np.testing.assert_allclose(float(tm[m].detach()), float(jm[m]),
                                   rtol=1e-5, err_msg=m)
    for k in jp:
        np.testing.assert_allclose(leaves[k].grad.numpy(), as_np(jg[k]),
                                   **GRAD_TOL, err_msg=k)
    return {k: float(v.detach()) for k, v in tm.items()}


def t_probe():
    """The port's stub optimizer: its update IS the averaged gradient
    (``tests/test_torch_training.py``)."""
    def update(g, st, params):
        return g, st, dict(lr=torch.zeros(()),
                           grad_norm=t_opt.global_norm(g))
    return t_opt.Optimizer(init=lambda p: torch.zeros((), dtype=torch.int32),
                           update=update)


def j_probe():
    """The reference test's stub optimizer (``tests/test_training.py``)."""
    def update(g, st, params):
        return g, st, dict(lr=jnp.float32(0), grad_norm=j_opt.global_norm(g))
    return j_opt.Optimizer(init=lambda p: jnp.int32(0), update=update)


def probe_grads(c, params, b, accum=1):
    """The port's train step under config ``c`` on numpy batch ``b``:
    (its averaged fp32 grads, its metrics)."""
    opt = t_probe()
    out, _, m = t_step.make_train_step(c, opt, accum=accum)(
        dict(params), opt.init(params), to_t(b))
    return {k: out[k] - params[k] for k in params}, m


