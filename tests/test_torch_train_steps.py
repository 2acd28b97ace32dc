"""The family train steps in the port (``repro_torch.training.step``):
hybrid grads at zamba2-7b's head dim 112 through K7's backward,
``accum=2`` and remat, against the JAX package's steps on each family's
smoke config in fp32 (``tests/_train_families.py``; metrics rtol 1e-5,
grads rtol 1e-3 / atol 1e-5, remat on against off exactly)."""
import jax
import numpy as np
import pytest
import torch

import _train_families as F
from repro.training import step as j_step


def test_hybrid_grads_at_head_dim_112():
    """zamba2's smoke config at two heads of 112 (``F.HD112``): the shared
    block's attention through K7's autograd (the plain backward at hd 112
    on the CPU) against ``jax.grad`` through the reference's Pallas
    kernel in interpret mode."""
    assert F.tcfg("zamba2-7b", **F.HD112).hd == 112
    F.grads_match("zamba2-7b", "pallas", **F.HD112)


@pytest.mark.parametrize("arch", F.ARCHS)
def test_grad_accum_matches(arch):
    """accum=2 on a batch: the port's step against the reference's step
    with accum=2, and against the port's accum=1 on the same batch.  moe's
    load-balance aux is taken per microbatch (the reference's scan does
    the same), so there the two differ by 0.01 times the aux's change, in
    the router's grads and every grad below it; the loss is equal."""
    jp, tp = F.weights(arch)
    b = F.batch(F.cfg(arch), 4, 32, seed=6)
    opt = F.j_probe()
    jout, _, jm = jax.jit(j_step.make_train_step(F.cfg(arch), opt,
                                                 accum=2))(
        jp, opt.init(jp), F.to_j(b))
    g2, m2 = F.probe_grads(F.tcfg(arch), tp, b, accum=2)
    for m in ("loss", "aux_loss", "tokens"):
        np.testing.assert_allclose(float(m2[m]), float(jm[m]), rtol=1e-5,
                                   err_msg=m)
    for k in jp:
        np.testing.assert_allclose(g2[k].numpy(), F.as_np(jout[k] - jp[k]),
                                   **F.GRAD_TOL, err_msg=k)
    g1, m1 = F.probe_grads(F.tcfg(arch), tp, b)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    assert float(m2["tokens"]) == float(m1["tokens"])
    if F.cfg(arch).family != "moe":
        for k in tp:
            np.testing.assert_allclose(g2[k].numpy(), g1[k].numpy(),
                                       **F.GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("arch", F.ARCHS)
def test_remat_on_equals_remat_off(arch):
    """Recomputing each layer (and each application of zamba2's shared
    block) in the backward pass changes no grad."""
    _, tp = F.weights(arch)
    b = F.batch(F.cfg(arch), 2, 32, seed=7)
    impl = "xla" if arch == "xlstm-1.3b" else "pallas"
    off, _ = F.probe_grads(F.tcfg(arch, attn_impl=impl, remat=False), tp, b)
    on, _ = F.probe_grads(F.tcfg(arch, attn_impl=impl, remat=True), tp, b)
    for k in tp:
        torch.testing.assert_close(on[k], off[k], rtol=0, atol=0)
