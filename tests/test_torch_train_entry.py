"""The family training's entry points in the port: ``make_eval_step``'s
metrics against the reference's (rtol 1e-5), the bf16 train step's one
cast of the fp32 masters, bit for bit against the reference's, and
``repro_torch.launch.train`` on non-dense families' smoke configs with a
failure and a restart, bit-identical to an uninterrupted run
(``tests/_train_families.py`` for the shared set-up)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _train_families as F
from repro.training import step as j_step
from repro_torch import configs as t_configs
from repro_torch.training import step as t_step


@pytest.mark.parametrize("arch", F.ARCHS)
def test_eval_step_matches(arch):
    jp, tp = F.weights(arch)
    b = F.batch(F.cfg(arch), 2, 32, seed=5)
    jm = j_step.make_eval_step(F.cfg(arch))(jp, F.to_j(b))
    tm = t_step.make_eval_step(F.tcfg(arch))(tp, F.to_t(b))
    for m in ("loss", "aux_loss", "tokens"):
        np.testing.assert_allclose(float(tm[m]), float(jm[m]), rtol=1e-5,
                                   err_msg=m)


@pytest.mark.parametrize("arch", F.ARCHS)
def test_train_cast_matches_the_reference(arch, monkeypatch):
    """The params the port's bf16 train step hands to ``loss_fn`` are
    bit-equal to those the reference's step hands to its own: every leaf
    of two or more dims in bf16 (the hybrid's stacked ``a_log`` and
    ``d_skip`` too, which the serving cast keeps in fp32), 1-D scales in
    fp32."""
    jp, tp = F.weights(arch)
    b = F.batch(F.cfg(arch), 2, 32, seed=8)
    seen_j, seen_t = {}, {}

    def j_spy(cfg, params, batch):
        jax.debug.callback(lambda p: seen_j.update(p), params)
        tot = sum(jnp.sum(v.astype(jnp.float32)) for v in params.values())
        z = jnp.float32(0)
        return tot, dict(loss=z, aux_loss=z, tokens=z)

    def t_spy(cfg, params, batch):
        seen_t.update({k: v.detach().clone() for k, v in params.items()})
        tot = sum(v.float().sum() for v in params.values())
        z = torch.zeros(())
        return tot, dict(loss=z, aux_loss=z, tokens=z)

    monkeypatch.setattr(j_step, "loss_fn", j_spy)
    monkeypatch.setattr(t_step, "loss_fn", t_spy)
    opt = F.j_probe()
    j_step.make_train_step(dataclasses.replace(F.cfg(arch),
                                               dtype="bfloat16"), opt)(
        jp, opt.init(jp), F.to_j(b))
    tcfg = dataclasses.replace(F.tcfg(arch), dtype="bfloat16")
    F.probe_grads(tcfg, tp, b)
    assert sorted(seen_t) == sorted(seen_j) == sorted(jp)
    for k, jv in seen_j.items():
        tv = seen_t[k]
        bf16 = tv.dim() >= 2
        assert tv.dtype == (torch.bfloat16 if bf16 else torch.float32), k
        assert str(jv.dtype) == ("bfloat16" if bf16 else "float32"), k
        ints = (torch.int16, np.int16) if bf16 else (torch.int32, np.int32)
        np.testing.assert_array_equal(tv.view(ints[0]).numpy(),
                                      np.asarray(jv).view(ints[1]),
                                      err_msg=k)
    if arch == "zamba2-7b":
        from repro_torch.models import model as TM
        served = TM.cast_params(tcfg, tp)
        for leaf in ("layers/mamba/a_log", "layers/mamba/d_skip"):
            assert seen_t[leaf].dtype == torch.bfloat16
            assert served[leaf].dtype == torch.float32


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "zamba2-7b"])
def test_launcher_restart_is_bit_identical(arch, tmp_path):
    """``repro_torch.launch.train`` on a non-dense family's smoke config:
    a failure after step 7, a restart from the step-5 checkpoint, and the
    final params and optimizer state bit-identical to an uninterrupted
    run (as ``tests/test_torch_checkpoint.py`` holds for dense)."""
    from repro_torch.checkpoint import restore
    from repro_torch.launch.train import train
    from repro_torch.models import model as TM
    from repro_torch.training.optimizer import AdamWState
    base = ["--arch", arch, "--smoke", "--steps", "10", "--batch", "2",
            "--seq", "32", "--ckpt-every", "5", "--lr", "1e-3"]
    r_fail = train(base + ["--ckpt-dir", str(tmp_path / "a"), "--fail-at",
                           "7"], device="cpu")
    r_ok = train(base + ["--ckpt-dir", str(tmp_path / "b")], device="cpu")
    assert r_fail["restarts"] == 1 and r_fail["starts"] == [0, 5]
    assert r_ok["restarts"] == 0 and r_ok["starts"] == [0]
    assert r_fail["loss"] == r_ok["loss"]
    names = dict.fromkeys(TM.param_specs(t_configs.get_smoke(arch)))
    tmpl = {"params": dict(names),
            "opt": AdamWState(step=None, mu=dict(names), nu=dict(names))}
    a, _ = restore(str(tmp_path / "a"), tmpl, device="cpu")
    b, _ = restore(str(tmp_path / "b"), tmpl, device="cpu")
    assert int(a["opt"].step) == int(b["opt"].step) == 10
    for k in names:
        assert torch.equal(a["params"][k], b["params"][k]), k
        assert torch.equal(a["opt"].mu[k], b["opt"].mu[k]), k
        assert torch.equal(a["opt"].nu[k], b["opt"].nu[k]), k
