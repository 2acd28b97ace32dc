"""The model axis wider than the heads, on the CPU.

The reference's ``make_rules`` keeps ``p_heads`` / ``p_kv`` / ``p_inner``
on ``model`` whatever the heads and drops ``act_heads`` / ``act_kv``
where the axis does not divide them; GSPMD then gathers or replicates
what a device needs.  The port runs each such table
(``models/model.py`` ``_attn_plan`` / ``_inner``):

* the kv heads do not divide ``model`` (qwen3 smoke's 2 at model=4): a
  device runs its q heads and takes the kv heads they read;
* the q heads do not divide it (4 at model=8, musicgen smoke's 4): every
  device runs every head, its rows of ``wo``;
* xlstm smoke's 2 heads at model=4 or 8 (ROADMAP item 12f): a device
  runs its rows of P in every head, the reference's split.

Each against one device (fp32 smoke configs, 1e-5): prefill logits under
both tables, decode with every cache leaf, the served loop token for
token, the grads and one AdamW step; the train step against the
reference's for three of them; and, for every architecture and shape,
the plans of the production meshes (16 x 16, 2 x 16 x 16) raise
nothing.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import layers as j_layers
from repro.models import model as JM
from repro.training.step import make_train_step as j_make_train_step
from repro_torch import configs as t_configs
from repro_torch.launch.mesh import Mesh, make_local_mesh
from repro_torch.launch.serve import serve_lm
from repro_torch.models import model as TM
from repro_torch.models.config import SHAPES, ShapeSpec
from repro_torch.models.layers import (gather_params, init_params,
                                       shard_params)
from repro_torch.models.weights import params_from_jax
from repro_torch.sharding import axes as A
from repro_torch.sharding.auto import make_rules
from repro_torch.training import optimizer as t_opt
from repro_torch.training.step import loss_fn, make_train_step

TOL = dict(rtol=1e-5, atol=1e-5)

# (arch, (data, model), the attention plan's mode or the xLSTM's split)
CASES = [("qwen3-1.7b", (1, 4), "kv"), ("qwen3-1.7b", (2, 4), "kv"),
         ("qwen3-1.7b", (1, 8), "all"), ("musicgen-medium", (1, 8), "all"),
         ("granite-moe-1b-a400m", (1, 4), "kv"),
         ("xlstm-1.3b", (1, 4), "rows"), ("xlstm-1.3b", (2, 4), "rows"),
         ("xlstm-1.3b", (1, 8), "rows")]
IDS = [f"{a}-{d}x{m}" for a, (d, m), _ in CASES]
# the served loop once a mode: the slot bookkeeping it adds to the decode
# steps that every case runs is the same on every mesh
SERVE = [1, 3, 6]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The cases are many small operators a device; one intra-op thread
    runs them about 3x faster than the default pool beside the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, **kw):
    return dataclasses.replace(t_configs.get_smoke(arch), dtype="float32",
                               **kw)


def _mesh(shape):
    return make_local_mesh(shape[1], device="cpu", shards=shape[0] * shape[1])


def _tokens(cfg, shape, seed):
    cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    return torch.randint(0, cfg.vocab, shape + cb,
                         generator=torch.Generator().manual_seed(seed))


def _mode(cfg, rules):
    if cfg.family == "ssm":
        return "rows" if TM._inner(cfg, rules)[1] == 0 else "heads"
    return TM._attn_plan(cfg, rules).mode


def _meta_mesh(multi_pod):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh([torch.device("meta")] * int(np.prod(shape)), axes, shape)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod1", "pod2"])
@pytest.mark.parametrize("arch", t_configs.ARCH_IDS)
def test_production_mesh_plans_raise_nothing(arch, multi_pod):
    """Every architecture, every shape, on the 256- and 512-device
    meshes: the attention plan, the inner split and the cache layout are
    defined, and every device's share of the heads or rows is whole."""
    cfg = t_configs.get_config(arch)
    mesh = _meta_mesh(multi_pod)
    for shape in SHAPES.values():
        rules = make_rules(cfg, mesh, shape, multi_pod=multi_pod)
        if cfg.family == "ssm":
            ax, hl = TM._inner(cfg, rules)
            assert hl or (cfg.mlstm_proj * cfg.d_model // cfg.n_heads) \
                % mesh.shape_of(ax) == 0
        else:
            plan = TM._attn_plan(cfg, rules)
            assert plan.m == 16
            for c in range(plan.m):
                h0, h1 = plan.heads(c)
                kv = plan.kv_of(cfg, c)
                assert len(kv) == plan.lc.n_kv and h1 - h0 == plan.lc.n_heads
                G = plan.lc.n_heads // plan.lc.n_kv
                assert all(kv[(h - h0) // G] == h // (cfg.n_heads // cfg.n_kv)
                           for h in range(h0, h1))
            if cfg.family == "hybrid":
                TM._inner(cfg, rules)
        if shape.kind == "decode":
            axes = TM.mesh_cache_axes(cfg, rules)
            for name, (shp, _) in TM.cache_specs(
                    cfg, shape.global_batch,
                    t_configs.cache_len(cfg, shape)).items():
                A.named_sharding(axes[name], rules).slices(
                    shp, mesh.coords(mesh.size - 1))


@pytest.mark.parametrize("arch,mesh_shape,mode", CASES, ids=IDS)
def test_wide_prefill_logits_equal_one_device(arch, mesh_shape, mode):
    """prefill logits (``attn_impl="pallas"``: K7's plain version on the
    CPU, on each device's heads) under both tables."""
    cfg = _cfg(arch, attn_impl="pallas")
    specs = TM.param_specs(cfg)
    p = init_params(specs, 0, device="cpu")
    toks = _tokens(cfg, (4, 32), 2)
    want, aw = TM.forward(cfg, p, toks)
    mesh = _mesh(mesh_shape)
    for kind in ("train", "serve"):
        rules = make_rules(cfg, mesh, ShapeSpec("t", 32, 4, kind))
        assert _mode(cfg, rules) == mode
        with A.use_rules(rules):
            got, ag = TM.forward(cfg, shard_params(p, specs, rules), toks,
                                 last_only=kind == "serve")
        np.testing.assert_allclose(got.numpy(),
                                   want[:, -got.shape[1]:].numpy(), **TOL)
        np.testing.assert_allclose(float(ag), float(aw), rtol=1e-6)


def _whole(parts, axes, rules, shape):
    sh = A.named_sharding(axes, rules)
    out = torch.zeros(shape)
    for k, part in enumerate(parts):
        out[sh.slices(shape, rules.mesh.coords(k))] = part.float()
    return out


@pytest.mark.parametrize("arch,mesh_shape,mode", CASES, ids=IDS)
def test_wide_decode_equals_one_device(arch, mesh_shape, mode):
    """Eight decode steps from a zero cache: the logits and every cache
    leaf assembled whole (``mesh_cache_axes``; with 3 slots the KV cache
    splits over its sequence on every axis)."""
    cfg = _cfg(arch)
    specs = TM.param_specs(cfg)
    p = init_params(specs, 0, device="cpu")
    slots = 3 if mesh_shape[0] > 1 else 2
    mesh = _mesh(mesh_shape)
    rules = make_rules(cfg, mesh, ShapeSpec("serve", 16, slots, "decode"))
    assert _mode(cfg, rules) == mode
    sp = shard_params(p, specs, rules)
    toks = _tokens(cfg, (slots, 8), 1)
    plain = TM.init_cache(cfg, slots, 16, device="cpu")
    with A.use_rules(rules):
        split = TM.init_cache(cfg, slots, 16, device="cpu")
    axes = TM.mesh_cache_axes(cfg, rules)
    for i in range(8):
        pos = torch.tensor([i, max(i - 1, 0), min(i + 2, 15)][:slots])
        want, _ = TM.decode_step(cfg, p, plain, toks[:, i], pos)
        with A.use_rules(rules):
            got, _ = TM.decode_step(cfg, sp, split, toks[:, i], pos)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL,
                                   err_msg=f"logits at step {i}")
        for name in plain:
            np.testing.assert_allclose(
                _whole(split[name], axes[name], rules,
                       plain[name].shape).numpy(),
                plain[name].float().numpy(), **TOL,
                err_msg=f"{name} at step {i}")


@pytest.mark.parametrize("arch,mesh_shape,mode", [CASES[i] for i in SERVE],
                         ids=[IDS[i] for i in SERVE])
def test_wide_served_loop_equals_one_device(arch, mesh_shape, mode):
    cfg = _cfg(arch)
    specs = TM.param_specs(cfg)
    p = init_params(specs, 0, device="cpu")
    rng = np.random.default_rng(0)
    cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    prompts = [rng.integers(0, cfg.vocab, (4,) + cb).astype(np.int32)
               for _ in range(5)]
    slots = 2
    want = serve_lm(cfg, p, prompts, slots=slots, max_new=5, max_seq=16)
    mesh = _mesh(mesh_shape)
    rules = make_rules(cfg, mesh, ShapeSpec("serve", 16, slots, "decode"))
    with A.use_rules(rules):
        got = serve_lm(cfg, shard_params(p, specs, rules), prompts,
                       slots=slots, max_new=5, max_seq=16)
    assert got["outputs"] == want["outputs"]
    assert got["steps"] == want["steps"]


@pytest.mark.parametrize("arch,mesh_shape,mode", CASES, ids=IDS)
def test_wide_grads_and_adamw_equal_one_device(arch, mesh_shape, mode):
    """The loss and every grad leaf (remat on: each device's share under
    its own checkpoint) and one AdamW step's params and moments on the
    mesh, FSDP over data, against one device."""
    cfg = _cfg(arch, remat=True)
    specs = TM.param_specs(cfg)
    p = init_params(specs, 0, device="cpu")
    toks = _tokens(cfg, (4, 32), 3)
    batch = dict(tokens=toks, labels=toks)
    mesh = _mesh(mesh_shape)
    rules = make_rules(cfg, mesh, ShapeSpec("t", 32, 4, "train"))
    assert _mode(cfg, rules) == mode
    one = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    l1 = loss_fn(cfg, one, batch)[0]
    l1.backward()
    sp = {k: v.like([q.requires_grad_(True) for q in v.parts])
          for k, v in shard_params(p, specs, rules).items()}
    with A.use_rules(rules):
        l2 = loss_fn(cfg, sp, batch)[0]
    l2.backward()
    np.testing.assert_allclose(float(l2.detach()), float(l1.detach()), **TOL)
    for k in p:
        g = sp[k].like([q.grad for q in sp[k].parts]).full()
        np.testing.assert_allclose(g.numpy(), one[k].grad.numpy(), **TOL,
                                   err_msg=k)
    kw = dict(warmup=1, total_steps=4, max_grad_norm=0.5)
    opt = t_opt.adamw(**kw)
    step = make_train_step(cfg, opt)
    p1, s1, m1 = step(p, opt.init(p), batch)
    sp = shard_params(p, specs, rules)
    with A.use_rules(rules):
        p2, s2, m2 = step(sp, opt.init(sp), batch)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), **TOL)
    # the moments in a grad's units (nu: its square root) at the limits
    # of test_torch_sharding.py's AdamW test; the params there too where
    # the grad is well above AdamW's eps (1e-8): a first step moves a
    # weight by ~lr * g / (|g| + eps), so a grad of ~1e-8 (the sLSTM's
    # ``down`` has some) turns on its last bits, and there only the
    # bound of a step, 2 lr, holds
    lr = float(m1["lr"])
    assert lr > 0
    for name, got, want, f in (("param", p2, p1, lambda x: x),
                               ("mu", s2.mu, s1.mu, lambda x: x),
                               ("nu", s2.nu, s1.nu, np.sqrt)):
        got = gather_params(got)
        for k in p:
            a, b = f(got[k].numpy()), f(want[k].numpy())
            sure = np.abs(one[k].grad.numpy()) > 1e-6
            if name == "param":
                assert np.all(np.abs(a - b) <= 2 * lr), k
                a, b = a[sure], b[sure]
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5,
                                       err_msg=f"{name} {k}")


def _grad_probe(mod, zeros, norm):
    return mod.Optimizer(
        init=lambda p: zeros(),
        update=lambda g, s, p: (g, s, dict(lr=zeros(), grad_norm=norm(g))))


@pytest.mark.parametrize("arch,mesh_shape", [
    ("xlstm-1.3b", (1, 4)), ("qwen3-1.7b", (1, 8)),
    ("musicgen-medium", (2, 4))])
def test_wide_train_step_matches_the_reference(arch, mesh_shape):
    """The train step on the wide mesh against the reference's
    one-device step on the same weights (``params_from_jax``), through
    the grad-probe optimizer: the loss within 1e-3 and every grad within
    rtol 1e-3 / atol 1e-5, as ``test_torch_sharding.py`` holds the
    narrow meshes."""
    from repro.training import optimizer as j_opt
    jcfg = dataclasses.replace(j_configs.get_smoke(arch), dtype="float32")
    tcfg = _cfg(arch)
    jp = j_layers.init_params(JM.param_specs(jcfg), jax.random.key(0))
    toks = np.asarray(_tokens(tcfg, (4, 32), 4), dtype=np.int32)
    jstep = jax.jit(j_make_train_step(jcfg, _grad_probe(
        j_opt, lambda: jnp.int32(0), j_opt.global_norm)))
    pr, _, mr = jstep(dict(jp), jnp.int32(0),
                      dict(tokens=jnp.asarray(toks), labels=jnp.asarray(toks)))
    np_p = {k: np.asarray(v) for k, v in jp.items()}
    mesh = _mesh(mesh_shape)
    rules = make_rules(tcfg, mesh, ShapeSpec("t", 32, 4, "train"))
    sp = params_from_jax(np_p, device="cpu", specs=TM.param_specs(tcfg),
                         rules=rules)
    step = make_train_step(tcfg, _grad_probe(
        t_opt, lambda: torch.zeros((), dtype=torch.int32), t_opt.global_norm))
    tb = torch.from_numpy(toks)
    with A.use_rules(rules):
        ps, _, ms = step(sp, torch.zeros((), dtype=torch.int32),
                         dict(tokens=tb, labels=tb))
    assert abs(float(ms["loss"]) - float(mr["loss"])) < 1e-3
    ps = gather_params(ps)
    for k in np_p:
        np.testing.assert_allclose(
            ps[k].numpy() - np_p[k], np.asarray(pr[k], np.float32) - np_p[k],
            rtol=1e-3, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("arch,model,smoke", [("xlstm-1.3b", 8, False),
                                              ("xlstm-1.3b", 4, True)])
def test_xlstm_on_a_model_axis_wider_than_its_heads(arch, model, smoke):
    """xlstm-1.3b's 4 heads at model=8 (its smoke config's 2 at model=4),
    where the port raised before item 12f: ``make_rules`` keeps
    ``p_inner`` on ``model``, and a device now holds the reference's
    layout of the state, its P / model rows of ``mC`` / ``mn`` in every
    head (the full config's cache on ``meta``: no allocation); the smoke
    config's forward equals one device's."""
    cfg = _cfg(arch) if smoke else t_configs.get_config(arch)
    mesh = (_mesh((1, model)) if smoke else
            Mesh([torch.device("meta")] * model, ("data", "model"),
                 (1, model)))
    rules = make_rules(cfg, mesh, ShapeSpec("t", 32, 4, "serve"))
    assert "model" in A._axes_of(rules.table["p_inner"])
    assert cfg.n_heads % model and TM._inner(cfg, rules)[1] == 0
    P = cfg.mlstm_proj * cfg.d_model // cfg.n_heads
    with A.use_rules(rules):
        cache = TM.init_cache(cfg, 4, 32, device="cpu")
    n_m = cfg.n_layers - cfg.n_layers // cfg.slstm_every
    assert cache["mC"][0].shape == (n_m, 4, cfg.n_heads, P // model, P)
    assert cache["mm"][0].shape == (n_m, 4, cfg.n_heads)
    if smoke:
        specs = TM.param_specs(cfg)
        p = init_params(specs, 0, device="cpu")
        toks = _tokens(cfg, (4, 32), 5)
        want, _ = TM.forward(cfg, p, toks)
        with A.use_rules(rules):
            got, _ = TM.forward(cfg, shard_params(p, specs, rules), toks)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
