"""The LM on a mesh against the JAX package (``src/repro/sharding``,
``launch/mesh.py``, the sharded models and train step), on the CPU.

Twin of ``tests/test_sharding.py``:

* the rule tables: for every architecture, for the train and serve
  shapes, on meshes (1,1) .. (16,16), the port's ``make_rules`` table
  and ``rules_report`` equal the reference's (``make_rules`` reads only
  ``mesh.shape``, so a stand-in object carries it); no spec breaks
  divisibility or names a mesh axis twice; ``spec_for`` raises on an
  unknown axis;
* a train step on a 2 x 2 mesh of CPU shards (the hybrid and ssm
  families also on (2, 1) and (1, 2), and with remat on (2, 2)), fp32,
  against the reference's one-device step on the same weights
  (``params_from_jax``): the loss within 1e-3 and, through the
  grad-probe optimizer, every grad and the global grad norm within rtol
  1e-3 / atol 1e-5; two AdamW steps the same way (params, both moments
  and the clipped grad norm);
* the collectives and their backward, the mesh helpers, decode with the
  KV cache's sequence split (3 slots on ``data=2``) against one device,
  prefill logits under both tables, and the served loop on a mesh token
  for token;
* the hybrid and ssm families' model axis: the shapes every device reads
  from each split leaf (never a whole ``p_inner`` leaf).
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
from repro.sharding import auto as j_auto
from repro.training import optimizer as j_opt
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
from repro_torch.sharding import collectives as C
from repro_torch.sharding.auto import make_rules, rules_report
from repro_torch.training import optimizer as t_opt
from repro_torch.training.step import make_train_step

MESHES = [(1, 1), (1, 2), (2, 2), (1, 4), (4, 1), (2, 4), (16, 16)]


class _FakeMesh:
    """Only ``.shape`` is read by either package's ``make_rules``."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


def _j_cfg(arch):
    return j_configs.get_config(arch)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", t_configs.ARCH_IDS)
def test_rule_tables_equal_the_reference(arch, mesh):
    fake = _FakeMesh({"data": mesh[0], "model": mesh[1]})
    tcfg, jcfg = t_configs.get_config(arch), _j_cfg(arch)
    for shape in SHAPES.values():
        tr = make_rules(tcfg, fake, shape)
        jr = j_auto.make_rules(jcfg, fake, j_configs.SHAPES[shape.name])
        assert tr.table == jr.table, (arch, mesh, shape.name)
        assert rules_report(tcfg, tr) == j_auto.rules_report(jcfg, jr)
        for slots in (1, 3, 4):              # the served loop's shapes
            s = ShapeSpec("serve", 128, slots, "decode")
            assert make_rules(tcfg, fake, s).table == j_auto.make_rules(
                jcfg, fake, s).table


def _axes(entry):
    return () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))


@pytest.mark.parametrize("arch", t_configs.ARCH_IDS)
def test_specs_divide_and_use_no_axis_twice(arch):
    """Every sharded dim of every param / cache spec divides its axes on
    the 16 x 16 mesh, and no spec names a mesh axis twice (multi-pod)."""
    cfg = t_configs.get_config(arch)
    for multi_pod in (False, True):
        shape = {"pod": 2, "data": 16, "model": 16} if multi_pod \
            else {"data": 16, "model": 16}
        fake = _FakeMesh(shape)
        for sp in SHAPES.values():
            rules = make_rules(cfg, fake, sp, multi_pod=multi_pod)
            lgs = [s.logical for s in TM.param_specs(cfg).values()]
            lgs += list(TM.cache_logical_axes(cfg).values())
            for lg in lgs:
                used = [a for e in A.spec_for(lg, rules) for a in _axes(e)]
                assert len(used) == len(set(used)), (arch, sp.name, lg)
            if multi_pod:
                continue
            for k, s in TM.param_specs(cfg).items():
                for dim, e in zip(s.shape, A.spec_for(s.logical, rules)):
                    n = int(np.prod([shape[a] for a in _axes(e)]))
                    assert dim % n == 0, (arch, sp.name, k, dim, e)


def test_spec_for_requires_known_axis():
    r = A.Rules(table={"x": ("data",)})
    with pytest.raises(KeyError):
        A.spec_for(("y",), r)
    assert A.spec_for(("x", None), r) == (("data",), None)
    mesh = make_local_mesh(2, device="cpu", shards=4)
    with pytest.raises(ValueError, match="twice"):
        A.NamedSharding(mesh, (("data",), ("data", "model")))


def test_local_mesh_and_its_groups():
    m = make_local_mesh(2, device="cpu", shards=4)
    assert m.shape == {"data": 2, "model": 2} and m.size == 4
    assert make_local_mesh(3, device="cpu").shape == {"data": 1, "model": 3}
    assert [m.coords(k) for k in range(4)] == [
        {"data": 0, "model": 0}, {"data": 0, "model": 1},
        {"data": 1, "model": 0}, {"data": 1, "model": 1}]
    assert m.group(3, "model") == [2, 3] and m.group(1, "data") == [1, 3]
    assert m.group(0, ("data", "model")) == [0, 1, 2, 3]
    assert m.take("data", 1).devices == m.devices[2:]
    with pytest.raises(ValueError, match="does not divide"):
        make_local_mesh(3, device="cpu", shards=4)
    with pytest.raises(ValueError, match="does not divide"):
        make_local_mesh(2, device="cpu", shards=1)


def test_shards_round_trip_and_gather():
    mesh = make_local_mesh(2, device="cpu", shards=4)
    x = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    sh = A.NamedSharding(mesh, (None, ("data",), ("model",)))
    s = sh.shard(x)
    assert len(s.parts) == 4 and s.parts[3].shape == (4, 3, 4)
    assert torch.equal(s.full(), x)
    # device (1, 0) gathers dim 1 over data: its model half, whole rows
    assert torch.equal(s.local(2, gather=("data",)), x[:, :, :4])
    assert torch.equal(s.local(3), x[:, 3:, 4:])
    layers = s.unbind0()
    assert torch.equal(layers[2].full(), x[2])
    rep = A.NamedSharding(mesh, (None, None, ("model",))).shard(x)
    assert len(rep.parts) == 2          # one shard a model index, not four
    pl = rep.place()
    assert pl.local(0) is pl.local(2)   # the CPU's replicas share a tensor
    assert torch.equal(pl.unbind0()[1].local(3), x[1, :, 4:])


def test_collectives_and_their_backward():
    mesh = make_local_mesh(2, device="cpu", shards=4)
    rng = np.random.default_rng(0)
    xs = [torch.tensor(rng.normal(size=(4, 6)), requires_grad=True)
          for _ in range(4)]
    red = C.all_reduce(xs, mesh, "model")
    gat = C.all_gather(xs, mesh, "data", dim=1)
    rs = C.reduce_scatter(xs, mesh, "model", dim=0)
    v = [x.detach().numpy() for x in xs]
    np.testing.assert_allclose(red[3].detach().numpy(), v[2] + v[3])
    np.testing.assert_array_equal(gat[1].detach().numpy(),
                                  np.concatenate([v[1], v[3]], 1))
    np.testing.assert_allclose(rs[1].detach().numpy(),
                               (v[0] + v[1])[2:])
    # the all-gather's backward is the reduce-scatter of the grads
    gs = [torch.tensor(rng.normal(size=(4, 12))) for _ in range(4)]
    torch.autograd.backward(gat, gs)
    np.testing.assert_allclose(xs[1].grad.numpy(),
                               (gs[1] + gs[3])[:, :6].numpy())
    assert C.all_reduce(xs, mesh.take("model", 0), "model")[0] is xs[0]


def _grad_probe_t():
    return t_opt.Optimizer(
        init=lambda p: torch.zeros((), dtype=torch.int32),
        update=lambda g, s, p: (g, s, dict(lr=torch.zeros(()),
                                           grad_norm=t_opt.global_norm(g))))


def _grad_probe_j():
    return j_opt.Optimizer(
        init=lambda p: jnp.int32(0),
        update=lambda g, s, p: (g, s, dict(lr=jnp.float32(0),
                                           grad_norm=j_opt.global_norm(g))))


STEP_CASES = [("qwen3-1.7b", (2, 2), False), ("qwen3-1.7b", (2, 2), True),
              ("granite-moe-1b-a400m", (2, 2), True),
              ("internvl2-2b", (2, 2), False),
              ("musicgen-medium", (2, 2), False),
              ("zamba2-7b", (2, 1), False), ("xlstm-1.3b", (2, 1), False),
              ("zamba2-7b", (1, 2), False), ("xlstm-1.3b", (1, 2), False),
              ("zamba2-7b", (2, 2), True), ("xlstm-1.3b", (2, 2), True)]


@pytest.mark.parametrize("arch,mesh_shape,remat", STEP_CASES)
def test_sharded_train_step_matches_the_reference(arch, mesh_shape, remat):
    """(remat: each device's attention / FFN share under its own
    checkpoint, the full configs' setting.)"""
    jcfg = dataclasses.replace(j_configs.get_smoke(arch), dtype="float32",
                               remat=remat)
    tcfg = dataclasses.replace(t_configs.get_smoke(arch), dtype="float32",
                               remat=remat)
    jp = j_layers.init_params(JM.param_specs(jcfg), jax.random.key(0))
    rng = np.random.default_rng(0)
    cb = (jcfg.n_codebooks,) if jcfg.n_codebooks else ()
    toks = rng.integers(0, jcfg.vocab, (4, 32) + cb).astype(np.int32)
    batch = dict(tokens=toks, labels=toks)
    if jcfg.family == "vlm":
        batch["patch_emb"] = rng.normal(
            size=(4, jcfg.patch_tokens, jcfg.d_model)).astype(np.float32)
    jstep = jax.jit(j_make_train_step(jcfg, _grad_probe_j()))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pr, _, mr = jstep(dict(jp), jnp.int32(0), jb)

    mesh = make_local_mesh(mesh_shape[1], device="cpu",
                           shards=mesh_shape[0] * mesh_shape[1])
    rules = make_rules(tcfg, mesh, ShapeSpec("t", 32, 4, "train"))
    np_p = {k: np.asarray(v) for k, v in jp.items()}
    sp = params_from_jax(np_p, device="cpu", specs=TM.param_specs(tcfg),
                         rules=rules)
    assert all(isinstance(v, A.Shards) for v in sp.values())
    step = make_train_step(tcfg, _grad_probe_t())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with A.use_rules(rules):
        ps, _, ms = step(sp, torch.zeros((), dtype=torch.int32), tb)
    assert abs(float(ms["loss"]) - float(mr["loss"])) < 1e-3
    # every element once: a replicated leaf counted once, not once a copy
    np.testing.assert_allclose(float(ms["grad_norm"]),
                               float(mr["grad_norm"]), rtol=1e-3, atol=1e-5)
    ps = gather_params(ps)
    for k in np_p:
        gr = np.asarray(pr[k], np.float32) - np_p[k]
        gs = ps[k].numpy() - np_p[k]
        np.testing.assert_allclose(gs, gr, rtol=1e-3, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-1b-a400m",
                                  "zamba2-7b", "xlstm-1.3b"])
def test_sharded_adamw_matches_the_reference(arch):
    """Two AdamW steps on a 2 x 2 mesh of CPU shards (global norm,
    clipping and the moments a shard on its device; FSDP over data and
    TP over model) against the reference's one-device steps on the same
    weights and batches: the loss and grad norm of each step, then every
    param, and both moments in a grad's units (bias-corrected: m / c1
    and sqrt(v / c2)) at the grads' limits."""
    jcfg = dataclasses.replace(j_configs.get_smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(t_configs.get_smoke(arch), dtype="float32")
    jp = j_layers.init_params(JM.param_specs(jcfg), jax.random.key(0))
    np_p = {k: np.asarray(v) for k, v in jp.items()}
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, jcfg.vocab, (4, 32)).astype(np.int32)
               for _ in range(2)]
    kw = dict(warmup=1, total_steps=4, max_grad_norm=0.5)
    jopt = j_opt.adamw(**kw)
    jstep = jax.jit(j_make_train_step(jcfg, jopt))
    jps, jst = dict(jp), jopt.init(jp)
    mesh = make_local_mesh(2, device="cpu", shards=4)
    rules = make_rules(tcfg, mesh, ShapeSpec("t", 32, 4, "train"))
    sp = params_from_jax(np_p, device="cpu", specs=TM.param_specs(tcfg),
                         rules=rules)
    topt = t_opt.adamw(**kw)
    tstep = make_train_step(tcfg, topt)
    tst = topt.init(sp)
    for toks in batches:
        jps, jst, mr = jstep(jps, jst, dict(tokens=jnp.asarray(toks),
                                            labels=jnp.asarray(toks)))
        t = torch.from_numpy(toks)
        with A.use_rules(rules):
            sp, tst, ms = tstep(sp, tst, dict(tokens=t, labels=t))
        assert abs(float(ms["loss"]) - float(mr["loss"])) < 1e-3
        assert float(mr["grad_norm"]) > kw["max_grad_norm"]   # clipped
        np.testing.assert_allclose(float(ms["grad_norm"]),
                                   float(mr["grad_norm"]), rtol=1e-3,
                                   atol=1e-5)
    assert int(tst.step) == 2
    c1, c2 = 1 - 0.9 ** 2, 1 - 0.95 ** 2      # adamw's b1, b2 at step 2
    for name, got, want, f in (
            ("param", sp, jps, lambda x: x),
            ("mu", tst.mu, jst.mu, lambda x: x / c1),
            ("nu", tst.nu, jst.nu, lambda x: np.sqrt(x / c2))):
        got = gather_params(got)
        for k in np_p:
            np.testing.assert_allclose(
                f(got[k].numpy()), f(np.asarray(want[k], np.float32)),
                rtol=1e-3, atol=1e-5, err_msg=f"{name} {k}")


def _fp32(arch):
    return dataclasses.replace(t_configs.get_smoke(arch), dtype="float32")


def test_decode_with_the_cache_sequence_split():
    """3 slots do not divide data=2: ``serve_rules`` puts the cache's
    sequence over every axis (flash-decode); each device attends over
    its chunk and the chunks merge by logsumexp."""
    cfg = _fp32("qwen3-1.7b")
    specs = TM.param_specs(cfg)
    p = init_params(specs, 0, device="cpu")
    mesh = make_local_mesh(1, device="cpu", shards=2)
    rules = make_rules(cfg, mesh, ShapeSpec("serve", 12, 3, "decode"))
    assert rules.table["cache_seq"] == ("data", "model")
    assert rules.table["cache_batch"] is None
    sp = shard_params(p, specs, rules)
    toks = torch.randint(0, cfg.vocab, (3, 10),
                         generator=torch.Generator().manual_seed(1))
    plain = TM.init_cache(cfg, 3, 12, device="cpu")
    with A.use_rules(rules):
        split = TM.init_cache(cfg, 3, 12, device="cpu")
    assert split["k"][0].shape[2] == 6
    for i in range(10):
        pos = torch.tensor([i, max(i - 1, 0), min(i + 2, 11)])
        want, _ = TM.decode_step(cfg, p, plain, toks[:, i], pos)
        with A.use_rules(rules):
            got, _ = TM.decode_step(cfg, sp, split, toks[:, i], pos)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("arch,mesh_shape,slots", [
    ("qwen3-1.7b", (1, 2), 2), ("qwen3-1.7b", (2, 2), 3),
    ("granite-moe-1b-a400m", (1, 2), 2), ("musicgen-medium", (2, 2), 2),
    ("xlstm-1.3b", (2, 1), 2), ("zamba2-7b", (1, 2), 2),
    ("zamba2-7b", (2, 2), 2), ("xlstm-1.3b", (1, 2), 2),
    ("xlstm-1.3b", (2, 2), 2)])
def test_served_loop_on_a_mesh_equals_one_device(arch, mesh_shape, slots):
    cfg = _fp32(arch)
    specs = TM.param_specs(cfg)
    p = init_params(specs, 0, device="cpu")
    rng = np.random.default_rng(0)
    cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    prompts = [rng.integers(0, cfg.vocab, (4,) + cb).astype(np.int32)
               for _ in range(5)]
    want = serve_lm(cfg, p, prompts, slots=slots, max_new=5, max_seq=12)
    mesh = make_local_mesh(mesh_shape[1], device="cpu",
                           shards=mesh_shape[0] * mesh_shape[1])
    rules = make_rules(cfg, mesh, ShapeSpec("serve", 12, slots, "decode"))
    with A.use_rules(rules):
        got = serve_lm(cfg, shard_params(p, specs, rules), prompts,
                       slots=slots, max_new=5, max_seq=12)
    assert got["outputs"] == want["outputs"]
    assert got["steps"] == want["steps"]


def test_forward_logits_on_a_mesh_equal_one_device():
    """prefill logits (``attn_impl="pallas"``: K7's plain version on the
    CPU) on a 2 x 2 mesh under both tables, moe aux included."""
    for arch in ("qwen3-1.7b", "granite-moe-1b-a400m"):
        cfg = dataclasses.replace(_fp32(arch), attn_impl="pallas")
        specs = TM.param_specs(cfg)
        p = init_params(specs, 0, device="cpu")
        toks = torch.randint(0, cfg.vocab, (4, 32),
                             generator=torch.Generator().manual_seed(2))
        want, aw = TM.forward(cfg, p, toks)
        mesh = make_local_mesh(2, device="cpu", shards=4)
        for kind in ("train", "serve"):
            rules = make_rules(cfg, mesh, ShapeSpec("t", 32, 4, kind))
            with A.use_rules(rules):
                got, ag = TM.forward(cfg, shard_params(p, specs, rules),
                                     toks, last_only=kind == "serve")
            np.testing.assert_allclose(
                got.numpy(), want[:, -got.shape[1]:].numpy(), rtol=1e-5,
                atol=1e-5)
            np.testing.assert_allclose(float(ag), float(aw), rtol=1e-6)


@pytest.mark.parametrize("kind", ["train", "serve"])
@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-1.3b"])
def test_hybrid_and_ssm_logits_on_a_mesh_equal_one_device(arch, kind):
    """prefill logits on a 2 x 2 mesh (a device runs its SSM / xLSTM
    heads; zamba2's shared block with ``attn_impl="pallas"``: K7's plain
    version on the CPU) against the same forward on one device, on the
    reference's weights (``params_from_jax``; the one-device forward is
    held against the reference's by ``test_torch_families.py``)."""
    cfg = dataclasses.replace(_fp32(arch), attn_impl="pallas")
    jcfg = dataclasses.replace(j_configs.get_smoke(arch), dtype="float32")
    np_p = {k: np.asarray(v) for k, v in j_layers.init_params(
        JM.param_specs(jcfg), jax.random.key(0)).items()}
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab, (4, 32)))
    want, _ = TM.forward(cfg, params_from_jax(np_p, device="cpu"), toks)
    mesh = make_local_mesh(2, device="cpu", shards=4)
    rules = make_rules(cfg, mesh, ShapeSpec("t", 32, 4, kind))
    sp = params_from_jax(np_p, device="cpu", specs=TM.param_specs(cfg),
                         rules=rules)
    with A.use_rules(rules):
        got, _ = TM.forward(cfg, sp, toks, last_only=kind == "serve")
    np.testing.assert_allclose(got.numpy(), want[:, -got.shape[1]:].numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 2)])
def test_hybrid_decode_with_the_cache_sequence_split(mesh_shape):
    """zamba2: 3 slots do not divide data=2, so the shared block's 2 KV
    caches split over their sequence on every axis (flash-decode) while
    the Mamba2 layers run their heads over ``model``; 10 steps' logits
    against one device."""
    cfg = _fp32("zamba2-7b")
    specs = TM.param_specs(cfg)
    p = init_params(specs, 0, device="cpu")
    mesh = make_local_mesh(mesh_shape[1], device="cpu",
                           shards=mesh_shape[0] * mesh_shape[1])
    rules = make_rules(cfg, mesh, ShapeSpec("serve", 12, 3, "decode"))
    assert rules.table["cache_seq"] == ("data", "model")
    sp = shard_params(p, specs, rules)
    toks = torch.randint(0, cfg.vocab, (3, 10),
                         generator=torch.Generator().manual_seed(1))
    plain = TM.init_cache(cfg, 3, 12, device="cpu")
    with A.use_rules(rules):
        split = TM.init_cache(cfg, 3, 12, device="cpu")
    assert split["k"][0].shape[2] == 12 // mesh.size
    for i in range(10):
        pos = torch.tensor([i, max(i - 1, 0), min(i + 2, 11)])
        want, _ = TM.decode_step(cfg, p, plain, toks[:, i], pos)
        with A.use_rules(rules):
            got, _ = TM.decode_step(cfg, sp, split, toks[:, i], pos)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)


def _whole_cache(cfg, parts: list, name: str, shape, rules) -> np.ndarray:
    """A cache leaf laid out a part a device (``mesh_cache_axes``),
    assembled whole."""
    sh = A.named_sharding(TM.mesh_cache_axes(cfg)[name], rules)
    out = np.zeros(shape, dtype=np.float32)
    for k, part in enumerate(parts):
        out[sh.slices(shape, rules.mesh.coords(k))] = part.float().numpy()
    return out


@pytest.mark.parametrize("arch,mesh_shape,slots", [
    ("zamba2-7b", (1, 2), 2), ("zamba2-7b", (2, 2), 3),
    ("xlstm-1.3b", (1, 2), 2), ("xlstm-1.3b", (2, 2), 2)])
def test_hybrid_and_ssm_decode_on_a_mesh_match_the_reference(
        arch, mesh_shape, slots):
    """Eight decode steps from a zero cache on a mesh against the
    reference's ``decode_step`` on one device, fp32, the reference's
    weights (``params_from_jax``): the logits and every cache leaf
    assembled whole (zamba2's Mamba2 conv cache taken and put back over
    its flat split; with 3 slots on data=2 its KV caches split over
    their sequence, flash-decode; the xLSTM's state laid out over its
    heads) within 1e-4, the one-device port's beside them."""
    cfg = _fp32(arch)
    jcfg = dataclasses.replace(j_configs.get_smoke(arch), dtype="float32")
    np_p = {k: np.asarray(v) for k, v in j_layers.init_params(
        JM.param_specs(jcfg), jax.random.key(0)).items()}
    mesh = make_local_mesh(mesh_shape[1], device="cpu",
                           shards=mesh_shape[0] * mesh_shape[1])
    rules = make_rules(cfg, mesh, ShapeSpec("serve", 12, slots, "decode"))
    assert "model" in _axes(rules.table["p_inner"])
    if slots == 3:
        assert rules.table["cache_seq"] == ("data", "model")
    sp = params_from_jax(np_p, device="cpu", specs=TM.param_specs(cfg),
                         rules=rules)
    tp = params_from_jax(np_p, device="cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (slots, 8))
    jc = JM.init_cache(jcfg, slots, 12)
    plain = TM.init_cache(cfg, slots, 12, device="cpu")
    with A.use_rules(rules):
        split = TM.init_cache(cfg, slots, 12, device="cpu")
    dec = jax.jit(lambda p, c, t, i: JM.decode_step(jcfg, p, c, t, i))
    tol = dict(rtol=1e-4, atol=1e-4)
    for i in range(8):
        jl, jc = dec(np_p, jc, jnp.asarray(toks[:, i]), jnp.int32(i))
        t = torch.from_numpy(toks[:, i])
        one, plain = TM.decode_step(cfg, tp, plain, t, i)
        with A.use_rules(rules):
            got, split = TM.decode_step(cfg, sp, split, t, i)
        want = np.asarray(jl, dtype=np.float32)
        np.testing.assert_allclose(one.numpy(), want, **tol)
        np.testing.assert_allclose(got.numpy(), want, **tol,
                                   err_msg=f"logits at step {i}")
        for name in jc:
            np.testing.assert_allclose(
                _whole_cache(cfg, split[name], name, jc[name].shape, rules),
                np.asarray(jc[name], dtype=np.float32), **tol,
                err_msg=f"{name} at step {i}")


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-1.3b"])
def test_no_device_reads_a_whole_split_leaf(arch, monkeypatch):
    """Every read of a split leaf in a train step (remat on, its backward
    included) and in the served loop on a 2 x 2 mesh, recorded as the
    shape each device gets from ``Shards.local`` / ``Shards.take``: a
    stacked leaf is read a layer at a time (the served loop's ``place``
    copies each device its own shards once), and no device gets the whole
    of a layer's leaf that is split over ``model`` (a ``p_inner``
    projection gets its heads' columns, an mLSTM block its heads' P x P
    blocks), while each ``p_inner`` leaf is read."""
    from repro_torch.training.step import loss_fn
    cfg = dataclasses.replace(_fp32(arch), remat=True)
    specs = TM.param_specs(cfg)
    p = init_params(specs, 0, device="cpu")
    mesh = make_local_mesh(2, device="cpu", shards=4)
    reads, owner, placing = [], {}, []

    def recorder(real):
        def rec(self, k, *a, **kw):
            out = real(self, k, *a, **kw)
            name = owner.get(self.parts[0].untyped_storage().data_ptr())
            reads.append((name, self.shape, self.sharding.spec,
                          tuple(out.shape), bool(placing)))
            return out
        return rec

    def place(self, *a, **kw):      # the served loop's placement, once
        placing.append(1)
        try:
            return real_place(self, *a, **kw)
        finally:
            placing.pop()
    real_place = A.Shards.place
    monkeypatch.setattr(A.Shards, "local", recorder(A.Shards.local))
    monkeypatch.setattr(A.Shards, "take", recorder(A.Shards.take))
    monkeypatch.setattr(A.Shards, "place", place)
    toks = torch.randint(0, cfg.vocab, (4, 32),
                         generator=torch.Generator().manual_seed(0))
    prompts = [t.numpy().astype(np.int32) for t in toks[:, :4]]
    for kind in ("train", "serve"):
        rules = make_rules(cfg, mesh, ShapeSpec("t", 32, 4, kind))
        sp = shard_params(p, specs, rules)
        owner.update({q.untyped_storage().data_ptr(): name
                      for name, leaf in sp.items() for q in leaf.parts})
        with A.use_rules(rules):
            if kind == "train":
                loss_fn(cfg, {k: v.like([q.requires_grad_(True)
                                         for q in v.parts])
                              for k, v in sp.items()},
                        dict(tokens=toks, labels=toks))[0].backward()
            else:
                serve_lm(cfg, sp, prompts, slots=2, max_new=3, max_seq=8)
    inner = {k for k, s in specs.items() if "p_inner" in s.logical}
    assert inner <= {r[0] for r in reads}
    for name, shape, spec, got, placed in reads:
        assert name is not None
        whole = specs[name].shape
        assert placed or len(shape) == len(whole) - (
            name.split("/")[0] in ("layers", "mblocks", "sblocks")), name
        if any("model" in _axes(e) for e in spec):
            assert np.prod(got) < np.prod(shape), (name, spec, got)


def test_mesh_of_one_device_is_the_plain_path():
    mesh = Mesh(["cpu"], ("data", "model"), (1, 1))
    cfg = _fp32("qwen3-1.7b")
    rules = make_rules(cfg, mesh, ShapeSpec("t", 32, 4, "train"))
    with A.use_rules(rules):
        assert A.mesh_rules() is None
        x = torch.ones(4, 8)
        assert A.constrain(x, "act_batch", "act_seq") is x


def test_serve_cli_model_parallel_equals_one_device(monkeypatch):
    """``serve --model-parallel 2`` on two CPU shards gives the tokens of
    ``--model-parallel 1``, the smoke config in fp32 (bf16 partial sums
    round in another order, so a near-tie may part)."""
    from repro_torch.launch.serve import serve
    fp32 = {a: _fp32(a) for a in ("qwen3-1.7b",)}
    monkeypatch.setattr(t_configs, "get_smoke", lambda a: fp32[a])
    argv = ["--arch", "qwen3-1.7b", "--smoke", "--requests", "3",
            "--slots", "2", "--prompt-len", "4", "--max-new", "4"]
    one = serve(argv, device="cpu")
    two = serve(argv + ["--model-parallel", "2"], device="cpu")
    assert one["mesh"] == {"data": 1, "model": 1}
    assert two["mesh"] == {"data": 1, "model": 2}
    assert two["outputs"] == one["outputs"] and two["tokens"] == 12
