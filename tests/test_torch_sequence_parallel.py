"""Megatron sequence parallelism in the port (``act_seq`` on ``model``:
the residual stream split along the sequence between sub-blocks), on the
CPU, against the JAX package.

* the mesh forward's logits and the train step (loss, grad norm through
  the grad probe, every param's delta) for all six families on (1, 2),
  (2, 2) and (1, 4) meshes of CPU shards, remat on and off, against the
  reference's one-device forward and step on the same weights
  (``params_from_jax``), fp32 smoke configs, at ``test_torch_sharding``'s
  tolerances; and against the port's own step under the table with
  ``act_seq=None`` (the sequence whole);
* a sequence ``model`` does not divide (S=30 at model=4): ``make_rules``
  keeps it whole and the step is still the reference's; a table that
  splits it anyway raises (no fallback);
* the remat frames: recorded through ``models.model._remat``, every
  frame's residual-stream input is a device's ``S / m`` positions (whole
  under ``act_seq=None``), one input a member of its group;
* the collectives under ``lead()``: a hand count of a reduce-scatter and
  an all-gather (forward and backward) and of a prefill's collectives on
  a (1, 2) ``meta`` mesh; the qwen3 smoke train cell on a (1, 4) ``meta``
  mesh counts fewer temp bytes with the sequence split than without.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.models import layers as j_layers
from repro.models import model as JM
from repro.training import optimizer as j_opt
from repro.training.step import make_train_step as j_make_train_step
from repro_torch import configs as t_configs
from repro_torch.launch import dryrun, hlo_stats
from repro_torch.launch.mesh import Mesh, make_local_mesh
from repro_torch.models import model as TM
from repro_torch.models.config import ShapeSpec
from repro_torch.models.layers import gather_params
from repro_torch.models.weights import params_from_jax
from repro_torch.sharding import axes as A
from repro_torch.sharding import collectives as C
from repro_torch.sharding.auto import make_rules
from repro_torch.training import optimizer as t_opt
from repro_torch.training.step import make_train_step

FAMILIES = ["qwen3-1.7b", "granite-moe-1b-a400m", "internvl2-2b",
            "musicgen-medium", "zamba2-7b", "xlstm-1.3b"]
MESHES = [(1, 2), (2, 2), (1, 4)]
B = 4
S = 32
LOSS_TOL, RTOL, ATOL = 1e-3, 1e-3, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small operators a device: one intra-op thread runs them
    faster than the default pool beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _batch(cfg, seq):
    rng = np.random.default_rng(seq)
    cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    toks = rng.integers(0, cfg.vocab, (B, seq) + cb).astype(np.int32)
    batch = dict(tokens=toks, labels=toks)
    if cfg.family == "vlm":
        batch["patch_emb"] = rng.normal(
            size=(B, cfg.patch_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _smoke(configs, arch, remat, seq):
    """The family's fp32 smoke config; the moe family's capacity groups
    of 8 tokens where its 64 do not divide the batch's (S=30)."""
    cfg = configs.get_smoke(arch)
    kw = dict(dtype="float32", remat=remat)
    if cfg.family == "moe" and B * seq % cfg.moe_group:
        kw["moe_group"] = 8
    return dataclasses.replace(cfg, **kw)


@functools.lru_cache(maxsize=None)
def _reference(arch, remat, seq=S):
    """The reference's weights, batch, forward logits, and its train
    step's loss, grad norm and param deltas (one device, fp32)."""
    jcfg = _smoke(j_configs, arch, remat, seq)
    jp = j_layers.init_params(JM.param_specs(jcfg), jax.random.key(0))
    np_p = {k: np.asarray(v) for k, v in jp.items()}
    batch = _batch(jcfg, seq)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits = jax.jit(lambda p, b: JM.forward(
        jcfg, p, b["tokens"], patch_emb=b.get("patch_emb"))[0])(jp, jb)
    pr, _, mr = jax.jit(j_make_train_step(jcfg, _grad_probe_j()))(
        dict(jp), jnp.int32(0), jb)
    deltas = {k: np.asarray(pr[k], np.float32) - np_p[k] for k in np_p}
    return dict(params=np_p, batch=batch, logits=np.asarray(logits),
                loss=float(mr["loss"]), grad_norm=float(mr["grad_norm"]),
                deltas=deltas)


def _rules(cfg, mesh_shape, seq, table=None):
    mesh = make_local_mesh(mesh_shape[1], device="cpu",
                           shards=mesh_shape[0] * mesh_shape[1])
    rules = make_rules(cfg, mesh, ShapeSpec("t", seq, B, "train"))
    if table:
        rules = A.Rules(mesh=mesh, table=dict(rules.table, **table))
    return rules


@functools.lru_cache(maxsize=None)
def _port(arch, mesh_shape, remat, seq=S, whole=False):
    """The port's forward logits and train step on the mesh under
    ``make_rules``' table (``whole``: with ``act_seq=None``), on the
    reference's weights and batch."""
    ref = _reference(arch, remat, seq)
    cfg = _smoke(t_configs, arch, remat, seq)
    rules = _rules(cfg, mesh_shape, seq,
                   dict(act_seq=None) if whole else None)
    sp = params_from_jax(ref["params"], device="cpu",
                         specs=TM.param_specs(cfg), rules=rules)
    tb = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    step = make_train_step(cfg, _grad_probe_t())
    with A.use_rules(rules):
        with torch.no_grad():
            logits = TM.forward(cfg, sp, tb["tokens"],
                                patch_emb=tb.get("patch_emb"))[0]
        ps, _, ms = step(sp, torch.zeros((), dtype=torch.int32), tb)
    ps = gather_params(ps)
    deltas = {k: ps[k].numpy() - ref["params"][k] for k in ref["params"]}
    return dict(rules=rules, logits=logits.numpy(), loss=float(ms["loss"]),
                grad_norm=float(ms["grad_norm"]), deltas=deltas)


def _assert_close(got, want, what):
    assert abs(got["loss"] - want["loss"]) < LOSS_TOL, what
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=RTOL, atol=ATOL, err_msg=what)
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=RTOL,
                               atol=ATOL, err_msg=f"{what} logits")
    for k, want_d in want["deltas"].items():
        np.testing.assert_allclose(got["deltas"][k], want_d, rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what} {k}")


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off",
                                                      "remat_on"])
@pytest.mark.parametrize("mesh_shape", MESHES,
                         ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", FAMILIES)
def test_split_sequence_matches_the_reference(arch, mesh_shape, remat):
    got = _port(arch, mesh_shape, remat)
    assert got["rules"].table["act_seq"] == ("model",)
    _assert_close(got, _reference(arch, remat), f"{arch} {mesh_shape}")


@pytest.mark.parametrize("mesh_shape", MESHES,
                         ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", FAMILIES)
def test_split_sequence_equals_the_whole_sequence_table(arch, mesh_shape):
    """The same step and forward under the table with ``act_seq=None``
    (every device holds its batch rows' whole residual stream)."""
    _assert_close(_port(arch, mesh_shape, True),
                  _port(arch, mesh_shape, True, whole=True),
                  f"{arch} {mesh_shape} split vs whole")


@pytest.mark.parametrize("arch", FAMILIES)
def test_undivided_sequence_runs_whole(arch):
    """S=30 at model=4 (the vlm family's 8 patch rows make 38): the
    table keeps the sequence whole, and the step is the reference's."""
    got = _port(arch, (1, 4), False, seq=30)
    assert got["rules"].table["act_seq"] is None
    _assert_close(got, _reference(arch, False, 30), f"{arch} S=30")


@pytest.mark.parametrize("arch", FAMILIES)
def test_a_split_the_sequence_cannot_take_raises(arch):
    """A table that splits S=30 over model=4 anyway: no fallback."""
    cfg = _smoke(t_configs, arch, False, 30)
    ref = _reference(arch, False, 30)
    rules = _rules(cfg, (1, 4), 30, dict(act_seq=("model",)))
    sp = params_from_jax(ref["params"], device="cpu",
                         specs=TM.param_specs(cfg), rules=rules)
    tb = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    with A.use_rules(rules), torch.no_grad(), \
            pytest.raises(ValueError, match="does not divide"):
        TM.forward(cfg, sp, tb["tokens"], patch_emb=tb.get("patch_emb"))


# sub-blocks whose frame gathers the sequence, per family (smoke
# configs): two a layer; zamba2: 5 Mamba2 layers and 2 uses of the
# shared block's two; xlstm: 2 mLSTM blocks and 2 sLSTM blocks' two
# (the cells and, at model=4 wider than its 2 heads, the FFN over its
# own shard of y)
GATHERED_FRAMES = {"qwen3-1.7b": 4, "granite-moe-1b-a400m": 4,
                   "internvl2-2b": 4, "musicgen-medium": 4,
                   "zamba2-7b": 9, "xlstm-1.3b": 6}


@pytest.mark.parametrize("whole", [False, True],
                         ids=["split", "act_seq_none"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_frames_save_a_devices_shard(arch, whole, monkeypatch):
    """A train step with remat on a (1, 4) mesh, every frame's tensor
    inputs recorded through ``_remat``: each residual-stream input (a
    device's batch rows x positions x d_model) holds S / 4 positions, one
    from each member of the device's group, and no frame takes the whole
    sequence; under ``act_seq=None`` each such frame takes the device's
    whole sequence, once."""
    cfg = _smoke(t_configs, arch, True, S)
    ref = _reference(arch, True)
    rules = _rules(cfg, (1, 4), S, dict(act_seq=None) if whole else None)
    sp = params_from_jax(ref["params"], device="cpu",
                         specs=TM.param_specs(cfg), rules=rules)
    tb = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    frames = []
    real = TM._remat

    def rec(cfg_, fn, k, *args):
        frames.append([tuple(a.shape) for a in args
                       if isinstance(a, torch.Tensor)])
        return real(cfg_, fn, k, *args)
    monkeypatch.setattr(TM, "_remat", rec)
    with A.use_rules(rules):
        make_train_step(cfg, _grad_probe_t())(
            sp, torch.zeros((), dtype=torch.int32), tb)
    S_all = S + (cfg.patch_tokens if cfg.family == "vlm" else 0)
    positions = S_all if whole else S_all // 4
    residual = [[s for s in f if len(s) == 3 and s[0] == B
                 and s[2] == cfg.d_model] for f in frames]
    residual = [f for f in residual if f]
    assert len(residual) == GATHERED_FRAMES[arch] * 4, len(residual)
    for f in residual:
        assert f == [(B, positions, cfg.d_model)] * (1 if whole else 4), f


def _meta_mesh(data, model):
    return Mesh([torch.device("meta")] * (data * model), ("data", "model"),
                (data, model))


def test_hand_count_of_reduce_scatter_and_all_gather():
    """(1, 2), device 0's share under ``lead()``: a (2, 8, 16) fp32
    partial sum reduce-scattered along dim 1, then all-gathered back,
    and the backward of both: each collective once a way, its operand
    bytes (the reduce-scatter's whole part, the all-gather's shard) and
    the bytes it reads and writes."""
    mesh = _meta_mesh(1, 2)
    x = torch.empty(2, 8, 16, device="meta", requires_grad=True)
    whole, half = 2 * 8 * 16 * 4, 2 * 4 * 16 * 4
    with A.lead(), hlo_stats.OpCounter() as c:
        rs = C.reduce_scatter([x, x], mesh, "model", dim=1)
        assert tuple(rs[0].shape) == (2, 4, 16) and rs[1] is rs[0]
        ag = C.all_gather(rs, mesh, "model", dim=1)
        assert tuple(ag[0].shape) == (2, 8, 16)
        one = C.gather_one(rs[:2], mesh, 0, "model", 1)
        assert tuple(one.shape) == (2, 8, 16)
    s = c.stats()
    coll = s["collectives"]
    assert coll["counts"] == {"reduce-scatter": 1, "all-gather": 2}
    assert coll["reduce-scatter"] == whole
    assert coll["all-gather"] == 2 * half
    assert s["hbm_bytes"] == (whole + half) + 2 * (half + whole)
    with A.lead(), hlo_stats.OpCounter() as c:
        ag[0].sum().backward()
    coll = c.stats()["collectives"]
    # the all-gather's backward is a reduce-scatter, the reduce-scatter's
    # an all-gather
    assert coll["counts"] == {"reduce-scatter": 1, "all-gather": 1}
    assert coll["reduce-scatter"] == whole and coll["all-gather"] == half
    assert tuple(x.grad.shape) == (2, 8, 16)


def test_hand_count_of_a_prefill():
    """qwen3 smoke prefill (2, 64) on a (1, 2) ``meta`` mesh, device 0
    under ``lead()`` (serve rules: no FSDP gather): the embedding and
    each of the 2L sub-blocks reduce-scatter a (2, 64, d) partial sum,
    each sub-block all-gathers its (2, 32, d) shard, the head takes the
    last position from device 1 (one row, a collective-permute); nothing
    is all-reduced."""
    cfg = t_configs.get_smoke("qwen3-1.7b")
    L, d = cfg.n_layers, cfg.d_model
    w = torch.empty((), dtype=TM.dtype_of(cfg)).element_size()
    fn, args, _, rules, _, _ = dryrun.build_lm_cell(
        "qwen3-1.7b", "prefill", False, mesh=_meta_mesh(1, 2), cfg=cfg,
        shape=ShapeSpec("s", 64, 2, "prefill"))
    assert rules.table["act_seq"] == ("model",)
    coll = dryrun.trace_cell(fn, args, rules)[0]["collectives"]
    assert coll["counts"] == {"reduce-scatter": 1 + 2 * L,
                              "all-gather": 2 * L,
                              "collective-permute": 1}
    # the embedding's lookups in the table's dtype (the fp32 masters),
    # the sub-blocks' outputs in the config's
    assert coll["reduce-scatter"] == 2 * 64 * d * (4 + 2 * L * w)
    assert coll["all-gather"] == 2 * L * 2 * 32 * d * w
    assert coll["collective-permute"] == 2 * 1 * d * w
    assert coll["all-reduce"] == 0


def test_split_sequence_lowers_the_train_cells_temp_bytes():
    """The qwen3 smoke train cell (remat on, (4, 256)) on a (1, 4)
    ``meta`` mesh: device 0's temp bytes with the sequence split are
    fewer than under ``act_seq=None``, its FLOPs the same."""
    cfg = dataclasses.replace(t_configs.get_smoke("qwen3-1.7b"), remat=True)
    fn, args, _, rules, _, _ = dryrun.build_lm_cell(
        "qwen3-1.7b", "train", False, mesh=_meta_mesh(1, 4), cfg=cfg,
        shape=ShapeSpec("s", 256, 4, "train"))
    split = dryrun.trace_cell(fn, args, rules)[0]
    whole = dryrun.trace_cell(fn, args, A.Rules(
        mesh=rules.mesh, table=dict(rules.table, act_seq=None)))[0]
    assert split["peak_bytes"] < whole["peak_bytes"], (
        split["peak_bytes"], whole["peak_bytes"])
    assert split["flops"] == whole["flops"]
