"""The dry run (``launch/dryrun.py``, ``launch/hlo_stats.py``) and its
abstract inputs against the JAX package, on the CPU.

* ``input_specs`` / ``cache_len`` / ``round_up`` for every arch x shape,
  ``abstract_params`` and ``param_logical_axes`` for every arch, and
  ``context_specs`` / ``state_specs`` for ``cumbe``: the reference's
  shapes and dtypes (``meta`` tensors against ``ShapeDtypeStruct``s);
* ``make_production_mesh``: (16, 16) and (2, 16, 16);
* the cell list and ``--list`` against the reference's cells, built from
  ``repro.configs`` (importing ``repro.launch.dryrun`` would set
  ``XLA_FLAGS`` to 512 host devices for the rest of the process);
* the counter's FLOPs against the reference's ``module_stats`` of the
  compiled HLO: exactly, on every family's smoke prefill and decode on
  one device; on every family's train step exactly the reference's less
  the forward products its backward computes again (``PERF.md`` section
  6), within 3 % but for internvl2;
* a hand count on a (1, 2) mesh: one product, one elementwise op and one
  all-reduce;
* one device's share: under ``lead()`` device 0's FLOPs on a (1, 2) or
  (2, 1) mesh equal the one-device count of the same share (half the
  heads, ff columns and vocab; half the batch), for prefill, decode and
  the train step;
* a production cell and the ``cumbe`` cell through ``run_cell``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.launch.hlo_stats import module_stats as j_module_stats
from repro.models import layers as j_layers
from repro.models import model as JM
from repro.training.optimizer import adamw as j_adamw
from repro.training.step import make_prefill_step as j_prefill
from repro.training.step import make_serve_step as j_serve
from repro.training.step import make_train_step as j_train
from repro_torch import configs as t_configs
from repro_torch.launch import dryrun, hlo_stats
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import model as TM
from repro_torch.models.config import ShapeSpec
from repro_torch.models.layers import abstract_params
from repro_torch.sharding import axes as A
from repro_torch.sharding import collectives as C
from repro_torch.sharding.auto import make_rules
from repro_torch.training.optimizer import adamw
from repro_torch.training.step import (make_prefill_step, make_serve_step,
                                       make_train_step)

FAMILIES = ["qwen3-1.7b", "granite-moe-1b-a400m", "internvl2-2b",
            "musicgen-medium", "zamba2-7b", "xlstm-1.3b"]


def _same(t: torch.Tensor, j) -> None:
    assert t.device.type == "meta"
    assert tuple(t.shape) == tuple(j.shape)
    assert str(t.dtype).split(".")[-1] == str(jnp.dtype(j.dtype)), (
        t.dtype, j.dtype)


@pytest.mark.parametrize("arch", t_configs.ARCH_IDS)
def test_input_specs_equal_the_reference(arch):
    tcfg, jcfg = t_configs.get_config(arch), j_configs.get_config(arch)
    for name, shape in t_configs.SHAPES.items():
        jshape = j_configs.SHAPES[name]
        assert t_configs.cache_len(tcfg, shape) == \
            j_configs.cache_len(jcfg, jshape)
        t, j = t_configs.input_specs(tcfg, shape), \
            j_configs.input_specs(jcfg, jshape)
        assert set(t) == set(j)
        for k in t:
            if k == "cache":
                assert set(t[k]) == set(j[k])
                for c in t[k]:
                    _same(t[k][c], j[k][c])
            else:
                _same(t[k], j[k])
    for x, m in ((1, 1024), (1024, 1024), (1025, 1024), (7, 3)):
        assert t_configs.round_up(x, m) == j_configs.round_up(x, m)


@pytest.mark.parametrize("arch", t_configs.ARCH_IDS)
def test_abstract_params_equal_the_reference(arch):
    tcfg, jcfg = t_configs.get_config(arch), j_configs.get_config(arch)
    t = abstract_params(TM.param_specs(tcfg))
    j = j_layers.abstract_params(JM.param_specs(jcfg))
    assert set(t) == set(j)
    for k in t:
        _same(t[k], j[k])
    assert TM.param_logical_axes(tcfg) == JM.param_logical_axes(jcfg)


def test_context_and_state_specs_equal_the_reference():
    from repro.configs.cumbe import CONFIG as JW
    from repro.core import distributed as j_dd
    from repro_torch.configs.cumbe import CONFIG as TW
    from repro_torch.core import distributed as t_dd
    tcfg, jcfg = TW.engine_config(), JW.engine_config()
    for t, j in zip(t_dd.context_specs(tcfg), j_dd.context_specs(jcfg)):
        _same(t, j)
    ts, js = t_dd.state_specs(tcfg, 256), j_dd.state_specs(jcfg, 256)
    assert ts._fields == js._fields
    for t, j in zip(ts, js):
        _same(t, j)


def test_production_mesh():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert one.shape == {"data": 16, "model": 16} and one.size == 256
    assert two.shape == {"pod": 2, "data": 16, "model": 16}
    assert two.size == 512
    assert {d.type for d in one.devices + two.devices} == {"meta"}


def test_cell_list_equals_the_reference():
    want = [(a, s) for a in j_configs.ARCH_IDS for s in j_configs.SHAPES]
    want.append(("cumbe", "cumbe-16k"))
    assert dryrun.all_cells() == want
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert dryrun.main(["--list"]) == 0
    assert out.getvalue().splitlines() == [f"{a} x {s}" for a, s in want]


def _j_flops(fn, *args) -> float:
    return j_module_stats(jax.jit(fn).lower(*args).compile().as_text())[
        "flops"]


def _cell(arch, kind):
    jcfg, tcfg = j_configs.get_smoke(arch), t_configs.get_smoke(arch)
    shape = ShapeSpec("s", 64, 2, kind)
    return (jcfg, tcfg, j_layers.abstract_params(JM.param_specs(jcfg)),
            abstract_params(TM.param_specs(tcfg)),
            j_configs.input_specs(jcfg, shape),
            t_configs.input_specs(tcfg, shape))


def _flops(arch, kind) -> tuple[float, dict]:
    """The reference's ``module_stats`` FLOPs of a family's smoke cell at
    (B, S) = (2, 64) on one device, lowered and compiled as its dry run
    does, and the counter's stats of the port's step on the same
    shapes: prefill, decode or the AdamW train step."""
    jcfg, tcfg, jp, tp, jb, tb = _cell(arch, kind)
    if kind == "prefill":
        return (_j_flops(j_prefill(jcfg), jp, jb),
                hlo_stats.module_stats(make_prefill_step(tcfg), tp, tb))
    if kind == "decode":
        return (_j_flops(j_serve(jcfg), jp, jb["cache"], jb["tokens"],
                         jb["pos"]),
                hlo_stats.module_stats(make_serve_step(tcfg), tp, tb["cache"],
                                       tb["tokens"], tb["pos"]))
    opt, topt = j_adamw(total_steps=100), adamw(total_steps=100)
    return (_j_flops(j_train(jcfg, opt), jp, jax.eval_shape(opt.init, jp),
                     jb),
            hlo_stats.module_stats(make_train_step(tcfg, topt), tp,
                                   topt.init(tp), tb))


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_counter_flops_equal_module_stats(arch, kind):
    want, got = _flops(arch, kind)
    assert got["flops"] == want
    assert got["conv_flops"] == 0.0 and got["hbm_bytes"] > 0


# the products the reference's backward computes again and the port's
# autograd keeps: (count, FLOPs) pairs.  A 64-key chunk's Q K^T is
# 1,048,576 (internvl2's 72 keys pad to two chunks: 1,179,648); zamba2
# adds 819,200 of small SSD products.
RECOMPUTED = {"qwen3-1.7b": [(2, 1_048_576)],
              "granite-moe-1b-a400m": [(2, 1_048_576)],
              "internvl2-2b": [(4, 1_179_648)],
              "musicgen-medium": [(2, 1_048_576)],
              "zamba2-7b": [(2, 1_048_576), (1, 819_200)],
              "xlstm-1.3b": [(4, 1_048_576)]}


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_flops_within_three_percent(arch):
    """The train step with AdamW: the port counts exactly the
    reference's FLOPs less the products its backward computes again
    (``RECOMPUTED``, ``PERF.md`` section 6).  That is within 3 % for
    every family but internvl2 (4.255 %: its padded key chunks)."""
    want, got = _flops(arch, "train")
    gap = sum(n * f for n, f in RECOMPUTED[arch])
    assert want - got["flops"] == gap, (got["flops"], want)


def _meta_mesh(data, model):
    return Mesh([torch.device("meta")] * (data * model), ("data", "model"),
                (data, model))


def test_hand_count_on_a_two_device_mesh():
    """(1, 2): x (8, 16) @ w (16, 32) in fp32, times 2, all-reduced over
    model, device 0's share under ``lead()``."""
    mesh = _meta_mesh(1, 2)
    x = torch.empty(8, 16, device="meta")
    w = torch.empty(16, 32, device="meta")
    with A.lead(), hlo_stats.OpCounter() as c:
        y = A.each(mesh, lambda k: x @ w)
        z = A.each(mesh, lambda k: y[k] * 2)
        C.all_reduce(z, mesh, "model")
    s = c.stats()
    assert s["flops"] == 2 * 8 * 16 * 32
    out = 8 * 32 * 4
    assert s["hbm_bytes"] == (8 * 16 + 16 * 32) * 4 + out + (out + out)
    coll = s["collectives"]
    assert coll["all-reduce"] == out and coll["total"] == out
    assert coll["counts"] == {"all-reduce": 1}


def _share(cfg, m):
    """The config of one device's share at model=m: its heads, kv heads,
    ff columns and vocab columns."""
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // m,
                               n_kv=cfg.n_kv // m, d_ff=cfg.d_ff // m,
                               vocab=cfg.padded_vocab // m, head_dim=cfg.hd)


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("data,model", [(1, 2), (2, 1)])
def test_one_devices_share_equals_its_unsharded_count(kind, data, model):
    """qwen3 smoke: device 0's FLOPs counted under ``lead()`` on the
    mesh equal the one-device count of its share (a device counts its
    own products, once, and no other device's)."""
    cfg = t_configs.get_smoke("qwen3-1.7b")
    B = 4
    shape = ShapeSpec("s", 64, B, kind)
    fn, args, _, rules, _, _ = dryrun.build_lm_cell(
        "qwen3-1.7b", kind, False, mesh=_meta_mesh(data, model), cfg=cfg,
        shape=shape)
    got = dryrun.trace_cell(fn, args, rules)[0]["flops"]
    share = _share(cfg, model)
    one = ShapeSpec("s", 64, B // data, kind)
    fn, args, _, rules, _, _ = dryrun.build_lm_cell(
        "qwen3-1.7b", kind, False, mesh=_meta_mesh(1, 1), cfg=share,
        shape=one)
    assert got == dryrun.trace_cell(fn, args, rules)[0]["flops"]


def test_run_cell_records():
    rec = dryrun.run_cell("qwen3-1.7b", "decode_32k", False)
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rec["hlo_flops"] > 0 and rec["collectives"]["total"] > 0
    mem = rec["memory"]
    # the fp32 params' device-0 shards, the cache part, tokens and pos
    cfg = t_configs.get_config("qwen3-1.7b")
    mesh = make_production_mesh()
    rules = make_rules(cfg, mesh, t_configs.SHAPES["decode_32k"])
    params = sum(int(np.prod(TM._local_shape(
        A.named_sharding(s.logical, rules), s.shape, 0))) * 4
        for s in TM.param_specs(cfg).values())
    assert mem["argument_size_in_bytes"] > params
    assert mem["temp_size_in_bytes"] > 0
    mbe = dryrun.run_cell("cumbe", "cumbe-16k", True)
    assert mbe["status"] == "ok" and mbe["n_devices"] == 512
    # AND + popcount over 16,384 x 512 words
    assert mbe["hlo_flops"] == 2 * 16_384 * 512


if __name__ == "__main__":
    # every family's smoke cells, both packages' FLOPs:
    # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_dryrun.py
    for arch in FAMILIES:
        for kind in ("prefill", "decode", "train"):
            want, got = _flops(arch, kind)
            print(f"{arch:22s} {kind:8s} reference {want:14,.0f} port "
                  f"{got['flops']:14,.0f} gap "
                  f"{(want - got['flops']) / want:+.3%}")
