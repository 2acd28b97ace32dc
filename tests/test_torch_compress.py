"""int8 error-feedback gradient compression over a mesh axis against the
JAX package (``src/repro/training/compress.py``), on the CPU.

Twin of ``tests/test_training.py::test_compression_error_feedback_
converges``:

* one participant: 50 steps of ``quantized_psum`` equal the reference's
  ``shard_map``'d calls, outputs and residuals bit for bit.  The
  reference runs as written, not under ``jax.jit``: XLA's CPU compiler
  rewrites its ``amax / 127`` and contracts ``g - codes * scale`` into a
  fused multiply-add, roundings that neither package's source makes (a
  jitted scale is one ulp off the written one at some steps);
* four participants on CPU shards: the mean equals a NumPy all-gather of
  the int8 codes and scales, dequantized and averaged in participant
  order, and every participant holds the same bits;
* ``make_train_step(compress_axis="data")`` on a (2, 1) mesh: each
  participant keeps its own residual, the copies stay bit-identical, and
  the running sum of the compressed mean grads tracks the exact one
  within the reference test's bound; the same on a (2, 2) mesh for the
  hybrid and ssm families, each participant split over ``model``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core.distributed import shard_map_compat
from repro.training.compress import quantized_psum as j_psum
from repro_torch import configs
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import model as TM
from repro_torch.models.config import ShapeSpec
from repro_torch.models.layers import gather_params, init_params
from repro_torch.sharding.auto import make_rules
from repro_torch.sharding.axes import use_rules
from repro_torch.training import optimizer as t_opt
from repro_torch.training.compress import (_quantize, init_error_state,
                                           quantized_psum)
from repro_torch.training.step import make_train_step, replicate


def test_one_participant_matches_the_reference_bit_for_bit():
    rng = np.random.default_rng(1)
    gs = [rng.normal(size=(64,)).astype(np.float32) for _ in range(50)]
    run = shard_map_compat(
        lambda g, e: j_psum({"g": g}, "x", {"g": e}),
        mesh=jax.make_mesh((1,), ("x",)), in_specs=(P(), P()),
        out_specs=(P(), P()))
    je = jnp.zeros((64,))
    te = [{"g": torch.zeros(64)}]
    acc_c, acc_t = np.zeros(64), np.zeros(64)
    for g in gs:
        jr, jn = run(jnp.asarray(g), je)
        je = jn["g"]
        tr, te = quantized_psum([{"g": torch.from_numpy(g)}], "x", te)
        np.testing.assert_array_equal(tr[0]["g"].numpy(),
                                      np.asarray(jr["g"]))
        np.testing.assert_array_equal(te[0]["g"].numpy(), np.asarray(je))
        acc_c += tr[0]["g"].numpy()
        acc_t += g
    assert np.abs(acc_c - acc_t).max() < 0.05 * np.abs(acc_t).max() + 0.2


def test_four_participants_equal_numpy_all_gather_and_mean():
    mesh = make_local_mesh(1, device="cpu", shards=4)
    rng = np.random.default_rng(3)
    grads, errs = [], []
    for i, dev in enumerate(mesh.devices):
        grads.append({"a": torch.from_numpy(rng.normal(size=(5, 7)) * (i + 1))
                      .float().to(dev),
                      "b": torch.from_numpy(rng.normal(size=(3,)))
                      .float().to(dev)})
        errs.append({k: torch.from_numpy(rng.normal(size=v.shape) * 1e-3)
                     .float() for k, v in grads[-1].items()})
    red, new = quantized_psum(grads, "data", errs)
    for k in ("a", "b"):
        codes, scales = [], []
        for i in range(4):
            g = grads[i][k].numpy() + errs[i][k].numpy()
            c, s = (t.numpy() for t in _quantize(torch.from_numpy(g)))
            assert c.dtype == np.int8
            codes.append(c)
            scales.append(np.float32(s))
            np.testing.assert_array_equal(
                new[i][k].numpy(), g - c.astype(np.float32) * scales[-1])
        stack = np.stack(codes).astype(np.float32) \
            * np.array(scales, np.float32).reshape((-1,) + (1,) * g.ndim)
        want = np.sum(stack, axis=0) / np.float32(4)
        for i in range(4):
            np.testing.assert_array_equal(red[i][k].numpy(), want)


def _probe():
    return t_opt.Optimizer(
        init=lambda p: torch.zeros((), dtype=torch.int32),
        update=lambda g, s, p: (g, s, dict(lr=torch.zeros(()),
                                           grad_norm=t_opt.global_norm(g))))


def test_compressed_train_step_on_a_data_mesh():
    cfg = dataclasses.replace(configs.get_smoke("qwen3-1.7b"),
                              dtype="float32")
    specs = TM.param_specs(cfg)
    p = init_params(specs, 0, device="cpu")
    mesh = make_local_mesh(1, device="cpu", shards=2)
    rules = make_rules(cfg, mesh, ShapeSpec("t", 16, 4, "train"))
    opt = _probe()
    step = make_train_step(cfg, opt, compress_axis="data")
    plain = make_train_step(cfg, opt)
    reps = replicate(p, specs, rules, "data")
    err = [init_error_state(x) for x in reps]
    gen = torch.Generator().manual_seed(0)
    acc_c = {k: torch.zeros_like(v) for k, v in p.items()}
    acc_t = {k: torch.zeros_like(v) for k, v in p.items()}
    for _ in range(12):
        toks = torch.randint(0, cfg.vocab, (4, 16), generator=gen)
        batch = dict(tokens=toks, labels=toks)
        with use_rules(rules):
            out, _, m, err = step(reps, [opt.init(x) for x in reps], batch,
                                  err)
        assert bool(torch.isfinite(m["loss"]))
        for k in p:
            assert torch.equal(out[0][k], out[1][k]), k
            acc_c[k] += out[0][k] - p[k]
        for half in (slice(0, 2), slice(2, 4)):
            q, _, _ = plain(dict(p), opt.init(p),
                            {n: v[half] for n, v in batch.items()})
            for k in p:
                acc_t[k] += (q[k] - p[k]) / 2
    assert not all(torch.equal(e0, e1) for e0, e1 in zip(
        err[0].values(), err[1].values()))       # each its own residual
    for k in p:
        d = (acc_c[k] - acc_t[k]).abs().max()
        assert d < 0.05 * acc_t[k].abs().max() + 0.2, k


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-1.3b"])
def test_compressed_step_with_the_model_axis(arch):
    """``compress_axis="data"`` on a 2 x 2 mesh for the hybrid and ssm
    families: each participant a (1, 2) sub-mesh whose leaves split over
    ``model`` (a device its SSM / xLSTM heads); the copies of every leaf
    stay bit-identical and the running sum of the compressed mean grads
    tracks the exact one within the bound of the data-mesh test."""
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype="float32")
    specs = TM.param_specs(cfg)
    p = init_params(specs, 0, device="cpu")
    mesh = make_local_mesh(2, device="cpu", shards=4)
    rules = make_rules(cfg, mesh, ShapeSpec("t", 16, 4, "train"))
    opt = _probe()
    step = make_train_step(cfg, opt, compress_axis="data")
    plain = make_train_step(cfg, opt)
    reps = replicate(p, specs, rules, "data")
    err = [init_error_state(x) for x in reps]
    gen = torch.Generator().manual_seed(0)
    acc_c = {k: torch.zeros_like(v) for k, v in p.items()}
    acc_t = {k: torch.zeros_like(v) for k, v in p.items()}
    for _ in range(3):
        toks = torch.randint(0, cfg.vocab, (4, 16), generator=gen)
        batch = dict(tokens=toks, labels=toks)
        with use_rules(rules):
            out, _, m, err = step(reps, [opt.init(x) for x in reps], batch,
                                  err)
        assert bool(torch.isfinite(m["loss"]))
        out = [gather_params(o) for o in out]
        for k in p:
            assert torch.equal(out[0][k], out[1][k]), k
            acc_c[k] += out[0][k] - p[k]
        for half in (slice(0, 2), slice(2, 4)):
            q, _, _ = plain(dict(p), opt.init(p),
                            {n: v[half] for n, v in batch.items()})
            for k in p:
                acc_t[k] += (q[k] - p[k]) / 2
    for k in p:
        d = (acc_c[k] - acc_t[k]).abs().max()
        assert d < 0.05 * acc_t[k].abs().max() + 0.2, k
