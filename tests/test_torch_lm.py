"""The port's LM serving path (``repro_torch.models``, ``training.step``,
``launch.serve``) against the JAX package's, on the qwen3 smoke config in
fp32: the same weights (the JAX package's ``init_params``, carried across
with ``params_from_jax``) and the same numpy-seeded tokens through both.

Tolerances: fp32 1e-5 abs/rel on logits (the same arithmetic, summed in
another order); tokens and the served streams exactly; the layers at
1e-6.  The JAX side runs its Pallas kernel in interpret mode
(``model.py`` does so off the TPU)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AxisType

from repro import configs as j_configs
from repro.launch import serve as j_serve
from repro.models import layers as j_layers
from repro.models import model as JM
from repro.training.step import make_prefill_step as j_prefill_step
from repro.training.step import make_serve_step as j_serve_step
from repro_torch import configs as t_configs
from repro_torch.checkpoint import restore
from repro_torch.launch.serve import serve, serve_lm
from repro_torch.launch.train import train
from repro_torch.models import layers as t_layers
from repro_torch.models import model as TM
from repro_torch.models.weights import params_from_jax
from repro_torch.training.step import make_prefill_step, make_serve_step

ARCH = "qwen3-1.7b"


def _cfg(**kw):
    return dataclasses.replace(j_configs.get_smoke(ARCH), dtype="float32",
                               **kw)


def _tcfg(**kw):
    return dataclasses.replace(t_configs.get_smoke(ARCH), dtype="float32",
                               **kw)


@pytest.fixture(scope="module")
def weights():
    """JAX params of the smoke config and the same weights in the port."""
    jp = j_layers.init_params(JM.param_specs(_cfg()), jax.random.key(0))
    return jp, params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                               device="cpu")


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, S),
                                                dtype=np.int32)


def _np(x):
    return np.asarray(x, np.float32)


def test_configs_match_the_reference():
    for arch in j_configs.ARCH_IDS:
        assert t_configs.get_config(arch) .__dict__ == \
            j_configs.get_config(arch).__dict__
        assert t_configs.get_smoke(arch).__dict__ == \
            j_configs.get_smoke(arch).__dict__
    assert t_configs.ARCH_IDS == j_configs.ARCH_IDS
    for name in j_configs.ARCH_IDS:       # every family's param table
        assert t_configs.get_config(name).n_params() == \
            j_configs.get_config(name).n_params()
    assert t_configs.SHAPES == {k: t_configs.ShapeSpec(*dataclasses.astuple(v))
                                for k, v in j_configs.SHAPES.items()}
    assert dataclasses.asdict(t_configs.get_config("cumbe")) == \
        dataclasses.asdict(j_configs.get_config("cumbe"))


def test_param_specs_match_the_reference():
    cfg = _cfg()
    js, ts = JM.param_specs(cfg), TM.param_specs(_tcfg())
    assert sorted(js) == sorted(ts)
    for k in js:
        assert (js[k].shape, js[k].logical, js[k].init, js[k].scale) == \
            (ts[k].shape, ts[k].logical, ts[k].init, ts[k].scale)


def test_init_params_shapes_and_distribution():
    specs = TM.param_specs(_tcfg())
    p = t_layers.init_params(specs, 3, device="cpu")
    q = t_layers.init_params(specs, 3, device="cpu")
    assert list(p) == sorted(specs)
    for k, s in specs.items():
        assert p[k].shape == s.shape and p[k].dtype == torch.float32
        assert torch.equal(p[k], q[k])           # seeded
    assert torch.equal(p["layers/attn/norm"], torch.ones(2, 64))
    w = p["layers/mlp/w1"]                       # std = 1 / sqrt(fan_in)
    assert abs(float(w.std()) * 64 ** 0.5 - 1.0) < 0.05


def test_params_from_jax_round_trip(weights):
    jp, tp = weights
    assert sorted(jp) == sorted(tp)
    for k in jp:
        assert tp[k].dtype == torch.float32 and tuple(tp[k].shape) == \
            jp[k].shape
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    bf = {"w": np.asarray(jnp.asarray([[1.5, -2.25]], jnp.bfloat16))}
    got = params_from_jax(bf, device="cpu")["w"]
    assert got.dtype == torch.bfloat16
    assert got.float().tolist() == [[1.5, -2.25]]


@pytest.mark.parametrize("shape", [(2, 5, 4, 16), (3, 4, 8), (7, 32)])
def test_rms_norm_matches(shape):
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    s = rng.normal(size=shape[-1:]).astype(np.float32)
    want = j_layers.rms_norm(jnp.asarray(x), jnp.asarray(s))
    got = t_layers.rms_norm(torch.from_numpy(x), torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6, atol=1e-6)
    xb = jnp.asarray(x, jnp.bfloat16)            # casts back to bf16
    gb = t_layers.rms_norm(torch.from_numpy(_np(xb)).bfloat16(),
                           torch.from_numpy(s))
    assert gb.dtype == torch.bfloat16
    np.testing.assert_allclose(gb.float().numpy(),
                               _np(j_layers.rms_norm(xb, jnp.asarray(s))),
                               rtol=1e-2, atol=1e-2)


def test_swiglu_matches_with_w3_the_gate():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 16)).astype(np.float32)
    w1, w3 = (rng.normal(size=(16, 24)).astype(np.float32) for _ in "ab")
    w2 = rng.normal(size=(24, 16)).astype(np.float32)
    want = j_layers.swiglu(*map(jnp.asarray, (x, w1, w3, w2)))
    got = t_layers.swiglu(*map(torch.from_numpy, (x, w1, w3, w2)))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)
    swapped = t_layers.swiglu(*map(torch.from_numpy, (x, w3, w1, w2)))
    assert not np.allclose(swapped.numpy(), _np(want), atol=1e-3)


@pytest.mark.parametrize("theta", [500_000.0, 1_000_000.0])
def test_apply_rope_matches_sequence_and_single_step(theta):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32) * 997, (2, 9))
    want = j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = t_layers.apply_rope(torch.from_numpy(x), torch.from_numpy(
        pos.copy()), theta)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)
    # single step, one position per slot (the decode path's form)
    x1 = x[:, :1]
    p1 = np.array([[5], [31]], np.int32)
    want1 = j_layers.apply_rope(jnp.asarray(x1), jnp.asarray(p1), theta)
    got1 = t_layers.apply_rope(torch.from_numpy(x1), torch.from_numpy(p1),
                               theta)
    np.testing.assert_allclose(got1.numpy(), _np(want1), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_logits_match(weights, impl):
    jp, tp = weights
    kw = dict(attn_impl=impl, attn_chunk_q=16, attn_chunk_k=16)
    toks = _tokens(2, 40, seed=4)
    want, _ = JM.forward(_cfg(**kw), jp, jnp.asarray(toks))
    with torch.no_grad():
        got, aux = TM.forward(_tcfg(**kw), tp, torch.from_numpy(toks))
    assert got.shape == (2, 40, 256) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)
    last, _ = TM.forward(_tcfg(**kw), tp, torch.from_numpy(toks),
                         last_only=True)
    np.testing.assert_allclose(last.numpy(), got[:, -1:].numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_step_tokens_equal(weights, impl):
    jp, tp = weights
    kw = dict(attn_impl=impl, attn_chunk_q=16, attn_chunk_k=16)
    toks = _tokens(3, 33, seed=5)
    want = j_prefill_step(_cfg(**kw))(jp, dict(tokens=jnp.asarray(toks)))
    got = make_prefill_step(_tcfg(**kw))(tp, dict(
        tokens=torch.from_numpy(toks)))
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(want).tolist()


def test_decode_steps_match_logits_and_cache(weights):
    """24 decode steps (the reference's serve step), logits and the whole
    KV cache after every step; the port also equals its own forward."""
    jp, tp = weights
    B, S, max_seq = 2, 24, 32
    toks = _tokens(B, S, seed=6)
    jcache = JM.init_cache(_cfg(), B, max_seq)
    tcache = TM.init_cache(_tcfg(), B, max_seq, device="cpu")
    jstep = jax.jit(lambda p, c, t, i: JM.decode_step(_cfg(), p, c, t, i))
    outs = []
    for i in range(S):
        jl, jcache = jstep(jp, jcache, jnp.asarray(toks[:, i]), jnp.int32(i))
        with torch.no_grad():
            tl, tcache = TM.decode_step(_tcfg(), tp, tcache,
                                        torch.from_numpy(toks[:, i]), i)
        np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=1e-5,
                                   atol=1e-5)
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[name].numpy(),
                                       _np(jcache[name]), rtol=1e-5,
                                       atol=1e-5)
        outs.append(tl)
    full, _ = TM.forward(_tcfg(attn_impl="pallas", attn_chunk_q=16,
                               attn_chunk_k=16), tp, torch.from_numpy(toks))
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)


def test_decode_writes_each_slot_at_its_clamped_position(weights):
    """Per-slot positions; a position past the cache writes the last row
    (the reference's ``dynamic_update_slice`` clamps its start)."""
    jp, tp = weights
    max_seq = 8
    pos = np.array([2, 11], np.int32)
    toks = _tokens(2, 1, seed=7)[:, 0]
    step = make_serve_step(_tcfg())
    tcache = TM.init_cache(_tcfg(), 2, max_seq, device="cpu")
    nxt, tcache = step(tp, tcache, torch.from_numpy(toks),
                       torch.from_numpy(pos))
    jstep = j_serve_step(_cfg())
    for b in range(2):
        jc = JM.init_cache(_cfg(), 1, max_seq)
        jn, jc = jstep(jp, jc, jnp.asarray(toks[b:b + 1]), jnp.int32(pos[b]))
        assert int(nxt[b]) == int(jn[0])
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[name][:, b].numpy(),
                                       _np(jc[name])[:, 0], rtol=1e-5,
                                       atol=1e-5)
    assert bool(tcache["k"][:, 1, max_seq - 1].abs().sum() > 0)


def test_served_streams_equal_jax_serve(weights, monkeypatch):
    """The port's serve loop on the JAX serve's own weights and prompts:
    every request's token stream equal, token for token."""
    argv = ["--arch", ARCH, "--smoke", "--requests", "5", "--slots", "2",
            "--prompt-len", "4", "--max-new", "5", "--max-seq", "12"]
    smoke = j_configs.get_smoke
    monkeypatch.setattr(j_configs, "get_smoke",
                        lambda a: dataclasses.replace(smoke(a),
                                                      dtype="float32"))
    # jax 0.9 makes Explicit mesh axes by default, which the reference's
    # sharding constraints reject; its serve loop runs on Auto axes
    monkeypatch.setattr(j_serve, "make_local_mesh", lambda model=1:
                        jax.make_mesh((1, model), ("data", "model"),
                                      axis_types=(AxisType.Auto,) * 2))
    want = j_serve.serve(argv)
    jp, tp = weights                # the call the JAX serve() makes, seed 0
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, (4,)).astype(np.int32)
               for _ in range(5)]
    got = serve_lm(_tcfg(), tp, prompts, slots=2, max_new=5, max_seq=12)
    assert got["outputs"] == want["outputs"]
    assert (got["tokens"], got["steps"]) == (want["tokens"], want["steps"])
    assert got["tokens"] == 5 * 5


def test_serve_flags():
    mbe = serve(["--mbe", "--mesh", "2", "--requests", "2"], device="cpu")
    assert mbe["executor"] == "sharded" and mbe["metric"] > 0
    mp = serve(["--arch", ARCH, "--smoke", "--model-parallel", "2",
                "--requests", "2", "--slots", "2", "--prompt-len", "3",
                "--max-new", "2"], device="cpu")
    assert mp["mesh"] == {"data": 1, "model": 2}
    assert mp["tokens"] == 4 and sorted(mp["outputs"]) == [0, 1]
    out = serve(["--arch", ARCH, "--smoke", "--requests", "2", "--slots",
                 "2", "--prompt-len", "3", "--max-new", "2"], device="cpu")
    assert out["tokens"] == 4 and sorted(out["outputs"]) == [0, 1]


def _default_device_calls():
    cfg = _tcfg()
    specs = TM.param_specs(cfg)
    return {
        "init_params": lambda: t_layers.init_params(specs, 0),
        "init_cache": lambda: TM.init_cache(cfg, 2, 8),
        "params_from_jax": lambda: params_from_jax(
            {"w": np.zeros((2, 2), np.float32)}),
        "serve": lambda: serve(["--arch", ARCH, "--smoke", "--requests",
                                "1"]),
        "train": lambda: train(["--arch", ARCH, "--smoke", "--steps", "1"]),
        "restore": lambda: restore(".", {"params": {}}),
    }


@pytest.mark.parametrize("entry", sorted(_default_device_calls()))
def test_entry_points_default_to_the_card(entry):
    """Without a ``device`` each LM entry point asks for the card, and
    raises when there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _default_device_calls()[entry]()
