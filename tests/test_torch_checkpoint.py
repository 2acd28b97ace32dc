"""The port's checkpoints (``repro_torch.checkpoint``) in the reference's
on-disk format: a checkpoint the port writes restores in
``repro.checkpoint.restore`` and the reverse, leaf for leaf (bf16 too),
with equal manifests; keep-N retention with async writes; and the CPU
launcher, whose run with an injected failure ends with params and
optimizer state bit-identical to an uninterrupted run's."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as j_restore
from repro.checkpoint import save as j_save
from repro.training.optimizer import AdamWState as JState
from repro_torch.checkpoint import (CheckpointManager, latest_step, restore,
                                    save)
from repro_torch.checkpoint.store import _COMMIT
from repro_torch.launch.train import train
from repro_torch.training.optimizer import AdamWState as TState


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    p = {"embed/tok": rng.normal(size=(6, 4)).astype(np.float32),
         "layers/attn/wq": rng.normal(size=(2, 4, 4)).astype(np.float32),
         "final_norm/scale": rng.normal(size=(4,)).astype(np.float32)}
    return p, rng.normal(size=(3, 5)).astype(np.float32)


def _jax_tree(p, half):
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    return {"params": jp, "half": jnp.asarray(half, jnp.bfloat16),
            "opt": JState(step=jnp.int32(7),
                          mu={k: v * 2 for k, v in jp.items()},
                          nu={k: v * v for k, v in jp.items()})}


def _torch_tree(p, half):
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    return {"params": tp, "half": torch.from_numpy(half).bfloat16(),
            "opt": TState(step=torch.tensor(7, dtype=torch.int32),
                          mu={k: v * 2 for k, v in tp.items()},
                          nu={k: v * v for k, v in tp.items()})}


def _leaves(tree):
    """(key path, numpy value) pairs of a JAX tree, bf16 as fp32."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(jax.tree_util.keystr(k), np.asarray(v, np.float32)
             if v.dtype == jnp.bfloat16 else np.asarray(v)) for k, v in flat]


def _template(tree):
    return jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        tree)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    p, half = _arrays()
    save(str(tmp_path / "t"), 3, _torch_tree(p, half), extra={"data_step": 3})
    j_save(str(tmp_path / "j"), 3, _jax_tree(p, half), extra={"data_step": 3})
    with open(tmp_path / "t" / "step_0000000003" / "manifest.json") as f:
        mt = json.load(f)
    with open(tmp_path / "j" / "step_0000000003" / "manifest.json") as f:
        mj = json.load(f)
    assert mt == mj
    assert any(e["dtype"] == "bfloat16" for e in mt["leaves"])
    want = _jax_tree(p, half)
    got, extra = j_restore(str(tmp_path / "t"), _template(want))
    assert extra == {"data_step": 3}
    for (kg, g), (kw, w) in zip(_leaves(got), _leaves(want)):
        assert kg == kw and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got["half"].dtype == jnp.bfloat16


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    p, half = _arrays(1)
    j_save(str(tmp_path), 9, _jax_tree(p, half), extra={"data_step": 9})
    want = _torch_tree(p, half)
    tmpl = {"params": dict.fromkeys(p), "half": None,
            "opt": TState(step=None, mu=dict.fromkeys(p),
                          nu=dict.fromkeys(p))}
    got, extra = restore(str(tmp_path), tmpl, device="cpu")
    assert extra == {"data_step": 9}
    assert isinstance(got["opt"], TState)
    assert got["half"].dtype == torch.bfloat16
    assert torch.equal(got["half"], want["half"])
    assert got["opt"].step.dtype == torch.int32 and int(got["opt"].step) == 7
    for part in ("mu", "nu"):
        for k in p:
            assert torch.equal(getattr(got["opt"], part)[k],
                               getattr(want["opt"], part)[k])
    for k in p:
        assert torch.equal(got["params"][k], want["params"][k])
    with pytest.raises(KeyError, match="missing leaf"):
        restore(str(tmp_path), {"params": {"nope": None}}, device="cpu")


def test_manager_keeps_the_newest_and_ignores_uncommitted(tmp_path):
    p, half = _arrays(2)
    tree = _torch_tree({k: v.copy() for k, v in p.items()}, half)
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree, extra={"data_step": s})
        tree["params"]["embed/tok"].add_(1.0)  # in place, after the snapshot
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_0000000003",
                                            "step_0000000004"]
    got, extra, step = mgr.restore_latest({"params": dict.fromkeys(p)},
                                          device="cpu")
    assert step == 4 and extra == {"data_step": 4}
    np.testing.assert_array_equal(got["params"]["embed/tok"].numpy(),
                                  p["embed/tok"] + 1.0 + 1.0 + 1.0)
    os.remove(tmp_path / "step_0000000004" / _COMMIT)
    assert latest_step(str(tmp_path)) == 3


def test_launcher_restart_is_bit_identical_on_the_cpu(tmp_path):
    """An injected failure after step 6 and a restart from the step-4
    checkpoint end with the same params and optimizer state, bit for bit,
    as an uninterrupted run."""
    base = ["--arch", "qwen3-1.7b", "--smoke", "--steps", "10", "--batch",
            "2", "--seq", "16", "--ckpt-every", "4", "--lr", "1e-3"]
    r_fail = train(base + ["--ckpt-dir", str(tmp_path / "a"), "--fail-at",
                           "6"], device="cpu")
    r_ok = train(base + ["--ckpt-dir", str(tmp_path / "b")], device="cpu")
    assert r_fail["restarts"] == 1 and r_fail["starts"] == [0, 4]
    assert r_ok["restarts"] == 0 and r_ok["starts"] == [0]
    assert r_fail["loss"] == r_ok["loss"]
    names = json.load(open(tmp_path / "b" / "step_0000000010"
                           / "manifest.json"))["leaves"]
    tmpl = {"params": {}, "opt": TState(step=None, mu={}, nu={})}
    for e in names:
        if e["key"].startswith("['params']"):
            tmpl["params"][e["key"][12:-2]] = None
    for part in ("mu", "nu"):
        getattr(tmpl["opt"], part).update(dict.fromkeys(tmpl["params"]))
    a, _ = restore(str(tmp_path / "a"), tmpl, device="cpu")
    b, _ = restore(str(tmp_path / "b"), tmpl, device="cpu")
    assert int(a["opt"].step) == int(b["opt"].step) == 10
    for k in tmpl["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
        assert torch.equal(a["opt"].mu[k], b["opt"].mu[k]), k
        assert torch.equal(a["opt"].nu[k], b["opt"].nu[k]), k


def test_launcher_flags(tmp_path):
    """``--model-parallel 2`` on two CPU shards: the run fails after step
    6, restarts from the step-5 checkpoint (saved whole, restored into
    the mesh's layout), resumes at data step 5 and gives the uninterrupted
    run's loss history bit for bit."""
    base = ["--arch", "qwen3-1.7b", "--smoke", "--steps", "12",
            "--ckpt-every", "5", "--model-parallel", "2", "--batch", "4",
            "--seq", "32"]
    r_fail = train(base + ["--ckpt-dir", str(tmp_path / "a"), "--fail-at",
                           "6"], device="cpu")
    r_ok = train(base + ["--ckpt-dir", str(tmp_path / "b")], device="cpu")
    assert r_fail["mesh"] == {"data": 1, "model": 2}
    assert r_fail["restarts"] == 1 and r_fail["starts"] == [0, 5]
    assert r_fail["history"] == r_ok["history"]
    assert len(r_ok["history"]) == 3
