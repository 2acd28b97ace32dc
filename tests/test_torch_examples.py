"""The port's examples (``examples/torch/``) run on the CPU
(``--device cpu``) and do what they print: the quickstart's engines agree
with the oracle, the custom engine counts the edges, the served streams
have every request's tokens (a list of codebook tokens a step for
musicgen)."""
import importlib.util
import pathlib

import pytest

from repro_torch.baselines.mbea import count_mbea
from repro_torch.core import engine as engine_mod
from repro_torch.data.generators import powerlaw_bipartite

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples" / "torch"


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart():
    out = _load("quickstart").main(["--device", "cpu"])
    assert out["n_max"] == 6       # Fig. 1's count (the example checks it)
    assert {"dense", "compact"} <= set(out["engines"])
    big = powerlaw_bipartite(192, 384, m_edges=4000, alpha=1.4, seed=7)
    assert out["big"] == count_mbea(big)


def test_custom_engine(monkeypatch):
    # the example registers "edges" at import: into a copy of the registry
    monkeypatch.setattr(engine_mod, "_REGISTRY", dict(engine_mod._REGISTRY))
    res = _load("custom_engine").main(["--device", "cpu"])
    assert res.count == res.metric == 6 and res.status == "done"
    assert "edges" in engine_mod._REGISTRY


def test_serve_lm():
    outs = _load("serve_lm").main(["--device", "cpu"])
    assert sorted(outs) == ["musicgen-medium", "qwen3-1.7b"]
    for arch, out in outs.items():
        assert out["tokens"] == 6 * 16
        assert all(len(v) == 16 for v in out["outputs"].values())
    steps = [t for v in outs["musicgen-medium"]["outputs"].values()
             for t in v]
    assert all(isinstance(t, list) and len(t) == 2 for t in steps)


def test_train_lm_refuses_without_a_card_by_default():
    """The training example's model is the reference example's qwen3
    config (80M params); without ``--device`` it asks for the card."""
    mod = _load("train_lm")
    spec = importlib.util.spec_from_file_location(
        "reference_example_train_lm", EXAMPLES.parent / "train_lm.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    assert vars(mod.make_100m()) == vars(ref.make_100m())
    assert mod.make_100m().n_params() == ref.make_100m().n_params()
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        mod.main(["--steps", "2"])


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "internvl2-2b",
                                  "musicgen-medium", "zamba2-7b",
                                  "xlstm-1.3b"])
def test_train_lm_takes_every_family(arch):
    """``--arch`` of another family: its smoke config through the same
    launcher loop on the CPU, a failure and a restart, the loss lower at
    the end (the example asserts it)."""
    out = _load("train_lm").main(["--arch", arch, "--steps", "30",
                                  "--batch", "4", "--seq", "32",
                                  "--device", "cpu"])
    assert out["restarts"] == 1 and out["starts"] == [0, 10]
    assert out["steps"] == 30
