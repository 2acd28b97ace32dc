"""The port's front door (``repro_torch.MBEClient``) against the JAX
package's: the same ``random_graph_stream`` through both clients gives
equal payloads (``n_max``, ``cs``, decoded bicliques, ``truncated``),
statuses, per-request ``steps`` and ``nodes``, routing decisions and
cache ``misses`` (tolerance: exact), for the dense and the compact
engine.  Also the ``stats()`` schema, the import firewall (no JAX, no
``repro``), the SLO and fault-tolerance options served through both
clients, and what the port does not serve yet."""
import dataclasses
import importlib
import os
import pathlib
import re
import subprocess
import sys

import pytest

import repro
from repro.serving.scheduler import STATS_SCHEMA
import repro_torch
from repro_torch.data.generators import random_graph_stream

ROOT = pathlib.Path(__file__).resolve().parents[1]
# four graphs of random_graph_stream(8, seed=1) in three buckets (75, 214,
# 97 and 21 engine steps): every JAX bucket costs a compile
STREAM = random_graph_stream(8, seed=1)[3:7]


def _payload(r):
    return (r.rid, r.name, r.status, r.n_max, r.cs, r.steps, r.nodes,
            r.bicliques, r.truncated)


@pytest.mark.parametrize("kw", [
    dict(collect=True, collect_cap=16, max_batch=2)])
def test_stream_through_both_clients(kw):
    jc = repro.MBEClient(repro.MBEOptions(**kw))
    tc = repro_torch.MBEClient(repro_torch.MBEOptions(device="cpu", **kw))
    jres = jc.enumerate_many(STREAM)
    tres = tc.enumerate_many(STREAM)
    assert [_payload(r) for r in tres] == [_payload(r) for r in jres]
    assert tc.routing_log == jc.routing_log
    js, ts = jc.stats(), tc.stats()
    for k in ("misses", "hits", "entries", "batches", "lanes", "pad_lanes",
              "busy_steps", "total_lane_steps", "launches", "admitted"):
        assert ts[k] == js[k], k


def test_compact_stream_through_both_clients():
    """engine='compact' served end to end: equal payloads, statuses,
    steps/nodes, routing, the full stats() key set and engine-qualified
    cache keys (compact entries can never collide with dense ones)."""
    kw = dict(engine="compact", collect=True, collect_cap=16, max_batch=2)
    jc = repro.MBEClient(repro.MBEOptions(**kw))
    tc = repro_torch.MBEClient(repro_torch.MBEOptions(device="cpu", **kw))
    jres = jc.enumerate_many(STREAM)
    tres = tc.enumerate_many(STREAM)
    assert [_payload(r) for r in tres] == [_payload(r) for r in jres]
    assert tc.routing_log == jc.routing_log
    js, ts = jc.stats(), tc.stats()
    assert set(ts) == set(STATS_SCHEMA)
    for k in ("engine", "misses", "hits", "entries", "batches", "lanes",
              "pad_lanes", "busy_steps", "total_lane_steps", "launches",
              "admitted"):
        assert ts[k] == js[k], k
    assert ts["engine"] == "compact"
    keys = list(tc.server.cache._entries)
    assert keys and all(k[0][0] == "compact" for k in keys)
    assert [(k[0][0], dataclasses.astuple(k[0][1])) + k[1:] for k in keys] \
        == [(k[0][0], dataclasses.astuple(k[0][1])) + k[1:]
            for k in jc.server.cache._entries]


def test_stats_schema_and_types():
    c = repro_torch.MBEClient(repro_torch.MBEOptions(device="cpu"))
    c.enumerate_many(STREAM[:2])
    st = c.stats()
    assert set(st) == set(STATS_SCHEMA)
    for k, typ in STATS_SCHEMA.items():
        assert isinstance(st[k], typ), (k, type(st[k]))
    c.server.reset_stats()
    assert c.stats()["misses"] == 0 and c.stats()["entries"] > 0


def test_futures_cancel_and_priority():
    c = repro_torch.MBEClient(repro_torch.MBEOptions(device="cpu"))
    f0, f1 = c.submit(STREAM[3]), c.submit(STREAM[0], priority=3)
    assert f0.cancel() and f0.result().status == "cancelled"
    r1 = f1.result()
    assert r1.status == "done" and r1.n_max > 0
    assert not f1.cancel()


def test_import_firewall():
    """The port imports without JAX, and neither it nor chip_smoke.py
    names ``jax`` or the ``repro`` package in an import."""
    code = ("import sys; sys.modules['jax'] = None; "
            "import repro_torch, repro_torch.core.engine_dense, "
            "repro_torch.core.engine_compact, "
            "repro_torch.serving.scheduler, repro_torch.serving.slo, "
            "repro_torch.serving.faults, repro_torch.serving.recovery, "
            "repro_torch.launch.serve; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env)
    bad = re.compile(r"^\s*(import jax|from jax|import repro\b(?!_torch)"
                     r"|from repro[. ](?!_torch))", re.M)
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for f in files:
        assert not bad.search(f.read_text()), f


@pytest.mark.parametrize("case", ["serve-model-parallel", "train-compress",
                                  "train-model-parallel",
                                  "serve-hybrid-model-parallel",
                                  "train-ssm-model-parallel"])
def test_mesh_options_run(case, tmp_path):
    """The options that raised before the LM mesh and the model axis of
    the hybrid and ssm families were ported (ROADMAP Queue 1 items 8,
    12c and 12e) run on CPU shards."""
    import torch

    from repro_torch import configs
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import train
    from repro_torch.models import model as TM
    from repro_torch.models.layers import init_params
    from repro_torch.training.compress import init_error_state
    from repro_torch.training.optimizer import adamw
    from repro_torch.training.step import make_train_step
    if case == "serve-model-parallel":
        out = serve(["--arch", "qwen3-1.7b", "--smoke", "--model-parallel",
                     "2", "--requests", "2", "--prompt-len", "3",
                     "--max-new", "2"], device="cpu")
        assert out["tokens"] == 4 and out["mesh"] == {"data": 1, "model": 2}
    elif case == "train-compress":
        cfg = configs.get_smoke("granite-moe-1b-a400m")
        opt = adamw()
        step = make_train_step(cfg, opt, compress_axis="x")
        p = init_params(TM.param_specs(cfg), 0, device="cpu")
        toks = torch.randint(0, cfg.vocab, (2, 32),
                             generator=torch.Generator().manual_seed(0))
        p2, _, m, err = step(p, opt.init(p), dict(tokens=toks, labels=toks),
                             init_error_state(p))
        assert bool(torch.isfinite(m["loss"])) and set(err) == set(p)
    elif case == "serve-hybrid-model-parallel":
        out = serve(["--arch", "zamba2-7b", "--smoke", "--requests", "1",
                     "--model-parallel", "2", "--prompt-len", "3",
                     "--max-new", "2"], device="cpu")
        assert out["tokens"] == 2 and out["mesh"] == {"data": 1, "model": 2}
    else:
        arch = "xlstm-1.3b" if case == "train-ssm-model-parallel" \
            else "qwen3-1.7b"
        out = train(["--arch", arch, "--smoke", "--steps", "1",
                     "--batch", "2", "--seq", "16", "--model-parallel", "2",
                     "--ckpt-dir", str(tmp_path)], device="cpu")
        assert out["mesh"] == {"data": 1, "model": 2}
        assert out["loss"] is not None


def _served_option(pkg, name, path):
    """The keyword of ``MBEOptions`` option ``name``, built with
    ``pkg``'s own policy classes."""
    sv = importlib.import_module(f"{pkg.__name__}.serving")
    return dict(
        admission=dict(admission=sv.AdmissionPolicy(max_pending=1)),
        trace_path=dict(trace_path=str(path)),
        retry=dict(retry=sv.RetryPolicy(checkpoint_interval=1)),
        fault_injector=dict(fault_injector=sv.FaultPlan(seed=1,
                                                        launch_rate=0.3),
                            retry=sv.RetryPolicy(max_attempts=8,
                                                 backoff_s=1e-5)))[name]


@pytest.mark.parametrize("name", ["admission", "trace_path", "retry",
                                  "fault_injector"])
def test_served_options_accepted(name, tmp_path):
    """The four options an earlier port refused are accepted by
    ``MBEOptions`` and serve results: the same payloads and counters as
    the JAX package's client with the same option."""
    res = {}
    for pkg, extra in ((repro_torch, dict(device="cpu")), (repro, {})):
        path = tmp_path / f"{pkg.__name__}.jsonl"
        c = pkg.MBEClient(pkg.MBEOptions(
            max_batch=2, steps_per_round=16, **extra,
            **_served_option(pkg, name, path)))
        res[pkg.__name__] = c.enumerate_many(STREAM[:3]), c.stats()
    (tres, tst), (jres, jst) = res["repro_torch"], res["repro"]
    assert [_payload(r) for r in tres] == [_payload(r) for r in jres]
    assert any(r.status == "done" for r in tres)
    for k in ("admitted", "rejected", "retries", "checkpoints",
              "faults_injected", "failovers"):
        assert tst[k] == jst[k], k
    if name == "trace_path":
        assert (tmp_path / "repro_torch.jsonl").exists()
    if name == "admission":
        assert tst["rejected"] > 0
    if name in ("retry", "fault_injector"):
        assert tst["checkpoints"] + tst["retries"] > 0


def test_cuda_device_without_a_card_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.MBEClient(repro_torch.MBEOptions())


def _default_device_calls():
    """Every public constructor that places tensors, called without a
    device: each must aim at the card."""
    import numpy as np
    from repro_torch.core import engine_compact as tec
    from repro_torch.core import distributed as tdd
    from repro_torch.core import engine_dense as ted
    from repro_torch.core.engine import COMPACT, DENSE
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sharding.axes import mbe_serve_mesh
    from repro_torch.serving.cache import ExecutableCache
    g = STREAM[0].canonical()
    cfg = ted.make_config(g)
    tasks = np.arange(g.n_u, dtype=np.int32)
    ctx = ted.GraphContext(**ted.state_to_numpy(
        ted.make_context(g, cfg, "cpu")))
    st = ted.DenseState(**ted.state_to_numpy(
        ted.init_state(cfg, tasks, "cpu")))
    cctx = tec.CompactContext(**tec.state_to_numpy(
        tec.make_context(g, cfg, "cpu")))
    cst = tec.CompactState(**tec.state_to_numpy(
        tec.init_state(cfg, tasks, "cpu")))
    return {
        "make_context": lambda: ted.make_context(g, cfg),
        "init_state": lambda: ted.init_state(cfg, tasks),
        "context_from_numpy": lambda: ted.context_from_numpy(ctx),
        "state_from_numpy": lambda: ted.state_from_numpy(st),
        "Engine.make_context": lambda: DENSE.make_context(g, cfg),
        "Engine.init_state": lambda: DENSE.init_state(cfg, tasks),
        "Engine.dummy_context": lambda: DENSE.dummy_context(cfg),
        "Engine.fresh_lane_state": lambda: DENSE.fresh_lane_state(cfg, 2),
        "ExecutableCache.get_round":
            lambda: ExecutableCache().get_round(cfg, 2, 8),
        "ExecutableCache.get": lambda: ExecutableCache().get(cfg, 2),
        "compact.make_context": lambda: tec.make_context(g, cfg),
        "compact.init_state": lambda: tec.init_state(cfg, tasks),
        "compact.context_from_numpy": lambda: tec.context_from_numpy(cctx),
        "compact.state_from_numpy": lambda: tec.state_from_numpy(cst),
        "compact.enumerate_compact": lambda: tec.enumerate_compact(g),
        "CompactEngine.dummy_context": lambda: COMPACT.dummy_context(cfg),
        "CompactEngine.fresh_lane_state":
            lambda: COMPACT.fresh_lane_state(cfg, 2),
        "ExecutableCache.get_round compact":
            lambda: ExecutableCache().get_round(cfg, 2, 8, engine=COMPACT),
        "mbe_serve_mesh": lambda: mbe_serve_mesh(),
        "make_local_mesh": lambda: make_local_mesh(),
        "make_distributed_runner":
            lambda: tdd.make_distributed_runner(g, cfg),
    }


@pytest.mark.parametrize("entry", sorted(_default_device_calls()))
def test_entry_points_default_to_the_card(entry):
    """No helper quietly places its tensors on the CPU: without a
    ``device`` each asks for the card, and raises when there is none."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _default_device_calls()[entry]()
