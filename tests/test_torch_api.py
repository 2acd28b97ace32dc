"""The port's front door (``repro_torch.MBEClient``) against the JAX
package's: the same ``random_graph_stream`` through both clients gives
equal payloads (``n_max``, ``cs``, decoded bicliques, ``truncated``),
statuses, per-request ``steps`` and ``nodes``, routing decisions and
cache ``misses`` (tolerance: exact).  Also the ``stats()`` schema, the
import firewall (no JAX, no ``repro``) and the options this slice does
not serve yet."""
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
            "repro_torch.serving.scheduler; "
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


@pytest.mark.parametrize("kw,item", [
    (dict(engine="compact"), "item 7"), (dict(mesh=2), "item 8"),
    (dict(big_graph_threshold=8), "item 8"), (dict(trace_path="t"), "item 9"),
    (dict(retry=object()), "item 10")])
def test_unported_options_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        repro_torch.MBEOptions(device="cpu", **kw)


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
    from repro_torch.core import engine_dense as ted
    from repro_torch.core.engine import DENSE
    from repro_torch.serving.cache import ExecutableCache
    g = STREAM[0].canonical()
    cfg = ted.make_config(g)
    tasks = np.arange(g.n_u, dtype=np.int32)
    ctx = ted.GraphContext(**ted.state_to_numpy(
        ted.make_context(g, cfg, "cpu")))
    st = ted.DenseState(**ted.state_to_numpy(
        ted.init_state(cfg, tasks, "cpu")))
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
