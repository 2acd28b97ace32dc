"""The port's ``ShardedExecutor`` and the big lane over a mesh against
the JAX package's, on the CPU.

The reference runs once, in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (the flag would
leak into this session's JAX), and writes what each case must match to
a JSON file; the port runs here on CPU meshes (N shards of the CPU
device, the counterpart of the forced host devices).  Tolerance: exact.

* ``tests/test_executors.py``'s 8-device stream (one heavy graph routed
  big, 17 small ones): ``ShardedExecutor(mbe_serve_mesh(8))`` in both
  packages and the port's ``LocalExecutor(big_workers=8)``: the same
  (n_max, cs), decoded bicliques, routing log (every pool's lanes a
  multiple of 8, the "8 device(s)" placement), the heavy graph's busy
  steps on >= 2 of its 8 workers, and the scheduler's launch count.
* ``MBEClient(MBEOptions(mesh=4))`` on the 32-graph stream, dense and
  compact engines: the same payloads, routing log and counters.
* ``serve --mbe --mesh 4``: the same routing lines, summary line and
  counters; ``launch/mbe_run.py`` on a mesh of 8 against the
  reference's on its 8 forced host devices.
* The fault and recovery ladder on a sharded pool (mesh of 4): launch
  faults, corrupted done-mask reads and a device loss with checkpoint
  resume, the same injector logs, payloads, recovery counters and
  routing log.
"""
import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro_torch import MBEClient, MBEOptions
from repro_torch.baselines.mbea import bicliques_to_key_set  # noqa: F401 (_SETUP)
from repro_torch.core import engine_dense as ted
from repro_torch.data.generators import (dense_small, random_bipartite,
                                         random_graph_stream)
from repro_torch.core.graph import BipartiteGraph
from repro_torch.launch import mbe_run as t_mbe_run
from repro_torch.launch import serve as t_serve
from repro_torch.serving import (BucketPolicy, FaultPlan, LocalExecutor,
                                 MBEServer, RetryPolicy, ShardedExecutor)
from repro_torch.sharding.axes import mbe_serve_mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]

STREAM_POLICY = dict(mode="pow2", max_batch=8, steps_per_round=32,
                     big_graph_threshold=16)
CAP = 4096
CLIENT_KW = dict(max_batch=8, steps_per_round=64)
SERVE_ARGV = ["--mbe", "--requests", "8", "--max-batch", "4",
              "--big-graph-threshold", "20", "--continuous", "--mesh", "4"]
MBE_RUN_ARGV = ["--suite", "test", "--workers", "2",
                "--steps-per-round", "32"]
CHAOS = dict(policy=dict(max_batch=2, steps_per_round=16),
             retry=dict(max_attempts=5, backoff_s=1e-5,
                        checkpoint_interval=2),
             plan=dict(seed=3, launch_rate=0.2, corrupt_done_rate=0.1,
                       device_lost_after=9))
LEDGER_KEYS = ("retries", "faults_injected", "checkpoints", "quarantined",
               "failovers", "failed", "step_capped", "batches", "lanes",
               "misses", "hits", "busy_steps", "total_lane_steps",
               "launches", "executor")
STREAM_KEYS = ("big_busy_per_worker", "big_imbalance", "batches",
               "busy_steps", "total_lane_steps", "launches", "misses",
               "hits", "pending", "in_flight")

_SETUP = r"""
import re
import numpy as np

def stream8(gen):
    heavy = gen.dense_small(18, 36, p=0.5, seed=7, name="heavy")
    rng = np.random.default_rng(0)
    smalls = [gen.random_bipartite(int(rng.integers(6, 14)),
                                   int(rng.integers(16, 30)), p=0.2,
                                   seed=1000 + i, name=f"small{i}")
              for i in range(17)]
    return [heavy] + smalls

def chaos_graphs(graph_cls):
    out = []
    for i in range(6):
        rng = np.random.default_rng(40 + i)
        mask = rng.random((5 + i, 10 + i)) < 0.35
        edges = list(zip(*np.nonzero(mask))) or [(0, 0)]
        out.append(graph_cls.from_edges(5 + i, 10 + i, edges).canonical())
    return out

def key_list(bicliques):
    return sorted([list(L), list(R)]
                  for L, R in bicliques_to_key_set(bicliques))

def payload(r):
    out = {k: getattr(r, k) for k in r.__dataclass_fields__
           if not k.endswith("_s")}
    if out.get("bicliques") is not None:
        out["bicliques"] = key_list(out["bicliques"])
    return out

WALL = re.compile(r"\d+ steps/s|[\d.]+s \([\d.]+ graphs/s\)")

def served_lines(text):
    routing = [x for x in text.splitlines()
               if x.startswith(("[route]", "[pool]", "[big]"))]
    summary = [WALL.sub("#", x) for x in text.splitlines()
               if x.startswith("[serve-mbe]")]
    return routing, summary
"""

_REF = _SETUP + r"""
import contextlib, io, json, os, sys
import jax
from repro import MBEClient, MBEOptions
from repro.baselines import bicliques_to_key_set
from repro.core.graph import BipartiteGraph
from repro.data import generators as gen
from repro.launch import mbe_run, serve
from repro.serving import (BucketPolicy, FaultPlan, MBEServer, RetryPolicy,
                           ShardedExecutor)
from repro.sharding.axes import mbe_serve_mesh
assert jax.device_count() == 8
out_path, spec = sys.argv[1], json.loads(sys.argv[2])
out = {}

srv = MBEServer(BucketPolicy(**spec["stream_policy"]),
                collect_cap=spec["cap"], collect=True,
                executor=ShardedExecutor(mbe_serve_mesh(8)))
res = srv.serve(stream8(gen))
st = srv.stats()
out["stream8"] = dict(
    results=[[r.n_max, r.cs, key_list(r.bicliques)] for r in res],
    routing=srv.routing_log,
    stats={k: st[k] for k in spec["stream_keys"]})

for engine in ("dense", "compact"):
    c = MBEClient(MBEOptions(mesh=4, engine=engine, **spec["client_kw"]))
    res = c.enumerate_many(gen.random_graph_stream(32, seed=0))
    st = c.stats()
    out[f"client-{engine}"] = dict(
        payloads=[payload(r) for r in res], routing=c.routing_log,
        stats={k: st[k] for k in spec["stream_keys"]})

buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    s_out = serve.serve(spec["serve_argv"])
routing, summary = served_lines(buf.getvalue())
out["serve"] = dict(out={k: s_out[k] for k in spec["serve_keys"]},
                    routing=routing, summary=summary)

with contextlib.redirect_stdout(io.StringIO()):
    m = mbe_run.main(spec["mbe_run_argv"])
out["mbe_run"] = {k: v for k, v in m.items() if k != "seconds"}

ch = spec["chaos"]
srv = MBEServer(BucketPolicy(**ch["policy"]),
                executor=ShardedExecutor(mbe_serve_mesh(4)),
                retry=RetryPolicy(**ch["retry"]),
                fault_injector=FaultPlan(**ch["plan"]))
rids = [srv.admit(g) for g in chaos_graphs(BipartiteGraph)]
got = srv.drain()
st = srv.stats()
out["chaos"] = dict(payloads=[payload(got[r]) for r in rids],
                    logs=[i.log for i in srv._injectors],
                    ledger={k: st[k] for k in spec["ledger_keys"]},
                    routing=srv.routing_log)
with open(out_path, "w") as f:
    json.dump(out, f)
"""

exec(compile(_SETUP, "<setup>", "exec"))    # the same helpers, port side


def _json(x):
    """``x`` as the reference's side reads it back from JSON."""
    return json.loads(json.dumps(x))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_ref") / "ref.json"
    spec = dict(stream_policy=STREAM_POLICY, cap=CAP, client_kw=CLIENT_KW,
                serve_argv=SERVE_ARGV, serve_keys=("metric",) + LEDGER_KEYS,
                mbe_run_argv=MBE_RUN_ARGV, chaos=CHAOS,
                ledger_keys=LEDGER_KEYS, stream_keys=STREAM_KEYS)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", _REF, str(out),
                        json.dumps(spec)], env=env, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    return json.loads(out.read_text())


class _Gen:
    dense_small = staticmethod(dense_small)
    random_bipartite = staticmethod(random_bipartite)


def _stream8_server(executor):
    return MBEServer(BucketPolicy(**STREAM_POLICY), collect_cap=CAP,
                     collect=True, executor=executor, device="cpu")


def test_stream_on_8_devices(ref):
    """The reference's 8-device case: the port's sharded stream equals
    the reference's sharded stream and the port's local one."""
    stream = stream8(_Gen)
    shard = _stream8_server(ShardedExecutor(mbe_serve_mesh(8,
                                                           device="cpu")))
    rs = shard.serve(stream)
    local = _stream8_server(LocalExecutor(big_workers=8, device="cpu"))
    rl = local.serve(stream)
    want = ref["stream8"]
    got = [[r.n_max, r.cs, key_list(r.bicliques)] for r in rs]
    assert got == want["results"]
    assert [[r.n_max, r.cs, key_list(r.bicliques)] for r in rl] == got
    for g, r in zip(stream, rs):
        o = ted.enumerate_dense(g.canonical(), collect_cap=CAP, device="cpu")
        assert (r.n_max, r.cs) == (int(o.n_max), int(o.cs) % (1 << 32))
        assert not r.truncated and len(r.bicliques) == r.n_max
    assert _json(shard.routing_log) == want["routing"]
    st = shard.stats()
    assert _json({k: st[k] for k in STREAM_KEYS}) == want["stats"]
    busy = np.array(st["big_busy_per_worker"])
    assert busy.shape == (8,) and int((busy > 0).sum()) >= 2
    routes = [e for e in shard.routing_log if e["event"] == "route"]
    assert [e["route"] for e in routes].count("big") == 1
    big = [e for e in shard.routing_log if e["event"] == "big-lane"][0]
    assert "8 device(s)" in big["placement"]
    pools = [e for e in shard.routing_log if e["event"] == "pool"]
    assert pools and all(e["lanes"] % 8 == 0 for e in pools)
    assert all(e["placement"].startswith("8 devices x ") for e in pools)
    assert st["executor"] == "sharded" and st["launches"] > 0


@pytest.mark.parametrize("engine", ["dense", "compact"])
def test_client_mesh_4(ref, engine):
    c = MBEClient(MBEOptions(mesh=4, engine=engine, device="cpu",
                             **CLIENT_KW))
    res = c.enumerate_many(random_graph_stream(32, seed=0))
    want = ref[f"client-{engine}"]
    assert _json([payload(r) for r in res]) == want["payloads"]
    assert _json(c.routing_log) == want["routing"]
    st = c.stats()
    assert _json({k: st[k] for k in STREAM_KEYS}) == want["stats"]
    ex = c.server.executor
    assert ex.n_devices == 4 and ex.mesh.size == 4
    assert all(e["lanes"] % 4 == 0 for e in c.routing_log
               if e["event"] in ("pool", "pool-grow"))


def test_serve_mbe_mesh_4(ref):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = t_serve.serve(SERVE_ARGV, device="cpu")
    routing, summary = served_lines(buf.getvalue())
    want = ref["serve"]
    assert _json({k: out[k] for k in ("metric",) + LEDGER_KEYS}) == \
        want["out"]
    assert routing == want["routing"] and routing
    assert summary == want["summary"] and len(summary) == 1
    assert out["executor"] == "sharded"


def test_mbe_run_on_8_devices(ref):
    with contextlib.redirect_stdout(io.StringIO()):
        got = t_mbe_run.main(MBE_RUN_ARGV, device="cpu", mesh=8)
    assert _json({k: v for k, v in got.items() if k != "seconds"}) == \
        ref["mbe_run"]


def test_fault_ladder_on_a_sharded_pool(ref):
    srv = MBEServer(BucketPolicy(**CHAOS["policy"]),
                    executor=ShardedExecutor(mbe_serve_mesh(4,
                                                            device="cpu")),
                    retry=RetryPolicy(**CHAOS["retry"]),
                    fault_injector=FaultPlan(**CHAOS["plan"]), device="cpu")
    rids = [srv.admit(g) for g in chaos_graphs(BipartiteGraph)]
    got = srv.drain()
    st = srv.stats()
    rec = dict(payloads=[payload(got[r]) for r in rids],
               logs=[i.log for i in srv._injectors],
               ledger={k: st[k] for k in LEDGER_KEYS},
               routing=srv.routing_log)
    assert _json(rec) == ref["chaos"]
    assert st["failovers"] == 1 and st["faults_injected"] > 0
    assert st["checkpoints"] > 0 and st["retries"] > 0
    assert all(got[r].status == "done" for r in rids)
