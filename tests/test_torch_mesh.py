"""The port's work-stealing rounds over a mesh of devices
(``repro_torch.core.distributed`` on ``launch.mesh`` /
``sharding.axes``) against the JAX package's ``shard_map`` rounds.

The reference runs in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (the flag would
leak into this session's JAX) and writes every round's worker states and
telemetry to an ``.npz``; the port runs here on a CPU mesh of 4 (four
shards of the CPU device, the counterpart of the forced host devices).

* Every leaf and the telemetry after EVERY round equal (tolerance:
  exact, ``strict=True``): the dense engine (torch-op path, and
  ``kernel_impl="pallas"``, which runs K3's plain version on each
  shard), ``mce`` and ``count``, ``workers_per_device`` 1 and 2,
  stealing on and off; and the per-lane form (``ctx_batched=True``, one
  graph a lane, the serving layout).  ``ctx_batched=True`` with stealing
  raises ``ValueError`` in both packages.
* Placement changes nothing: a mesh of 4 x ``wpd`` workers gives the
  port's one-device rounds at ``4 x wpd`` workers.
* Exactly once (``tests/test_workstealing.py``'s invariant) at 4
  devices, stealing on and off; the totals equal the serial oracle's.
* ``mbe_serve_mesh``: CPU meshes of any size, the reference's axis
  names, the missing-axis error, and no CPU mesh in the card's place.
"""
import json
import os
import pathlib
import subprocess
import sys
from collections import Counter

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from repro.core import distributed as jdd
from repro.core.engine import get_engine as j_get
from repro.data import generators as jgen
from repro_torch.baselines.mbea import enumerate_mbea
from repro_torch.core import distributed as tdd
from repro_torch.core import engine_dense as ted
from repro_torch.core.engine import get_engine as t_get
from repro_torch.data import generators as tgen
from repro_torch.launch.mesh import Mesh, make_local_mesh, mesh_axis_sizes
from repro_torch.serving import ShardedExecutor
from repro_torch.sharding.axes import MBE_LANE_AXIS, mbe_serve_mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_DEV = 4
AXES = (MBE_LANE_AXIS,)

# name -> (engine, graph, config keywords, wpd, work stealing,
#          steps_per_round, steps_per_call); graph: ("suite", name) or
#          ("uni", n, p, seed)
CASES = {
    "dense-w1-ws": ("dense", ("suite", "community-tiny"), {}, 1, True,
                    24, 1),
    "dense-w2-nows": ("dense", ("suite", "community-tiny"), {}, 2, False,
                      24, 1),
    "dense-w1-nows": ("dense", ("suite", "community-tiny"), {}, 1, False,
                      24, 1),
    "dense-w2-ws": ("dense", ("suite", "community-tiny"), {}, 2, True,
                    24, 1),
    "mce-w2-ws": ("mce", ("uni", 24, 0.3, 3), dict(order_mode="deg"), 2,
                  True, 16, 3),
    "count-w1-ws": ("count", ("suite", "ucforum-like"),
                    dict(count_pq=(2, 2)), 1, True, 16, 3),
}
# the per-lane form: 8 lanes (2 a device) of one 16 x 32 bucket
LANE_GRAPHS = [(6 + i, 16 + i, 0.3, 100 + i) for i in range(8)]
LANE_BUCKET = (16, 32, 18)
LANE_SPR = 8

_REF = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%d"
import numpy as np, jax
from repro.core import distributed as jdd
from repro.core.engine import get_engine
from repro.data import generators as gen
from repro.sharding.axes import mbe_serve_mesh
assert jax.device_count() == %d
out, spec = sys.argv[1], json.loads(sys.argv[2])
mesh = mbe_serve_mesh(%d)
arrays = {}

def graph(g):
    if g[0] == "suite":
        return gen.dataset_suite("test")[g[1]]
    return gen.random_unipartite(g[1], g[2], seed=g[3])

def stack(xs):
    return jax.tree.map(lambda *a: jax.numpy.stack(a), *xs)

def rounds(name, fn, ctx, state, eng):
    for r in range(400):
        state, tel = fn(ctx, state)
        for f in state._fields:
            arrays[f"{name}/{r}/{f}"] = np.asarray(getattr(state, f))
        for k in ("busy_steps", "pending"):
            arrays[f"{name}/{r}/{k}"] = np.asarray(tel[k])
        if bool(np.asarray(eng.done(state)).all()):
            break
    arrays[f"{name}/rounds"] = np.int64(r + 1)

for name, (engine, g, kw, wpd, ws, spr, spc) in spec["cases"].items():
    eng, g = get_engine(engine), graph(g)
    if "count_pq" in kw:
        kw["count_pq"] = tuple(kw["count_pq"])
    cfg = eng.make_config(g, **kw)
    dist = jdd.DistConfig(steps_per_round=spr, workers_per_device=wpd,
                          work_stealing=ws, steps_per_call=spc)
    fn, W, T = jdd.make_round_fn(cfg, mesh, ("mbe_lanes",), dist,
                                 with_telemetry=True, engine=eng)
    per = []
    for w in range(W):
        tasks = np.arange(w, g.n_u, W, dtype=np.int32)
        pad = np.full(T, -1, np.int32)
        pad[: len(tasks)] = tasks
        per.append(eng.init_state(cfg, tasks)._replace(
            tasks=jax.numpy.asarray(pad)))
    rounds(name, fn, eng.make_context(g, cfg), stack(per), eng)

eng = get_engine("dense")
n_u, n_v, depth = spec["bucket"]
cfg = eng.config(n_u, n_v, depth)
gs = [gen.random_bipartite(a, b, p, seed=sd).canonical()
      for a, b, p, sd in spec["lanes"]]
dist = jdd.DistConfig(steps_per_round=spec["lane_spr"],
                      workers_per_device=len(gs) // %d, work_stealing=False)
fn, _, _ = jdd.make_round_fn(cfg, mesh, ("mbe_lanes",), dist,
                             ctx_batched=True, with_telemetry=True)
rounds("lanes", fn, stack([eng.make_context(g, cfg) for g in gs]),
       stack([eng.fresh_lane_state(cfg, g.n_u) for g in gs]), eng)
np.savez(out, **arrays)
""" % ((N_DEV,) * 4)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's rounds on 4 forced host devices, every case."""
    out = tmp_path_factory.mktemp("mesh_ref") / "rounds.npz"
    spec = dict(cases=CASES, bucket=LANE_BUCKET, lanes=LANE_GRAPHS,
                lane_spr=LANE_SPR)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _REF, str(out),
                        json.dumps(spec)], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    return dict(np.load(out))


def _mesh(n=N_DEV):
    return Mesh(["cpu"] * n, AXES)


def _graph(g):
    if g[0] == "suite":
        return tgen.dataset_suite("test")[g[1]]
    return tgen.random_unipartite(g[1], g[2], seed=g[3])


def _assert_round(ref, name, r, state, tel):
    """Every leaf of the port's gathered state and its telemetry equal
    the reference's round ``r``."""
    view = state.gather()
    leaves = ted.state_to_numpy(view)
    for f, got in leaves.items():
        np.testing.assert_array_equal(got, ref[f"{name}/{r}/{f}"],
                                      err_msg=f"{name} round {r}: {f}",
                                      strict=True)
    for k in ("busy_steps", "pending"):
        np.testing.assert_array_equal(tel[k].numpy(),
                                      ref[f"{name}/{r}/{k}"],
                                      err_msg=f"{name} round {r}: {k}",
                                      strict=True)


def _port_rounds(name, mesh, kernel_impl="jnp"):
    """The port's round fn for case ``name`` on ``mesh`` from the strided
    deal: the list of (state, telemetry) of every round until done."""
    engine, g, kw, wpd, ws, spr, spc = CASES[name]
    eng, g = t_get(engine), _graph(g)
    cfg = eng.make_config(g, kernel_impl=kernel_impl, **kw)
    n_dev = mesh.size
    wpd = wpd * N_DEV // n_dev
    dist = tdd.DistConfig(steps_per_round=spr, workers_per_device=wpd,
                          work_stealing=ws, steps_per_call=spc)
    fn, W, T = tdd.make_round_fn(cfg, mesh, AXES, dist,
                                 with_telemetry=True, engine=eng)
    assert (W, T) == (n_dev * wpd, cfg.m_real)
    ctx = tdd.replicate(eng.make_context(g, cfg, "cpu"), mesh)
    state = tdd.Sharded.split(tdd.strided_states(eng, cfg, g.n_u, W, "cpu"),
                              mesh)
    out = []
    for _ in range(400):
        state, tel = fn(ctx, state)
        assert len(state.shards) == n_dev
        assert all(s.lvl.shape == (wpd,) for s in state.shards)
        out.append((state, tel))
        if bool(eng.done(state.gather()).all()):
            break
    return out


@pytest.mark.parametrize("name,kernel_impl", [
    (n, k) for n in sorted(CASES)
    for k in (("jnp", "pallas") if CASES[n][0] == "dense" else ("jnp",))])
def test_worker_states_after_every_round(ref, name, kernel_impl):
    """The port's rounds on a CPU mesh of 4 against the reference's on 4
    forced host devices, round for round.  ``kernel_impl="pallas"``
    runs the dense rounds as K3 pool segments (the plain version here),
    each shard its own pool (mce and count have no pool kernel)."""
    rounds = _port_rounds(name, _mesh(), kernel_impl)
    assert len(rounds) == int(ref[f"{name}/rounds"]) and len(rounds) > 1
    for r, (state, tel) in enumerate(rounds):
        _assert_round(ref, name, r, state, tel)


def _lane_pool(mesh):
    eng = t_get("dense")
    cfg = eng.config(*LANE_BUCKET)
    gs = [tgen.random_bipartite(a, b, p, seed=sd).canonical()
          for a, b, p, sd in LANE_GRAPHS]
    ctx = ted._stack([eng.make_context(g, cfg, "cpu") for g in gs])
    st = ted._stack([eng.fresh_lane_state(cfg, g.n_u, "cpu") for g in gs])
    return eng, cfg, gs, tdd.shard(ctx, mesh), tdd.shard(st, mesh)


@pytest.mark.parametrize("kernel_impl", ["jnp", "pallas"])
def test_per_lane_form_against_the_reference(ref, kernel_impl):
    """``ctx_batched=True``, stealing off: one graph per lane, the
    context sharded like the state (the ``ShardedExecutor`` round)."""
    import dataclasses
    mesh = _mesh()
    eng, cfg, gs, ctx, st = _lane_pool(mesh)
    cfg = dataclasses.replace(cfg, kernel_impl=kernel_impl)
    dist = tdd.DistConfig(steps_per_round=LANE_SPR,
                          workers_per_device=len(gs) // N_DEV,
                          work_stealing=False)
    fn, _, _ = tdd.make_round_fn(cfg, mesh, AXES, dist, ctx_batched=True,
                                 with_telemetry=True)
    n = int(ref["lanes/rounds"])
    assert n > 2
    for r in range(n):
        st, tel = fn(ctx, st)
        _assert_round(ref, "lanes", r, st, tel)
    view = st.gather()
    assert bool(eng.done(view).all())
    for i, g in enumerate(gs):
        want = ted.enumerate_dense(g, device="cpu")
        assert (int(view.n_max[i]), int(view.cs[i])) == \
            (int(want.n_max), int(want.cs))


def test_per_lane_form_refuses_work_stealing():
    g = tgen.dataset_suite("test")["community-tiny"]
    jg = jgen.dataset_suite("test")["community-tiny"]
    jmesh = JMesh(np.array(jax.devices()[:1]), AXES)
    for make, cfg, mesh in (
            (jdd.make_round_fn, j_get("dense").make_config(jg), jmesh),
            (tdd.make_round_fn, t_get("dense").make_config(g), _mesh())):
        with pytest.raises(ValueError, match="work stealing requires a "
                                             "shared graph context"):
            make(cfg, mesh, AXES, ctx_batched=True)


@pytest.mark.parametrize("name", ["dense-w1-ws", "dense-w2-nows",
                                  "mce-w2-ws"])
def test_placement_changes_nothing(name):
    """4 devices x wpd workers == one device x 4 wpd workers, round for
    round, every leaf and the telemetry."""
    a = _port_rounds(name, _mesh())
    b = _port_rounds(name, _mesh(1))
    assert len(a) == len(b)
    for (sa, ta), (sb, tb) in zip(a, b):
        la = ted.state_to_numpy(sa.gather())
        lb = ted.state_to_numpy(sb.gather())
        for f in la:
            np.testing.assert_array_equal(la[f], lb[f], strict=True)
        for k in ta:
            np.testing.assert_array_equal(ta[k].numpy(), tb[k].numpy())


def _pending(state) -> Counter:
    out = Counter()
    for w in range(state.tasks.shape[0]):
        t, n = int(state.tpos[w]), int(state.n_tasks[w])
        out.update(state.tasks[w, t:n].tolist())
    return out


@pytest.mark.parametrize("ws", [True, False])
def test_every_root_task_runs_exactly_once_on_4_devices(ws):
    """``tests/test_workstealing.py``'s invariant on a mesh of 4 devices
    (2 workers each): the tasks consumed per round sum to the root set
    with multiplicity one across the barriers, and the totals are the
    serial oracle's."""
    g = tgen.dataset_suite("test")["community-tiny"]
    cfg = ted.make_config(g)
    dist = tdd.DistConfig(steps_per_round=16, workers_per_device=2,
                          work_stealing=ws)
    init, roundf, _ = tdd.make_distributed_runner(g, cfg, _mesh(), AXES,
                                                  dist)
    state = init()
    assert len(state.shards) == N_DEV
    pend = _pending(state.gather())
    assert sorted(pend.elements()) == list(range(cfg.m_real))
    executed = Counter()
    for _ in range(dist.max_rounds):
        state = roundf(state)
        view = state.gather()
        after = _pending(view)
        consumed = pend - after
        assert sum(consumed.values()) == \
            sum(pend.values()) - sum(after.values())
        executed.update(consumed)
        pend = after
        if bool(ted._done(view).all()):
            break
    assert not pend
    assert all(v == 1 for v in executed.values())
    assert sorted(executed.elements()) == list(range(cfg.m_real))
    tot = tdd.totals(state)
    ref = ted.enumerate_dense(g, device="cpu")
    assert tot["n_max"] == len(enumerate_mbea(g))
    assert tot["cs"] == int(ref.cs) % (1 << 32)
    assert tot["steps"].shape == (N_DEV * 2,)


@pytest.mark.parametrize("n", [1, 2, 8])
def test_mbe_serve_mesh_on_the_cpu(n):
    mesh = mbe_serve_mesh(n, device="cpu")
    assert mesh.axis_names == (MBE_LANE_AXIS,)
    assert mesh.shape == {MBE_LANE_AXIS: n} == mesh_axis_sizes(mesh)
    assert mesh.devices == (torch.device("cpu"),) * n
    assert mesh == mbe_serve_mesh(n, device="cpu")
    assert hash(mesh) == hash(mbe_serve_mesh(n, device="cpu"))
    assert ShardedExecutor(mesh).n_devices == n
    local = make_local_mesh(device="cpu")
    assert local.axis_names == ("data", "model") and local.size == 1


def test_sharded_executor_rejects_missing_axis():
    """``tests/test_executors.py``'s missing-axis case; and the card path
    with no card raises instead of building a CPU mesh."""
    with pytest.raises(ValueError, match="no axis"):
        ShardedExecutor(mbe_serve_mesh(1, device="cpu"), axis="nonexistent")
    assert MBE_LANE_AXIS in mbe_serve_mesh(1, device="cpu").axis_names
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mbe_serve_mesh(2)
    elif torch.cuda.device_count() < 64:
        with pytest.raises(ValueError, match="only"):
            mbe_serve_mesh(64)
