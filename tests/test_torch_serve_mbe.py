"""``serve --mbe`` in the port (``repro_torch.launch.serve``, on the CPU)
against the JAX package's ``serve`` with the same flags: the same
``metric`` total, the same ``[route]`` / ``[pool]`` / ``[big]`` lines,
the same ``[serve-mbe]`` line once its wall-clock figures are left out,
and the same scheduling, SLO and fault counters — for the defaults in
continuous mode, the compact / mce / count engines, a traced stream
under backpressure and shed-on-deadline (the two trace files give the
same events), and a chaos stream with retries and a device loss.
``--mesh N`` serves through ``ShardedExecutor`` (against the reference's
in ``tests/test_torch_sharded_executor.py``); asked of the card with no
card, it raises.  Tolerance: exact.
"""
import argparse
import dataclasses
import re

import pytest
import torch

from test_torch_serving_pair import BOTH, LEDGER_KEYS, T, masked
from repro.launch import serve as j_serve
from repro_torch.launch import serve as t_serve

CASES = {
    "defaults-continuous": ["--continuous"],
    "compact": ["--engine", "compact", "--continuous"],
    "mce": ["--engine", "mce"],
    "count": ["--engine", "count", "--count-q", "3"],
    # deadline 41 s never expires here; at slack 0.01 the shed layer
    # refuses a cold bucket's request whose own work tops 0.01 s at the
    # default cost model (the larger graphs), and --admit-max-pending 3
    # turns the rest of the burst away
    "trace-admission": ["--continuous", "--admit-max-pending", "3",
                        "--admit-shed", "--shed-slack", "0.01",
                        "--deadline-s", "41"],
    "chaos": ["--continuous", "--retry", "3", "--fault-launch-rate", "0.2",
              "--fault-device-lost-at", "5"],
}

# the [serve-mbe] line's wall-clock figures
_WALL = re.compile(r"\d+ steps/s|[\d.]+s \([\d.]+ graphs/s\)")


def _run(P, argv, capsys):
    out = P.serve(argv)
    lines = capsys.readouterr().out.splitlines()
    routing = [x for x in lines if x.startswith(("[route]", "[pool]",
                                                 "[big]"))]
    summary = [_WALL.sub("#", x) for x in lines
               if x.startswith("[serve-mbe]")]
    return out, routing, summary


@pytest.mark.parametrize("case", sorted(CASES))
def test_serve_mbe_matches_the_reference(case, capsys, tmp_path):
    argv = ["--mbe", "--requests", "6", "--max-batch", "4", *CASES[case]]
    runs = {}
    for P in BOTH:
        extra = []
        if case == "trace-admission":
            extra = ["--trace", str(tmp_path / f"{P.name}.jsonl")]
        runs[P.name] = _run(P, argv + extra, capsys)
    (t_out, t_routing, t_summary), (j_out, j_routing, j_summary) = \
        runs["torch"], runs["jax"]
    assert t_out["metric"] == j_out["metric"] and t_out["metric"] > 0
    assert t_routing == j_routing and t_routing
    assert t_summary == j_summary and len(t_summary) == 1
    for k in (*LEDGER_KEYS, "requests", "engine", "kernel_impl",
              "occupancy", "pad_lanes", "steps_per_poll"):
        assert t_out[k] == j_out[k], k
    if case == "trace-admission":
        assert t_out["rejected_backpressure"] > 0 and t_out["shed"] > 0
        assert t_out["admitted"] > 0 and t_out["timed_out"] == 0
        events = {P.name: P.slo.read_trace(str(tmp_path / f"{P.name}.jsonl"))
                  for P in BOTH}
        assert masked(events["torch"]) == masked(events["jax"])
    if case == "chaos":
        assert t_out["failovers"] == 1 and t_out["retries"] > 0
        assert t_out["executor"] == "fault(local)"
    if case == "count":
        assert t_out["engine"] == "count"


def test_serve_mbe_mesh_raises():
    """``--mesh 2`` serves on a CPU mesh of 2 (the same metric as the
    one-device run); on the card path with no card it raises rather
    than serving on the CPU."""
    argv = ["--mbe", "--requests", "4", "--max-batch", "2"]
    local, mesh = T.serve(argv), T.serve(argv + ["--mesh", "2"])
    assert mesh["executor"] == "sharded" and mesh["metric"] > 0
    assert mesh["metric"] == local["metric"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_serve.serve(argv + ["--mesh", "2"])


@pytest.mark.parametrize("flags", [
    dict(retry=4, checkpoint_interval=2),
    dict(fault_launch_rate=0.3, fault_seed=9),
    dict(fault_device_lost_at=7),
    dict(admit_max_pending=5, shed_slack=2.0),
    dict(admit_shed=True), dict()])
def test_serve_mbe_builds_the_references_policies(flags):
    """The flag -> policy functions give the reference's policies, field
    for field, and None where the reference gives None."""
    ns = argparse.Namespace(**{**dict(
        retry=0, checkpoint_interval=4, fault_launch_rate=0.0,
        fault_seed=0, fault_device_lost_at=None, admit_max_pending=None,
        admit_shed=False, shed_slack=1.0), **flags})
    for build in ("_retry_policy", "_fault_plan", "_admission_policy"):
        t, j = getattr(t_serve, build)(ns), getattr(j_serve, build)(ns)
        assert (t is None) == (j is None), build
        if t is not None:
            td, jd = dataclasses.asdict(t), dataclasses.asdict(j)
            for k in ("cost", "retry_on"):      # per-package classes
                td.pop(k, None), jd.pop(k, None)
            assert td == jd, build
