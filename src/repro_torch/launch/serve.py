"""Batched serving launchers: the LM continuous-batching decode loop and the
multi-graph MBE front end.

Twin of ``src/repro/launch/serve.py`` (``serve``), with the same flags and
their defaults.

MBE mode (``--mbe``, ``serve_mbe``): a synthetic mixed-size request
stream (symmetric embeds for ``--engine mce``) through ``MBEClient`` on
the card, with the reference's policies built from flags: admission
(``--admit-max-pending``, ``--admit-shed``, ``--shed-slack``,
``--deadline-s``), tracing (``--trace``), recovery (``--retry``,
``--checkpoint-interval``) and chaos (``--fault-launch-rate``,
``--fault-seed``, ``--fault-device-lost-at``).  Every routing decision
and pool placement is printed (``[route]`` / ``[pool]`` / ``[big]``),
then one ``[serve-mbe]`` summary line with the reference's fields.
``--mesh N`` serves through ``ShardedExecutor`` on a 1-D serving mesh
over N cards (N shards of the CPU with ``device="cpu"``); 0 keeps the
one-device ``LocalExecutor``.

LM mode, every model family: the same loop as the reference: a
fixed-slot batch, each slot holding one request's cache rows; a request
is prefilled by replaying its prompt through decode steps; every step
decodes one token for every slot at the slot's own position (greedy
argmax); finished requests leave and queued requests take their slot.
The reference vmaps a one-slot decode over the slots; here the slots are
the batch dimension of one ``decode_step`` with a per-slot position
vector, each slot writing its own cache position and attending over its
own prefix.  What the vmap implies is kept:

* moe routes each slot's token as a capacity group of its own (a batched
  decode groups the whole batch, and a third slot picking an expert would
  be dropped where the reference keeps it);
* the recurrent state of the hybrid and ssm families advances in every
  slot on every call (prompt replays of a neighbour and idle slots too)
  and is not reset when a slot takes a request, so such a request's
  stream depends on its neighbours, as in the reference (ROADMAP
  Queue 3);
* audio prompts are (prompt_len, n_cb) and each generated token a list
  of n_cb codes.

A model-parallel mesh (``--model-parallel`` > 1) is ROADMAP Queue 1
item 12c and raises here.

Usage (on the card):
  python -m repro_torch.launch.serve --arch qwen3-1.7b --smoke \
      --requests 8 --max-new 32
  python -m repro_torch.launch.serve --mbe --continuous --steps-per-round 64
  python -m repro_torch.launch.serve --mbe --mesh 2 --big-graph-threshold 16
  python -m repro_torch.launch.serve --mbe --retry 3 \
      --fault-launch-rate 0.2 --fault-device-lost-at 6
  python -m repro_torch.launch.serve --mbe --trace build/trace.jsonl \
      --admit-max-pending 4 --admit-shed --deadline-s 0.5
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import init_params
from repro_torch.training.step import make_serve_step


def serve_lm(cfg: ModelConfig, params: dict, prompts: list[np.ndarray], *,
             slots: int = 4, max_new: int = 24, max_seq: int = 128) -> dict:
    """Serve ``prompts`` (int32 token arrays, (prompt_len,) or
    (prompt_len, n_cb) for audio) through ``slots`` decode slots on the
    device that holds ``params``; returns the reference's result dict
    (``outputs``: request id -> generated tokens) plus the loop's wall
    time and its decode steps, prompt replay included."""
    dev = params["embed/tok"].device
    params = M.cast_params(cfg, params)     # once per call, not per step
    # moe: each slot's token a capacity group of its own, as in the
    # reference's vmapped one-slot decode
    step = make_serve_step(dataclasses.replace(cfg, moe_group=1)
                           if cfg.is_moe else cfg)
    B = slots
    cache = M.init_cache(cfg, B, max_seq, device=dev)
    cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    slot_req = [-1] * B           # request id per slot
    slot_pos = np.zeros(B, np.int32)
    slot_new = np.zeros(B, np.int32)
    cur_tok = np.zeros((B,) + cb, np.int32)
    queue = list(range(len(prompts)))
    done, outputs = 0, {i: [] for i in range(len(prompts))}
    steps = calls = 0

    def decode(tok, pos):
        nonlocal cache, calls
        nxt, cache = step(params, cache, torch.from_numpy(tok).to(dev),
                          torch.from_numpy(pos).to(dev))
        calls += 1
        return nxt.cpu().numpy()

    def admit(s):
        rid = queue.pop(0)
        slot_req[s] = rid
        # prefill by replaying the prompt through decode steps (the
        # reference's choice: simple and exact)
        for j, t in enumerate(prompts[rid]):
            cur_tok[s] = t
            posv = slot_pos.copy()
            posv[s] = j
            nxt = decode(cur_tok, posv)
        slot_pos[s] = len(prompts[rid])
        slot_new[s] = 0
        cur_tok[s] = nxt[s]

    t0 = time.perf_counter()
    while done < len(prompts):
        for s in range(B):
            if slot_req[s] < 0 and queue:
                admit(s)
        nxt = decode(cur_tok, slot_pos)
        steps += 1
        for s in range(B):
            rid = slot_req[s]
            if rid < 0:
                continue
            outputs[rid].append(nxt[s].tolist())
            slot_pos[s] += 1
            slot_new[s] += 1
            cur_tok[s] = nxt[s]
            if slot_new[s] >= max_new or slot_pos[s] >= max_seq - 1:
                slot_req[s] = -1
                slot_pos[s] = 0
                done += 1
    dt = time.perf_counter() - t0
    toks = sum(len(v) for v in outputs.values())
    return dict(requests=len(prompts), tokens=toks, steps=steps,
                decode_calls=calls, wall_s=dt, tok_per_s=toks / dt,
                outputs=outputs)


def _print_routing(server) -> None:
    """Per-request routing decisions + per-bucket placements (anything
    with a ``routing_log``: MBEClient or MBEServer)."""
    for e in server.routing_log:
        if e["event"] == "route":
            print(f"[route] rid={e['rid']} {e['graph']}: -> {e['route']} "
                  f"(bucket {e['bucket']}, executor={e['executor']}) — "
                  f"{e['reason']}")
        elif e["event"] in ("pool", "pool-grow"):
            grew = (f" (grown from {e['was']})"
                    if e["event"] == "pool-grow" else "")
            print(f"[pool]  bucket {e['bucket']}: {e['lanes']} lanes on "
                  f"{e['placement']}{grew}")
        elif e["event"] == "big-lane":
            print(f"[big]   rid={e['rid']} {e['graph']}: {e['placement']}")


def _request_stream(engine_name: str, n_requests: int, seed: int):
    """The synthetic request stream matched to the engine's workload:
    unipartite engines (``mce``) get symmetric embeds, everything else
    the mixed-size bipartite stream."""
    from repro_torch.core.engine import get_engine
    from repro_torch.data.generators import (random_graph_stream,
                                             random_unipartite)
    if get_engine(engine_name).unipartite:
        rng = np.random.default_rng(seed)
        return [random_unipartite(int(rng.integers(8, 24)),
                                  float(rng.uniform(0.2, 0.5)),
                                  seed=int(rng.integers(1 << 30)),
                                  name=f"req{i}-uni")
                for i in range(n_requests)]
    return random_graph_stream(n_requests, seed=seed)


def _retry_policy(args):
    """The ``RetryPolicy`` of the command line, or None with ``--retry 0``
    (the default: no recovery machinery at all)."""
    if not args.retry:
        return None
    from repro_torch.serving import RetryPolicy
    return RetryPolicy(max_attempts=args.retry,
                       checkpoint_interval=args.checkpoint_interval)


def _fault_plan(args):
    """The chaos ``FaultPlan``, or None when no fault flag was given (no
    injector wrapper at all)."""
    if not args.fault_launch_rate and args.fault_device_lost_at is None:
        return None
    from repro_torch.serving import FaultPlan
    return FaultPlan(seed=args.fault_seed,
                     launch_rate=args.fault_launch_rate,
                     device_lost_after=args.fault_device_lost_at)


def _admission_policy(args):
    """The ``AdmissionPolicy`` of the command line, or None when no
    admission flag was given (the SLO layer stays out of the path)."""
    if args.admit_max_pending is None and not args.admit_shed:
        return None
    from repro_torch.serving.slo import AdmissionPolicy
    return AdmissionPolicy(max_pending=args.admit_max_pending,
                           shed_on_deadline=args.admit_shed,
                           shed_slack=args.shed_slack)


def serve_mbe(args, device="cuda") -> dict:
    """Serve a synthetic mixed-size request stream through ``MBEClient``
    on ``device``, with any registered engine; returns the reference's
    dict plus ``results`` (in submit order)."""
    from repro_torch.api import MBEClient, MBEOptions
    graphs = _request_stream(args.engine, args.requests, args.seed)
    spr = args.steps_per_round if args.continuous else 0
    client = MBEClient(MBEOptions(
        engine=args.engine, count_p=args.count_p, count_q=args.count_q,
        bucket_mode=args.policy,
        kernel_impl=args.kernel_impl,
        resident_lanes=args.resident_lanes,
        resident_rebalance=args.resident_rebalance,
        max_batch=args.max_batch, steps_per_round=spr,
        steps_per_call=args.steps_per_call,
        big_graph_threshold=args.big_graph_threshold,
        mesh=args.mesh or None,
        admission=_admission_policy(args),
        trace_path=args.trace,
        retry=_retry_policy(args),
        fault_injector=_fault_plan(args),
        strict_step_cap=args.strict_step_cap, device=device))
    t0 = time.perf_counter()
    if args.deadline_s is not None:
        futs = [client.submit(g, deadline_s=args.deadline_s)
                for g in graphs]
        client.drain()
        results = [f.result() for f in futs]
    else:
        results = client.enumerate_many(graphs)
    dt = time.perf_counter() - t0
    stats = client.stats()
    # engine-agnostic headline: bicliques/cliques found, or the count
    metric = sum(r.metric for r in results)
    mode = f"continuous(r={spr})" if args.continuous else "flush"
    _print_routing(client)
    slo = ""
    if _admission_policy(args) is not None:
        slo = (f"admitted {stats['admitted']}, "
               f"rejected {stats['rejected']} "
               f"(shed {stats['shed']}, "
               f"backpressure {stats['rejected_backpressure']}), "
               f"timed_out {stats['timed_out']}, ")
    ft = ""
    if _retry_policy(args) is not None or _fault_plan(args) is not None:
        ft = (f"faults {stats['faults_injected']}, "
              f"retries {stats['retries']}, "
              f"checkpoints {stats['checkpoints']}, "
              f"quarantined {stats['quarantined']}, "
              f"failovers {stats['failovers']}, "
              f"failed {stats['failed']}, ")
    print(f"[serve-mbe] {args.requests} graphs, policy={args.policy}, "
          f"engine={stats['engine']}, executor={stats['executor']}, "
          f"kernels={stats['kernel_impl']} "
          f"(x{stats['steps_per_call']}/call), "
          f"{mode}: metric total {metric}, "
          f"{stats['batches']} rounds, "
          f"{stats['misses']} compiles ({stats['hits']} cache hits), "
          f"{slo}{ft}"
          f"occupancy {stats['occupancy']:.2f}, "
          f"{stats['busy_steps'] / dt:.0f} steps/s "
          f"({stats['steps_per_poll']:.0f} steps/poll, "
          f"{stats['launches_per_poll']:.1f} launches/poll), "
          f"{dt:.2f}s ({args.requests / dt:.1f} graphs/s)")
    if args.trace:
        client.server.close_trace()
        print(f"[trace] wrote {args.trace}")
    # the reference's dict, plus the results in submit order
    return dict(requests=args.requests, metric=metric, wall_s=dt,
                results=results, **stats)


def serve(argv=None, *, device="cuda") -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbe", action="store_true",
                    help="serve bipartite graphs (MBE) instead of LM decode")
    ap.add_argument("--policy", default="pow2",
                    choices=["pow2", "linear", "exact"])
    ap.add_argument("--engine", default="dense",
                    help="MBE: workload engine by registry name (dense, "
                         "compact, count, mce)")
    ap.add_argument("--count-p", type=int, default=2,
                    help="count engine: p of the (p,q)-biclique count")
    ap.add_argument("--count-q", type=int, default=2,
                    help="count engine: q of the (p,q)-biclique count")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--continuous", action="store_true",
                    help="MBE: bounded-round slot scheduling with "
                         "mid-flight lane refill")
    ap.add_argument("--steps-per-round", type=int, default=64,
                    help="MBE continuous mode: engine steps per round")
    ap.add_argument("--steps-per-call", type=int, default=1,
                    help="MBE: engine steps per kernel segment "
                         "(bit-identical results)")
    ap.add_argument("--kernel-impl", default="auto",
                    choices=["auto", "jnp", "pallas"],
                    help="MBE: step-kernel path — 'pallas' = the "
                         "hand-written kernels, 'auto' = by device")
    ap.add_argument("--resident-lanes",
                    type=lambda v: v if v == "auto" else int(v),
                    default="auto",
                    help="MBE: multi-lane resident pool kernel — 'auto' "
                         "= one launch per pool whenever the gate admits "
                         "it, int k caps the pool width, 0/1 one launch "
                         "per lane")
    ap.add_argument("--resident-rebalance", action="store_true",
                    help="MBE pool path: rebalance surplus step budget "
                         "from finished to busy lanes at segment "
                         "boundaries")
    ap.add_argument("--mesh", type=int, default=0,
                    help="MBE: serve through ShardedExecutor on a 1-D "
                         "mesh over N devices (0 = LocalExecutor)")
    ap.add_argument("--big-graph-threshold", type=int, default=None,
                    help="MBE: route graphs with >= K root tasks to the "
                         "work-stealing big-graph lane")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="MBE: record a JSONL request trace "
                         "(serving.slo.trace)")
    ap.add_argument("--admit-max-pending", type=int, default=None,
                    help="MBE admission control: bounded-queue "
                         "backpressure — reject (typed 'rejected' "
                         "result) once this many requests are pending")
    ap.add_argument("--admit-shed", action="store_true",
                    help="MBE admission control: shed-on-deadline — "
                         "reject at admit when the simulated completion "
                         "time exceeds the request deadline")
    ap.add_argument("--shed-slack", type=float, default=1.0,
                    help="MBE shed-on-deadline: admit while "
                         "est_completion <= deadline * slack")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="MBE: per-request wall-clock deadline in "
                         "seconds (enables timed_out, and with "
                         "--admit-shed, at-admit shedding)")
    ap.add_argument("--retry", type=int, default=0,
                    help="MBE fault tolerance: retry failed round "
                         "launches up to N attempts (with checkpointing, "
                         "quarantine and failover; 0 = recovery off)")
    ap.add_argument("--checkpoint-interval", type=int, default=4,
                    help="MBE fault tolerance: polls between lane-state "
                         "checkpoints (0 = no checkpointing)")
    ap.add_argument("--fault-launch-rate", type=float, default=0.0,
                    help="MBE chaos testing: inject transient launch "
                         "faults at this per-launch rate")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="MBE chaos testing: fault-schedule seed")
    ap.add_argument("--fault-device-lost-at", type=int, default=None,
                    help="MBE chaos testing: the Nth launch raises a "
                         "persistent DeviceLostError (checkpoint-restore "
                         "failover)")
    ap.add_argument("--strict-step-cap", action="store_true",
                    help="MBE: evict + raise at max_graph_steps instead "
                         "of typed status=='step_capped' results")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.mbe:
        return serve_mbe(args, device=device)
    if args.arch is None:
        ap.error("--arch is required unless --mbe is given")
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel > 1 needs the sharding port (ROADMAP Queue 1 "
            "item 12c); the port serves on one card")

    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get_config(args.arch))
    params = init_params(M.param_specs(cfg), args.seed, device=device)
    rng = np.random.default_rng(args.seed)
    cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    prompts = [rng.integers(0, cfg.vocab,
                            (args.prompt_len,) + cb).astype(np.int32)
               for _ in range(args.requests)]
    out = serve_lm(cfg, params, prompts, slots=args.slots,
                   max_new=args.max_new, max_seq=args.max_seq)
    print(f"[serve] {out['requests']} requests, {out['tokens']} tokens, "
          f"{out['steps']} batch steps, {out['tok_per_s']:.1f} tok/s")
    return out


if __name__ == "__main__":
    serve()
