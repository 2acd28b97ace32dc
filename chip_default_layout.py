#!/usr/bin/env python3
"""The LM launchers' default layout on every visible card against one card.

    python3 chip_default_layout.py [--arch qwen3-1.7b] [--steps 3]

With ``--model-parallel 1`` (the default) ``serve`` and ``train`` on
``device="cuda"`` lay the model over every visible card as a data-only
mesh (data = the card count, model = 1): the batch split over ``data``
and, in training, the weights' ``p_embed`` dimension too (FSDP).  This
script runs both at the architecture's full width (random weights, seed
0) on that mesh and on ``cuda:0`` alone:

* ``serve`` with its CLI defaults (4 slots, 8 requests, prompts of 16,
  24 new tokens): wall, tokens/s, streams equal to the one-card run's;
* the launcher's train step: ``launch.train.build`` with the launcher's
  optimizer and the batches of its data pipeline (``SyntheticSource``,
  seed 0), ``TRAIN_ARGS`` per step, for ``--steps`` steps and no
  checkpoints; each step's wall (every card synchronised), the loss
  beside the one-card run's, tokens/s over all but the first step.

Peak device memory by card for each.  Prints the card's name and power
limit, then one JSON object as the last line.  Needs CUDA; exits
non-zero where a loss is not finite or differs from the one-card run's
by more than ``LOSS_RTOL`` (relative), or a served run yields another
number of tokens.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# the launcher's train step: batch 8 of 1024 tokens in 2 microbatches
# (one card holds a microbatch of 4 without remat; four cards a row each)
TRAIN_ARGS = dict(batch=8, seq=1024, accum=2, lr=3e-4)
# the mesh's partial sums round in another order than one card's
LOSS_RTOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def peaks(devs) -> dict:
    import torch
    out = {}
    for i in devs:
        out[i] = round(torch.cuda.max_memory_allocated(i) / 1e9, 3)
        torch.cuda.reset_peak_memory_stats(i)
    return out


def sync(devs) -> None:
    import torch
    for i in devs:
        torch.cuda.synchronize(i)


def run_serve(arch: str, device: str, devs) -> dict:
    from repro_torch.launch.serve import serve
    peaks(devs)
    out = serve(["--arch", arch], device=device)
    return dict(out, peak_gb=peaks(devs))


def run_train(arch: str, device: str, steps: int, devs) -> dict:
    import torch
    from repro_torch import configs
    from repro_torch.datapipe import DataConfig, SyntheticSource, \
        make_pipeline
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import build
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.layers import init_params
    from repro_torch.sharding.axes import use_rules
    a = TRAIN_ARGS
    cfg = configs.get_config(arch)
    mesh = make_local_mesh(model=1, device=device)
    dev = mesh.devices[0]
    rules, specs, p_shard, opt, step_fn = build(
        cfg, mesh, ShapeSpec("cli", a["seq"], a["batch"], "train"),
        accum=a["accum"], lr=a["lr"], steps=steps)
    params = init_params(specs, 0, device=dev)
    if p_shard is not None:
        params = {k: p_shard[k].shard(v) for k, v in params.items()}
    state = opt.init(params)
    torch.cuda.empty_cache()
    peaks(devs)
    src = SyntheticSource(DataConfig(batch=a["batch"], seq_len=a["seq"],
                                     vocab=cfg.vocab, seed=0))
    pipe = make_pipeline(src, start_step=0)
    hist = []
    try:
        for i, batch in pipe:
            if i >= steps:
                break
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in batch.items()}
            sync(devs)
            t = time.perf_counter()
            with use_rules(rules):
                params, state, m = step_fn(params, state, batch)
            sync(devs)
            hist.append(dict(wall_s=time.perf_counter() - t,
                             loss=float(m["loss"]),
                             grad_norm=float(m["grad_norm"])))
    finally:
        pipe.close()
    walls = [h["wall_s"] for h in hist[1:]] or [hist[0]["wall_s"]]
    tokens = a["batch"] * a["seq"]
    out = dict(mesh=mesh.shape, history=hist, peak_gb=peaks(devs),
               step_s=sum(walls) / len(walls),
               tok_per_s=tokens * len(walls) / sum(walls))
    del params, state
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("chip_default_layout: CUDA is not available")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    n = torch.cuda.device_count()
    devs = list(range(n))
    for i in devs:          # each card's allocator up before its peaks
        torch.empty(1, device=torch.device("cuda", i))
    log(f"{smi} ({n} card(s) visible)")
    res = dict(cards=n, smi=smi, train_args=TRAIN_ARGS, steps=args.steps)
    for key, device in (("all_cards", "cuda"), ("one_card", "cuda:0")):
        t = time.perf_counter()
        s = run_serve(args.arch, device, devs)
        res[f"serve_{key}"] = {k: s[k] for k in ("tokens", "steps", "wall_s",
                                                 "tok_per_s", "mesh",
                                                 "peak_gb")}
        res[f"serve_{key}"]["outputs"] = s["outputs"]
        res[f"train_{key}"] = run_train(args.arch, device, args.steps, devs)
        log(f"[{key}] {time.perf_counter() - t:.1f} s: serve "
            + json.dumps({k: v for k, v in res[f"serve_{key}"].items()
                          if k != "outputs"})
            + " train " + json.dumps(res[f"train_{key}"]))
    sa, so = res.pop("serve_all_cards"), res.pop("serve_one_card")
    res["serve"] = dict(
        all_cards={k: v for k, v in sa.items() if k != "outputs"},
        one_card={k: v for k, v in so.items() if k != "outputs"},
        streams_equal=sum(sa["outputs"][r] == so["outputs"][r]
                          for r in so["outputs"]),
        requests=len(so["outputs"]))
    ok = sa["tokens"] == so["tokens"]
    res["loss_rel"] = []
    for ha, ho in zip(res["train_all_cards"]["history"],
                      res["train_one_card"]["history"]):
        rel = abs(ha["loss"] - ho["loss"]) / abs(ho["loss"])
        res["loss_rel"].append(rel)
        ok = ok and ha["loss"] == ha["loss"] and rel <= LOSS_RTOL
    res["ok"] = bool(ok)
    log(json.dumps(res))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
