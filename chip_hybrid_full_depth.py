#!/usr/bin/env python3
"""zamba2-7b trained at its full depth over four cards.

    python3 chip_hybrid_full_depth.py [--layers 81] [--shards N]

One card cannot hold zamba2-7b's train state: its 6.75 B fp32 masters,
AdamW moments and grads take ~120 GB.  Split over ``model`` (each card
its SSM heads' columns of every Mamba2 layer, 8 of the shared block's 32
attention heads, its vocab rows) a card holds a quarter.  This script
draws the model at full width and ``--layers`` depth (random weights,
seed 0), splits it by ``make_rules``' train table over a mesh of every
visible card with MODEL on its model axis (``--shards N``: N shards of
``cuda:0``, a rehearsal at a depth one card holds), and runs two AdamW
steps with ACCUM microbatches on (BATCH, SEQ) tokens of the port's
SyntheticSource, remat on, K7 (``attn_impl="pallas"``) in the shared
block.  The first step warms the cards up and holds every K7 forward
and backward call against its plain version on the card that ran it
(``chip_smoke.py``'s ``k7_held`` / ``k7_bwd_held``), counting them by
card; the second is timed (every card synchronised) with no hold, and
its launches must equal the first's.  It reports each step's wall time,
loss and grad norm, K7 launches by card, the timed step's tokens/s and
peak device memory by card.

Prints the card's name and power limit, then one JSON object as the last
line.  Needs CUDA; exits non-zero where a K7 call is off its plain
version, the loss or the grad norm is not finite, a card launched no K7
call or the timed step launched other counts than the held one.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import chip_smoke as cs  # noqa: E402

MODEL = 4                  # the model axis
BATCH, ACCUM, SEQ = 4, 2, 4096


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=81)
    ap.add_argument("--shards", type=int, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.log("chip_hybrid_full_depth: CUDA is not available")
        return 1
    from repro_torch import configs
    from repro_torch.datapipe import DataConfig, SyntheticSource
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.layers import init_params, shard_params
    from repro_torch.sharding.auto import make_rules
    from repro_torch.sharding.axes import use_rules
    from repro_torch.training.optimizer import adamw
    from repro_torch.training.step import make_train_step
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    cs.log(f"{smi} ({torch.cuda.device_count()} card(s) visible)")
    if args.shards is None:
        mesh = make_local_mesh(MODEL, device="cuda")
    else:
        mesh = make_local_mesh(MODEL, device="cuda:0", shards=args.shards)
    cards = cs.cards(mesh)
    for i in cards:         # each card's allocator up before its peaks
        torch.empty(1, device=torch.device("cuda", i))
    cfg = dataclasses.replace(configs.get_config("zamba2-7b"), remat=True,
                              attn_impl="pallas", n_layers=args.layers)
    specs = M.param_specs(cfg)
    rules = make_rules(cfg, mesh, ShapeSpec("train", SEQ, BATCH, "train"))
    t = time.perf_counter()
    params = shard_params(init_params(specs, 0, device=mesh.devices[0]),
                          specs, rules)
    opt = adamw(peak_lr=3e-4, warmup=1, total_steps=3)
    state = opt.init(params)
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t
    src = SyntheticSource(DataConfig(batch=BATCH, seq_len=SEQ,
                                     vocab=cfg.vocab, seed=0))
    step = make_train_step(cfg, opt, accum=ACCUM)
    hist, k7 = [], None
    for i, held in enumerate((True, False)):
        batch = {k: torch.from_numpy(v).to(mesh.devices[0])
                 for k, v in src.batch(i).items()}
        if not held:
            cs.peaks_gb(mesh, reset=True)
        cs.sync_cards(mesh)
        cs.reset_counters()
        t = time.perf_counter()
        with use_rules(rules), \
                (cs.k7_held() if held else contextlib.nullcontext()) as fwd, \
                (cs.k7_bwd_held() if held else contextlib.nullcontext()) \
                as bwd:
            params, state, m = step(params, state, batch)
        cs.sync_cards(mesh)
        wall = time.perf_counter() - t
        hist.append(dict(step_s=wall, held=held, loss=float(m["loss"]),
                         grad_norm=float(m["grad_norm"]),
                         launches=cs.nonzero(cs.counters())))
        if held:
            k7 = cs.k7_verdict(f"zamba2-7b {cfg.n_layers} layers step 0",
                               fwd, bwd)
            hist[-1]["k7"] = k7
        cs.log(f"step {i}: " + json.dumps(hist[-1]))
    peak = cs.peaks_gb(mesh)
    wall = hist[-1]["step_s"]
    res = dict(arch=cfg.name, layers=cfg.n_layers, params=cfg.n_params(),
               mesh=mesh.shape, cards=cards, smi=smi, batch=BATCH, seq=SEQ,
               accum=ACCUM, init_s=init_s, steps=hist, step_s=wall,
               tok_per_s=BATCH * SEQ / wall, peak_gb=peak)
    cs.log(smi)
    ok = all(x == x and abs(x) != float("inf") for h in hist
             for x in (h["loss"], h["grad_norm"])) and set(
        k7["fwd_by_card"]) == set(cards) == set(k7["bwd_by_card"]) and (
        hist[0]["launches"] == hist[1]["launches"])
    res["ok"] = ok
    print(json.dumps(res), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
