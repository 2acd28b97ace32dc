"""LM serving: the continuous-batching decode loop.

Twin of the LM mode of ``src/repro/launch/serve.py`` (``serve``), with the
same flags and the same loop: a fixed-slot batch, each slot holding one
request's KV state; a request is prefilled by replaying its prompt through
decode steps; every step decodes one token for every slot at the slot's
own position (greedy argmax); finished requests leave and queued requests
take their slot.  The reference vmaps a one-slot decode over the slots;
here the slots are the batch dimension of one ``decode_step`` with a
per-slot position vector, each slot writing its own cache position and
attending over its own prefix.

The MBE mode (``--mbe``) is ROADMAP Queue 1 item 11, and a model-parallel
mesh (``--model-parallel`` > 1) item 12; both raise here.

Usage (on the card):
  python -m repro_torch.launch.serve --arch qwen3-1.7b --smoke \
      --requests 8 --max-new 32
"""
from __future__ import annotations

import argparse
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
    """Serve ``prompts`` (int32 token arrays) through ``slots`` decode
    slots on the device that holds ``params``; returns the reference's
    result dict (``outputs``: request id -> generated tokens) plus the
    loop's wall time and its decode steps, prompt replay included."""
    dev = params["embed/tok"].device
    params = M.cast_params(cfg, params)     # once per call, not per step
    step = make_serve_step(cfg)
    B = slots
    cache = M.init_cache(cfg, B, max_seq, device=dev)
    slot_req = [-1] * B           # request id per slot
    slot_pos = np.zeros(B, np.int32)
    slot_new = np.zeros(B, np.int32)
    cur_tok = np.zeros(B, np.int32)
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
            outputs[rid].append(int(nxt[s]))
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


def serve(argv=None, *, device="cuda") -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbe", action="store_true",
                    help="serve bipartite graphs (MBE) instead of LM decode "
                         "(not ported yet)")
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
        raise NotImplementedError(
            "the MBE mode of serve is not ported yet (ROADMAP Queue 1 item "
            "11); serve graphs with repro_torch.MBEClient")
    if args.arch is None:
        ap.error("--arch is required unless --mbe is given")
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel > 1 needs the sharding port (ROADMAP Queue 1 "
            "item 12); the port serves on one card")

    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get_config(args.arch))
    params = init_params(M.param_specs(cfg), args.seed, device=device)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab, (args.prompt_len,)).astype(np.int32)
               for _ in range(args.requests)]
    out = serve_lm(cfg, params, prompts, slots=args.slots,
                   max_new=args.max_new, max_seq=args.max_seq)
    print(f"[serve] {out['requests']} requests, {out['tokens']} tokens, "
          f"{out['steps']} batch steps, {out['tok_per_s']:.1f} tok/s")
    return out


if __name__ == "__main__":
    serve()
