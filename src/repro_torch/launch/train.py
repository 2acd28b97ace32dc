"""Fault-tolerant training launcher.

Twin of ``src/repro/launch/train.py`` on one device, with the same flags
and the same loop:

* **checkpoint/restart** — ``CheckpointManager`` with async saves and a
  COMMIT marker; a restart restores the latest committed step and the
  step-indexed data pipeline continues at exactly that batch (so on the
  CPU a resumed run is bit-identical to an uninterrupted one; on the card
  the embedding's backward accumulates with atomics, in no fixed order).
* **failure injection** — ``--fail-at N`` raises after step N on the first
  attempt; the supervisor loop (retry budget ``--max-restarts``) restarts
  from the last checkpoint.

Every family trains: the data source's batches carry the audio family's
codebook tokens and the vlm family's ``patch_emb`` rows to the device with
the tokens and labels.  A model-parallel mesh (``--model-parallel`` > 1)
needs the sharding port (ROADMAP Queue 1 item 12c, ``sharding/*``) and
raises.

Usage (on the card):
  python -m repro_torch.launch.train --arch qwen3-1.7b --smoke --steps 100
  python -m repro_torch.launch.train --arch zamba2-7b --smoke --steps 100
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.datapipe import DataConfig, SyntheticSource, make_pipeline
from repro_torch.kernels.dispatch import check_device
from repro_torch.models import model as M
from repro_torch.models.layers import init_params
from repro_torch.training.optimizer import AdamWState, adamw
from repro_torch.training.step import make_train_step


class SimulatedFailure(RuntimeError):
    pass


def build(cfg, *, accum: int, lr: float, steps: int):
    """(param specs, optimizer, train step) of a run."""
    specs = M.param_specs(cfg)
    opt = adamw(peak_lr=lr, total_steps=steps, warmup=max(steps // 20, 1))
    return specs, opt, make_train_step(cfg, opt, accum=accum)


def init_or_restore(ckpt: CheckpointManager, specs, opt, seed: int,
                    device) -> tuple[dict, AdamWState, int]:
    """(params, optimizer state, data step) from the latest committed
    checkpoint, or fresh ones from ``seed`` at data step 0."""
    tmpl_p = {k: None for k in specs}
    tmpl_o = AdamWState(step=None, mu=dict(tmpl_p), nu=dict(tmpl_p))
    got = ckpt.restore_latest({"params": tmpl_p, "opt": tmpl_o},
                              device=device)
    if got is not None:
        tree, extra, step = got
        print(f"[train] restored step {step}")
        return tree["params"], tree["opt"], int(extra.get("data_step",
                                                          step))
    params = init_params(specs, seed, device=device)
    return params, opt.init(params), 0


def train(argv=None, *, device="cuda") -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a failure after this step (test FT)")
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel > 1 needs the sharding port (sharding/*, "
            "ROADMAP Queue 1 item 12c)")
    dev = check_device(device)

    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get_config(args.arch))
    specs, opt, step_fn = build(cfg, accum=args.accum, lr=args.lr,
                                steps=args.steps)
    ckpt = CheckpointManager(args.ckpt_dir, keep=3, async_save=True)
    dcfg = DataConfig(batch=args.batch, seq_len=args.seq,
                      vocab=cfg.vocab, n_codebooks=cfg.n_codebooks,
                      patch_tokens=cfg.patch_tokens, d_model=cfg.d_model,
                      seed=args.seed)
    src = SyntheticSource(dcfg)

    restarts = 0
    metrics_hist = []
    starts = []
    while True:
        params, opt_state, start = init_or_restore(ckpt, specs, opt,
                                                   args.seed, dev)
        starts.append(start)
        pipe = make_pipeline(src, start_step=start)
        t0 = time.time()
        try:
            for step, batch in pipe:
                if step >= args.steps:
                    break
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in batch.items()}
                params, opt_state, m = step_fn(params, opt_state, batch)
                if step == args.fail_at and restarts == 0:
                    raise SimulatedFailure(f"injected at {step}")
                if step % 10 == 0 or step == args.steps - 1:
                    loss = float(m["loss"])
                    metrics_hist.append((step, loss))
                    print(f"[train] step {step} loss {loss:.4f} "
                          f"lr {float(m['lr']):.2e} "
                          f"{(time.time() - t0):.1f}s")
                if (step + 1) % args.ckpt_every == 0:
                    ckpt.save(step + 1, {"params": params, "opt": opt_state},
                              extra={"data_step": step + 1})
            break
        except SimulatedFailure as e:
            restarts += 1
            print(f"[train] FAILURE {e}; restart {restarts}")
            if restarts > args.max_restarts:
                raise
        finally:
            pipe.close()
    ckpt.save(args.steps, {"params": params, "opt": opt_state},
              extra={"data_step": args.steps})
    ckpt.wait()
    final = dict(loss=metrics_hist[-1][1] if metrics_hist else None,
                 restarts=restarts, steps=args.steps,
                 history=metrics_hist, starts=starts)
    print(f"[train] done: {final['loss']}")
    return final


if __name__ == "__main__":
    train()
