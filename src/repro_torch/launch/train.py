"""Fault-tolerant training launcher.

Twin of ``src/repro/launch/train.py``, with the same flags and the same
loop:

* **checkpoint/restart** — ``CheckpointManager`` with async saves and a
  COMMIT marker; a restart restores the latest committed step and the
  step-indexed data pipeline continues at exactly that batch (so on the
  CPU a resumed run is bit-identical to an uninterrupted one; on the card
  the embedding's backward accumulates with atomics, in no fixed order).
* **failure injection** — ``--fail-at N`` raises after step N on the first
  attempt; the supervisor loop (retry budget ``--max-restarts``) restarts
  from the last checkpoint.

* **the mesh** — ``make_local_mesh(model=--model-parallel)`` over every
  visible card (over N shards of the CPU with ``device="cpu"``): the
  params and the optimizer's moments are split by ``make_rules``'
  ``train_rules`` (the batch over ``data``, FSDP over ``data``, TP over
  ``model``), a checkpoint holds whole leaves, and a restart restores
  into the mesh's layout.  ``--model-parallel 1`` on several cards is
  data-parallel FSDP over all of them; on one device the step runs as it
  always did.

Every family trains, on one device or a mesh: the data source's batches
carry the audio family's codebook tokens and the vlm family's
``patch_emb`` rows to the device with the tokens and labels.

Usage (on the card):
  python -m repro_torch.launch.train --arch qwen3-1.7b --smoke --steps 100
  python -m repro_torch.launch.train --arch zamba2-7b --smoke --steps 100
  python -m repro_torch.launch.train --arch qwen3-1.7b --smoke \
      --model-parallel 2
  python -m repro_torch.launch.train --arch zamba2-7b --smoke \
      --model-parallel 2
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
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import model as M
from repro_torch.models.config import ShapeSpec
from repro_torch.models.layers import init_params
from repro_torch.sharding.auto import make_rules
from repro_torch.sharding.axes import named_sharding, use_rules
from repro_torch.training.optimizer import AdamWState, adamw
from repro_torch.training.step import make_train_step


class SimulatedFailure(RuntimeError):
    pass


def build(cfg, mesh, shape, *, accum: int, lr: float, steps: int):
    """(rules, param specs, param shardings, optimizer, train step) of a
    run; rules and shardings are None on a one-device mesh."""
    specs = M.param_specs(cfg)
    rules = p_shard = None
    if mesh.size > 1:
        rules = make_rules(cfg, mesh, shape)
        p_shard = {k: named_sharding(s.logical, rules)
                   for k, s in specs.items()}
    opt = adamw(peak_lr=lr, total_steps=steps, warmup=max(steps // 20, 1))
    return rules, specs, p_shard, opt, make_train_step(cfg, opt,
                                                       accum=accum)


def init_or_restore(ckpt: CheckpointManager, specs, p_shard, opt,
                    seed: int, device) -> tuple[dict, AdamWState, int]:
    """(params, optimizer state, data step) from the latest committed
    checkpoint, or fresh ones from ``seed`` at data step 0; split by
    ``p_shard`` over its mesh when given."""
    tmpl_p = {k: None for k in specs}
    tmpl_o = AdamWState(step=None, mu=dict(tmpl_p), nu=dict(tmpl_p))
    shardings = None
    if p_shard is not None:
        shardings = {"params": p_shard,
                     "opt": AdamWState(step=None, mu=p_shard, nu=p_shard)}
    got = ckpt.restore_latest({"params": tmpl_p, "opt": tmpl_o},
                              device=device, shardings=shardings)
    if got is not None:
        tree, extra, step = got
        print(f"[train] restored step {step}")
        return tree["params"], tree["opt"], int(extra.get("data_step",
                                                          step))
    params = init_params(specs, seed, device=device)
    if p_shard is not None:
        params = {k: p_shard[k].shard(v) for k, v in params.items()}
    return params, opt.init(params), 0


def train(argv=None, *, device="cuda",
          shards: int | None = None) -> dict:
    """The launcher's CLI (``argv``) on ``device``: every visible card for
    ``"cuda"``, one card for ``"cuda:i"``, or the CPU; ``shards`` lays
    the LM's mesh over that many shards of the one device named
    (``launch.mesh.make_local_mesh``)."""
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

    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get_config(args.arch))
    mesh = make_local_mesh(model=args.model_parallel, device=device,
                           shards=shards)
    dev = mesh.devices[0]
    rules, specs, p_shard, opt, step_fn = build(
        cfg, mesh, ShapeSpec("cli", args.seq, args.batch, "train"),
        accum=args.accum, lr=args.lr, steps=args.steps)
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
        params, opt_state, start = init_or_restore(ckpt, specs, p_shard,
                                                   opt, args.seed, dev)
        starts.append(start)
        pipe = make_pipeline(src, start_step=start)
        t0 = time.time()
        try:
            for step, batch in pipe:
                if step >= args.steps:
                    break
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in batch.items()}
                with use_rules(rules):
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
                 history=metrics_hist, starts=starts, mesh=mesh.shape)
    print(f"[train] done: {final['loss']}")
    return final


if __name__ == "__main__":
    train()
