"""Train, eval and serving step builders.

Twin of ``src/repro/training/step.py``.  ``make_train_step(cfg, opt,
...)`` returns

    (params, opt_state, batch) -> (params, opt_state, metrics)

* **mixed precision** — master params and optimizer moments are fp32; the
  fp32 masters are cast once to ``cfg.dtype`` (matrices only) inside the
  graph, so the grads reach the masters in fp32.  Loss/softmax in fp32.
* **gradient accumulation** — ``accum`` microbatches (the batch's leading
  dim split in ``accum`` slices) each run forward and backward, their
  grads summing into the masters' fp32 ``.grad``; the sum is then divided
  by ``accum``.  Only one microbatch's activations and one fp32 grad set
  live at a time.
* **compression** — ``compress_axis`` needs a collective axis across
  devices; it raises until the multi-GPU item (ROADMAP Queue 1 item 8).

The metrics are ``loss``, ``aux_loss``, ``tokens``, ``lr`` and
``grad_norm``, as 0-d tensors.  The train and eval steps take the dense
family; the others wait for their loss branches (vlm's text-only slice,
audio's codebook labels, moe's aux) and the K7 backward at hd 112
(ROADMAP Queue 1 item 12b).  The serving steps take every family and run
under ``torch.no_grad()``: serving keeps no graph.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import softmax_cross_entropy
from repro_torch.training.optimizer import Optimizer, apply_updates


def _trainable(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"training the {cfg.family} family ({cfg.name}) is not ported "
            f"yet: the port serves it, and trains the dense family (ROADMAP "
            f"Queue 1 item 12b)")


def loss_fn(cfg: ModelConfig, params: dict, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """Causal-LM loss. batch: tokens (B, S) int, labels like tokens.
    Labels < 0 are masked out."""
    logits, aux = M.forward(cfg, params, batch["tokens"])
    loss, n_tok = softmax_cross_entropy(logits, batch["labels"])
    total = loss + 0.01 * aux
    return total, dict(loss=loss, aux_loss=aux, tokens=n_tok)


def make_train_step(cfg: ModelConfig, opt: Optimizer, *, accum: int = 1,
                    compress_axis: str | None = None) -> Callable:
    """Build the train step (see module docstring)."""
    _trainable(cfg)
    if compress_axis is not None:
        raise NotImplementedError(
            "compress_axis: the int8 gradient all-reduce needs a collective "
            "axis across devices, which waits for the multi-GPU item "
            "(ROADMAP Queue 1 item 8)")

    def accumulate(params, batch):
        """fp32 grads of the masters, averaged over ``accum`` microbatches,
        and the step's loss metrics."""
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        B = batch["tokens"].shape[0]
        if B % accum:
            raise ValueError(f"batch {B} is not a multiple of accum={accum}")
        mb = B // accum
        m = dict(loss=0.0, aux_loss=0.0, tokens=0.0)
        for i in range(accum):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            tot, metrics = loss_fn(cfg, M.cast_params(cfg, leaves), micro)
            tot.backward()
            metrics = {k: v.detach() for k, v in metrics.items()}
            m = dict(loss=m["loss"] + metrics["loss"] / accum,
                     aux_loss=m["aux_loss"] + metrics["aux_loss"] / accum,
                     tokens=m["tokens"] + metrics["tokens"])
            del tot, metrics
        grads = {k: v.grad for k, v in leaves.items()}
        if accum > 1:
            for g in grads.values():
                g.div_(accum)
        return grads, m

    def train_step(params, opt_state, batch):
        g, metrics = accumulate(params, batch)
        updates, opt_state, opt_metrics = opt.update(g, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, dict(metrics, **opt_metrics)

    return train_step


def make_eval_step(cfg: ModelConfig) -> Callable:
    _trainable(cfg)

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(cfg, params, batch)
        return metrics
    return eval_step


# ---------------------------------------------------------------------------
# serving steps (prefill / decode)
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig) -> Callable:
    """(params, batch) -> the next token of each row, (B,) int32 ((B,
    n_cb) for audio); the vlm family takes ``batch["patch_emb"]``."""
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = M.forward(cfg, params, batch["tokens"],
                              patch_emb=batch.get("patch_emb"),
                              last_only=True)
        return logits[:, -1].argmax(-1).to(torch.int32)
    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """One decode step: (params, cache, tokens, pos) -> (next tokens (B,)
    int32 ((B, n_cb) for audio), cache); the cache is updated in place."""
    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        logits, cache = M.decode_step(cfg, params, cache, tokens, pos)
        return logits.argmax(-1).to(torch.int32), cache
    return serve_step
