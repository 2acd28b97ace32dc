"""Train, eval and serving step builders.

Twin of ``src/repro/training/step.py``.  ``make_train_step(cfg, opt,
...)`` returns

    (params, opt_state, batch) -> (params, opt_state, metrics)

* **mixed precision** — master params and optimizer moments are fp32; the
  fp32 masters are cast once to ``cfg.dtype`` inside the graph (every
  leaf of two or more dims, as the reference's ``cast_params`` closure:
  the hybrid family's stacked ``a_log`` and ``d_skip`` too, which the
  serving cast ``models.model.cast_params`` keeps in fp32), so the grads
  reach the masters in fp32.  Loss/softmax in fp32.
* **gradient accumulation** — ``accum`` microbatches (the batch's leading
  dim split in ``accum`` slices) each run forward and backward, their
  grads summing into the masters' fp32 ``.grad``; the sum is then divided
  by ``accum``.  Only one microbatch's activations and one fp32 grad set
  live at a time.
* **compression** — ``compress_axis`` needs a collective axis across
  devices; it raises until the multi-GPU item (ROADMAP Queue 1 item 8).

The metrics are ``loss``, ``aux_loss``, ``tokens``, ``lr`` and
``grad_norm``, as 0-d tensors.  Every step takes every family: the vlm
loss is taken on the text positions only, audio's (B, S, n_cb) labels
against its (B, S, n_cb, V) logits, and moe's load-balance aux enters the
total at 0.01.  The serving steps run under ``torch.no_grad()``: serving
keeps no graph.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import softmax_cross_entropy
from repro_torch.training.optimizer import Optimizer, apply_updates


def loss_fn(cfg: ModelConfig, params: dict, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """Causal-LM loss. batch: tokens (B, S[, n_cb]) int, labels like
    tokens, ``patch_emb`` (B, n_patch, d) for vlm. Labels < 0 are masked
    out."""
    logits, aux = M.forward(cfg, params, batch["tokens"],
                            patch_emb=batch.get("patch_emb"))
    labels = batch["labels"]
    if cfg.family == "vlm":
        # the logits cover the patch prefix and the text: loss on the text
        logits = logits[:, -labels.shape[1]:]
    # audio: (B, S, n_cb) labels against (B, S, n_cb, V) logits, each
    # codebook position counted like another sequence position
    loss, n_tok = softmax_cross_entropy(logits, labels)
    total = loss + 0.01 * aux
    return total, dict(loss=loss, aux_loss=aux, tokens=n_tok)


def train_cast(cfg: ModelConfig, params: dict) -> dict:
    """The train step's one cast of the fp32 masters to ``cfg.dtype``:
    every leaf of two or more dims (the reference's ``cast_params``
    closure in ``make_train_step``); 1-D scales stay fp32."""
    dt = M.dtype_of(cfg)
    if dt == torch.float32:
        return params
    return {k: (v.to(dt) if v.dim() >= 2 else v) for k, v in params.items()}


def make_train_step(cfg: ModelConfig, opt: Optimizer, *, accum: int = 1,
                    compress_axis: str | None = None) -> Callable:
    """Build the train step (see module docstring)."""
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
            tot, metrics = loss_fn(cfg, train_cast(cfg, leaves), micro)
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
