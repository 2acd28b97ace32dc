"""Serving step builders (prefill / decode).

Twin of the serving half of ``src/repro/training/step.py``
(``make_prefill_step``, ``make_serve_step``).  ``loss_fn`` and the train
step wait for the training slice, with K7's backward kernels (ROADMAP
Queue 2).  The steps run under ``torch.no_grad()``: serving keeps no
graph, and the K7 wrapper refuses tensors that require grad.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """(params, batch) -> the next token of each row (B,) int32."""
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = M.forward(cfg, params, batch["tokens"], last_only=True)
        return logits[:, -1].argmax(-1).to(torch.int32)
    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """One decode step: (params, cache, tokens, pos) -> (next tokens (B,)
    int32, cache); the cache is updated in place."""
    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        logits, cache = M.decode_step(cfg, params, cache, tokens, pos)
        return logits.argmax(-1).to(torch.int32), cache
    return serve_step
