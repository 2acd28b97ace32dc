"""AdamW with fp32 master state, cosine schedule and global-norm clipping.

Twin of ``src/repro/training/optimizer.py``, as plain functions on flat
dicts of tensors (the reference's pytrees of parameters are flat dicts in
the LM stack):

    opt = adamw(peak_lr=3e-4, ...)
    state = opt.init(params)
    updates, state, metrics = opt.update(grads, state, params)
    params = apply_updates(params, updates)

The arithmetic is the reference's, in its order: clip the fp32 grads by
their global norm, then the moments ``b1 m + (1 - b1) g`` and ``b2 v +
(1 - b2) g g``, then ``u = (m / c1) / (sqrt(v / c2) + eps)`` with the bias
corrections ``c = 1 - b^t``, plus ``weight_decay * p`` for matrices, then
``-lr * u``.  ``torch.optim.AdamW`` decays the weights in another order,
so it is not used.

Unlike the reference (whose arrays are immutable), ``update`` works in
place to keep the fp32 transients of a 2 B-parameter model (8 GB for each
full set) off the card: the grads it is given are clipped in place and
then overwritten by the updates it returns, and the moments of ``state``
are updated in place (the returned state shares them).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor       # int32 scalar
    mu: Any                  # first moment  (dict like params, fp32)
    nu: Any                  # second moment (dict like params, fp32)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], AdamWState]
    update: Callable[..., tuple[Any, AdamWState, dict]]


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup -> cosine decay to ``floor * peak_lr`` (fp32)."""

    def lr(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).float()
        warm = peak_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, peak_lr * cos)

    return lr


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares, summed over the leaves in sorted key
    order (the reference's pytree order), whatever the dict's order."""
    return torch.sqrt(sum(torch.sum(torch.square(tree[k].float()))
                          for k in sorted(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree: dict, max_norm: float
                        ) -> tuple[dict, torch.Tensor]:
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return {k: x * scale for k, x in tree.items()}, norm


def adamw(peak_lr: float = 3e-4, *, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          warmup: int = 100, total_steps: int = 10_000,
          max_grad_norm: float = 1.0,
          decay_mask: Callable[[str], bool] | None = None) -> Optimizer:
    """decay_mask(name) -> apply weight decay to this param (default: only
    matrices — 1-D scales/norm params are exempt, the usual LM recipe)."""
    sched = cosine_schedule(peak_lr, warmup, total_steps)

    def init(params: dict) -> AdamWState:
        dev = next(iter(params.values())).device
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            mu={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()},
            nu={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()})

    def update(grads: dict, state: AdamWState, params: dict
               ) -> tuple[dict, AdamWState, dict]:
        step = state.step + 1
        grads = {k: g.float() for k, g in grads.items()}
        gnorm = global_norm(grads)
        scale = _clip_scale(gnorm, max_grad_norm)
        lr = sched(step)
        t = step.float()
        c1 = 1.0 - torch.pow(torch.tensor(b1, device=t.device), t)
        c2 = 1.0 - torch.pow(torch.tensor(b2, device=t.device), t)
        names = _leaf_names(params)
        for k, g in grads.items():
            g.mul_(scale)                                   # clip
            m = state.mu[k].mul_(b1).add_((1 - b1) * g)
            v = state.nu[k].mul_(b2).add_((1 - b2) * g * g)
            p = params[k]
            u = torch.div(m / c1, torch.sqrt(v / c2) + eps, out=g)
            decay = (decay_mask(names[k]) if decay_mask is not None
                     else p.dim() >= 2)
            if decay:
                u.add_(weight_decay * p.float())
            u.mul_(-lr)
        new_state = AdamWState(step=step, mu=state.mu, nu=state.nu)
        return ({k: g.to(params[k].dtype) for k, g in grads.items()},
                new_state, dict(lr=lr, grad_norm=gnorm))

    return Optimizer(init=init, update=update)


def _leaf_names(tree: dict) -> dict:
    """Each leaf's key path as ``jax.tree_util.keystr`` spells it for the
    reference's flat dict (``['embed/tok']``)."""
    return {k: f"[{k!r}]" for k in tree}


def apply_updates(params: dict, updates: dict) -> dict:
    return {k: p + updates[k].to(p.dtype) for k, p in params.items()}
