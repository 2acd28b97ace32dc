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

On a mesh the leaves are ``sharding.axes.Shards`` (each distinct shard
once, on its home device): every function here runs a shard on its own
device, and ``global_norm`` sums each element once (every shard's sum of
squares, brought to the first shard's device; a replicated leaf is one
shard, so it counts once, not once a copy).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.sharding.axes import leaf_like as _same
from repro_torch.sharding.axes import leaf_parts as _parts


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
    order (the reference's pytree order), whatever the dict's order; a
    sharded leaf's shards each once, on the first leaf's device."""
    dev = _parts(tree[min(tree)])[0].device
    return torch.sqrt(sum(torch.sum(torch.square(p.float())).to(dev)
                          for k in sorted(tree) for p in _parts(tree[k])))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree: dict, max_norm: float
                        ) -> tuple[dict, torch.Tensor]:
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return {k: _same(x, [p * scale.to(p.device) for p in _parts(x)])
            for k, x in tree.items()}, norm


def adamw(peak_lr: float = 3e-4, *, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          warmup: int = 100, total_steps: int = 10_000,
          max_grad_norm: float = 1.0,
          decay_mask: Callable[[str], bool] | None = None) -> Optimizer:
    """decay_mask(name) -> apply weight decay to this param (default: only
    matrices — 1-D scales/norm params are exempt, the usual LM recipe)."""
    sched = cosine_schedule(peak_lr, warmup, total_steps)

    def zeros(x):
        return _same(x, [torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device) for p in _parts(x)])

    def init(params: dict) -> AdamWState:
        dev = _parts(next(iter(params.values())))[0].device
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            mu={k: zeros(p) for k, p in params.items()},
            nu={k: zeros(p) for k, p in params.items()})

    def update(grads: dict, state: AdamWState, params: dict
               ) -> tuple[dict, AdamWState, dict]:
        step = state.step + 1
        grads = {k: _same(g, [p.float() for p in _parts(g)])
                 for k, g in grads.items()}
        gnorm = global_norm(grads)
        scale = _clip_scale(gnorm, max_grad_norm)
        lr = sched(step)
        t = step.float()
        c1 = 1.0 - torch.pow(torch.tensor(b1, device=t.device), t)
        c2 = 1.0 - torch.pow(torch.tensor(b2, device=t.device), t)
        on = {}                     # the step's scalars on each device

        def scalars(dev):
            if dev not in on:
                on[dev] = tuple(x.to(dev) for x in (scale, c1, c2, lr))
            return on[dev]

        names = _leaf_names(params)
        for k, gl in grads.items():
            decay = (decay_mask(names[k]) if decay_mask is not None
                     else params[k].dim() >= 2)
            for g, m, v, p in zip(_parts(gl), _parts(state.mu[k]),
                                  _parts(state.nu[k]), _parts(params[k])):
                sc, c1_, c2_, lr_ = scalars(g.device)
                g.mul_(sc)                                  # clip
                m = m.mul_(b1).add_((1 - b1) * g)
                v = v.mul_(b2).add_((1 - b2) * g * g)
                u = torch.div(m / c1_, torch.sqrt(v / c2_) + eps, out=g)
                if decay:
                    u.add_(weight_decay * p.float())
                u.mul_(-lr_)
        new_state = AdamWState(step=step, mu=state.mu, nu=state.nu)
        return ({k: _same(g, [u.to(p.dtype) for u, p in
                              zip(_parts(g), _parts(params[k]))])
                 for k, g in grads.items()},
                new_state, dict(lr=lr, grad_norm=gnorm))

    return Optimizer(init=init, update=update)


def _leaf_names(tree: dict) -> dict:
    """Each leaf's key path as ``jax.tree_util.keystr`` spells it for the
    reference's flat dict (``['embed/tok']``)."""
    return {k: f"[{k!r}]" for k in tree}


def apply_updates(params: dict, updates: dict) -> dict:
    return {k: _same(x, [p + u.to(p.dtype) for p, u in
                         zip(_parts(x), _parts(updates[k]))])
            for k, x in params.items()}
