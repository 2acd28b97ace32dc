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
* **on a mesh** — under ``use_rules`` with a mesh of several devices the
  params (and the optimizer's moments) are ``shard_params``' leaves: the
  forward runs every device's share (``models.model``), the loss is the
  cross-entropy over the vocab-split logits (each device's log-sum-exp
  and label logit combined over the model axis, the token mean over the
  whole batch), and each shard's grad lands on its home device.
* **compression** — with ``compress_axis`` the step runs once a
  participant along that mesh axis (the reference's ``shard_map``
  exposing it): ``params``, ``opt_state`` and ``err`` are lists, one a
  participant, each laid out on its sub-mesh (``replicate``); the batch
  is split over the participants; each computes its grads on its rows
  under its sub-mesh's rules, and the grads cross the axis through
  ``compress.quantized_psum`` (int8 + error feedback) instead of the
  fp32 sum; each participant then updates its own copy.  Without rules
  it is one participant.

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
from repro_torch.models.layers import shard_params, softmax_cross_entropy
from repro_torch.sharding.axes import (Rules, constrain, each, leaf_like,
                                       leaf_parts, mesh_rules, use_rules)
from repro_torch.training import compress
from repro_torch.training.optimizer import Optimizer, apply_updates


def loss_fn(cfg: ModelConfig, params: dict, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """Causal-LM loss. batch: tokens (B, S[, n_cb]) int, labels like
    tokens, ``patch_emb`` (B, n_patch, d) for vlm. Labels < 0 are masked
    out.  Under mesh rules the loss is taken over the laid-out logits
    (``mesh_loss``)."""
    r = mesh_rules()
    if r is not None:
        return mesh_loss(cfg, params, batch, r)
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


def mesh_loss(cfg: ModelConfig, params: dict, batch: dict, r
              ) -> tuple[torch.Tensor, dict]:
    """``loss_fn`` over a mesh: each device's logits hold its batch rows
    and vocab columns; the log-sum-exp and the label's logit of a row are
    combined over the vocab axes on the batch shard's first device, and
    the masked token mean is taken over the whole batch on the mesh's
    first device."""
    mesh = r.mesh
    parts, aux = M.forward_parts(cfg, params, batch["tokens"],
                                 patch_emb=batch.get("patch_emb"))
    # whole on the sequence, as the logits are (``forward_parts``)
    labels = constrain(batch["labels"], "act_batch", None,
                       *((None,) * (batch["labels"].dim() - 2)))
    vax = M._ax(r.table["p_vocab"])
    dev0 = mesh.devices[0]

    def columns(j):
        """Device j's log-sum-exp and label logit over its vocab columns."""
        lab = labels[j]
        lg = parts[j]
        if cfg.family == "vlm":
            lg = lg[:, -lab.shape[1]:]
        lg = lg.float()
        v0 = M._offset(params["lm_head/w"], -1, j)
        t = lab.to(lg.device).clamp(min=0).long() - v0
        hit = (t >= 0) & (t < lg.shape[-1])
        got = torch.gather(lg, -1, t.clamp(0, lg.shape[-1] - 1)
                           [..., None])[..., 0]
        return torch.logsumexp(lg, dim=-1), torch.where(hit, got, 0.0)

    def rows(k):
        """Batch shard k's masked sums, on its first device."""
        dev = mesh.devices[k]
        lse, ll = [], 0
        for j in mesh.group(k, vax):
            lse.append(cols[j][0].to(dev))
            ll = ll + cols[j][1].to(dev)
        lse = torch.logsumexp(torch.stack(lse), dim=0)
        mask = (labels[k] >= 0).float()
        return torch.sum((lse - ll) * mask), torch.sum(mask)

    cols = each(mesh, columns)
    nll = n = 0
    for s, c in each(mesh, rows,
                     over=mesh.group(0, M._ax(r.table["act_batch"]))):
        nll = nll + s.to(dev0)
        n = n + c.to(dev0)
    n = torch.clamp(n, min=1.0)
    loss = nll / n
    return loss + 0.01 * aux, dict(loss=loss, aux_loss=aux, tokens=n)


def replicate(params: dict, specs: dict, rules: Rules, axis: str) -> list:
    """One copy of whole ``params`` a participant along mesh ``axis``,
    each laid out on its sub-mesh under ``rules``' table (plain tensors on
    the participant's device when its sub-mesh is one device): the
    ``params`` / ``opt_state`` form a ``compress_axis`` step takes."""
    out = []
    for i in range(rules.mesh.shape[axis]):
        sub = rules.mesh.take(axis, i)
        if sub.size == 1:
            out.append({k: v.to(sub.devices[0], copy=True)
                        for k, v in params.items()})
        else:
            out.append(shard_params(params, specs,
                                    Rules(table=rules.table, mesh=sub)))
    return out


def train_cast(cfg: ModelConfig, params: dict) -> dict:
    """The train step's one cast of the fp32 masters to ``cfg.dtype``:
    every leaf of two or more dims (the reference's ``cast_params``
    closure in ``make_train_step``); 1-D scales stay fp32."""
    dt = M.dtype_of(cfg)
    if dt == torch.float32:
        return params
    return {k: (M.cast_leaf(v, dt) if v.dim() >= 2 else v)
            for k, v in params.items()}


def _leaf(v):
    """A fresh leaf of the autograd graph over ``v``'s values."""
    return leaf_like(v, [p.detach().requires_grad_(True)
                         for p in leaf_parts(v)])


def _grad(v):
    return leaf_like(v, [p.grad for p in leaf_parts(v)])


def make_train_step(cfg: ModelConfig, opt: Optimizer, *, accum: int = 1,
                    compress_axis: str | None = None) -> Callable:
    """Build the train step (see module docstring)."""

    def accumulate(params, batch):
        """fp32 grads of the masters, averaged over ``accum`` microbatches,
        and the step's loss metrics."""
        leaves = {k: _leaf(v) for k, v in params.items()}
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
        grads = {k: _grad(v) for k, v in leaves.items()}
        if accum > 1:
            for g in grads.values():
                for p in leaf_parts(g):
                    p.div_(accum)
        return grads, m

    def train_step(params, opt_state, batch):
        g, metrics = accumulate(params, batch)
        updates, opt_state, opt_metrics = opt.update(g, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, dict(metrics, **opt_metrics)

    if compress_axis is None:
        return train_step

    def compressed_step(params, opt_state, batch, err):
        r = mesh_rules()
        one = isinstance(params, dict)
        if one:                              # one participant, no mesh
            params, opt_state, err = [params], [opt_state], [err]
        n = len(params)
        if r is not None and r.mesh.shape[compress_axis] != n:
            raise ValueError(f"{n} participants for the {compress_axis!r} "
                             f"axis of {r.mesh.shape[compress_axis]}")
        subs = [None if r is None else
                r.mesh.take(compress_axis, i) for i in range(n)]
        B = batch["tokens"].shape[0]
        if B % n:
            raise ValueError(f"batch {B} does not split over {n} "
                             f"participants")
        grads, mets = [], []
        for i in range(n):
            rows = {k: v[i * B // n:(i + 1) * B // n]
                    for k, v in batch.items()}
            sub = subs[i]
            dev = (sub.devices[0] if sub is not None
                   else next(iter(params[i].values())).device)
            rows = {k: v.to(dev) for k, v in rows.items()}
            with use_rules(None if sub is None else
                           Rules(table=r.table, mesh=sub)):
                g, m = accumulate(params[i], rows)
            grads.append(g)
            mets.append(m)
        red, err = compress.quantized_psum(grads, compress_axis, err)
        out_p, out_o, out_m = [], [], []
        for i in range(n):
            updates, o, om = opt.update(red[i], opt_state[i], params[i])
            out_p.append(apply_updates(params[i], updates))
            out_o.append(o)
            out_m.append(dict(mets[i], **om))
        dev0 = out_m[0]["loss"].device
        metrics = dict(out_m[0], loss=sum(m["loss"].to(dev0)
                                          for m in out_m) / n)
        if one:
            return out_p[0], out_o[0], metrics, err[0]
        return out_p, out_o, metrics, err

    return compressed_step


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
