"""Mixture-of-Experts FFN: grouped top-k capacity dispatch.

Twin of ``src/repro/models/moe.py``.  Tokens are split into groups of
``group``; each group routes its tokens to a per-group expert capacity
``C = int(g * k * cf / E + 1)`` through one-hot dispatch / combine
einsums, so every shape is static.  Tokens past an expert's capacity are
dropped (their weight stays in the renormalised gate, as in the
reference).  The router runs in fp32 and returns the Switch-style
load-balance aux loss.  No kernel: the products are the reference's
plain einsums.

A decode step routes its (B, 1) tokens as one group of B
(``decode_step``, as the reference's does); the served loop gives each
slot a group of its own (``launch/serve.py``), which is what the
reference's vmapped one-slot decode computes.

On a mesh each device holds ``E / m`` experts (``p_expert`` over the
model axis): it routes its tokens over every expert (the router is
replicated), runs only its own (``experts=(e0, e1)``) and returns its
share of the combine, which the caller sums over the model axis; with
``stats=True`` it returns the load-balance statistics (the token
fraction and mean probability per expert) for the caller to average over
the batch shards before forming the aux loss (``moe_aux``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding.axes import constrain


def top_k_lower_first(x: torch.Tensor, k: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of the last dim, ties to the lower index (as
    ``jax.lax.top_k``): a stable descending sort, which ``torch.topk``
    does not promise on the card."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def moe_ffn(x: torch.Tensor, wg: torch.Tensor, w1: torch.Tensor,
            w3: torch.Tensor, w2: torch.Tensor, *, top_k: int,
            capacity_factor: float, group: int, experts=None,
            stats: bool = False):
    """x: (B, S, d); wg (d, E), w1 / w3 (E, d, f), w2 (E, f, d) (with
    ``experts=(e0, e1)``: only experts e0..e1-1).  Returns (out (B, S,
    d), aux_loss 0-d fp32), or (out, (frac, imp)) with ``stats``."""
    B, S, d = x.shape
    E = wg.shape[1]
    T = B * S
    g = min(group, T)
    assert T % g == 0, (T, g)
    G = T // g
    k = top_k
    C = int((g * k * capacity_factor) / E + 1)
    C = min(C, g * k)

    xg = x.reshape(G, g, d)
    xg = constrain(xg, "act_group", None, "act_embed")
    logits = torch.einsum("Gtd,de->Gte", xg.float(), wg.float())
    probs = torch.softmax(logits, dim=-1)                 # (G, g, E)
    gate_v, gate_i = top_k_lower_first(probs, k)          # (G, g, k)
    gate_v = gate_v / torch.clamp(gate_v.sum(-1, keepdim=True), min=1e-9)

    # flatten (token, slot) and compute expert-queue positions
    oh = F.one_hot(gate_i.reshape(G, g * k), E).int()    # (G, gk, E)
    pos = torch.cumsum(oh, dim=1) - oh                    # (G, gk, E)
    keep = (pos < C) & (oh > 0)
    posC = pos[..., None] == torch.arange(C, device=x.device)  # (G,gk,E,C)
    disp = keep[..., None] & posC
    if experts is not None:                               # this device's
        disp = disp[:, :, experts[0]:experts[1]]

    x_slot = torch.repeat_interleave(xg, k, dim=1)        # (G, gk, d)
    xd = torch.einsum("GtEC,Gtd->GECd", disp.to(x.dtype), x_slot)
    xd = constrain(xd, "act_group", "act_expert", None, "act_embed")
    h = torch.einsum("GECd,Edf->GECf", xd, w1.to(x.dtype))
    gate = torch.einsum("GECd,Edf->GECf", xd, w3.to(x.dtype))
    h = F.silu(gate) * h
    h = constrain(h, "act_group", "act_expert", None, "act_ff")
    y = torch.einsum("GECf,Efd->GECd", h, w2.to(x.dtype))

    comb = disp.float() * gate_v.reshape(G, g * k)[..., None, None]
    out = torch.einsum("GtEC,GECd->Gtd", comb.to(x.dtype), y)
    # t indexes (token, slot): fold the k slots back per token
    out = out.reshape(G, g, k, d).sum(dim=2).reshape(B, S, d)

    # Switch-style load-balance aux loss
    frac = oh.reshape(G, g, k, E).sum(2).float().mean(dim=(0, 1))
    imp = probs.mean(dim=(0, 1))
    if stats:
        return out, (frac, imp)
    return out, moe_aux(frac, imp, k)


def moe_aux(frac: torch.Tensor, imp: torch.Tensor, top_k: int
            ) -> torch.Tensor:
    """The Switch load-balance loss from the per-expert token fraction and
    mean router probability."""
    return frac.shape[-1] * torch.sum(frac * imp) / top_k
