"""Model assembly: the dense decoder family.

Twin of ``src/repro/models/model.py`` for ``family == "dense"``: pre-norm
GQA transformer blocks (optional qk-norm, RoPE), SwiGLU FFN.
The other families (moe, vlm, audio, hybrid, ssm) raise
``NotImplementedError`` (ROADMAP Queue 1 item 12).

Params are a flat ``dict[str, torch.Tensor]`` with the reference's names
and layout; stacked layer params carry a leading layer dim and the layer
loop walks it (the reference's ``lax.scan``).  ``forward`` is
differentiable; with ``cfg.remat`` and grad enabled each layer's block
runs under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``
in ``_maybe_remat``): only the layer's input is kept, and the block is
recomputed in the backward pass.  ``param_specs(cfg)`` is the
single source of truth for shapes.  The reference's sharding constraints
(``constrain``) are no-ops without a mesh and are dropped here.

Weights are cast to ``cfg.dtype`` at use, as in the reference
(``w.astype(x.dtype)``); ``cast_params`` does that cast once for a caller
that runs many steps on the same weights, with the same numbers (a cast is
elementwise and deterministic; 1-D scales stay fp32 because every use
upcasts them).

Entry points:
  forward(cfg, params, tokens)               -> (logits, aux)
  decode_step(cfg, params, cache, tok, pos)  -> (logits, cache)
  init_cache(cfg, batch, max_seq)            -> cache dict
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.kernels.dispatch import check_device
from repro_torch.models.attention import decode_attention, flash_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamSpec, apply_rope, rms_norm, swiglu

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: the port "
            f"serves the dense family (ROADMAP Queue 1 item 12)")


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def _attn_specs(cfg: ModelConfig, L: int | None, prefix: str
                ) -> dict[str, ParamSpec]:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    Ld = () if L is None else (L,)
    Lx = () if L is None else (None,)

    def S(shape, logical, **kw):
        return ParamSpec(Ld + shape, Lx + logical, **kw)

    out = {
        f"{prefix}/norm": S((d,), (None,), init="ones"),
        f"{prefix}/wq": S((d, H * hd), ("p_embed", "p_heads")),
        f"{prefix}/wk": S((d, KV * hd), ("p_embed", "p_kv")),
        f"{prefix}/wv": S((d, KV * hd), ("p_embed", "p_kv")),
        f"{prefix}/wo": S((H * hd, d), ("p_heads", "p_embed")),
    }
    if cfg.qk_norm:
        out[f"{prefix}/q_norm"] = S((hd,), (None,), init="ones")
        out[f"{prefix}/k_norm"] = S((hd,), (None,), init="ones")
    return out


def _mlp_specs(cfg: ModelConfig, L: int | None, prefix: str
               ) -> dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    Ld = () if L is None else (L,)
    Lx = () if L is None else (None,)

    def S(shape, logical, **kw):
        return ParamSpec(Ld + shape, Lx + logical, **kw)

    return {
        f"{prefix}/norm": S((d,), (None,), init="ones"),
        f"{prefix}/w1": S((d, f), ("p_embed", "p_ff")),
        f"{prefix}/w3": S((d, f), ("p_embed", "p_ff")),
        f"{prefix}/w2": S((f, d), ("p_ff", "p_embed")),
    }


def param_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    _dense_only(cfg)
    d, V, L = cfg.d_model, cfg.padded_vocab, cfg.n_layers
    specs = {
        "embed/tok": ParamSpec((V, d), ("p_vocab", "p_embed")),
        "lm_head/w": ParamSpec((d, V), ("p_embed", "p_vocab")),
        "final_norm/scale": ParamSpec((d,), (None,), init="ones"),
    }
    specs.update(_attn_specs(cfg, L, "layers/attn"))
    specs.update(_mlp_specs(cfg, L, "layers/mlp"))
    return specs


def cast_params(cfg: ModelConfig, params: dict) -> dict:
    """The fp32 masters cast once to ``cfg.dtype`` (matrices only; the
    1-D scales stay fp32).  Same numbers as the cast at every use."""
    dt = dtype_of(cfg)
    return {k: (v.to(dt) if v.dim() >= 2 else v) for k, v in params.items()}


# ---------------------------------------------------------------------------
# blocks (runtime)
# ---------------------------------------------------------------------------

def _subtree(params: dict, prefix: str) -> dict:
    pl = prefix + "/"
    return {k[len(pl):]: v for k, v in params.items() if k.startswith(pl)}


def _layers(p: dict, n: int) -> list[dict]:
    """Per-layer views of stacked params (one ``unbind`` per leaf: its
    backward stacks the layers' grads once, where indexing would build a
    full-size zero grad per layer)."""
    rows = {k: v.unbind(0) for k, v in p.items()}
    return [{k: r[i] for k, r in rows.items()} for i in range(n)]


def _qkv(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """Pre-norm projections with qk-norm: x (..., d) -> q (..., H, hd),
    k, v (..., KV, hd)."""
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    q = (h @ p["wq"].to(x.dtype)).unflatten(-1, (H, hd))
    k = (h @ p["wk"].to(x.dtype)).unflatten(-1, (KV, hd))
    v = (h @ p["wv"].to(x.dtype)).unflatten(-1, (KV, hd))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _attn_apply(cfg: ModelConfig, p: dict, x: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
    """Prefill attention sub-block (pre-norm residual inside).
    x: (B, S, d) -> (B, S, d)."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, p, x)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    if cfg.attn_impl == "pallas":
        from repro_torch.kernels.flash_attention import (
            flash_attention as flash_kernel)
        o = flash_kernel(q, k, v, True, cfg.attn_chunk_q, cfg.attn_chunk_k,
                         None)
    elif cfg.attn_impl == "xla":
        o = flash_attention(q, k, v, chunk_k=cfg.attn_chunk_k)
    else:
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}; expected "
                         f"'xla' or 'pallas'")
    return o.reshape(B, S, -1) @ p["wo"].to(x.dtype)


def _attn_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 kc: torch.Tensor, vc: torch.Tensor, pos: torch.Tensor
                 ) -> torch.Tensor:
    """One-token attention per slot. x: (B, d); kc/vc: (B, Smax, KV, hd),
    written IN PLACE at each slot's ``min(pos, Smax - 1)`` (the
    reference's ``dynamic_update_slice`` clamps its start the same way);
    pos: (B,) int64."""
    B = x.shape[0]
    q, k, v = _qkv(cfg, p, x)
    q = apply_rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    k = apply_rope(k[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    slot = torch.arange(B, device=x.device)
    at = torch.clamp(pos, max=kc.shape[1] - 1)
    kc[slot, at] = k.to(kc.dtype)
    vc[slot, at] = v.to(vc.dtype)
    o = decode_attention(q, kc, vc, pos)
    return o.reshape(B, -1) @ p["wo"].to(x.dtype)


def _mlp_apply(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    return swiglu(h, p["w1"], p["w3"], p["w2"])


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    return params["embed/tok"][tokens.long()].to(dtype)


def _lm_head(cfg: ModelConfig, params: dict, x: torch.Tensor
             ) -> torch.Tensor:
    return x @ params["lm_head/w"].to(x.dtype)


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            last_only: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. tokens: (B, S) int.  ``last_only`` computes
    the LM head on the final position only (prefill).  Returns (logits,
    aux); aux is 0 for the dense family."""
    _dense_only(cfg)
    dtype = dtype_of(cfg)
    x = _embed(cfg, params, tokens, dtype)
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)[None, :]
    attn_p = _layers(_subtree(params, "layers/attn"), cfg.n_layers)
    ff_p = _layers(_subtree(params, "layers/mlp"), cfg.n_layers)

    def block(x, ap, fp):
        x = x + _attn_apply(cfg, ap, x, pos)
        return x + _mlp_apply(cfg, fp, x)

    remat = cfg.remat and torch.is_grad_enabled()
    for ap, fp in zip(attn_p, ff_p):
        if remat:
            x = torch.utils.checkpoint.checkpoint(block, x, ap, fp,
                                                  use_reentrant=False)
        else:
            x = block(x, ap, fp)
    if last_only:
        x = x[:, -1:]
    x = rms_norm(x, params["final_norm/scale"], cfg.norm_eps)
    return _lm_head(cfg, params, x), torch.zeros((), device=x.device)


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, batch: int, max_seq: int
                ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of every leaf of the decode cache."""
    _dense_only(cfg)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv, cfg.hd)
    return {"k": (shape, dtype_of(cfg)), "v": (shape, dtype_of(cfg))}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device="cuda") -> dict[str, torch.Tensor]:
    """The decode cache, all zeros, on ``device``."""
    dev = check_device(device)
    return {name: torch.zeros(shape, dtype=dt, device=dev)
            for name, (shape, dt) in cache_specs(cfg, batch, max_seq).items()}


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, pos) -> tuple[torch.Tensor, dict]:
    """One decode step. tokens: (B,) int; pos: the cache slot the new
    token occupies, one int for the batch or (B,) per slot.  The cache is
    updated in place and returned."""
    _dense_only(cfg)
    dtype = dtype_of(cfg)
    x = params["embed/tok"][tokens.long()].to(dtype)
    B = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device).long().expand(B)
    attn_p = _layers(_subtree(params, "layers/attn"), cfg.n_layers)
    ff_p = _layers(_subtree(params, "layers/mlp"), cfg.n_layers)
    for i, (ap, fp) in enumerate(zip(attn_p, ff_p)):
        x = x + _attn_decode(cfg, ap, x, cache["k"][i], cache["v"][i], pos)
        x = x + _mlp_apply(cfg, fp, x)
    x = rms_norm(x, params["final_norm/scale"], cfg.norm_eps)
    return _lm_head(cfg, params, x), cache
