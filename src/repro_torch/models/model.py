"""Model assembly for the six model families.

Twin of ``src/repro/models/model.py``, driven by ``ModelConfig.family``:

* dense / moe / vlm / audio: pre-norm GQA transformer blocks (optional
  qk-norm, RoPE), a SwiGLU or MoE FFN; vlm prepends ``patch_emb`` rows,
  audio sums its codebooks' embeddings and has one LM head a codebook.
* hybrid (zamba2): a Mamba2 (SSD) backbone with ONE weight-shared
  attention + MLP block after every ``attn_every`` layers, each
  application with its own KV cache at decode.
* ssm (xlstm): mLSTM blocks with an sLSTM block every ``slstm_every``.

The attention of every family but ssm reaches the K7 kernel with
``attn_impl="pallas"`` exactly where the reference reaches
``flash_attention_pallas`` (the hybrid's shared block included).

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
elementwise and deterministic; 1-D scales and the SSM's ``a_log`` /
``d_skip``, which every use reads in fp32, stay fp32).

Entry points:
  forward(cfg, params, tokens, patch_emb=)   -> (logits, aux)
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
from repro_torch.models.moe import moe_ffn
from repro_torch.models.ssm import mamba2_block
from repro_torch.models.xlstm import mlstm_block, slstm_block

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the families of pre-norm attention blocks with a KV cache a layer
_ATTN_FAMILIES = ("dense", "vlm", "audio", "moe")
# leaves that every use reads in fp32 though they are stacked 2-D:
# cast_params leaves them as they are
_FP32_LEAVES = ("a_log", "d_skip")


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


def _moe_specs(cfg: ModelConfig, L: int, prefix: str
               ) -> dict[str, ParamSpec]:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        f"{prefix}/norm": ParamSpec((L, d), (None, None), init="ones"),
        f"{prefix}/wg": ParamSpec((L, d, E), (None, "p_embed", None)),
        f"{prefix}/w1": ParamSpec((L, E, d, f),
                                  (None, "p_expert", "p_embed", None)),
        f"{prefix}/w3": ParamSpec((L, E, d, f),
                                  (None, "p_expert", "p_embed", None)),
        f"{prefix}/w2": ParamSpec((L, E, f, d),
                                  (None, "p_expert", None, "p_embed")),
    }


def _mamba_specs(cfg: ModelConfig, L: int, prefix: str
                 ) -> dict[str, ParamSpec]:
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H, K = cfg.ssm_heads, cfg.ssm_conv
    return {
        f"{prefix}/norm": ParamSpec((L, d), (None, None), init="ones"),
        f"{prefix}/in_proj": ParamSpec(
            (L, d, 2 * di + 2 * N + H), (None, "p_embed", "p_inner")),
        f"{prefix}/conv_w": ParamSpec(
            (L, K, di + 2 * N), (None, None, "p_inner"), scale=0.5),
        f"{prefix}/a_log": ParamSpec((L, H), (None, None), init="zeros"),
        f"{prefix}/dt_bias": ParamSpec((L, H), (None, None), init="zeros"),
        f"{prefix}/d_skip": ParamSpec((L, H), (None, None), init="ones"),
        f"{prefix}/norm_inner": ParamSpec((L, di), (None, "p_inner"),
                                          init="ones"),
        f"{prefix}/out_proj": ParamSpec((L, di, d),
                                        (None, "p_inner", "p_embed")),
    }


def _mlstm_specs(cfg: ModelConfig, L: int, prefix: str
                 ) -> dict[str, ParamSpec]:
    d = cfg.d_model
    di = cfg.mlstm_proj * d
    H, K = cfg.n_heads, cfg.ssm_conv
    return {
        f"{prefix}/norm": ParamSpec((L, d), (None, None), init="ones"),
        f"{prefix}/up_proj": ParamSpec((L, d, 2 * di),
                                       (None, "p_embed", "p_inner")),
        f"{prefix}/conv_w": ParamSpec((L, K, di), (None, None, "p_inner"),
                                      scale=0.5),
        # block-diagonal per-head projections: H blocks of (P, P)
        f"{prefix}/wq": ParamSpec((L, H, di // H, di // H),
                                  (None, None, "p_inner", None)),
        f"{prefix}/wk": ParamSpec((L, H, di // H, di // H),
                                  (None, None, "p_inner", None)),
        f"{prefix}/wv": ParamSpec((L, H, di // H, di // H),
                                  (None, None, "p_inner", None)),
        f"{prefix}/wi": ParamSpec((L, di, H), (None, "p_inner", None)),
        f"{prefix}/wf": ParamSpec((L, di, H), (None, "p_inner", None)),
        f"{prefix}/norm_inner": ParamSpec((L, di), (None, "p_inner"),
                                          init="ones"),
        f"{prefix}/down_proj": ParamSpec((L, di, d),
                                         (None, "p_inner", "p_embed")),
    }


def _slstm_specs(cfg: ModelConfig, L: int, prefix: str
                 ) -> dict[str, ParamSpec]:
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    ff = ((4 * d // 3) + 127) // 128 * 128
    return {
        f"{prefix}/norm": ParamSpec((L, d), (None, None), init="ones"),
        f"{prefix}/w_gates": ParamSpec((L, d, H * dh * 4),
                                       (None, "p_embed", "p_inner")),
        f"{prefix}/r_gates": ParamSpec((L, H, dh, dh * 4),
                                       (None, None, None, None),
                                       scale=0.5),
        f"{prefix}/ln": ParamSpec((L, d), (None, None), init="ones"),
        f"{prefix}/up": ParamSpec((L, d, ff), (None, "p_embed", "p_ff")),
        f"{prefix}/down": ParamSpec((L, ff, d), (None, "p_ff", "p_embed")),
    }


def _n_slstm(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.slstm_every if cfg.slstm_every else 0


def param_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    d, V, L = cfg.d_model, cfg.padded_vocab, cfg.n_layers
    specs: dict[str, ParamSpec] = {}
    if cfg.family == "audio":
        specs["embed/tok"] = ParamSpec(
            (cfg.n_codebooks, V, d), (None, "p_vocab", "p_embed"))
        specs["lm_head/w"] = ParamSpec(
            (cfg.n_codebooks, d, V), (None, "p_embed", "p_vocab"))
    else:
        specs["embed/tok"] = ParamSpec((V, d), ("p_vocab", "p_embed"))
        specs["lm_head/w"] = ParamSpec((d, V), ("p_embed", "p_vocab"))
    specs["final_norm/scale"] = ParamSpec((d,), (None,), init="ones")

    if cfg.family in ("dense", "vlm", "audio"):
        specs.update(_attn_specs(cfg, L, "layers/attn"))
        specs.update(_mlp_specs(cfg, L, "layers/mlp"))
    elif cfg.family == "moe":
        specs.update(_attn_specs(cfg, L, "layers/attn"))
        specs.update(_moe_specs(cfg, L, "layers/moe"))
    elif cfg.family == "hybrid":
        specs.update(_mamba_specs(cfg, L, "layers/mamba"))
        specs.update(_attn_specs(cfg, None, "shared/attn"))
        specs.update(_mlp_specs(cfg, None, "shared/mlp"))
    elif cfg.family == "ssm":
        n_s = _n_slstm(cfg)
        specs.update(_mlstm_specs(cfg, L - n_s, "mblocks"))
        if n_s:
            specs.update(_slstm_specs(cfg, n_s, "sblocks"))
    else:
        raise ValueError(cfg.family)
    return specs


def cast_params(cfg: ModelConfig, params: dict) -> dict:
    """The fp32 masters cast once to ``cfg.dtype`` (matrices only; the
    1-D scales, ``a_log`` and ``d_skip`` stay fp32).  Same numbers as the
    cast at every use."""
    dt = dtype_of(cfg)
    return {k: (v.to(dt) if v.dim() >= 2
                and k.rsplit("/", 1)[-1] not in _FP32_LEAVES else v)
            for k, v in params.items()}


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


def _moe_apply(cfg: ModelConfig, p: dict, x: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    return moe_ffn(h, p["wg"], p["w1"], p["w3"], p["w2"], top_k=cfg.top_k,
                   capacity_factor=cfg.capacity_factor, group=cfg.moe_group)


def _residual(x: torch.Tensor, p: dict, block, cfg: ModelConfig, **kw):
    """x + block(rms_norm(x), p, cfg, **kw) and the block's state (a
    Mamba2, mLSTM or sLSTM layer's pre-norm residual)."""
    out, state = block(rms_norm(x, p["norm"], cfg.norm_eps), p, cfg, **kw)
    return x + out, state


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    emb = params["embed/tok"]
    tokens = tokens.long()
    if cfg.family == "audio":
        # tokens (..., n_cb): the sum of the codebooks' embeddings
        x = sum(emb[i][tokens[..., i]] for i in range(cfg.n_codebooks))
    else:
        x = emb[tokens]
    return x.to(dtype)


def _lm_head(cfg: ModelConfig, params: dict, x: torch.Tensor
             ) -> torch.Tensor:
    w = params["lm_head/w"].to(x.dtype)
    if cfg.family == "audio":
        return torch.einsum("...d,cdv->...cv", x, w)
    return x @ w


def _run(cfg: ModelConfig, block, *args):
    """``block(*args)``, under ``torch.utils.checkpoint`` when ``cfg.remat``
    and grad are on (the reference's ``_maybe_remat``)."""
    if cfg.remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(block, *args,
                                                 use_reentrant=False)
    return block(*args)


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            patch_emb: torch.Tensor | None = None, last_only: bool = False
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. tokens: (B, S) int ((B, S, n_cb) for audio).
    For the vlm family ``patch_emb`` (B, n_patch, d_model) is prepended.
    ``last_only`` computes the LM head on the final position only
    (prefill).  Returns (logits, aux): aux is the moe family's load-balance
    loss summed over the layers, else 0."""
    dtype = dtype_of(cfg)
    x = _embed(cfg, params, tokens, dtype)
    if cfg.family == "vlm":
        assert patch_emb is not None
        x = torch.cat([patch_emb.to(dtype), x], dim=1)
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)[None, :]
    aux = torch.zeros((), device=x.device)

    if cfg.family in _ATTN_FAMILIES:
        attn_p = _layers(_subtree(params, "layers/attn"), cfg.n_layers)
        ff_p = _layers(_subtree(params, "layers/moe" if cfg.is_moe
                                else "layers/mlp"), cfg.n_layers)

        def block(x, ap, fp):
            x = x + _attn_apply(cfg, ap, x, pos)
            if cfg.is_moe:
                f_out, a = _moe_apply(cfg, fp, x)
                return x + f_out, a
            return x + _mlp_apply(cfg, fp, x), aux

        auxs = []
        for ap, fp in zip(attn_p, ff_p):
            x, a = _run(cfg, block, x, ap, fp)
            auxs.append(a)
        aux = torch.stack(auxs).sum()
    elif cfg.family == "hybrid":
        x = _zamba_forward(cfg, params, x, pos)
    elif cfg.family == "ssm":
        x = _xlstm_forward(cfg, params, x)

    if last_only:
        x = x[:, -1:]
    x = rms_norm(x, params["final_norm/scale"], cfg.norm_eps)
    return _lm_head(cfg, params, x), aux


def _shared_block(cfg: ModelConfig, params: dict, x: torch.Tensor,
                  pos: torch.Tensor) -> torch.Tensor:
    x = x + _attn_apply(cfg, _subtree(params, "shared/attn"), x, pos)
    return x + _mlp_apply(cfg, _subtree(params, "shared/mlp"), x)


def _zamba_forward(cfg: ModelConfig, params: dict, x: torch.Tensor,
                   pos: torch.Tensor) -> torch.Tensor:
    """The Mamba2 layers in groups of ``attn_every``, the shared block
    after each whole group, then the rest (81 = 13 x 6 + 3)."""
    k = cfg.attn_every
    mp = _layers(_subtree(params, "layers/mamba"), cfg.n_layers)

    def mamba(x, p):
        return _residual(x, p, mamba2_block, cfg)[0]

    for i, p in enumerate(mp):
        x = _run(cfg, mamba, x, p)
        if (i + 1) % k == 0:
            x = _run(cfg, lambda y: _shared_block(cfg, params, y, pos), x)
    return x


def _xlstm_forward(cfg: ModelConfig, params: dict, x: torch.Tensor
                   ) -> torch.Tensor:
    """Groups of ``slstm_every - 1`` mLSTM blocks, each followed by one
    sLSTM block, then the mLSTM blocks left over."""
    n_s = _n_slstm(cfg)
    mp = _layers(_subtree(params, "mblocks"), cfg.n_layers - n_s)
    sp = _layers(_subtree(params, "sblocks"), n_s) if n_s else []
    per = cfg.slstm_every - 1 if n_s else 0

    def m_body(x, p):
        return _residual(x, p, mlstm_block, cfg)[0]

    def s_body(x, p):
        return _residual(x, p, slstm_block, cfg)[0]

    for g in range(n_s):
        for p in mp[g * per:(g + 1) * per]:
            x = _run(cfg, m_body, x, p)
        x = _run(cfg, s_body, x, sp[g])
    for p in mp[n_s * per:]:
        x = _run(cfg, m_body, x, p)
    return x


# ---------------------------------------------------------------------------
# KV / state caches + decode
# ---------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, batch: int, max_seq: int
                ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of every leaf of the decode cache: the reference's
    names and shapes, the recurrent state in fp32."""
    dt, f32 = dtype_of(cfg), torch.float32
    B, S = batch, max_seq
    KV, hd, L = cfg.n_kv, cfg.hd, cfg.n_layers
    if cfg.family in _ATTN_FAMILIES:
        return {"k": ((L, B, S, KV, hd), dt), "v": ((L, B, S, KV, hd), dt)}
    if cfg.family == "hybrid":
        H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
        n_apps = L // cfg.attn_every
        return {
            "ssm_h": ((L, B, H, N, P), f32),
            "conv": ((L, B, cfg.ssm_conv - 1, cfg.d_inner + 2 * N), dt),
            "k": ((n_apps, B, S, KV, hd), dt),
            "v": ((n_apps, B, S, KV, hd), dt),
        }
    if cfg.family == "ssm":
        n_s = _n_slstm(cfg)
        n_m = L - n_s
        di = cfg.mlstm_proj * cfg.d_model
        H = cfg.n_heads
        P, dh = di // H, cfg.d_model // H
        out = {
            "mC": ((n_m, B, H, P, P), f32),
            "mn": ((n_m, B, H, P), f32),
            "mm": ((n_m, B, H), f32),
            "mconv": ((n_m, B, cfg.ssm_conv - 1, di), dt),
        }
        for nm in ("sc", "sn", "sm", "sh") if n_s else ():
            out[nm] = ((n_s, B, H, dh), f32)
        return out
    raise ValueError(cfg.family)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device="cuda") -> dict[str, torch.Tensor]:
    """The decode cache, all zeros, on ``device``."""
    dev = check_device(device)
    return {name: torch.zeros(shape, dtype=dt, device=dev)
            for name, (shape, dt) in cache_specs(cfg, batch, max_seq).items()}


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, pos) -> tuple[torch.Tensor, dict]:
    """One decode step. tokens: (B,) int ((B, n_cb) for audio); pos: the
    cache slot the new token occupies, one int for the batch or (B,) per
    slot.  The recurrent state advances whatever ``pos`` is.  The moe
    family routes the B tokens in groups of ``cfg.moe_group``, as the
    reference's decode does.  The cache is updated in place and
    returned."""
    dtype = dtype_of(cfg)
    x = _embed(cfg, params, tokens, dtype)
    B = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device).long().expand(B)

    if cfg.family in _ATTN_FAMILIES:
        attn_p = _layers(_subtree(params, "layers/attn"), cfg.n_layers)
        ff_p = _layers(_subtree(params, "layers/moe" if cfg.is_moe
                                else "layers/mlp"), cfg.n_layers)
        for i, (ap, fp) in enumerate(zip(attn_p, ff_p)):
            x = x + _attn_decode(cfg, ap, x, cache["k"][i], cache["v"][i],
                                 pos)
            if cfg.is_moe:
                f_out, _ = _moe_apply(cfg, fp, x[:, None])
                x = x + f_out[:, 0]
            else:
                x = x + _mlp_apply(cfg, fp, x)
    elif cfg.family == "hybrid":
        x = _zamba_decode(cfg, params, cache, x, pos)
    elif cfg.family == "ssm":
        x = _xlstm_decode(cfg, params, cache, x)

    x = rms_norm(x, params["final_norm/scale"], cfg.norm_eps)
    return _lm_head(cfg, params, x), cache


def _zamba_decode(cfg, params, cache, x, pos):
    """One token through the Mamba2 layers (state written into
    ``ssm_h`` / ``conv``) and the shared block's applications (each into
    its own KV cache)."""
    k = cfg.attn_every
    ap = _subtree(params, "shared/attn")
    mlp = _subtree(params, "shared/mlp")
    for i, p in enumerate(_layers(_subtree(params, "layers/mamba"),
                                  cfg.n_layers)):
        x, (sh, cv) = _residual(
            x, p, mamba2_block, cfg, decode=True,
            state=(cache["ssm_h"][i], cache["conv"][i]))
        cache["ssm_h"][i].copy_(sh)
        cache["conv"][i].copy_(cv)
        if (i + 1) % k == 0:
            a = (i + 1) // k - 1               # the shared block's a-th use
            x = x + _attn_decode(cfg, ap, x, cache["k"][a], cache["v"][a],
                                 pos)
            x = x + _mlp_apply(cfg, mlp, x)
    return x


def _xlstm_decode(cfg, params, cache, x):
    """One token through the mLSTM and sLSTM blocks in the forward's
    order, each block's state written into its cache rows."""
    n_s = _n_slstm(cfg)
    mp = _layers(_subtree(params, "mblocks"), cfg.n_layers - n_s)
    sp = _layers(_subtree(params, "sblocks"), n_s) if n_s else []
    per = cfg.slstm_every - 1 if n_s else 0

    def m_step(x, j):
        st = ((cache["mC"][j], cache["mn"][j], cache["mm"][j]),
              cache["mconv"][j])
        x, ((C, n, m), cv) = _residual(x, mp[j], mlstm_block, cfg,
                                       state=st, decode=True)
        for name, t in (("mC", C), ("mn", n), ("mm", m), ("mconv", cv)):
            cache[name][j].copy_(t)
        return x

    def s_step(x, j):
        st = tuple(cache[nm][j] for nm in ("sc", "sn", "sm", "sh"))
        x, new = _residual(x, sp[j], slstm_block, cfg, state=st,
                           decode=True)
        for nm, t in zip(("sc", "sn", "sm", "sh"), new):
            cache[nm][j].copy_(t)
        return x

    for g in range(n_s):
        for j in range(g * per, (g + 1) * per):
            x = m_step(x, j)
        x = s_step(x, g)
    for j in range(n_s * per, len(mp)):
        x = m_step(x, j)
    return x
