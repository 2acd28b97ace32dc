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
single source of truth for shapes and logical axes.

**On a mesh** (``forward`` / ``decode_step`` under ``use_rules`` whose
mesh has several devices; params from ``layers.shard_params``, a
serving loop's placed once with ``Shards.place``): one process runs
every device's share in turn, each on its device, with the collectives
of ``sharding/collectives.py`` between them:

* the batch is laid out over ``act_batch`` (``constrain`` at the
  reference's :331 / :531 sites); a device runs its batch rows;
* Megatron sequence parallelism: where the table's ``act_seq`` splits
  the sequence over ``model`` (``_seq_split``; the :331 site), a device
  holds ``S / m`` positions of its batch rows' residual stream between
  sub-blocks.  A sub-block's remat frame takes its group's shards as its
  inputs, all-gathers the whole sequence inside the frame (``_gathered``:
  the backward gathers it again, nothing whole is saved), runs its
  pre-norm and mixer on it, and its row-parallel partial sums are
  reduce-scattered along the sequence (``_seq_sum``) onto the shard the
  residual adds to.  Where ``act_seq`` is None (or ``make_rules``
  dropped it: ``model`` does not divide S) the stream is whole and the
  partial sums all-reduced.  Positions stay whole (RoPE, K7 on the
  gathered sequence); decode has no sequence dim;
* ``wq`` / ``wk`` / ``wv`` and ``w1`` / ``w3`` are split by columns over
  ``model``, so a device runs its heads (and its K7 calls on them) and
  its ff columns; ``wo`` / ``w2`` are split by rows, and their partial
  sums are summed over ``model`` (``_seq_sum``).  Where ``model`` does not divide
  the kv heads (8 at model=16) a device takes the ``wk`` / ``wv``
  columns of the kv heads its q heads read; where it does not divide
  the q heads either (24 at model=16) every device runs every head, ``wq``
  / ``wk`` / ``wv`` taken whole, and its rows of ``wo`` (``_attn_plan``);
* moe: a device runs its ``E / m`` experts (``p_expert``) over its
  group's tokens, and the outputs are summed over ``model``;
* the token embedding and the LM head are split over the vocab
  (``p_vocab``): a device looks up the token rows it holds at every
  position (the others' rows add zeros; the sum reduce-scattered to the
  sequence's shards) and, the final norm run on its shard and the
  sequence gathered, computes its vocab columns of the logits (the :311
  site's ``act_vocab`` layout, kept for the train loss, gathered for a
  caller of ``forward``);
* under ``train_rules`` every weight's ``p_embed`` dim is split over
  ``data`` (FSDP) and all-gathered inside each layer's block, inside
  remat, so the gathered weights are freed after use and gathered again
  in the backward, whose copies reduce-scatter the grads;
* decode: the KV cache is laid out over ``cache_batch`` / ``cache_seq``
  / ``act_kv``; with ``act_kv`` split a device attends over its kv heads,
  and with ``cache_seq`` split every device attends over its chunk of
  the sequence for all heads (q, k, v gathered over ``model``) and the
  chunks merge by logsumexp.

* hybrid and ssm: a device runs whole heads of every recurrent block,
  ``p_inner`` / ``act_inner`` split over ``model`` (``_inner``): the
  columns of a split projection its heads read are taken, a layer at a
  time and inside the layer's remat frame, from the shards that hold
  them (``Shards.take``: Mamba2's z / x / dt columns and the shared
  B / C, which ``in_proj``'s flat split does not align with the heads;
  the mLSTM's P x P blocks); a norm over the whole d_inner takes its
  sum of squares all-reduced, the mLSTM's gate pre-activations (a sum
  over d_inner) are all-reduced, the sLSTM's heads' outputs all-gathered
  before its norm over d, and ``out_proj`` / ``down_proj`` sum their
  partial products like ``wo`` (the xLSTM's sums in fp32, rounded once:
  ``_sum_fp32``, ``_seq_sum``); in prefill the conv, the chunked SSD and
  the sLSTM's time loop run on the sequence gathered inside the block's
  first frame; the hybrid's shared block splits as the attention
  families'.  At decode a device reads and writes its heads'
  state; the Mamba2 conv cache stays split over d_inner + 2N as the
  reference's (each device takes its channels and puts them back), the
  xLSTM's state is laid out over its heads (``mesh_cache_axes``;
  ROADMAP Queue 3).  Where ``model`` does not divide the ssm family's
  heads (xlstm-1.3b's 4 at model=8 or 16) a device runs its rows of P,
  the head dim, in every head, the reference's split
  (``_mesh_mlstm_rows``), and the sLSTM runs every head on every device.

Under ``sharding.axes.lead()`` (the dry run, ``launch/dryrun.py``) every
per-device computation is ``each(mesh, fn)``: device 0's share alone.

Inside the attention sub-block a device runs its heads over the whole
gathered sequence, where the reference lays ``q`` out over ``act_seq``
(the :234 site, its context-parallel flash loop): ROADMAP Queue 3.

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

import dataclasses

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.kernels.dispatch import check_device
from repro_torch.models.attention import (combine_partials, decode_attention,
                                          decode_partial, flash_attention)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (ParamSpec, apply_rope, rms_norm,
                                       rms_norm_split, sum_squares, swiglu)
from repro_torch.models.moe import moe_aux, moe_ffn
from repro_torch.sharding import collectives as C
from repro_torch.sharding.axes import (NamedSharding, constrain, each,
                                       leaf_like, leaf_parts, mesh_rules,
                                       named_sharding, run_range, use_rules)
from repro_torch.models.ssm import mamba2_block, mamba2_cols, mamba2_mix
from repro_torch.models.xlstm import (mlstm_block, mlstm_chunk_read,
                                      mlstm_chunk_sums, mlstm_proj,
                                      mlstm_scan, mlstm_step_read,
                                      mlstm_step_sums, slstm_block,
                                      slstm_cells, slstm_up)

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


def param_logical_axes(cfg: ModelConfig) -> dict[str, tuple]:
    return {k: v.logical for k, v in param_specs(cfg).items()}


def cast_params(cfg: ModelConfig, params: dict) -> dict:
    """The fp32 masters cast once to ``cfg.dtype`` (matrices only; the
    1-D scales, ``a_log`` and ``d_skip`` stay fp32).  Same numbers as the
    cast at every use.  Takes sharded leaves too (each shard cast)."""
    dt = dtype_of(cfg)
    return {k: (cast_leaf(v, dt) if v.dim() >= 2
                and k.rsplit("/", 1)[-1] not in _FP32_LEAVES else v)
            for k, v in params.items()}


def cast_leaf(v, dtype):
    """A whole or sharded leaf cast to ``dtype``."""
    return leaf_like(v, [p.to(dtype) for p in leaf_parts(v)])


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
                pos: torch.Tensor, rows: tuple[int, int] | None = None
                ) -> torch.Tensor:
    """Prefill attention sub-block (pre-norm residual inside).
    x: (B, S, d) -> (B, S, d).  ``rows``: the rows [r0, r1) of the whole
    ``wo`` that ``p["wo"]`` holds, the heads' outputs cut to them (a
    device that runs every head, ``wo`` split by rows)."""
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
    o = o.reshape(B, S, -1)
    if rows is not None:
        o = o[..., rows[0]:rows[1]]
    return o @ p["wo"].to(x.dtype)


def _qkv_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                pos: torch.Tensor):
    """One token a slot: x (B, d), pos (B,) int64 -> q (B, H, hd), k, v
    (B, KV, hd), q and k roped at ``pos``."""
    q, k, v = _qkv(cfg, p, x)
    q = apply_rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    k = apply_rope(k[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    return q, k, v


def _cache_write(kc: torch.Tensor, vc: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, pos: torch.Tensor, off: int = 0,
                 total: int | None = None) -> None:
    """Write each slot's k / v (B, KV, hd) IN PLACE at its ``min(pos,
    total - 1)`` (the reference's ``dynamic_update_slice`` clamps its start
    the same way).  kc / vc (B, Sl, KV, hd) hold the cache's positions
    [off, off + Sl) of ``total`` (default: all of them); a slot whose
    position lies outside them writes nothing here."""
    Sl = kc.shape[1]
    total = Sl if total is None else total
    slot = torch.arange(k.shape[0], device=k.device)
    at = torch.clamp(pos, max=total - 1)
    if total != Sl and kc.is_meta:
        # the dry run: meta tensors hold no positions to select by, so
        # every slot writes a row (the most the selected write moves)
        at = torch.clamp(at - off, 0, Sl - 1)
    elif total != Sl:                     # one shard of the sequence
        sel = (at >= off) & (at < off + Sl)
        slot, at, k, v = slot[sel], at[sel] - off, k[sel], v[sel]
    kc[slot, at] = k.to(kc.dtype)
    vc[slot, at] = v.to(vc.dtype)


def _attn_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 kc: torch.Tensor, vc: torch.Tensor, pos: torch.Tensor
                 ) -> torch.Tensor:
    """One-token attention per slot. x: (B, d); kc/vc: (B, Smax, KV, hd),
    written in place (``_cache_write``); pos: (B,) int64."""
    q, k, v = _qkv_decode(cfg, p, x, pos)
    _cache_write(kc, vc, k, v, pos)
    o = decode_attention(q, kc, vc, pos)
    return o.reshape(x.shape[0], -1) @ p["wo"].to(x.dtype)


def _mlp_apply(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    return swiglu(h, p["w1"], p["w3"], p["w2"])


def _moe_apply(cfg: ModelConfig, p: dict, x: torch.Tensor, **kw):
    """``moe_ffn`` on the pre-normed x (B, S, d) in groups of
    ``cfg.moe_group``; ``kw``: its ``experts`` / ``stats``."""
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    return moe_ffn(h, p["wg"], p["w1"], p["w3"], p["w2"], top_k=cfg.top_k,
                   capacity_factor=cfg.capacity_factor, group=cfg.moe_group,
                   **kw)


def _ffn_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, **kw
                ) -> torch.Tensor:
    """The FFN sub-block on one token a slot: x (B, d) -> (B, d); the moe
    family routes the B tokens in groups of ``cfg.moe_group`` (``kw``:
    ``_moe_apply``'s)."""
    if cfg.is_moe:
        return _moe_apply(cfg, p, x[:, None], **kw)[0][:, 0]
    return _mlp_apply(cfg, p, x)


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
    loss summed over the layers, else 0.  Under mesh rules the logits come
    back whole on the mesh's first device."""
    r = mesh_rules()
    if r is not None:
        parts, aux = forward_parts(cfg, params, tokens, patch_emb=patch_emb,
                                   last_only=last_only)
        return gather_logits(parts, r), aux
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


def cache_logical_axes(cfg: ModelConfig) -> dict:
    """Logical axes of every cache leaf (the reference's)."""
    kv_axes = (None, "cache_batch", "cache_seq", "act_kv", None)
    if cfg.family in _ATTN_FAMILIES:
        return {"k": kv_axes, "v": kv_axes}
    if cfg.family == "hybrid":
        return {
            "ssm_h": (None, "cache_batch", "act_inner", None, None),
            "conv": (None, "cache_batch", None, "act_inner"),
            "k": kv_axes, "v": kv_axes,
        }
    if cfg.family == "ssm":
        ax = {
            "mC": (None, "cache_batch", None, "act_inner", None),
            "mn": (None, "cache_batch", None, "act_inner"),
            "mm": (None, "cache_batch", None),
            "mconv": (None, "cache_batch", None, "act_inner"),
        }
        if cfg.slstm_every:
            for nm in ("sc", "sn", "sm", "sh"):
                ax[nm] = (None, "cache_batch", None, None)
        return ax
    raise ValueError(cfg.family)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device="cuda") -> dict:
    """The decode cache, all zeros, on ``device``.  Under mesh rules each
    leaf is a list with one part a device: its shard of the leaf under
    ``mesh_cache_axes``, zeros on that device."""
    r = mesh_rules()
    specs = cache_specs(cfg, batch, max_seq)
    if r is not None:
        if cfg.family in ("hybrid", "ssm"):
            _inner(cfg, r)
        axes = mesh_cache_axes(cfg, r)
        out = {}
        for name, (shape, dt) in specs.items():
            sh = named_sharding(axes[name], r)
            out[name] = each(r.mesh, lambda k: torch.zeros(
                _local_shape(sh, shape, k), dtype=dt,
                device=r.mesh.devices[k]))
        return out
    dev = check_device(device)
    return {name: torch.zeros(shape, dtype=dt, device=dev)
            for name, (shape, dt) in specs.items()}


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, pos) -> tuple[torch.Tensor, dict]:
    """One decode step. tokens: (B,) int ((B, n_cb) for audio); pos: the
    cache slot the new token occupies, one int for the batch or (B,) per
    slot.  The recurrent state advances whatever ``pos`` is.  The moe
    family routes the B tokens in groups of ``cfg.moe_group``, as the
    reference's decode does.  The cache is updated in place and
    returned.  Under mesh rules the cache is ``init_cache``'s laid-out
    form and the logits come back whole on the mesh's first device."""
    r = mesh_rules()
    if r is not None:
        return _mesh_decode(cfg, params, cache, tokens, pos, r), cache
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
            x = x + _ffn_decode(cfg, fp, x)
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


# ---------------------------------------------------------------------------
# the model on a mesh (see the module docstring)
# ---------------------------------------------------------------------------

def _ax(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _local_shape(sh: NamedSharding, shape, k: int) -> tuple[int, ...]:
    return tuple(x.stop - x.start
                 for x in sh.slices(shape, sh.mesh.coords(k)))


def _offset(leaf, dim: int, k: int) -> int:
    """Where device ``k``'s shard of ``leaf`` starts along ``dim``."""
    sh = leaf.sharding
    return sh.slices(leaf.shape, sh.mesh.coords(k))[dim].start


def _experts(w: dict, k: int) -> tuple[int, int]:
    """The experts [e0, e1) whose weights device ``k`` holds (``p_expert``
    splits dim 0 of a moe layer's ``w1`` / ``w3`` / ``w2``)."""
    e0 = _offset(w["w1"], 0, k)
    return e0, e0 + _local_shape(w["w1"].sharding, w["w1"].shape, k)[0]


def _chunk(mesh, k: int, axes) -> int:
    """Device ``k``'s index, row-major, over ``axes``."""
    c, i = mesh.coords(k), 0
    for a in axes:
        i = i * mesh.shape[a] + c[a]
    return i


def _fsdp(r) -> tuple[str, ...]:
    """The axes a device gathers a weight over before it computes with it
    (``p_embed``'s: FSDP under ``train_rules``)."""
    return _ax(r.table.get("p_embed"))


@dataclasses.dataclass(frozen=True)
class _AttnPlan:
    """How the devices of a mesh split the attention heads
    (``_attn_plan``): ``mode`` is

    * ``"heads"``: the model axes ``ax`` (``m`` devices) divide the q and
      the kv heads; a device runs its ``H / m`` q and ``KV / m`` kv
      heads, its shards of ``wq`` / ``wk`` / ``wv`` (columns) and ``wo``
      (rows);
    * ``"kv"``: they divide the q heads but not the kv heads (8 kv heads
      at model=16); a device runs its ``H / m`` q heads and the kv heads
      they read, whose ``wk`` / ``wv`` columns it takes from the shards
      that hold them (``Shards.take``; ``kv_of(c)``);
    * ``"all"``: they do not divide the q heads (24 at model=16); every
      device runs every head, ``wq`` / ``wk`` / ``wv`` taken whole a
      layer at a time, and multiplies its rows of the heads' outputs by
      its rows of ``wo``.

    ``lc`` is the config one device computes with."""
    mode: str
    ax: tuple[str, ...]
    m: int
    lc: ModelConfig

    def heads(self, c: int) -> tuple[int, int]:
        """The q heads [h0, h1) of the device at index ``c`` over ``ax``."""
        if self.mode == "all":
            return 0, self.lc.n_heads
        return c * self.lc.n_heads, (c + 1) * self.lc.n_heads

    def kv_of(self, cfg: ModelConfig, c: int) -> list[int]:
        """The kv heads, in ``lc``'s order, of the device at index ``c``:
        the one kv head of all its q heads, or one a q head."""
        h0, h1 = self.heads(c)
        G = cfg.n_heads // cfg.n_kv
        if self.mode == "heads":
            return list(range(c * self.lc.n_kv, (c + 1) * self.lc.n_kv))
        if self.mode == "all":
            return list(range(cfg.n_kv))
        kv = [h // G for h in range(h0, h1)]
        return kv[:1] if self.lc.n_kv == 1 else kv


def _attn_plan(cfg: ModelConfig, r) -> _AttnPlan:
    """The attention heads' split over ``p_heads``' axes (``_AttnPlan``).
    ``make_rules`` keeps ``p_heads`` / ``p_kv`` on ``model`` whatever the
    heads, and drops ``act_heads`` / ``act_kv`` where the axis does not
    divide them (the reference's GSPMD then gathers or replicates what
    a device needs); the port runs every such table."""
    ax = _ax(r.table["p_heads"])
    if _ax(r.table["p_kv"]) != ax:
        raise NotImplementedError(
            f"{cfg.name}: p_heads {ax} and p_kv {r.table['p_kv']} differ")
    m = r.mesh.shape_of(ax)
    H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    if H % m:
        return _AttnPlan("all", ax, m, dataclasses.replace(
            cfg, head_dim=hd))
    hl = H // m
    if KV % m == 0:
        return _AttnPlan("heads", ax, m, dataclasses.replace(
            cfg, n_heads=hl, n_kv=KV // m, head_dim=hd))
    G = H // KV
    # one kv head serves all of a device's q heads when they lie inside
    # one group (hl divides G); else each q head takes its own kv head
    kvl = 1 if G % hl == 0 else hl
    return _AttnPlan("kv", ax, m, dataclasses.replace(
        cfg, n_heads=hl, n_kv=kvl, head_dim=hd))


def _attn_views(cfg: ModelConfig, plan: _AttnPlan, ap: dict, k: int,
                gather) -> dict:
    """Device ``k``'s attention weights under ``plan``: its shards, with
    ``wk`` / ``wv`` (``"kv"``: its kv heads' columns) or ``wq`` / ``wk`` /
    ``wv`` (``"all"``: whole) taken from the shards that hold them."""
    if plan.mode == "heads":
        return _views(ap, k, gather)
    hd = cfg.hd
    mesh = ap["wq"].sharding.mesh
    taken = ("wk", "wv") if plan.mode == "kv" else ("wq", "wk", "wv")
    out = _views({n: w for n, w in ap.items() if n not in taken}, k, gather)
    kv = plan.kv_of(cfg, _chunk(mesh, k, plan.ax))
    for n in taken:
        cols = ([(0, ap[n].shape[1])] if plan.mode == "all"
                else [(j * hd, (j + 1) * hd) for j in kv])
        out[n] = ap[n].take(k, 1, cols, gather)
    return out


def _inner(cfg: ModelConfig, r) -> tuple[tuple[str, ...], int]:
    """(axes, heads a device) of the hybrid's SSM heads or the ssm
    family's heads, split over ``p_inner``'s axes (``act_inner``'s, the
    same in every table): a device runs whole heads.  Where the axes do
    not divide the ssm family's heads (xlstm-1.3b's 4 at model=8 or 16)
    the heads a device is 0: each device runs its rows of P, the head
    dim, in every head (``_mesh_mlstm_rows``), as the reference splits
    P.  (``make_rules`` keeps ``p_inner`` only on axes that divide the
    hybrid's heads and the ssm family's P.)"""
    heads = cfg.ssm_heads if cfg.family == "hybrid" else cfg.n_heads
    ax = _ax(r.table.get("p_inner"))
    n = r.mesh.shape_of(ax)
    if _ax(r.table.get("act_inner")) != ax:
        raise NotImplementedError(
            f"{cfg.name}: p_inner {ax} and act_inner "
            f"{r.table.get('act_inner')} differ")
    if heads % n == 0:
        return ax, heads // n
    P = cfg.mlstm_proj * cfg.d_model // heads
    if cfg.family == "ssm" and P % n == 0:
        return ax, 0
    raise NotImplementedError(
        f"{cfg.name}: {heads} heads over p_inner {ax} ({n} ways)")


def _heads(mesh, k: int, ax, hl: int) -> tuple[int, int]:
    """The heads [h0, h1) device ``k`` runs, ``hl`` a device over
    ``ax``."""
    h0 = _chunk(mesh, k, ax) * hl
    return h0, h0 + hl


def mesh_cache_axes(cfg: ModelConfig, r=None) -> dict:
    """The logical axes of every cache leaf on a mesh: the reference's
    (``cache_logical_axes``) but the ssm family's recurrent state, laid
    out over its heads (``act_inner``) where the reference splits the
    mLSTM's P and replicates the rest (ROADMAP Queue 3): a device runs
    whole heads and reads and writes only its own state.  Under rules
    ``r`` whose axes do not divide the heads (``_inner``'s 0 heads a
    device) a device runs rows of P, and the state is laid out as the
    reference's: ``mC`` / ``mn`` their P rows a device, the rest
    whole."""
    axes = cache_logical_axes(cfg)
    if cfg.family == "ssm" and (r is None or _inner(cfg, r)[1]):
        heads = (None, "cache_batch", "act_inner")
        axes.update(mC=heads + (None, None), mn=heads + (None,), mm=heads)
        if cfg.slstm_every:
            for nm in ("sc", "sn", "sm", "sh"):
                axes[nm] = heads + (None,)
    return axes


def _mesh_layers(params: dict, prefix: str, n: int) -> list[dict]:
    rows = {k: v.unbind0() for k, v in _subtree(params, prefix).items()}
    return [{k: r[i] for k, r in rows.items()} for i in range(n)]


def _views(p: dict, k: int, gather) -> dict:
    return {name: leaf.local(k, gather) for name, leaf in p.items()}


def _remat(cfg: ModelConfig, fn, k: int, *args):
    """``fn(k, *args)``, device ``k``'s share of a sub-block, under
    ``torch.utils.checkpoint`` when ``cfg.remat`` and grad are on: one
    frame a device and sub-block, since the backward runs a thread a
    device and one frame recomputed from two threads would race.  The
    weights ``fn`` gathers are gathered inside the frame, so they are
    freed after use and gathered again in the backward."""
    if cfg.remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(
            fn, k, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(k, *args)


def _gathered(cfg: ModelConfig, r, ax, fn, xs: list, dim: int = 1) -> list:
    """Every device's ``_remat`` of ``fn(k, x)``, ``x`` the parts of
    ``xs`` that device ``k``'s group over ``ax`` holds, all-gathered
    along ``dim`` inside the frame: the parts (references to the tensors
    they are, no copy) are the frame's inputs, so the frame saves no more
    than its group's parts, and the gathered tensor is freed after use
    and gathered again in the backward.  The forward takes the parts
    from copies made for every device before any frame is queued: a copy
    between two cards waits for the work queued on both, so copies made
    inside the frames would wait for the frames queued before them on
    the other cards, and the devices' frames would run one after
    another.  With ``ax`` () ``x`` is ``xs[k]``.  The sub-blocks' frames
    gather the residual stream's sequence so (``dim`` 1 over
    ``act_seq``'s axes: ``_seq_split``)."""
    mesh = r.mesh
    groups = [mesh.group(k, ax) for k in range(mesh.size)]
    near = each(mesh, lambda k: [xs[j].to(mesh.devices[k])
                                 for j in groups[k]])

    def frame(k):
        box, near[k] = [near[k]], None

        def body(k, *parts):
            return fn(k, C.gather_one(box.pop() if box else list(parts),
                                      mesh, k, ax, dim))
        return _remat(cfg, body, k, *[xs[j] for j in groups[k]])
    return each(mesh, frame)


def _seq_split(r, S: int) -> tuple[str, ...]:
    """The mesh axes over which the table's ``act_seq`` splits the
    residual stream's ``S`` positions (Megatron sequence parallelism: a
    device holds ``S / m`` positions of its batch rows between
    sub-blocks), or () where it keeps them whole (None, or one device).
    ``make_rules`` keeps them whole where the axes do not divide ``S``;
    a table that splits an ``S`` they do not divide raises."""
    sq = _ax(r.table.get("act_seq"))
    m = r.mesh.shape_of(sq)
    if m == 1:
        return ()
    if S % m:
        raise ValueError(f"act_seq splits the sequence over {sq} ({m} "
                         f"ways), which does not divide its {S} positions")
    return sq


def _seq_sum(parts: list, r, ax, sq, dtype=None) -> list:
    """A row-parallel product's partial sums over ``ax`` (each device's
    (B, S, d) over the whole sequence), summed over the group and rounded
    to ``dtype`` once (default: the parts'; the xLSTM's fp32 partials:
    ``_sum_fp32``'s rule): reduce-scattered along the sequence where
    ``sq`` splits it, so a device gets the sum at its ``S / m``
    positions, else all-reduced.  A sequence split over other axes than
    the sum's raises: the port has no layout for it."""
    if not sq:
        red = C.all_reduce(parts, r.mesh, ax)
        return red if dtype is None else each(r.mesh,
                                               lambda k: red[k].to(dtype))
    if tuple(ax) != tuple(sq):
        raise NotImplementedError(
            f"partial sums over {ax} with act_seq split over {sq}")
    return C.reduce_scatter(parts, r.mesh, ax, dim=1, dtype=dtype)


def _mesh_embed(cfg: ModelConfig, params: dict, toks: list, r, dtype,
                gather, sq=(), pe=None) -> list:
    """The token embedding with its table split over the vocab: each
    device looks up the rows it holds (zeros for the others) at every
    position of its batch rows, and the lookups are summed over the vocab
    axes, one codebook at a time, so the sum is the one-device lookup
    exactly: reduce-scattered along the sequence where ``sq`` splits it
    (the vocab and the sequence share the axes; ``_seq_sum``), else
    all-reduced.  ``pe``: the vlm family's patch rows (each device's
    batch rows), put before the text by the first device of the vocab
    group (the others put zeros), so the split falls on the whole
    sequence."""
    mesh = r.mesh
    emb = params["embed/tok"]
    vdim = 1 if cfg.family == "audio" else 0
    vax = _ax(emb.sharding.spec[vdim])
    n_cb = cfg.n_codebooks if cfg.family == "audio" else 1

    def lookup(k):
        e = emb.local(k, gather)
        v0, nv = _offset(emb, vdim, k), e.shape[vdim]
        t = toks[k].long() - v0
        hit = (t >= 0) & (t < nv)
        t = t.clamp(0, nv - 1)
        out = []
        for i in range(n_cb):
            if cfg.family == "audio":
                x = torch.where(hit[..., i, None], e[i][t[..., i]], 0)
            else:
                x = torch.where(hit[..., None], e[t], 0)
            x = x.to(e.dtype)
            if pe is not None:
                p = pe[k].to(x.device, x.dtype)
                if _chunk(mesh, k, vax):
                    p = torch.zeros_like(p)
                x = torch.cat([p, x], dim=1)
            out.append(x)
        return out
    rows = each(mesh, lookup)
    looked = [_seq_sum([x[i] for x in rows], r, vax, sq)
              for i in range(n_cb)]
    return each(mesh, lambda k: sum(x[k] for x in looked).to(dtype)
                if n_cb > 1 else looked[0][k].to(dtype))


def _lm_heads(cfg: ModelConfig, params: dict, xs: list, gather, sq=(),
              last_only: bool = False) -> list:
    """final norm + each device's vocab columns of the LM head.  Where
    ``sq`` splits the sequence the norm runs on a device's shard and the
    normed shards are all-gathered, so a device's logits cover the whole
    sequence of its batch rows: in fp32, so that the backward sums the
    group's grads of a position in fp32 and rounds them once, before the
    norm's scale sums them over the positions (in bf16 partial sums of
    16 devices its grad strayed 0.12 from one device's: PERF.md §6);
    with ``last_only`` a device takes the last position from the last
    shard of its group."""
    mesh = params["lm_head/w"].sharding.mesh
    if last_only:
        n = mesh.shape_of(sq)
        xs = each(mesh, lambda k: C.take(
            xs, mesh, k, sq, 1, [(n * xs[k].shape[1] - 1,
                                  n * xs[k].shape[1])]))
    with use_rules(None):
        xs = each(mesh, lambda k: rms_norm(
            xs[k], params["final_norm/scale"].local(k, gather),
            cfg.norm_eps))
    if sq and not last_only:
        dt = xs[0].dtype
        xs = C.all_gather(each(mesh, lambda k: xs[k].float()), mesh, sq,
                          dim=1)
        xs = each(mesh, lambda k: xs[k].to(dt))
    with use_rules(None):
        return each(mesh, lambda k: _lm_head(
            cfg, {"lm_head/w": params["lm_head/w"].local(k, gather)}, xs[k]))


def gather_logits(parts: list, r) -> torch.Tensor:
    """Logits laid out over the mesh (a device's batch rows, its vocab
    columns) brought whole to the mesh's first device."""
    mesh = r.mesh
    dev = mesh.devices[0]
    vax, bax = _ax(r.table["p_vocab"]), _ax(r.table["act_batch"])
    return torch.cat([torch.cat([parts[j].to(dev)
                                 for j in mesh.group(k, vax)], dim=-1)
                      for k in mesh.group(0, bax)], dim=0)


def _batch_mean(xs: list, r) -> torch.Tensor:
    """The mean over the batch shards (one device each) of per-device
    values, on the mesh's first device."""
    mesh = r.mesh
    reps = mesh.group(0, _ax(r.table["act_batch"]))
    dev = mesh.devices[0]
    tot = xs[reps[0]].to(dev)
    for j in reps[1:]:
        tot = tot + xs[j].to(dev)
    return tot / len(reps)


# ---- the sub-blocks, every device's share -------------------------------

def _mesh_attn(cfg, plan, r, ap, xs, pos, gather, sq=()) -> list:
    """Prefill attention (pre-norm residual): a device gathers its batch
    rows' whole sequence over ``sq`` inside its remat frame
    (``_gathered``), runs its heads under ``plan`` (``plan.lc``, its K7
    calls on them; the weights it takes inside the frame), and ``wo``'s
    partial sums are reduce-scattered back to the sequence's shards
    (all-reduced where ``sq`` is ())."""
    def attn(k, x):
        with use_rules(None):
            p = _attn_views(cfg, plan, ap, k, gather)
            rows = None
            if plan.mode == "all":              # this device's rows of wo
                r0 = _offset(ap["wo"], 0, k)
                rows = (r0, r0 + p["wo"].shape[0])
            return _attn_apply(plan.lc, p, x, pos[k], rows)
    outs = _gathered(cfg, r, sq, attn, xs)
    red = _seq_sum(outs, r, _ax(ap["wo"].sharding.spec[0]), sq)
    return each(r.mesh, lambda k: xs[k] + red[k])


def _mesh_ffn(cfg, lc, r, fp, xs, gather, sq=()
              ) -> tuple[list, torch.Tensor]:
    """The FFN sub-block (pre-norm residual): a device gathers the
    sequence as ``_mesh_attn`` does, runs its ff columns or its experts
    (over its batch rows' whole sequences: the moe groups of one device)
    and the outputs are summed (``_seq_sum``); the moe family's
    load-balance aux over the whole batch (else None)."""
    def mlp(k, x):
        with use_rules(None):
            return _mlp_apply(lc, _views(fp, k, gather), x)

    def moe(k, x):
        with use_rules(None):
            return _moe_apply(lc, _views(fp, k, gather), x,
                              experts=_experts(fp, k), stats=True)
    aux = None
    if cfg.is_moe:
        outs, stats = zip(*_gathered(cfg, r, sq, moe, xs))
        aux = moe_aux(_batch_mean([s[0] for s in stats], r),
                      _batch_mean([s[1] for s in stats], r), cfg.top_k)
    else:
        outs = _gathered(cfg, r, sq, mlp, xs)
    red = _seq_sum(list(outs), r, _ax(fp["w2"].sharding.spec[0]), sq)
    return each(r.mesh, lambda k: xs[k] + red[k]), aux


def _mesh_attn_decode(cfg, r, plan, ap, xs, poss, kcs, vcs, gather) -> list:
    """One-token attention (pre-norm residual) on every device; ``kcs`` /
    ``vcs``: each device's part of this layer's KV cache, written in
    place.  With ``act_kv`` split a device attends over its kv heads;
    with ``cache_seq`` split every device attends over its chunk of the
    sequence for all heads (q, k, v gathered over the head axes, each kv
    head once; under ``plan.mode == "all"`` every device has them all)
    and the chunks merge by logsumexp (flash-decode)."""
    mesh, n = r.mesh, r.mesh.size
    seq_ax = _ax(r.table.get("cache_seq"))
    head_ax = plan.ax
    local_heads = plan.mode == "heads" and (
        r.table.get("act_kv") is not None or plan.m == 1)
    n_seq = mesh.shape_of(seq_ax)
    with use_rules(None):
        qkv = each(mesh, lambda k: _qkv_decode(
            plan.lc, _attn_views(cfg, plan, ap, k, gather), xs[k], poss[k]))
    if not local_heads and plan.mode != "all":   # every head everywhere
        qkv = [list(t) for t in zip(*(C.all_gather(list(t), mesh, head_ax,
                                                   dim=1)
                                      for t in zip(*qkv)))]
        if plan.mode == "kv":                 # each kv head once, in order
            owner = [j for c in range(plan.m) for j in plan.kv_of(cfg, c)]
            idx = [owner.index(j) for j in range(cfg.n_kv)]

            def dedup(k):
                sel = torch.tensor(idx, device=qkv[k][1].device)
                return [qkv[k][0], qkv[k][1][:, sel], qkv[k][2][:, sel]]
            qkv = each(mesh, dedup)

    def attend(k):
        q, kk, v = qkv[k]
        kc, vc = kcs[k], vcs[k]
        off = _chunk(mesh, k, seq_ax) * kc.shape[1]
        _cache_write(kc, vc, kk, v, poss[k], off, kc.shape[1] * n_seq)
        return (decode_attention(q, kc, vc, poss[k]) if n_seq == 1 else
                decode_partial(q, kc, vc, poss[k], off))

    def project(k):
        o = outs[k].reshape(outs[k].shape[0], -1)
        wo = ap["wo"].local(k, gather)
        if not local_heads:                   # this device's rows of wo
            r0 = _offset(ap["wo"], 0, k)
            o = o[:, r0:r0 + wo.shape[0]]
        return o @ wo.to(o.dtype)
    with use_rules(None):
        outs = each(mesh, attend)
    if n_seq > 1:                             # flash-decode's combine
        outs = each(mesh, lambda k: combine_partials(
            [tuple(t.to(mesh.devices[k]) for t in outs[j])
             for j in mesh.group(k, seq_ax)], qkv[k][0].dtype))
    with use_rules(None):
        outs = each(mesh, project)
    red = C.all_reduce(outs, mesh, _ax(ap["wo"].sharding.spec[0]))
    return each(mesh, lambda k: xs[k] + red[k])


def _mesh_ffn_decode(cfg, lc, r, fp, xs, gather) -> list:
    """The FFN sub-block on one token a slot, every device's share."""
    with use_rules(None):
        outs = each(r.mesh, lambda k: _ffn_decode(
            lc, _views(fp, k, gather), xs[k],
            **(dict(experts=_experts(fp, k)) if cfg.is_moe else {})))
    red = C.all_reduce(outs, r.mesh, _ax(fp["w2"].sharding.spec[0]))
    return each(r.mesh, lambda k: xs[k] + red[k])


def _mesh_mamba(cfg, r, lp, xs, gather, cache=None, i=None, sq=()
                ) -> list:
    """One Mamba2 layer (pre-norm residual) on every device: a device
    runs its SSM heads (``_inner``): the columns of ``in_proj`` and
    ``conv_w`` they read (their z, x and dt, the shared B / C whole;
    ``ssm.mamba2_cols``) taken from the shards that hold them, their
    conv channels, chunked SSD and state; the gated RMSNorm over the
    whole d_inner takes its sum of squares all-reduced over the heads'
    axes, and ``out_proj``'s partial sums are summed (``_seq_sum``).  In
    prefill the conv and the chunked SSD read the whole sequence: a
    device gathers it over ``sq`` inside its first frame, before
    ``in_proj`` (``_gathered``).  With
    ``cache`` (decode) layer ``i``'s state is read and written in place:
    ``ssm_h`` a device's own heads, the conv cache (split over d_inner +
    2N as the reference's, not by heads) its columns taken from the
    devices that hold them and put back after every device has read."""
    mesh, n = r.mesh, r.mesh.size
    ax, hl = _inner(cfg, r)
    cols = [mamba2_cols(cfg, *_heads(mesh, k, ax, hl)) for k in range(n)]
    decode = cache is not None
    convs = [c[i] for c in cache["conv"]] if decode else None

    def mix(k, x):
        h0, h1 = _heads(mesh, k, ax, hl)
        with use_rules(None):
            p = {"in_proj": lp["in_proj"].take(k, 1, cols[k]["in_proj"],
                                               gather),
                 "conv_w": lp["conv_w"].take(k, 1, cols[k]["conv_w"],
                                             gather)}
            for nm in ("a_log", "dt_bias", "d_skip"):
                p[nm] = lp[nm].take(k, 0, [(h0, h1)], gather)
            st = None
            if decode:
                st = (cache["ssm_h"][k][i],
                      C.take(convs, mesh, k, ax, 2, cols[k]["conv_w"]))
            y, st = mamba2_mix(
                rms_norm(x, lp["norm"].local(k, gather), cfg.norm_eps), p,
                cfg, state=st, decode=decode)
        return (y, sum_squares(y)) + ((st,) if decode else ())

    def out(k, y, ss):
        with use_rules(None):
            s = lp["norm_inner"].take(k, 0, cols[k]["inner"], gather)
            w = lp["out_proj"].take(k, 0, cols[k]["inner"], gather)
            y = rms_norm_split(y, ss, cfg.d_inner, s, cfg.norm_eps)
            return y @ w.to(y.dtype)

    mixed = _gathered(cfg, r, sq, mix, xs)
    if decode:                         # every device has read: write back
        for k in run_range(mesh):
            sh, cv = mixed[k][2]
            cache["ssm_h"][k][i].copy_(sh)
            own = cols[k]["conv_w"]          # its x channels, then B / C
            if mesh.group(k, ax)[0] != k:    # B / C: the group's first
                own = own[:1]
            C.put(convs, mesh, k, ax, 2, own,
                  cv[..., :sum(b - a for a, b in own)])
    tot = C.all_reduce([m[1] for m in mixed], mesh, ax)
    outs = each(mesh, lambda k: _remat(cfg, out, k, mixed[k][0], tot[k]))
    red = _seq_sum(outs, r, ax, sq)
    return each(mesh, lambda k: xs[k] + red[k])


def _fp32_partial(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One device's part of a product over a split dim, ``h @ w`` with
    ``w`` in h's dtype, computed and kept in fp32 (``_sum_fp32``)."""
    return h.float() @ w.to(h.dtype).float()


def _sum_fp32(parts: list, r, axes, dtype) -> list:
    """Parts of a product summed over ``axes`` in fp32 and rounded to
    ``dtype`` once, as one device's product rounds its fp32 accumulation
    once.  The xLSTM blocks sum their partial products so: their
    exponential gates amplify the rounding of every bf16 part (PERF.md
    §6 has the logits on the card both ways).  The mLSTM's gate
    pre-activations and v go through here; the blocks' outputs through
    ``_seq_sum`` with ``dtype``, the same rule along the sequence."""
    red = C.all_reduce(parts, r.mesh, axes)
    return each(r.mesh, lambda k: red[k].to(dtype))


def _mesh_mlstm(cfg, r, lp, xs, gather, state=None, sq=()
                ) -> tuple[list, list]:
    """One mLSTM layer (pre-norm residual) on every device: a device runs
    its heads (``_inner``): its ``xm`` and ``z`` columns of ``up_proj``,
    its conv channels, its heads' ``wq`` / ``wk`` / ``wv`` blocks (P
    whole, where the reference splits it: ROADMAP Queue 3) taken from
    the shards that hold them; the gate pre-activations ``c @ wi`` /
    ``c @ wf`` sum over all of d_inner, so each device's partial sums
    are summed over the heads' axes (``_sum_fp32``), as ``down_proj``'s
    are along the sequence's shards (``_seq_sum`` in fp32);
    ``norm_inner`` takes its sum of squares all-reduced.  In prefill a
    device gathers the sequence over ``sq`` inside its first frame
    (``_gathered``).  ``state``: each device's ((C, n, m), conv) for
    decode.  Returns (xs, new states)."""
    mesh, n = r.mesh, r.mesh.size
    ax, hl = _inner(cfg, r)
    if not hl:
        return _mesh_mlstm_rows(cfg, r, lp, xs, gather, state, sq)
    H = cfg.n_heads
    di = cfg.mlstm_proj * cfg.d_model
    P = di // H
    decode = state is not None
    hs = [_heads(mesh, k, ax, hl) for k in range(n)]
    inner = [[(h0 * P, h1 * P)] for h0, h1 in hs]

    def proj(k, x):
        (h0, h1), ch = hs[k], inner[k]
        with use_rules(None):
            p = {"up_proj": lp["up_proj"].take(
                     k, 1, ch + [(di + h0 * P, di + h1 * P)], gather),
                 "conv_w": lp["conv_w"].take(k, 1, ch, gather),
                 "wi": lp["wi"].take(k, 0, ch, gather),
                 "wf": lp["wf"].take(k, 0, ch, gather)}
            for nm in ("wq", "wk", "wv"):
                p[nm] = lp[nm].take(k, 1, [(0, P)], gather,
                                    index={0: slice(h0, h1)})
            q, kk, v, i_pre, f_pre, z, cv = mlstm_proj(
                rms_norm(x, lp["norm"].local(k, gather), cfg.norm_eps), p,
                conv_cache=state[k][1] if decode else None, decode=decode,
                gate_dtype=torch.float32)
        return (q, kk, v, torch.cat([i_pre, f_pre], dim=-1), z) + (
            (cv,) if decode else ())

    def scan(k, q, kk, v, g):
        h0, h1 = hs[k]
        h, ms = mlstm_scan(q, kk, v, g[..., h0:h1], g[..., H + h0:H + h1],
                           cfg, state=state[k][0] if decode else None,
                           decode=decode)
        return (h, sum_squares(h)) + ((ms,) if decode else ())

    def out(k, h, ss, z):
        with use_rules(None):
            s = lp["norm_inner"].take(k, 0, inner[k], gather)
            w = lp["down_proj"].take(k, 0, inner[k], gather)
            h = rms_norm_split(h, ss, di, s, cfg.norm_eps) * F.silu(z)
            return _fp32_partial(h, w)

    pr = _gathered(cfg, r, sq, proj, xs)
    gates = _sum_fp32([t[3] for t in pr], r, ax, xs[0].dtype)
    sc = each(mesh, lambda k: _remat(cfg, scan, k, *pr[k][:3], gates[k]))
    tot = C.all_reduce([t[1] for t in sc], mesh, ax)
    outs = each(mesh, lambda k: _remat(cfg, out, k, sc[k][0], tot[k],
                                       pr[k][4]))
    red = _seq_sum(outs, r, ax, sq, xs[0].dtype)
    new = [(t[2], p[5]) for t, p in zip(sc, pr)] if decode else None
    return each(mesh, lambda k: xs[k] + red[k]), new


def _mesh_mlstm_rows(cfg, r, lp, xs, gather, state=None, sq=()
                     ) -> tuple[list, list]:
    """One mLSTM layer where the model axes ``ax`` (m devices) do not
    divide the heads (ROADMAP item 12f): device ``k`` at index c over
    ``ax`` runs rows R = [c P / m, (c + 1) P / m) of P in every head, as
    the reference splits P:

    * its channels (head h's rows R, h = 0 .. H-1) of ``up_proj`` (``xm``
      and ``z``), ``conv_w``, ``wi`` / ``wf``, ``norm_inner`` and
      ``down_proj`` taken from the shards that hold them, and its shard
      of ``wq`` / ``wk`` / ``wv``, whose P input rows ``p_inner`` splits:
      R of every head;
    * q, k, v over its rows are partial sums: q and k reduce-scattered to
      their columns R, v all-reduced whole, the gates all-reduced (all in
      fp32, rounded once: ``_sum_fp32``'s rule);
    * the state's rows R (``C[R, :]``, ``n[R]``; ``m`` on every device)
      advance with no collective; the sums over p that read the state
      (``qk``, ``h``'s inter-chunk term and the denominator's) are
      partial sums, all-reduced (``h``: reduce-scattered to its columns
      R, all a device reads);
    * ``norm_inner`` takes its sum of squares all-reduced and
      ``down_proj`` its partial products summed (``_seq_sum``: in prefill
      reduce-scattered along the sequence, which a device gathers over
      ``sq`` inside its first frame).

    Decode reads and writes ``mC`` / ``mn`` rows R, ``mm`` whole (the
    reference's layout: ``mesh_cache_axes``), and the conv cache's
    channels, which lie in other devices' parts of its flat split, taken
    from them and put back after every device has read.  ``state``:
    each device's ((C, n, m), conv).  Returns (xs, new states), each
    state's conv None: the conv caches are written in place."""
    mesh, n = r.mesh, r.mesh.size
    ax = _ax(r.table.get("p_inner"))
    m = mesh.shape_of(ax)
    H = cfg.n_heads
    di = cfg.mlstm_proj * cfg.d_model
    P = di // H
    Pl = P // m
    dt = xs[0].dtype
    decode = state is not None
    rows = [_chunk(mesh, k, ax) for k in range(n)]
    ch = [[(h * P + c * Pl, h * P + (c + 1) * Pl) for h in range(H)]
          for c in rows]
    convs = [st[1] for st in state] if decode else None

    def proj(k, x):
        with use_rules(None):
            p = {"up_proj": lp["up_proj"].take(
                     k, 1, ch[k] + [(di + a, di + b) for a, b in ch[k]],
                     gather),
                 "conv_w": lp["conv_w"].take(k, 1, ch[k], gather),
                 "wi": lp["wi"].take(k, 0, ch[k], gather),
                 "wf": lp["wf"].take(k, 0, ch[k], gather)}
            for nm in ("wq", "wk", "wv"):
                p[nm] = lp[nm].local(k, gather)
            cv = C.take(convs, mesh, k, ax, 2, ch[k]) if decode else None
            q, kk, v, i_pre, f_pre, z, cv = mlstm_proj(
                rms_norm(x, lp["norm"].local(k, gather), cfg.norm_eps), p,
                conv_cache=cv, decode=decode, gate_dtype=torch.float32,
                qkv_dtype=torch.float32)
        return (q, kk, v, torch.cat([i_pre, f_pre], dim=-1), z) + (
            (cv,) if decode else ())

    def sums(k, q, kk, v, g):
        st = state[k][0] if decode else None
        if decode:
            return mlstm_step_sums(q, kk, v, g[..., :H], g[..., H:], st)
        (qk, hi, di_), rest, st = mlstm_chunk_sums(
            q, kk, v, g[..., :H], g[..., H:], cfg.ssd_chunk, st)
        return (qk, hi, di_), st, rest

    def read(k, v, red, rest):
        if decode:
            h = mlstm_step_read(red[0], red[1], rest, dt)
        else:                          # v's columns R: h's
            c = rows[k]
            h = mlstm_chunk_read(red, rest, v[..., c * Pl:(c + 1) * Pl])
        h = h.flatten(-2)
        return h, sum_squares(h)

    def out(k, h, ss, z):
        with use_rules(None):
            s = lp["norm_inner"].take(k, 0, ch[k], gather)
            w = lp["down_proj"].take(k, 0, ch[k], gather)
            h = rms_norm_split(h, ss, di, s, cfg.norm_eps) * F.silu(z)
            return _fp32_partial(h, w)

    pr = _gathered(cfg, r, sq, proj, xs)
    if decode:                         # every device has read: write back
        for k in run_range(mesh):
            C.put(convs, mesh, k, ax, 2, ch[k], pr[k][5])
    q = C.reduce_scatter([t[0] for t in pr], mesh, ax, dim=-1, dtype=dt)
    kk = C.reduce_scatter([t[1] for t in pr], mesh, ax, dim=-1, dtype=dt)
    v = _sum_fp32([t[2] for t in pr], r, ax, dt)
    gates = _sum_fp32([t[3] for t in pr], r, ax, dt)
    sc = each(mesh, lambda k: _remat(cfg, sums, k, q[k], kk[k], v[k],
                                     gates[k]))
    parts = list(zip(*[t[0] for t in sc]))
    if decode:                         # (h, d): h to its columns R
        red = list(zip(C.reduce_scatter(list(parts[0]), mesh, ax, dim=-1),
                       C.all_reduce(list(parts[1]), mesh, ax)))
        rest = [t[1][2] for t in sc]   # m, the new stabiliser
    else:                              # (qk, h_inter, d_inter)
        red = list(zip(C.all_reduce(list(parts[0]), mesh, ax),
                       C.reduce_scatter(list(parts[1]), mesh, ax, dim=-1),
                       C.all_reduce(list(parts[2]), mesh, ax)))
        rest = [t[2] for t in sc]
    hs = each(mesh, lambda k: _remat(cfg, read, k, v[k], red[k], rest[k]))
    tot = C.all_reduce([t[1] for t in hs], mesh, ax)
    outs = each(mesh, lambda k: _remat(cfg, out, k, hs[k][0], tot[k],
                                       pr[k][4]))
    res = _seq_sum(outs, r, ax, sq, dt)
    new = [(t[1], None) for t in sc] if decode else None
    return each(mesh, lambda k: xs[k] + res[k]), new


def _mesh_slstm(cfg, r, lp, xs, gather, state=None, sq=()
                ) -> tuple[list, list]:
    """One sLSTM layer (pre-norm residual) on every device: a device runs
    its heads' recurrence (their ``w_gates`` columns, head-major, and
    ``r_gates`` blocks) over the whole sequence (gathered over ``sq``
    inside its frame) with no collective inside the time loop; ``y`` is
    all-gathered over the heads inside the FFN's frame, before the
    RMSNorm over d, and ``up`` / ``down`` split as ``p_ff`` (their
    partial sums ``_seq_sum`` in fp32).  Where the axes do not divide
    the heads (``_inner``'s 0) every device runs every head, ``w_gates``
    taken whole a layer at a time, and keeps the whole state (the
    reference's layout: ``mesh_cache_axes``); in prefill its FFN frame
    keeps its own shard of ``y``'s sequence and gathers the others'.
    ``state``: each device's (c, n, m, h) for decode.  Returns (xs, new
    states)."""
    mesh, n = r.mesh, r.mesh.size
    ax, hl = _inner(cfg, r)
    dh = cfg.d_model // cfg.n_heads
    decode = state is not None
    hs = [_heads(mesh, k, ax, hl) if hl else (0, cfg.n_heads)
          for k in range(n)]

    def cells(k, x):
        h0, h1 = hs[k]
        with use_rules(None):
            p = {"w_gates": lp["w_gates"].take(
                     k, 1, [(h0 * dh * 4, h1 * dh * 4)], gather),
                 "r_gates": lp["r_gates"].take(k, 0, [(h0, h1)], gather)}
            return slstm_cells(
                rms_norm(x, lp["norm"].local(k, gather), cfg.norm_eps), p,
                state=state[k] if decode else None, decode=decode)

    def ffn(k, y):
        with use_rules(None):
            p = _views({nm: lp[nm] for nm in ("ln", "up", "down")}, k,
                       gather)
            return _fp32_partial(slstm_up(y, p, cfg), p["down"])

    ys, new = zip(*_gathered(cfg, r, sq, cells, xs))
    if hl:                           # its heads' y, gathered in the frame
        outs = _gathered(cfg, r, ax, ffn, ys, dim=-1)
    elif sq:                         # its own shard of y's sequence
        Sl = xs[0].shape[1]
        own = each(mesh, lambda k: ys[k].narrow(
            1, _chunk(mesh, k, sq) * Sl, Sl).clone())
        outs = _gathered(cfg, r, sq, ffn, own)
    else:
        outs = each(mesh, lambda k: _remat(cfg, ffn, k, ys[k]))
    red = _seq_sum(outs, r, _ax(lp["down"].sharding.spec[0]), sq,
                   xs[0].dtype)
    return each(mesh, lambda k: xs[k] + red[k]), (list(new) if decode
                                                  else None)


def _mesh_zamba(cfg, r, params, xs, gather, *, pos=None, cache=None,
                poss=None, sq=()) -> list:
    """The hybrid's layers on every device (``_zamba_forward``'s order):
    the Mamba2 layers (``_mesh_mamba``) and the shared attention + MLP
    block, whose heads and ff columns split as the attention families'
    (K7 on a device's heads with ``attn_impl="pallas"``).  Prefill with
    ``pos``; decode with ``cache`` / ``poss``, the shared block's
    application ``a`` attending over its KV cache ``a``; ``sq``: the
    prefill's sequence split (``_seq_split``)."""
    plan = _attn_plan(cfg, r)
    ap = _subtree(params, "shared/attn")
    mlp = _subtree(params, "shared/mlp")
    every = cfg.attn_every
    for i, lp in enumerate(_mesh_layers(params, "layers/mamba",
                                        cfg.n_layers)):
        xs = _mesh_mamba(cfg, r, lp, xs, gather, cache=cache, i=i, sq=sq)
        if (i + 1) % every:
            continue
        if cache is None:
            xs = _mesh_attn(cfg, plan, r, ap, xs, pos, gather, sq)
            xs = _mesh_ffn(cfg, plan.lc, r, mlp, xs, gather, sq)[0]
        else:
            a = (i + 1) // every - 1           # the shared block's a-th use
            xs = _mesh_attn_decode(cfg, r, plan, ap, xs, poss,
                                   [c[a] for c in cache["k"]],
                                   [c[a] for c in cache["v"]], gather)
            xs = _mesh_ffn_decode(cfg, plan.lc, r, mlp, xs, gather)
    return xs


def _mesh_xlstm(cfg, r, params, xs, gather, cache=None, sq=()) -> list:
    """The ssm family's blocks on every device in ``_xlstm_forward``'s
    order (``_mesh_mlstm`` / ``_mesh_slstm``); with ``cache`` (decode)
    each block's state read from and written into its rows, a device's
    own heads; ``sq``: the prefill's sequence split."""
    n_s = _n_slstm(cfg)
    n = r.mesh.size
    mp = _mesh_layers(params, "mblocks", cfg.n_layers - n_s)
    sp = _mesh_layers(params, "sblocks", n_s) if n_s else []
    per = cfg.slstm_every - 1 if n_s else 0

    def m_step(xs, j):
        st = None
        if cache is not None:
            st = [((cache["mC"][k][j], cache["mn"][k][j],
                    cache["mm"][k][j]), cache["mconv"][k][j])
                  for k in range(n)]
        xs, new = _mesh_mlstm(cfg, r, mp[j], xs, gather, st, sq)
        for k in run_range(r.mesh) if new else ():
            (Cm, nm, mm), cv = new[k]
            for name, t in (("mC", Cm), ("mn", nm), ("mm", mm),
                            ("mconv", cv)):
                if t is not None:            # None: written in place
                    cache[name][k][j].copy_(t)
        return xs

    def s_step(xs, g):
        names = ("sc", "sn", "sm", "sh")
        st = None if cache is None else [
            tuple(cache[nm][k][g] for nm in names) for k in range(n)]
        xs, new = _mesh_slstm(cfg, r, sp[g], xs, gather, st, sq)
        for k in run_range(r.mesh) if new else ():
            for nm, t in zip(names, new[k]):
                cache[nm][k][g].copy_(t)
        return xs

    for g in range(n_s):
        for j in range(g * per, (g + 1) * per):
            xs = m_step(xs, j)
        xs = s_step(xs, g)
    for j in range(n_s * per, len(mp)):
        xs = m_step(xs, j)
    return xs


def forward_parts(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
                  patch_emb: torch.Tensor | None = None,
                  last_only: bool = False) -> tuple[list, torch.Tensor]:
    """``forward`` under mesh rules, its logits left laid out: one part a
    device, that device's batch rows and vocab columns (the whole
    sequence).  aux (0-d, on the mesh's first device) is taken over the
    whole batch.  Where the table's ``act_seq`` splits the sequence
    (``_seq_split``) the residual stream between sub-blocks is a
    device's ``S / m`` positions; every sub-block gathers the whole
    sequence inside its remat frame and reduce-scatters its output
    (``_gathered``, ``_seq_sum``)."""
    r = mesh_rules()
    mesh = r.mesh
    gather = _fsdp(r)
    dtype = dtype_of(cfg)
    cb = (None,) if cfg.family == "audio" else ()
    # whole on the sequence: a device looks up its vocab rows at every
    # position of its batch rows
    toks = constrain(tokens, "act_batch", None, *cb)
    pe = None
    if cfg.family == "vlm":
        pe = constrain(patch_emb, "act_batch", None, "act_embed")
    S = tokens.shape[1] + (0 if pe is None else patch_emb.shape[1])
    sq = _seq_split(r, S)
    zero = torch.zeros((), device=mesh.devices[0])
    xs = _mesh_embed(cfg, params, toks, r, dtype, gather, sq, pe)
    # positions whole: RoPE and K7 run on the gathered sequence
    pos = each(mesh, lambda k: torch.arange(S, device=mesh.devices[k])[None])
    auxs = [zero]
    if cfg.family == "hybrid":
        xs = _mesh_zamba(cfg, r, params, xs, gather, pos=pos, sq=sq)
    elif cfg.family == "ssm":
        xs = _mesh_xlstm(cfg, r, params, xs, gather, sq=sq)
    else:
        plan = _attn_plan(cfg, r)
        attn_p = _mesh_layers(params, "layers/attn", cfg.n_layers)
        ff_p = _mesh_layers(params, "layers/moe" if cfg.is_moe
                            else "layers/mlp", cfg.n_layers)
        auxs = []
        for ap, fp in zip(attn_p, ff_p):
            xs = _mesh_attn(cfg, plan, r, ap, xs, pos, gather, sq)
            xs, aux = _mesh_ffn(cfg, plan.lc, r, fp, xs, gather, sq)
            auxs.append(zero if aux is None else aux)
    parts = _lm_heads(cfg, params, xs, gather, sq, last_only)
    parts = constrain(parts, *(("act_batch",) + (None,) * (parts[0].dim() - 2)
                               + ("act_vocab",)))
    return parts, torch.stack(auxs).sum()


def _mesh_decode(cfg: ModelConfig, params: dict, cache: dict,
                 tokens: torch.Tensor, pos, r) -> torch.Tensor:
    """One decode step under mesh rules: every device's share (see the
    module docstring); the logits whole on the mesh's first device."""
    gather = _fsdp(r)
    dtype = dtype_of(cfg)
    B = tokens.shape[0]
    pos = torch.as_tensor(pos, device=tokens.device).long().expand(B)
    cb = (None,) if cfg.family == "audio" else ()
    toks = constrain(tokens, "act_batch", *cb)
    poss = constrain(pos.contiguous(), "act_batch")
    xs = _mesh_embed(cfg, params, toks, r, dtype, gather)
    xs = constrain(xs, "act_batch", "act_embed")
    if cfg.family == "hybrid":
        xs = _mesh_zamba(cfg, r, params, xs, gather, cache=cache, poss=poss)
    elif cfg.family == "ssm":
        xs = _mesh_xlstm(cfg, r, params, xs, gather, cache=cache)
    else:
        plan = _attn_plan(cfg, r)
        attn_p = _mesh_layers(params, "layers/attn", cfg.n_layers)
        ff_p = _mesh_layers(params, "layers/moe" if cfg.is_moe
                            else "layers/mlp", cfg.n_layers)
        for i, (ap, fp) in enumerate(zip(attn_p, ff_p)):
            xs = _mesh_attn_decode(cfg, r, plan, ap, xs, poss,
                                   [c[i] for c in cache["k"]],
                                   [c[i] for c in cache["v"]], gather)
            xs = _mesh_ffn_decode(cfg, plan.lc, r, fp, xs, gather)
    return gather_logits(_lm_heads(cfg, params, xs, gather), r)
