"""Mamba2 (SSD, state-space duality) block: chunked prefill path and O(1)
recurrent decode.

Twin of ``src/repro/models/ssm.py``.  Within a chunk the recurrence is
unrolled as a masked, decay-weighted attention-like product; across
chunks a Python loop carries the (H, N, P) state (the reference's
``lax.scan``).  No kernel: the products are the reference's einsums.

Shapes: B batch, S seq, H ssm heads, P ssm head dim, N state dim.  The
B / C projections are shared across heads (n_groups = 1, as in Mamba2).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rms_norm


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 cache: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x (B, S, D), w (K, D).  Returns (y,
    new_cache), the cache holding the last K - 1 inputs for decode."""
    K = w.shape[0]
    pad = x.new_zeros(x[:, :K - 1].shape) if cache is None else cache
    xp = torch.cat([pad, x], dim=1)                       # (B, S+K-1, D)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K))
    new_cache = xp[:, -(K - 1):] if K > 1 else xp[:, :0]
    return F.silu(y), new_cache


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
                C_: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                chunk: int, h0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD scan.  x (B, S, H, P), dt (B, S, H) pre-softplus, B_ / C_
    (B, S, N), A (H,) log, D (H,).  Returns (y (B, S, H, P), final state
    (B, H, N, P) fp32)."""
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    Lc = min(chunk, S)
    assert S % Lc == 0
    nc = S // Lc
    delta = F.softplus(dt.float())                        # (B, S, H)
    a_log = delta * (-torch.exp(A.float()))               # log decay <= 0
    xb = x.float() * delta[..., None]                     # dt-scaled input

    ac = a_log.reshape(Bb, nc, Lc, H)
    la = torch.cumsum(ac, dim=2)                          # within-chunk csum
    la_last = la[:, :, -1:, :]                            # (B, nc, 1, H)
    xc = xb.reshape(Bb, nc, Lc, H, P)
    Bc = B_.reshape(Bb, nc, Lc, N).float()
    Cc = C_.reshape(Bb, nc, Lc, N).float()

    # ---- intra-chunk (quadratic within Lc) ----
    cb = torch.einsum("bcln,bcsn->bcls", Cc, Bc)          # (B, nc, Lc, Lc)
    dec = la[:, :, :, None, :] - la[:, :, None, :, :]     # (B,nc,Lt,Ls,H)
    ar = torch.arange(Lc, device=x.device)
    mask = ar[:, None] >= ar[None, :]
    # masked before the exp, not after as the reference does: above the
    # diagonal dec = -(decay from t to s) >= 0 overflows to inf once a
    # chunk's decays sum past ~88 (zamba2-7b's 256-step chunks at its
    # init), and the reference's where then passes 0 * inf = NaN to the
    # grads; the values are the same bits (exp(-inf) = 0)
    dec = torch.exp(torch.where(mask[None, None, :, :, None], dec,
                                -torch.inf))
    y_intra = torch.einsum("bcls,bclsh,bcshp->bclhp", cb, dec, xc)

    # ---- chunk summaries: the state each chunk contributes ----
    w_in = torch.exp(la_last - la)                        # (B, nc, Lc, H)
    h_loc = torch.einsum("bcsn,bcsh,bcshp->bchnp", Bc, w_in, xc)
    a_tot = torch.exp(la_last[:, :, 0, :])                # (B, nc, H)

    # ---- inter-chunk scan ----
    h = (torch.zeros((Bb, H, N, P), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    before = []
    for c in range(nc):
        before.append(h)                                  # state BEFORE chunk
        h = h * a_tot[:, c, :, None, None] + h_loc[:, c]
    h_before = torch.stack(before, dim=1)                 # (B, nc, H, N, P)

    w_out = torch.exp(la)                                 # (B, nc, Lc, H)
    y_inter = torch.einsum("bcln,bclh,bchnp->bclhp", Cc, w_out, h_before)

    y = (y_intra + y_inter).reshape(Bb, S, H, P)
    y = y + x.float() * D.float()[None, None, :, None]
    return y.to(x.dtype), h


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
                    C_: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                    h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence.  x (B, H, P), dt (B, H), B_ / C_ (B, N),
    h (B, H, N, P)."""
    delta = F.softplus(dt.float())
    decay = torch.exp(delta * (-torch.exp(A.float())))    # (B, H)
    xb = x.float() * delta[..., None]
    h_new = h * decay[..., None, None] + torch.einsum(
        "bn,bhp->bhnp", B_.float(), xb)
    y = torch.einsum("bn,bhnp->bhp", C_.float(), h_new)
    y = y + x.float() * D.float()[None, :, None]
    return y.to(x.dtype), h_new


# ---------------------------------------------------------------------------
# the full Mamba2 block
# ---------------------------------------------------------------------------

def mamba2_cols(cfg, h0: int, h1: int) -> dict[str, list[tuple[int, int]]]:
    """The columns of the whole ``in_proj`` / ``conv_w`` that SSM heads
    [h0, h1) read, as ``(start, stop)`` ranges in the order the block
    splits them: their ``z``, ``x``, the shared ``B`` / ``C`` (one group,
    whole) and their ``dt``; ``inner``: their channels of ``d_inner``
    (``norm_inner``, ``out_proj``)."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    x = (h0 * P, h1 * P)
    return dict(in_proj=[x, (di + x[0], di + x[1]), (2 * di, 2 * di + 2 * N),
                         (2 * di + 2 * N + h0, 2 * di + 2 * N + h1)],
                conv_w=[x, (di, di + 2 * N)], inner=[x])


def mamba2_mix(x: torch.Tensor, p: dict, cfg, *, state: tuple | None = None,
               decode: bool = False):
    """The Mamba2 block up to its inner norm: ``y * silu(z)`` (..., di)
    and the new state.  The heads are ``p``'s: ``a_log`` (H,) and the
    columns of ``in_proj`` / ``conv_w`` laid out as ``mamba2_cols``
    gives them for those heads (all of them: the whole leaves)."""
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    H = p["a_log"].shape[-1]
    di = H * P
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xin, BC, dt = torch.split(zxbcdt, [di, di, 2 * N, H], dim=-1)
    conv_in = torch.cat([xin, BC], dim=-1)                # (..., di + 2N)
    dt = dt + p["dt_bias"].to(x.dtype)

    if decode:
        ssm_h, conv_cache = state
        conv_out, conv_cache = _causal_conv(
            conv_in[:, None], p["conv_w"].to(x.dtype), conv_cache)
        conv_out = conv_out[:, 0]
        xs, B_, C_ = torch.split(conv_out, [di, N, N], dim=-1)
        y, ssm_h = ssd_decode_step(xs.reshape(-1, H, P), dt, B_, C_,
                                   p["a_log"], p["d_skip"], ssm_h)
        y = y.reshape(-1, di)
    else:
        B0 = x.shape[0]
        conv_out, conv_cache = _causal_conv(
            conv_in, p["conv_w"].to(x.dtype),
            None if state is None else state[1])
        xs, B_, C_ = torch.split(conv_out, [di, N, N], dim=-1)
        y, ssm_h = ssd_chunked(
            xs.reshape(B0, -1, H, P), dt, B_, C_, p["a_log"], p["d_skip"],
            cfg.ssd_chunk, None if state is None else state[0])
        y = y.reshape(B0, -1, di)
    return y * F.silu(z), (ssm_h, conv_cache)


def mamba2_block(x: torch.Tensor, p: dict, cfg, *, state: tuple | None = None,
                 decode: bool = False):
    """p keys: in_proj (d, 2 di + 2N + H), conv_w (K, di + 2N), a_log (H,),
    d_skip (H,), dt_bias (H,), norm_inner (di,), out_proj (di, d).  x is
    (B, d) with ``decode``, else (B, S, d).

    Returns (y, new_state); state = (ssm_h (B, H, N, P), conv_cache)."""
    y, state = mamba2_mix(x, p, cfg, state=state, decode=decode)
    y = rms_norm(y, p["norm_inner"], cfg.norm_eps)
    return y @ p["out_proj"].to(x.dtype), state
