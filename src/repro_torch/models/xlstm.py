"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, sequential), after Beck et al. 2024.

Twin of ``src/repro/models/xlstm.py``, with its documented
simplifications (one projection per q / k / v, one depthwise conv on the
shared path, RMSNorm per block).  mLSTM is linear attention with
exponential gating, ``C_t = f_t C_{t-1} + i_t v_t k_t^T``, read out as
``h = (C q) / max(|n . q|, 1)``; it runs chunkwise, stabilised in log
space with a running max (the m-state), its inter-chunk state carried by
a Python loop (the reference's ``lax.scan``).  sLSTM keeps the classic
recurrence with exponential gating and a stabiliser, a loop over time.
No kernel: the products are the reference's einsums.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rms_norm
from repro_torch.models.ssm import _causal_conv

_NEG = -1e30


def mlstm_chunked(q, k, v, i_pre, f_pre, chunk: int, state=None):
    """q, k, v: (B, S, H, P); i_pre, f_pre: (B, S, H) pre-activation
    gates.  Returns (h (B, S, H, P), (C (B, H, P, P), n (B, H, P), m (B,
    H))), the state in fp32."""
    sums, rest, st = mlstm_chunk_sums(q, k, v, i_pre, f_pre, chunk, state)
    return mlstm_chunk_read(sums, rest, v), st


def mlstm_chunk_sums(q, k, v, i_pre, f_pre, chunk: int, state=None):
    """``mlstm_chunked`` up to its contractions over the k dim p: q, k
    (B, S, H, Pk) may hold rows Pk of the head dim P = v's last (each
    sum over p is then a partial sum, and the state's C / n hold those
    rows).  Returns ((qk, h_inter, d_inter) the sums over p, the read's
    (w_intra, m_read), the new (C, n, m))."""
    B, S, H, Pk = q.shape
    Lc = min(chunk, S)
    assert S % Lc == 0
    nc = S // Lc
    scale = 1.0 / (v.shape[-1] ** 0.5)

    logf = F.logsigmoid(f_pre.float())                    # (B, S, H) <= 0
    logi = i_pre.float()

    lf = logf.reshape(B, nc, Lc, H)
    li = logi.reshape(B, nc, Lc, H)
    Fc = torch.cumsum(lf, dim=2)                          # within-chunk
    F_last = Fc[:, :, -1, :]                              # (B, nc, H)
    qc = (q.float() * scale).reshape(B, nc, Lc, H, Pk)
    kc = k.float().reshape(B, nc, Lc, H, Pk)
    vc = v.float().reshape(B, nc, Lc, H, v.shape[-1])

    # per-position source weight (log): i * f-decay to the chunk's end
    src = F_last[:, :, None, :] - Fc + li                 # (B, nc, Lc, H)
    m_loc = torch.amax(src, dim=2)                        # (B, nc, H)

    # ---- inter-chunk loop over (C, n, m) ----
    if state is None:
        C = torch.zeros((B, H, Pk, v.shape[-1]), dtype=torch.float32,
                        device=q.device)
        n = torch.zeros((B, H, Pk), dtype=torch.float32, device=q.device)
        m = torch.full((B, H), _NEG, dtype=torch.float32, device=q.device)
    else:
        C, n, m = state
    C_pre, n_pre, m_pre = [], [], []
    for c in range(nc):
        C_pre.append(C)
        n_pre.append(n)
        m_pre.append(m)
        m_new = torch.maximum(F_last[:, c] + m, m_loc[:, c])   # (B, H)
        w_old = torch.exp(F_last[:, c] + m - m_new)
        w_src = torch.exp(src[:, c] - m_new[:, None, :])      # (B, Lc, H)
        C = C * w_old[..., None, None] + torch.einsum(
            "blhp,blhq->bhpq", kc[:, c] * w_src[..., None], vc[:, c])
        n = n * w_old[..., None] + torch.einsum(
            "blhp,blh->bhp", kc[:, c], w_src)
        m = m_new
    C_pre = torch.stack(C_pre, dim=1)                     # (B, nc, H, P, P)
    n_pre = torch.stack(n_pre, dim=1)                     # (B, nc, H, P)
    m_pre = torch.stack(m_pre, dim=1)                     # (B, nc, H)

    # ---- intra-chunk attention-like term ----
    # pairwise log weight: F_t - F_s + li_s  (s <= t)
    lw = Fc[:, :, :, None, :] - Fc[:, :, None, :, :] + li[:, :, None, :, :]
    ar = torch.arange(Lc, device=q.device)
    mask = ar[:, None] >= ar[None, :]
    lw = torch.where(mask[None, None, :, :, None], lw, _NEG)  # (B,nc,t,s,H)
    # read-time stabiliser: max over the intra sources and the carried state
    m_read_intra = torch.amax(lw, dim=3)                  # (B, nc, Lc, H)
    m_carry = Fc + m_pre[:, :, None, :]                   # (B, nc, Lc, H)
    m_read = torch.maximum(m_read_intra, m_carry)

    w_intra = torch.exp(lw - m_read[:, :, :, None, :])
    qk = torch.einsum("bclhp,bcshp->bclsh", qc, kc)
    w_carry = torch.exp(m_carry - m_read)                 # (B, nc, Lc, H)
    h_inter = torch.einsum("bclhp,bchpq,bclh->bclhq", qc, C_pre, w_carry)
    d_inter = torch.einsum("bclhp,bchp,bclh->bclh", qc, n_pre, w_carry)
    return (qk, h_inter, d_inter), (w_intra, m_read), (C, n, m)


def mlstm_chunk_read(sums, rest, v):
    """h (B, S, H, Pv) in v's dtype from ``mlstm_chunk_sums``' sums over
    the whole of p (``h_inter``: its columns Pv) and v (B, S, H, Pv),
    v's columns Pv of the head."""
    qk, h_inter, d_inter = sums
    w_intra, m_read = rest
    B, nc, Lc, H = m_read.shape
    vc = v.float().reshape(B, nc, Lc, H, v.shape[-1])
    h_intra = torch.einsum("bclsh,bclsh,bcshp->bclhp", qk, w_intra, vc)
    d_intra = torch.einsum("bclsh,bclsh->bclh", qk, w_intra)
    denom = torch.maximum(torch.abs(d_intra + d_inter),
                          torch.exp(-m_read)) + 1e-9
    h = (h_intra + h_inter) / denom[..., None]
    return h.reshape(B, nc * Lc, H, v.shape[-1]).to(v.dtype)


def mlstm_decode_step(q, k, v, i_pre, f_pre, state):
    """One token.  q, k, v: (B, H, P); gates (B, H)."""
    (h, d), st = mlstm_step_sums(q, k, v, i_pre, f_pre, state)
    return mlstm_step_read(h, d, st[2], q.dtype), st


def mlstm_step_sums(q, k, v, i_pre, f_pre, state):
    """``mlstm_decode_step`` up to its contractions over p: q, k (B, H,
    Pk) may hold rows Pk of P = v's last dim, and the state (C, n, m)
    those rows of C / n.  Returns ((h, d) the sums over p, the new
    state)."""
    C, n, m = state
    scale = 1.0 / (v.shape[-1] ** 0.5)
    logf = F.logsigmoid(f_pre.float())
    logi = i_pre.float()
    m_new = torch.maximum(logf + m, logi)
    w_old = torch.exp(logf + m - m_new)
    w_in = torch.exp(logi - m_new)
    kf = k.float() * w_in[..., None]
    C_new = C * w_old[..., None, None] + torch.einsum(
        "bhp,bhq->bhpq", kf, v.float())
    n_new = n * w_old[..., None] + kf
    qs = q.float() * scale
    h = torch.einsum("bhp,bhpq->bhq", qs, C_new)
    d = torch.einsum("bhp,bhp->bh", qs, n_new)
    return (h, d), (C_new, n_new, m_new)


def mlstm_step_read(h, d, m_new, dtype):
    """One token's h from ``mlstm_step_sums``' sums over the whole of
    p."""
    d = torch.maximum(torch.abs(d), torch.exp(-m_new)) + 1e-9
    return (h / d[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _mlstm_qkv(c, xm, p, dt, qkv_dtype=None):
    """q, k (from the conv path), v (from the raw path) through the
    per-head block-diagonal projections (weights cast to ``dt``; the
    products in ``qkv_dtype``, default ``dt``)."""
    qd = qkv_dtype or dt

    def proj(a, w):
        return torch.einsum("...hp,hpj->...hj", a.to(qd), w.to(dt).to(qd))
    return proj(c, p["wq"]), proj(c, p["wk"]), proj(xm, p["wv"])


def mlstm_proj(x, p, *, conv_cache=None, decode=False, gate_dtype=None,
               qkv_dtype=None):
    """The mLSTM block's input side for ``p``'s heads (``wq`` (H, P, P),
    or (H, Pr, P): the P rows Pr of every head): ``up_proj`` (d, 2 H P:
    their ``xm`` columns, then their ``z`` columns), the causal conv,
    q / k / v (..., H, P) (a sum over ``wq``'s rows: with Pr rows a
    partial sum, which ``qkv_dtype`` fp32 keeps unrounded) and the gate
    pre-activations ``c @ wi``, ``c @ wf`` (..., H_all) over ``p``'s rows
    of ``wi`` / ``wf`` (all of d_inner: the gates, in x's dtype; some
    rows: a partial sum, which ``gate_dtype`` fp32 keeps unrounded until
    the parts are summed).  Returns (q, k, v, i_pre, f_pre, z,
    conv_cache)."""
    H, P = p["wq"].shape[0], p["wq"].shape[1]
    up = x @ p["up_proj"].to(x.dtype)
    xm, z = torch.chunk(up, 2, dim=-1)
    c, conv_cache = _causal_conv(xm[:, None] if decode else xm,
                                 p["conv_w"].to(x.dtype), conv_cache)
    if decode:
        c = c[:, 0]
    q, k, v = _mlstm_qkv(c.unflatten(-1, (H, P)), xm.unflatten(-1, (H, P)),
                         p, x.dtype, qkv_dtype)
    gd = gate_dtype or x.dtype
    i_pre = c.to(gd) @ p["wi"].to(x.dtype).to(gd)
    f_pre = c.to(gd) @ p["wf"].to(x.dtype).to(gd)
    return q, k, v, i_pre, f_pre, z, conv_cache


def mlstm_scan(q, k, v, i_pre, f_pre, cfg, *, state=None, decode=False):
    """The mLSTM cell over q / k / v (..., H, P): h (..., H P) and the new
    (C, n, m)."""
    if decode:
        h, mstate = mlstm_decode_step(q, k, v, i_pre, f_pre, state)
    else:
        h, mstate = mlstm_chunked(q, k, v, i_pre, f_pre, cfg.ssd_chunk,
                                  state)
    return h.flatten(-2), mstate


def mlstm_block(x, p, cfg, *, state=None, decode=False):
    """p keys: up_proj (d, 2 di), conv_w (K, di), wq / wk / wv (H, P, P)
    block-diagonal per head, wi / wf (di, H), norm_inner (di,), down_proj
    (di, d).  Returns (out, (mstate, conv_cache))."""
    q, k, v, i_pre, f_pre, z, conv_cache = mlstm_proj(
        x, p, conv_cache=None if state is None else state[1], decode=decode)
    h, mstate = mlstm_scan(q, k, v, i_pre, f_pre, cfg,
                           state=None if state is None else state[0],
                           decode=decode)
    h = rms_norm(h, p["norm_inner"], cfg.norm_eps)
    h = h * F.silu(z)
    return h @ p["down_proj"].to(x.dtype), (mstate, conv_cache)


def slstm_cells(x, p, *, state=None, decode=False):
    """The sLSTM recurrence of ``p``'s heads (``r_gates`` (H, dh, 4 dh),
    ``w_gates`` (d, H dh 4) their columns, head-major): y (..., H dh) in
    x's dtype and the new (c, n, m, h) (B, H, dh) in fp32.  The prefill
    path is a loop over time (sLSTM does not parallelise in time), the
    input projection taken for every step in one product before it;
    decode is one step of the same cell."""
    H, dh = p["r_gates"].shape[0], p["r_gates"].shape[1]
    B = x.shape[0]
    if state is None:
        z = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
        state = (z, z + 1e-6, z - 1e30, z)
    rg = p["r_gates"].to(x.dtype)

    def step(carry, gx):                     # gx: (B, H dh 4), x's dtype
        c, n, m, h = carry
        gr = torch.einsum("bhe,hek->bhk", h.to(x.dtype), rg)
        g = gx.reshape(B, H, dh, 4) + gr.reshape(B, H, dh, 4)
        gi, gf, gz, go = g.unbind(-1)
        log_f = F.logsigmoid(gf.float())
        log_i = gi.float()
        m_new = torch.maximum(log_f + m, log_i)
        wi = torch.exp(log_i - m_new)
        wf = torch.exp(log_f + m - m_new)
        c_new = wf * c + wi * torch.tanh(gz.float())
        n_new = wf * n + wi
        h_new = torch.sigmoid(go.float()) * c_new / torch.clamp(n_new,
                                                                min=1e-6)
        return c_new, n_new, m_new, h_new

    gx = x @ p["w_gates"].to(x.dtype)
    if decode:
        state = step(state, gx)
        return state[3].reshape(B, H * dh).to(x.dtype), state
    hs = []
    for t in range(x.shape[1]):
        state = step(state, gx[:, t])
        hs.append(state[3])
    return (torch.stack(hs, dim=1).reshape(B, x.shape[1], H * dh)
            .to(x.dtype), state)


def slstm_up(y, p, cfg):
    """The sLSTM block's output side up to ``down``: RMSNorm over d, then
    the GELU projection ``up``."""
    y = rms_norm(y, p["ln"], cfg.norm_eps)
    return F.gelu(y @ p["up"].to(y.dtype), approximate="tanh")


def slstm_block(x, p, cfg, *, state=None, decode=False):
    """p keys: w_gates (d, H dh 4), r_gates (H, dh, 4 dh), ln (d,), up
    (d, ff), down (ff, d).  x is (B, d) with ``decode``, else (B, S, d).

    Heads H = cfg.n_heads, dh = d / H; the recurrent matrix R is per-head
    block-diagonal (``slstm_cells``).  Returns (out, (c, n, m, h)), the
    state in fp32."""
    y, state = slstm_cells(x, p, state=state, decode=decode)
    return slstm_up(y, p, cfg) @ p["down"].to(x.dtype), state
