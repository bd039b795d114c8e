"""Mamba-2 SSD (state-space duality) layer — arXiv:2405.21060.

The port of :mod:`repro.models.ssd`.  The chunked SSD algorithm: split the
sequence into chunks of Q tokens (the last one padded); within a chunk the
quadratic ("attention-like") form is used, across chunks a recurrent state
(H = heads, P = head_dim, N = d_state) is carried:

  intra:  Y_diag = (C B^T ∘ L) X           (L = lower-tri decay products)
  state:  h' = h * decay_chunk + B^T (X * decay_tail)
  inter:  Y_off = C h_prev * decay_head

Scalar-per-head A; dt via softplus with a learned bias; a short causal
conv (SiLU) on x/B/C; gated RMSNorm on the output (z branch).  The chunk
scan is a Python loop over the T/Q chunks, as the reference's
``lax.scan`` is sequential over them; a decode step is T = 1, one chunk of
one token.  The scan runs in float32 at any model dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dtype_of, rms_norm, trunc_normal, zeros
from repro_torch.sharding import constrain, proj


class SSMCache(NamedTuple):
    conv: torch.Tensor    # (B, W-1, conv_dim)
    state: torch.Tensor   # (B, H, P, N) f32
    pos: int


def _conv_dim(cfg):
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def init_ssd(gen: torch.Generator, cfg):
    d, di, H = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    G, N, W = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv_width
    dt = dtype_of(cfg.dtype)
    conv_dim = _conv_dim(cfg)
    dev = gen.device
    return {
        # fused input projection: [z, x, B, C, dt]
        "in_proj": trunc_normal(gen, (d, 2 * di + 2 * G * N + H), 1.0, dt),
        "conv_w": trunc_normal(gen, (W, conv_dim), 4.0, dt),
        "conv_b": zeros((conv_dim,), dt, gen),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                          device=dev)),
        "dt_bias": zeros((H,), torch.float32, gen),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "norm_w": zeros((di,), dt, gen),
        "out_proj": trunc_normal(gen, (di, d), 1.0, dt),
    }


def ssd_specs(cfg):
    return {
        "in_proj": ("fsdp", "tp"),
        "conv_w": (None, "tp"),
        "conv_b": ("tp",),
        "A_log": ("tp",),
        "dt_bias": ("tp",),
        "D": ("tp",),
        "norm_w": ("tp",),
        "out_proj": ("tp", "fsdp"),
    }


def _split_proj(cfg, zxbcdt):
    di = cfg.d_inner
    GN = cfg.ssm_groups * cfg.ssm_state
    z = zxbcdt[..., :di]
    x = zxbcdt[..., di:2 * di]
    Bm = zxbcdt[..., 2 * di:2 * di + GN]
    Cm = zxbcdt[..., 2 * di + GN:2 * di + 2 * GN]
    dt_raw = zxbcdt[..., 2 * di + 2 * GN:]
    return z, x, Bm, Cm, dt_raw


def _causal_conv(xbc, w, b, init_state=None):
    """Depthwise causal conv along time, then SiLU.  xbc: (B, T, C); w:
    (W, C).  Returns the output and the last W - 1 inputs (the state)."""
    W = w.shape[0]
    if init_state is None:
        init_state = xbc.new_zeros((xbc.shape[0], W - 1, xbc.shape[2]))
    xp = torch.cat([init_state, xbc], dim=1)
    T = xbc.shape[1]
    out = xp[:, 0:T] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + T] * w[i]
    return F.silu(out + b), xp[:, -(W - 1):]


def ssd_chunked(cfg, x, Bm, Cm, dt, A, init_state=None):
    """Chunked SSD scan.

    x:  (B, T, H, P) — inputs per head.
    Bm: (B, T, G, N); Cm: (B, T, G, N); dt: (B, T, H) (post-softplus).
    A:  (H,) negative reals.
    Returns y (B, T, H, P) and the final state (B, H, P, N), in float32.
    """
    Bsz, T, H, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(cfg.ssm_chunk, T)
    nc = -(-T // Q)
    pad = nc * Q - T
    x, Bm, Cm, dt = (t.to(torch.float32) for t in (x, Bm, Cm, dt))
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    heads_per_group = H // G
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    h = init_state
    if h is None:
        h = torch.zeros((Bsz, H, Pd, N), dtype=torch.float32,
                        device=x.device)
    ys = []
    for c in range(nc):
        sl = slice(c * Q, (c + 1) * Q)
        xq, dtq = x[:, sl], dt[:, sl]
        bqh = torch.repeat_interleave(Bm[:, sl], heads_per_group, dim=2)
        cqh = torch.repeat_interleave(Cm[:, sl], heads_per_group, dim=2)
        dA = dtq * A                                     # (B, Q, H) negative
        cum = torch.cumsum(dA, dim=1)                    # segsum prefix
        # L[i, j] = exp(cum_i - cum_j) for i >= j (decay from j+1..i).  Mask
        # BEFORE the exp: the upper triangle holds large positive values
        # whose exp overflows.
        Li = cum[:, :, None, :] - cum[:, None, :, :]     # (B, Q, Q, H)
        L = torch.exp(torch.where(tri[None, :, :, None], Li, -1e30))
        # intra-chunk (quadratic) term
        scores = torch.einsum("bihn,bjhn->bijh", cqh, bqh) * L
        xdt = xq * dtq[..., None]                        # (B, Q, H, P)
        y = torch.einsum("bijh,bjhp->bihp", scores, xdt)
        # inter-chunk: contribution of the carried state
        decay_head = torch.exp(cum)                      # (B, Q, H)
        y = y + torch.einsum("bihn,bhpn->bihp", cqh, h) * decay_head[..., None]
        # state update
        total = cum[:, -1, :]                            # (B, H)
        decay_tail = torch.exp(total[:, None, :] - cum)  # (B, Q, H)
        h = h * torch.exp(total)[:, :, None, None] + torch.einsum(
            "bjhn,bjhp->bhpn", bqh * decay_tail[..., None], xdt)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :T]
    return y, h


def ssd_layer(p, u, cfg, cache: SSMCache | None = None):
    """Full Mamba-2 block.  u: (B, T, d) -> (B, T, d) (and the cache
    advanced by T when one is given, else None)."""
    Bsz, T, d = u.shape
    H, Pd = cfg.ssm_heads, cfg.ssm_head_dim
    di = cfg.d_inner
    GN = cfg.ssm_groups * cfg.ssm_state

    z, x, Bm, Cm, dt_raw = _split_proj(cfg, proj(u, p["in_proj"]))
    xbc = torch.cat([x, Bm, Cm], dim=-1)
    conv_init = cache.conv if cache is not None else None
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_init)
    x = xbc[..., :di]
    Bm = xbc[..., di:di + GN]
    Cm = xbc[..., di + GN:]

    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = x.reshape(Bsz, T, H, Pd)
    Bh = Bm.reshape(Bsz, T, cfg.ssm_groups, cfg.ssm_state)
    Ch = Cm.reshape(Bsz, T, cfg.ssm_groups, cfg.ssm_state)

    init_state = cache.state if cache is not None else None
    y, h_fin = ssd_chunked(cfg, xh, Bh, Ch, dt, A, init_state)
    y = y + xh.to(torch.float32) * p["D"][None, None, :, None]
    y = y.reshape(Bsz, T, di).to(u.dtype)
    y = constrain(y, "dp", None, "tp")
    # gated RMSNorm (Mamba-2's "norm before gate" variant)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    out = proj(y, p["out_proj"])
    if cache is not None:
        return out, SSMCache(conv=conv_state, state=h_fin,
                             pos=cache.pos + T)
    return out, None


def init_ssm_cache(cfg, batch: int, device=None) -> SSMCache:
    return SSMCache(
        conv=torch.zeros((batch, cfg.ssm_conv_width - 1, _conv_dim(cfg)),
                         dtype=dtype_of(cfg.dtype), device=device),
        state=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                           cfg.ssm_state), dtype=torch.float32,
                          device=device),
        pos=0,
    )
