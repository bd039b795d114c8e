"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The port of :mod:`repro.models.rglru`.  The real-gated linear recurrent
unit:

  r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
  i_t = sigmoid(W_x x_t + b_x)          (input gate)
  a_t = a^(c * r_t),  a = sigmoid(Lambda)  (per-channel, c = 8)
  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The reference runs the linear recurrence as ``jax.lax.associative_scan``;
the port runs it as a log-depth doubling scan over whole tensors
(:func:`_rglru_scan`: ceil(log2 T) steps, no Python loop over T).  The
products associate in another order than XLA's, so the two agree within
rounding, not bit for bit.  Decode is the same code at T = 1.

The full recurrent block (Griffin):  x -> [gate branch: GeLU(W_g x)]
                                      x -> [W_r x -> conv1d(4) -> RG-LRU]
                                      out = W_o (gate * lru_out)
The gate's GeLU is the tanh form, as ``jax.nn.gelu``'s default.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dtype_of, trunc_normal, zeros
from repro_torch.sharding import proj

C_CONST = 8.0
CONV_WIDTH = 4


class LRUCache(NamedTuple):
    conv: torch.Tensor    # (B, W-1, lru_width)
    h: torch.Tensor       # (B, lru_width) f32
    pos: int


def init_rglru_block(gen: torch.Generator, cfg):
    d = cfg.d_model
    w = cfg.lru_width or d
    dt = dtype_of(cfg.dtype)
    # Lambda so that a = sigmoid(Lambda) spans (0.9, 0.999), the paper's
    # init range
    a = torch.linspace(0.9, 0.999, w, dtype=torch.float32, device=gen.device)
    return {
        "w_gate": trunc_normal(gen, (d, w), 1.0, dt),
        "w_rec": trunc_normal(gen, (d, w), 1.0, dt),
        "conv_w": trunc_normal(gen, (CONV_WIDTH, w), 4.0, dt),
        "conv_b": zeros((w,), dt, gen),
        "wa": trunc_normal(gen, (w, w), 1.0, dt),
        "ba": zeros((w,), torch.float32, gen),
        "wx": trunc_normal(gen, (w, w), 1.0, dt),
        "bx": zeros((w,), torch.float32, gen),
        "lam": torch.log(a / (1.0 - a)),
        "w_out": trunc_normal(gen, (w, d), 1.0, dt),
    }


def rglru_specs(cfg):
    return {
        "w_gate": ("fsdp", "tp"),
        "w_rec": ("fsdp", "tp"),
        "conv_w": (None, "tp"),
        "conv_b": ("tp",),
        "wa": ("fsdp", "tp"),
        "ba": ("tp",),
        "wx": ("fsdp", "tp"),
        "bx": ("tp",),
        "lam": ("tp",),
        "w_out": ("tp", "fsdp"),
    }


def _causal_conv(x, w, b, init_state=None):
    """Depthwise causal conv along time (no activation).  Returns the
    output and the last W - 1 inputs (the state)."""
    W = w.shape[0]
    if init_state is None:
        init_state = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    xp = torch.cat([init_state, x], dim=1)
    T = x.shape[1]
    out = xp[:, 0:T] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + T] * w[i]
    return out + b, xp[:, -(W - 1):]


def _rglru_scan(x, a_t, h0=None):
    """h_t = a_t h_{t-1} + x_t over T.  x, a_t: (B, T, W); h0: (B, W).

    A doubling (Hillis-Steele) scan of the reference's combine
    ``(a1, b1), (a2, b2) -> (a1 a2, b1 a2 + b2)``: after the step of
    offset s, position t holds the combination of positions t - 2s + 1..t.
    ``h0`` is folded in as a virtual first step (a = 1, b = h0), as in the
    reference."""
    if h0 is not None:
        x = torch.cat([h0[:, None], x], dim=1)
        a_t = torch.cat([torch.ones_like(a_t[:, :1]), a_t], dim=1)
    T = x.shape[1]
    a, b = a_t, x
    s = 1
    while s < T:
        # each step fills a new tensor through slice copies and never
        # writes into one that a product saved for the backward pass
        # (torch.cat in its place costs 22% more on an H100 at serving's
        # shape)
        nb = torch.empty_like(b)
        nb[:, :s] = b[:, :s]
        nb[:, s:] = b[:, :-s] * a[:, s:] + b[:, s:]
        if 2 * s < T:
            na = torch.empty_like(a)
            na[:, :s] = a[:, :s]
            na[:, s:] = a[:, :-s] * a[:, s:]
            a = na
        b = nb
        s *= 2
    return b[:, 1:] if h0 is not None else b


def rglru_block(p, u, cfg, cache: LRUCache | None = None):
    """u: (B, T, d) -> (B, T, d) (and the cache advanced by T when one is
    given, else None)."""
    gate = F.gelu(proj(u, p["w_gate"]), approximate="tanh")
    x = proj(u, p["w_rec"])
    conv_init = cache.conv if cache is not None else None
    x, conv_state = _causal_conv(x, p["conv_w"], p["conv_b"], conv_init)

    xf = x.to(torch.float32)
    r = torch.sigmoid(proj(xf, p["wa"].to(torch.float32)) + p["ba"])
    i = torch.sigmoid(proj(xf, p["wx"].to(torch.float32)) + p["bx"])
    log_a = -C_CONST * r * F.softplus(-p["lam"])  # log sigmoid(lam)^(c r)
    a_t = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - a_t * a_t, min=1e-12)) * (i * xf)

    h0 = cache.h if cache is not None else None
    h = _rglru_scan(gated_x, a_t, h0)
    y = proj(h.to(u.dtype) * gate, p["w_out"])
    if cache is not None:
        return y, LRUCache(conv=conv_state, h=h[:, -1].to(torch.float32),
                           pos=cache.pos + u.shape[1])
    return y, None


def init_lru_cache(cfg, batch: int, device=None) -> LRUCache:
    w = cfg.lru_width or cfg.d_model
    return LRUCache(
        conv=torch.zeros((batch, CONV_WIDTH - 1, w),
                         dtype=dtype_of(cfg.dtype), device=device),
        h=torch.zeros((batch, w), dtype=torch.float32, device=device),
        pos=0,
    )
