"""Attention blocks: GQA/MQA/MHA, RoPE, sliding window, KV cache.

The port of :mod:`repro.models.attention` for the decoder families: causal
self-attention with RoPE (cross-attention, bidirectional attention and
attention without RoPE wait with the vlm and encdec families).  Three
interchangeable implementations (``cfg.attn_impl``), as in the JAX
package:

  einsum  — materialized logits; right for short sequences.
  chunked — online softmax over kv chunks (a Python loop): peak memory
            O(Sq * chunk) instead of O(Sq * Skv).
  flash   — the hand-written CUDA kernel
            (:mod:`repro_torch.kernels.flash_attention`); its plain version
            on the CPU.

Decode attends a single query over the cache with explicit length masking
and stays plain PyTorch, as it is plain JAX in the reference; sliding-window
caches are ring buffers of size ``window``.  :func:`decode_attention` is
functional by default, as in the JAX package: it writes the new token into
a copy of the cache.  With ``inplace=True`` it writes into the caller's
tensors instead (no copy of the whole cache per step), which consumes the
cache passed in.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import dtype_of, rope, trunc_normal, zeros

NEG_INF = -1e30


def init_attn(gen: torch.Generator, cfg):
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = dtype_of(cfg.dtype)
    p = {
        "wq": trunc_normal(gen, (d, H * hd), 1.0, dt),
        "wk": trunc_normal(gen, (d, K * hd), 1.0, dt),
        "wv": trunc_normal(gen, (d, K * hd), 1.0, dt),
        "wo": trunc_normal(gen, (H * hd, d), 1.0, dt),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros((H * hd,), dt, gen)
        p["bk"] = zeros((K * hd,), dt, gen)
        p["bv"] = zeros((K * hd,), dt, gen)
    return p


def _qkv(p, x, cfg):
    B, S = x.shape[:2]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, H, hd), k.reshape(B, S, K, hd),
            v.reshape(B, S, K, hd))


def _mask(Sq, Skv, causal, window, device, j=None):
    """(Sq, Skv) visibility of key j to query i (end-aligned)."""
    i = torch.arange(Sq, device=device)[:, None] + (Skv - Sq)
    if j is None:
        j = torch.arange(Skv, device=device)
    j = j[None, :]
    mask = torch.ones((Sq, j.shape[1]), dtype=torch.bool, device=device)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= j > i - window
    return mask


def _einsum_attn(q, k, v, causal, window):
    """q: (B,Sq,H,hd); k/v: (B,Skv,K,hd). Materialized-logit attention."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    g = H // K
    qh = q.reshape(B, Sq, K, g, hd)
    logits = torch.einsum(
        "bqkgd,bskd->bkgqs", qh.to(torch.float32), k.to(torch.float32)
    ) * (hd ** -0.5)
    mask = _mask(Sq, Skv, causal, window, q.device)
    logits = torch.where(mask, logits, NEG_INF)
    pattn = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", pattn, v.to(torch.float32))
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _chunked_attn(q, k, v, causal, window, chunk):
    """Online softmax over kv chunks; math identical to the flash kernel."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    g = H // K
    qh = q.reshape(B, Sq, K, g, hd).to(torch.float32) * (hd ** -0.5)
    m = torch.full((B, K, g, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, K, g, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, K, g, Sq, hd), dtype=torch.float32,
                      device=q.device)
    for lo in range(0, Skv, chunk):
        kb = k[:, lo:lo + chunk].to(torch.float32)
        vb = v[:, lo:lo + chunk].to(torch.float32)
        j_pos = torch.arange(lo, lo + chunk, device=q.device)
        s = torch.einsum("bqkgd,bskd->bkgqs", qh, kb)
        mask = _mask(Sq, Skv, causal, window, q.device, j_pos)
        mask = mask[:, :kb.shape[1]]   # the last chunk may be short
        s = torch.where(mask[None, None, None], s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    return out.to(q.dtype)


def multihead_attention(
    p,
    x: torch.Tensor,
    cfg,
    positions: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    impl: Optional[str] = None,
    return_kv: bool = False,
):
    """Full-sequence causal self-attention (train / prefill)."""
    q, k, v = _qkv(p, x, cfg)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    impl = impl or cfg.attn_impl
    if impl == "auto":
        impl = "einsum" if k.shape[1] <= 8192 else "chunked"
    if impl == "flash":
        o = flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, window=window,
        ).transpose(1, 2)
    elif impl == "chunked":
        o = _chunked_attn(q, k, v, True, window, cfg.attn_chunk)
    else:
        o = _einsum_attn(q, k, v, True, window)
    B, S = o.shape[0], o.shape[1]
    out = o.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out


# ------------------------------------------------------------------ KV cache
class KVCache(NamedTuple):
    """KV cache of one layer; with cfg.kv_cache_dtype == "int8" the k/v
    planes are symmetric per-(token, head) absmax-quantized int8 with bf16
    scales.
    """

    k: torch.Tensor   # (B, S_cache, K, hd) — ring buffer if windowed
    v: torch.Tensor
    k_scale: Any      # (B, S_cache, K, 1) or None
    v_scale: Any
    pos: int          # absolute position of the next token


def _cache_is_q(cfg) -> bool:
    return cfg.kv_cache_dtype == "int8"


def quantize_kv(x: torch.Tensor):
    """(…, hd) -> int8 values + per-row absmax scale."""
    x32 = x.to(torch.float32)
    scale = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
    scale = torch.clamp(scale, min=1e-6)
    q = torch.clamp(torch.round(x32 / scale * 127.0), -127, 127).to(
        torch.int8)
    return q, scale.to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype):
    return (q.to(torch.float32) * (scale.to(torch.float32) / 127.0)).to(dtype)


def init_kv_cache(cfg, batch: int, max_len: int,
                  window: Optional[int] = None, device=None):
    size = min(max_len, window) if window else max_len
    shape = (batch, size, cfg.n_kv_heads, cfg.hd)
    if _cache_is_q(cfg):
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:-1] + (1,), dtype=torch.bfloat16,
                                device=device),
            v_scale=torch.zeros(shape[:-1] + (1,), dtype=torch.bfloat16,
                                device=device),
            pos=0,
        )
    dt = dtype_of(cfg.dtype)
    return KVCache(
        k=torch.zeros(shape, dtype=dt, device=device),
        v=torch.zeros(shape, dtype=dt, device=device),
        k_scale=None, v_scale=None, pos=0,
    )


def fill_kv_cache(cfg, k, v, max_len: int, window: Optional[int] = None):
    """Build a cache from prefill keys/values (end-aligned for ring buffers)."""
    if _cache_is_q(cfg):
        # the same round trip through one bf16 plane per tensor as the
        # reference (values and scale side by side)
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        base = fill_kv_cache(
            cfg.replace(kv_cache_dtype="model"),
            torch.cat([kq.to(torch.bfloat16),
                       ks.expand(kq.shape[:-1] + (1,)).to(torch.bfloat16)],
                      dim=-1),
            torch.cat([vq.to(torch.bfloat16),
                       vs.expand(vq.shape[:-1] + (1,)).to(torch.bfloat16)],
                      dim=-1),
            max_len, window,
        )
        return KVCache(
            k=torch.round(base.k[..., :-1]).to(torch.int8),
            v=torch.round(base.v[..., :-1]).to(torch.int8),
            k_scale=base.k[..., -1:].contiguous(),
            v_scale=base.v[..., -1:].contiguous(),
            pos=base.pos,
        )
    B, S = k.shape[:2]
    size = min(max_len, window) if window else max_len

    def ring(src, first):
        # ring-buffer layout: slot = pos % size
        out = torch.zeros((B, size) + src.shape[2:], dtype=src.dtype,
                          device=src.device)
        idx = torch.arange(first, first + src.shape[1],
                           device=src.device) % size
        out[:, idx] = src
        return out

    if S >= size:
        kk, vv = k[:, S - size:], v[:, S - size:]
        if window:
            kk, vv = ring(kk, S - size), ring(vv, S - size)
        else:
            kk, vv = kk.contiguous(), vv.contiguous()
    elif window:
        kk, vv = ring(k, 0), ring(v, 0)
    else:
        pad = (0, 0, 0, 0, 0, size - S)
        kk = torch.nn.functional.pad(k, pad)
        vv = torch.nn.functional.pad(v, pad)
    return KVCache(k=kk, v=vv, k_scale=None, v_scale=None, pos=S)


def decode_attention(
    p,
    x_t: torch.Tensor,          # (B, 1, d)
    cache: KVCache,
    cfg,
    window: Optional[int] = None,
    inplace: bool = False,
) -> tuple[torch.Tensor, KVCache]:
    """One decode step: write the token's k/v into the cache, attend over
    the cache.  The token goes into a copy of the cache's tensors, or with
    ``inplace`` into the tensors themselves, so that ``cache`` no longer
    holds the state before the step."""
    if not inplace:
        cache = cache._replace(**{
            name: getattr(cache, name).clone()
            for name in ("k", "v", "k_scale", "v_scale")
            if getattr(cache, name) is not None})
    B = x_t.shape[0]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k_t, v_t = _qkv(p, x_t, cfg)
    pos = cache.pos
    pp = torch.full((B, 1), pos, dtype=torch.int32, device=x_t.device)
    q = rope(q, pp, cfg.rope_theta)
    k_t = rope(k_t, pp, cfg.rope_theta)

    size = cache.k.shape[1]
    slot = pos % size
    if cache.k_scale is not None:
        kq, ks = quantize_kv(k_t)
        vq, vs = quantize_kv(v_t)
        cache.k[:, slot:slot + 1] = kq
        cache.v[:, slot:slot + 1] = vq
        cache.k_scale[:, slot:slot + 1] = ks
        cache.v_scale[:, slot:slot + 1] = vs
        k_read = dequantize_kv(cache.k, cache.k_scale, x_t.dtype)
        v_read = dequantize_kv(cache.v, cache.v_scale, x_t.dtype)
    else:
        cache.k[:, slot:slot + 1] = k_t.to(cache.k.dtype)
        cache.v[:, slot:slot + 1] = v_t.to(cache.v.dtype)
        k_read, v_read = cache.k, cache.v

    g = H // K
    qh = q.reshape(B, 1, K, g, hd).to(torch.float32) * (hd ** -0.5)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qh, k_read.to(torch.float32))
    slots = torch.arange(size, device=x_t.device)
    # ring buffer: every slot written so far is within the window
    valid = slots <= (min(pos, size - 1) if window else pos)
    logits = torch.where(valid, logits, NEG_INF)
    pattn = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", pattn, v_read.to(torch.float32))
    o = o.reshape(B, 1, H * hd).to(x_t.dtype)
    out = o @ p["wo"]
    return out, cache._replace(pos=pos + 1)
