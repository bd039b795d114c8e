"""Attention blocks: GQA/MQA/MHA, RoPE, sliding window, cross-attention,
KV cache.

The port of :mod:`repro.models.attention`: causal and bidirectional
self-attention with RoPE, and cross-attention over a memory (``kv_x``, no
RoPE, no qkv bias).  Three interchangeable implementations
(``cfg.attn_impl``, or a call site's ``impl``), as in the JAX package:

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
from repro_torch.sharding import (
    constrain, is_dtensor, proj, replicate_dim, seq_matmuls, shards_of,
    tp_ag_matmuls, tp_rs_matmul,
)

NEG_INF = -1e30


def init_attn(gen: torch.Generator, cfg, cross: bool = False):
    """Projections of one attention block; a cross projection (``cross``)
    has no qkv bias, as in the reference."""
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = dtype_of(cfg.dtype)
    p = {
        "wq": trunc_normal(gen, (d, H * hd), 1.0, dt),
        "wk": trunc_normal(gen, (d, K * hd), 1.0, dt),
        "wv": trunc_normal(gen, (d, K * hd), 1.0, dt),
        "wo": trunc_normal(gen, (H * hd, d), 1.0, dt),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = zeros((H * hd,), dt, gen)
        p["bk"] = zeros((K * hd,), dt, gen)
        p["bv"] = zeros((K * hd,), dt, gen)
    return p


def attn_specs(cfg, cross: bool = False):
    p = {
        "wq": ("fsdp", "tp"),
        "wk": ("fsdp", "tp"),
        "wv": ("fsdp", "tp"),
        "wo": ("tp", "fsdp"),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = ("tp",)
        p["bk"] = ("tp",)
        p["bv"] = ("tp",)
    return p


def _heads(t, B, S, n, hd):
    """(B, S, n * hd) -> (B, S, n, hd).  A DTensor whose last dim is
    sharded into pieces that do not hold whole heads (fewer heads than the
    model axis has ranks) is gathered over that dim first."""
    if is_dtensor(t) and n % shards_of(t, t.ndim - 1):
        t = replicate_dim(t, t.ndim - 1)
    return t.reshape(B, S, n, hd)


def _qkv(p, x, cfg, kv_x=None, matmuls=None):
    """q from ``x``; k and v from ``kv_x`` (cross-attention) or ``x``.
    ``matmuls(x, wq, wk, wv)``, where given, computes the three
    self-attention products at once (the TP modes' ``tp_ag_matmuls`` /
    ``seq_matmuls``); else each is its own :func:`proj`."""
    kv_x = x if kv_x is None else kv_x
    B, S, Skv = x.shape[0], x.shape[1], kv_x.shape[1]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if matmuls is None:
        q, k, v = proj(x, p["wq"]), proj(kv_x, p["wk"]), proj(kv_x, p["wv"])
    else:
        q, k, v = matmuls(x, p["wq"], p["wk"], p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (_heads(q, B, S, H, hd), _heads(k, B, Skv, K, hd),
            _heads(v, B, Skv, K, hd))


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


def _expand_kv(q, k, v):
    """k and v for q's heads.  Where q's heads are split over more ranks
    than there are kv heads (DTensors under a mesh), each kv head is
    repeated for its query heads, so that the heads shard alike: the same
    attention, each query head reading its own kv head."""
    if not is_dtensor(q):
        return k, v
    n = shards_of(q, 2)
    if n == 1 or k.shape[2] % n == 0:
        return k, v
    g = q.shape[2] // k.shape[2]
    return tuple(t.repeat_interleave(g, dim=2).redistribute(
        q.device_mesh, q.placements) for t in (k, v))


def _sharded_attn(q, k, v, causal, window, impl, chunk):
    """Attention of DTensors: each rank attends its own batch rows and
    heads (the sequence and head dims gathered first) by ``impl``, on
    plain local tensors (flash on a fake one takes its traced stand-in)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    k, v = _expand_kv(q, k, v)
    mesh = q.device_mesh

    def keep(t):        # batch (0) and heads (2) stay sharded
        return t.redistribute(mesh, [
            Replicate() if isinstance(p, Shard) and p.dim in (1, 3) else p
            for p in t.placements])

    q, k, v = keep(q), keep(k), keep(v)
    if any(isinstance(a, Shard) and a.dim == 2 and not (
            isinstance(b, Shard) and b.dim == 2)
           for a, b in zip(q.placements, k.placements)):
        k = k.redistribute(mesh, q.placements)
        v = v.redistribute(mesh, q.placements)

    def local(ql, kl, vl):
        if impl == "flash":
            return flash_attention(
                ql.transpose(1, 2), kl.transpose(1, 2), vl.transpose(1, 2),
                causal=causal, window=window).transpose(1, 2)
        if impl == "chunked":
            return _chunked_attn(ql, kl, vl, causal, window, chunk)
        return _einsum_attn(ql, kl, vl, causal, window)

    return local_map(local, out_placements=list(q.placements),
                     in_placements=(q.placements, k.placements,
                                    v.placements),
                     redistribute_inputs=False)(q, k, v)


def _einsum_attn(q, k, v, causal, window):
    """q: (B,Sq,H,hd); k/v: (B,Skv,K,hd). Materialized-logit attention.

    The f32 logits are scaled in place and, with no mask to apply
    (bidirectional, no window), not copied: at most two (B, H, Sq, Skv)
    f32 arrays live at once, the logits and their softmax."""
    k, v = _expand_kv(q, k, v)
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    g = H // K
    qh = q.reshape(B, Sq, K, g, hd)
    logits = torch.einsum(
        "bqkgd,bskd->bkgqs", qh.to(torch.float32), k.to(torch.float32)
    ).mul_(hd ** -0.5)
    if causal or window is not None:
        mask = _mask(Sq, Skv, causal, window, q.device)
        logits = torch.where(mask, logits, NEG_INF)
    pattn = torch.softmax(logits, dim=-1)
    del logits
    out = torch.einsum("bkgqs,bskd->bqkgd", pattn, v.to(torch.float32))
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _chunked_attn(q, k, v, causal, window, chunk):
    """Online softmax over kv chunks; math identical to the flash kernel."""
    k, v = _expand_kv(q, k, v)
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
    kv_x: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: Optional[int] = None,
    use_rope: bool = True,
    impl: Optional[str] = None,
    return_kv: bool = False,
):
    """Full-sequence attention (train / prefill / cross).  With ``kv_x``
    the keys and values come from that memory and RoPE is not applied, as
    in the reference; ``causal=False`` is bidirectional (the encoder, and
    every cross call).

    Under a mesh the reference's constraints apply: heads over tp around
    the attention itself, and by ``cfg.tp_mode`` for self-attention:
    megatron_rs fuses the sequence all-gather with the q, k and v
    products (:func:`~repro_torch.sharding.tp_ag_matmuls`) and
    reduce-scatters the ``wo`` product's partial sums by hand
    (``tp_rs_matmul``); ulysses runs the projections on the
    sequence-sharded stream (:func:`~repro_torch.sharding.seq_matmuls`)
    and reshards q, k and v from sequence to heads, and the output back
    (all-to-alls of activation / tp bytes, where megatron all-reduces the
    whole activation).  Without a mesh every mode is the same product."""
    cross = kv_x is not None
    mode = "megatron" if cross else cfg.tp_mode
    q, k, v = _qkv(p, x, cfg, kv_x, {"megatron_rs": tp_ag_matmuls,
                                     "ulysses": seq_matmuls}.get(mode))
    if use_rope and not cross:
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)[None, :]
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if mode == "ulysses":
        q = constrain(q, "dp", "sp", None, None)
        k = constrain(k, "dp", "sp", None, None)
        v = constrain(v, "dp", "sp", None, None)
    q = constrain(q, "dp", None, "tp", None)
    k = constrain(k, "dp", None, "tp", None)
    v = constrain(v, "dp", None, "tp", None)

    impl = impl or cfg.attn_impl
    if impl == "auto":
        impl = "einsum" if k.shape[1] <= 8192 else "chunked"
    if is_dtensor(q):
        o = _sharded_attn(q, k, v, causal, window, impl, cfg.attn_chunk)
    elif impl == "flash":
        o = flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window,
        ).transpose(1, 2)
    elif impl == "chunked":
        o = _chunked_attn(q, k, v, causal, window, cfg.attn_chunk)
    else:
        o = _einsum_attn(q, k, v, causal, window)
    o = constrain(o, "dp", None, "tp", None)
    if mode == "ulysses":
        o = constrain(o, "dp", "sp", None, None)    # back to the sequence
    B, S = o.shape[0], o.shape[1]
    o2 = o.reshape(B, S, cfg.n_heads * cfg.hd)
    if mode == "megatron":
        out = proj(o2, p["wo"])
    elif mode == "ulysses":
        (out,) = seq_matmuls(o2, p["wo"])
    else:
        out = tp_rs_matmul(o2, p["wo"])
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
    if is_dtensor(q):       # one token's query: every head on every rank
        q = replicate_dim(q, 2)
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


# ------------------------------------------------- cross-attention memory
def memory_kv(k: torch.Tensor, v: torch.Tensor):
    """A memory's keys and values (B, S, K, hd), as the decode caches hold
    them: head-major (B, K, S, hd) and contiguous, so that the keys of one
    (sequence, kv head) are one matrix of a batched product."""
    return k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two bf16 batches, the products exact and summed in
    float32: one cuBLAS product with a float32 output on the card; on the
    CPU, which has no such product, through float32 copies."""
    if a.device.type == "cuda":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.to(torch.float32), b.to(torch.float32))


def _split_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` (N, m, n) as three bf16 pieces stacked along dim 1,
    (N, 3m, n), whose sum is ``x`` exactly: ``hi = bf16(x)`` holds its
    leading 8 significant bits, ``mid`` the next 8 (those of ``x - hi``,
    an exact float32 difference) and ``lo`` the last 8, which fit (outside
    float32's subnormal range)."""
    hi = x.to(torch.bfloat16)
    r = x - hi.to(torch.float32)
    mid = r.to(torch.bfloat16)
    lo = (r - mid.to(torch.float32)).to(torch.bfloat16)
    return torch.cat([hi, mid, lo], dim=1)


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in float32 for float32 ``a`` (N, m, n) and ``b`` (N, n, p)
    in the cache's dtype: the product of ``a`` with ``b``'s values.  A
    bf16 ``b`` is never copied to float32: ``a`` goes in as its three bf16
    pieces (:func:`_split_bf16`), one product reads ``b`` once, and the
    pieces' row blocks are summed, the smallest first."""
    if b.dtype != torch.bfloat16:
        return torch.bmm(a, b.to(torch.float32))
    m = a.shape[1]
    r = _bmm_f32(_split_bf16(a), b)
    return (r[:, 2 * m:] + r[:, m:2 * m]) + r[:, :m]


def cross_attend_cached(q: torch.Tensor, mk: torch.Tensor,
                        mv: torch.Tensor) -> torch.Tensor:
    """One query a sequence over a memory's cached keys and values: ``q``
    (B, 1, H, hd) in float32, already scaled by hd ** -0.5 (the
    reference's cached paths scale q before the product); ``mk``, ``mv``
    (B, K, S, hd) as :func:`memory_kv` lays them out.  Returns the float32
    output (B, 1, H * hd).

    The reference casts the memory to float32 for its einsums, a copy of
    the whole memory at every step; :func:`_dot_f32` computes the same
    float32 logits and output from the cache as it is, reading it once a
    product."""
    B, _, H, hd = q.shape
    K, S = mk.shape[1], mk.shape[2]
    g = H // K
    logits = _dot_f32(q.reshape(B * K, g, hd),
                      mk.reshape(B * K, S, hd).transpose(1, 2))
    pattn = torch.softmax(logits, dim=-1)
    o = _dot_f32(pattn, mv.reshape(B * K, S, hd))
    return o.reshape(B, 1, H * hd)
