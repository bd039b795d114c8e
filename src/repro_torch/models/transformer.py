"""Decoder assembly: the dense, moe, ssm and hybrid families.

The port of the decoder-only part of :mod:`repro.models.transformer`.
Where the JAX package runs a ``lax.scan`` over parameters stacked along a
leading layer axis, the port keeps one parameter dict per layer and loops
over them; the decode cache is likewise one cache per layer.  ``remat``
and the sharding constraints have no counterpart on one card
(:func:`check_family` refuses those fields away from their defaults).

Layer layouts, as in the reference:

  dense / moe : L identical decoder blocks (MoE replaces the MLP).
  ssm         : L Mamba-2 (SSD) blocks.
  hybrid      : L // attn_every super-blocks of (attn_every - 1) RG-LRU
                blocks and one local-attention block (window
                ``cfg.local_window``), then the L mod attn_every leftover
                RG-LRU blocks (``Decoder.tail``, None when there are none).

The ``vlm`` and ``encdec`` families raise ``NotImplementedError`` naming
the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.models import attention as att
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssd as ssd_mod
from repro_torch.models.config import NO_EFFECT, ModelConfig
from repro_torch.models.layers import (
    dtype_of, init_mlp, mlp, rms_norm, trunc_normal, zeros,
)

PORTED = ("dense", "moe", "ssm", "hybrid")
_UNPORTED = {
    "vlm": "cross-attention blocks and the vision projection",
    "encdec": "the audio encoder-decoder",
}


def check_family(cfg) -> None:
    """Raise ``NotImplementedError`` unless the port runs ``cfg.family``,
    and ``ValueError`` if a field that has no effect in the port
    (:data:`~repro_torch.models.config.NO_EFFECT`) is not at its default."""
    if cfg.family not in PORTED:
        what = _UNPORTED.get(cfg.family, f"family {cfg.family!r}")
        raise NotImplementedError(
            f"repro_torch: {cfg.name} is family {cfg.family!r}; {what} are "
            f"not ported yet (ROADMAP.md, queue 1 item 9: the LM "
            f"substrate's other families); the {', '.join(PORTED)} "
            f"families run")
    fields = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    moved = {n: getattr(cfg, n) for n in NO_EFFECT
             if getattr(cfg, n) != fields[n]}
    if moved:
        raise ValueError(
            f"repro_torch: {moved} would have no effect here: these fields "
            f"only shape JAX compilation and sharding (models/config.py); "
            f"leave them at their defaults")


def hybrid_layout(cfg):
    """(super-blocks, recurrent blocks in each, tail blocks)."""
    per = cfg.attn_every
    n_super = cfg.n_layers // per
    return n_super, per - 1, cfg.n_layers - n_super * per


# ============================================================= decoder blocks
def init_decoder_block(gen: torch.Generator, cfg):
    dt = dtype_of(cfg.dtype)
    p = {
        "attn_norm": zeros((cfg.d_model,), dt, gen),
        "attn": att.init_attn(gen, cfg),
        "mlp_norm": zeros((cfg.d_model,), dt, gen),
    }
    if cfg.n_experts:
        p["moe"] = moe_mod.init_moe(gen, cfg)
    else:
        p["mlp"] = init_mlp(gen, cfg)
    return p


def _ffn(bp, h, cfg):
    return moe_mod.moe_block(bp["moe"], h, cfg) if cfg.n_experts \
        else mlp(bp["mlp"], h, cfg)


def decoder_block(bp, x, cfg, positions, window=None):
    """One pre-norm decoder block (full-sequence path)."""
    h = rms_norm(x, bp["attn_norm"], cfg.norm_eps)
    x = x + att.multihead_attention(bp["attn"], h, cfg, positions=positions,
                                    window=window)
    h = rms_norm(x, bp["mlp_norm"], cfg.norm_eps)
    return x + _ffn(bp, h, cfg)


def decoder_block_decode(bp, x_t, cache, cfg, window=None, inplace=False):
    h = rms_norm(x_t, bp["attn_norm"], cfg.norm_eps)
    h, cache = att.decode_attention(bp["attn"], h, cache, cfg, window=window,
                                    inplace=inplace)
    x_t = x_t + h
    h = rms_norm(x_t, bp["mlp_norm"], cfg.norm_eps)
    if cfg.n_experts:
        return x_t + moe_mod.moe_decode(bp["moe"], h, cfg), cache
    return x_t + mlp(bp["mlp"], h, cfg), cache


def decoder_block_prefill(bp, x, cfg, positions, window=None):
    """Decoder block that also returns (k, v) for cache construction."""
    h = rms_norm(x, bp["attn_norm"], cfg.norm_eps)
    h, (k, v) = att.multihead_attention(
        bp["attn"], h, cfg, positions=positions, window=window,
        return_kv=True,
    )
    x = x + h
    h = rms_norm(x, bp["mlp_norm"], cfg.norm_eps)
    return x + _ffn(bp, h, cfg), (k, v)


# ------------------------------------------------------------ hybrid blocks
def init_rec_block(gen: torch.Generator, cfg):
    dt = dtype_of(cfg.dtype)
    return {
        "rec_norm": zeros((cfg.d_model,), dt, gen),
        "rec": rglru_mod.init_rglru_block(gen, cfg),
        "mlp_norm": zeros((cfg.d_model,), dt, gen),
        "mlp": init_mlp(gen, cfg),
    }


def rec_block(bp, x, cfg, cache=None):
    h = rms_norm(x, bp["rec_norm"], cfg.norm_eps)
    h, cache = rglru_mod.rglru_block(bp["rec"], h, cfg, cache)
    x = x + h
    h = rms_norm(x, bp["mlp_norm"], cfg.norm_eps)
    return x + mlp(bp["mlp"], h, cfg), cache


# ---------------------------------------------------------------- ssm blocks
def init_ssm_block(gen: torch.Generator, cfg):
    return {
        "norm": zeros((cfg.d_model,), dtype_of(cfg.dtype), gen),
        "ssd": ssd_mod.init_ssd(gen, cfg),
    }


def ssm_block(bp, x, cfg, cache=None):
    h = rms_norm(x, bp["norm"], cfg.norm_eps)
    h, cache = ssd_mod.ssd_layer(bp["ssd"], h, cfg, cache)
    return x + h, cache


# ================================================================== assembly
class Decoder(NamedTuple):
    """Decoder-only parameters: the JAX ``Decoder``'s fields that the
    ported families use (``cross`` and ``vision_proj`` wait for vlm)."""

    embed: torch.Tensor
    blocks: list        # one parameter dict per layer (hybrid: super-block)
    final_norm: torch.Tensor
    lm_head: Optional[torch.Tensor]   # None if tied
    tail: Optional[list] = None       # hybrid leftover blocks, else None


def init_decoder(gen: torch.Generator, cfg) -> Decoder:
    """Random parameters drawn from ``gen``, on ``gen``'s device."""
    check_family(cfg)
    dt = dtype_of(cfg.dtype)
    embed = trunc_normal(gen, (cfg.vocab_size, cfg.d_model), 1.0, dt)
    tail = None
    if cfg.family == "ssm":
        blocks = [init_ssm_block(gen, cfg) for _ in range(cfg.n_layers)]
    elif cfg.family == "hybrid":
        n_super, n_rec, n_tail = hybrid_layout(cfg)
        blocks = [{"recs": [init_rec_block(gen, cfg) for _ in range(n_rec)],
                   "attn": init_decoder_block(gen, cfg)}
                  for _ in range(n_super)]
        if n_tail:
            tail = [init_rec_block(gen, cfg) for _ in range(n_tail)]
    else:   # dense / moe
        blocks = [init_decoder_block(gen, cfg) for _ in range(cfg.n_layers)]
    final_norm = zeros((cfg.d_model,), dt, gen)
    lm_head = (None if cfg.tie_embeddings else
               trunc_normal(gen, (cfg.d_model, cfg.vocab_size), 1.0, dt))
    return Decoder(embed, blocks, final_norm, lm_head, tail)


def _lm_logits(params: Decoder, x, cfg):
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    head = params.lm_head if params.lm_head is not None else params.embed.T
    return x @ head


def _positions(B, S, device):
    return torch.arange(S, device=device)[None].expand(B, S)


def decoder_forward(params: Decoder, cfg, tokens: torch.Tensor):
    """Full-sequence forward -> logits (B, S, V)."""
    check_family(cfg)
    B, S = tokens.shape
    x = params.embed[tokens]
    positions = _positions(B, S, tokens.device)
    if cfg.family == "ssm":
        for bp in params.blocks:
            x, _ = ssm_block(bp, x, cfg)
    elif cfg.family == "hybrid":
        for sb in params.blocks:
            for rp in sb["recs"]:
                x, _ = rec_block(rp, x, cfg)
            x = decoder_block(sb["attn"], x, cfg, positions,
                              window=cfg.local_window)
        for rp in params.tail or ():
            x, _ = rec_block(rp, x, cfg)
    else:   # dense / moe
        for bp in params.blocks:
            x = decoder_block(bp, x, cfg, positions, cfg.sliding_window)
    return _lm_logits(params, x, cfg)


# =========================================================== caches & decode
class DecodeCache(NamedTuple):
    """``self_kv`` by family: dense / moe one :class:`KVCache` a layer; ssm
    one :class:`~repro_torch.models.ssd.SSMCache` a layer; hybrid a dict
    of ``recs`` (a list of :class:`~repro_torch.models.rglru.LRUCache` a
    super-block), ``attn`` (one windowed KV ring a super-block) and
    ``tail`` (LRU caches, or None)."""

    self_kv: object
    pos: int
    # [position up to which self_kv's tensors hold tokens], shared by every
    # cache over the same tensors: an in-place step moves it past the pos
    # of the cache it consumed
    written: list


def init_decode_cache(cfg, batch: int, max_len: int,
                      device=None) -> DecodeCache:
    check_family(cfg)
    if cfg.family == "ssm":
        self_kv = [ssd_mod.init_ssm_cache(cfg, batch, device=device)
                   for _ in range(cfg.n_layers)]
    elif cfg.family == "hybrid":
        n_super, n_rec, n_tail = hybrid_layout(cfg)

        def lru():
            return rglru_mod.init_lru_cache(cfg, batch, device=device)

        self_kv = {
            "recs": [[lru() for _ in range(n_rec)] for _ in range(n_super)],
            "attn": [att.init_kv_cache(cfg, batch, max_len,
                                       cfg.local_window, device=device)
                     for _ in range(n_super)],
            "tail": [lru() for _ in range(n_tail)] if n_tail else None,
        }
    else:
        self_kv = [att.init_kv_cache(cfg, batch, max_len, cfg.sliding_window,
                                     device=device)
                   for _ in range(cfg.n_layers)]
    return DecodeCache(self_kv=self_kv, pos=0, written=[0])


def decoder_decode_step(params: Decoder, cfg, token: torch.Tensor,
                        cache: DecodeCache, inplace: bool = False):
    """One decode step.  token: (B,) int -> logits (B, V) and the cache
    with pos + 1.  By default ``cache`` stays as it was (the step writes
    into copies of its KV tensors; the recurrent states are new tensors
    anyway), as in the JAX package; with ``inplace`` the step writes into
    its KV tensors and ``cache`` is consumed: decoding from it again
    raises."""
    check_family(cfg)
    if cache.written[0] != cache.pos:
        raise ValueError(
            f"repro_torch: this cache (pos {cache.pos}) was consumed by an "
            f"in-place decode step (its tensors hold tokens up to "
            f"{cache.written[0]}); decode from the cache that step returned")
    x = params.embed[token][:, None, :]  # (B, 1, d)
    if cfg.family == "ssm":
        kv2 = []
        for bp, c in zip(params.blocks, cache.self_kv):
            x, c = ssm_block(bp, x, cfg, c)
            kv2.append(c)
    elif cfg.family == "hybrid":
        kv = cache.self_kv
        kv2 = {"recs": [], "attn": [], "tail": None}
        for sb, recs_c, kv_c in zip(params.blocks, kv["recs"], kv["attn"]):
            recs2 = []
            for rp, c in zip(sb["recs"], recs_c):
                x, c = rec_block(rp, x, cfg, c)
                recs2.append(c)
            x, kv_c = decoder_block_decode(sb["attn"], x, kv_c, cfg,
                                           window=cfg.local_window,
                                           inplace=inplace)
            kv2["recs"].append(recs2)
            kv2["attn"].append(kv_c)
        if params.tail is not None:
            kv2["tail"] = []
            for rp, c in zip(params.tail, kv["tail"]):
                x, c = rec_block(rp, x, cfg, c)
                kv2["tail"].append(c)
    else:
        kv2 = []
        for bp, c in zip(params.blocks, cache.self_kv):
            x, c = decoder_block_decode(bp, x, c, cfg,
                                        window=cfg.sliding_window,
                                        inplace=inplace)
            kv2.append(c)
    logits = _lm_logits(params, x, cfg)[:, 0]
    if inplace:
        cache.written[0] = cache.pos + 1
        return logits, DecodeCache(kv2, cache.pos + 1, cache.written)
    return logits, DecodeCache(kv2, cache.pos + 1, [cache.pos + 1])


# ==================================================================== prefill
def decoder_prefill(params: Decoder, cfg, tokens: torch.Tensor,
                    max_len: Optional[int] = None):
    """Prefill: forward the prompt, return (last-token logits, DecodeCache)."""
    check_family(cfg)
    B, S = tokens.shape
    max_len = max_len or S
    x = params.embed[tokens]
    positions = _positions(B, S, tokens.device)
    # the recurrent layers start from the zero state, as the reference's
    # prefill starts from init_decode_cache
    if cfg.family == "ssm":
        kv = []
        for bp in params.blocks:
            x, c = ssm_block(bp, x, cfg, ssd_mod.init_ssm_cache(
                cfg, B, device=tokens.device))
            kv.append(c)
    elif cfg.family == "hybrid":
        def recs(blocks):
            nonlocal x
            caches = []
            for rp in blocks:
                x, c = rec_block(rp, x, cfg, rglru_mod.init_lru_cache(
                    cfg, B, device=tokens.device))
                caches.append(c)
            return caches

        kv = {"recs": [], "attn": [], "tail": None}
        for sb in params.blocks:
            kv["recs"].append(recs(sb["recs"]))
            x, (k, v) = decoder_block_prefill(sb["attn"], x, cfg, positions,
                                              cfg.local_window)
            kv["attn"].append(att.fill_kv_cache(cfg, k, v, max_len,
                                                cfg.local_window))
        if params.tail is not None:
            kv["tail"] = recs(params.tail)
    else:   # dense / moe
        window = cfg.sliding_window
        kv = []
        for bp in params.blocks:
            x, (k, v) = decoder_block_prefill(bp, x, cfg, positions, window)
            kv.append(att.fill_kv_cache(cfg, k, v, max_len, window))
    logits = _lm_logits(params, x[:, -1:, :], cfg)[:, 0]
    return logits, DecodeCache(kv, S, [S])
