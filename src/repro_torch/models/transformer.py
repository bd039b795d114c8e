"""Decoder assembly, dense family.

The port of the dense part of :mod:`repro.models.transformer`.  Where the
JAX package runs a ``lax.scan`` over parameters stacked along a leading
layer axis, the port keeps one parameter dict per layer and loops over
them; the decode cache is likewise one :class:`KVCache` per layer.
``remat`` and the sharding constraints have no counterpart on one card
(:func:`check_family` refuses those fields away from their defaults).

Only ``family == "dense"`` is ported.  The other families raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.models import attention as att
from repro_torch.models.config import NO_EFFECT, ModelConfig
from repro_torch.models.layers import (
    dtype_of, init_mlp, mlp, rms_norm, trunc_normal, zeros,
)

_UNPORTED = {
    "moe": "mixture-of-experts blocks (models/moe.py)",
    "ssm": "Mamba-2 SSD blocks (models/ssd.py)",
    "hybrid": "RG-LRU blocks (models/rglru.py)",
    "vlm": "cross-attention blocks and the vision projection",
    "encdec": "the audio encoder-decoder",
}


def check_family(cfg) -> None:
    """Raise ``NotImplementedError`` unless the port runs ``cfg.family``,
    and ``ValueError`` if a field that has no effect in the port
    (:data:`~repro_torch.models.config.NO_EFFECT`) is not at its default."""
    if cfg.family != "dense":
        what = _UNPORTED.get(cfg.family, f"family {cfg.family!r}")
        raise NotImplementedError(
            f"repro_torch: {cfg.name} is family {cfg.family!r}; {what} are "
            f"not ported yet (ROADMAP.md, queue 1 item 9: the LM "
            f"substrate's other families); only the dense family runs")
    fields = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    moved = {n: getattr(cfg, n) for n in NO_EFFECT
             if getattr(cfg, n) != fields[n]}
    if moved:
        raise ValueError(
            f"repro_torch: {moved} would have no effect here: these fields "
            f"only shape JAX compilation and sharding (models/config.py); "
            f"leave them at their defaults")


# ============================================================= decoder blocks
def init_decoder_block(gen: torch.Generator, cfg):
    dt = dtype_of(cfg.dtype)
    return {
        "attn_norm": zeros((cfg.d_model,), dt, gen),
        "attn": att.init_attn(gen, cfg),
        "mlp_norm": zeros((cfg.d_model,), dt, gen),
        "mlp": init_mlp(gen, cfg),
    }


def decoder_block(bp, x, cfg, positions, window=None):
    """One pre-norm decoder block (full-sequence path)."""
    h = rms_norm(x, bp["attn_norm"], cfg.norm_eps)
    x = x + att.multihead_attention(bp["attn"], h, cfg, positions=positions,
                                    window=window)
    h = rms_norm(x, bp["mlp_norm"], cfg.norm_eps)
    return x + mlp(bp["mlp"], h, cfg)


def decoder_block_decode(bp, x_t, cache, cfg, window=None, inplace=False):
    h = rms_norm(x_t, bp["attn_norm"], cfg.norm_eps)
    h, cache = att.decode_attention(bp["attn"], h, cache, cfg, window=window,
                                    inplace=inplace)
    x_t = x_t + h
    h = rms_norm(x_t, bp["mlp_norm"], cfg.norm_eps)
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
    return x + mlp(bp["mlp"], h, cfg), (k, v)


class Decoder(NamedTuple):
    """Dense decoder parameters: the JAX ``Decoder``'s fields that the
    dense family uses."""

    embed: torch.Tensor
    blocks: list        # one parameter dict per layer
    final_norm: torch.Tensor
    lm_head: Optional[torch.Tensor]   # None if tied


def init_decoder(gen: torch.Generator, cfg) -> Decoder:
    """Random parameters drawn from ``gen``, on ``gen``'s device."""
    check_family(cfg)
    dt = dtype_of(cfg.dtype)
    embed = trunc_normal(gen, (cfg.vocab_size, cfg.d_model), 1.0, dt)
    blocks = [init_decoder_block(gen, cfg) for _ in range(cfg.n_layers)]
    final_norm = zeros((cfg.d_model,), dt, gen)
    lm_head = (None if cfg.tie_embeddings else
               trunc_normal(gen, (cfg.d_model, cfg.vocab_size), 1.0, dt))
    return Decoder(embed, blocks, final_norm, lm_head)


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
    for bp in params.blocks:
        x = decoder_block(bp, x, cfg, positions, cfg.sliding_window)
    return _lm_logits(params, x, cfg)


# =========================================================== caches & decode
class DecodeCache(NamedTuple):
    self_kv: list    # one KVCache per layer
    pos: int
    # [position up to which self_kv's tensors hold tokens], shared by every
    # cache over the same tensors: an in-place step moves it past the pos
    # of the cache it consumed
    written: list


def init_decode_cache(cfg, batch: int, max_len: int,
                      device=None) -> DecodeCache:
    check_family(cfg)
    self_kv = [att.init_kv_cache(cfg, batch, max_len, cfg.sliding_window,
                                 device=device)
               for _ in range(cfg.n_layers)]
    return DecodeCache(self_kv=self_kv, pos=0, written=[0])


def decoder_decode_step(params: Decoder, cfg, token: torch.Tensor,
                        cache: DecodeCache, inplace: bool = False):
    """One decode step.  token: (B,) int -> logits (B, V) and the cache
    with pos + 1.  By default ``cache`` stays as it was (the step writes
    into copies of its tensors), as in the JAX package; with ``inplace``
    the step writes into its tensors and ``cache`` is consumed: decoding
    from it again raises."""
    check_family(cfg)
    if cache.written[0] != cache.pos:
        raise ValueError(
            f"repro_torch: this cache (pos {cache.pos}) was consumed by an "
            f"in-place decode step (its tensors hold tokens up to "
            f"{cache.written[0]}); decode from the cache that step returned")
    x = params.embed[token][:, None, :]  # (B, 1, d)
    kv2 = []
    for bp, c in zip(params.blocks, cache.self_kv):
        x, c = decoder_block_decode(bp, x, c, cfg, window=cfg.sliding_window,
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
    window = cfg.sliding_window
    x = params.embed[tokens]
    positions = _positions(B, S, tokens.device)
    kv = []
    for bp in params.blocks:
        x, (k, v) = decoder_block_prefill(bp, x, cfg, positions, window)
        kv.append(att.fill_kv_cache(cfg, k, v, max_len, window))
    logits = _lm_logits(params, x[:, -1:, :], cfg)[:, 0]
    return logits, DecodeCache(kv, S, [S])
