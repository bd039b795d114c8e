"""Architecture assembly for all six families.

The port of :mod:`repro.models.transformer`.  Where the JAX package runs a
``lax.scan`` over parameters stacked along a leading layer axis, the port
keeps one parameter dict per layer and loops over them; the decode cache
is likewise one cache per layer.  With ``cfg.remat`` each block of the
full-sequence forward (:func:`decoder_forward`, :func:`encode_audio`,
:func:`encdec_forward`) is recomputed in the backward pass instead of
keeping its activations, where the reference wraps it in
``jax.checkpoint``; this applies only while gradients are taken.  The
reference's sharding constraints sit at its places
(:func:`repro_torch.sharding.constrain`): under a mesh they redistribute
the DTensor activations, without one they return their input, so that a
model on one card computes the same bits with or without them.  The
``*_specs`` functions give each parameter's logical axes, one spec a
parameter leaf: the reference's stacked spec without its leading
``None`` (two for the hybrid's recurrent blocks and the vlm's self
blocks).

Layer layouts, as in the reference:

  dense / moe : L identical decoder blocks (MoE replaces the MLP).
  ssm         : L Mamba-2 (SSD) blocks.
  hybrid      : L // attn_every super-blocks of (attn_every - 1) RG-LRU
                blocks and one local-attention block (window
                ``cfg.local_window``), then the L mod attn_every leftover
                RG-LRU blocks (``Decoder.tail``, None when there are none).
  vlm         : L // cross_every groups of cross_every self blocks, each
                group followed by one gated cross-attention block over the
                projected vision embeddings (``Decoder.blocks`` holds the
                self blocks group-major, ``Decoder.cross`` one block a
                group).
  encdec      : an encoder of bidirectional self blocks over the projected
                audio frames (:class:`EncDec`), then decoder blocks of
                causal self-attention, cross-attention over the encoder's
                memory and an MLP.

Cross-attention is plain PyTorch (``impl="einsum"`` at every cross call
site, as in the reference, whatever ``cfg.attn_impl`` says).  Its keys and
values are computed once at prefill and held in the cache head-major
(:func:`~repro_torch.models.attention.memory_kv`); decode reads them as
they are (:func:`~repro_torch.models.attention.cross_attend_cached`).
A vlm cross block's gate is a float32 scalar initialized to 0, so that at
initialization the block adds nothing.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as att
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssd as ssd_mod
from repro_torch.models.config import NO_EFFECT, TP_MODES, ModelConfig
from repro_torch.models.layers import (
    dtype_of, init_mlp, mlp, mlp_specs, rms_norm, trunc_normal, zeros,
)
from repro_torch.sharding import (
    constrain, current_mesh, embed_lookup, proj, use_mesh,
)

PORTED = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec")


def check_family(cfg) -> None:
    """Raise ``NotImplementedError`` unless ``cfg.family`` is one of the
    families the port runs, and ``ValueError`` if a field that has no
    effect in the port (:data:`~repro_torch.models.config.NO_EFFECT`) is
    not at its default or ``cfg.tp_mode`` is not one of
    :data:`~repro_torch.models.config.TP_MODES`."""
    if cfg.family not in PORTED:
        raise NotImplementedError(
            f"repro_torch: {cfg.name} is family {cfg.family!r}, which is "
            f"not a family of the model substrate; the "
            f"{', '.join(PORTED)} families run")
    fields = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    moved = {n: getattr(cfg, n) for n in NO_EFFECT
             if getattr(cfg, n) != fields[n]}
    if moved:
        raise ValueError(
            f"repro_torch: {moved} would have no effect here: these fields "
            f"only shape JAX compilation (models/config.py); "
            f"leave them at their defaults")
    if cfg.tp_mode not in TP_MODES:
        raise ValueError(f"repro_torch: tp_mode {cfg.tp_mode!r} is not one "
                         f"of {TP_MODES}")


def hybrid_layout(cfg):
    """(super-blocks, recurrent blocks in each, tail blocks)."""
    per = cfg.attn_every
    n_super = cfg.n_layers // per
    return n_super, per - 1, cfg.n_layers - n_super * per


def vlm_layout(cfg):
    """(groups, self blocks in each): each group's self blocks are followed
    by one cross block; as in the reference, L mod cross_every leftover
    layers are not built."""
    return cfg.n_layers // cfg.cross_every, cfg.cross_every


def _norm(x, w, cfg):
    """RMSNorm of a full-sequence activation, the input of a sub-block's
    projections.  Under a mesh the result is gathered over the sequence
    (``("dp", None, None)``, the Megatron layout; the reference pins it
    under ``opt_collectives`` and GSPMD picks it otherwise).  DTensor
    would otherwise fold the batch and sequence shards of a projection's
    input into one strided shard, which a fake trace cannot follow.
    Without a mesh: the norm."""
    return constrain(rms_norm(x, w, cfg.norm_eps), "dp", None, None)


def _out(h):
    """A sub-block's output under a mesh: sequence-sharded before the
    residual add (its partial sums reduce-scattered; in the backward pass
    its gradient gathered over the sequence before the sub-block's
    projections).  Without a mesh: ``h``."""
    return constrain(h, "dp", "sp", None)


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


def decoder_block_specs(cfg):
    p = {
        "attn_norm": (None,),
        "attn": att.attn_specs(cfg),
        "mlp_norm": (None,),
    }
    if cfg.n_experts:
        p["moe"] = moe_mod.moe_specs(cfg)
    else:
        p["mlp"] = mlp_specs(cfg)
    return p


def _ffn(bp, h, cfg):
    return moe_mod.moe_block(bp["moe"], h, cfg) if cfg.n_experts \
        else mlp(bp["mlp"], h, cfg)


def _block_norm(x, w, cfg):
    """The pre-norm of a decoder block's sub-block: under ``ulysses`` and
    ``megatron_rs`` the normed stream stays sequence-sharded (the
    sub-block's own regions gather or reshard it), else :func:`_norm`."""
    if cfg.tp_mode == "megatron":
        return _norm(x, w, cfg)
    return constrain(rms_norm(x, w, cfg.norm_eps), "dp", "sp", None)


def decoder_block(bp, x, cfg, positions, window=None):
    """One pre-norm decoder block (full-sequence path).

    Under a mesh the post-norm activation is gathered over the sequence
    (:func:`_norm`; under ``ulysses`` and ``megatron_rs`` it stays
    sequence-sharded, :func:`_block_norm`) and each sub-block's output is
    constrained to the sequence-sharded layout before the residual add
    (:func:`_out`), so that its partial sums are reduce-scattered: the
    reference's ``opt_collectives`` boundaries, which the port keeps."""
    h = _block_norm(x, bp["attn_norm"], cfg)
    h = att.multihead_attention(bp["attn"], h, cfg, positions=positions,
                                window=window)
    x = constrain(x + _out(h), "dp", "sp", None)
    h = _block_norm(x, bp["mlp_norm"], cfg)
    return constrain(x + _out(_ffn(bp, h, cfg)), "dp", "sp", None)


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
    h = _norm(x, bp["attn_norm"], cfg)
    h, (k, v) = att.multihead_attention(
        bp["attn"], h, cfg, positions=positions, window=window,
        return_kv=True,
    )
    x = constrain(x + _out(h), "dp", "sp", None)
    h = _norm(x, bp["mlp_norm"], cfg)
    return constrain(x + _out(_ffn(bp, h, cfg)), "dp", "sp", None), (k, v)


# ------------------------------------------------------------- cross blocks
def init_cross_block(gen: torch.Generator, cfg):
    return {
        "norm": zeros((cfg.d_model,), dtype_of(cfg.dtype), gen),
        "attn": att.init_attn(gen, cfg, cross=True),
        "gate": zeros((), torch.float32, gen),
    }


def cross_block_specs(cfg):
    return {
        "norm": (None,),
        "attn": att.attn_specs(cfg, cross=True),
        "gate": (),
    }


def cross_block(bp, x, memory, cfg, return_kv=False):
    """Gated cross-attention over ``memory`` (full-sequence path);
    ``tanh(gate)`` is cast to the activations' dtype before the multiply,
    as in the reference.  With ``return_kv`` also the memory's keys and
    values as the decode cache holds them."""
    h = _norm(x, bp["norm"], cfg)
    h, (k, v) = att.multihead_attention(
        bp["attn"], h, cfg, kv_x=memory, causal=False, use_rope=False,
        impl="einsum", return_kv=True,
    )
    x = x + torch.tanh(bp["gate"]).to(x.dtype) * _out(h)
    if return_kv:
        return x, att.memory_kv(k, v)
    return x


def _cross_cached(p, h, mem_kv, cfg):
    """Cross-attention of one decode token over a memory's cached keys and
    values (projections ``p``): q scaled by hd ** -0.5 in float32 before
    the products, as the reference's cached paths do (its full-sequence
    path scales the logits after)."""
    B = h.shape[0]
    q = (h @ p["wq"]).reshape(B, 1, cfg.n_heads, cfg.hd)
    o = att.cross_attend_cached(q.to(torch.float32) * (cfg.hd ** -0.5),
                                *mem_kv)
    return o.to(h.dtype) @ p["wo"]


def cross_block_cached(bp, x_t, mem_kv, cfg):
    """Decode-path gated cross-attention over precomputed memory K/V."""
    h = rms_norm(x_t, bp["norm"], cfg.norm_eps)
    o = _cross_cached(bp["attn"], h, mem_kv, cfg)
    return x_t + torch.tanh(bp["gate"]).to(x_t.dtype) * o


# ------------------------------------------------------------ hybrid blocks
def init_rec_block(gen: torch.Generator, cfg):
    dt = dtype_of(cfg.dtype)
    return {
        "rec_norm": zeros((cfg.d_model,), dt, gen),
        "rec": rglru_mod.init_rglru_block(gen, cfg),
        "mlp_norm": zeros((cfg.d_model,), dt, gen),
        "mlp": init_mlp(gen, cfg),
    }


def rec_block_specs(cfg):
    return {
        "rec_norm": (None,),
        "rec": rglru_mod.rglru_specs(cfg),
        "mlp_norm": (None,),
        "mlp": mlp_specs(cfg),
    }


def rec_block(bp, x, cfg, cache=None):
    h = _norm(x, bp["rec_norm"], cfg)
    h, cache = rglru_mod.rglru_block(bp["rec"], h, cfg, cache)
    x = x + _out(h)
    h = _norm(x, bp["mlp_norm"], cfg)
    return constrain(x + _out(mlp(bp["mlp"], h, cfg)), "dp", "sp",
                     None), cache


# ---------------------------------------------------------------- ssm blocks
def init_ssm_block(gen: torch.Generator, cfg):
    return {
        "norm": zeros((cfg.d_model,), dtype_of(cfg.dtype), gen),
        "ssd": ssd_mod.init_ssd(gen, cfg),
    }


def ssm_block_specs(cfg):
    return {"norm": (None,), "ssd": ssd_mod.ssd_specs(cfg)}


def ssm_block(bp, x, cfg, cache=None):
    h = _norm(x, bp["norm"], cfg)
    h, cache = ssd_mod.ssd_layer(bp["ssd"], h, cfg, cache)
    return constrain(x + _out(h), "dp", "sp", None), cache


# ================================================================== assembly
class Decoder(NamedTuple):
    """Decoder-only parameters (dense / moe / ssm / hybrid / vlm): the
    JAX ``Decoder``'s fields."""

    embed: torch.Tensor
    blocks: list        # one parameter dict per layer (hybrid: super-block)
    final_norm: torch.Tensor
    lm_head: Optional[torch.Tensor]   # None if tied
    tail: Optional[list] = None       # hybrid leftover blocks, else None
    cross: Optional[list] = None      # vlm: one cross block a group
    vision_proj: Optional[torch.Tensor] = None   # vlm: (vision_dim, d)


def init_decoder(gen: torch.Generator, cfg) -> Decoder:
    """Random parameters drawn from ``gen``, on ``gen``'s device."""
    check_family(cfg)
    dt = dtype_of(cfg.dtype)
    embed = trunc_normal(gen, (cfg.vocab_size, cfg.d_model), 1.0, dt)
    tail = cross = vision_proj = None
    if cfg.family == "encdec":
        raise ValueError("repro_torch: encdec parameters are an EncDec "
                         "(init_encdec), not a Decoder")
    if cfg.family == "ssm":
        blocks = [init_ssm_block(gen, cfg) for _ in range(cfg.n_layers)]
    elif cfg.family == "hybrid":
        n_super, n_rec, n_tail = hybrid_layout(cfg)
        blocks = [{"recs": [init_rec_block(gen, cfg) for _ in range(n_rec)],
                   "attn": init_decoder_block(gen, cfg)}
                  for _ in range(n_super)]
        if n_tail:
            tail = [init_rec_block(gen, cfg) for _ in range(n_tail)]
    elif cfg.family == "vlm":
        n_groups, per = vlm_layout(cfg)
        blocks = [init_decoder_block(gen, cfg)
                  for _ in range(n_groups * per)]
        cross = [init_cross_block(gen, cfg) for _ in range(n_groups)]
        vision_proj = trunc_normal(gen, (cfg.vision_dim, cfg.d_model), 1.0,
                                   dt)
    else:   # dense / moe
        blocks = [init_decoder_block(gen, cfg) for _ in range(cfg.n_layers)]
    final_norm = zeros((cfg.d_model,), dt, gen)
    lm_head = (None if cfg.tie_embeddings else
               trunc_normal(gen, (cfg.d_model, cfg.vocab_size), 1.0, dt))
    return Decoder(embed, blocks, final_norm, lm_head, tail, cross,
                   vision_proj)


def decoder_specs(cfg) -> Decoder:
    """Logical-axis spec tree matching :func:`init_decoder`, one tuple a
    parameter leaf."""
    check_family(cfg)
    tail = cross = vision_proj = None
    if cfg.family == "ssm":
        blocks = [ssm_block_specs(cfg) for _ in range(cfg.n_layers)]
    elif cfg.family == "hybrid":
        n_super, n_rec, n_tail = hybrid_layout(cfg)
        blocks = [{"recs": [rec_block_specs(cfg) for _ in range(n_rec)],
                   "attn": decoder_block_specs(cfg)}
                  for _ in range(n_super)]
        if n_tail:
            tail = [rec_block_specs(cfg) for _ in range(n_tail)]
    elif cfg.family == "vlm":
        n_groups, per = vlm_layout(cfg)
        blocks = [decoder_block_specs(cfg) for _ in range(n_groups * per)]
        cross = [cross_block_specs(cfg) for _ in range(n_groups)]
        vision_proj = ("fsdp", "tp")
    else:
        blocks = [decoder_block_specs(cfg) for _ in range(cfg.n_layers)]
    return Decoder(
        embed=("tp", "fsdp"),
        blocks=blocks,
        final_norm=(None,),
        lm_head=None if cfg.tie_embeddings else ("fsdp", "tp"),
        tail=tail,
        cross=cross,
        vision_proj=vision_proj,
    )


def _maybe_remat(fn, cfg):
    """``fn(params, x, ...)``, recomputed in the backward pass (its
    activations not kept) when ``cfg.remat`` is set and grad mode is on:
    the reference's ``jax.checkpoint`` around a block.  Where nothing
    requires grad the checkpoint keeps nothing and computes the same bits.
    The forward draws no random numbers, so no RNG state is stashed.  The
    recomputation runs under the mesh of the forward (``use_mesh``): the
    autograd engine runs a CUDA backward on a thread of its own, which
    does not see the caller's mesh."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn

    def run(bp, x, *rest):
        mesh = current_mesh()

        def under_mesh(*args):
            with use_mesh(mesh):
                return fn(*args)

        return checkpoint(under_mesh, bp, x, *rest, use_reentrant=False,
                          preserve_rng_state=False)

    return run


def _lm_logits(params: Decoder, x, cfg):
    x = _norm(x, params.final_norm, cfg)
    head = params.lm_head if params.lm_head is not None else params.embed.T
    return constrain(proj(x, head), "dp", None, "tp")


def _positions(B, S, device):
    return torch.arange(S, device=device)[None].expand(B, S)


def _vision_memory(params: Decoder, cfg, vision_embeds):
    """The vlm's cross-attention memory: the vision embeddings projected."""
    if vision_embeds is None:
        raise ValueError(
            f"repro_torch: {cfg.name} (vlm) needs batch['vision'], "
            f"(B, {cfg.vision_tokens}, {cfg.vision_dim}) embeddings")
    return constrain(proj(vision_embeds, params.vision_proj), "dp", None,
                     None)


def _groups(params: Decoder, cfg):
    """(the group's self blocks, its cross block, group index) of a vlm."""
    _, per = vlm_layout(cfg)
    for gi, cp in enumerate(params.cross):
        yield params.blocks[gi * per:(gi + 1) * per], cp, gi


def decoder_forward(params: Decoder, cfg, tokens: torch.Tensor,
                    vision_embeds: Optional[torch.Tensor] = None):
    """Full-sequence forward -> logits (B, S, V).  ``vision_embeds``
    (B, vision_tokens, vision_dim): the vlm's stub patch embeddings."""
    check_family(cfg)
    B, S = tokens.shape
    x = constrain(embed_lookup(params.embed, tokens), "dp", "sp", None)
    positions = _positions(B, S, tokens.device)
    if cfg.family == "ssm":
        block = _maybe_remat(lambda bp, x_: ssm_block(bp, x_, cfg)[0], cfg)
        for bp in params.blocks:
            x = block(bp, x)
    elif cfg.family == "hybrid":
        def super_block(sb, x_):
            for rp in sb["recs"]:
                x_, _ = rec_block(rp, x_, cfg)
            return decoder_block(sb["attn"], x_, cfg, positions,
                                 window=cfg.local_window)

        super_block = _maybe_remat(super_block, cfg)
        tail_block = _maybe_remat(
            lambda rp, x_: rec_block(rp, x_, cfg)[0], cfg)
        for sb in params.blocks:
            x = super_block(sb, x)
        for rp in params.tail or ():
            x = tail_block(rp, x)
    elif cfg.family == "vlm":
        memory = _vision_memory(params, cfg, vision_embeds)

        def group(gp, x_, memory_):
            blocks, cp = gp
            for bp in blocks:
                x_ = decoder_block(bp, x_, cfg, positions,
                                   cfg.sliding_window)
            return cross_block(cp, x_, memory_, cfg)

        group = _maybe_remat(group, cfg)
        for blocks, cp, _ in _groups(params, cfg):
            x = group((blocks, cp), x, memory)
    else:   # dense / moe
        block = _maybe_remat(
            lambda bp, x_: decoder_block(bp, x_, cfg, positions,
                                         cfg.sliding_window), cfg)
        for bp in params.blocks:
            x = block(bp, x)
    return _lm_logits(params, x, cfg)


# =========================================================== caches & decode
class DecodeCache(NamedTuple):
    """``self_kv`` by family: dense / moe / vlm one :class:`KVCache` a
    (self-attention) layer; ssm one :class:`~repro_torch.models.ssd.
    SSMCache` a layer; hybrid a dict of ``recs`` (a list of
    :class:`~repro_torch.models.rglru.LRUCache` a super-block), ``attn``
    (one windowed KV ring a super-block) and ``tail`` (LRU caches, or
    None).  ``cross_kv``: the vlm's (k, v) of the projected vision
    embeddings, one pair a group, (B, K, vision_tokens, hd) each; decode
    never writes them."""

    self_kv: object
    pos: int
    # [position up to which self_kv's tensors hold tokens], shared by every
    # cache over the same tensors: an in-place step moves it past the pos
    # of the cache it consumed
    written: list
    cross_kv: Optional[list] = None


def _check_live(cache) -> None:
    """Raise unless ``cache``'s tensors still hold its own state."""
    if cache.written[0] != cache.pos:
        raise ValueError(
            f"repro_torch: this cache (pos {cache.pos}) was consumed by an "
            f"in-place decode step (its tensors hold tokens up to "
            f"{cache.written[0]}); decode from the cache that step returned")


def _next_written(cache, inplace: bool) -> list:
    """The ``written`` of the cache a decode step returns: the consumed
    cache's own list moved on (in place), else a fresh one."""
    if inplace:
        cache.written[0] = cache.pos + 1
        return cache.written
    return [cache.pos + 1]


def init_decode_cache(cfg, batch: int, max_len: int,
                      device=None) -> DecodeCache:
    check_family(cfg)
    cross = None
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
    elif cfg.family == "vlm":
        n_groups, per = vlm_layout(cfg)
        self_kv = [att.init_kv_cache(cfg, batch, max_len, cfg.sliding_window,
                                     device=device)
                   for _ in range(n_groups * per)]
        shape = (batch, cfg.n_kv_heads, cfg.vision_tokens, cfg.hd)
        dt = dtype_of(cfg.dtype)
        cross = [tuple(torch.zeros(shape, dtype=dt, device=device)
                       for _ in range(2)) for _ in range(n_groups)]
    else:
        self_kv = [att.init_kv_cache(cfg, batch, max_len, cfg.sliding_window,
                                     device=device)
                   for _ in range(cfg.n_layers)]
    return DecodeCache(self_kv=self_kv, pos=0, written=[0], cross_kv=cross)


def decoder_decode_step(params: Decoder, cfg, token: torch.Tensor,
                        cache: DecodeCache, inplace: bool = False):
    """One decode step.  token: (B,) int -> logits (B, V) and the cache
    with pos + 1.  By default ``cache`` stays as it was (the step writes
    into copies of its KV tensors; the recurrent states are new tensors
    anyway), as in the JAX package; with ``inplace`` the step writes into
    its KV tensors and ``cache`` is consumed: decoding from it again
    raises."""
    check_family(cfg)
    _check_live(cache)
    x = embed_lookup(params.embed, token)[:, None, :]  # (B, 1, d)
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
    elif cfg.family == "vlm":
        kv2 = []
        _, per = vlm_layout(cfg)
        for blocks, cp, gi in _groups(params, cfg):
            for j, bp in enumerate(blocks):
                x, c = decoder_block_decode(
                    bp, x, cache.self_kv[gi * per + j], cfg,
                    window=cfg.sliding_window, inplace=inplace)
                kv2.append(c)
            x = cross_block_cached(cp, x, cache.cross_kv[gi], cfg)
    else:
        kv2 = []
        for bp, c in zip(params.blocks, cache.self_kv):
            x, c = decoder_block_decode(bp, x, c, cfg,
                                        window=cfg.sliding_window,
                                        inplace=inplace)
            kv2.append(c)
    logits = _lm_logits(params, x, cfg)[:, 0]
    return logits, DecodeCache(kv2, cache.pos + 1,
                               _next_written(cache, inplace), cache.cross_kv)


# ==================================================================== prefill
def decoder_prefill(params: Decoder, cfg, tokens: torch.Tensor,
                    vision_embeds: Optional[torch.Tensor] = None,
                    max_len: Optional[int] = None):
    """Prefill: forward the prompt, return (last-token logits, DecodeCache)."""
    check_family(cfg)
    B, S = tokens.shape
    max_len = max_len or S
    x = constrain(embed_lookup(params.embed, tokens), "dp", "sp", None)
    positions = _positions(B, S, tokens.device)
    cross = None
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
    elif cfg.family == "vlm":
        memory = _vision_memory(params, cfg, vision_embeds)
        window = cfg.sliding_window
        kv, cross = [], []
        for blocks, cp, _ in _groups(params, cfg):
            for bp in blocks:
                x, (k, v) = decoder_block_prefill(bp, x, cfg, positions,
                                                  window)
                kv.append(att.fill_kv_cache(cfg, k, v, max_len, window))
            x, mem_kv = cross_block(cp, x, memory, cfg, return_kv=True)
            cross.append(mem_kv)
    else:   # dense / moe
        window = cfg.sliding_window
        kv = []
        for bp in params.blocks:
            x, (k, v) = decoder_block_prefill(bp, x, cfg, positions, window)
            kv.append(att.fill_kv_cache(cfg, k, v, max_len, window))
    logits = _lm_logits(params, x[:, -1:, :], cfg)[:, 0]
    return logits, DecodeCache(kv, S, [S], cross)


# ==================================================================== enc-dec
class EncDec(NamedTuple):
    """Encoder-decoder parameters (seamless-m4t family; the audio frontend
    is a stub: precomputed frame embeddings): the JAX ``EncDec``'s
    fields, one parameter dict a layer."""

    audio_proj: torch.Tensor       # (audio_dim, d)
    enc_blocks: list
    enc_norm: torch.Tensor
    embed: torch.Tensor            # decoder token embeddings
    dec_blocks: list               # self + cross + mlp
    final_norm: torch.Tensor
    lm_head: torch.Tensor


def init_enc_block(gen: torch.Generator, cfg):
    dt = dtype_of(cfg.dtype)
    return {
        "attn_norm": zeros((cfg.d_model,), dt, gen),
        "attn": att.init_attn(gen, cfg),
        "mlp_norm": zeros((cfg.d_model,), dt, gen),
        "mlp": init_mlp(gen, cfg),
    }


def init_dec_block(gen: torch.Generator, cfg):
    dt = dtype_of(cfg.dtype)
    return {
        "attn_norm": zeros((cfg.d_model,), dt, gen),
        "attn": att.init_attn(gen, cfg),
        "cross_norm": zeros((cfg.d_model,), dt, gen),
        "cross": att.init_attn(gen, cfg, cross=True),
        "mlp_norm": zeros((cfg.d_model,), dt, gen),
        "mlp": init_mlp(gen, cfg),
    }


def init_encdec(gen: torch.Generator, cfg) -> EncDec:
    """Random parameters drawn from ``gen``, on ``gen``'s device."""
    check_family(cfg)
    dt = dtype_of(cfg.dtype)
    return EncDec(
        audio_proj=trunc_normal(gen, (cfg.audio_dim, cfg.d_model), 1.0, dt),
        enc_blocks=[init_enc_block(gen, cfg)
                    for _ in range(cfg.encoder_layers)],
        enc_norm=zeros((cfg.d_model,), dt, gen),
        embed=trunc_normal(gen, (cfg.vocab_size, cfg.d_model), 1.0, dt),
        dec_blocks=[init_dec_block(gen, cfg) for _ in range(cfg.n_layers)],
        final_norm=zeros((cfg.d_model,), dt, gen),
        lm_head=trunc_normal(gen, (cfg.d_model, cfg.vocab_size), 1.0, dt),
    )


def encdec_specs(cfg) -> EncDec:
    """Logical-axis spec tree matching :func:`init_encdec`."""
    check_family(cfg)
    enc = {
        "attn_norm": (None,),
        "attn": att.attn_specs(cfg),
        "mlp_norm": (None,),
        "mlp": mlp_specs(cfg),
    }
    dec = {
        "attn_norm": (None,),
        "attn": att.attn_specs(cfg),
        "cross_norm": (None,),
        "cross": att.attn_specs(cfg, cross=True),
        "mlp_norm": (None,),
        "mlp": mlp_specs(cfg),
    }
    return EncDec(
        audio_proj=("fsdp", "tp"),
        enc_blocks=[dict(enc) for _ in range(cfg.encoder_layers)],
        enc_norm=(None,),
        embed=("tp", "fsdp"),
        dec_blocks=[dict(dec) for _ in range(cfg.n_layers)],
        final_norm=(None,),
        lm_head=("fsdp", "tp"),
    )


def encode_audio(params: EncDec, cfg, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, T_frames, audio_dim) stub embeddings -> memory (B, T, d).
    Bidirectional self-attention with RoPE, through ``cfg.attn_impl``
    (under ``"flash"`` the kernel's non-causal mode)."""
    check_family(cfg)
    x = constrain(proj(frames, params.audio_proj), "dp", "sp", None)
    positions = _positions(x.shape[0], x.shape[1], x.device)

    def block(bp, x_):
        h = _norm(x_, bp["attn_norm"], cfg)
        x_ = x_ + _out(att.multihead_attention(
            bp["attn"], h, cfg, positions=positions, causal=False))
        h = _norm(x_, bp["mlp_norm"], cfg)
        return constrain(x_ + _out(mlp(bp["mlp"], h, cfg)), "dp", "sp",
                         None)

    block = _maybe_remat(block, cfg)
    for bp in params.enc_blocks:
        x = block(bp, x)
    return _norm(x, params.enc_norm, cfg)


def _dec_block(bp, x, memory, cfg, positions):
    """One encoder-decoder decoder block (full-sequence path): causal
    self-attention, cross-attention over ``memory``, MLP.  Returns the
    output, the self-attention's (k, v) and the memory's (k, v)."""
    h = _norm(x, bp["attn_norm"], cfg)
    h, self_kv = att.multihead_attention(
        bp["attn"], h, cfg, positions=positions, causal=True,
        return_kv=True)
    x = x + _out(h)
    h = _norm(x, bp["cross_norm"], cfg)
    h, mem_kv = att.multihead_attention(
        bp["cross"], h, cfg, kv_x=memory, causal=False, use_rope=False,
        impl="einsum", return_kv=True)
    x = x + _out(h)
    h = _norm(x, bp["mlp_norm"], cfg)
    return (constrain(x + _out(mlp(bp["mlp"], h, cfg)), "dp", "sp", None),
            self_kv, mem_kv)


def encdec_forward(params: EncDec, cfg, frames: torch.Tensor,
                   tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder logits (B, S, V)."""
    memory = encode_audio(params, cfg, frames)
    B, S = tokens.shape
    x = constrain(embed_lookup(params.embed, tokens), "dp", "sp", None)
    positions = _positions(B, S, tokens.device)
    block = _maybe_remat(
        lambda bp, x_, memory_: _dec_block(bp, x_, memory_, cfg,
                                           positions)[0], cfg)
    for bp in params.dec_blocks:
        x = block(bp, x, memory)
    return _lm_logits(params, x, cfg)


class EncDecCache(NamedTuple):
    """One :class:`~repro_torch.models.attention.KVCache` a decoder layer
    (``kv_cache_dtype="int8"`` applies), and the encoder memory's keys and
    values of each layer's cross-attention, (B, K, T_frames, hd) each
    (head-major: :func:`~repro_torch.models.attention.memory_kv`); decode
    never writes them."""

    self_kv: list
    cross_k: list
    cross_v: list
    pos: int
    written: list      # as DecodeCache.written


def encdec_prefill(params: EncDec, cfg, frames: torch.Tensor,
                   tokens: torch.Tensor, max_len: Optional[int] = None):
    """Encode the audio and prefill the decoder prompt -> (last-token
    logits, EncDecCache)."""
    memory = encode_audio(params, cfg, frames)
    B, S = tokens.shape
    max_len = max_len or S
    x = embed_lookup(params.embed, tokens)
    positions = _positions(B, S, tokens.device)
    self_kv, cross_k, cross_v = [], [], []
    for bp in params.dec_blocks:
        x, (k, v), (mk, mv) = _dec_block(bp, x, memory, cfg, positions)
        self_kv.append(att.fill_kv_cache(cfg, k, v, max_len, None))
        mk, mv = att.memory_kv(mk, mv)
        cross_k.append(mk)
        cross_v.append(mv)
    logits = _lm_logits(params, x[:, -1:, :], cfg)[:, 0]
    return logits, EncDecCache(self_kv, cross_k, cross_v, S, [S])


def init_encdec_cache(cfg, batch: int, max_len: int, n_frames: int,
                      device=None) -> EncDecCache:
    """An empty cache.  The self caches are those of
    :func:`~repro_torch.models.attention.init_kv_cache` (with their int8
    planes and scales under ``kv_cache_dtype="int8"``, as the prefill
    makes them); the reference's ``init_encdec_cache`` builds its
    ``KVCache`` without the scale fields and raises ``TypeError``."""
    check_family(cfg)
    shape = (batch, cfg.n_kv_heads, n_frames, cfg.hd)
    dt = dtype_of(cfg.dtype)

    def planes():
        return [torch.zeros(shape, dtype=dt, device=device)
                for _ in range(cfg.n_layers)]

    return EncDecCache(
        self_kv=[att.init_kv_cache(cfg, batch, max_len, None, device=device)
                 for _ in range(cfg.n_layers)],
        cross_k=planes(), cross_v=planes(), pos=0, written=[0])


def encdec_decode_step(params: EncDec, cfg, token: torch.Tensor,
                       cache: EncDecCache, inplace: bool = False):
    """One decode step: token (B,) -> logits (B, V) and the cache with
    pos + 1; functional unless ``inplace``, as
    :func:`decoder_decode_step`."""
    check_family(cfg)
    _check_live(cache)
    x = embed_lookup(params.embed, token)[:, None, :]
    kv2 = []
    for bp, c, mk, mv in zip(params.dec_blocks, cache.self_kv,
                             cache.cross_k, cache.cross_v):
        h = rms_norm(x, bp["attn_norm"], cfg.norm_eps)
        h, c = att.decode_attention(bp["attn"], h, c, cfg, inplace=inplace)
        x = x + h
        h = rms_norm(x, bp["cross_norm"], cfg.norm_eps)
        x = x + _cross_cached(bp["cross"], h, (mk, mv), cfg)
        h = rms_norm(x, bp["mlp_norm"], cfg.norm_eps)
        x = x + mlp(bp["mlp"], h, cfg)
        kv2.append(c)
    logits = _lm_logits(params, x, cfg)[:, 0]
    return logits, EncDecCache(kv2, cache.cross_k, cache.cross_v,
                               cache.pos + 1, _next_written(cache, inplace))
