"""Model configuration dataclass covering all assigned architecture families.

The port's own copy of :mod:`repro.models.config` (pure data, the same
fields and defaults), so that the port imports nothing of the JAX package.

Two fields only shape compilation in the JAX package and are refused
here away from their defaults (:data:`NO_EFFECT`,
``models/transformer.py::check_family``), so that a setting that would do
nothing fails loudly: ``scan_layers`` (``lax.scan`` over stacked layers;
the port loops over per-layer parameter dicts) and ``moe_bf16_dispatch``
(it only casts the reference's one-hot dispatch and its combine weights
to the activations' dtype earlier: the dispatch is exact either way, and
``repro/models/moe.py:114`` rounds the combine weights to that dtype
anyway, so the result is the same bits).  They are kept so that a
configuration reads the same in both packages.

The sharding fields act under a mesh (:mod:`repro_torch.sharding`), as
in the reference: ``tp_mode`` (``megatron``, ``ulysses`` or
``megatron_rs``; any other value raises) picks the tensor-parallel
layout of the attention and MLP blocks, ``moe_ep`` shards the experts
over the model axis and sends their token buffers by all-to-all, and
``opt_collectives`` is accepted at both values, which give one layout:
the port always places the reference's ``opt_collectives=True``
boundaries (the post-norm activation gathered over the sequence in its
own dtype, each sub-block's output reduce-scattered onto it before the
residual add; ``models/transformer.py::_norm`` / ``_out``).  On one card
every mode computes the same function.  ``remat`` takes effect: the port
recomputes each block in the backward pass
(``models/transformer.py::_maybe_remat``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


# fields with no effect in the port (see the module docstring)
NO_EFFECT = ("scan_layers", "moe_bf16_dispatch")

# the tensor-parallel layouts (``tp_mode``)
TP_MODES = ("megatron", "ulysses", "megatron_rs")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | vlm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_group_size: int = 1024       # GShard-style dispatch group
    capacity_factor: float = 1.25

    # --- attention flavour ---
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    mlp_bias: bool = False
    mlp_type: str = "swiglu"         # swiglu | gelu
    sliding_window: Optional[int] = None
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    attn_chunk: int = 1024           # kv-chunk for the online-softmax path
    attn_impl: str = "auto"          # auto | einsum | chunked | flash

    # --- ssm (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    ssm_groups: int = 1

    # --- hybrid (RG-LRU / Griffin) ---
    lru_width: Optional[int] = None
    local_window: Optional[int] = None
    attn_every: int = 0              # 1 attention layer per `attn_every` (3 -> 1:2)

    # --- vlm ---
    cross_every: int = 0             # a cross-attn block after every N self layers
    vision_dim: int = 0
    vision_tokens: int = 0

    # --- encdec (audio) ---
    encoder_layers: int = 0
    audio_frames: int = 0
    audio_dim: int = 0

    # --- numerics / runtime ---
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    # §Perf hillclimb knobs (EXPERIMENTS.md): baseline = all off
    opt_collectives: bool = False   # RS residual boundaries + bf16 AG points
    moe_bf16_dispatch: bool = False  # bf16 dispatch/combine one-hot einsums
    tp_mode: str = "megatron"        # megatron | ulysses | megatron_rs
    moe_ep: bool = False             # expert parallelism: experts over tp
    kv_cache_dtype: str = "model"    # model (= cfg.dtype) | int8 (quantized)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + layers)."""
        d, f, V = self.d_model, self.d_ff, self.vocab_size
        hd, H, K = self.hd, self.n_heads, self.n_kv_heads
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            di, st = self.d_inner, self.ssm_state
            per = d * (2 * di + 2 * self.ssm_groups * st + self.ssm_heads)
            per += di * d + 2 * d  # out proj + norms
            return emb + self.n_layers * per
        attn = d * hd * (H + 2 * K) + H * hd * d
        if self.qkv_bias:
            attn += hd * (H + 2 * K)
        if self.mlp_type == "swiglu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        if self.n_experts:
            mlp = mlp * self.n_experts + d * self.n_experts
        per = attn + mlp + 2 * d
        n_attn_layers = self.n_layers
        if self.family == "hybrid":
            n_rec = self.n_layers - self.n_layers // (self.attn_every or 3)
            lw = self.lru_width or d
            rec = d * lw * 3 + lw * d + 4 * lw  # gate+x+out projections + lru
            n_att = self.n_layers - n_rec
            return emb + n_att * per + n_rec * (rec + mlp + 2 * d)
        total = emb + n_attn_layers * per
        if self.family == "vlm" and self.cross_every:
            n_cross = self.n_layers // self.cross_every
            cross = d * hd * (H + 2 * K) + H * hd * d + 2 * d
            total += n_cross * cross + self.vision_dim * d
        if self.family == "encdec":
            enc_per = attn + mlp + 2 * d
            cross = d * hd * (H + 2 * K) + H * hd * d + d
            total += self.encoder_layers * enc_per + self.n_layers * cross
            total += self.audio_dim * d
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_mlp = (3 if self.mlp_type == "swiglu" else 2) * d * f
        inactive = (self.n_experts - self.experts_per_token) * dense_mlp
        return self.param_count() - self.n_layers * inactive

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
